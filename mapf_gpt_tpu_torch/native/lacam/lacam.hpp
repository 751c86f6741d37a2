// LaCAM* expert solver for MAPF — a fresh implementation of the algorithm
// family used by the reference's dataset pipeline (ref:dataset/lacam/lacam3,
// "LaCAM: Search-Based Algorithm for Quick Multi-Agent Pathfinding",
// Okumura AAAI 2023, its anytime LaCAM* variant, and the PIBT + swap
// operation from Okumura et al.).  The code is not derived from the
// reference; capabilities track SURVEY §2.2 component-for-component:
//
//   graph.cpp            '.'/'#' ASCII map -> 4-connected grid graph
//   dist_table.cpp       per-agent BFS-from-goal tables (thread-pool BFS,
//                        ref analogue: lacam3/src/dist_table.cpp)
//   pibt.cpp             priority-inheritance config generator with vertex +
//                        swap conflict checks and corridor swap emulation
//                        (ref: lacam3/src/pibt.cpp)
//   scatter.cpp          SUO space-utilization optimization: iterated
//                        penalized A* producing per-agent preferred-next-
//                        vertex hints for PIBT (ref: lacam3/src/scatter.cpp)
//   planner.cpp          high-level anytime DFS over joint configs: EXPLORED
//                        hash, lazy low-level constraint trees, Monte-Carlo
//                        PIBT ensemble on a persistent thread pool, Dijkstra
//                        rewiring on rediscovery (the "*"), random re-inserts,
//                        periodic cost checkpoints
//                        (ref: lacam3/src/planner.cpp, hnode/lnode.cpp)
//   collision_table.cpp  per-vertex time-indexed occupancy with enroll/clear
//                        and vertex/edge conflict queries
//                        (ref: lacam3/src/collision_table.cpp)
//   sipp.cpp             safe-interval path planning minimizing path loss
//                        against the collision table (ref: lacam3/src/sipp.cpp)
//   refiner.cpp          large-neighborhood search: re-plan random groups
//                        (<=30, <=N/4) with SIPP under a sum-of-loss bound,
//                        parallel refiner pool + single-agent polish
//                        (ref: lacam3/src/refiner.cpp)
//   metrics.cpp          makespan / sum-of-costs / sum-of-loss + lower bounds
//                        (ref: lacam3/src/metrics.cpp)
//   translator.cpp       configs <-> per-agent paths (ref: src/translator.cpp)
//   post_processing.cpp  feasibility validation + visualizer log writer
//                        (ref: lacam3/src/post_processing.cpp)
//   utils.cpp            Deadline, seeded RNG helpers, persistent ThreadPool
//                        (ref: lacam3/src/utils.cpp)
//
// Exposed both as a C++ API and a C ABI (capi.cpp) for the ctypes bridge in
// mapf_gpt_tpu/dataset/expert.py.
#pragma once

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <functional>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace lacam {

using Config = std::vector<int>;  // joint positions, one vertex id per agent
using Path = std::vector<int>;    // per-agent vertex sequence over time

// ---------------------------------------------------------------- graph ----
struct Grid {
  int height = 0, width = 0;
  std::vector<uint8_t> blocked;  // h*w, 1 = obstacle
  std::vector<int> nbr[4];       // neighbor vertex id or -1, per direction
  std::vector<uint8_t> degree;   // number of free neighbors per vertex
  explicit Grid(const std::string& map_text);
  Grid(int h, int w, const std::vector<uint8_t>& blocked_cells);
  int size() const { return height * width; }
  bool free_cell(int v) const { return !blocked[v]; }

 private:
  void build_adjacency();
};

struct ConfigHash {
  size_t operator()(const Config& q) const {
    size_t h = 14695981039346656037ULL;
    for (int v : q) {
      h ^= (size_t)(v + 0x9e3779b9);
      h *= 1099511628211ULL;
    }
    return h;
  }
};

// ---------------------------------------------------------------- utils ----
struct Deadline {
  double limit_s;
  std::chrono::steady_clock::time_point start;
  explicit Deadline(double limit_s);
  bool over() const;
  double elapsed_s() const;
};

// Persistent pool: threads stay alive across submissions (the reference
// spawns PIBT ensemble threads per expansion and async refiners; a pool
// amortizes that cost).
struct ThreadPool {
  explicit ThreadPool(int n_threads);
  ~ThreadPool();
  void submit(std::function<void()> fn);
  void wait_all();  // block until every submitted task finished
  int size() const { return (int)workers_.size(); }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  int active_ = 0;
  bool stop_ = false;
};

// ----------------------------------------------------------- dist table ----
// Per-agent BFS distance-from-goal tables (pool-parallel construction).
struct DistTables {
  const Grid& grid;
  std::vector<std::vector<int32_t>> tables;  // [agents][verts], -1 unreachable
  DistTables(const Grid& grid, const Config& goals, ThreadPool* pool = nullptr);
  int get(int agent, int v) const { return tables[agent][v]; }
};

// ------------------------------------------------------------- solution ----
struct Solution {
  bool solved = false;
  std::vector<Config> configs;  // configs[t][agent] = vertex at step t
  int makespan() const { return (int)configs.size() - 1; }
  int sum_of_loss(const Config& goals) const;
};

// -------------------------------------------------------------- metrics ----
int makespan(const Solution& sol);
int sum_of_costs(const Solution& sol, const Config& goals);
int sum_of_loss(const Solution& sol, const Config& goals);
// Lower bounds from per-agent shortest-path distances.
int makespan_lower_bound(const DistTables& dist, const Config& starts);
int sum_of_costs_lower_bound(const DistTables& dist, const Config& starts);

// ----------------------------------------------------------- translator ----
std::vector<Path> configs_to_paths(const Solution& sol);
Solution paths_to_configs(const std::vector<Path>& paths);

// ------------------------------------------------------ collision table ----
// Time-indexed occupancy of enrolled agent paths, for SIPP re-planning.
// After a path's horizon, the agent is parked at its final vertex.
struct CollisionTable {
  int V = 0, T = 0;  // vertices, time horizon (configs - 1)
  std::vector<int> occ;      // [(T+1) * V] occupant agent id or -1
  std::vector<int> parked;   // [V] agent parked here from its path end, or -1
  CollisionTable(int vertices, int horizon);
  void enroll(int agent, const Path& path);
  void clear(int agent, const Path& path);
  int occupant(int t, int v) const;       // incl. parked extension
  bool vertex_free(int t, int v) const { return occupant(t, v) < 0; }
  // edge (swap) conflict moving v -> u between t and t+1
  bool edge_conflict(int t, int v, int u) const;
};

// ----------------------------------------------------------------- sipp ----
// Safe-interval path planning: minimum-arrival path start -> goal within
// horizon T that stays conflict-free against the collision table and can
// rest on the goal through T.  Returns empty path on failure.
Path sipp_plan(const Grid& grid, int start, int goal, int horizon,
               const CollisionTable& table);

// -------------------------------------------------------------- scatter ----
// Space-utilization optimization: penalized A* per agent (cost bounded by
// shortest distance + margin) minimizing overlap with other agents' tentative
// paths; yields per-agent preferred next-vertex hints consumed by PIBT.
struct Scatter {
  // next_of[a][v] = preferred successor of vertex v for agent a (or absent)
  std::vector<std::unordered_map<int, int>> next_of;
  void construct(const Grid& grid, const Config& starts, const Config& goals,
                 const DistTables& dist, int margin, int iterations,
                 unsigned seed);
};

// ---------------------------------------------------------------- pibt -----
// One-step config generator. Each instance owns its scratch, so ensemble
// threads each hold their own PIBT (the reference does the same,
// ref:lacam3/src/planner.cpp:303-308).
struct PIBT {
  const Grid& grid;
  const DistTables& dist;
  const Scatter* scatter;  // optional hints
  int A;
  std::mt19937 rng;
  Config Qto;
  std::vector<int> occupied_now, occupied_next;

  PIBT(const Grid& grid, const DistTables& dist, int agents, unsigned seed,
       const Scatter* scatter = nullptr);
  // Generate successor config of Q; constraints pin order[k] -> where[k] for
  // k < depth. Returns false if constraints are unsatisfiable.
  bool set_new_config(const Config& Q, const Config& goals,
                      const std::vector<int>& order,
                      const std::vector<int>& where, int depth, Config& out);

 private:
  bool func_pibt(const Config& Q, const Config& goals, int a);
  bool swap_required_and_possible(const Config& Q, int a, int b) const;
};

// -------------------------------------------------------------- options ----
struct Options {
  double time_limit_s = 1.0;
  int seed = 0;
  bool anytime = true;     // keep improving after first solution (LaCAM*)
  int pibt_ensemble = 4;   // Monte-Carlo configs per unconstrained expansion
                           // (ref runs 10 PIBT threads,
                           //  ref:lacam3/src/planner.cpp:208-248)
  int ensemble_threads = 0;  // >1: run the ensemble on a thread pool
  bool use_scatter = true;   // SUO preprocessing (ref: FLG_SCATTER)
  int scatter_margin = 10;   // path-length slack for scattered paths
  int refine_iters = 2000;   // LNS attempts after a solution (0 disables)
  int refiner_pool = 2;      // parallel refiner workers with distinct seeds
  int group_max = 30;        // max agents per LNS group (ref: refiner.cpp)
  int restart_interval = 10000;  // re-insert init node every k expansions
  int verbosity = 0;
};

// ------------------------------------------------------- planner + LNS -----
Solution solve(const Grid& grid, const Config& starts, const Config& goals,
               const Options& opt);

// Group + single-agent LNS refinement under the deadline (see refiner.cpp).
Solution refine(const Grid& grid, const Config& starts, const Config& goals,
                const DistTables& dist, Solution sol, const Options& opt,
                int seed, const Deadline& deadline);

// ------------------------------------------------------ post-processing ----
// Feasibility: starts/goals match, moves are edges, no vertex/swap conflicts.
bool is_feasible(const Grid& grid, const Config& starts, const Config& goals,
                 const Solution& sol, std::string* error = nullptr);
// Text log for visualization/debugging (the reference writes lacam_log.txt,
// ref:lacam3/src/post_processing.cpp:88-130).
bool write_log(const std::string& path, const Grid& grid, const Config& starts,
               const Config& goals, const Solution& sol, double elapsed_s);

}  // namespace lacam
