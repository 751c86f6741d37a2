// LaCAM* high-level search (ref analogue: lacam3/src/planner.cpp +
// hnode.cpp/lnode.cpp): anytime DFS over joint configurations with an
// EXPLORED hash map, lazy low-level constraint trees, Monte-Carlo PIBT
// ensemble (persistent thread pool), Dijkstra rewiring of the search DAG on
// rediscovery, random re-inserts, and periodic cost checkpoints.
#include <algorithm>
#include <atomic>
#include <cassert>
#include <cstdio>
#include <deque>
#include <memory>

#include "lacam.hpp"

namespace lacam {

namespace {

// Low-level constraint node: the first `depth` agents of the owner's order
// are pinned to specific vertices.
struct LNode {
  std::vector<int> where;  // where[k] = forced vertex of order[k]
  int depth = 0;
};

struct HNode {
  Config Q;
  HNode* parent = nullptr;
  int g = 0;                      // cost-to-come (sum-of-loss edges)
  int h = 0;                      // sum of BFS distances to goals
  std::vector<float> priority;    // PIBT dynamic priorities
  std::vector<int> order;         // agents by priority desc
  std::deque<LNode> tree;         // lazy low-level constraint queue
  std::vector<HNode*> edges_out;  // discovered transitions, for rewiring
};

struct Planner {
  const Grid& grid;
  const Config& starts;
  const Config& goals;
  const Options& opt;
  ThreadPool* pool;
  DistTables dist;
  Scatter scatter;
  bool scatter_on;
  std::mt19937 rng;
  int A;

  std::vector<HNode*> all_nodes;
  std::unordered_map<Config, HNode*, ConfigHash> explored;
  std::vector<HNode*> open;  // DFS stack
  HNode* h_goal = nullptr;

  // one PIBT per ensemble slot (each thread owns its instance)
  std::vector<std::unique_ptr<PIBT>> pibts;

  Planner(const Grid& grid, const Config& starts, const Config& goals,
          const Options& opt, ThreadPool* pool)
      : grid(grid), starts(starts), goals(goals), opt(opt), pool(pool),
        dist(grid, goals, pool), rng(opt.seed), A((int)starts.size()) {
    scatter_on = opt.use_scatter;
    if (scatter_on)
      scatter.construct(grid, starts, goals, dist, opt.scatter_margin,
                        /*iterations=*/2, (unsigned)opt.seed + 7);
    int n = std::max(1, opt.pibt_ensemble);
    for (int e = 0; e < n; e++)
      pibts.emplace_back(std::make_unique<PIBT>(
          grid, dist, A, (unsigned)(opt.seed * 97 + e),
          scatter_on ? &scatter : nullptr));
  }

  ~Planner() {
    for (auto* n : all_nodes) delete n;
  }

  int heuristic(const Config& q) const {
    int h = 0;
    for (int a = 0; a < A; a++) {
      int d = dist.get(a, q[a]);
      if (d < 0) return -1;  // infeasible instance
      h += d;
    }
    return h;
  }

  int edge_cost(const Config& from, const Config& to) const {
    int c = 0;
    for (int a = 0; a < A; a++)
      if (from[a] != goals[a] || to[a] != goals[a]) c++;
    return c;
  }

  HNode* make_node(const Config& q, HNode* parent) {
    auto* n = new HNode;
    all_nodes.push_back(n);
    n->Q = q;
    n->parent = parent;
    n->h = heuristic(q);
    n->priority.resize(A);
    if (parent == nullptr) {
      int maxd = 1;
      for (int a = 0; a < A; a++) maxd = std::max(maxd, dist.get(a, q[a]));
      for (int a = 0; a < A; a++)
        n->priority[a] = (float)dist.get(a, q[a]) / (maxd + 1);
      n->g = 0;
    } else {
      n->g = parent->g + edge_cost(parent->Q, q);
      // dynamic priorities: grow while off-goal, reset on arrival
      // (ref analogue: lacam3/src/hnode.cpp:29-47)
      for (int a = 0; a < A; a++)
        n->priority[a] = q[a] == goals[a]
                             ? (float)(parent->priority[a] -
                                       (int)parent->priority[a])
                             : parent->priority[a] + 1.0f;
    }
    n->order.resize(A);
    for (int a = 0; a < A; a++) n->order[a] = a;
    std::sort(n->order.begin(), n->order.end(), [&](int i, int j) {
      return n->priority[i] > n->priority[j];
    });
    n->tree.push_back(LNode{});  // root: no constraints
    return n;
  }

  // lazy enumeration of the next low-level constraint layer
  // (ref analogue: lacam3/src/hnode.cpp:57-72)
  void expand_lowlevel(HNode* n, const LNode& l) {
    if (l.depth >= A) return;
    int a = n->order[l.depth];
    int vs[5];
    int n_v = 0;
    vs[n_v++] = n->Q[a];
    for (int d = 0; d < 4; d++) {
      int u = grid.nbr[d][n->Q[a]];
      if (u >= 0) vs[n_v++] = u;
    }
    std::shuffle(vs, vs + n_v, rng);
    for (int k = 0; k < n_v; k++) {
      LNode child = l;
      child.where.push_back(vs[k]);
      child.depth = l.depth + 1;
      n->tree.push_back(std::move(child));
    }
  }

  // Dijkstra relaxation through recorded edges after a cheaper path is found
  void rewire_from(HNode* src) {
    std::deque<HNode*> q{src};
    while (!q.empty()) {
      HNode* n = q.front();
      q.pop_front();
      for (HNode* m : n->edges_out) {
        int ng = n->g + edge_cost(n->Q, m->Q);
        if (ng < m->g) {
          m->g = ng;
          m->parent = n;
          q.push_back(m);
        }
      }
    }
  }

  // Monte-Carlo config generation: `ensemble` PIBT rollouts (parallel on the
  // pool when available), keep the best f = g + edge + h
  // (ref analogue: lacam3/src/planner.cpp:208-248).
  bool gen_best_config(HNode* n, const LNode& l, Config& out) {
    const int n_e = l.depth == 0 ? (int)pibts.size() : 1;
    std::vector<Config> cands(n_e);
    std::vector<uint8_t> ok(n_e, 0);
    auto run_one = [&](int e) {
      ok[e] = pibts[e]->set_new_config(n->Q, goals, n->order, l.where,
                                       l.depth, cands[e]) ? 1 : 0;
    };
    if (n_e > 1 && pool != nullptr && opt.ensemble_threads > 1) {
      for (int e = 0; e < n_e; e++) pool->submit([&, e] { run_one(e); });
      pool->wait_all();
    } else {
      for (int e = 0; e < n_e; e++) run_one(e);
    }
    bool found = false;
    long best_f = 0;
    for (int e = 0; e < n_e; e++) {
      if (!ok[e]) continue;
      int hh = heuristic(cands[e]);
      if (hh < 0) continue;
      long f = (long)n->g + edge_cost(n->Q, cands[e]) + hh;
      if (!found || f < best_f) {
        best_f = f;
        out = cands[e];
        found = true;
      }
    }
    return found;
  }

  Solution run() {
    Solution sol;
    Deadline deadline(opt.time_limit_s);
    if (heuristic(starts) < 0) return sol;  // some goal unreachable

    HNode* init = make_node(starts, nullptr);
    explored[starts] = init;
    open.push_back(init);

    long iter = 0;
    double next_checkpoint = 1.0;
    // once a goal config is known, cap the anytime search so LNS refinement
    // gets the remainder of the budget
    const double search_cap = opt.refine_iters > 0 ? 0.6 : 1.0;
    while (!open.empty()) {
      if ((++iter & 0xFF) == 0) {
        if (deadline.over() ||
            (h_goal != nullptr &&
             deadline.elapsed_s() >= search_cap * deadline.limit_s))
          break;
        if (opt.verbosity > 0 && deadline.elapsed_s() >= next_checkpoint) {
          std::fprintf(stderr,
                       "lacam: t=%.1fs iter=%ld explored=%zu best_g=%d\n",
                       deadline.elapsed_s(), iter, explored.size(),
                       h_goal ? h_goal->g : -1);
          next_checkpoint += 1.0;
        }
      }
      // random re-insert of the initial node (restart; ref:planner.cpp keeps
      // exploration from stagnating in deep branches)
      if (opt.restart_interval > 0 && iter % opt.restart_interval == 0 &&
          h_goal == nullptr)
        open.push_back(init);

      HNode* n = open.back();
      if (h_goal != nullptr && n->g >= h_goal->g) {  // pruned branch (h >= 0)
        open.pop_back();
        continue;
      }
      if (n->Q == goals) {
        if (h_goal == nullptr || n->g < h_goal->g) h_goal = n;
        if (!opt.anytime) break;
        open.pop_back();
        continue;
      }
      if (n->tree.empty()) {  // exhausted low-level tree
        open.pop_back();
        continue;
      }
      LNode l = std::move(n->tree.front());
      n->tree.pop_front();
      expand_lowlevel(n, l);

      Config q_new;
      if (!gen_best_config(n, l, q_new)) continue;

      auto it = explored.find(q_new);
      if (it == explored.end()) {
        HNode* m = make_node(q_new, n);
        explored[q_new] = m;
        n->edges_out.push_back(m);
        open.push_back(m);
      } else {
        HNode* m = it->second;
        n->edges_out.push_back(m);
        int ng = n->g + edge_cost(n->Q, q_new);
        if (ng < m->g) {
          m->g = ng;
          m->parent = n;
          rewire_from(m);
        }
        if (h_goal == nullptr) open.push_back(m);  // revisit (completeness)
      }
    }

    if (h_goal == nullptr) return sol;
    std::vector<Config> rev;
    for (HNode* n = h_goal; n != nullptr; n = n->parent) rev.push_back(n->Q);
    sol.configs.assign(rev.rbegin(), rev.rend());
    sol.solved = true;
    if (opt.refine_iters > 0)
      sol = refine(grid, starts, goals, dist, std::move(sol), opt,
                   opt.seed + 1, deadline);
    return sol;
  }
};

}  // namespace

Solution solve(const Grid& grid, const Config& starts, const Config& goals,
               const Options& opt) {
  std::unique_ptr<ThreadPool> pool;
  int n_threads = std::max(opt.ensemble_threads,
                           opt.refiner_pool > 1 ? opt.refiner_pool : 0);
  if (n_threads > 1) pool = std::make_unique<ThreadPool>(n_threads);
  Planner p(grid, starts, goals, opt, pool.get());
  return p.run();
}

}  // namespace lacam
