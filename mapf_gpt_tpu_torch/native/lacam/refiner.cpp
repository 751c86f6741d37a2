// Large-neighborhood-search refinement (ref analogue: lacam3/src/refiner.cpp
// + the async refiner pool in planner.cpp:310-350):
//
//   * group LNS: clear a random group (<= group_max, <= N/4, >= 2) from the
//     collision table and re-plan its members sequentially with SIPP,
//     accepting strict sum-of-loss improvements, rolling back otherwise;
//   * single-agent polish: 0/1-cost time-expanded Dijkstra per agent against
//     everyone else frozen (the group-size-1 case, cheap and effective);
//   * refiner pool: `refiner_pool` workers run the schedule on copies of the
//     solution with distinct seeds in parallel threads; the best result wins
//     (the reference runs its refiners asynchronously during search).
#include <algorithm>
#include <deque>

#include "lacam.hpp"

namespace lacam {

namespace {

int path_loss(const Path& p, int goal) {
  int l = 0;
  for (size_t t = 1; t < p.size(); t++)
    if (p[t] != goal || p[t - 1] != goal) l++;
  return l;
}

// Single-agent optimal re-plan on the time-expanded graph with 0/1 costs
// (0 = resting on goal), honoring vertex + swap conflicts vs `occ`.
bool replan_single(const Grid& grid, int start, int goal, int T,
                   const std::vector<int>& occ, Path& out) {
  const int V = grid.size();
  const int INF = 1 << 29;
  std::vector<int> cost((size_t)(T + 1) * V, INF);
  std::vector<int> parent((size_t)(T + 1) * V, -1);
  std::deque<size_t> dq;
  size_t s0 = (size_t)0 * V + start;
  cost[s0] = 0;
  dq.push_back(s0);
  while (!dq.empty()) {
    size_t cur = dq.front();
    dq.pop_front();
    int t = (int)(cur / V), v = (int)(cur % V);
    if (t == T) continue;
    int moves[5];
    int n_m = 0;
    moves[n_m++] = v;
    for (int d = 0; d < 4; d++)
      if (grid.nbr[d][v] >= 0) moves[n_m++] = grid.nbr[d][v];
    for (int m = 0; m < n_m; m++) {
      int u = moves[m];
      size_t nxt = (size_t)(t + 1) * V + u;
      if (occ[nxt] >= 0) continue;  // vertex conflict
      int b = occ[(size_t)t * V + u];
      if (b >= 0 && occ[(size_t)(t + 1) * V + v] == b) continue;  // swap
      int c = (u == goal && v == goal) ? 0 : 1;
      if (cost[cur] + c < cost[nxt]) {
        cost[nxt] = cost[cur] + c;
        parent[nxt] = (int)cur;
        if (c == 0) dq.push_front(nxt);
        else dq.push_back(nxt);
      }
    }
  }
  size_t goal_state = (size_t)T * V + goal;
  if (cost[goal_state] >= INF) return false;
  out.assign(T + 1, -1);
  size_t cur = goal_state;
  for (int t = T; t >= 0; t--) {
    out[t] = (int)(cur % V);
    if (t > 0) cur = (size_t)parent[cur];
  }
  return true;
}

struct RefineWorker {
  const Grid& grid;
  const Config& starts;
  const Config& goals;
  const Options& opt;
  const Deadline& deadline;
  std::mt19937 rng;
  int A, T, V;
  std::vector<Path> paths;

  RefineWorker(const Grid& g, const Config& s, const Config& go,
               const Options& o, const Deadline& dl, const Solution& sol,
               int seed)
      : grid(g), starts(s), goals(go), opt(o), deadline(dl), rng(seed),
        A((int)s.size()), T((int)sol.configs.size() - 1), V(g.size()) {
    paths = configs_to_paths(sol);
  }

  int total_loss() const {
    int l = 0;
    for (int a = 0; a < A; a++) l += path_loss(paths[a], goals[a]);
    return l;
  }

  // one group-LNS attempt; returns true if it improved the solution
  bool try_group(CollisionTable& table) {
    int gmax = std::min(opt.group_max, std::max(2, A / 4));
    int gsize = 2 + (int)(rng() % (unsigned)std::max(1, gmax - 1));
    gsize = std::min(gsize, A);
    // sample distinct members
    std::vector<int> group;
    std::vector<uint8_t> in(A, 0);
    while ((int)group.size() < gsize) {
      int a = (int)(rng() % A);
      if (!in[a]) {
        in[a] = 1;
        group.push_back(a);
      }
    }
    int old_loss = 0;
    for (int a : group) {
      old_loss += path_loss(paths[a], goals[a]);
      table.clear(a, paths[a]);
    }
    std::shuffle(group.begin(), group.end(), rng);
    std::vector<Path> new_paths;
    int new_loss = 0;
    bool ok = true;
    std::vector<int> planned;
    for (int a : group) {
      Path p = sipp_plan(grid, starts[a], goals[a], T, table);
      if (p.empty()) {
        ok = false;
        break;
      }
      new_loss += path_loss(p, goals[a]);
      table.enroll(a, p);
      planned.push_back(a);
      new_paths.push_back(std::move(p));
    }
    if (ok && new_loss < old_loss) {
      for (size_t i = 0; i < planned.size(); i++)
        paths[planned[i]] = std::move(new_paths[i]);
      return true;
    }
    // rollback
    for (size_t i = 0; i < planned.size(); i++)
      table.clear(planned[i], new_paths[i]);
    for (int a : group) table.enroll(a, paths[a]);
    return false;
  }

  // one single-agent polish pass over a random agent
  void try_single(std::vector<int>& occ) {
    int a = (int)(rng() % A);
    int old_loss = path_loss(paths[a], goals[a]);
    if (old_loss == 0) return;
    for (int t = 0; t <= T; t++) occ[(size_t)t * V + paths[a][t]] = -1;
    Path np;
    if (replan_single(grid, starts[a], goals[a], T, occ, np) &&
        path_loss(np, goals[a]) < old_loss)
      paths[a] = np;
    for (int t = 0; t <= T; t++) occ[(size_t)t * V + paths[a][t]] = a;
  }

  Solution run(int iters) {
    // group phase with the collision table
    CollisionTable table(V, T);
    for (int a = 0; a < A; a++) table.enroll(a, paths[a]);
    int group_iters = iters / 8;  // group attempts are ~group_size costlier
    for (int it = 0; it < group_iters; it++) {
      if ((it & 3) == 0 && deadline.over()) break;
      try_group(table);
    }
    // single-agent phase on a dense occupancy grid
    std::vector<int> occ((size_t)(T + 1) * V, -1);
    for (int a = 0; a < A; a++)
      for (int t = 0; t <= T; t++) occ[(size_t)t * V + paths[a][t]] = a;
    for (int it = 0; it < iters; it++) {
      if ((it & 7) == 0 && deadline.over()) break;
      try_single(occ);
    }
    Solution out = paths_to_configs(paths);
    // trim trailing all-on-goal configs (makespan may shrink)
    while (out.configs.size() > 1 &&
           out.configs[out.configs.size() - 2] == goals)
      out.configs.pop_back();
    return out;
  }
};

}  // namespace

Solution refine(const Grid& grid, const Config& starts, const Config& goals,
                const DistTables& dist, Solution sol, const Options& opt,
                int seed, const Deadline& deadline) {
  (void)dist;
  if (!sol.solved || sol.configs.size() < 2) return sol;
  const int workers = std::max(1, opt.refiner_pool);
  std::vector<Solution> results(workers);
  auto run_worker = [&](int w) {
    RefineWorker rw(grid, starts, goals, opt, deadline, sol, seed + 131 * w);
    results[w] = rw.run(opt.refine_iters);
  };
  if (workers > 1) {
    std::vector<std::thread> ts;
    for (int w = 0; w < workers; w++) ts.emplace_back(run_worker, w);
    for (auto& t : ts) t.join();
  } else {
    run_worker(0);
  }
  Solution* best = &sol;
  int best_loss = sol.sum_of_loss(goals);
  for (auto& r : results) {
    if (!r.solved) continue;
    int l = r.sum_of_loss(goals);
    if (l < best_loss ||
        (l == best_loss && r.configs.size() < best->configs.size())) {
      best_loss = l;
      best = &r;
    }
  }
  return std::move(*best);
}

}  // namespace lacam
