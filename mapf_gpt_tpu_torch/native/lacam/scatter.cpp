// Space-utilization optimization (SUO): spread agents' tentative paths to
// minimize pairwise overlap before search, yielding per-agent preferred
// next-vertex hints for PIBT (ref analogue: lacam3/src/scatter.cpp —
// iterated prioritized A* minimizing (collisions, length) under a cost
// bound).  Fresh implementation.
#include <algorithm>
#include <queue>

#include "lacam.hpp"

namespace lacam {

namespace {

// A* from start to goal minimizing (overlap penalty, length), with path
// length capped at dist_lb + margin.  usage[v] counts other agents' paths.
Path penalized_astar(const Grid& grid, int start, int goal,
                     const std::vector<int32_t>& dist_to_goal,
                     const std::vector<uint16_t>& usage, int margin,
                     std::mt19937& rng) {
  const int V = grid.size();
  const int budget = dist_to_goal[start] + margin;
  struct QN {
    long f;       // penalty * V + length (lexicographic via scaling)
    int len, v;
  };
  struct Cmp {
    bool operator()(const QN& a, const QN& b) const { return a.f > b.f; }
  };
  std::vector<long> best(V, (long)1 << 60);
  std::vector<int> parent(V, -1);
  std::priority_queue<QN, std::vector<QN>, Cmp> pq;
  long f0 = (long)usage[start] * (V + 1);
  best[start] = f0;
  pq.push({f0, 0, start});
  int dirs[4] = {0, 1, 2, 3};
  while (!pq.empty()) {
    QN n = pq.top();
    pq.pop();
    if (n.f > best[n.v]) continue;
    if (n.v == goal) break;
    std::shuffle(dirs, dirs + 4, rng);
    for (int di = 0; di < 4; di++) {
      int u = grid.nbr[dirs[di]][n.v];
      if (u < 0) continue;
      int nlen = n.len + 1;
      if (nlen + dist_to_goal[u] > budget || dist_to_goal[u] < 0) continue;
      long nf = n.f + (long)usage[u] * (V + 1) + 1;
      if (nf < best[u]) {
        best[u] = nf;
        parent[u] = n.v;
        pq.push({nf, nlen, u});
      }
    }
  }
  if (parent[goal] < 0 && goal != start) return {};
  Path p;
  for (int v = goal; v >= 0; v = parent[v]) {
    p.push_back(v);
    if (v == start) break;
  }
  std::reverse(p.begin(), p.end());
  return p.empty() || p.front() != start ? Path{} : p;
}

}  // namespace

void Scatter::construct(const Grid& grid, const Config& starts,
                        const Config& goals, const DistTables& dist,
                        int margin, int iterations, unsigned seed) {
  const int A = (int)starts.size();
  next_of.assign(A, {});
  std::mt19937 rng(seed);
  std::vector<uint16_t> usage(grid.size(), 0);
  std::vector<Path> paths(A);
  std::vector<int> order(A);
  for (int a = 0; a < A; a++) order[a] = a;

  for (int it = 0; it < iterations; it++) {
    std::shuffle(order.begin(), order.end(), rng);
    for (int a : order) {
      // remove own usage before re-planning
      for (int v : paths[a])
        if (usage[v] > 0) usage[v]--;
      Path p = penalized_astar(grid, starts[a], goals[a], dist.tables[a],
                               usage, margin, rng);
      if (p.empty()) p = paths[a];  // keep previous on failure
      paths[a] = p;
      for (int v : paths[a]) usage[v]++;
    }
  }
  for (int a = 0; a < A; a++)
    for (size_t i = 0; i + 1 < paths[a].size(); i++)
      next_of[a][paths[a][i]] = paths[a][i + 1];
}

}  // namespace lacam
