// Per-agent BFS distance-from-goal tables, pool-parallel construction
// (ref analogue: lacam3/src/dist_table.cpp uses std::async per agent).
#include "lacam.hpp"

namespace lacam {

namespace {
void bfs_from(const Grid& grid, int goal, std::vector<int32_t>& dist) {
  dist.assign(grid.size(), -1);
  std::vector<int> queue_buf(grid.size());
  int head = 0, tail = 0;
  dist[goal] = 0;
  queue_buf[tail++] = goal;
  while (head < tail) {
    int v = queue_buf[head++];
    for (int d = 0; d < 4; d++) {
      int u = grid.nbr[d][v];
      if (u >= 0 && dist[u] < 0) {
        dist[u] = dist[v] + 1;
        queue_buf[tail++] = u;
      }
    }
  }
}
}  // namespace

DistTables::DistTables(const Grid& g, const Config& goals, ThreadPool* pool)
    : grid(g) {
  const int A = (int)goals.size();
  tables.resize(A);
  if (pool != nullptr && pool->size() > 1 && A > 8) {
    for (int a = 0; a < A; a++)
      pool->submit([this, a, &goals] { bfs_from(grid, goals[a], tables[a]); });
    pool->wait_all();
  } else {
    for (int a = 0; a < A; a++) bfs_from(grid, goals[a], tables[a]);
  }
}

}  // namespace lacam
