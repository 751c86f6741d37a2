// Safe-interval path planning against a collision table
// (ref analogue: lacam3/src/sipp.cpp).
//
// States are (vertex, safe-interval); the search minimizes arrival time at
// the goal such that the goal stays free through the horizon (so the agent
// can rest), which on a fixed horizon equals minimizing the path's
// sum-of-loss contribution.  A* with h = BFS distance to goal would need a
// per-call distance field; since instances are small grids we run uniform
// Dijkstra on (interval) states — intervals per vertex are few.
#include <algorithm>
#include <queue>

#include "lacam.hpp"

namespace lacam {

namespace {

struct Interval {
  int lo, hi;  // inclusive time window with the vertex free
};

// maximal free intervals of vertex v in [0, T]
void build_intervals(const CollisionTable& tab, int v,
                     std::vector<Interval>& out) {
  out.clear();
  int t = 0;
  while (t <= tab.T) {
    if (tab.occupant(t, v) >= 0) {
      t++;
      continue;
    }
    int lo = t;
    while (t + 1 <= tab.T && tab.occupant(t + 1, v) < 0) t++;
    out.push_back({lo, t});
    t++;
  }
}

struct Node {
  int time;      // earliest arrival within the interval
  int vertex;
  int interval;  // index into intervals[vertex]
};
struct NodeCmp {
  bool operator()(const Node& a, const Node& b) const {
    return a.time > b.time;
  }
};

}  // namespace

Path sipp_plan(const Grid& grid, int start, int goal, int horizon,
               const CollisionTable& table) {
  const int V = grid.size();
  std::vector<std::vector<Interval>> intervals(V);
  std::vector<uint8_t> built(V, 0);
  auto ivs = [&](int v) -> std::vector<Interval>& {
    if (!built[v]) {
      build_intervals(table, v, intervals[v]);
      built[v] = 1;
    }
    return intervals[v];
  };

  auto& s_ivs = ivs(start);
  int s_iv = -1;
  for (size_t i = 0; i < s_ivs.size(); i++)
    if (s_ivs[i].lo == 0) s_iv = (int)i;
  if (s_iv < 0) return {};  // start occupied at t=0

  // best arrival per (vertex, interval)
  std::vector<std::vector<int>> best(V);
  std::vector<std::vector<std::pair<int, int>>> from(V);  // (vertex, interval)
  std::vector<std::vector<int>> from_time(V);
  auto ensure = [&](int v) {
    size_t n = ivs(v).size();
    if (best[v].size() != n) {
      best[v].assign(n, 1 << 29);
      from[v].assign(n, {-1, -1});
      from_time[v].assign(n, -1);
    }
  };
  ensure(start);
  best[start][s_iv] = 0;

  std::priority_queue<Node, std::vector<Node>, NodeCmp> pq;
  pq.push({0, start, s_iv});
  int goal_iv = -1;

  while (!pq.empty()) {
    Node n = pq.top();
    pq.pop();
    if (n.time > best[n.vertex][n.interval]) continue;
    if (n.vertex == goal && ivs(goal)[n.interval].hi >= horizon) {
      goal_iv = n.interval;
      break;
    }
    const Interval cur = ivs(n.vertex)[n.interval];
    // latest time we can still depart from this interval
    const int depart_hi = std::min(cur.hi, horizon - 1);
    for (int d = 0; d < 4; d++) {
      int u = grid.nbr[d][n.vertex];
      if (u < 0) continue;
      ensure(u);
      auto& u_ivs = ivs(u);
      for (size_t i = 0; i < u_ivs.size(); i++) {
        // arrive at u at time ta in [n.time+1, depart_hi+1] ∩ interval i
        int ta = std::max(n.time + 1, u_ivs[i].lo);
        if (ta > depart_hi + 1 || ta > u_ivs[i].hi) continue;
        // wait at n.vertex until ta-1, then move; check swap conflicts at
        // the earliest feasible ta (later ta within the window cannot have
        // a swap if the vertex interval is free — occupant would need to
        // leave u into our vertex while it is free, impossible mid-interval
        // — so only the boundary arrival needs the check)
        while (ta <= u_ivs[i].hi && ta <= depart_hi + 1 &&
               table.edge_conflict(ta - 1, n.vertex, u))
          ta++;
        if (ta > depart_hi + 1 || ta > u_ivs[i].hi) continue;
        if (ta < best[u][i]) {
          best[u][i] = ta;
          from[u][i] = {n.vertex, n.interval};
          from_time[u][i] = ta;
          pq.push({ta, u, (int)i});
        }
      }
    }
  }
  if (goal_iv < 0) return {};

  // reconstruct: walk parents, filling waits
  std::vector<std::pair<int, int>> rev;  // (vertex, arrival time)
  int v = goal, iv = goal_iv;
  while (v >= 0) {
    rev.push_back({v, best[v][iv]});
    auto pr = from[v][iv];
    v = pr.first;
    iv = pr.second;
  }
  std::reverse(rev.begin(), rev.end());
  Path path;
  path.reserve(horizon + 1);
  for (size_t i = 0; i < rev.size(); i++) {
    if (i == 0) {
      path.push_back(rev[0].first);
    } else {
      while ((int)path.size() < rev[i].second) path.push_back(rev[i - 1].first);
      path.push_back(rev[i].first);
    }
  }
  while ((int)path.size() <= horizon) path.push_back(goal);
  return path;
}

}  // namespace lacam
