// Priority-inheritance-with-backtracking config generator with vertex + swap
// conflict checks, corridor swap emulation, and scatter-path prioritization
// (ref analogue: lacam3/src/pibt.cpp; swap operation from Okumura's
// "Improving LaCAM for Scalable Eventually Optimal MAPF" / PIBT+ literature,
// implemented from the published algorithm, not the reference source).
#include <algorithm>

#include "lacam.hpp"

namespace lacam {

PIBT::PIBT(const Grid& g, const DistTables& d, int agents, unsigned seed,
           const Scatter* sc)
    : grid(g), dist(d), scatter(sc), A(agents), rng(seed),
      occupied_now(g.size(), -1), occupied_next(g.size(), -1) {}

// Swap emulation: when the highest-ranked move of `a` targets the cell of a
// lower-priority neighbor `b` and the local topology is a corridor/dead-end
// such that b cannot yield without passing through a, the pair must swap
// roles: a retreats (reversed preference) pulling b forward.  We detect the
// situation by walking the corridor behind b: if the walk reaches a dead end
// before a vertex of degree >= 3, a swap is required; it is possible if a's
// own backside reaches a branching vertex.
bool PIBT::swap_required_and_possible(const Config& Q, int a, int b) const {
  // required: walk from b's cell away from a while in a corridor
  int prev = Q[a], cur = Q[b];
  bool required = false;
  for (int steps = 0; steps < grid.size(); steps++) {
    if (grid.degree[cur] >= 3) break;  // b can sidestep eventually
    int nxt = -1;
    int options = 0;
    for (int d = 0; d < 4; d++) {
      int u = grid.nbr[d][cur];
      if (u >= 0 && u != prev) {
        options++;
        nxt = u;
      }
    }
    if (options == 0) {  // dead end behind b
      required = true;
      break;
    }
    if (options >= 2) break;
    prev = cur;
    cur = nxt;
  }
  if (!required) return false;
  // possible: walk from a's cell away from b; a must reach a branching
  // vertex (or open space) to pull b through
  prev = Q[b];
  cur = Q[a];
  for (int steps = 0; steps < grid.size(); steps++) {
    if (grid.degree[cur] >= 3) return true;
    int nxt = -1;
    int options = 0;
    for (int d = 0; d < 4; d++) {
      int u = grid.nbr[d][cur];
      if (u >= 0 && u != prev) {
        options++;
        nxt = u;
      }
    }
    if (options == 0) return false;  // dead end behind a too: no swap room
    if (options >= 2) return true;
    prev = cur;
    cur = nxt;
  }
  return false;
}

bool PIBT::func_pibt(const Config& Q, const Config& goals, int a) {
  // candidate moves sorted by distance-to-goal, random tie-break, scatter
  // hint preferred within equal distance
  int cands[5];
  int n_c = 0;
  cands[n_c++] = Q[a];
  for (int d = 0; d < 4; d++) {
    int u = grid.nbr[d][Q[a]];
    if (u >= 0) cands[n_c++] = u;
  }
  std::shuffle(cands, cands + n_c, rng);
  int hint = -1;
  if (scatter != nullptr) {
    auto it = scatter->next_of[a].find(Q[a]);
    if (it != scatter->next_of[a].end()) hint = it->second;
  }
  std::sort(cands, cands + n_c, [&](int u, int v) {
    int du = dist.get(a, u), dv = dist.get(a, v);
    if (du != dv) return du < dv;
    if ((u == hint) != (v == hint)) return u == hint;  // prefer scatter path
    return false;
  });

  // swap emulation: if the best move lands on a lower-priority agent stuck
  // in a corridor that requires swapping, reverse the preference so `a`
  // retreats and pulls that agent
  if (n_c > 1 && cands[0] != Q[a]) {
    int b = occupied_now[cands[0]];
    if (b >= 0 && b != a && Qto[b] < 0 &&
        swap_required_and_possible(Q, a, b)) {
      std::reverse(cands, cands + n_c);
      // retreating should still avoid standing still if possible: move the
      // current cell to the end
      int self_at = -1;
      for (int k = 0; k < n_c; k++)
        if (cands[k] == Q[a]) self_at = k;
      if (self_at >= 0) {
        for (int k = self_at; k + 1 < n_c; k++) cands[k] = cands[k + 1];
        cands[n_c - 1] = Q[a];
      }
    }
  }

  for (int k = 0; k < n_c; k++) {
    int v = cands[k];
    if (occupied_next[v] >= 0) continue;  // vertex conflict
    int b = occupied_now[v];
    if (b >= 0 && Qto[b] == Q[a]) continue;  // swap conflict
    Qto[a] = v;
    occupied_next[v] = a;
    if (b >= 0 && b != a && Qto[b] < 0) {
      if (!func_pibt(Q, goals, b)) {  // priority inheritance + backtracking
        Qto[a] = -1;
        occupied_next[v] = -1;
        continue;
      }
    }
    return true;
  }
  return false;
}

bool PIBT::set_new_config(const Config& Q, const Config& goals,
                          const std::vector<int>& order,
                          const std::vector<int>& where, int depth,
                          Config& out) {
  Qto.assign(A, -1);
  for (int a = 0; a < A; a++) occupied_now[Q[a]] = a;
  bool ok = true;
  // apply low-level constraints (pinned agents)
  for (int k = 0; k < depth && ok; k++) {
    int a = order[k], v = where[k];
    if (occupied_next[v] >= 0) { ok = false; break; }     // vertex clash
    int b = occupied_now[v];
    if (b >= 0 && Qto[b] == Q[a]) { ok = false; break; }  // swap clash
    Qto[a] = v;
    occupied_next[v] = a;
  }
  if (ok) {
    for (int k = 0; k < A && ok; k++) {
      int a = order[k];
      if (Qto[a] < 0) ok = func_pibt(Q, goals, a);
    }
  }
  if (ok) out = Qto;
  for (int a = 0; a < A; a++) {
    occupied_now[Q[a]] = -1;
    if (Qto[a] >= 0) occupied_next[Qto[a]] = -1;
  }
  return ok;
}

}  // namespace lacam
