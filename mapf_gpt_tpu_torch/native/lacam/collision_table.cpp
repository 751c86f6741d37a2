// Time-indexed occupancy for SIPP/LNS (ref: lacam3/src/collision_table.cpp).
#include "lacam.hpp"

namespace lacam {

CollisionTable::CollisionTable(int vertices, int horizon)
    : V(vertices), T(horizon),
      occ((size_t)(horizon + 1) * vertices, -1), parked(vertices, -1) {}

void CollisionTable::enroll(int agent, const Path& path) {
  for (size_t t = 0; t < path.size(); t++) occ[t * V + path[t]] = agent;
  // agent parks at its final vertex for the rest of the horizon
  for (size_t t = path.size(); t <= (size_t)T; t++)
    occ[t * V + path.back()] = agent;
  parked[path.back()] = agent;
}

void CollisionTable::clear(int agent, const Path& path) {
  for (size_t t = 0; t < path.size(); t++)
    if (occ[t * V + path[t]] == agent) occ[t * V + path[t]] = -1;
  for (size_t t = path.size(); t <= (size_t)T; t++)
    if (occ[t * V + path.back()] == agent) occ[t * V + path.back()] = -1;
  if (parked[path.back()] == agent) parked[path.back()] = -1;
}

int CollisionTable::occupant(int t, int v) const {
  if (t > T) return parked[v];
  return occ[(size_t)t * V + v];
}

bool CollisionTable::edge_conflict(int t, int v, int u) const {
  // someone moves u -> v while we move v -> u between t and t+1
  int b = occupant(t, u);
  return b >= 0 && occupant(t + 1, v) == b;
}

}  // namespace lacam
