// Solution quality metrics + lower bounds (ref: lacam3/src/metrics.cpp).
#include "lacam.hpp"

namespace lacam {

int Solution::sum_of_loss(const Config& goals) const {
  return lacam::sum_of_loss(*this, goals);
}

int makespan(const Solution& sol) { return (int)sol.configs.size() - 1; }

// sum-of-costs: per agent, the last timestep it is off its goal (i.e. the
// step count until it settles), summed.
int sum_of_costs(const Solution& sol, const Config& goals) {
  if (sol.configs.empty()) return 0;
  const int A = (int)goals.size();
  const int T = (int)sol.configs.size() - 1;
  int total = 0;
  for (int a = 0; a < A; a++) {
    int last_off = 0;
    for (int t = 1; t <= T; t++)
      if (sol.configs[t][a] != goals[a]) last_off = t;
    total += last_off;
  }
  return total;
}

// sum-of-loss: number of (t-1 -> t) transitions where the agent is not
// resting on its goal at both ends.
int sum_of_loss(const Solution& sol, const Config& goals) {
  int loss = 0;
  for (size_t t = 1; t < sol.configs.size(); t++)
    for (size_t a = 0; a < goals.size(); a++)
      if (sol.configs[t][a] != goals[a] || sol.configs[t - 1][a] != goals[a])
        loss++;
  return loss;
}

int makespan_lower_bound(const DistTables& dist, const Config& starts) {
  int lb = 0;
  for (size_t a = 0; a < starts.size(); a++)
    lb = std::max(lb, (int)dist.get((int)a, starts[a]));
  return lb;
}

int sum_of_costs_lower_bound(const DistTables& dist, const Config& starts) {
  int lb = 0;
  for (size_t a = 0; a < starts.size(); a++) lb += dist.get((int)a, starts[a]);
  return lb;
}

}  // namespace lacam
