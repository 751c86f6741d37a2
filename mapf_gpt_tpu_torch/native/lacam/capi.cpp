// C ABI for the LaCAM* solver, consumed via ctypes from
// mapf_gpt_tpu/dataset/expert.py.  The reference exposed a string-serialized
// interface (ref:dataset/lacam/main.cpp:4-97 returns "x,y|x,y|...\n" text);
// here paths travel as flat int32 buffers to avoid parse overhead.
#include <cstdint>
#include <cstring>
#include <string>

#include "lacam.hpp"

extern "C" {

// Solve a MAPF instance on an ASCII map ('.' free, '#'/'@'/'T' blocked).
// starts_rc / goals_rc: [n_agents * 2] row,col pairs.
// out_paths: caller buffer of capacity max_configs * n_agents * 2 int32;
//   filled with configs[t][agent] = (row, col).
// Returns: number of configs written (makespan + 1) on success; 0 if the
// instance is unsolved within the time limit; -1 if the solution exceeded
// max_configs; -2 on invalid input or infeasible validation.
int32_t lacam_solve(const char* map_text, int32_t n_agents,
                    const int32_t* starts_rc, const int32_t* goals_rc,
                    double time_limit_s, int32_t seed, int32_t anytime,
                    int32_t* out_paths, int32_t max_configs) {
  lacam::Grid grid(map_text ? std::string(map_text) : std::string());
  if (grid.size() == 0 || n_agents <= 0) return -2;

  lacam::Config starts(n_agents), goals(n_agents);
  for (int a = 0; a < n_agents; a++) {
    int sr = starts_rc[2 * a], sc = starts_rc[2 * a + 1];
    int gr = goals_rc[2 * a], gc = goals_rc[2 * a + 1];
    if (sr < 0 || sr >= grid.height || sc < 0 || sc >= grid.width ||
        gr < 0 || gr >= grid.height || gc < 0 || gc >= grid.width)
      return -2;
    starts[a] = sr * grid.width + sc;
    goals[a] = gr * grid.width + gc;
    if (!grid.free_cell(starts[a]) || !grid.free_cell(goals[a])) return -2;
  }

  lacam::Options opt;
  opt.time_limit_s = time_limit_s;
  opt.seed = seed;
  opt.anytime = anytime != 0;
  auto sol = lacam::solve(grid, starts, goals, opt);
  if (!sol.solved) return 0;
  if (!lacam::is_feasible(grid, starts, goals, sol)) return -2;
  int t_len = (int)sol.configs.size();
  if (t_len > max_configs) return -1;
  for (int t = 0; t < t_len; t++)
    for (int a = 0; a < n_agents; a++) {
      int v = sol.configs[t][a];
      out_paths[(t * n_agents + a) * 2] = v / grid.width;
      out_paths[(t * n_agents + a) * 2 + 1] = v % grid.width;
    }
  return t_len;
}

// Sum-of-loss of a previously returned solution buffer (convenience for
// quality metrics without re-deriving in Python).
int32_t lacam_sum_of_loss(const int32_t* paths, int32_t t_len,
                          int32_t n_agents, const int32_t* goals_rc) {
  int loss = 0;
  for (int t = 1; t < t_len; t++)
    for (int a = 0; a < n_agents; a++) {
      bool prev_on = paths[((t - 1) * n_agents + a) * 2] == goals_rc[2 * a] &&
                     paths[((t - 1) * n_agents + a) * 2 + 1] ==
                         goals_rc[2 * a + 1];
      bool cur_on = paths[(t * n_agents + a) * 2] == goals_rc[2 * a] &&
                    paths[(t * n_agents + a) * 2 + 1] == goals_rc[2 * a + 1];
      if (!prev_on || !cur_on) loss++;
    }
  return loss;
}

}  // extern "C"
