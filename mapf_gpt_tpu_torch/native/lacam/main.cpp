// Smoke-test binary (the reference keeps one too,
// ref:dataset/lacam/main.cpp:99-138): solves a built-in instance and prints
// the solution summary.
#include <cstdio>
#include <string>

#include "lacam.hpp"

int main(int argc, char** argv) {
  std::string map_text =
      "..........\n"
      "..##..##..\n"
      "..........\n"
      "..##..##..\n"
      "..........\n"
      "..........\n"
      "..##..##..\n"
      "..........\n";
  lacam::Grid grid(map_text);
  int n = 12;
  lacam::Config starts, goals;
  // starts along the top rows, goals mirrored at the bottom
  int placed = 0;
  for (int v = 0; v < grid.size() && placed < n; v++)
    if (grid.free_cell(v)) {
      starts.push_back(v);
      placed++;
    }
  placed = 0;
  for (int v = grid.size() - 1; v >= 0 && placed < n; v--)
    if (grid.free_cell(v)) {
      goals.push_back(v);
      placed++;
    }
  lacam::Options opt;
  opt.time_limit_s = argc > 1 ? atof(argv[1]) : 2.0;
  auto sol = lacam::solve(grid, starts, goals, opt);
  std::string err;
  bool ok = lacam::is_feasible(grid, starts, goals, sol, &err);
  printf("solved=%d feasible=%d makespan=%d soc_loss=%d %s\n", sol.solved, ok,
         sol.makespan(), sol.solved ? sol.sum_of_loss(goals) : -1,
         err.c_str());
  return ok ? 0 : 1;
}
