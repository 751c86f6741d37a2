// Solution validation + visualizer log writer
// (ref analogue: lacam3/src/post_processing.cpp).
#include <cstdio>

#include "lacam.hpp"

namespace lacam {

bool is_feasible(const Grid& grid, const Config& starts, const Config& goals,
                 const Solution& sol, std::string* error) {
  auto fail = [&](const std::string& msg) {
    if (error) *error = msg;
    return false;
  };
  if (!sol.solved || sol.configs.empty()) return fail("unsolved");
  int A = (int)starts.size();
  if (sol.configs.front() != starts) return fail("bad start config");
  if (sol.configs.back() != goals) return fail("bad final config");
  for (size_t t = 1; t < sol.configs.size(); t++) {
    const auto& prev = sol.configs[t - 1];
    const auto& cur = sol.configs[t];
    for (int a = 0; a < A; a++) {
      if (!grid.free_cell(cur[a])) return fail("agent on obstacle");
      bool edge = cur[a] == prev[a];
      for (int d = 0; d < 4 && !edge; d++)
        edge = grid.nbr[d][prev[a]] == cur[a];
      if (!edge) return fail("non-adjacent move");
      for (int b = a + 1; b < A; b++) {
        if (cur[a] == cur[b]) return fail("vertex conflict");
        if (cur[a] == prev[b] && cur[b] == prev[a])
          return fail("swap conflict");
      }
    }
  }
  return true;
}

bool write_log(const std::string& path, const Grid& grid, const Config& starts,
               const Config& goals, const Solution& sol, double elapsed_s) {
  std::FILE* f = std::fopen(path.c_str(), "w");
  if (f == nullptr) return false;
  const int A = (int)starts.size();
  std::fprintf(f, "agents=%d\n", A);
  std::fprintf(f, "map_size=%dx%d\n", grid.width, grid.height);
  std::fprintf(f, "solved=%d\n", sol.solved ? 1 : 0);
  std::fprintf(f, "comp_time_s=%.3f\n", elapsed_s);
  if (sol.solved) {
    std::fprintf(f, "makespan=%d\n", makespan(sol));
    std::fprintf(f, "sum_of_costs=%d\n", sum_of_costs(sol, goals));
    std::fprintf(f, "sum_of_loss=%d\n", sum_of_loss(sol, goals));
  }
  std::fprintf(f, "starts=");
  for (int a = 0; a < A; a++)
    std::fprintf(f, "(%d,%d),", starts[a] % grid.width,
                 starts[a] / grid.width);
  std::fprintf(f, "\ngoals=");
  for (int a = 0; a < A; a++)
    std::fprintf(f, "(%d,%d),", goals[a] % grid.width, goals[a] / grid.width);
  std::fprintf(f, "\nsolution=\n");
  for (size_t t = 0; t < sol.configs.size(); t++) {
    std::fprintf(f, "%zu:", t);
    for (int a = 0; a < A; a++)
      std::fprintf(f, "(%d,%d),", sol.configs[t][a] % grid.width,
                   sol.configs[t][a] / grid.width);
    std::fprintf(f, "\n");
  }
  std::fclose(f);
  return true;
}

}  // namespace lacam
