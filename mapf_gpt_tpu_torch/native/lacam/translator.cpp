// configs <-> per-agent paths (ref: lacam3/src/translator.cpp).
#include "lacam.hpp"

namespace lacam {

std::vector<Path> configs_to_paths(const Solution& sol) {
  if (sol.configs.empty()) return {};
  const int A = (int)sol.configs[0].size();
  const int T = (int)sol.configs.size();
  std::vector<Path> paths(A, Path(T));
  for (int t = 0; t < T; t++)
    for (int a = 0; a < A; a++) paths[a][t] = sol.configs[t][a];
  return paths;
}

Solution paths_to_configs(const std::vector<Path>& paths) {
  Solution sol;
  if (paths.empty()) return sol;
  const int A = (int)paths.size();
  size_t T = 0;
  for (auto& p : paths) T = std::max(T, p.size());
  sol.configs.assign(T, Config(A));
  for (int a = 0; a < A; a++)
    for (size_t t = 0; t < T; t++)
      sol.configs[t][a] = t < paths[a].size() ? paths[a][t] : paths[a].back();
  sol.solved = true;
  return sol;
}

}  // namespace lacam
