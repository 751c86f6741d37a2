// ASCII map -> 4-connected grid graph (ref analogue: lacam3/src/graph.cpp).
#include "lacam.hpp"

namespace lacam {

Grid::Grid(const std::string& map_text) {
  std::vector<std::vector<uint8_t>> rows;
  std::vector<uint8_t> row;
  for (char c : map_text) {
    if (c == '\n') {
      if (!row.empty()) rows.push_back(row);
      row.clear();
    } else if (c == '.') {
      row.push_back(0);
    } else if (c == '#' || c == '@' || c == 'T') {
      row.push_back(1);
    }  // other chars (spaces) ignored
  }
  if (!row.empty()) rows.push_back(row);
  height = (int)rows.size();
  width = height ? (int)rows[0].size() : 0;
  blocked.resize(height * width);
  for (int i = 0; i < height; i++)
    for (int j = 0; j < width; j++) blocked[i * width + j] = rows[i][j];
  build_adjacency();
}

Grid::Grid(int h, int w, const std::vector<uint8_t>& blocked_cells)
    : height(h), width(w), blocked(blocked_cells) {
  build_adjacency();
}

void Grid::build_adjacency() {
  const int dirs[4][2] = {{-1, 0}, {1, 0}, {0, -1}, {0, 1}};
  for (int d = 0; d < 4; d++) nbr[d].assign(height * width, -1);
  degree.assign(height * width, 0);
  for (int i = 0; i < height; i++)
    for (int j = 0; j < width; j++) {
      int v = i * width + j;
      if (blocked[v]) continue;
      for (int d = 0; d < 4; d++) {
        int ni = i + dirs[d][0], nj = j + dirs[d][1];
        if (ni >= 0 && ni < height && nj >= 0 && nj < width &&
            !blocked[ni * width + nj]) {
          nbr[d][v] = ni * width + nj;
          degree[v]++;
        }
      }
    }
}

}  // namespace lacam
