"""Map parsing, registries, procedural generators and start/goal placement
(numpy only).

The port's copy of ``mapf_gpt_tpu/maps.py``: same functions, same seeds,
same arrays (``tests/test_torch_maps.py`` holds the two equal).

- ASCII grids with ``.`` free / ``#`` obstacle, loaded from ``maps.yaml``
  registries; placement-restricted cells of warehouse maps (``@`` starts
  only, ``$`` goals only, ``!`` neither) become start and goal masks.
- MovingAI ``.map`` and ``.scen`` text.
- Procedural random / maze / warehouse / city generators (own seeding, not
  pogema's).

All grids are numpy bool arrays, True = obstacle.  ``pad_grid`` adds the
C2G_RADIUS obstacle border that the tokenizer's window gather relies on
(padded coordinates are the frame of the whole engine).  PyYAML is read
only by :meth:`MapRegistry.load_yaml`, so the module imports without it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from mapf_gpt_tpu_torch.ops.vocab import C2G_RADIUS


def parse_ascii_map_ex(text: str, movingai: bool = False
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse an ASCII grid -> (obstacles, start_allowed, goal_allowed).

    Symbols: ``.`` free; ``#`` obstacle (plus ``@``/``T`` blocked terrain in
    MovingAI files).  Warehouse maps (wfi_warehouse,
    ref:eval_configs/03-warehouse/maps.yaml) use placement-restricted free
    cells: ``@`` spawn-only (starts), ``$`` pick-only (goals), ``!``
    walkway (neither).  pogema's exact symbol semantics are not published in
    the reference; this interpretation keeps all three traversable and
    restricts sampling masks.
    """
    rows, srows, grows = [], [], []
    for line in text.split():
        row, srow, grow = [], [], []
        for ch in line:
            if ch == ".":
                ob, st, gl = False, True, True
            elif ch == "#" or (movingai and ch in "@T"):
                ob, st, gl = True, False, False
            elif ch == "@":
                ob, st, gl = False, True, False
            elif ch == "$":
                ob, st, gl = False, False, True
            elif ch == "!":
                ob, st, gl = False, False, False
            else:
                raise ValueError(f"unsupported map symbol {ch!r}")
            row.append(ob)
            srow.append(st)
            grow.append(gl)
        if row:
            if rows and len(rows[-1]) != len(row):
                raise ValueError("ragged map rows")
            rows.append(row)
            srows.append(srow)
            grows.append(grow)
    return (np.array(rows, dtype=bool), np.array(srows, dtype=bool),
            np.array(grows, dtype=bool))


def parse_ascii_map(text: str) -> np.ndarray:
    """Obstacle grid only (placement-restricted cells count as free)."""
    return parse_ascii_map_ex(text)[0]


def parse_movingai_map(text: str) -> np.ndarray:
    """Parse MovingAI benchmark ``.map`` format (``type``/``height``/``width``/``map``)."""
    lines = text.splitlines()
    idx = next(i for i, ln in enumerate(lines) if ln.strip() == "map")
    grid_lines = [ln for ln in lines[idx + 1:] if ln.strip()]
    return parse_ascii_map_ex("\n".join(grid_lines), movingai=True)[0]


def parse_scen(text: str, grid: np.ndarray, num_agents: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Parse MovingAI ``.scen`` start/goal pairs against an (unpadded) grid.

    Format per line: ``bucket<TAB>map<TAB>w<TAB>h<TAB>x_s<TAB>y_s<TAB>x_g
    <TAB>y_g<TAB>cost`` with x = column, y = row.  Mirrors the reference's
    filtering (ref:dataset/lacam/lacam3/src/instance.cpp:28-66): entries out
    of range or on blocked cells are skipped; reading stops once
    ``num_agents`` pairs are collected.  Returns (starts, goals) as int32
    [A, 2] (row, col) in the *unpadded* frame.
    """
    h, w = grid.shape
    starts, goals = [], []
    for line in text.splitlines():
        parts = line.rstrip("\r").split("\t")
        if len(parts) < 9 or not parts[0].strip().isdigit():
            continue  # header / malformed lines
        try:
            xs, ys, xg, yg = (int(parts[4]), int(parts[5]),
                              int(parts[6]), int(parts[7]))
        except ValueError:
            continue
        if not (0 <= xs < w and 0 <= xg < w and 0 <= ys < h and 0 <= yg < h):
            continue
        if grid[ys, xs] or grid[yg, xg]:
            continue
        starts.append((ys, xs))
        goals.append((yg, xg))
        if num_agents is not None and len(starts) == num_agents:
            break
    return (np.asarray(starts, dtype=np.int32).reshape(-1, 2),
            np.asarray(goals, dtype=np.int32).reshape(-1, 2))


def scen_instance(map_text: str, scen_text: str,
                  num_agents: int | None = None, map_name: str = "",
                  pad: bool = True) -> Instance:
    """Build an Instance from MovingAI ``.map`` + ``.scen`` file contents,
    the reference LaCAM CLI's input mode (ref:dataset/lacam/main.cpp:99-138).
    """
    grid = parse_movingai_map(map_text)
    starts, goals = parse_scen(scen_text, grid, num_agents)
    if num_agents is not None and len(starts) < num_agents:
        raise ValueError(
            f"scen provides {len(starts)} valid pairs < {num_agents}")
    if pad:
        b = C2G_RADIUS
        grid = pad_grid(grid)
        starts, goals = starts + b, goals + b
    return Instance(grid=grid, starts=starts, goals=goals,
                    map_name=map_name)


def grid_to_str(grid: np.ndarray) -> str:
    return "\n".join("".join("#" if c else "." for c in row) for row in grid)


def pad_grid(grid: np.ndarray, border: int = C2G_RADIUS) -> np.ndarray:
    """Surround with an obstacle border of width `border` (reference frame)."""
    return np.pad(grid, border, constant_values=True)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

class MapRegistry:
    """name -> bool grid registry, loadable from maps.yaml files."""

    def __init__(self) -> None:
        self._maps: dict[str, np.ndarray] = {}
        self._masks: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    def register(self, name: str, grid: np.ndarray | str) -> None:
        if isinstance(grid, str):
            grid, smask, gmask = parse_ascii_map_ex(grid)
            free = ~grid
            if (free & ~smask).any() or (free & ~gmask).any():
                self._masks[name] = (smask, gmask)
        self._maps[name] = np.asarray(grid, dtype=bool)

    def load_yaml(self, path: str) -> None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)
        for name, text in data.items():
            self.register(str(name), text)

    def load_reference_suite(self, suite_dir: str) -> None:
        self.load_yaml(os.path.join(suite_dir, "maps.yaml"))

    def __getitem__(self, name: str) -> np.ndarray:
        return self._maps[name]

    def __contains__(self, name: str) -> bool:
        return name in self._maps

    def masks(self, name: str):
        """(start_allowed, goal_allowed) bool masks, or None if unrestricted."""
        return self._masks.get(name)

    def names(self) -> list[str]:
        return sorted(self._maps)

    def __len__(self) -> int:
        return len(self._maps)

    def stitch_tiles(self, prefix: str, tiles_per_side: int = 4) -> np.ndarray:
        """Reassemble a full map from registered ``{prefix}_{k:02d}`` tiles.

        The reference's 04-movingai suite ships 256x256 MovingAI city maps as
        4x4 grids of 64x64 tiles in row-major order
        (ref:eval_configs/04-movingai/maps.yaml — verified by >95 % obstacle
        continuity across row-major tile seams vs ~59 % column-major).
        Registers and returns the stitched map under ``prefix``.
        """
        rows = []
        for r in range(tiles_per_side):
            rows.append(np.concatenate(
                [self[f"{prefix}_{r * tiles_per_side + c:02d}"]
                 for c in range(tiles_per_side)], axis=1))
        full = np.concatenate(rows, axis=0)
        self._maps[prefix] = full
        return full


# --------------------------------------------------------------------------
# Procedural generators (own implementations; seeds are not pogema-compatible)
# --------------------------------------------------------------------------

def random_grid(size: int, density: float, seed: int) -> np.ndarray:
    """Uniform random obstacles at the given density."""
    rng = np.random.RandomState(seed & 0xFFFFFFFF)
    return rng.rand(size, size) < density


def maze_grid(size: int, seed: int, wall_components: int = 8,
              obstacle_density: float = 0.36) -> np.ndarray:
    """Maze-like map: recursive-backtracker corridors on an odd lattice,
    then knock out extra walls until the obstacle density matches pogema-style
    imperfect mazes (the reference's training/eval maze maps measure ~0.31-0.40
    obstacles, ref:dataset/dataset_configs/11-medium-mazes-eval/maps.yaml)."""
    rng = np.random.RandomState(seed & 0xFFFFFFFF)
    n = size if size % 2 == 1 else size + 1
    grid = np.ones((n, n), dtype=bool)
    start = (1, 1)
    grid[start] = False
    stack = [start]
    while stack:
        i, j = stack[-1]
        nbrs = [
            (ni, nj)
            for ni, nj in ((i - 2, j), (i + 2, j), (i, j - 2), (i, j + 2))
            if 0 < ni < n - 1 and 0 < nj < n - 1 and grid[ni, nj]
        ]
        if not nbrs:
            stack.pop()
            continue
        ni, nj = nbrs[rng.randint(len(nbrs))]
        grid[(i + ni) // 2, (j + nj) // 2] = False
        grid[ni, nj] = False
        stack.append((ni, nj))
    # open extra passages: loops + target obstacle density
    walls = np.argwhere(grid[1:-1, 1:-1]) + 1
    target_obstacles = int(obstacle_density * grid.size)
    extra = max(1, len(walls) // wall_components,
                int(grid.sum()) - target_obstacles)
    if len(walls):
        for k in rng.choice(len(walls), size=min(extra, len(walls)),
                            replace=False):
            grid[tuple(walls[k])] = False
    return grid[:size, :size]


def warehouse_grid(
    rows: int = 8, cols: int = 10, shelf_h: int = 2, shelf_w: int = 5,
    aisle: int = 1, margin: int = 4,
) -> np.ndarray:
    """Warehouse layout: a lattice of shelf blocks separated by aisles
    (shaped after the wfi_warehouse map used by the 03-warehouse suite)."""
    h = rows * shelf_h + (rows + 1) * aisle
    w = cols * shelf_w + (cols + 1) * aisle + 2 * margin
    grid = np.zeros((h, w), dtype=bool)
    for r in range(rows):
        for c in range(cols):
            i0 = aisle + r * (shelf_h + aisle)
            j0 = margin + aisle + c * (shelf_w + aisle)
            grid[i0:i0 + shelf_h, j0:j0 + shelf_w] = True
    return grid


def city_grid(size: int = 256, seed: int = 0) -> np.ndarray:
    """City-like map in the style of the MovingAI street benchmarks
    (Berlin_1_256 class): irregular building blocks separated by a connected
    street lattice, ~50-60 % obstacle density (default seed: 57 %).  The
    MovingAI maps themselves are not in this repository, so the 256x256
    tier runs on this procedural stand-in; the eval path takes real ``.map``
    files through :func:`parse_movingai_map` unchanged."""
    rng = np.random.RandomState(seed & 0xFFFFFFFF)
    grid = np.ones((size, size), dtype=bool)
    # carve a street lattice at irregular intervals (connected by crossing)
    def cuts(n):
        xs, x = [0], 0
        while x < n - 4:
            x += rng.randint(7, 18)
            xs.append(min(x, n - 2))
        return xs
    for i in cuts(size):
        grid[i:i + rng.randint(2, 4), :] = False
    for j in cuts(size):
        grid[:, j:j + rng.randint(2, 4)] = False
    # open plazas / parks
    for _ in range(size // 16):
        i, j = rng.randint(0, size - 12, size=2)
        grid[i:i + rng.randint(4, 12), j:j + rng.randint(4, 12)] = False
    # punch small 2x2 courtyard gaps into some blocks; gaps inside a solid
    # block are disconnected free cells by design — sample_instance places
    # each agent's start and goal in the same connected component, so they
    # act as map texture, never as unreachable goals
    for _ in range(size // 4):
        i, j = rng.randint(0, size - 4, size=2)
        grid[i:i + 2, j:j + 2] = False
    return grid


# --------------------------------------------------------------------------
# Instance building: start/goal placement
# --------------------------------------------------------------------------

@dataclass
class Instance:
    """A single MAPF instance in *padded* coordinates."""

    grid: np.ndarray                 # bool [H, W] incl. obstacle border
    starts: np.ndarray               # int32 [A, 2]
    goals: np.ndarray                # int32 [A, 2]
    map_name: str = ""
    seed: int = 0
    lifelong_goals: np.ndarray | None = None   # int32 [A, K, 2] for on_target=restart

    @property
    def num_agents(self) -> int:
        return len(self.starts)


def _components(grid: np.ndarray) -> np.ndarray:
    """Connected components of free cells (4-connectivity), 0 for obstacles.

    Mirrors ref:mapf_gpt/observation_generator.cpp:4-41 (mark_components)."""
    h, w = grid.shape
    comp = np.zeros((h, w), dtype=np.int32)
    cur = 0
    from collections import deque

    for si in range(h):
        for sj in range(w):
            if grid[si, sj] or comp[si, sj]:
                continue
            cur += 1
            comp[si, sj] = cur
            q = deque([(si, sj)])
            while q:
                i, j = q.popleft()
                for ni, nj in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
                    if 0 <= ni < h and 0 <= nj < w and not grid[ni, nj] and not comp[ni, nj]:
                        comp[ni, nj] = cur
                        q.append((ni, nj))
    return comp


def sample_instance(
    grid: np.ndarray,
    num_agents: int,
    seed: int,
    map_name: str = "",
    pad: bool = True,
    num_lifelong_goals: int = 0,
    masks: tuple[np.ndarray, np.ndarray] | None = None,
) -> Instance:
    """Sample unique start cells and unique goal cells on free cells, with each
    agent's start and goal in the same connected component (solvability, as
    pogema guarantees).  `masks` = optional (start_allowed, goal_allowed)
    placement restrictions (warehouse maps).  Our own seeding scheme (numpy
    RandomState(seed)); pogema's RNG stream is not reproduced.
    """
    if masks is not None:
        smask, gmask = masks
    else:
        smask = gmask = np.ones_like(grid, dtype=bool)
    if pad:
        grid = pad_grid(grid)
        smask = np.pad(smask, C2G_RADIUS, constant_values=False)
        gmask = np.pad(gmask, C2G_RADIUS, constant_values=False)
    else:
        # the tokenizer's window gather needs a full C2G_RADIUS obstacle
        # border (out-of-range window cells would read 0 rather than
        # clamp): fail here instead of producing wrong observations
        r = C2G_RADIUS
        border = np.ones_like(grid)
        border[r:-r, r:-r] = False
        if not grid[border].all():
            raise ValueError(
                f"pad=False requires a {r}-cell obstacle border "
                "(see maps.pad_grid); got free cells within the border")
    rng = np.random.RandomState(seed & 0xFFFFFFFF)
    comp = _components(grid)
    free = np.argwhere(~grid)
    start_cand = np.argwhere(~grid & smask)
    if len(start_cand) < num_agents:
        raise ValueError("not enough start cells")
    order = rng.permutation(len(start_cand))
    starts = start_cand[order[:num_agents]].astype(np.int32)

    # goals: per component, permute that component's allowed cells
    goals = np.zeros_like(starts)
    used = set()
    for a in range(num_agents):
        c = comp[starts[a, 0], starts[a, 1]]
        cand = np.argwhere(~grid & gmask)
        cells = cand[comp[cand[:, 0], cand[:, 1]] == c]
        if len(cells) == 0:
            raise ValueError("no goal cells reachable from start")
        perm = rng.permutation(len(cells))
        for k in perm:
            cell = (int(cells[k, 0]), int(cells[k, 1]))
            if cell not in used:
                goals[a] = cells[k]
                used.add(cell)
                break
        else:
            raise ValueError("could not place unique goal")

    lifelong = None
    if num_lifelong_goals > 0:
        lifelong = np.zeros((num_agents, num_lifelong_goals, 2), dtype=np.int32)
        # queued goals obey the same placement mask as one-shot goals
        # (pogema's lifelong warehouse spawns goals on the aisle cells
        # only); fall back to any free cell if the mask is empty in a
        # component
        gcand = np.argwhere(~grid & gmask)
        for a in range(num_agents):
            c = comp[starts[a, 0], starts[a, 1]]
            cells = gcand[comp[gcand[:, 0], gcand[:, 1]] == c]
            if len(cells) == 0:
                cells = free[comp[free[:, 0], free[:, 1]] == c]
            idx = rng.randint(0, len(cells), size=num_lifelong_goals)
            lifelong[a] = cells[idx]
        goals = lifelong[:, 0].copy()

    return Instance(grid=grid, starts=starts, goals=goals, map_name=map_name,
                    seed=seed, lifelong_goals=lifelong)
