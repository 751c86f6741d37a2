"""MAPF instances from a seed: random grids with starts and goals, a frozen copy of
the program's ``maps.random_grid`` and ``maps.sample_instance`` (one-shot MAPF,
no placement masks), so that the traffic cannot move with the program.

All grids are numpy bool arrays, True = obstacle, padded with the obstacle
border of width 5 that the tokenizer's 11 x 11 window needs; coordinates are in
that padded frame.
"""

from __future__ import annotations

from collections import deque

import numpy as np

BORDER = 5


def random_grid(size: int, density: float, seed: int) -> np.ndarray:
    """Uniform random obstacles at the given density."""
    rng = np.random.RandomState(seed & 0xFFFFFFFF)
    return rng.rand(size, size) < density


def _components(grid: np.ndarray) -> np.ndarray:
    """Connected components of free cells (4-connectivity), 0 for obstacles."""
    h, w = grid.shape
    comp = np.zeros((h, w), dtype=np.int32)
    cur = 0
    for si in range(h):
        for sj in range(w):
            if grid[si, sj] or comp[si, sj]:
                continue
            cur += 1
            comp[si, sj] = cur
            queue = deque([(si, sj)])
            while queue:
                i, j = queue.popleft()
                for ni, nj in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
                    if 0 <= ni < h and 0 <= nj < w and not grid[ni, nj] and not comp[ni, nj]:
                        comp[ni, nj] = cur
                        queue.append((ni, nj))
    return comp


def sample_instance(grid: np.ndarray, num_agents: int, seed: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(padded grid, starts int32 [A, 2], goals int32 [A, 2]): unique start
    cells and unique goal cells on free cells, each agent's goal in its start's
    connected component."""
    grid = np.pad(grid, BORDER, constant_values=True)
    rng = np.random.RandomState(seed & 0xFFFFFFFF)
    comp = _components(grid)
    start_cand = np.argwhere(~grid)
    if len(start_cand) < num_agents:
        raise ValueError("not enough start cells")
    order = rng.permutation(len(start_cand))
    starts = start_cand[order[:num_agents]].astype(np.int32)
    goals = np.zeros_like(starts)
    used = set()
    for a in range(num_agents):
        c = comp[starts[a, 0], starts[a, 1]]
        cand = np.argwhere(~grid)
        cells = cand[comp[cand[:, 0], cand[:, 1]] == c]
        for k in rng.permutation(len(cells)):
            cell = (int(cells[k, 0]), int(cells[k, 1]))
            if cell not in used:
                goals[a] = cells[k]
                used.add(cell)
                break
        else:
            raise ValueError("could not place unique goal")
    return grid, starts, goals


def instance_batch(size: int, density: float, envs: int, agents: int, seeds
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stacked (grids [B, H, W], starts [B, A, 2], goals [B, A, 2]) of `envs`
    instances, the i-th from ``seeds[i]`` (its map and its placement)."""
    insts = [sample_instance(random_grid(size, density, int(s)), agents, int(s))
             for s in seeds[:envs]]
    return tuple(np.stack([inst[k] for inst in insts]) for k in range(3))
