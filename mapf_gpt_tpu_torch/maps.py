"""Procedural maps and start/goal placement (numpy only).

The port's copy of the parts of ``mapf_gpt_tpu/maps.py`` that the batched
rollout needs: ``pad_grid``, ``random_grid``, ``Instance``, ``_components``
and ``sample_instance``.  Same seeds give the same arrays as the JAX
package's versions (``tests/test_torch_maps.py``).

All grids are numpy bool arrays, True = obstacle.  ``pad_grid`` adds the
C2G_RADIUS obstacle border that the tokenizer's window gather relies on.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from mapf_gpt_tpu_torch.ops.vocab import C2G_RADIUS


def pad_grid(grid: np.ndarray, border: int = C2G_RADIUS) -> np.ndarray:
    """Surround with an obstacle border of width `border` (reference frame)."""
    return np.pad(grid, border, constant_values=True)


def random_grid(size: int, density: float, seed: int) -> np.ndarray:
    """Uniform random obstacles at the given density."""
    rng = np.random.RandomState(seed & 0xFFFFFFFF)
    return rng.rand(size, size) < density


@dataclass
class Instance:
    """A single MAPF instance in *padded* coordinates."""

    grid: np.ndarray                 # bool [H, W] incl. obstacle border
    starts: np.ndarray               # int32 [A, 2]
    goals: np.ndarray                # int32 [A, 2]


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
            q = deque([(si, sj)])
            while q:
                i, j = q.popleft()
                for ni, nj in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
                    if (0 <= ni < h and 0 <= nj < w and not grid[ni, nj]
                            and not comp[ni, nj]):
                        comp[ni, nj] = cur
                        q.append((ni, nj))
    return comp


def sample_instance(grid: np.ndarray, num_agents: int, seed: int) -> Instance:
    """Pad `grid` with the obstacle border, then sample unique start cells
    and unique goal cells on free cells, with each agent's start and goal in
    the same connected component."""
    grid = pad_grid(grid)
    rng = np.random.RandomState(seed & 0xFFFFFFFF)
    comp = _components(grid)
    free = np.argwhere(~grid)
    if len(free) < num_agents:
        raise ValueError("not enough start cells")
    order = rng.permutation(len(free))
    starts = free[order[:num_agents]].astype(np.int32)

    # goals: per component, permute that component's cells
    goals = np.zeros_like(starts)
    used = set()
    free_comp = comp[free[:, 0], free[:, 1]]
    for a in range(num_agents):
        cells = free[free_comp == comp[starts[a, 0], starts[a, 1]]]
        perm = rng.permutation(len(cells))
        for k in perm:
            cell = (int(cells[k, 0]), int(cells[k, 1]))
            if cell not in used:
                goals[a] = cells[k]
                used.add(cell)
                break
        else:
            raise ValueError("could not place unique goal")
    return Instance(grid=grid, starts=starts, goals=goals)
