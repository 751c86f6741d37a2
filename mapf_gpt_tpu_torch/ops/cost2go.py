"""Dense cost-to-go (BFS distance-from-goal) fields.

Port of ``mapf_gpt_tpu/ops/cost2go.py``.  Two implementations with identical
results (4-connected unit-cost BFS):

- :func:`cost2go_host` — numpy BFS, the parity oracle.
- :func:`cost2go_device` — batched sweep relaxation on the tensors' device.
  Each round runs four directional sweeps (down/up/right/left), each a loop
  over the rows or columns, vectorized over the other axis and the batch of
  goals.  Rounds repeat until a round changes nothing; that check reads one
  flag back to the host per round, which is fine at reset, the only caller
  in this slice.

Convention: fields are int32, ``-1`` marks unreachable cells and obstacles.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

INF = 1 << 20  # internal "unreached" marker during relaxation


def cost2go_host(grid: np.ndarray, goal: tuple[int, int]) -> np.ndarray:
    """BFS distance-from-goal on the host. grid: bool/int [H,W], True=obstacle."""
    h, w = grid.shape
    dist = np.full((h, w), -1, dtype=np.int32)
    gi, gj = int(goal[0]), int(goal[1])
    if grid[gi, gj]:
        return dist
    dist[gi, gj] = 0
    q = deque([(gi, gj)])
    while q:
        i, j = q.popleft()
        d = dist[i, j] + 1
        for ni, nj in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1)):
            if 0 <= ni < h and 0 <= nj < w and not grid[ni, nj] and dist[ni, nj] < 0:
                dist[ni, nj] = d
                q.append((ni, nj))
    return dist


def _sweep(dist: torch.Tensor, free: torch.Tensor, axis: int,
           reverse: bool) -> torch.Tensor:
    """One directional sweep along `axis` (-2 rows, -1 columns):
    d[i] = min(d[i], d[i-1] + 1) on free cells, INF on obstacles."""
    d = dist.movedim(axis, 0)
    f = free.movedim(axis, 0)
    out = torch.empty_like(d)
    carry = torch.full_like(d[0], INF)
    order = range(d.shape[0] - 1, -1, -1) if reverse else range(d.shape[0])
    inf = torch.tensor(INF, dtype=d.dtype, device=d.device)
    for i in order:
        carry = torch.where(f[i], torch.minimum(d[i], carry + 1), inf)
        out[i] = carry
    return out.movedim(0, axis)


def _relax_round(dist: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    dist = _sweep(dist, free, axis=-2, reverse=False)  # down
    dist = _sweep(dist, free, axis=-2, reverse=True)   # up
    dist = _sweep(dist, free, axis=-1, reverse=False)  # right
    dist = _sweep(dist, free, axis=-1, reverse=True)   # left
    return dist


def relax_fixpoint(dist0: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """Repeat relaxation rounds until one changes nothing.

    dist0: int32 [..., H, W] seed distances (INF = unreached); free: bool,
    same shape."""
    dist = _relax_round(dist0, free)
    changed = bool((dist != dist0).any())
    while changed:
        new = _relax_round(dist, free)
        changed = bool((new != dist).any())
        dist = new
    return dist


def goal_seed(grid: torch.Tensor, goals: torch.Tensor):
    """(dist0, free) relaxation seed for batched per-goal fields.

    grid: bool [H, W], or [N, H, W] with one grid per goal; goals: int
    [N, 2].  Returns ([N,H,W] int32 seed with 0 at each goal, [N,H,W] bool
    free)."""
    h, w = grid.shape[-2:]
    n = goals.shape[0]
    free = torch.logical_not(grid).expand(n, h, w)
    rows = torch.arange(h, device=grid.device)[None, :, None]
    cols = torch.arange(w, device=grid.device)[None, None, :]
    at_goal = (rows == goals[:, 0, None, None]) & (cols == goals[:, 1, None, None])
    dist0 = torch.where(at_goal & free, 0, INF).to(torch.int32)
    return dist0, free


def cost2go_device(grid: torch.Tensor, goals: torch.Tensor) -> torch.Tensor:
    """Batched dense cost2go fields on the tensors' device.

    grid: bool [H, W] or [N, H, W] (True = obstacle); goals: int [N, 2].
    Returns int32 [N, H, W]; -1 for unreachable cells and obstacles."""
    dist0, free = goal_seed(grid, goals)
    dist = relax_fixpoint(dist0, free)
    return torch.where(dist >= INF, -1, dist).to(torch.int32)
