"""Dense cost-to-go (BFS distance-from-goal) fields.

Port of ``mapf_gpt_tpu/ops/cost2go.py``.  Two implementations with identical
results (4-connected unit-cost BFS):

- :func:`cost2go_host` — numpy BFS, the parity oracle.
- :func:`cost2go_device` — batched sweep relaxation on the tensors' device.
  Each round runs four directional sweeps (down/up/right/left), vectorized
  over the other axis and the batch of goals.  Rounds repeat until a round
  changes nothing; that check reads one flag back to the host per round.

A sweep is the JAX package's ``lax.scan`` of d[i] = min(d[i], d[i-1] + 1)
over free cells (INF on obstacles), computed as a segmented cumulative
minimum: within a run of free cells it is min over j <= i of d[j] + (i - j),
that is cummin(d - j) + i, and an offset per run keeps each run's minimum
from reaching across an obstacle.  The integers are exactly the scan's
(``tests/test_torch_cost2go.py`` holds it against a loop over the rows and
against JAX); it costs a few launches a sweep instead of a few per row,
which matters where the lazy lifelong env relaxes its fields in every step
(``envs/env.step``).  :func:`relax_fixpoint_rows` is that loop over the
rows, the plain version the tests and ``chip_smoke.py`` hold the sweep
against.

Convention: fields are int32, ``-1`` marks unreachable cells and obstacles.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from mapf_gpt_tpu_torch.utils.profiling import span

INF = 1 << 20  # internal "unreached" marker during relaxation
# Offset between runs of free cells in a sweep: more than any d - j within a
# run (d <= INF, j < the grid's side), so an earlier run's keys are all larger.
_RUN = 1 << 22
_NEVER = 1 << 62   # the key of an obstacle cell: never a run's minimum


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


# A round's four sweeps, in the JAX package's order: down, up, right, left.
_SWEEPS = ((-2, False), (-2, True), (-1, False), (-1, True))


def _run_offsets(free: torch.Tensor, axis: int) -> torch.Tensor:
    """int64 offset of each cell along `axis`: its index j plus _RUN times
    the number of obstacles before it (so a run's cells share the second
    term, and a later run's is larger)."""
    n = free.shape[axis]
    shape = [1] * free.dim()
    shape[axis] = n
    j = torch.arange(n, device=free.device).view(shape)
    return torch.cumsum(~free, dim=axis, dtype=torch.int64) * _RUN + j


def _sweep(dist: torch.Tensor, free: torch.Tensor, offset: torch.Tensor,
           axis: int) -> torch.Tensor:
    """One forward sweep along `axis` (-2 rows, -1 columns): d[i] =
    min(d[i], d[i-1] + 1) on free cells, INF on obstacles, as the segmented
    cumulative minimum of d - offset (offset from :func:`_run_offsets`)."""
    key = torch.where(free, dist.long() - offset, _NEVER)
    best = torch.cummin(key, dim=axis).values + offset
    return torch.where(free, best, INF).to(torch.int32)


def relax_fixpoint(dist0: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """Repeat relaxation rounds until one changes nothing.

    dist0: int32 [..., H, W] seed distances (INF = unreached; obstacles may
    carry any value, each sweep sets them to INF); free: bool, same shape.
    A seed that is already a fixpoint costs one round."""
    # a backward sweep is a forward sweep of the flipped tensors
    plan = []
    for axis, reverse in _SWEEPS:
        f = free.flip(axis) if reverse else free
        plan.append((axis, reverse, f, _run_offsets(f, axis)))

    def relax_round(dist: torch.Tensor) -> torch.Tensor:
        for axis, reverse, f, offset in plan:
            if reverse:
                dist = _sweep(dist.flip(axis), f, offset, axis).flip(axis)
            else:
                dist = _sweep(dist, f, offset, axis)
        return dist

    dist, changed = dist0, True
    while changed:
        with span("mapf.cost2go.relax_round"):     # the four sweeps and the flag read
            new = relax_round(dist)
            changed = bool((new != dist).any())
        dist = new
    return dist


def relax_fixpoint_rows(dist0: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """:func:`relax_fixpoint` as the JAX package's ``lax.scan`` writes it:
    each sweep a loop over the rows (or columns), the same integers."""
    def sweep(d: torch.Tensor, axis: int, reverse: bool) -> torch.Tensor:
        d, f = d.movedim(axis, 0), free.movedim(axis, 0)
        out, carry = torch.empty_like(d), torch.full_like(d[0], INF)
        for i in (range(d.shape[0] - 1, -1, -1) if reverse else range(d.shape[0])):
            carry = torch.where(f[i], torch.minimum(d[i], carry + 1), INF)
            out[i] = carry
        return out.movedim(0, axis)

    def relax_round(dist: torch.Tensor) -> torch.Tensor:
        for axis, reverse in _SWEEPS:
            dist = sweep(dist, axis, reverse)
        return dist

    dist = relax_round(dist0)
    changed = bool((dist != dist0).any())
    while changed:
        new = relax_round(dist)
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
