"""Grid dynamics and soft collision arbitration over a batch of envs.

Port of ``mapf_gpt_tpu/envs/dynamics.py`` with an explicit leading batch
dimension B:

- 5 discrete actions: wait / up / down / left / right.
- A move into an obstacle cell is canceled (the agent waits).
- Vertex conflict: if two or more agents would occupy the same cell, all
  conflicting *movers* are canceled (a stationary agent keeps its cell).
- Edge (swap) conflict: two agents exchanging cells are both canceled.
- Cancellations cascade: rounds repeat until one changes nothing.

The arbiter loops until stable, reading one flag back to the host per
round (the JAX package's ``lax.while_loop``; usually 1-2 rounds).  A round
leaves a stable batch unchanged, so looping the whole batch until every
env is stable gives each env the positions the per-env loop gives.
"""

from __future__ import annotations

import torch

from mapf_gpt_tpu_torch.ops.vocab import MOVES
from mapf_gpt_tpu_torch.utils.profiling import span


def propose_moves(grid: torch.Tensor, pos: torch.Tensor, actions: torch.Tensor,
                  active: torch.Tensor) -> torch.Tensor:
    """Desired next cells after obstacle masking.

    grid: bool [B, H, W] (True = obstacle); pos: int [B, A, 2]; actions:
    int [B, A]; active: bool [B, A].  The grid carries an obstacle border,
    so desired cells are always in bounds."""
    moves = torch.tensor(MOVES, dtype=pos.dtype, device=pos.device)
    desired = pos + moves[actions.long().clamp(0, 4)]
    bi = torch.arange(grid.shape[0], device=grid.device)[:, None]
    blocked = grid[bi, desired[..., 0].long(), desired[..., 1].long()]
    move_ok = active & ~blocked
    return torch.where(move_ok[..., None], desired, pos)


def resolve_collisions(pos: torch.Tensor, desired: torch.Tensor,
                       active: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Soft collision arbitration to fixpoint. Returns final positions [B, A, 2]."""
    b = pos.shape[0]
    h, w = hw
    n_cells = h * w
    # one slot per cell and env, plus one trash slot per env for inactive agents
    base = (torch.arange(b, device=pos.device) * (n_cells + 1))[:, None]

    def lin(p):
        return p[..., 0].long() * w + p[..., 1].long()

    pos_lin = lin(pos)
    pos_idx = base + torch.where(active, pos_lin, n_cells)

    def round_fn(des):
        des_lin = lin(des)
        des_idx = base + torch.where(active, des_lin, n_cells)
        moving = active & (des_lin != pos_lin)
        # vertex conflicts: count desired cells (stationary agents claim their own)
        counts = torch.zeros(b * (n_cells + 1), dtype=torch.int32,
                             device=pos.device)
        counts.index_add_(0, des_idx.flatten(),
                          torch.ones_like(des_idx.flatten(), dtype=torch.int32))
        vertex = counts[base + des_lin] > 1
        # swap conflicts: the occupant of my target cell is moving into my
        # cell.  Occupancy is unique, so the scatters do not collide (only
        # the never-read trash slots do).
        occ_dest = torch.full((b * (n_cells + 1),), -1, dtype=torch.long,
                              device=pos.device)
        occ_dest[pos_idx.flatten()] = des_lin.flatten()
        occupied = torch.zeros(b * (n_cells + 1), dtype=torch.bool,
                               device=pos.device)
        occupied[pos_idx.flatten()] = True
        swap = occupied[base + des_lin] & (occ_dest[base + des_lin] == pos_lin)
        revert = moving & (vertex | swap)
        return torch.where(revert[..., None], pos, des)

    des, changed = desired, True
    while changed:
        with span("mapf.env.arbiter_round"):       # the round and its flag read
            new = round_fn(des)
            changed = bool((new != des).any())
        des = new
    return des


def step_positions(grid: torch.Tensor, pos: torch.Tensor, actions: torch.Tensor,
                   active: torch.Tensor) -> torch.Tensor:
    """Full position update: propose + arbitrate."""
    desired = propose_moves(grid, pos, actions, active)
    return resolve_collisions(pos, desired, active, tuple(grid.shape[-2:]))
