"""Observation tokenization: batched env state -> int32 [B, A, 256] contexts.

Port of ``mapf_gpt_tpu/ops/obs.py`` over an explicit [B, A] batch:

1. **cost2go window** — 11x11 window around each agent, value relative to
   the center, clamped to ±20 with ±40 sentinels, unreachable cells -80.
   A plain gather replaces the JAX package's one-hot window matmul.
2. **greedy-action bits** — one bit per u/d/l/r move that strictly
   decreases cost2go, weighted 8/4/2/1.
3. **neighbor records** — agents within Chebyshev radius 5, ordered by the
   unique key ``manhattan * A + id``, nearest 13 including self.
4. **token assembly** — [121 cost2go][13 x 10 agent record]['!' x 5].

PRECONDITION (as in the JAX package): the grid carries a >= C2G_RADIUS
obstacle border (``maps.pad_grid``), so every window lies inside the field.
A window cell outside the field reads as 0 ("distance 0"), which is what
the JAX package's one-hot extraction gives there: an unpadded grid gives
wrong observations, not an error.
"""

from __future__ import annotations

import torch

from mapf_gpt_tpu_torch.ops import vocab as V
from mapf_gpt_tpu_torch.utils.profiling import span


def _c2g_windows(c2g: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Raw 11x11 windows. c2g: int32 [B, A, H, W]; pos [B, A, 2] ->
    int32 [B, A, 11, 11]; cells outside the field read 0."""
    b, a, hgt, wid = c2g.shape
    r = V.C2G_RADIUS
    offs = torch.arange(-r, r + 1, device=pos.device)
    rows = pos[..., 0:1].long() + offs                     # [B, A, 11]
    cols = pos[..., 1:2].long() + offs
    inside = (((rows >= 0) & (rows < hgt))[..., :, None]
              & ((cols >= 0) & (cols < wid))[..., None, :])
    bi = torch.arange(b, device=pos.device)[:, None, None, None]
    ai = torch.arange(a, device=pos.device)[None, :, None, None]
    win = c2g[bi, ai, rows.clamp(0, hgt - 1)[..., :, None],
              cols.clamp(0, wid - 1)[..., None, :]]
    return torch.where(inside, win, 0)


def _c2g_window_tokens(windows: torch.Tensor) -> torch.Tensor:
    """[B, A, 11, 11] windows -> cost2go tokens [B, A, 121]."""
    r = V.C2G_RADIUS
    center = windows[..., r:r + 1, r:r + 1]
    delta = windows - center
    tok = torch.where(
        delta > V.C2G_LIMIT, V.ID_FAR_POS,
        torch.where(delta < -V.C2G_LIMIT, V.ID_FAR_NEG,
                    delta + V.ID_COORD_ZERO))
    tok = torch.where(windows < 0, V.ID_UNREACHABLE, tok)
    return tok.flatten(-2)


def _greedy_tokens(windows: torch.Tensor) -> torch.Tensor:
    """Greedy next-action 4-bit mask token per agent, [B, A]."""
    r = V.C2G_RADIUS
    cur = windows[..., r, r]
    # order u d l r matching V.GREEDY_MOVES = ((-1,0),(1,0),(0,-1),(0,1))
    nv = torch.stack([windows[..., r - 1, r], windows[..., r + 1, r],
                      windows[..., r, r - 1], windows[..., r, r + 1]], dim=-1)
    bits = (nv >= 0) & (cur[..., None] > nv)               # [B, A, 4]
    weights = torch.tensor([8, 4, 2, 1], device=windows.device)
    return V.ID_NEXT_ACTION_BASE + (bits * weights).sum(-1)


def _neighbor_indices(pos: torch.Tensor, active: torch.Tensor):
    """Nearest-13 neighbor selection. Returns (idx [B,A,13], valid [B,A,13])."""
    a = pos.shape[1]
    p = pos.long()
    d = p[:, None, :, :] - p[:, :, None, :]                # [B, A, A, 2] other - self
    adx, ady = d[..., 0].abs(), d[..., 1].abs()
    within = ((torch.maximum(adx, ady) <= V.AGENTS_RADIUS)
              & active[:, None, :] & active[:, :, None])
    ids = torch.arange(a, device=pos.device)
    big = a * (2 * V.AGENTS_RADIUS + 1) + a                # > any real key
    key = torch.where(within, (adx + ady) * a + ids, big)
    sorted_key, order = torch.sort(key, dim=-1, stable=True)
    k = min(V.NUM_NEIGHBORS, a)
    idx = order[..., :k]
    valid = sorted_key[..., :k] < big
    if k < V.NUM_NEIGHBORS:
        padn = V.NUM_NEIGHBORS - k
        idx = torch.nn.functional.pad(idx, (0, padn))
        valid = torch.nn.functional.pad(valid, (0, padn))
    return idx, valid


@span("mapf.obs.observe")
def observe(c2g: torch.Tensor, pos: torch.Tensor, goal: torch.Tensor,
            hist: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Tokenize a batch of env instances.

    Args:
      c2g: int32 [B, A, H, W] cost2go fields of each agent's goal
        (``envs.env.current_c2g``); see the module's border precondition.
      pos, goal: int [B, A, 2]; hist: int [B, A, P] symbols 0..5;
      active: bool [B, A].

    Returns:
      int32 [B, A, 256] token contexts.
    """
    b, a = pos.shape[:2]
    windows = _c2g_windows(c2g, pos)                       # [B, A, 11, 11]
    c2g_tok = _c2g_window_tokens(windows)                  # [B, A, 121]
    greedy_tok = _greedy_tokens(windows)                   # [B, A]
    hist_tok = V.ID_ACTION_BASE + hist.long()              # [B, A, P]

    idx, valid = _neighbor_indices(pos, active)            # [B, A, 13]
    bi = torch.arange(b, device=pos.device)[:, None, None]
    p = pos.long()
    rel_pos = p[bi, idx] - p[:, :, None, :]                # [B, A, 13, 2]
    rel_goal = (goal.long()[bi, idx] - p[:, :, None, :]).clamp(
        -V.C2G_LIMIT, V.C2G_LIMIT)
    rec = torch.cat([
        rel_pos + V.ID_COORD_ZERO,
        rel_goal + V.ID_COORD_ZERO,
        hist_tok[bi, idx],                                 # [B, A, 13, P]
        greedy_tok[bi, idx][..., None],
    ], dim=-1)                                             # [B, A, 13, 10]
    rec = torch.where(valid[..., None], rec, V.ID_PAD)
    agent_tok = rec.reshape(b, a, V.AGENT_TOKENS)
    pad = torch.full((b, a, V.TAIL_PAD), V.ID_PAD, dtype=agent_tok.dtype,
                     device=pos.device)
    return torch.cat([c2g_tok.to(agent_tok.dtype), agent_tok, pad],
                     dim=-1).to(torch.int32)
