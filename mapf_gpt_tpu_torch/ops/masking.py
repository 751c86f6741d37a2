"""Context masking ablations and token decoding.

Port of ``mapf_gpt_tpu/ops/masking.py``: the four input-ablation switches
of the reference's analysis runs (mask the action history, the cost2go
window, the goal, or the greedy action), applied to whole [..., 256] token
tensors right after ``ops/obs.observe``, and a decoder of a context for
debugging.  The masks are exact integer selects, equal to the JAX
package's (``tests/test_torch_masking.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mapf_gpt_tpu_torch.ops import vocab as V


class MaskConfig(NamedTuple):
    mask_actions_history: bool = False
    mask_cost2go: bool = False
    mask_goal: bool = False
    mask_greed_action: bool = False

    @property
    def any(self) -> bool:
        return any(self)


def _record_offsets():
    base = V.C2G_TOKENS + np.arange(V.NUM_NEIGHBORS) * V.AGENT_RECORD
    return base


def _selectors() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """bool [256] positions of the history, goal and greedy-action tokens."""
    sel_hist = np.zeros(V.CONTEXT_SIZE, dtype=bool)
    sel_goal = np.zeros(V.CONTEXT_SIZE, dtype=bool)
    sel_greedy = np.zeros(V.CONTEXT_SIZE, dtype=bool)
    for b in _record_offsets():
        sel_hist[b + 4: b + 4 + V.NUM_PREV_ACTIONS] = True
        sel_goal[b + 2: b + 4] = True
        sel_greedy[b + 4 + V.NUM_PREV_ACTIONS] = True
    return sel_hist, sel_goal, sel_greedy


def apply_masks(tokens: torch.Tensor, cfg: MaskConfig) -> torch.Tensor:
    """tokens: int [..., 256] -> masked copy (the reference's semantics)."""
    if not cfg.any:
        return tokens
    sel_hist, sel_goal, sel_greedy = (torch.from_numpy(m).to(tokens.device)
                                      for m in _selectors())
    pad = torch.tensor(V.ID_PAD, dtype=tokens.dtype, device=tokens.device)
    out = tokens
    if cfg.mask_actions_history:
        out = torch.where(sel_hist, pad, out)
    if cfg.mask_goal:
        out = torch.where(sel_goal, pad, out)
    if cfg.mask_greed_action:
        out = torch.where(sel_greedy, pad, out)
    if cfg.mask_cost2go:
        # every cost2go cell except blocked (-80) becomes "0"
        in_c2g = torch.arange(V.CONTEXT_SIZE, device=tokens.device) < V.C2G_TOKENS
        zero = torch.tensor(V.ID_COORD_ZERO, dtype=tokens.dtype, device=tokens.device)
        out = torch.where(in_c2g & (out != V.ID_UNREACHABLE), zero, out)
    return out


# -- decoding (host-side debugging) ------------------------------------------

_ACTION_CHARS = "nwudlr"


def token_to_str(tok: int) -> str:
    tok = int(tok)
    if tok < V.ID_COORD_ZERO * 2 + 1:
        return str(tok - V.ID_COORD_ZERO)
    if tok == V.ID_UNREACHABLE:
        return str(-4 * V.C2G_LIMIT)
    if tok == V.ID_FAR_NEG:
        return str(-2 * V.C2G_LIMIT)
    if tok == V.ID_FAR_POS:
        return str(2 * V.C2G_LIMIT)
    if V.ID_ACTION_BASE <= tok < V.ID_NEXT_ACTION_BASE:
        return _ACTION_CHARS[tok - V.ID_ACTION_BASE]
    if V.ID_NEXT_ACTION_BASE <= tok < V.ID_PAD:
        return format(tok - V.ID_NEXT_ACTION_BASE, "04b")
    return "!"


def decode_context(tokens: np.ndarray) -> dict:
    """int [256] -> {"cost2go": int [11,11] str-values, "agents": [...]}
    mirroring the reference decoder's structure."""
    tokens = np.asarray(tokens)
    if tokens.shape != (V.CONTEXT_SIZE,):
        raise ValueError(f"decode_context: one context of {V.CONTEXT_SIZE} tokens; "
                         f"got {tokens.shape}")
    c2g = np.array([token_to_str(t) for t in tokens[:V.C2G_TOKENS]]
                   ).reshape(V.C2G_WINDOW, V.C2G_WINDOW)
    agents = []
    for b in _record_offsets():
        rec = tokens[b: b + V.AGENT_RECORD]
        if rec[0] == V.ID_PAD:
            continue
        agents.append({
            "relative_pos": (int(rec[0]) - V.ID_COORD_ZERO,
                             int(rec[1]) - V.ID_COORD_ZERO),
            "relative_goal": (int(rec[2]) - V.ID_COORD_ZERO,
                              int(rec[3]) - V.ID_COORD_ZERO),
            "previous_actions": [token_to_str(t) for t in rec[4:-1]],
            "next_action": token_to_str(rec[-1]),
        })
    return {"cost2go": c2g, "agents": agents}
