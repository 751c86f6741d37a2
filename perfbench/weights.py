"""Policy weights from a seed, made on the device in one draw.

The scheme is the MAPF-GPT (nanoGPT) initialisation the program's
``models.gpt.init_params`` follows: normal(0, 0.02) for the embeddings and every
linear weight, the residual projections (``c_proj``) scaled by 1/sqrt(2L),
LayerNorm gains 1.  The normal draws come from one ``torch.randn`` over all of
them, sliced into leaves in the reference checkpoint's key layout; the same
tensors feed the program (copied into its parameters) and the reference.
"""

from __future__ import annotations

import math

import torch


def leaf_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(state-dict key, shape) of every weight, the tied head left out."""
    e, t, v = cfg["n_embd"], cfg["block_size"], cfg["vocab_size"]
    leaves = [("transformer.wte.weight", (v, e)), ("transformer.wpe.weight", (t, e))]
    for i in range(cfg["n_layer"]):
        p = f"transformer.h.{i}."
        leaves += [(p + "ln_1.weight", (e,)), (p + "attn.c_attn.weight", (3 * e, e)),
                   (p + "attn.c_proj.weight", (e, e)), (p + "ln_2.weight", (e,)),
                   (p + "mlp.c_fc.weight", (4 * e, e)), (p + "mlp.c_proj.weight", (e, 4 * e))]
    return leaves + [("transformer.ln_f.weight", (e,))]


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """float32 weights from `seed`, on `device`; ``lm_head.weight`` is the token
    embedding itself."""
    leaves = leaf_shapes(cfg)
    drawn = [(k, s) for k, s in leaves if len(s) == 2]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device).mul_(0.02)
    out, at = {}, 0
    proj = 1.0 / math.sqrt(2.0 * cfg["n_layer"])
    for key, shape in leaves:
        if len(shape) == 1:
            out[key] = torch.ones(shape, device=device)
            continue
        n = math.prod(shape)
        out[key] = flat[at:at + n].view(shape)
        if key.endswith("c_proj.weight"):
            out[key].mul_(proj)
        at += n
    out["lm_head.weight"] = out["transformer.wte.weight"]
    return out
