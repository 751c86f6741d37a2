"""Weights of a DeepSeek-V3-type policy (the Moonlight configuration) from a
seed, drawn on the device one layer at a time, in the source's key names.

The scheme (the configuration's ``assumed.init``): normal(0, 0.02) for the
embedding, the head and every projection, the output projections
(``o_proj``, ``down_proj``) scaled by 1 / sqrt(2 L); RMSNorm gains 1; the
router's weight in float32, its correction bias 0; everything else drawn in
bfloat16, the dtype the configuration runs.  Each MoE layer's routed experts
come stacked (``mlp.experts.gate_proj.weight`` [X, f, E], ``up_proj`` the
same, ``down_proj`` [X, E, f]).  :func:`draw` yields the parts in one fixed
order from one generator, so the program (which copies each part into its
own layout and drops it) and the reference (which draws them again after
the window) see the same numbers without the card ever holding two copies.
"""

from __future__ import annotations

import math

import torch

BF16 = torch.bfloat16


def layer_shapes(cfg: dict, i: int) -> list[tuple[str, tuple[int, ...]]]:
    """(key without ``model.layers.{i}.``, shape) of layer i's weights, in drawing order."""
    e, h, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    out = [("input_layernorm.weight", (e,)), ("self_attn.q_proj.weight", (h * (dn + dr), e)),
           ("self_attn.kv_a_proj_with_mqa.weight", (r + dr, e)),
           ("self_attn.kv_a_layernorm.weight", (r,)),
           ("self_attn.kv_b_proj.weight", (h * (dn + dv), r)),
           ("self_attn.o_proj.weight", (e, h * dv)), ("post_attention_layernorm.weight", (e,))]
    if i < cfg["first_k_dense_replace"]:
        fd = cfg["intermediate_size"]
        return out + [("mlp.gate_proj.weight", (fd, e)), ("mlp.up_proj.weight", (fd, e)),
                      ("mlp.down_proj.weight", (e, fd))]
    x, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    sf = cfg["n_shared_experts"] * f
    return out + [("mlp.gate.weight", (x, e)), ("mlp.gate.e_score_correction_bias", (x,)),
                  ("mlp.experts.gate_proj.weight", (x, f, e)),
                  ("mlp.experts.up_proj.weight", (x, f, e)),
                  ("mlp.experts.down_proj.weight", (x, e, f)),
                  ("mlp.shared_experts.gate_proj.weight", (sf, e)),
                  ("mlp.shared_experts.up_proj.weight", (sf, e)),
                  ("mlp.shared_experts.down_proj.weight", (e, sf))]


def parameter_count(cfg: dict) -> int:
    e, v = cfg["hidden_size"], cfg["vocab_size"]
    layers = sum(math.prod(s) for i in range(cfg["num_hidden_layers"])
                 for _, s in layer_shapes(cfg, i))
    return layers + 2 * v * e + e


def draw(cfg: dict, seed: int, device):
    """Yields ("embed", {...}), then (i, layer i's weights) for every layer,
    then ("head", {...}): float32 gains, router weight and bias, bfloat16 else."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    e, v = cfg["hidden_size"], cfg["vocab_size"]
    proj = 1.0 / math.sqrt(2.0 * cfg["num_hidden_layers"])
    normal = lambda shape, dtype=BF16: torch.randn(shape, generator=gen, device=device,
                                                   dtype=dtype).mul_(0.02)
    yield "embed", {"model.embed_tokens.weight": normal((v, e))}
    for i in range(cfg["num_hidden_layers"]):
        sd = {}
        for key, shape in layer_shapes(cfg, i):
            if key.endswith("layernorm.weight"):
                sd[key] = torch.ones(shape, device=device)
            elif key.endswith("e_score_correction_bias"):
                sd[key] = torch.zeros(shape, device=device)
            elif key == "mlp.gate.weight":
                sd[key] = normal(shape, torch.float32)
            else:
                w = normal(shape)
                sd[key] = w.mul_(proj) if key.endswith(("o_proj.weight", "down_proj.weight")) \
                    else w
        yield i, sd
    yield "head", {"model.norm.weight": torch.ones(e, device=device),
                   "lm_head.weight": normal((v, e))}
