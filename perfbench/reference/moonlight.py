"""Plain PyTorch reference of the Moonlight-16B-A3B block as a MAPF policy:
the last position's logits in float32 (TF32 off), with a float8 variant that
serves as the cell's control.

The model is DeepSeek-V3's block as Moonlight's ``config.json`` sets it
(https://huggingface.co/moonshotai/Moonlight-16B-A3B): per layer, with h the
residual stream,

- multi-head latent attention: ``a = RMSNorm(h)``; ``q = a Wq`` (heads of
  nope | rope columns); ``kv_a = a Wkva`` (latent | one rope key shared by
  the heads); ``c = RMSNorm(latent)``; ``k_nope | v = c Wkvb``; RoPE (theta
  ``rope_theta``, pairs (2i, 2i + 1) rotated by pos theta^(-2i / rope), as
  ``apply_rotary_pos_emb`` does after its interleave) on q's rope columns and
  the shared key; scores ``(q_nope k_nope + q_pe k_pe) / sqrt(nope + rope)``,
  softmax over every position; ``h += (P v) Wo``;
- ``b = RMSNorm(h)``; the first ``first_k_dense_replace`` layers ``h +=
  SwiGLU(b)``; the others: ``s = sigmoid(b Wr)`` in float32, the
  ``num_experts_per_tok`` experts of largest ``s + e_bias`` (ties to the
  lower index), weights ``routed_scaling_factor s_i / (sum of the chosen s +
  1e-20)``, ``h += sum_i w_i E_i(b) + S(b)``, the routed experts run one at a
  time on the rows that chose them, ``S`` the shared experts' SwiGLU;
- ``logits = RMSNorm(h[T - 1]) W_head``, the head untied.

Every position of every layer is computed.  Departures from the source, as
the configuration file lists them: non-causal attention and the MAPF
vocabulary; no YaRN, multi-token prediction or auxiliary loss.

Weights come from ``perfbench/moe_weights.draw`` one layer at a time, so the
reference runs a layer over every context (in blocks of ``rows``) before it
draws the next.  ``precision="fp8"`` rounds both operands of every product
but the router's to float8 e4m3 with one scale a tensor (the step below the
bfloat16 the configuration states; the router is stated in float32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.gpt import fp8_round


def _matmul(precision: str):
    if precision == "fp32":
        return torch.matmul
    if precision == "fp8":
        return lambda a, b: fp8_round(a) @ fp8_round(b)
    raise ValueError(f"reference: unknown precision {precision!r}")


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * gain.float()


def _rope(x: torch.Tensor, t: int, theta: float) -> torch.Tensor:
    dim = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=x.device) / dim))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack((x0 * cos - x1 * sin, x0 * sin + x1 * cos), dim=-1).flatten(-2)


def _swiglu(x, gate, up, down, mm):
    return mm(F.silu(mm(x, gate.float().t())) * mm(x, up.float().t()), down.float().t())


def attention(a: torch.Tensor, w: dict, cfg: dict, mm) -> torch.Tensor:
    n, t, _ = a.shape
    h, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    r, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    q = mm(a, w["self_attn.q_proj.weight"].float().t()).view(n, t, h, dn + dr).transpose(1, 2)
    kv_a = mm(a, w["self_attn.kv_a_proj_with_mqa.weight"].float().t())
    c = rms_norm(kv_a[..., :r], w["self_attn.kv_a_layernorm.weight"], eps)
    kv = mm(c, w["self_attn.kv_b_proj.weight"].float().t()).view(n, t, h, dn + dv).transpose(1, 2)
    q_pe = _rope(q[..., dn:], t, cfg["rope_theta"])
    k_pe = _rope(kv_a[..., r:], t, cfg["rope_theta"])[:, None]
    s = (mm(q[..., :dn], kv[..., :dn].transpose(-1, -2))
         + mm(q_pe, k_pe.transpose(-1, -2))) / math.sqrt(dn + dr)
    o = mm(torch.softmax(s, dim=-1), kv[..., dn:]).transpose(1, 2).reshape(n, t, h * dv)
    return mm(o, w["self_attn.o_proj.weight"].float().t())


def route(b: torch.Tensor, w: dict, cfg: dict, force: torch.Tensor | None = None):
    """(chosen experts [M, k], weights [M, k], gap [M]), float32: the k
    experts of largest score + bias, or where `force` ([M, k], -1 rows left
    to the reference) gives a row's experts, those; a row's gap is how far
    its least forced expert's biased score lies below the reference's k-th
    (0 where the choice is the reference's own or not forced)."""
    k = cfg["num_experts_per_tok"]
    s = torch.sigmoid(b @ w["mlp.gate.weight"].float().t())
    biased = s + w["mlp.gate.e_score_correction_bias"].float()
    ranked = torch.sort(biased, dim=-1, descending=True, stable=True)
    idx = ranked.indices[:, :k]
    gap = torch.zeros(b.shape[0], device=b.device)
    if force is not None:
        forced = force[:, 0] >= 0
        take = torch.where(forced[:, None], force.long(), idx)
        below = ranked.values[:, k - 1:k] - biased.gather(1, take)
        gap = torch.where(forced, below.clamp(min=0).amax(-1), gap)
        idx = take
    wk = s.gather(1, idx)
    return idx, wk / (wk.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"], gap


def experts(b: torch.Tensor, w: dict, cfg: dict, mm, record=None, force=None) -> torch.Tensor:
    idx, wk, gap = route(b, w, cfg, force)
    if record is not None:
        record.append((idx.int(), gap))
    out = _swiglu(b, w["mlp.shared_experts.gate_proj.weight"],
                  w["mlp.shared_experts.up_proj.weight"],
                  w["mlp.shared_experts.down_proj.weight"], mm)
    gate, up = w["mlp.experts.gate_proj.weight"], w["mlp.experts.up_proj.weight"]
    down = w["mlp.experts.down_proj.weight"]
    for e in range(cfg["n_routed_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if len(rows):
            y = _swiglu(b[rows], gate[e], up[e], down[e], mm)
            out.index_add_(0, rows, y * wk[rows, slot][:, None])
    return out


def layer(h: torch.Tensor, w: dict, i: int, cfg: dict, precision: str = "fp32",
          record=None, force=None) -> torch.Tensor:
    """Layer i (weights `w` without the layer prefix) on h [N, T, E] float32;
    `record` and `force` as :func:`experts` takes them, rows in context order."""
    mm, eps = _matmul(precision), cfg["rms_norm_eps"]
    h = h + attention(rms_norm(h, w["input_layernorm.weight"], eps), w, cfg, mm)
    b = rms_norm(h, w["post_attention_layernorm.weight"], eps)
    if i < cfg["first_k_dense_replace"]:
        return h + _swiglu(b, w["mlp.gate_proj.weight"], w["mlp.up_proj.weight"],
                           w["mlp.down_proj.weight"], mm)
    n, t, e = b.shape
    return h + experts(b.reshape(n * t, e), w, cfg, mm, record, force).view(n, t, e)


def logits_streamed(parts, tokens: torch.Tensor, cfg: dict, rows: int,
                    precision: str = "fp32", force: dict | None = None) -> tuple:
    """(float32 logits [N, vocab] at the last position of int tokens [N, T],
    choices, gaps): the weights taken from `parts` (``moe_weights.draw``'s
    sequence) one layer at a time, each layer run over `rows` contexts at a
    time.  `force` maps a MoE layer to the experts [N T, k] its rows must
    take (-1 rows: the reference's own); choices and gaps map each MoE layer
    to what :func:`route` gave every row."""
    mm = _matmul(precision)
    choices, gaps = {}, {}
    with torch.no_grad():
        h = None
        t = tokens.shape[1]
        for key, w in parts:
            if key == "embed":
                h = w["model.embed_tokens.weight"].float()[tokens.long()]
            elif key == "head":
                x = rms_norm(h[:, -1], w["model.norm.weight"], cfg["rms_norm_eps"])
                return mm(x, w["lm_head.weight"].float().t()), choices, gaps
            else:
                record = []
                for blk in range(0, h.shape[0], rows):
                    f = None if force is None or key not in force else \
                        force[key][blk * t:(blk + rows) * t]
                    h[blk:blk + rows] = layer(h[blk:blk + rows], w, key, cfg, precision, record,
                                              f)
                if record:
                    choices[key] = torch.cat([r[0] for r in record])
                    gaps[key] = torch.cat([r[1] for r in record])
    raise ValueError("reference: the weights ended before the head")
