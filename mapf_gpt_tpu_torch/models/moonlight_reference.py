"""Plain float32 reference of the Moonlight-16B-A3B block as a MAPF policy.

The forward of ``models/moonlight.py``, written from the published equations
(``modeling_deepseek.py`` of the DeepSeek-V3 family, which Moonlight's
``config.json`` names) in plain ``torch`` operations, float32 throughout, with
no kernels, no cache and no batching tricks: every position of every layer is
computed, experts are run one at a time over the rows that chose them.  It
imports nothing but ``torch``, so the tests can hold the program to it.

Per layer, with h the residual stream:

- MLA: ``a = RMSNorm(h)``; ``q = a Wq`` (heads of nope | rope columns);
  ``kv_a = a Wkva`` (latent | one shared rope key); ``c = RMSNorm(latent)``;
  ``k_nope | v = c Wkvb``; RoPE (theta ``rope_theta``, pairs (2i, 2i + 1)
  rotated by pos * theta^(-2i / rope), as ``apply_rotary_pos_emb`` does after
  its interleave) on q's rope columns and on the shared key; scores
  ``(q_nope k_nope + q_pe k_pe) / sqrt(nope + rope)``, softmax over all
  positions; ``h += (P v) Wo``.
- MLP: ``b = RMSNorm(h)``; the first ``first_k_dense_replace`` layers
  ``h += SwiGLU(b)`` of width ``intermediate_size``; the others route:
  ``s = sigmoid(b Wr)``, the ``num_experts_per_tok`` experts with the largest
  ``s + e_bias`` (ties to the lower index), weights ``routed_scaling_factor *
  s_i / (sum of the chosen s + 1e-20)``, ``h += sum_i w_i E_i(b) + S(b)``
  with ``S`` the shared experts' SwiGLU.
- Head: ``logits = RMSNorm(h[T - 1]) W_head`` (untied).

Departures from the source, as the MAPF policy needs them: attention is
non-causal; the vocabulary is the MAPF tokenizer's; no YaRN, no multi-token
prediction, no auxiliary loss.

Weights are a dict in the source's key names (``model.layers.{i}.self_attn.
q_proj.weight`` [out, in], ...), with each MoE layer's routed experts stacked
(``mlp.experts.gate_proj.weight`` [X, f, E], ``up_proj`` the same,
``down_proj`` [X, E, f]); any dtype, read as float32.
"""

from __future__ import annotations

import math

import torch


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * gain.float()


def rope_tables(t: int, dim: int, theta: float, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) float32 [t, dim / 2]: position p, pair i at angle p theta^(-2i / dim)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv[None]
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., T, dim] with pairs (2i, 2i + 1) rotated by the tables' angles."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack((x0 * cos - x1 * sin, x0 * sin + x1 * cos), dim=-1).flatten(-2)


def _w(sd: dict, key: str) -> torch.Tensor:
    return sd[key].float()


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
           mm=torch.matmul) -> torch.Tensor:
    """down(silu(x gate^T) * (x up^T)), weights [out, in]."""
    return mm(torch.nn.functional.silu(mm(x, gate.t())) * mm(x, up.t()), down.t())


def mla(a: torch.Tensor, sd: dict, p: str, cfg, mm=torch.matmul) -> torch.Tensor:
    """The attention sublayer's output (before the residual add) for normed a [N, T, E]."""
    n, t, _ = a.shape
    h, dn, dr, dv = cfg.n_head, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    q = mm(a, _w(sd, p + "self_attn.q_proj.weight").t()).view(n, t, h, dn + dr).transpose(1, 2)
    kv_a = mm(a, _w(sd, p + "self_attn.kv_a_proj_with_mqa.weight").t())
    c = rms_norm(kv_a[..., :r], sd[p + "self_attn.kv_a_layernorm.weight"], cfg.rms_norm_eps)
    kv = mm(c, _w(sd, p + "self_attn.kv_b_proj.weight").t()).view(n, t, h, dn + dv).transpose(1, 2)
    cos, sin = rope_tables(t, dr, cfg.rope_theta, a.device)
    q_pe = rope(q[..., dn:], cos, sin)
    k_pe = rope(kv_a[..., r:], cos, sin)[:, None]                 # one head, shared
    s = (mm(q[..., :dn], kv[..., :dn].transpose(-1, -2))
         + mm(q_pe, k_pe.transpose(-1, -2))) / math.sqrt(dn + dr)
    o = mm(torch.softmax(s, dim=-1), kv[..., dn:]).transpose(1, 2).reshape(n, t, h * dv)
    return mm(o, _w(sd, p + "self_attn.o_proj.weight").t())


def route(b: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, cfg
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(chosen experts int64 [M, k], their weights [M, k], biased scores [M, X])
    of rows b [M, E]: sigmoid scores in float32, the k largest of score + bias
    (a stable sort: ties to the lower index), weights normalised and scaled."""
    s = torch.sigmoid(b.float() @ weight.float().t())
    biased = s + bias.float()
    idx = torch.sort(biased, dim=-1, descending=True, stable=True).indices
    idx = idx[:, :cfg.num_experts_per_tok]
    w = s.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    return idx, w, biased


def moe(b: torch.Tensor, sd: dict, p: str, cfg, mm=torch.matmul, record=None) -> torch.Tensor:
    """The routed and shared experts' sum for rows b [M, E], experts one at a time."""
    idx, w, biased = route(b, sd[p + "mlp.gate.weight"], sd[p + "mlp.gate.e_score_correction_bias"],
                           cfg)
    if record is not None:
        record.append((idx, biased))
    out = swiglu(b, _w(sd, p + "mlp.shared_experts.gate_proj.weight"),
                 _w(sd, p + "mlp.shared_experts.up_proj.weight"),
                 _w(sd, p + "mlp.shared_experts.down_proj.weight"), mm)
    gate, up = sd[p + "mlp.experts.gate_proj.weight"], sd[p + "mlp.experts.up_proj.weight"]
    down = sd[p + "mlp.experts.down_proj.weight"]
    for e in range(cfg.n_routed_experts):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if len(rows):
            y = swiglu(b[rows], gate[e].float(), up[e].float(), down[e].float(), mm)
            out.index_add_(0, rows, y * w[rows, slot][:, None])
    return out


def layer(h: torch.Tensor, sd: dict, i: int, cfg, mm=torch.matmul, record=None) -> torch.Tensor:
    """Layer i on the residual stream h [N, T, E] (float32)."""
    p = f"model.layers.{i}."
    eps = cfg.rms_norm_eps
    h = h + mla(rms_norm(h, sd[p + "input_layernorm.weight"], eps), sd, p, cfg, mm)
    b = rms_norm(h, sd[p + "post_attention_layernorm.weight"], eps)
    if i < cfg.first_k_dense_replace:
        return h + swiglu(b, _w(sd, p + "mlp.gate_proj.weight"), _w(sd, p + "mlp.up_proj.weight"),
                          _w(sd, p + "mlp.down_proj.weight"), mm)
    n, t, e = b.shape
    return h + moe(b.reshape(n * t, e), sd, p, cfg, mm, record).view(n, t, e)


def hidden(sd: dict, tokens: torch.Tensor, cfg, mm=torch.matmul) -> torch.Tensor:
    """The residual stream [N, T, E] after every layer, for int tokens [N, T]."""
    h = sd["model.embed_tokens.weight"].float()[tokens.long()]
    for i in range(cfg.n_layer):
        h = layer(h, sd, i, cfg, mm)
    return h


def logits(sd: dict, tokens: torch.Tensor, cfg, mm=torch.matmul) -> torch.Tensor:
    """float32 logits [N, vocab] at the last position, every position computed."""
    h = hidden(sd, tokens, cfg, mm)[:, -1]
    return mm(rms_norm(h, sd["model.norm.weight"], cfg.rms_norm_eps),
              _w(sd, "lm_head.weight").t())
