"""The Moonlight-16B-A3B block (DeepSeek-V3 type) as a non-causal MAPF policy.

Source: https://huggingface.co/moonshotai/Moonlight-16B-A3B (``config.json``,
``model_type`` deepseek_v3): 27 layers, hidden 2048, RMSNorm eps 1e-5;
multi-head latent attention (MLA) with 16 heads, no q compression, latent
(``kv_lora_rank``) 512, ``qk_nope_head_dim`` 128 + ``qk_rope_head_dim`` 64,
``v_head_dim`` 128, RoPE theta 50000; layer 0 a dense SwiGLU of 11264; layers
1-26 mixtures of 64 routed SwiGLU experts of 1408 (top 6 by sigmoid score +
correction bias, weights normalised and scaled by 2.446) and 2 shared ones.
The equations are those of ``models/moonlight_reference.py`` (the plain
float32 reference the tests hold this module to).  Departures from the
source, as the MAPF policy needs them: non-causal attention, the MAPF
tokenizer's 67 ids, the logits at the last position only, and no YaRN,
multi-token prediction or auxiliary loss.

:class:`MoonlightPolicy` holds one copy of the weights, in bf16 (fp32 norm
gains, router weight as three bf16 terms, fp32 bias), laid out as the
kernels read them; its forward runs every op of ``ops/moe.py`` and the
attention of ``ops/attention.py``: on CUDA the hand-written kernels, on the
CPU their plain versions.  Products are bf16 with fp32 accumulation; norms,
router and softmax fp32.  The last layer is thinned: its keys and values at
every position, the rest at the last position only.  Spans:
``mapf.mla.attention``, ``mapf.moe.route``, ``mapf.moe.experts``.

:func:`load_state` takes weights in the source's key names (``model.layers.
{i}.self_attn.q_proj.weight`` [out, in], ...; each MoE layer's routed
experts stacked, ``mlp.experts.gate_proj.weight`` [X, f, E]); :func:`init_params`
draws them.  ``CONFIGS`` names the sizes, and ``models/gpt.make_forward``,
``parallel/rollout`` and the evaluator take the policy as they take a GPT.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from mapf_gpt_tpu_torch.ops import moe
from mapf_gpt_tpu_torch.ops.attention import attention_pallas
from mapf_gpt_tpu_torch.ops.fused_gpt import jax_index
from mapf_gpt_tpu_torch.ops.vocab import CONTEXT_SIZE, VOCAB_SIZE
from mapf_gpt_tpu_torch.utils.profiling import span

BF16 = torch.bfloat16


@dataclass(frozen=True)
class MoonlightConfig:
    block_size: int = CONTEXT_SIZE
    vocab_size: int = VOCAB_SIZE
    n_layer: int = 27
    hidden_size: int = 2048
    n_head: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0

    @property
    def n_embd(self) -> int:
        return self.hidden_size

    @property
    def head_dim(self) -> int:
        """A head's q and k width (nope + rope), the attention's D."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def forward_bytes_per_context(self) -> int:
        """Device bytes a context's forward holds at once, counted from shapes:
        the MoE layer's experts' input, hidden and output rows (k of each per
        token, bf16), the residual stream, the attention's q, k|v and output,
        and the dense layer's hidden (the largest of the layer's parts)."""
        t, e, k = self.block_size, self.hidden_size, self.num_experts_per_tok
        moe_rows = k * (2 * e + self.moe_intermediate_size)
        attn = self.n_head * self.head_dim * 4
        return 2 * t * (3 * e + max(moe_rows, attn, self.intermediate_size))


CONFIGS = {
    "Moonlight-16B-A3B": MoonlightConfig(),
}


def interleave_gate_up(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """gate, up [..., f, E] ([out, in]) -> [..., E, 2f]: columns in blocks of
    16, the gate of 8 hidden units then their up (the SwiGLU epilogue's layout)."""
    *lead, f, e = gate.shape
    g = gate.transpose(-1, -2).reshape(*lead, e, f // 8, 1, 8)
    u = up.transpose(-1, -2).reshape(*lead, e, f // 8, 1, 8)
    return torch.cat([g, u], dim=-2).reshape(*lead, e, 2 * f)


def pad_kv_b(w: torch.Tensor, cfg: MoonlightConfig) -> torch.Tensor:
    """kv_b_proj [H (nope + v), R] -> [R, H 2D]: each head's columns k_nope |
    (rope key, written by RoPE) | v | zeros, D = nope + rope wide each half, so
    that keys and values are [.., D] views the attention kernel reads."""
    h, dn, dv, d = cfg.n_head, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.head_dim
    r = w.shape[1]
    src = w.t().reshape(r, h, dn + dv)
    out = torch.zeros((r, h, 2 * d), dtype=w.dtype, device=w.device)
    out[..., :dn] = src[..., :dn]
    out[..., d:d + dv] = src[..., dn:]
    return out.reshape(r, h * 2 * d)


class MoonlightPolicy(nn.Module):
    """The policy: int tokens [N, T] -> fp32 logits [N, vocab] at the last
    position.  Parameters (frozen, in the kernels' layout) are made empty on
    `device` and filled by :meth:`load_layer` and :meth:`load_globals`."""

    def __init__(self, cfg: MoonlightConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, v = cfg.hidden_size, cfg.vocab_size
        par = lambda *shape, dtype=BF16: nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device), requires_grad=False)
        self.embed = par(v, e)
        self.norm = par(e, dtype=torch.float32)
        self.head = par(v, e)
        h, d, dv, r = cfg.n_head, cfg.head_dim, cfg.v_head_dim, cfg.kv_lora_rank
        x, f = cfg.n_routed_experts, cfg.moe_intermediate_size
        sf = cfg.n_shared_experts * f
        self.layers = nn.ModuleList()
        for i in range(cfg.n_layer):
            lay = nn.ParameterDict({
                "ln1": par(e, dtype=torch.float32), "ln2": par(e, dtype=torch.float32),
                "kv_ln": par(r, dtype=torch.float32), "wq": par(e, h * d),
                "wkva": par(e, r + cfg.qk_rope_head_dim), "wkvb": par(r, h * 2 * d),
                "wo": par(h * dv, e)})
            if i < cfg.first_k_dense_replace:
                lay.update({"wgu": par(e, 2 * cfg.intermediate_size),
                            "wd": par(cfg.intermediate_size, e)})
            else:
                lay.update({"wr3": par(e, 3 * x), "bias": par(x, dtype=torch.float32),
                            "wgu": par(x * e, 2 * f), "wd": par(x * f, e),
                            "wsgu": par(e, 2 * sf), "wsd": par(sf, e)})
            self.layers.append(lay)
        cos, sin = moe.rope_tables(cfg.block_size, cfg.qk_rope_head_dim, cfg.rope_theta, device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        # per-layer tokens per expert, added on the device by the router
        self.register_buffer("expert_counts",
                             torch.zeros((cfg.n_layer, x), dtype=torch.int64, device=device),
                             persistent=False)
        self.register_buffer("_route_scratch", torch.zeros(2 * x, dtype=torch.int32,
                                                           device=device), persistent=False)
        self.capture: list | None = None   # when a list, each MoE layer's choices are appended

    # -- weights ------------------------------------------------------------
    def load_layer(self, i: int, sd: dict) -> None:
        """Copy layer i's weights (source key names without the
        ``model.layers.{i}.`` prefix) into the kernels' layout."""
        cfg, lay = self.cfg, self.layers[i]
        t = lambda key: sd[key].t()
        with torch.no_grad():
            lay["ln1"].copy_(sd["input_layernorm.weight"])
            lay["ln2"].copy_(sd["post_attention_layernorm.weight"])
            lay["kv_ln"].copy_(sd["self_attn.kv_a_layernorm.weight"])
            lay["wq"].copy_(t("self_attn.q_proj.weight"))
            lay["wkva"].copy_(t("self_attn.kv_a_proj_with_mqa.weight"))
            lay["wkvb"].copy_(pad_kv_b(sd["self_attn.kv_b_proj.weight"], cfg))
            lay["wo"].copy_(t("self_attn.o_proj.weight"))
            if i < cfg.first_k_dense_replace:
                lay["wgu"].copy_(interleave_gate_up(sd["mlp.gate_proj.weight"],
                                                    sd["mlp.up_proj.weight"]))
                lay["wd"].copy_(t("mlp.down_proj.weight"))
                return
            lay["wr3"].copy_(moe.split3(sd["mlp.gate.weight"].float()))
            lay["bias"].copy_(sd["mlp.gate.e_score_correction_bias"])
            lay["wgu"].view(cfg.n_routed_experts, cfg.hidden_size, -1).copy_(
                interleave_gate_up(sd["mlp.experts.gate_proj.weight"],
                                   sd["mlp.experts.up_proj.weight"]))
            lay["wd"].view(cfg.n_routed_experts, cfg.moe_intermediate_size, -1).copy_(
                sd["mlp.experts.down_proj.weight"].transpose(1, 2))
            lay["wsgu"].copy_(interleave_gate_up(sd["mlp.shared_experts.gate_proj.weight"],
                                                 sd["mlp.shared_experts.up_proj.weight"]))
            lay["wsd"].copy_(t("mlp.shared_experts.down_proj.weight"))

    def load_globals(self, sd: dict) -> None:
        """The embedding, the final norm and the head."""
        with torch.no_grad():
            self.embed.copy_(sd["model.embed_tokens.weight"])
            self.norm.copy_(sd["model.norm.weight"])
            self.head.copy_(sd["lm_head.weight"])

    # -- forward ------------------------------------------------------------
    def _attention(self, h: torch.Tensor, lay, n: int, t: int, thin: bool) -> torch.Tensor:
        cfg = self.cfg
        hh, d, dn, dv, r = (cfg.n_head, cfg.head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim,
                            cfg.kv_lora_rank)
        eps = cfg.rms_norm_eps
        scale = 1.0 / math.sqrt(d)
        a = moe.rms_norm(h, lay["ln1"], eps)
        kva = moe.linear(a, lay["wkva"])
        kv = moe.linear(moe.rms_norm(kva[:, :r], lay["kv_ln"], eps), lay["wkvb"])
        cos, sin = self.rope_cos, self.rope_sin
        if not thin:
            q = moe.linear(a, lay["wq"])
            moe.rope(q, kva, kv, cos, sin, hh, d, dn, r, t)
            kvh = kv.view(n, t, hh, 2 * d)
            o = attention_pallas(q.view(n, t, hh, d).transpose(1, 2),
                                 kvh[..., :d].transpose(1, 2), kvh[..., d:].transpose(1, 2),
                                 scale)
            o = moe.compact(o.transpose(1, 2).reshape(n * t, hh, d), dv)
            return moe.linear(o, lay["wo"], resid=h)
        # thinned: keys and values at every position, the rest at the last
        moe.rope(None, kva, kv, cos, sin, hh, d, dn, r, t)
        q = moe.linear(a.view(n, t, -1)[:, -1], lay["wq"])
        moe.rope(q, None, None, cos, sin, hh, d, dn, r, t, fixed=t - 1)
        o = moe.thin_attention(q, kv, hh, d, dv, t, scale)
        return moe.linear(o, lay["wo"], resid=h.view(n, t, -1)[:, -1].contiguous())

    def _mlp(self, h: torch.Tensor, lay, i: int) -> torch.Tensor:
        cfg = self.cfg
        if i < cfg.first_k_dense_replace:
            b = moe.rms_norm(h, lay["ln2"], cfg.rms_norm_eps)
            return moe.linear(moe.swiglu(b, lay["wgu"]), lay["wd"], resid=h)
        with span("mapf.moe.route"):
            b = moe.rms_norm(h, lay["ln2"], cfg.rms_norm_eps)
            a, table, slot, w, idx = moe.route(
                b, lay["wr3"], lay["bias"], cfg.num_experts_per_tok, cfg.routed_scaling_factor,
                self._route_scratch, self.expert_counts[i])
        if self.capture is not None:
            self.capture.append(idx)
        with span("mapf.moe.experts"):
            x = cfg.n_routed_experts
            y = moe.grouped(moe.swiglu(a, lay["wgu"], table, x), lay["wd"], table, x)
            del a
            ys = moe.linear(moe.swiglu(b, lay["wsgu"]), lay["wsd"])
            return moe.combine(h, ys, y, slot, w)

    def forward(self, tokens: torch.Tensor, last_only: bool = True) -> torch.Tensor:
        """tokens int [N, T] -> fp32 logits [N, vocab] at the last position
        (the last layer thinned), or [N, T, vocab] when not last_only (every
        position of every layer)."""
        cfg = self.cfg
        n, t = tokens.shape
        h = self.embed[jax_index(tokens, cfg.vocab_size).reshape(-1)]
        for i, lay in enumerate(self.layers):
            thin = last_only and i == cfg.n_layer - 1
            with span("mapf.mla.attention"):
                h = self._attention(h, lay, n, t, thin)
            h = self._mlp(h, lay, i)
        x = h.float()
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + cfg.rms_norm_eps) * self.norm
        logits = x @ self.head.float().t()
        return logits if last_only else logits.view(n, t, -1)

    def policy_forward(self):
        """The inference forward ``models/gpt.make_forward`` returns for this
        policy: tokens [N, T] -> logits [N, vocab], with no autograd graph."""

        @span("mapf.policy.forward")
        def run(tokens: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return self(tokens)

        return run


def layer_shapes(cfg: MoonlightConfig, i: int) -> list[tuple[str, tuple[int, ...]]]:
    """(key without the layer prefix, shape) of layer i's weights, in drawing order."""
    e, h, r = cfg.hidden_size, cfg.n_head, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    x, f = cfg.n_routed_experts, cfg.moe_intermediate_size
    sf = cfg.n_shared_experts * f
    out = [("input_layernorm.weight", (e,)), ("self_attn.q_proj.weight", (h * (dn + dr), e)),
           ("self_attn.kv_a_proj_with_mqa.weight", (r + dr, e)),
           ("self_attn.kv_a_layernorm.weight", (r,)),
           ("self_attn.kv_b_proj.weight", (h * (dn + dv), r)),
           ("self_attn.o_proj.weight", (e, h * dv)), ("post_attention_layernorm.weight", (e,))]
    if i < cfg.first_k_dense_replace:
        fd = cfg.intermediate_size
        return out + [("mlp.gate_proj.weight", (fd, e)), ("mlp.up_proj.weight", (fd, e)),
                      ("mlp.down_proj.weight", (e, fd))]
    return out + [("mlp.gate.weight", (x, e)), ("mlp.gate.e_score_correction_bias", (x,)),
                  ("mlp.experts.gate_proj.weight", (x, f, e)),
                  ("mlp.experts.up_proj.weight", (x, f, e)),
                  ("mlp.experts.down_proj.weight", (x, e, f)),
                  ("mlp.shared_experts.gate_proj.weight", (sf, e)),
                  ("mlp.shared_experts.up_proj.weight", (sf, e)),
                  ("mlp.shared_experts.down_proj.weight", (e, sf))]


def draw_layer(cfg: MoonlightConfig, i: int, generator: torch.Generator) -> dict:
    """Layer i's weights drawn from `generator` (on its device): normal(0,
    0.02) in bf16, the output projections (``o_proj``, ``down_proj``) scaled by
    1 / sqrt(2 n_layer), the router's weight in fp32; norm gains 1, the
    correction bias 0."""
    dev = generator.device
    scale = 1.0 / math.sqrt(2.0 * cfg.n_layer)
    sd = {}
    for key, shape in layer_shapes(cfg, i):
        if key.endswith("layernorm.weight"):
            sd[key] = torch.ones(shape, device=dev)
        elif key.endswith("e_score_correction_bias"):
            sd[key] = torch.zeros(shape, device=dev)
        elif key == "mlp.gate.weight":
            sd[key] = torch.randn(shape, generator=generator, device=dev).mul_(0.02)
        else:
            w = torch.randn(shape, generator=generator, device=dev, dtype=BF16).mul_(0.02)
            sd[key] = w.mul_(scale) if key.endswith(("o_proj.weight", "down_proj.weight")) else w
    return sd


def draw_globals(cfg: MoonlightConfig, generator: torch.Generator, part: str) -> dict:
    """The embedding (`part` "embed", drawn before the layers) or the final norm
    and the head ("head", after them)."""
    dev = generator.device
    e, v = cfg.hidden_size, cfg.vocab_size
    if part == "embed":
        return {"model.embed_tokens.weight":
                torch.randn((v, e), generator=generator, device=dev, dtype=BF16).mul_(0.02)}
    return {"model.norm.weight": torch.ones(e, device=dev),
            "lm_head.weight": torch.randn((v, e), generator=generator, device=dev,
                                          dtype=BF16).mul_(0.02)}


def init_params(cfg: MoonlightConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Every weight in the source's key names, drawn as :func:`draw_layer` and
    :func:`draw_globals` draw them, on the generator's device."""
    sd = draw_globals(cfg, generator, "embed")
    for i in range(cfg.n_layer):
        sd.update({f"model.layers.{i}.{k}": w for k, w in draw_layer(cfg, i, generator).items()})
    sd.update(draw_globals(cfg, generator, "head"))
    return sd


def load_state(cfg: MoonlightConfig, sd: dict, device=None) -> MoonlightPolicy:
    """The policy on `device` from weights in the source's key names; each
    layer's entries are removed from `sd` once copied, so that a whole model
    is never held twice on the card."""
    model = MoonlightPolicy(cfg, device=device)
    for i in range(cfg.n_layer):
        prefix = f"model.layers.{i}."
        keys = [k for k in sd if k.startswith(prefix)]
        model.load_layer(i, {k[len(prefix):]: sd.pop(k) for k in keys})
    model.load_globals(sd)
    return model.eval()
