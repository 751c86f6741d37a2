"""Non-causal GPT policy as an ``nn.Module`` in the reference key layout.

Port of ``mapf_gpt_tpu/models/gpt.py``: learned token and position
embeddings, pre-LN blocks (LayerNorm eps 1e-5), fused QKV, non-causal
attention (``ops/attention.py``: the plain version for ``attn_impl`` "auto"
and "einsum", the hand-written kernel for "pallas"), 4x erf-GELU MLP, and
the head tied to the token embedding, computed at the last position only.
With ``bias=True`` the four Linears and the three LayerNorms carry biases
(zeros at init, as flax's).  Parameters are fp32; activations run in
``cfg.dtype`` (bf16 by default) with fp32 LayerNorm, softmax and logits, as
the flax module does.  Token ids are read as JAX indexing reads
``wte[idx]``: a negative id wraps once, then ids are clamped to the table.
With ``dropout > 0`` and ``deterministic=False`` the forward drops where
the flax module does: the embedding sum, the attention probabilities (on
the plain attention only; the kernel runs undropped), the attention output
and the MLP output, with masks drawn from an explicit ``torch.Generator``.
The default is deterministic, as the flax module's, so inference and the
training loss see no dropout.

The state dict keys are the reference's (``transformer.wte.weight``,
``transformer.h.{i}.attn.c_attn.weight``, ``.bias`` with ``bias=True``,
..., ``lm_head.weight``), so the committed ``checkpoints/MAPF-GPT-*.pt``
load with ``strict=True``.

Model family: 2M: 5L/5H/160d   6M: 8L/8H/256d   85M: 12L/12H/768d
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from mapf_gpt_tpu_torch.ops.attention import attention, attention_einsum
from mapf_gpt_tpu_torch.ops.fused_gpt import fused_logits, jax_index, stack_weights
from mapf_gpt_tpu_torch.ops.vocab import CONTEXT_SIZE, NUM_ACTIONS, VOCAB_SIZE
from mapf_gpt_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class GPTConfig:
    block_size: int = CONTEXT_SIZE
    vocab_size: int = VOCAB_SIZE
    n_layer: int = 8
    n_head: int = 8
    n_embd: int = 256
    dropout: float = 0.0
    bias: bool = False
    dtype: torch.dtype = torch.bfloat16   # activation/compute dtype
    attn_impl: str = "auto"               # "auto" | "einsum" | "pallas" (ops/attention.py)


CONFIGS = {
    "2M": GPTConfig(n_layer=5, n_head=5, n_embd=160),
    "6M": GPTConfig(n_layer=8, n_head=8, n_embd=256),
    "85M": GPTConfig(n_layer=12, n_head=12, n_embd=768),
}


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32, with a bias when the config has one."""

    def __init__(self, n: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n)) if bias else None

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, 1e-5)


def _linear(x, layer: nn.Linear, dtype):
    """flax Dense in `dtype`: the product rounded, then the bias added."""
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


Dropout = Callable[[torch.Tensor], torch.Tensor]


def dropout(x: torch.Tensor, p: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: each element kept with probability 1 - p and
    scaled by 1 / (1 - p) in x's dtype, the others zero; the mask drawn
    from `generator` (on x's device)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class SelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.c_attn = nn.Linear(cfg.n_embd, 3 * cfg.n_embd, bias=cfg.bias)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd, bias=cfg.bias)

    def forward(self, x, drop: Dropout | None = None):
        cfg = self.cfg
        b, t, c = x.shape
        nh, hd = cfg.n_head, cfg.n_embd // cfg.n_head
        qkv = _linear(x, self.c_attn, cfg.dtype)
        q, k, v = (z.reshape(b, t, nh, hd).transpose(1, 2)
                   for z in qkv.split(cfg.n_embd, dim=-1))   # [B, H, T, D]
        if drop is None:
            y = attention(q, k, v, 1.0 / math.sqrt(hd), cfg.attn_impl)
        else:
            # the flax module drops the probabilities on its einsum path, whatever attn_impl
            y = attention_einsum(q, k, v, 1.0 / math.sqrt(hd), drop)
        y = _linear(y.transpose(1, 2).reshape(b, t, c), self.c_proj, cfg.dtype)
        return y if drop is None else drop(y)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, bias=cfg.bias)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd, bias=cfg.bias)

    def forward(self, x, drop: Dropout | None = None):
        h = F.gelu(_linear(x, self.c_fc, self.cfg.dtype))   # erf form, as torch nn.GELU()
        y = _linear(h, self.c_proj, self.cfg.dtype)
        return y if drop is None else drop(y)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, cfg.bias)
        self.attn = SelfAttention(cfg)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg.bias)
        self.mlp = MLP(cfg)

    def forward(self, x, drop: Dropout | None = None):
        x = x + self.attn(self.ln_1(x), drop)
        return x + self.mlp(self.ln_2(x), drop)


class GPT(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        if cfg.attn_impl not in ("auto", "einsum", "pallas"):
            raise NotImplementedError(f"GPT: attn_impl={cfg.attn_impl!r} is not ported; "
                                      "'auto' and 'einsum' run the plain attention, "
                                      "'pallas' the attention kernel")
        self.cfg = cfg
        self.transformer = nn.ModuleDict(dict(
            wte=nn.Embedding(cfg.vocab_size, cfg.n_embd),
            wpe=nn.Embedding(cfg.block_size, cfg.n_embd),
            h=nn.ModuleList([Block(cfg) for _ in range(cfg.n_layer)]),
            ln_f=LayerNorm(cfg.n_embd, cfg.bias),
        ))
        self.lm_head = nn.Linear(cfg.n_embd, cfg.vocab_size, bias=False)
        self.lm_head.weight = self.transformer.wte.weight   # weight tying

    def forward(self, idx: torch.Tensor, last_only: bool = True, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """idx: int [B, T] tokens -> fp32 logits [B, vocab] at the last
        position (inference and the training loss only read that one), or
        [B, T, vocab] when not last_only.  With deterministic=False and
        cfg.dropout > 0, dropout masks come from `generator`, which must
        then be given."""
        cfg = self.cfg
        drop = None
        if cfg.dropout > 0.0 and not deterministic:
            if generator is None:
                raise ValueError("GPT: deterministic=False with dropout > 0 needs a "
                                 "torch.Generator")
            drop = functools.partial(dropout, p=cfg.dropout, generator=generator)
        tr = self.transformer
        t = idx.shape[1]
        x = (F.embedding(jax_index(idx, cfg.vocab_size), tr.wte.weight)
             + tr.wpe.weight[:t]).to(cfg.dtype)
        if drop is not None:
            x = drop(x)
        for block in tr.h:
            x = block(x, drop)
        x = tr.ln_f(x[:, -1, :] if last_only else x)
        return x.float() @ tr.wte.weight.float().T

    def num_params(self, non_embedding: bool = True) -> int:
        """Parameters (the tied head counted once), less the position
        embedding when non_embedding, as the JAX ``GPT.num_params``."""
        n = sum(p.numel() for p in self.parameters())
        if non_embedding:
            n -= self.transformer.wpe.weight.numel()
        return n


def uses_fused(cfg: GPTConfig, device_type: str) -> bool:
    """The JAX package's route rule (its ``make_forward`` and
    ``select_loss_fn``): the fused kernels on CUDA for bias-free, dropout-0
    models whose heads divide the width; the module otherwise."""
    return (device_type == "cuda" and not cfg.bias and cfg.dropout == 0.0
            and cfg.n_embd % cfg.n_head == 0)


def make_forward(model: GPT, use_fused: bool | None = None):
    """Inference forward: tokens [N, T] -> logits [N, vocab] at the last
    position.

    The route is :func:`uses_fused`'s unless `use_fused` says otherwise.
    Fused: the hand-written kernels through ``ops/fused_gpt.fused_logits``
    on weights stacked once here (the e2e kernel for the 2M and 6M, the
    layer-stack kernel for the 85M, each built for the model's width on
    first use; on the CPU their plain versions).  Otherwise the module
    itself, on the model's device: erf GELU, biases, and on CUDA with
    ``attn_impl="pallas"`` the attention kernel once a layer.  No autograd
    graph is built."""
    cfg = model.cfg
    if use_fused is None:
        use_fused = uses_fused(cfg, model.lm_head.weight.device.type)
    if use_fused:
        if cfg.bias:
            raise ValueError("make_forward: the fused kernels have no biases")
        weights = stack_weights(model)
        forward = lambda tokens: fused_logits(weights, tokens)
    else:
        forward = model

    @span("mapf.policy.forward")
    def run(tokens: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return forward(tokens)

    return run


def init_params(cfg: GPTConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random fp32 weights in the reference key layout, by the JAX package's
    ``init_params`` scheme: normal(0.02) for every embedding and linear
    weight, the residual projections (``c_proj``) scaled by 1/sqrt(2L),
    LayerNorm gains 1, biases 0 (flax's defaults).  Drawn from `generator`,
    on its device; the biases draw nothing, so a bias=True config gets the
    weights of its bias-free twin."""
    scale = 1.0 / math.sqrt(2.0 * cfg.n_layer)
    sd = {}
    # the tied head is listed once, as the token embedding
    for name, p in GPT(cfg).named_parameters():
        if name.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight")):
            sd[name] = torch.ones(p.shape, device=generator.device)
            continue
        if name.endswith(".bias"):
            sd[name] = torch.zeros(p.shape, device=generator.device)
            continue
        w = torch.randn(p.shape, generator=generator, device=generator.device) * 0.02
        sd[name] = w * scale if name.endswith("c_proj.weight") else w
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def action_logits(logits: torch.Tensor) -> torch.Tensor:
    """Mask to the 5 action ids."""
    return logits[..., :NUM_ACTIONS]


@span("mapf.policy.act")
def act(logits: torch.Tensor, generator: torch.Generator | None = None,
        do_sample: bool = True) -> torch.Tensor:
    """Sample (or argmax) actions from last-position logits [N, vocab].

    Sampling draws from ``generator`` (on the logits' device); it cannot
    reproduce the JAX package's counter-based stream, so sampled runs are
    compared by their metric distributions only."""
    al = action_logits(logits).float()
    if do_sample:
        if generator is None:
            raise ValueError("do_sample=True needs a torch.Generator")
        return torch.multinomial(torch.softmax(al, dim=-1), 1,
                                 generator=generator).squeeze(-1)
    return al.argmax(dim=-1)
