"""Non-causal GPT policy as an ``nn.Module`` in the reference key layout.

Port of ``mapf_gpt_tpu/models/gpt.py``: learned token and position
embeddings, pre-LN blocks with bias-free LayerNorm (eps 1e-5), fused QKV,
non-causal attention, 4x erf-GELU MLP, and the head tied to the token
embedding, computed at the last position only.  Parameters are fp32;
activations run in ``cfg.dtype`` (bf16 by default) with fp32 LayerNorm,
softmax and logits, as the flax module does.

The state dict keys are the reference's (``transformer.wte.weight``,
``transformer.h.{i}.attn.c_attn.weight``, ..., ``lm_head.weight``), so the
committed ``checkpoints/MAPF-GPT-*.pt`` load with ``strict=True``.

Model family: 2M: 5L/5H/160d   6M: 8L/8H/256d   85M: 12L/12H/768d
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from mapf_gpt_tpu_torch.ops.vocab import CONTEXT_SIZE, NUM_ACTIONS, VOCAB_SIZE


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
    attn_impl: str = "auto"               # "auto" | "einsum": the plain attention below


CONFIGS = {
    "2M": GPTConfig(n_layer=5, n_head=5, n_embd=160),
    "6M": GPTConfig(n_layer=8, n_head=8, n_embd=256),
    "85M": GPTConfig(n_layer=12, n_head=12, n_embd=768),
}


class LayerNorm(nn.Module):
    """Bias-free LayerNorm computed in fp32."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight, None, 1e-5)


def _linear(x, layer: nn.Linear, dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype))


class SelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.c_attn = nn.Linear(cfg.n_embd, 3 * cfg.n_embd, bias=False)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd, bias=False)

    def forward(self, x):
        cfg = self.cfg
        b, t, c = x.shape
        nh, hd = cfg.n_head, cfg.n_embd // cfg.n_head
        qkv = _linear(x, self.c_attn, cfg.dtype)
        q, k, v = (z.reshape(b, t, nh, hd).transpose(1, 2)
                   for z in qkv.split(cfg.n_embd, dim=-1))   # [B, H, T, D]
        att = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        att = torch.softmax(att, dim=-1)
        y = (att.to(cfg.dtype) @ v).transpose(1, 2).reshape(b, t, c)
        return _linear(y, self.c_proj, cfg.dtype)


class MLP(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, bias=False)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd, bias=False)

    def forward(self, x):
        h = F.gelu(_linear(x, self.c_fc, self.cfg.dtype))   # erf form, as torch nn.GELU()
        return _linear(h, self.c_proj, self.cfg.dtype)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd)
        self.attn = SelfAttention(cfg)
        self.ln_2 = LayerNorm(cfg.n_embd)
        self.mlp = MLP(cfg)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPT(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        if cfg.bias or cfg.dropout > 0.0:
            raise NotImplementedError("GPT: bias=True and dropout > 0 are not ported yet")
        if cfg.attn_impl not in ("auto", "einsum"):
            # "pallas" is the JAX package's standalone attention kernel
            raise NotImplementedError(f"GPT: attn_impl={cfg.attn_impl!r} is not ported; "
                                      "'auto' and 'einsum' run the plain attention")
        self.cfg = cfg
        self.transformer = nn.ModuleDict(dict(
            wte=nn.Embedding(cfg.vocab_size, cfg.n_embd),
            wpe=nn.Embedding(cfg.block_size, cfg.n_embd),
            h=nn.ModuleList([Block(cfg) for _ in range(cfg.n_layer)]),
            ln_f=LayerNorm(cfg.n_embd),
        ))
        self.lm_head = nn.Linear(cfg.n_embd, cfg.vocab_size, bias=False)
        self.lm_head.weight = self.transformer.wte.weight   # weight tying

    def forward(self, idx: torch.Tensor, last_only: bool = True) -> torch.Tensor:
        """idx: int [B, T] tokens -> fp32 logits [B, vocab] at the last
        position (inference and the training loss only read that one), or
        [B, T, vocab] when not last_only."""
        tr = self.transformer
        t = idx.shape[1]
        x = (tr.wte(idx.long()) + tr.wpe.weight[:t]).to(self.cfg.dtype)
        for block in tr.h:
            x = block(x)
        x = tr.ln_f(x[:, -1, :] if last_only else x)
        return x.float() @ tr.wte.weight.float().T

    def num_params(self, non_embedding: bool = True) -> int:
        """Parameters (the tied head counted once), less the position
        embedding when non_embedding, as the JAX ``GPT.num_params``."""
        n = sum(p.numel() for p in self.parameters())
        if non_embedding:
            n -= self.transformer.wpe.weight.numel()
        return n


def make_forward(model: GPT):
    """Inference forward: tokens [N, T] -> logits [N, vocab] at the last
    position.

    With the model on CUDA this runs the hand-written kernels through
    ``ops/fused_gpt.fused_logits`` on weights stacked once here: the e2e
    kernel for the 2M and 6M, the layer-stack kernel for the 85M, each
    built for the model's width on first use; a width neither can hold
    raises.  On the CPU it runs the module itself (erf GELU), as the JAX
    package runs the flax module there.  No autograd graph is built."""
    if model.lm_head.weight.device.type == "cuda":
        from mapf_gpt_tpu_torch.ops.fused_gpt import fused_logits, stack_weights

        weights = stack_weights(model)
        forward = lambda tokens: fused_logits(weights, tokens)
    else:
        forward = model

    def run(tokens: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return forward(tokens)

    return run


def init_params(cfg: GPTConfig, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random fp32 weights in the reference key layout, by the JAX package's
    ``init_params`` scheme: normal(0.02) for every embedding and linear
    weight, the residual projections (``c_proj``) scaled by 1/sqrt(2L),
    LayerNorm gains 1.  Drawn from `generator`, on its device."""
    scale = 1.0 / math.sqrt(2.0 * cfg.n_layer)
    sd = {}
    # the tied head is listed once, as the token embedding
    for name, p in GPT(cfg).named_parameters():
        if name.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight")):
            sd[name] = torch.ones(p.shape, device=generator.device)
            continue
        w = torch.randn(p.shape, generator=generator, device=generator.device) * 0.02
        sd[name] = w * scale if name.endswith("c_proj.weight") else w
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def action_logits(logits: torch.Tensor) -> torch.Tensor:
    """Mask to the 5 action ids."""
    return logits[..., :NUM_ACTIONS]


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
