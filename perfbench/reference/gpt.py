"""Plain PyTorch reference of the MAPF-GPT policy: forward logits, the training
loss and its gradients, in float32 (TF32 off), with a float8 variant that serves
as the benchmark's control.

The model is the MAPF-GPT transformer (arXiv:2409.00134, a nanoGPT): learned
token and position embeddings, pre-LayerNorm blocks without biases (eps 1e-5),
non-causal multi-head attention, a 4x MLP, the head tied to the token embedding
and read at the last position only.  One departure follows the program's own
arithmetic and is named in the configuration file (``gelu``): the published
model's GELU is the erf form, the port's fused kernels compute the tanh form.

Weights come in as the benchmark made them: a dict in the reference checkpoint's
key layout (``transformer.wte.weight``, ``transformer.h.{i}.attn.c_attn.weight``,
...), nn.Linear weights as [out, in].

``precision="fp8"`` rounds both operands of every product (and, in the backward,
the incoming gradient) to float8 e4m3 with one scale a tensor (its largest
magnitude to 448), the step below the bfloat16 the configuration states.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor, back in x's dtype."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands in float8, and float8 operands in the backward."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, grad):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(grad)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def _matmul(precision: str):
    if precision == "fp32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"reference: unknown precision {precision!r}")


def _layer_norm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    return xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-5) * gain


def _gelu(x: torch.Tensor, form: str) -> torch.Tensor:
    if form == "tanh":
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    if form == "erf":
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
    raise ValueError(f"reference: unknown GELU form {form!r}")


def last_hidden(w: dict, tokens: torch.Tensor, cfg: dict, precision: str = "fp32"
                ) -> torch.Tensor:
    """tokens int [N, T] -> the final LayerNorm's output at the last position, [N, E]."""
    mm = _matmul(precision)
    n, t = tokens.shape
    e, h = cfg["n_embd"], cfg["n_head"]
    dh = e // h
    x = w["transformer.wte.weight"][tokens.long()] + w["transformer.wpe.weight"][:t]
    for i in range(cfg["n_layer"]):
        p = f"transformer.h.{i}."
        xn = _layer_norm(x, w[p + "ln_1.weight"])
        qkv = mm(xn, w[p + "attn.c_attn.weight"].t())
        q, k, v = (z.reshape(n, t, h, dh).transpose(1, 2) for z in qkv.split(e, dim=-1))
        att = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
        y = mm(att, v).transpose(1, 2).reshape(n, t, e)
        x = x + mm(y, w[p + "attn.c_proj.weight"].t())
        xn = _layer_norm(x, w[p + "ln_2.weight"])
        hid = _gelu(mm(xn, w[p + "mlp.c_fc.weight"].t()), cfg["gelu"])
        x = x + mm(hid, w[p + "mlp.c_proj.weight"].t())
    return _layer_norm(x[:, -1], w["transformer.ln_f.weight"])


def logits(w: dict, tokens: torch.Tensor, cfg: dict, precision: str = "fp32") -> torch.Tensor:
    """float32 logits [N, vocab] at the last position."""
    return _matmul(precision)(last_hidden(w, tokens, cfg, precision),
                              w["transformer.wte.weight"].t())


def logits_in_blocks(w: dict, tokens: torch.Tensor, cfg: dict, rows: int,
                     precision: str = "fp32") -> torch.Tensor:
    """logits() over `rows` contexts at a time, with no autograd graph."""
    with torch.no_grad():
        return torch.cat([logits(w, blk, cfg, precision) for blk in tokens.split(rows)])


def loss_and_grads(w: dict, tokens: torch.Tensor, targets: torch.Tensor, cfg: dict,
                   rows: int, precision: str = "fp32"
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Sum over rows of the last-position cross-entropy, and its gradient with
    respect to every weight, `rows` contexts at a time (float32 sums)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()
              if k != "lm_head.weight"}
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for x, y in zip(tokens.split(rows), targets.split(rows)):
        loss = F.cross_entropy(logits(leaves, x, cfg, precision), y.long(), reduction="sum")
        got = torch.autograd.grad(loss, list(leaves.values()))
        for k, g in zip(leaves, got):
            grads[k] += g
        total += loss.detach().double()
    return total, grads


class fp32_exact:
    """Context: float32 products without TF32 for the reference's run."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved
        return False
