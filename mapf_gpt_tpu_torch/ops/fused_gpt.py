"""Fused whole-GPT inference forward: tokens [N, 256] -> last-position logits.

Port of ``mapf_gpt_tpu/ops/fused_gpt.py`` (``_e2e_kernel`` through
``fused_logits``'s single-call path):

- :func:`stack_weights` stacks the per-layer weights into the kernel's
  layout: bf16 [L, in, out] matrices with the attention scale and log2(e)
  folded into the W_q columns, fp32 LN gains, bf16 embedding tables and the
  tied head as fp32 [E, vocab] of the bf16-rounded token embedding.
- :func:`fused_logits_reference` is the plain PyTorch version of the
  kernel's arithmetic: bf16 activations between ops with fp32 accumulation,
  fp32 two-pass LayerNorm, the ``exp2`` softmax clamped at 100 and
  normalised after P@V, tanh GELU, the thinned last layer (K/V over all
  positions; Q, attention and MLP for the last position only) and the fp32
  head.  The CPU tests and ``chip_smoke.py``'s comparison use it.
- :func:`fused_logits` is the wrapper: CPU tensors take the plain version;
  CUDA tensors launch the hand-written kernel of ``csrc/fused_gpt.cu`` (built
  by ``ops/_build.py``) or raise.  ``launches`` counts its kernel launches.

The kernel is built for the 2M shape (T=256, E=160, head dim 32); the plain
version takes any shape.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

_LOG2E = math.log2(math.e)
_EPS = 1e-5
_EXP2_CLAMP = 100.0   # overflow guard on the exp2 argument (bf16 max ~2^127)

launches = 0   # kernel launches by fused_logits; callers may reset it to 0


class FusedWeights(NamedTuple):
    wte: torch.Tensor     # bf16 [V, E]
    wpe: torch.Tensor     # bf16 [T, E]
    wht: torch.Tensor     # f32 [E, V] tied head (bf16-rounded wte, transposed)
    wqkv: torch.Tensor    # bf16 [L, E, 3E], W_q columns pre-scaled
    wproj: torch.Tensor   # bf16 [L, E, E]
    wfc: torch.Tensor     # bf16 [L, E, 4E]
    wfc2: torch.Tensor    # bf16 [L, 4E, E]
    g1: torch.Tensor      # f32 [L, E]
    g2: torch.Tensor      # f32 [L, E]
    gf: torch.Tensor      # f32 [E]
    n_head: int


def stack_weights(model) -> FusedWeights:
    """Stack a :class:`models.gpt.GPT`'s weights into the kernel's layout,
    on the model's device."""
    cfg = model.cfg
    e = cfg.n_embd
    blocks = model.transformer.h
    kernel = lambda lin: lin.weight.detach().float().T        # [in, out]
    wqkv = torch.stack([kernel(b.attn.c_attn) for b in blocks])
    fold = (1.0 / math.sqrt(e // cfg.n_head)) * _LOG2E
    wqkv[:, :, :e] *= fold
    wte = model.transformer.wte.weight.detach().to(torch.bfloat16)
    bf = lambda ts: torch.stack(ts).to(torch.bfloat16).contiguous()
    return FusedWeights(
        wte=wte.contiguous(),
        wpe=model.transformer.wpe.weight.detach().to(torch.bfloat16).contiguous(),
        wht=wte.float().T.contiguous(),
        wqkv=wqkv.to(torch.bfloat16).contiguous(),
        wproj=bf([kernel(b.attn.c_proj) for b in blocks]),
        wfc=bf([kernel(b.mlp.c_fc) for b in blocks]),
        wfc2=bf([kernel(b.mlp.c_proj) for b in blocks]),
        g1=torch.stack([b.ln_1.weight.detach().float() for b in blocks]).contiguous(),
        g2=torch.stack([b.ln_2.weight.detach().float() for b in blocks]).contiguous(),
        gf=model.transformer.ln_f.weight.detach().float().contiguous(),
        n_head=cfg.n_head,
    )


def _ln_f32(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return (xc * torch.rsqrt(var + _EPS)) * gain


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 product with fp32 accumulation (fp32 result)."""
    return a.float() @ w.float()


def fused_logits_reference(w: FusedWeights, tokens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: tokens int [N, T] -> fp32 logits
    [N, vocab] at the last position."""
    bf16 = torch.bfloat16
    n, t = tokens.shape
    layers, e, _ = w.wqkv.shape
    h = w.n_head
    dh = e // h
    x = (w.wte[tokens.long()].float() + w.wpe[:t].float()).to(bf16)  # [N, T, E]
    for l in range(layers):
        xn = _ln_f32(x.float(), w.g1[l]).to(bf16)
        if l < layers - 1:
            q, k, v = _mm(xn, w.wqkv[l]).to(bf16).split(e, dim=-1)
        else:
            # thinned last layer: the head reads only position t-1
            k, v = _mm(xn, w.wqkv[l][:, e:]).to(bf16).split(e, dim=-1)
            q = _mm(xn[:, -1:], w.wqkv[l][:, :e]).to(bf16)
            x = x[:, -1:]
        tq = q.shape[1]
        q = q.reshape(n, tq, h, dh).transpose(1, 2)
        k = k.reshape(n, t, h, dh).transpose(1, 2)
        v = v.reshape(n, t, h, dh).transpose(1, 2)
        # scores already in the exp2 domain (scale * log2(e) folded into W_q)
        ex = torch.exp2(_mm(q, k.transpose(-1, -2)).clamp(max=_EXP2_CLAMP)).to(bf16)
        denom = ex.float().sum(-1, keepdim=True)
        att = (_mm(ex, v) * (1.0 / denom)).to(bf16)
        att = att.transpose(1, 2).reshape(n, tq, e)
        x = (x.float() + _mm(att, w.wproj[l]).to(bf16).float()).to(bf16)
        xn2 = _ln_f32(x.float(), w.g2[l]).to(bf16)
        hmid = _mm(xn2, w.wfc[l]).to(bf16)
        hact = F.gelu(hmid.float(), approximate="tanh").to(bf16)
        x = (x.float() + _mm(hact, w.wfc2[l]).to(bf16).float()).to(bf16)
    xf = _ln_f32(x[:, -1].float(), w.gf)
    return xf @ w.wht


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from csrc/fused_gpt.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_gpt_config.argtypes = [ctypes.POINTER(i)] * 5
    lib.fused_gpt_config.restype = i
    lib.fused_gpt_forward.argtypes = [p] * 13 + [i] * 4 + [p]
    lib.fused_gpt_forward.restype = i
    lib.fused_gpt_error_string.argtypes = [i]
    lib.fused_gpt_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    from mapf_gpt_tpu_torch.ops import _build

    return bind(_build.load("fused_gpt"))


@functools.cache
def kernel_config() -> dict[str, int]:
    """The shape constants the kernel was built for (builds it if needed)."""
    vals = [ctypes.c_int() for _ in range(5)]
    _library().fused_gpt_config(*[ctypes.byref(v) for v in vals])
    return dict(zip(("t", "e", "dh", "max_vocab", "smem_bytes"),
                    (v.value for v in vals)))


def _check(name: str, ten: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if ten.dtype != dtype or tuple(ten.shape) != shape or ten.device != device \
            or not ten.is_contiguous():
        raise ValueError(f"fused_gpt: {name} must be a contiguous {dtype} {shape} on "
                         f"{device}; got {ten.dtype} {tuple(ten.shape)} on {ten.device}")


def fused_logits(w: FusedWeights, tokens: torch.Tensor) -> torch.Tensor:
    """tokens int [N, T] -> fp32 logits [N, vocab] at the last position.

    CPU tensors take :func:`fused_logits_reference`; CUDA tensors launch the
    kernel (one launch per call) or raise."""
    global launches
    if tokens.device.type == "cpu":
        return fused_logits_reference(w, tokens)
    if tokens.device.type != "cuda":
        raise ValueError(f"fused_gpt: no kernel for device {tokens.device}")
    lib = _library()
    cfg = kernel_config()
    n, t = tokens.shape
    layers, e, _ = w.wqkv.shape
    vocab = w.wte.shape[0]
    if (t, e, e // w.n_head) != (cfg["t"], cfg["e"], cfg["dh"]) or e % w.n_head:
        raise ValueError(
            f"fused_gpt: the kernel is built for T={cfg['t']}, n_embd={cfg['e']}, "
            f"head dim {cfg['dh']}; got T={t}, n_embd={e}, {w.n_head} heads")
    if vocab > cfg["max_vocab"]:
        raise ValueError(f"fused_gpt: vocab {vocab} > {cfg['max_vocab']}")
    dev = tokens.device
    tokens = tokens.to(torch.int32).contiguous()
    f = 4 * e
    for name, ten, dtype, shape in (
            ("wte", w.wte, torch.bfloat16, (vocab, e)),
            ("wpe", w.wpe, torch.bfloat16, (w.wpe.shape[0], e)),
            ("wht", w.wht, torch.float32, (e, vocab)),
            ("wqkv", w.wqkv, torch.bfloat16, (layers, e, 3 * e)),
            ("wproj", w.wproj, torch.bfloat16, (layers, e, e)),
            ("wfc", w.wfc, torch.bfloat16, (layers, e, f)),
            ("wfc2", w.wfc2, torch.bfloat16, (layers, f, e)),
            ("g1", w.g1, torch.float32, (layers, e)),
            ("g2", w.g2, torch.float32, (layers, e)),
            ("gf", w.gf, torch.float32, (e,))):
        _check(name, ten, dtype, shape, dev)
    if w.wpe.shape[0] < t:
        raise ValueError(f"fused_gpt: wpe has {w.wpe.shape[0]} positions < T={t}")
    out = torch.empty((n, vocab), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    grid = min(n, torch.cuda.get_device_properties(dev).multi_processor_count)
    workspace = torch.empty((grid, t, 3 * e), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.fused_gpt_forward(
            tokens.data_ptr(), w.wte.data_ptr(), w.wpe.data_ptr(), w.wht.data_ptr(),
            w.wqkv.data_ptr(), w.wproj.data_ptr(), w.wfc.data_ptr(), w.wfc2.data_ptr(),
            w.g1.data_ptr(), w.g2.data_ptr(), w.gf.data_ptr(), out.data_ptr(),
            workspace.data_ptr(), n, layers, vocab, grid, stream)
    if rc != 0:
        raise RuntimeError("fused_gpt kernel launch failed: "
                           f"{lib.fused_gpt_error_string(rc).decode()} ({rc})")
    launches += 1
    return out
