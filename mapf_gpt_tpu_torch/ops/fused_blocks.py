"""GPT layer stack on the residual stream: bf16 x [N, T, E] through a chunk
of layers -> bf16 [N, T, E], or [N, 1, E] (the last position) with the
chunk's final layer thinned.

Port of ``mapf_gpt_tpu/ops/fused_gpt.py``'s ``_block_kernel`` (through
``_blocks_call``), the 85M's layer chunks:

- :class:`LayerStacks` holds a chunk's stacked layer weights (bf16 [L, in,
  out] matrices with the attention scale and log2(e) folded into the W_q
  columns, fp32 LN gains).
- :func:`blocks_reference` is the plain PyTorch version of the layer
  stack's arithmetic: bf16 activations between ops with fp32 accumulation,
  fp32 two-pass LayerNorm, the ``exp2`` softmax clamped at 100 and
  normalised after P@V, tanh GELU, and, when ``last_only``, the thinned
  final layer (K/V over all positions; Q, attention and MLP for the last
  position only).  ``ops/fused_gpt.py``'s plain forward runs its layers
  through it, and the CPU tests and ``chip_smoke.py`` compare with it.
- :func:`fused_blocks` is the wrapper: CPU tensors take the plain version;
  CUDA tensors launch the hand-written kernels of ``csrc/fused_blocks.cu``
  (built by ``ops/_build.py``) or raise.  ``launches`` counts its calls of
  the kernel library, one per chunk.

The kernel is built for the width of the stacks it is given, on first use:
the 85M's (E=768, head dim 64) from the source as it stands, any other as a
library of its own (``-DFUSED_BLOCKS_E``, ``-DFUSED_BLOCKS_DH``); T is a
runtime argument.  :func:`check_width` raises, before ``nvcc`` starts, for
a width the kernel cannot hold: a head dim past 512.  The kernels take
their operands in a padded layout (:func:`kernel_layout`), whose zero
columns and rows change no product: each head's q|k|v columns and
projection rows padded to :func:`padded_head_dim` (a multiple of 16, and
for a head past 128 columns, slabs of at most 128 that the attention runs
one at a time), and an n_embd or 4 n_embd that is not a multiple of 8 (the
GEMM's TMA wants 16-byte row strides) padded to one, with the residual
stream; LayerNorm takes its statistics over the true n_embd.  The plain
version takes any shape.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

_EPS = 1e-5
_EXP2_CLAMP = 100.0   # overflow guard on the exp2 argument (bf16 max ~2^127)
GROUP = 256           # contexts a kernel call processes at a time (workspace ~0.9 GB)

launches = 0   # kernel calls by fused_blocks; callers may reset it to 0


class LayerStacks(NamedTuple):
    wqkv: torch.Tensor    # bf16 [L, E, 3E], W_q columns pre-scaled
    wproj: torch.Tensor   # bf16 [L, E, E]
    wfc: torch.Tensor     # bf16 [L, E, 4E]
    wfc2: torch.Tensor    # bf16 [L, 4E, E]
    g1: torch.Tensor      # f32 [L, E]
    g2: torch.Tensor      # f32 [L, E]
    n_head: int

    def chunk(self, lo: int, hi: int) -> "LayerStacks":
        """Layers lo .. hi-1."""
        return LayerStacks(*(s[lo:hi] for s in self[:6]), n_head=self.n_head)


def ln_f32(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return (xc * torch.rsqrt(var + _EPS)) * gain


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 product with fp32 accumulation (fp32 result)."""
    return a.float() @ w.float()


def blocks_reference(x: torch.Tensor, stacks: LayerStacks, last_only: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel: bf16 x [N, T, E] through the
    chunk's layers -> bf16 [N, T, E], or [N, 1, E] when last_only."""
    bf16 = torch.bfloat16
    n, t, e = x.shape
    layers = stacks.wqkv.shape[0]
    h = stacks.n_head
    dh = e // h
    for l in range(layers):
        xn = ln_f32(x.float(), stacks.g1[l]).to(bf16)
        if not (last_only and l == layers - 1):
            q, k, v = _mm(xn, stacks.wqkv[l]).to(bf16).split(e, dim=-1)
        else:
            # thinned final layer: only position t-1 is read downstream
            k, v = _mm(xn, stacks.wqkv[l][:, e:]).to(bf16).split(e, dim=-1)
            q = _mm(xn[:, -1:], stacks.wqkv[l][:, :e]).to(bf16)
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
        x = (x.float() + _mm(att, stacks.wproj[l]).to(bf16).float()).to(bf16)
        xn2 = ln_f32(x.float(), stacks.g2[l]).to(bf16)
        hmid = _mm(xn2, stacks.wfc[l]).to(bf16)
        hact = F.gelu(hmid.float(), approximate="tanh").to(bf16)
        x = (x.float() + _mm(hact, stacks.wfc2[l]).to(bf16).float()).to(bf16)
    return x


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from csrc/fused_blocks.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_blocks_config.argtypes = [ctypes.POINTER(i)] * 3
    lib.fused_blocks_config.restype = i
    lib.fused_blocks_workspace.argtypes = [i, i]
    lib.fused_blocks_workspace.restype = ctypes.c_longlong
    lib.fused_blocks_forward.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.fused_blocks_forward.restype = i
    lib.fused_blocks_error_string.argtypes = [i]
    lib.fused_blocks_error_string.restype = ctypes.c_char_p
    return lib


_DEFAULT_WIDTH = (768, 64)   # (n_embd, head dim) the source builds with no defines
_MAX_HEAD_DIM = 512          # the widest head whose slabs' windows fit shared memory
_SLAB = 128                  # the attention tiles' widest head in registers


def check_width(t: int, e: int, n_head: int) -> None:
    """Raise ValueError, naming the constraint, unless the kernel can be
    built for n_embd=e and n_head heads and run at T=t (the static_asserts
    of csrc/fused_blocks.cu)."""
    if t < 1:
        raise ValueError(f"fused_blocks: T must be at least 1; got {t}")
    if n_head <= 0 or e % n_head:
        raise ValueError(f"fused_blocks: n_embd {e} is not a multiple of n_head {n_head}")
    dh = e // n_head
    if dh > _MAX_HEAD_DIM:
        raise ValueError(f"fused_blocks: head dim must be at most {_MAX_HEAD_DIM}; got {dh}")


def padded_head_dim(dh: int) -> int:
    """A head's width in the kernels' layout: dh rounded up to 16, or for a
    head past 128 columns, NS slabs of the same width (a multiple of 16 of
    at most 128), NS = ceil(dh / 128) (csrc/fused_blocks.cu's DP)."""
    ns = -(-dh // _SLAB)
    return ns * (-(-(-(-dh // ns)) // 16) * 16)


def stored_width(n: int) -> int:
    """n rounded up to 8: how the kernels store n_embd and 4 n_embd columns
    (TMA's 16-byte row strides)."""
    return -(-n // 8) * 8


def pad_heads(wqkv: torch.Tensor, wproj: torch.Tensor, n_head: int):
    """(wqkv [L, E, 3 H DP], wproj [L, H DP, E]) from wqkv [L, E, 3E] and
    wproj [L, E, E]: each head's q, k and v columns and its projection rows
    padded with zeros to DP = :func:`padded_head_dim` (the kernels' layout;
    the tensors themselves when the head dim is a multiple of 16)."""
    layers, e, _ = wqkv.shape
    dh = e // n_head
    dp = padded_head_dim(dh)
    if dp == dh:
        return wqkv, wproj
    wqkv = F.pad(wqkv.reshape(layers, e, 3, n_head, dh), (0, dp - dh))
    wproj = F.pad(wproj.reshape(layers, n_head, dh, e), (0, 0, 0, dp - dh))
    return (wqkv.reshape(layers, e, 3 * n_head * dp).contiguous(),
            wproj.reshape(layers, n_head * dp, e).contiguous())


def kernel_layout(stacks) -> tuple[torch.Tensor, ...]:
    """The six stacks of a LayerStacks (or TrainStacks) as the kernels take
    them: heads padded (:func:`pad_heads`), then n_embd and 4 n_embd padded
    to :func:`stored_width` with zero rows, columns and gains (the stacks
    themselves where nothing needs padding)."""
    wqkv, wproj = pad_heads(stacks.wqkv, stacks.wproj, stacks.n_head)
    wfc, wfc2, g1, g2 = stacks[2:6]
    e = g1.shape[-1]
    pe, pf = stored_width(e) - e, stored_width(4 * e) - 4 * e
    if pe == pf == 0:
        return wqkv, wproj, wfc, wfc2, g1, g2
    return (F.pad(wqkv, (0, 0, 0, pe)), F.pad(wproj, (0, pe)), F.pad(wfc, (0, pf, 0, pe)),
            F.pad(wfc2, (0, pe, 0, pf)), F.pad(g1, (0, pe)), F.pad(g2, (0, pe)))


def pad_width(x: torch.Tensor) -> torch.Tensor:
    """The residual stream [..., E] with zero columns to stored_width(E)
    (x itself when E is a multiple of 8)."""
    e = x.shape[-1]
    return x if stored_width(e) == e else F.pad(x, (0, stored_width(e) - e))


def kernel_defines(e: int, n_head: int) -> dict[str, int]:
    """The -D defines that build the kernel for this width (none for the 85M's)."""
    dh = e // n_head
    return {} if (e, dh) == _DEFAULT_WIDTH else {"FUSED_BLOCKS_E": e, "FUSED_BLOCKS_DH": dh}


@functools.cache
def _library(e: int = 768, n_head: int = 12) -> ctypes.CDLL:
    """The kernel's library for this width, built on first use."""
    from mapf_gpt_tpu_torch.ops import _build

    return bind(_build.load("fused_blocks", kernel_defines(e, n_head)))


@functools.cache
def kernel_config(e: int = 768, n_head: int = 12) -> dict[str, int]:
    """The shape constants of the kernel built for this width (builds it if
    needed): n_embd, heads and a head's padded width."""
    vals = [ctypes.c_int() for _ in range(3)]
    _library(e, n_head).fused_blocks_config(*[ctypes.byref(v) for v in vals])
    return dict(zip(("e", "h", "dp"), (v.value for v in vals)))


def check_tensor(kernel: str, name: str, ten: torch.Tensor, dtype: torch.dtype, shape: tuple,
                 device: torch.device) -> None:
    """Raise unless `ten` is a contiguous `dtype` tensor of `shape` on `device`."""
    if ten.dtype != dtype or tuple(ten.shape) != shape or ten.device != device \
            or not ten.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous {dtype} {shape} on "
                         f"{device}; got {ten.dtype} {tuple(ten.shape)} on {ten.device}")


def fused_blocks(x: torch.Tensor, stacks: LayerStacks, last_only: bool) -> torch.Tensor:
    """bf16 x [N, T, E] through the chunk's layers -> bf16 [N, T, E], or
    [N, 1, E] when last_only.

    CPU tensors take :func:`blocks_reference`; CUDA tensors launch the
    kernel (one call of its library per chunk) or raise."""
    global launches
    if x.device.type == "cpu":
        return blocks_reference(x, stacks, last_only)
    if x.device.type != "cuda":
        raise ValueError(f"fused_blocks: no kernel for device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"fused_blocks: x must be [N, T, E]; got {tuple(x.shape)}")
    n, t, e = x.shape
    layers = stacks.wqkv.shape[0]
    check_width(t, e, stacks.n_head)
    if layers == 0:
        raise ValueError("fused_blocks: no layers")
    lib = _library(e, stacks.n_head)
    cfg = kernel_config(e, stacks.n_head)
    if (e, stacks.n_head) != (cfg["e"], cfg["h"]):
        raise ValueError(
            f"fused_blocks: the library is built for n_embd={cfg['e']}, {cfg['h']} heads; "
            f"got n_embd={e}, {stacks.n_head} heads")
    dev = x.device
    f = 4 * e
    for name, ten, dtype, shape in (
            ("x", x, torch.bfloat16, (n, t, e)),
            ("wqkv", stacks.wqkv, torch.bfloat16, (layers, e, 3 * e)),
            ("wproj", stacks.wproj, torch.bfloat16, (layers, e, e)),
            ("wfc", stacks.wfc, torch.bfloat16, (layers, e, f)),
            ("wfc2", stacks.wfc2, torch.bfloat16, (layers, f, e)),
            ("g1", stacks.g1, torch.float32, (layers, e)),
            ("g2", stacks.g2, torch.float32, (layers, e))):
        check_tensor("fused_blocks", name, ten, dtype, shape, dev)
    # the kernel updates the residual stream in place, in its stored width
    stream_x = pad_width(x)
    if stream_x is x:
        stream_x = x.clone()
    es = stream_x.shape[-1]
    out = torch.empty((n, 1, es), dtype=torch.bfloat16, device=dev) if last_only else stream_x
    if n == 0:
        return out[..., :e]
    wqkv, wproj, wfc, wfc2, g1, g2 = kernel_layout(stacks)
    group = min(n, GROUP)
    workspace = torch.empty(lib.fused_blocks_workspace(group, t), dtype=torch.bfloat16,
                            device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.fused_blocks_forward(
            stream_x.data_ptr(), out.data_ptr(), wqkv.data_ptr(), wproj.data_ptr(),
            wfc.data_ptr(), wfc2.data_ptr(), g1.data_ptr(), g2.data_ptr(), workspace.data_ptr(),
            n, t, layers, int(last_only), group, stream)
    if rc != 0:
        raise RuntimeError("fused_blocks kernel launch failed: "
                           f"{lib.fused_blocks_error_string(rc).decode()} ({rc})")
    launches += 1
    return out if es == e else out[..., :e].contiguous()
