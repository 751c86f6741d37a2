"""Non-causal softmax attention: q, k, v [B, H, T, D] -> [B, H, T, D].

Port of ``mapf_gpt_tpu/ops/attention.py``:

- :func:`attention_einsum` is the plain PyTorch version: fp32 scores, the
  softmax in fp32, the probabilities rounded to q's dtype before P @ V
  (summed in fp32, rounded once).  It is differentiable, and the module
  takes it for ``attn_impl`` "auto" and "einsum", as the flax module does.
- :func:`attention_pallas` is the wrapper of the hand-written kernel
  ``csrc/attention.cu`` (the counterpart of the TPU kernel
  ``_attn_kernel``), for ``attn_impl="pallas"``: CPU tensors take the plain
  version; CUDA tensors launch the kernel or raise.  ``launches`` counts
  its launches.  Like the JAX kernel, which has no gradient rule, it has
  no backward: it raises ``NotImplementedError`` when a gradient could be
  asked of it, on either device.
- :func:`attention` dispatches as the JAX one does: "pallas" goes to the
  kernel, anything else to the plain version.

The kernel takes any T >= 1 in bf16, fp16 or fp32, head dims 1 to 672 in
bf16 and 1 to 842 in fp16 and fp32 (:func:`check_shape`), on the route
the C launcher picks by shape (``attention_route`` in
``csrc/attention.cu``): the wgmma kernel (``csrc/attn_wgmma.cuh``) for
the 16-bit types at T <= 256 and head dims 16, 32, 48 and 64, the
mma.sync tiles for the other heads up to 128 and for T past 256, the bf16
slabs past 128 and FMA for fp32 and for fp16 past 128.  The 16-bit tiles are 16
columns wide: for a head dim that is not a multiple of 16 the wrapper pads
q, k and v with zero columns (which change neither the scores nor the first
D outputs) to :func:`kernel_width` and returns the first D columns.  It
reads q, k and v through their strides (the last dim contiguous, the
others positive multiples of 16 bytes, as TMA wants), so the module's views
of its fused q|k|v product go in without a copy, and it returns a [B, H,
T, D] view of a [B, T, H, D] buffer, so the module's transpose back to [B,
T, H * D] is a view too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_D_TILE = 128        # widest head of the register tiles (csrc/attn_tile.cuh)
_D_MAX_BF16 = 672    # widest bf16 head whose slabs' windows fit shared memory
_D_MAX_FMA = 842     # widest head whose FMA staging fits a block's shared memory
_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}   # the kernel's codes

launches = 0   # kernel launches by attention_pallas; callers may reset it to 0


def attention_einsum(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float, drop=None) -> torch.Tensor:
    """Plain version: q, k, v [B, H, T, D] -> [B, H, T, D] in q's dtype.
    `drop`, when given, is applied to the fp32 probabilities (the module's
    dropout)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    if drop is not None:
        p = drop(p)
    return (p.to(q.dtype).float() @ v.float()).to(q.dtype)


def _d_max(dtype: torch.dtype) -> int:
    return _D_MAX_BF16 if dtype == torch.bfloat16 else _D_MAX_FMA


def check_shape(t: int, d: int, dtype: torch.dtype) -> None:
    """Raise ValueError, naming the constraint, unless the kernel takes
    T=t, head dim d and `dtype`."""
    if t < 1:
        raise ValueError(f"attention: T must be at least 1; got {t}")
    if dtype not in _DTYPES:
        raise ValueError(f"attention: dtype must be bfloat16, float16 or float32; got {dtype}")
    if not 1 <= d <= _d_max(dtype):
        raise ValueError(f"attention: head dim must be 1..{_d_max(dtype)} in {dtype}; got {d}")


def kernel_width(d: int, dtype: torch.dtype) -> int:
    """The head width the kernel reads for head dim d: d itself on the FMA
    route; for the 16-bit tiles d rounded up to 16, and past 128 (bf16)
    NS = ceil(d / 128) slabs of the same width, a multiple of 16."""
    if dtype == torch.float32 or (dtype == torch.float16 and d > _D_TILE):
        return d
    ns = -(-d // _D_TILE)
    return ns * (-(-(-(-d // ns)) // 16) * 16)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the library built from csrc/attention.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attention_forward.argtypes = [i] + [p] * 5 + [i] * 4 + [ctypes.c_float, p]
    lib.attention_forward.restype = i
    lib.attention_route.argtypes = [i, i, i]
    lib.attention_route.restype = i
    lib.attention_error_string.argtypes = [i]
    lib.attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    from mapf_gpt_tpu_torch.ops import _build

    return bind(_build.load("attention"))


def _tma_ready(x: torch.Tensor) -> bool:
    """Whether the kernel can read x through its strides: the last dim
    contiguous, the address and every other stride of a dim longer than
    one a positive multiple of 16 bytes below 2^40 (TMA's limits)."""
    es = x.element_size()
    return x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
        n == 1 or (s > 0 and s * es % 16 == 0 and s * es < 2 ** 40)
        for n, s in zip(x.shape[:-1], x.stride()[:-1]))


def _kernel_ready(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    """x, zero-padded to d_pad columns, as the kernel reads it: x itself if
    :func:`_tma_ready`, else a fresh contiguous copy."""
    if x.shape[-1] != d_pad:
        return torch.nn.functional.pad(x, (0, d_pad - x.shape[-1]))
    return x if _tma_ready(x) else x.clone(memory_format=torch.contiguous_format)


def attention_pallas(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """q, k, v [B, H, T, D] -> [B, H, T, D] in q's dtype.

    CPU tensors take :func:`attention_einsum`; CUDA tensors launch the
    kernel (one launch a call) or raise."""
    global launches
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "attention_pallas has no gradient: the JAX kernel it ports (no custom_vjp) "
            "cannot be differentiated either; train with attn_impl 'auto' or 'einsum'")
    if q.device.type == "cpu":
        return attention_einsum(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no kernel for device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention: q, k, v must be [B, H, T, D] of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device \
            or v.device != q.device:
        raise ValueError("attention: q, k, v must share a dtype and a device")
    b, h, t, d = q.shape
    check_shape(t, d, q.dtype)
    dp = kernel_width(d, q.dtype)
    q, k, v = (_kernel_ready(x, dp) for x in (q, k, v))
    buf = torch.empty((b, t, h, dp), dtype=q.dtype, device=q.device)
    out = buf.permute(0, 2, 1, 3)
    if b * h == 0:
        return out[..., :d]
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out) for s in x.stride()[:3]))
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.attention_forward(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), ctypes.addressof(strides), b, h, t, dp,
                                   float(scale), stream)
    if rc != 0:
        raise RuntimeError("attention kernel launch failed: "
                           f"{lib.attention_error_string(rc).decode()} ({rc})")
    launches += 1
    return out[..., :d]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              impl: str = "auto") -> torch.Tensor:
    """"pallas" -> :func:`attention_pallas`; anything else ->
    :func:`attention_einsum` (the JAX dispatch)."""
    if impl == "pallas":
        return attention_pallas(q, k, v, scale)
    return attention_einsum(q, k, v, scale)
