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

The kernel takes any T >= 1 and any D from 1 to 128, bf16, fp16 or fp32
(:func:`check_shape`).  In bf16 and fp16 its tiles are 16 columns wide: for
a D that is not a multiple of 16 the wrapper pads q, k and v with zero columns
(which change neither the scores nor the first D outputs) and returns the
first D columns.  It reads q, k and v through their strides (the last dim
contiguous, the others multiples of 16 bytes), so the module's views of
its fused q|k|v product go in without a copy, and it returns a [B, H, T,
D] view of a [B, T, H, D] buffer, so the module's transpose back to [B, T,
H * D] is a view too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_D_MAX = 128
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


def check_shape(t: int, d: int, dtype: torch.dtype) -> None:
    """Raise ValueError, naming the constraint, unless the kernel takes
    T=t, head dim d and `dtype`."""
    if t < 1:
        raise ValueError(f"attention: T must be at least 1; got {t}")
    if not 1 <= d <= _D_MAX:
        raise ValueError(f"attention: head dim must be 1..{_D_MAX}; got {d}")
    if dtype not in _DTYPES:
        raise ValueError(f"attention: dtype must be bfloat16, float16 or float32; got {dtype}")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the library built from csrc/attention.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.attention_forward.argtypes = [i] + [p] * 5 + [i] * 4 + [ctypes.c_float, p]
    lib.attention_forward.restype = i
    lib.attention_error_string.argtypes = [i]
    lib.attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    from mapf_gpt_tpu_torch.ops import _build

    return bind(_build.load("attention"))


def _kernel_ready(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    """x, zero-padded to d_pad columns, as the kernel reads it: x itself if
    its strides do (the last dim contiguous, the others and the address
    multiples of 16 bytes), else a fresh contiguous copy."""
    if x.shape[-1] != d_pad:
        return torch.nn.functional.pad(x, (0, d_pad - x.shape[-1]))
    align = 16 // x.element_size()
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 \
            and all(s % align == 0 for s in x.stride()[:3]):
        return x
    return x.clone(memory_format=torch.contiguous_format)


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
    dp = d if q.dtype == torch.float32 else -(-d // 16) * 16   # 16-bit tiles: 16 columns
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
