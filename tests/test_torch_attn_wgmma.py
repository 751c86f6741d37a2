"""The wgmma attention forward (``csrc/attn_wgmma.cuh``) on the CPU: a plain
PyTorch emulation of its order of work against the plain versions and the
JAX package, and the wrappers' shape and stride checks.

- ``emulate_wgmma`` repeats the kernel's steps on [P, T, D] tensors: keys
  padded with zero rows to 256 (TMA's zero fill), queries in 64-row tiles,
  the scores of all 256 key slots of a row in fp32, keys at or past T
  masked; then either the attention's arithmetic (``_attn_kernel``: m =
  max(s) * c2 with c2 = scale * log2(e), p = 2^(s c2 - m) with the product
  and the difference rounded once as an fma rounds them, l = sum p, p * (1
  / l) rounded to the element type, P V in fp32, rounded) or the layer
  stack's (``_block_kernel``: e = bf16(2^min(s, 100)), the sum of the
  rounded e, bf16((e V) * (1 / sum e))).  Each row's sum is taken in the
  kernel's fp32 order (``row_sums``: a thread's partial sums, then the
  quad's), and P V is added slice by slice (``slice_pv``), as the kernel
  issues it a group of slices at a time while P is packed.
- The attention's emulation is held against ``attention_einsum`` and JAX
  ``attention_pallas`` in interpret mode (as ``tests/test_attention.py``
  runs it), the layer stack's against ``fused_blocks.attention_reference``
  (the attention of ``blocks_reference``, itself held against JAX
  ``_blocks_call`` by ``tests/test_torch_blocks.py``), at the head dims of
  the 2M and 6M (32) and the 85M (64), and 16 and 48 (the kernel's other
  two), at T = 1, 130, 200 and 256, in bf16 and fp16: within 0.01 *
  max|ref| + 1e-3, one rounding of p (or e) and of o apart.
- ``kernel_width`` names the padded width the kernel of each shape's
  route reads (the route is ``csrc/attention.cu``'s ``attention_route``
  alone, which ``chip_smoke.py`` names for each compare on the card);
  ``check_shape`` takes those shapes and raises past the head dims each dtype's kernels take; the
  stride checks keep the module's q|k|v views and copy what TMA cannot
  read; ``blocks_attention`` raises for heads that need padding; none of
  them builds anything.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mapf_gpt_tpu.ops.attention import attention_pallas as jax_attention_pallas
from mapf_gpt_tpu_torch.ops import _build
from mapf_gpt_tpu_torch.ops import attention as tatt
from mapf_gpt_tpu_torch.ops import fused_blocks

LOG2E = np.float32(1.4426950408889634)
T_MAX, ROWS = 256, 64
NT, NS = T_MAX // 8, T_MAX // 16   # n8 tiles of the scores, 16-key slices


def row_sums(x, blocks=False):
    """Each row's sum of x [..., 256] in fp32 in the kernel's order (the
    tile's row_sums): a thread (c4) holds keys 8 j + 2 c4 + c (c = 0, 1) and
    adds them into four partial sums by n8 tile j % 4 (the attention's) or
    by 16-key slice kk % 4, slice kk's two n8 tiles in turn (the layer
    stack's, as each slice is packed); then ((s0 + s0') + (s1 + s1')) + ((s2
    + s2') + (s3 + s3')) a thread, and the quad's four as (t0 + t1) + (t2 +
    t3)."""
    xs = x.reshape(*x.shape[:-1], NT, 4, 2)              # [..., j, c4, c]
    parts = []
    for m in range(4):
        js = ([j for kk in range(m, NS, 4) for j in (2 * kk, 2 * kk + 1)] if blocks
              else list(range(m, NT, 4)))
        acc = xs[..., js[0], :, :]
        for j in js[1:]:
            acc = acc + xs[..., j, :, :]
        parts.append(acc)
    t = (((parts[0][..., 0] + parts[0][..., 1]) + (parts[1][..., 0] + parts[1][..., 1]))
         + ((parts[2][..., 0] + parts[2][..., 1]) + (parts[3][..., 0] + parts[3][..., 1])))
    return ((t[..., 0] + t[..., 1]) + (t[..., 2] + t[..., 3]))[..., None]


def slice_pv(p, v):
    """P V in fp32 over the 16 slices of 16 keys, added in slice order, as
    the kernel's wgmma products accumulate (whether issued at once or a
    group at a time as P is packed)."""
    o = p[..., :16] @ v[:, :16]
    for kk in range(1, NS):
        o = o + p[..., 16 * kk:16 * kk + 16] @ v[:, 16 * kk:16 * kk + 16]
    return o


def emulate_wgmma(q, k, v, scale, blocks=False):
    """The wgmma kernel's order of work on [P, T, D] bf16 or fp16 tensors;
    `blocks` picks the layer stack's arithmetic (q already carries the
    scale and log2(e))."""
    p_, t, d = q.shape
    dtype = q.dtype
    pad = torch.zeros((p_, T_MAX - t, d), dtype=dtype)
    kp, vp = torch.cat([k, pad], 1).float(), torch.cat([v, pad], 1).float()
    masked = torch.arange(T_MAX) >= t
    c2 = np.float32(scale) * LOG2E
    out = torch.empty((p_, t, d), dtype=dtype)
    for t0 in range(0, t, ROWS):
        qt = q[:, t0:t0 + ROWS].float()
        s = qt @ kp.transpose(1, 2)                          # [P, rows, 256] fp32
        if blocks:
            e = torch.exp2(s.clamp(max=100.0)).to(dtype)
            e[..., masked] = 0
            inv = 1.0 / row_sums(e.float(), blocks=True)
            o = slice_pv(e.float(), vp) * inv
        else:
            s = s.masked_fill(masked, -np.inf)
            m = s.amax(-1, keepdim=True) * abs(c2)
            x = (s.double() * float(c2) - m.double()).float()   # one rounding, as fmaf
            p = torch.exp2(x).masked_fill(masked, 0.0)
            inv = 1.0 / row_sums(p)
            o = slice_pv((p * inv).to(dtype).float(), vp)
        out[:, t0:t0 + ROWS] = o.to(dtype)
    return out


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _tol(ref):
    return 0.01 * ref.abs().max().item() + 1e-3


HEAD_DIMS = [("2M/6M", 32), ("85M", 64), ("16", 16), ("48", 48)]


@pytest.mark.parametrize("t", [1, 130, 200, 256])
@pytest.mark.parametrize("label,d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_attention_order_of_work_matches_plain_and_jax(dtype, label, d, t):
    shape = (2, 3, t, d)
    q, k, v = _inputs(shape, seed=t + d)
    scale = 1.0 / np.sqrt(d)
    x = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    got = emulate_wgmma(*(a.reshape(6, t, d) for a in x), scale).reshape(shape).float()
    ref = tatt.attention_einsum(*x, scale).float()
    assert (got - ref).abs().max().item() <= _tol(ref)
    with pltpu.force_tpu_interpret_mode():
        jax_ref = jax_attention_pallas(*(jnp.asarray(a, dtype=getattr(jnp, str(dtype)[6:]))
                                         for a in (q, k, v)), scale, group=3)
    jax_ref = torch.from_numpy(np.array(jax_ref.astype(jnp.float32)))
    assert (got - jax_ref).abs().max().item() <= _tol(jax_ref)


@pytest.mark.parametrize("t", [1, 130, 200, 256])
@pytest.mark.parametrize("label,d", HEAD_DIMS)
def test_blocks_order_of_work_matches_blocks_reference(label, d, t):
    h = 3
    rng = np.random.RandomState(t + d + 1)
    qkv = rng.randn(2, t, 3 * h * d).astype(np.float32)
    qkv[..., :h * d] *= LOG2E / np.sqrt(d)   # W_q's folded scale
    qkv = torch.from_numpy(qkv).to(torch.bfloat16)
    ref = fused_blocks.attention_reference(qkv, h).float()
    q, k, v = (z.reshape(2, t, h, d).transpose(1, 2).reshape(2 * h, t, d)
               for z in qkv.split(h * d, dim=-1))
    got = emulate_wgmma(q, k, v, 1.0, blocks=True)
    got = got.reshape(2, h, t, d).transpose(1, 2).reshape(2, t, h * d).float()
    assert (got - ref).abs().max().item() <= _tol(ref)
    # on the CPU the wrapper is the plain version itself
    assert torch.equal(fused_blocks.blocks_attention(qkv, h),
                       fused_blocks.attention_reference(qkv, h))


ROUTE_CASES = [   # (T, D, dtype, the launcher's route, kernel width)
    (256, 32, torch.bfloat16, "wgmma", 32), (256, 64, torch.float16, "wgmma", 64),
    (1, 16, torch.bfloat16, "wgmma", 16), (200, 48, torch.bfloat16, "wgmma", 48),
    (256, 24, torch.bfloat16, "wgmma", 32), (256, 8, torch.float16, "wgmma", 16),
    (257, 32, torch.bfloat16, "tile", 32), (256, 80, torch.bfloat16, "tile", 80),
    (256, 72, torch.float16, "tile", 80), (1024, 128, torch.bfloat16, "tile", 128),
    (256, 144, torch.bfloat16, "wide", 160), (300, 256, torch.bfloat16, "wide", 256),
    (256, 672, torch.bfloat16, "wide", 672), (256, 144, torch.float16, "fma", 144),
    (256, 842, torch.float16, "fma", 842), (256, 32, torch.float32, "fma", 32),
    (1, 842, torch.float32, "fma", 842),
]


@pytest.mark.parametrize("t,d,dtype,want,width", ROUTE_CASES)
def test_route_and_kernel_width(t, d, dtype, want, width, monkeypatch):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    tatt.check_shape(t, d, dtype)
    assert tatt.kernel_width(d, dtype) == width
    # the FMA route reads the head as it is; the 16-bit tiles a multiple of
    # 16 columns, past 128 (the slabs) in equal slabs of at most 128
    assert width == d if want == "fma" else width % 16 == 0 and width - d < 16 * -(-d // 128)
    assert (width > 128) == (want == "wide" or (want == "fma" and d > 128))


@pytest.mark.parametrize("t,d,dtype", [(256, 673, torch.bfloat16), (256, 843, torch.float16),
                                       (256, 843, torch.float32), (0, 32, torch.bfloat16)])
def test_check_shape_raises_past_each_dtypes_kernels(t, d, dtype, monkeypatch):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(ValueError, match="head dim|T must be"):
        tatt.check_shape(t, d, dtype)


def test_bf16_slab_limit_is_the_shared_memory_budget():
    """_D_MAX_BF16 is the widest head whose slabs' windows fit
    attn_tile.cuh's WIDE_BUDGET (wide_window > 0), every narrower one too."""
    def fits(d):
        dt = tatt.kernel_width(d, torch.bfloat16)
        dv = dt // -(-d // 128)
        return 128 * (dt + 8) + 128 * (dt + dv + 16) <= 200 * 1024
    assert all(fits(d) for d in range(129, tatt._D_MAX_BF16 + 1))
    assert not fits(tatt._D_MAX_BF16 + 1)
    # and the FMA kernel's staging at _D_MAX_FMA fits a block's 232,448 bytes
    assert ((32 + 32) * (tatt._D_MAX_FMA + 1) + 32 * 129) * 4 <= 232448
    assert ((32 + 32) * (tatt._D_MAX_FMA + 2) + 32 * 129) * 4 > 232448


def test_strided_views_go_in_and_others_are_copied(monkeypatch):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    b, t, h, d = 2, 16, 8, 32
    qkv = torch.zeros((b, t, 3 * h * d), dtype=torch.bfloat16)
    views = [z.reshape(b, t, h, d).transpose(1, 2) for z in qkv.split(h * d, dim=-1)]
    assert all(tatt._tma_ready(x) and tatt._kernel_ready(x, d) is x for x in views)
    odd = torch.zeros((b, h, t, d + 1), dtype=torch.bfloat16)[..., 1:]   # 66-byte rows
    assert not tatt._tma_ready(odd)
    copy = tatt._kernel_ready(odd, d)
    assert copy is not odd and copy.is_contiguous() and tatt._tma_ready(copy)
    expanded = torch.zeros((1, h, t, d), dtype=torch.bfloat16).expand(b, h, t, d)
    assert not tatt._tma_ready(expanded)            # a zero stride TMA cannot take
    single = torch.zeros((1, 1, 1, d), dtype=torch.bfloat16).as_strided((1, 1, 1, d),
                                                                        (5, 3, 7, 1))
    assert tatt._tma_ready(single)                  # dims of one element carry any stride


def test_blocks_attention_raises_for_padded_heads_before_building(monkeypatch):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    qkv = torch.zeros((2, 8, 3 * 96), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="need padding"):
        fused_blocks.blocks_attention(qkv, 4)        # head dim 24 -> 32 columns
