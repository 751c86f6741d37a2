"""The port's attention (``mapf_gpt_tpu_torch/ops/attention.py``) against
the JAX package's (``mapf_gpt_tpu/ops/attention.py``), on the same numpy
inputs:

- ``attention_pallas`` (on the CPU, its plain version) against JAX
  ``attention_pallas`` in interpret mode, as ``tests/test_attention.py``
  runs it: that file's three shapes and its pair-count remainder, head dim
  16 and a T of 200 that is not a multiple of 16; fp32 within rtol = atol =
  1e-4 (``tests/test_attention.py``), bf16 within 0.01 * max|ref| + 1e-3
  (one bf16 rounding of p and of o apart);
- neither can be differentiated: JAX has no gradient rule for the kernel,
  and the port's wrapper raises before it looks at the device;
- ``attention`` dispatches as the JAX one: "pallas" to the kernel's
  wrapper, anything else to the plain version;
- ``check_shape`` takes the shapes the CUDA kernels take (any T >= 1, head
  dims 1..672 in bf16 and 1..842 in fp16 and fp32) and names the constraint
  of any other, without building anything; the same comparison with JAX
  runs at T = 300 and 512 and at head dims 8, 24 and 72, which the kernel
  takes since its two-pass redesign, and at head dims 144 and 256, which it
  takes since heads past 128 were routed to the slab and FMA kernels;
- the wrapper's zero columns (bf16 heads padded to a multiple of 16) change
  no output column;
- a test-only emulation in plain PyTorch of the bf16 kernel's order of work
  (``csrc/attn_tile.cuh``: pass 1 keeps each row's running max and sum in
  the log2 domain over 64-key chunks, pass 2 rounds the normalised p to
  bf16 and sums P V in fp32, windows of K and V for a long T) against
  ``attention_einsum`` at the 2M's, 6M's and 85M's head dims, within the
  bf16 tolerance, so an algebra slip shows here before the card runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mapf_gpt_tpu.ops.attention import attention_pallas as jax_attention_pallas
from mapf_gpt_tpu_torch.ops import _build
from mapf_gpt_tpu_torch.ops import attention as tatt

SHAPES = [(4, 5, 256, 32), (2, 8, 256, 32), (3, 12, 256, 64),   # tests/test_attention.py
          (1, 3, 256, 32),                                       # 3 pairs, group 8
          (2, 4, 256, 16), (2, 3, 200, 32)]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _jax(q, k, v, scale, dtype, group):
    with pltpu.force_tpu_interpret_mode():
        out = jax_attention_pallas(*(jnp.asarray(x, dtype=dtype) for x in (q, k, v)), scale,
                                   group=group)
    return np.asarray(out.astype(jnp.float32))


# shapes the kernel takes since its two-pass redesign: T past 256, head dims
# that are not multiples of 16 (padded with zero columns in bf16)
LIFTED_SHAPES = [(1, 2, 300, 32), (1, 2, 512, 32), (2, 3, 64, 8), (2, 3, 100, 24),
                 (1, 3, 128, 72),
                 # heads past 128: bf16 slabs of 80 and 128 columns, fp32 on FMA
                 (1, 3, 256, 144), (1, 2, 200, 256)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + LIFTED_SHAPES)
def test_attention_pallas_matches_jax(shape, dtype):
    q, k, v = _inputs(shape, seed=sum(shape))
    scale = 1.0 / np.sqrt(shape[-1])
    ref = _jax(q, k, v, scale, getattr(jnp, dtype), group=8 if shape[:2] == (1, 3) else 4)
    tdt = getattr(torch, dtype)
    got = tatt.attention_pallas(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), scale)
    assert got.dtype == tdt and got.shape == shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=0.01 * np.abs(ref).max() + 1e-3)


def test_neither_attention_kernel_has_a_gradient():
    q, k, v = _inputs((1, 2, 64, 16), seed=3)
    with pytest.raises(Exception, match="[Ll]inearization|differentiat|JVP|jvp"):
        with pltpu.force_tpu_interpret_mode():
            jax.grad(lambda x: jax_attention_pallas(x, jnp.asarray(k), jnp.asarray(v), 0.25,
                                                    group=2).sum())(jnp.asarray(q))
    for device in ("cpu", "meta"):
        tq, tk, tv = (torch.from_numpy(x).to(device) for x in (q, k, v))
        with pytest.raises(NotImplementedError, match="no gradient"):
            tatt.attention_pallas(tq.requires_grad_(), tk, tv, 0.25)
    with torch.no_grad():   # no gradient can be asked: the plain version runs
        out = tatt.attention_pallas(torch.from_numpy(q).requires_grad_(), torch.from_numpy(k),
                                    torch.from_numpy(v), 0.25)
    assert torch.equal(out, tatt.attention_einsum(*(torch.from_numpy(x) for x in (q, k, v)),
                                                  0.25))


def test_attention_dispatch_and_devices(monkeypatch):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    q = torch.zeros((1, 2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tatt.attention(q, q, q, 0.25, impl="pallas")
    for impl in ("auto", "einsum", "flash"):
        assert tatt.attention(q, q, q, 0.25, impl=impl).shape == q.shape
    x = [torch.from_numpy(a) for a in _inputs((1, 2, 16, 16), seed=5)]
    assert torch.equal(tatt.attention(*x, 0.25, impl="pallas"), tatt.attention_einsum(*x, 0.25))


@pytest.mark.parametrize("t,d,dtype,match", [
    (256, 32, torch.bfloat16, None), (1, 16, torch.float32, None), (200, 128, torch.bfloat16, None),
    (256, 96, torch.float32, None), (0, 32, torch.bfloat16, "T must be"),
    (257, 32, torch.bfloat16, None), (256, 8, torch.bfloat16, None),
    (256, 24, torch.bfloat16, None), (256, 144, torch.float32, None),
    (256, 1024, torch.float32, "head dim"), (256, 700, torch.bfloat16, "head dim"),
    (256, 32, torch.float16, None), (256, 32, torch.float64, "dtype"),
    (1024, 72, torch.float32, None),
    (300, 1, torch.bfloat16, None), (256, 0, torch.bfloat16, "head dim"),
])
def test_check_shape(t, d, dtype, match):
    if match is None:
        tatt.check_shape(t, d, dtype)
    else:
        with pytest.raises(ValueError, match=match):
            tatt.check_shape(t, d, dtype)


@pytest.mark.parametrize("d", [1, 8, 24, 72])
def test_zero_columns_change_no_output(d):
    """The bf16 wrapper pads a head dim to a multiple of 16 with zero columns
    and returns the first d: the padded attention's first d columns equal
    the unpadded attention's."""
    x = [torch.from_numpy(a).to(torch.bfloat16) for a in _inputs((2, 3, 40, d), seed=d)]
    dp = -(-d // 16) * 16
    padded = [tatt._kernel_ready(a, dp) for a in x]
    assert all(p.shape[-1] == dp and p.is_contiguous() for p in padded)
    assert all(torch.equal(p[..., d:], torch.zeros_like(p[..., d:])) for p in padded)
    got = tatt.attention_einsum(*padded, 0.3)[..., :d]
    ref = tatt.attention_einsum(*x, 0.3)
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), rtol=0, atol=1e-6)


LOG2E = np.float32(1.4426950408889634)


def emulate_kernel_fwd(q, k, v, scale, window=None, kc=64):
    """The bf16 kernel's order of work (csrc/attn_tile.cuh attn_fwd_bf16) in
    plain PyTorch, on [P, T, D] bf16: pass 1 over windows of K and chunks
    of kc keys keeps each row's running max m of s * scale * log2(e) and
    its sum l of 2^(that - m); pass 2 forms p = 2^(s scale log2 e - m) / l,
    rounds it to bf16 and sums P V in fp32.  Returns (o bf16, m, l)."""
    p_, t, _ = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    c2 = torch.tensor(np.float32(scale) * LOG2E)
    w = window or -(-t // kc) * kc
    chunks = [(c0, min(c0 + kc, w0 + w, t)) for w0 in range(0, t, w)
              for c0 in range(w0, min(w0 + w, t), kc)]
    m = torch.full((p_, t), -np.inf)
    l = torch.zeros((p_, t))
    for c0, c1 in chunks:
        s = (qf @ kf[:, c0:c1].transpose(1, 2)) * c2
        mn = torch.maximum(m, s.amax(-1))
        l = l * torch.exp2(m - mn) + torch.exp2(s - mn[..., None]).sum(-1)
        m = mn
    inv = 1.0 / l
    acc = torch.zeros_like(qf)
    for c0, c1 in chunks:
        s = qf @ kf[:, c0:c1].transpose(1, 2)
        p = (torch.exp2(s * c2 - m[..., None]) * inv[..., None]).to(torch.bfloat16)
        acc += p.float() @ vf[:, c0:c1]
    return acc.to(torch.bfloat16), m, l


@pytest.mark.parametrize("t,window", [(256, None), (200, None), (300, 128)])
@pytest.mark.parametrize("model,heads,d", [("2M", 5, 32), ("6M", 8, 32), ("85M", 12, 64)])
def test_kernel_order_of_work_matches_plain_version(model, heads, d, t, window):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs((2, heads, t, d), seed=t + d + heads))
    scale = 1.0 / np.sqrt(d)
    ref = tatt.attention_einsum(q, k, v, scale).float()
    got, m, l = emulate_kernel_fwd(*(x.reshape(2 * heads, t, d) for x in (q, k, v)), scale,
                                   window=window)
    got = got.float().reshape(ref.shape)
    tol = 0.01 * ref.abs().max().item() + 1e-3
    assert (got - ref).abs().max().item() <= tol
    # the statistics give the plain softmax's p (the training backward's use of them)
    s = (q.float() @ k.float().transpose(-1, -2)).reshape(2 * heads, t, t)
    p_ref = torch.softmax(s * scale, -1)
    p = torch.exp2(s * float(np.float32(scale) * LOG2E) - m[..., None]) / l[..., None]
    np.testing.assert_allclose(p.numpy(), p_ref.numpy(), rtol=1e-4, atol=1e-6)
