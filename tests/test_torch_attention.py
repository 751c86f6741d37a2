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
- ``check_shape`` takes the shapes the CUDA kernel takes and names the
  constraint of any other, without building anything.
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
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
    (257, 32, torch.bfloat16, "T must be"), (256, 8, torch.bfloat16, "head dim"),
    (256, 24, torch.bfloat16, "head dim"), (256, 144, torch.float32, "head dim"),
    (256, 32, torch.float16, "dtype"),
])
def test_check_shape(t, d, dtype, match):
    if match is None:
        tatt.check_shape(t, d, dtype)
    else:
        with pytest.raises(ValueError, match=match):
            tatt.check_shape(t, d, dtype)
