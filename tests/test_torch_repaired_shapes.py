"""The shapes the port's kernels used to refuse, in plain form against the
JAX package (numpy in between, JAX's Pallas kernels in interpret mode), and
the layouts and names the CUDA side relies on:

- ``blocks_reference`` against JAX ``_blocks_call`` at n_embd 250 (5 heads,
  not a multiple of 8) and n_embd 1032 (4 heads of 258 columns, past 128),
  with and without ``last_only``: the bf16 stream within 0.02 * max|ref|
  (``chip_smoke.py``'s stream tolerance);
- ``train_fwd_reference`` and ``train_bwd_reference`` against JAX
  ``_fwd_call`` and ``_bwd_call`` at the same widths: out and xsave within
  0.02 * max|ref| + 0.02, dx and the six gradients within 0.08 * max|ref| +
  1e-4 (``tests/test_fused_gpt_train.py``);
- fp16 attention: ``attention_pallas`` (its plain version on the CPU)
  against JAX ``attention_pallas`` in fp16, within the bf16 tolerance
  0.01 * max|ref| + 1e-3;
- the padded layout the CUDA kernels take (``fused_blocks.kernel_layout``,
  ``pad_width``): only zeros are added, the products over the padded
  operands equal those over the operands as they are, and a wide head
  splits into slabs of at most 128 columns; the training wrapper's
  unpadding recovers the stacks' shapes;
- both shapes are planned on the layer-stack kernel without a build;
- ``utils.profiling.kernel_key`` keys the profiler's kernel names by the
  function's own name, so two attention-backward kernels of one namespace
  keep apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.ops import fused_gpt_train as jfgt
from mapf_gpt_tpu.ops.attention import attention_pallas as jax_attention_pallas
from mapf_gpt_tpu.ops.fused_gpt import _blocks_call, stack_block_weights
from mapf_gpt_tpu_torch.ops import _build, fused_blocks, fused_gpt
from mapf_gpt_tpu_torch.ops import attention as tatt
from mapf_gpt_tpu_torch.ops import fused_gpt_train as fgt
from mapf_gpt_tpu_torch.ops.fused_blocks import blocks_reference, kernel_layout, pad_width
from mapf_gpt_tpu_torch.ops.fused_gpt import stack_weights
from mapf_gpt_tpu_torch.utils.profiling import kernel_key
from tests.test_torch_lifted_shapes import _bf16_torch, _carried, _close, _f32

# (n_embd, heads, T): n_embd not a multiple of 8; a head dim of 258
SHAPES = [(250, 5, 24), (1032, 4, 12)]


@pytest.mark.parametrize("last_only", [True, False])
@pytest.mark.parametrize("e,h,t", SHAPES)
def test_blocks_reference_matches_jax_at_repaired_shapes(e, h, t, last_only):
    jcfg = JGPTConfig(n_layer=1, n_head=h, n_embd=e)
    params, model = _carried(jcfg, key=e + h)
    x = (np.random.RandomState(e + t).randn(2, t, e) * 0.05).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    ref = _blocks_call(xj, stack_block_weights(params, jcfg), jcfg, ctx=2,
                       last_only=last_only, interpret=True)
    got = blocks_reference(_bf16_torch(xj), stack_weights(model).stacks(), last_only)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1 if last_only else t, e)
    _close(got.float().numpy(), _f32(ref), 0.02, 0.0, "stream")


@pytest.mark.parametrize("e,h,t", SHAPES)
def test_train_references_match_jax_at_repaired_shapes(e, h, t):
    jcfg = JGPTConfig(n_layer=1, n_head=h, n_embd=e, block_size=t)
    params, model = _carried(jcfg, key=e + 3)
    jstacks, stacks = jfgt.build_train_stacks(params, jcfg), fgt.build_train_stacks(model)
    x = jnp.asarray((np.random.RandomState(e).randn(2, t, e) * 0.05).astype(np.float32)
                    ).astype(jnp.bfloat16)
    ref_out, ref_save = jfgt._fwd_call(jstacks, x, jcfg, 1, True, last_only=False)
    with torch.no_grad():
        out, xsave = fgt.train_fwd_reference(_bf16_torch(x), stacks, False)
    _close(out.float().numpy(), _f32(ref_out), 0.02, 0.02, "out")
    _close(xsave.float().numpy(), _f32(ref_save), 0.02, 0.02, "xsave")
    dxin = np.zeros((2, t, e), np.float32)
    dxin[:, -1] = np.random.RandomState(e + 1).randn(2, e) * 0.1
    dxin = jnp.asarray(dxin).astype(jnp.bfloat16)
    ref = jfgt._bwd_call(jstacks, ref_save, dxin, jcfg, 1, True)
    with torch.no_grad():
        dx, grads = fgt.train_bwd_reference(_bf16_torch(ref_save), _bf16_torch(dxin), stacks)
    for name, got, want in zip(("dx", "dwqkv", "dwproj", "dwfc", "dwfc2", "dg1", "dg2"),
                               (dx, *grads), ref):
        _close(got.float().numpy(), _f32(want), 0.08, 1e-4, name)


@pytest.mark.parametrize("shape", [(2, 5, 64, 32), (1, 3, 100, 24), (1, 2, 300, 16)])
def test_fp16_attention_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(shape[-1])
    with pltpu.force_tpu_interpret_mode():
        ref = jax_attention_pallas(*(jnp.asarray(a, dtype=jnp.float16) for a in (q, k, v)),
                                   scale, group=2)
    ref = np.asarray(ref.astype(jnp.float32))
    tatt.check_shape(shape[2], shape[3], torch.float16)
    got = tatt.attention_pallas(*(torch.from_numpy(a).half() for a in (q, k, v)), scale)
    assert got.dtype == torch.float16 and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=0.01 * np.abs(ref).max() + 1e-3)


@pytest.mark.parametrize("e,h", [(250, 5), (1032, 4), (255, 5), (768, 12)])
def test_kernel_layout_adds_only_zeros_and_changes_no_product(e, h):
    gen = torch.Generator().manual_seed(e)
    f = 4 * e
    stacks = fgt.TrainStacks(*(torch.randn(s, generator=gen).to(torch.bfloat16)
                               for s in ((1, e, 3 * e), (1, e, e), (1, e, f), (1, f, e))),
                             torch.rand((1, e), generator=gen) + 0.5,
                             torch.rand((1, e), generator=gen) + 0.5, n_head=h)
    wqkv, wproj, wfc, wfc2, g1, g2 = kernel_layout(stacks)
    es, fs = fused_blocks.stored_width(e), fused_blocks.stored_width(f)
    dh = e // h
    dp = fused_blocks.padded_head_dim(dh)
    ns = -(-dh // 128)
    assert es % 8 == 0 and fs % 8 == 0 and es - e < 8 and fs - f < 8
    assert dp % ns == 0 and (dp // ns) % 16 == 0 and dp // ns <= 128 and dp >= dh
    assert wqkv.shape == (1, es, 3 * h * dp) and wproj.shape == (1, h * dp, es)
    assert wfc.shape == (1, es, fs) and wfc2.shape == (1, fs, es) and g1.shape == (1, es)
    # the zeros: padding rows and columns, padding head columns, padding gains
    assert not wqkv[:, e:].any() and not wproj[..., e:].any() and not g1[:, e:].any()
    assert not wfc[:, e:].any() and not wfc[..., f:].any() and not wfc2[:, f:].any()
    cols = wqkv[:, :e].reshape(1, e, 3, h, dp)
    assert torch.equal(cols[..., :dh].reshape(1, e, 3 * e), stacks.wqkv)
    assert not cols[..., dh:].any()
    # the products over the padded operands equal those over the operands as they are
    x = torch.randn((3, e), generator=gen).to(torch.bfloat16)
    xp = pad_width(x)
    assert xp.shape == (3, es) and torch.equal(xp[:, :e], x) and not xp[:, e:].any()
    qkv = (xp.float() @ wqkv[0].float()).reshape(3, 3, h, dp)
    torch.testing.assert_close(qkv[..., :dh].reshape(3, 3 * e),
                               x.float() @ stacks.wqkv[0].float(), rtol=1e-5, atol=1e-3)
    assert not qkv[..., dh:].any()
    hid = xp.float() @ wfc[0].float()
    torch.testing.assert_close(hid[:, :f], x.float() @ stacks.wfc[0].float(),
                               rtol=1e-5, atol=1e-3)
    assert not hid[:, f:].any()
    grads = fgt._unpad_grads(tuple(torch.randn(w.shape, generator=gen)
                                   for w in (wqkv, wproj, wfc, wfc2, g1, g2)), e, h)
    assert [g.shape for g in grads] == [w.shape for w in stacks[:6]]


@pytest.mark.parametrize("e,h", [(250, 5), (1032, 4), (196, 7)])
def test_repaired_shapes_are_planned_without_a_build(monkeypatch, e, h):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    monkeypatch.setattr(_build, "find_nvcc", lambda: pytest.fail("looked for nvcc"))
    assert fused_gpt.cuda_plan(e, h, 2, 256)[1] == "fused_blocks"
    fused_blocks.check_width(256, e, h)
    fgt.check_train_width(300, e, h)


def test_kernel_key_keeps_kernels_of_one_namespace_apart():
    names = {
        "void (anonymous namespace)::attn_bwd_q_kernel<32>(__nv_bfloat16 const*, "
        "float const*, attn::Strides)": "attn_bwd_q_kernel",
        "void (anonymous namespace)::attn_bwd_kv_kernel<32>(__nv_bfloat16 const*, int)":
            "attn_bwd_kv_kernel",
        "void attn::attn_fwd_stream<32, __nv_bfloat16>(attn::Strides, int)": "attn_fwd_stream",
        "void (anonymous namespace)::ln_kernel(__nv_bfloat16 const*, long long)": "ln_kernel",
        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": (
            "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"),
    }
    for name, key in names.items():
        assert kernel_key(name) == key, name
    assert len({kernel_key(n) for n in names}) == len(names)
