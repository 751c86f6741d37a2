"""The layer kernels' lifted shapes (any T, head dims off multiples of 16,
n_embd a multiple of 8), against the JAX package
(numpy in between, JAX's Pallas kernels in interpret mode):

- ``blocks_reference`` (the plain version of ``csrc/fused_blocks.cu``)
  against JAX ``_blocks_call(..., interpret=True)`` at T = 200 (the 85M's
  width, one layer), head dims 8 and 24 and n_embd 336 (21 heads), with
  and without ``last_only``: the bf16 stream within 0.02 * max|ref|
  (``chip_smoke.py``'s stream tolerance);
- the port's chunked ``fused_logits`` plain route against JAX
  ``fused_logits`` on its chunked route (``layers_per_call=1``) at the same
  shapes, an 85M-shaped but shallow config among them: logits within
  0.02 * max|ref| + 0.02 with >= 95 % argmax agreement over the 5 action
  logits (``tests/test_fused_gpt.py``);
- ``train_fwd_reference`` and ``train_bwd_reference`` against JAX
  ``_fwd_call`` and ``_bwd_call`` at head dim 8, n_embd 200 and T = 300
  (one or two layers, 2 contexts): out and xsave within 0.02 * max|ref| +
  0.02, dx and the six gradients within 0.08 * max|ref| + 1e-4
  (``tests/test_fused_gpt_train.py``);
- the padded head layout the CUDA kernels take for head dims that are not
  multiples of 16 (``fused_blocks.pad_heads``): only zero columns and rows
  are added, the scores and P V over padded heads equal those over the
  heads as they are, and the training wrapper's unpadding recovers the
  gradients' shapes;
- the plans: each of these shapes is planned on a kernel without a
  build.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.models.gpt import init_params as jinit_params
from mapf_gpt_tpu.ops import fused_gpt_train as jfgt
from mapf_gpt_tpu.ops.fused_gpt import _blocks_call, stack_block_weights
from mapf_gpt_tpu.ops.fused_gpt import fused_logits as jax_fused_logits
from mapf_gpt_tpu_torch.models.convert import load_model, params_to_state_dict
from mapf_gpt_tpu_torch.models.gpt import GPTConfig
from mapf_gpt_tpu_torch.ops import _build, fused_blocks, fused_gpt
from mapf_gpt_tpu_torch.ops import fused_gpt_train as fgt
from mapf_gpt_tpu_torch.ops.fused_blocks import blocks_reference, pad_heads
from mapf_gpt_tpu_torch.ops.fused_gpt import chunked_logits, stack_weights

_init_params = jax.jit(jinit_params, static_argnums=0)

# (n_embd, heads, T): the 85M's width at T = 200, head dims 8 and 24, n_embd 336
BLOCK_SHAPES = [(768, 12, 200), (96, 12, 200), (96, 4, 200), (336, 21, 200)]
# (n_embd, heads, T, layers): head dim 8, n_embd 200 and T = 300 together
TRAIN_SHAPE = (200, 25, 300, 2)


def _carried(jcfg, key):
    """(JAX params, the port's model on the CPU with the same weights)."""
    params = _init_params(jcfg, jax.random.PRNGKey(key))
    cfg = GPTConfig(block_size=jcfg.block_size, vocab_size=jcfg.vocab_size,
                    n_layer=jcfg.n_layer, n_head=jcfg.n_head, n_embd=jcfg.n_embd)
    sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return params, load_model(cfg, sd, device="cpu")


def _f32(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _bf16_torch(a):
    return torch.from_numpy(_f32(a)).to(torch.bfloat16)


def _close(got, ref, scale, floor, what):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    tol = scale * np.abs(ref).max() + floor
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("last_only", [True, False])
@pytest.mark.parametrize("e,h,t", BLOCK_SHAPES)
def test_blocks_reference_matches_jax_blocks_call_at_lifted_shapes(e, h, t, last_only):
    jcfg = JGPTConfig(n_layer=1, n_head=h, n_embd=e)
    params, model = _carried(jcfg, key=e + h)
    x = (np.random.RandomState(e + t).randn(2, t, e) * 0.05).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    ref = _blocks_call(xj, stack_block_weights(params, jcfg), jcfg, ctx=2,
                       last_only=last_only, interpret=True)
    got = blocks_reference(_bf16_torch(xj), stack_weights(model).stacks(), last_only)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1 if last_only else t, e)
    _close(got.float().numpy(), _f32(ref), 0.02, 0.0, "stream")


@pytest.mark.parametrize("e,h,t", BLOCK_SHAPES)
def test_chunked_route_matches_jax_fused_logits_at_lifted_shapes(e, h, t):
    jcfg = JGPTConfig(n_layer=2, n_head=h, n_embd=e)
    params, model = _carried(jcfg, key=e + t)
    tok = np.random.RandomState(e + h).randint(0, jcfg.vocab_size, size=(8, t))
    ref = np.asarray(jax_fused_logits(params, jnp.asarray(tok), jcfg, interpret=True,
                                      layers_per_call=1, ctx_per_program=8))
    got = chunked_logits(stack_weights(model), torch.from_numpy(tok), 1).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    _close(got, ref, 0.02, 0.02, "logits")
    assert (got[:, :5].argmax(-1) == ref[:, :5].argmax(-1)).mean() >= 0.95


@pytest.fixture(scope="module")
def train_setup():
    e, h, t, layers = TRAIN_SHAPE
    jcfg = JGPTConfig(n_layer=layers, n_head=h, n_embd=e, block_size=t)
    params, model = _carried(jcfg, key=7)
    x = (np.random.RandomState(8).randn(2, t, e) * 0.05).astype(np.float32)
    return (jcfg, jfgt.build_train_stacks(params, jcfg), fgt.build_train_stacks(model),
            jnp.asarray(x).astype(jnp.bfloat16))


@pytest.mark.parametrize("last_only", [False, True])
def test_train_fwd_reference_matches_jax_at_head_dim_8_t_300(train_setup, last_only):
    jcfg, jstacks, stacks, x = train_setup
    ref_out, ref_save = jfgt._fwd_call(jstacks, x, jcfg, 2, True, last_only=last_only)
    with torch.no_grad():
        out, xsave = fgt.train_fwd_reference(_bf16_torch(x), stacks, last_only)
    _close(out.float().numpy(), _f32(ref_out), 0.02, 0.02, "out")
    _close(xsave.float().numpy(), _f32(ref_save), 0.02, 0.02, "xsave")


def test_train_bwd_reference_matches_jax_at_head_dim_8_t_300(train_setup):
    jcfg, jstacks, stacks, x = train_setup
    _, xsave = jfgt._fwd_call(jstacks, x, jcfg, 2, True, last_only=False)
    dxin = np.zeros((2, jcfg.block_size, jcfg.n_embd), np.float32)
    dxin[:, -1] = np.random.RandomState(9).randn(2, jcfg.n_embd) * 0.1
    dxin = jnp.asarray(dxin).astype(jnp.bfloat16)
    ref = jfgt._bwd_call(jstacks, xsave, dxin, jcfg, 2, True)
    with torch.no_grad():
        dx, grads = fgt.train_bwd_reference(_bf16_torch(xsave), _bf16_torch(dxin), stacks)
    for name, got, want in zip(("dx", "dwqkv", "dwproj", "dwfc", "dwfc2", "dg1", "dg2"),
                               (dx, *grads), ref):
        _close(got.float().numpy(), _f32(want), 0.08, 1e-4, name)


@pytest.mark.parametrize("e,h", [(96, 12), (96, 4), (200, 25), (256, 8)])
def test_padded_heads_add_only_zeros_and_change_no_score(e, h):
    gen = torch.Generator().manual_seed(e + h)
    wqkv = torch.randn((2, e, 3 * e), generator=gen).to(torch.bfloat16)
    wproj = torch.randn((2, e, e), generator=gen).to(torch.bfloat16)
    pq, pp = pad_heads(wqkv, wproj, h)
    dh = e // h
    dp = fused_blocks.padded_head_dim(dh)
    assert dp % 16 == 0 and dp - dh < 16
    assert pq.shape == (2, e, 3 * h * dp) and pp.shape == (2, h * dp, e)
    if dp == dh:
        assert pq is wqkv and pp is wproj
    cols = pq.reshape(2, e, 3, h, dp)
    rows = pp.reshape(2, h, dp, e)
    assert torch.equal(cols[..., :dh].reshape(2, e, 3 * e), wqkv)
    assert torch.equal(rows[:, :, :dh].reshape(2, e, e), wproj)
    assert not cols[..., dh:].any() and not rows[:, :, dh:].any()
    # scores and P V over the padded heads equal those over the heads as they are
    xn = torch.randn((3, 5, e), generator=gen).to(torch.bfloat16).float()
    q, k, v = (xn @ pq[0].float()).reshape(3, 5, 3, h, dp).unbind(2)
    q0, k0, v0 = (xn @ wqkv[0].float()).reshape(3, 5, 3, h, dh).unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    torch.testing.assert_close(s, torch.einsum("bqhd,bkhd->bhqk", q0, k0), rtol=1e-5, atol=1e-4)
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    assert not o[..., dh:].any()
    torch.testing.assert_close(o.reshape(3, 5, h * dp) @ pp[0].float(),
                               o[..., :dh].reshape(3, 5, e) @ wproj[0].float(),
                               rtol=1e-5, atol=1e-4)
    stacks = fgt.TrainStacks(wqkv, wproj, torch.zeros((2, e, 4 * e)), torch.zeros((2, 4 * e, e)),
                             torch.ones((2, e)), torch.ones((2, e)), n_head=h)
    padded = fused_blocks.kernel_layout(stacks)
    grads = fgt._unpad_grads(tuple(torch.randn(w.shape, generator=gen) for w in padded), e, h)
    assert [g.shape for g in grads] == [w.shape for w in stacks[:6]]


@pytest.mark.parametrize("e,h,t,layers", [(768, 12, 200, 12), (96, 12, 200, 2), (96, 4, 200, 2),
                                          (336, 21, 200, 2), (200, 25, 300, 2)])
def test_lifted_shapes_are_planned_without_a_build(monkeypatch, e, h, t, layers):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    monkeypatch.setattr(_build, "find_nvcc", lambda: pytest.fail("looked for nvcc"))
    assert fused_gpt.cuda_plan(e, h, layers, t)[1] == "fused_blocks"
    fgt.check_train_width(t, e, h)
