"""The training kernels' plain versions and the fused loss against the JAX
package (numpy in between, JAX's Pallas kernels in interpret mode):

- ``train_fwd_reference`` (the plain version of ``csrc/fused_train.cu``'s
  forward) against JAX ``_fwd_call(..., interpret=True)``: ``out`` and
  ``xsave`` over all layers, ``last_only`` both ways, within
  0.02 * max|ref| + 0.02 (the fused tolerance of ``tests/test_fused_gpt.py``);
- ``train_bwd_reference`` against JAX ``_bwd_call(..., interpret=True)`` on
  a 2-layer chunk: dx and the six gradients, each within
  0.08 * max|ref| + 1e-4 (``tests/test_fused_gpt_train.py``);
- the port's ``fused_loss_fn`` (on the CPU: the plain versions under the
  ``autograd.Function``) against the JAX ``fused_loss_fn(interpret=True)``
  and the JAX module ``loss_fn``: loss within 0.03, every parameter's
  gradient within 0.08 * max|ref| + 1e-4.  These mirror
  ``tests/test_fused_gpt_train.py``: a small config, the 2M's width, the
  padding path (N=10), forced 1-layer chunks and a few SGD steps;
- the wrappers: CPU tensors take the plain versions, other devices raise,
  and a width the kernels cannot hold raises before anything is built
  (any T >= 1, any n_embd, head dims 1 to 512, heads that divide n_embd);
- a test-only emulation in plain PyTorch of the redesigned attention
  backward's order of work (``csrc/fused_train.cu``: the forward's row
  statistics, the query side's delta pass then its ds / dq pass over
  32-key chunks, the key side's dk / dv pass over 32-query chunks, each
  from the statistics alone) against the attention part of
  ``train_bwd_reference`` at the 2M's, 6M's and 85M's head dims, within
  0.08 * max|ref| + 1e-4, and at a T that is not a multiple of the chunks.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.models.gpt import CONFIGS as JCONFIGS
from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.models.gpt import init_params as jinit_params
from mapf_gpt_tpu.ops import fused_gpt_train as jfgt
from mapf_gpt_tpu.train.train_step import loss_fn as jloss_fn
from mapf_gpt_tpu_torch.models.convert import (grads_to_params, load_model,
                                               params_to_state_dict)
from mapf_gpt_tpu_torch.models.gpt import GPTConfig
from mapf_gpt_tpu_torch.ops import fused_gpt_train as fgt
from tests.test_torch_attention import LOG2E, emulate_kernel_fwd

SMALL = JGPTConfig(n_layer=2, n_head=2, n_embd=64, block_size=64)
_init = jax.jit(jinit_params, static_argnums=0)


def _port_cfg(jcfg):
    return GPTConfig(block_size=jcfg.block_size, vocab_size=jcfg.vocab_size,
                     n_layer=jcfg.n_layer, n_head=jcfg.n_head, n_embd=jcfg.n_embd)


def _setup(jcfg, n, key=0):
    """(JAX params, the port's model with the same weights, tokens, targets)."""
    params = _init(jcfg, jax.random.PRNGKey(key))
    rng = np.random.RandomState(key)
    tokens = rng.randint(0, jcfg.vocab_size, (n, jcfg.block_size)).astype(np.int32)
    targets = rng.randint(0, 5, (n,)).astype(np.int32)
    sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), _port_cfg(jcfg))
    model = load_model(_port_cfg(jcfg), sd, device="cpu").train().requires_grad_()
    return params, model, tokens, targets


def _close(got, ref, scale, floor, what):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    tol = scale * np.abs(ref).max() + floor
    assert err <= tol, (what, err, tol)


def _f32(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _bf16_torch(a):
    return torch.from_numpy(_f32(a)).to(torch.bfloat16)


def _stream(jcfg, n, seed):
    """A residual stream of the embedding's scale, rounded to bf16 once."""
    x = (np.random.RandomState(seed).randn(n, jcfg.block_size, jcfg.n_embd) * 0.05)
    return jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def small():
    params, model, _, _ = _setup(SMALL, 4, key=5)
    return params, model, jfgt.build_train_stacks(params, SMALL), fgt.build_train_stacks(model)


@pytest.mark.parametrize("last_only", [False, True])
def test_train_fwd_reference_matches_jax_fwd_call(small, last_only):
    _, _, jstacks, stacks = small
    x = _stream(SMALL, 4, seed=1)
    ref_out, ref_save = jfgt._fwd_call(jstacks, x, SMALL, 2, True, last_only=last_only)
    with torch.no_grad():
        out, xsave = fgt.train_fwd_reference(_bf16_torch(x), stacks, last_only)
    assert out.dtype == xsave.dtype == torch.bfloat16
    _close(out.float().numpy(), _f32(ref_out), 0.02, 0.02, "out")
    _close(xsave.float().numpy(), _f32(ref_save), 0.02, 0.02, "xsave")


def test_forward_in_one_call_equals_layer_chunks(small):
    """x is bf16 at every layer boundary, so the forward over all layers
    equals 1-layer chunks chained (the JAX package's chunking above E=384)
    bit for bit: FusedBlocksTrain runs it in one call."""
    _, _, _, stacks = small
    x = _bf16_torch(_stream(SMALL, 2, seed=6))
    with torch.no_grad():
        out, xsave = fgt.train_fwd_reference(x, stacks, True)
        saves, y = [], x
        for lo in range(SMALL.n_layer):
            last = lo == SMALL.n_layer - 1
            y, save = fgt.train_fwd_reference(y, stacks.chunk(lo, lo + 1), last_only=last)
            saves.append(save)
    assert torch.equal(out, y) and torch.equal(xsave, torch.cat(saves))


def test_train_bwd_reference_matches_jax_bwd_call(small):
    _, _, jstacks, stacks = small
    x = _stream(SMALL, 4, seed=2)
    _, xsave = jfgt._fwd_call(jstacks, x, SMALL, 2, True, last_only=False)
    dxin = np.zeros((4, SMALL.block_size, SMALL.n_embd), np.float32)
    dxin[:, -1] = np.random.RandomState(3).randn(4, SMALL.n_embd) * 0.1
    dxin = jnp.asarray(dxin).astype(jnp.bfloat16)
    ref = jfgt._bwd_call(jstacks, xsave, dxin, SMALL, 2, True)
    with torch.no_grad():
        dx, grads = fgt.train_bwd_reference(_bf16_torch(xsave), _bf16_torch(dxin), stacks)
    assert dx.dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in grads)
    for name, got, want in zip(("dx", "dwqkv", "dwproj", "dwfc", "dwfc2", "dg1", "dg2"),
                               (dx, *grads), ref):
        _close(got.float().numpy(), _f32(want), 0.08, 1e-4, name)


def _port_loss_and_grads(model, tokens, targets):
    model.zero_grad(set_to_none=True)
    loss = fgt.fused_loss_fn(model, torch.from_numpy(tokens), torch.from_numpy(targets))
    loss.backward()
    return loss.item(), grads_to_params(model)


def _compare_grads(got, ref, atol_scale=0.08):
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(got)}
    assert len(flat_got) == len(flat_ref)
    for k, rv in flat_ref:
        ks = jax.tree_util.keystr(k)
        rv, gv = np.asarray(rv, np.float32), np.asarray(flat_got[ks], np.float32)
        assert gv.shape == rv.shape, ks
        err = np.abs(rv - gv).max()
        assert err <= atol_scale * (np.abs(rv).max() + 1e-5) + 1e-4, (ks, err)


def _against_both_jax_paths(jcfg, n, key):
    params, model, tokens, targets = _setup(jcfg, n, key)
    tj, yj = jnp.asarray(tokens), jnp.asarray(targets)
    loss, grads = _port_loss_and_grads(model, tokens, targets)
    for jfn in (lambda p: jloss_fn(jcfg, p, tj, yj),
                lambda p: jfgt.fused_loss_fn(jcfg, p, tj, yj, interpret=True)):
        ref_loss, ref_g = jax.value_and_grad(jfn)(params)
        assert abs(float(ref_loss) - loss) < 0.03, (float(ref_loss), loss)
        _compare_grads(grads, ref_g)


def test_small_config_grads():
    _against_both_jax_paths(SMALL, n=16, key=0)


def test_2m_config_grads():
    _against_both_jax_paths(JCONFIGS["2M"], n=4, key=1)


def test_padding_path_loss():
    jcfg = JGPTConfig(n_layer=1, n_head=2, n_embd=64, block_size=64)
    params, model, tokens, targets = _setup(jcfg, 10, key=2)   # 10 % 8 != 0
    ref = float(jloss_fn(jcfg, params, jnp.asarray(tokens), jnp.asarray(targets)))
    ref_fused = float(jfgt.fused_loss_fn(jcfg, params, jnp.asarray(tokens),
                                         jnp.asarray(targets), interpret=True))
    with torch.no_grad():
        got = float(fgt.fused_loss_fn(model, torch.from_numpy(tokens), torch.from_numpy(targets)))
    assert abs(ref - got) < 0.03 and abs(ref_fused - got) < 0.03, (ref, ref_fused, got)


def test_chunked_layers_grads(monkeypatch):
    """Force 1-layer chunks (the 85M's backward walk) in both packages on a
    small model; the JAX forward in 1-layer chunks too, which the port's
    one forward call must equal."""
    monkeypatch.setattr(jfgt, "_fwd_layers_per_call", lambda cfg: 1)
    for mod in (jfgt, fgt):
        monkeypatch.setattr(mod, "_bwd_layers_per_call", lambda cfg: 1)
    jcfg = JGPTConfig(n_layer=3, n_head=2, n_embd=64, block_size=64)
    params, model, tokens, targets = _setup(jcfg, 16, key=0)
    tj, yj = jnp.asarray(tokens), jnp.asarray(targets)
    loss, grads = _port_loss_and_grads(model, tokens, targets)
    ref_loss, ref_g = jax.value_and_grad(
        lambda p: jfgt.fused_loss_fn(jcfg, p, tj, yj, interpret=True))(params)
    assert abs(float(ref_loss) - loss) < 0.03
    _compare_grads(grads, ref_g)


def test_one_sgd_step_decreases_loss():
    """A few SGD steps on a fixed batch lower the fused loss (the gradients
    point downhill), as the JAX test of the same name."""
    _, model, tokens, targets = _setup(SMALL, 32, key=3)
    tok, tgt = torch.from_numpy(tokens), torch.from_numpy(targets)
    l0 = fgt.fused_loss_fn(model, tok, tgt).item()
    for _ in range(5):
        model.zero_grad(set_to_none=True)
        fgt.fused_loss_fn(model, tok, tgt).backward()
        with torch.no_grad():
            for p in model.parameters():
                p -= 0.1 * p.grad
    l1 = fgt.fused_loss_fn(model, tok, tgt).item()
    assert l1 < l0 - 0.5, (l0, l1)


def test_wrappers_take_plain_versions_on_cpu_and_raise_elsewhere(small):
    _, _, _, stacks = small
    x = _bf16_torch(_stream(SMALL, 2, seed=4))
    with torch.no_grad():
        out, xsave = fgt.train_forward(x, stacks, last_only=False)
        ref_out, ref_save = fgt.train_fwd_reference(x, stacks, False)
        assert torch.equal(out, ref_out) and torch.equal(xsave, ref_save)
        dx, grads = fgt.train_backward(xsave, out, stacks)
        ref_dx, ref_grads = fgt.train_bwd_reference(xsave, out, stacks)
        assert torch.equal(dx, ref_dx) and all(map(torch.equal, grads, ref_grads))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fgt.train_forward(x.to("meta"), stacks, last_only=False)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fgt.train_backward(xsave.to("meta"), out.to("meta"), stacks)


@pytest.mark.parametrize("t,e,h,match", [
    (256, 160, 5, None), (256, 256, 8, None), (256, 768, 12, None), (64, 64, 2, None),
    (256, 192, 4, None), (100, 256, 8, None),   # head dim 48
    (256, 96, 1, None), (512, 256, 8, None), (256, 250, 4, "not a multiple of n_head"),
    (0, 256, 8, "T must be"), (1, 256, 8, None), (200, 768, 12, None), (257, 256, 8, None),
    (256, 256, 16, None), (256, 384, 4, None), (256, 256, 32, None),   # head dim 8
    (256, 144, 9, None), (256, 256, 1, None),   # head dim 256: two slabs of 128
    (300, 200, 25, None), (256, 100, 4, None),  # n_embd 100: stored padded to 104
    (256, 1032, 8, None),                       # head dim 129: two slabs of 80
    (256, 1040, 2, "up to 512"), (256, 600, 1, "up to 512"), (256, 250, 3, "not a multiple"),
])
def test_train_width_checks_before_any_build(t, e, h, match):
    if match is None:
        fgt.check_train_width(t, e, h)
    else:
        with pytest.raises(ValueError, match=match):
            fgt.check_train_width(t, e, h)


def test_layers_per_call_mirror_jax():
    for name, jcfg in JCONFIGS.items():
        cfg = _port_cfg(jcfg)
        assert fgt._bwd_layers_per_call(cfg) == jfgt._bwd_layers_per_call(jcfg), name
    assert math.isclose(fgt._gelu_tanh_grad(torch.tensor(0.0)).item(), 0.5)


def emulate_kernel_attn_bwd(q, k, v, da, scale, m, l, bc=32):
    """The attention backward's order of work (csrc/fused_train.cu
    attn_bwd_q_kernel, attn_bwd_kv_kernel) in plain PyTorch, on [P, T, dh]
    bf16 and the forward's statistics m, l [P, T]: p = 2^(s scale log2 e -
    m) / l recomputed from them in every pass.  Returns (dq, dk, dv) bf16."""
    qf, kf, vf, daf = (x.float() for x in (q, k, v, da))
    c2 = float(np.float32(scale) * LOG2E)
    inv = 1.0 / l
    t = q.shape[1]
    chunks = [(c0, min(c0 + bc, t)) for c0 in range(0, t, bc)]

    def probs(rows_q, c0, c1):   # p of all queries against keys c0..c1
        return torch.exp2(rows_q @ kf[:, c0:c1].transpose(1, 2) * c2 - m[..., None]) \
            * inv[..., None]

    # query side, pass A: delta; pass B: ds and dq
    delta = torch.zeros_like(m)
    for c0, c1 in chunks:
        delta += ((daf @ vf[:, c0:c1].transpose(1, 2)) * probs(qf, c0, c1)).sum(-1)
    dq = torch.zeros_like(qf)
    for c0, c1 in chunks:
        dp = daf @ vf[:, c0:c1].transpose(1, 2)
        ds = (((dp - delta[..., None]) * probs(qf, c0, c1)) * scale).to(torch.bfloat16)
        dq += ds.float() @ kf[:, c0:c1]
    # key side: S^T = K Q^T over query chunks, p and ds from m, l and delta
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for c0, c1 in chunks:
        pt = torch.exp2(kf @ qf[:, c0:c1].transpose(1, 2) * c2 - m[:, None, c0:c1]) \
            * inv[:, None, c0:c1]
        dpt = vf @ daf[:, c0:c1].transpose(1, 2)
        dst = (((dpt - delta[:, None, c0:c1]) * pt) * scale).to(torch.bfloat16)
        dv += pt.to(torch.bfloat16).float() @ daf[:, c0:c1]
        dk += dst.float() @ qf[:, c0:c1]
    return dq.to(torch.bfloat16), dk.to(torch.bfloat16), dv.to(torch.bfloat16)


@pytest.mark.parametrize("t", [256, 200])
@pytest.mark.parametrize("model,e,h", [("2M", 160, 5), ("6M", 256, 8), ("85M", 768, 12)])
def test_attention_backward_order_of_work_matches_plain_version(model, e, h, t):
    rng = np.random.RandomState(e + t)
    n = 2
    qkv = torch.from_numpy(rng.randn(n, t, 3 * e).astype(np.float32)).to(torch.bfloat16)
    datt = torch.from_numpy(rng.randn(n, t, e).astype(np.float32) * 0.01).to(torch.bfloat16)
    dh = e // h
    scale = 1.0 / math.sqrt(dh)
    # the attention part of train_bwd_reference, as written there
    p, q, k, v = fgt._probs(qkv, h)
    da = fgt._heads(datt, h)
    pb = p.to(torch.bfloat16)
    ref_dv = fgt._mm(pb.transpose(-1, -2), da).to(torch.bfloat16)
    dp = fgt._mm(da, v.transpose(-1, -2))
    ds = ((dp - (dp * p).sum(-1, keepdim=True)) * p * scale).to(torch.bfloat16)
    ref_dq = fgt._mm(ds, k).to(torch.bfloat16)
    ref_dk = fgt._mm(ds.transpose(-1, -2), q).to(torch.bfloat16)
    # the kernels' order: the forward recompute's statistics, then both sides
    flat = [x.reshape(n * h, t, dh) for x in (q, k, v, da)]
    att, m, l = emulate_kernel_fwd(*flat[:3], scale)
    ref_att = fgt._mm(pb, v).to(torch.bfloat16).reshape(n * h, t, dh)
    _close(att.float().numpy(), ref_att.float().numpy(), 0.02, 0.02, "att")
    got = emulate_kernel_attn_bwd(*flat, scale, m, l)
    for name, g, r in zip(("dq", "dk", "dv"), got, (ref_dq, ref_dk, ref_dv)):
        _close(g.float().numpy(), r.reshape(n * h, t, dh).float().numpy(), 0.08, 1e-4, name)
