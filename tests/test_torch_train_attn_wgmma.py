"""The training attention on wgmma (``csrc/attn_wgmma.cuh`` through its
TrainIo, ``csrc/attn_wgmma_bwd.cuh``) on the CPU: a plain PyTorch emulation
of the kernels' order of work against the plain versions and the JAX
package, the route, and the wrappers' checks.

- ``emulate_fwd`` repeats the forward with statistics on [P, T, D] bf16:
  keys zero-padded to 256 (TMA's zero fill), queries in 64-row tiles, the
  scores of all 256 key slots in fp32, keys at or past T masked; m =
  max(s) c2 (c2 = scale log2(e)), p = 2^(s c2 - m) with the product and the
  difference rounded once (an fma), l = sum p in the kernel's fp32 order
  (``_row_sums``), bf16(p / l) V in fp32 added 16-key slice by slice
  (``_slice_pv``), rounded.
- ``emulate_bwd`` repeats the backward's two kernels from those
  statistics: lse = m + log2(l); delta = rowsum(dA * att) in fp32 (the
  forward's bf16 att, not JAX's sum over the keys of dp * p); the query
  side over 64-row tiles and chunks of 64 keys (32 at D >= 48: S and dP,
  p = 2^(fma(s, c2, -lse)), ds = bf16(((dp - delta) p) scale), dq += ds
  K); the key side over 64-key tiles and chunks of 32 queries (S^T, dP^T,
  p^T and ds^T as above, dv += bf16(p^T) dA, dk += ds^T Q); queries and
  keys past T masked.
- Held against ``train_attention_reference`` and
  ``train_attention_backward_reference`` (the attention of
  ``train_fwd_reference`` and ``train_bwd_reference``, which
  ``tests/test_torch_train_kernels.py`` holds against JAX) at head dims
  16, 32, 48 and 64 and T = 1, 130, 200 and 256, two contexts; and, as the
  attention of a whole one-layer chunk (the plain versions' LayerNorm,
  products and MLP around it), against JAX ``_fwd_call`` and ``_bwd_call``
  in interpret mode at the same head dims and T.  Tolerances: outputs
  within 0.02 * max|ref| + 0.02, gradients within 0.08 * max|ref| + 1e-4
  (``tests/test_fused_gpt_train.py``'s); the statistics within 1e-4 *
  max|ref| + 1e-4 (m) and 2e-3 * max|ref| (l, two exp2s apart).  How far
  the two deltas lie apart is asserted too (within 0.01 * max|delta|).
- ``attention_route`` (the mirror of ``csrc/fused_train.cu``'s, held to
  the launcher's constants here and to its codes by ``chip_smoke.py``)
  names which (T, head dim) go to the wgmma kernels and which stay on
  ``csrc/attn_tile.cuh``; the wrappers raise on shapes no kernel takes, or
  that need padding, before anything is built.
"""

import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.ops import fused_gpt_train as jfgt
from mapf_gpt_tpu_torch.ops import _build
from mapf_gpt_tpu_torch.ops import fused_gpt_train as fgt

LOG2E = np.float32(1.4426950408889634)
T_MAX, ROWS, NK = 256, 64, 32
BF16 = torch.bfloat16


def _nq(d):
    return 32 if d >= 48 else 64


def _fma(a, b, c):
    """a * b + c rounded once, as fmaf rounds it (fp32 in, fp32 out)."""
    return (a.double() * float(b) + c.double()).float()


def _pad(x):
    p_, t, d = x.shape
    return torch.cat([x, torch.zeros((p_, T_MAX - t, d), dtype=x.dtype)], 1).float()


def _row_sums(x):
    """Each row's sum of x [..., 256] in the forward's fp32 order: a thread
    (c4) adds its keys 8 j + 2 c4 + c into partial sums by j % 4, then ((s0 +
    s0') + (s1 + s1')) + ((s2 + s2') + (s3 + s3')), and the quad's four as
    (t0 + t1) + (t2 + t3) (csrc/attn_wgmma.cuh's row_sums)."""
    xs = x.reshape(*x.shape[:-1], T_MAX // 8, 4, 2)      # [..., j, c4, c]
    parts = []
    for m in range(4):
        acc = xs[..., m, :, :]
        for j in range(m + 4, T_MAX // 8, 4):
            acc = acc + xs[..., j, :, :]
        parts.append(acc)
    t = (((parts[0][..., 0] + parts[0][..., 1]) + (parts[1][..., 0] + parts[1][..., 1]))
         + ((parts[2][..., 0] + parts[2][..., 1]) + (parts[3][..., 0] + parts[3][..., 1])))
    return ((t[..., 0] + t[..., 1]) + (t[..., 2] + t[..., 3]))[..., None]


def _slice_pv(p, v):
    """P V in fp32 over 16-key slices added in order, as the forward's
    wgmma products accumulate."""
    o = p[..., :16] @ v[:, :16]
    for k0 in range(16, T_MAX, 16):
        o = o + p[..., k0:k0 + 16] @ v[:, k0:k0 + 16]
    return o


def emulate_fwd(q, k, v, scale):
    """The forward with statistics on [P, T, D] bf16 -> (att bf16, m, l)."""
    p_, t, d = q.shape
    kp, vp = _pad(k), _pad(v)
    masked = torch.arange(T_MAX) >= t
    c2 = np.float32(scale) * LOG2E
    att = torch.empty((p_, t, d), dtype=BF16)
    m = torch.empty((p_, t))
    l = torch.empty((p_, t))
    for t0 in range(0, t, ROWS):
        s = q[:, t0:t0 + ROWS].float() @ kp.transpose(1, 2)
        s = s.masked_fill(masked, -np.inf)
        mt = s.amax(-1, keepdim=True) * c2
        p = torch.exp2(_fma(s, c2, -mt)).masked_fill(masked, 0.0)
        lt = _row_sums(p)
        att[:, t0:t0 + ROWS] = _slice_pv((p * (1.0 / lt)).to(BF16).float(), vp).to(BF16)
        m[:, t0:t0 + ROWS], l[:, t0:t0 + ROWS] = mt[..., 0], lt[..., 0]
    return att, m, l


def deltas(da, att):
    """The kernels' delta: rowsum(dA * att) in fp32."""
    return (da.float() * att.float()).sum(-1)


def emulate_bwd(q, k, v, da, att, m, l, scale):
    """The backward's two kernels on [P, T, D] bf16 and the forward's att, m,
    l -> (dq, dk, dv) bf16."""
    p_, t, d = q.shape
    qp, kp, vp, dap = (_pad(x) for x in (q, k, v, da))
    c2 = np.float32(scale) * LOG2E
    lse = torch.zeros((p_, T_MAX))
    dl = torch.zeros((p_, T_MAX))
    lse[:, :t] = m + torch.log2(l)
    dl[:, :t] = deltas(da, att)
    # the query side: 64-row tiles, chunks of NQ keys
    dq = torch.zeros((p_, T_MAX, d))
    nq = _nq(d)
    for t0 in range(0, t, ROWS):
        rows = slice(t0, t0 + ROWS)
        for c0 in range(0, t, nq):
            keys = slice(c0, c0 + nq)
            s = qp[:, rows] @ kp[:, keys].transpose(1, 2)
            dp = dap[:, rows] @ vp[:, keys].transpose(1, 2)
            p = torch.exp2(_fma(s, c2, -lse[:, rows, None]))
            p = p.masked_fill(torch.arange(c0, c0 + nq) >= t, 0.0)
            ds = (((dp - dl[:, rows, None]) * p) * np.float32(scale)).to(BF16).float()
            dq[:, rows] += ds @ kp[:, keys]
    # the key side: 64-key tiles, chunks of NK queries
    dk = torch.zeros((p_, T_MAX, d))
    dv = torch.zeros((p_, T_MAX, d))
    for t0 in range(0, t, ROWS):
        keys = slice(t0, t0 + ROWS)
        for c0 in range(0, t, NK):
            qs = slice(c0, c0 + NK)
            st = kp[:, keys] @ qp[:, qs].transpose(1, 2)
            dpt = vp[:, keys] @ dap[:, qs].transpose(1, 2)
            pt = torch.exp2(_fma(st, c2, -lse[:, None, qs]))
            dst = ((dpt - dl[:, None, qs]) * pt) * np.float32(scale)
            past = torch.arange(c0, c0 + NK) >= t
            pt, dst = pt.masked_fill(past, 0.0), dst.masked_fill(past, 0.0)
            dv[:, keys] += pt.to(BF16).float() @ dap[:, qs]
            dk[:, keys] += dst.to(BF16).float() @ qp[:, qs]
    return tuple(x[:, :t].to(BF16) for x in (dq, dk, dv))


def _split(qkv, h):
    """[N, T, 3E] -> q, k, v [N H, T, dh]."""
    n, t, e3 = qkv.shape
    d = e3 // 3 // h
    return [z.reshape(n, t, h, d).transpose(1, 2).reshape(n * h, t, d)
            for z in qkv.split(e3 // 3, dim=-1)]


def _merge(z, n, h):
    """[N H, T, dh] -> [N, T, H dh]."""
    _, t, d = z.shape
    return z.reshape(n, h, t, d).transpose(1, 2).reshape(n, t, h * d)


def emulated_attention(qkv, datt, h):
    """The kernels' attention on q|k|v [N, T, 3E] and datt [N, T, E]: (att,
    m, l [N, H, T], dqkv [N, T, 3E], the kernels' delta, JAX's delta)."""
    n, t, e3 = qkv.shape
    d = e3 // 3 // h
    scale = 1.0 / math.sqrt(d)
    q, k, v = _split(qkv, h)
    da = datt.reshape(n, t, h, d).transpose(1, 2).reshape(n * h, t, d)
    att, m, l = emulate_fwd(q, k, v, scale)
    grads = emulate_bwd(q, k, v, da, att, m, l, scale)
    dqkv = torch.cat([_merge(g, n, h) for g in grads], -1)
    p, *_ = fgt._probs(qkv, h)
    dp = fgt._mm(da.reshape(n, h, t, d), v.reshape(n, h, t, d).transpose(-1, -2))
    jax_delta = (dp * p).sum(-1).reshape(n * h, t)
    return (_merge(att, n, h), m.reshape(n, h, t), l.reshape(n, h, t), dqkv,
            deltas(da, att), jax_delta)


def _close(got, ref, rel, floor, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    tol = rel * np.abs(ref).max() + floor
    assert err <= tol, (what, err, tol)
    return err / tol


HEADS = [(16, 4), (32, 3), (48, 2), (64, 2)]   # (head dim, heads)
TS = [1, 130, 200, 256]


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("d,h", HEADS)
def test_order_of_work_matches_plain_versions(d, h, t):
    rng = np.random.RandomState(d + t)
    n = 2
    qkv = torch.from_numpy(rng.randn(n, t, 3 * h * d).astype(np.float32)).to(BF16)
    datt = torch.from_numpy(rng.randn(n, t, h * d).astype(np.float32)).to(BF16)
    att, m, l, dqkv, delta, jax_delta = emulated_attention(qkv, datt, h)
    ref_att, ref_m, ref_l = fgt.train_attention_reference(qkv, h)
    _close(att.float(), ref_att.float(), 0.02, 0.02, "att")
    _close(m, ref_m, 1e-4, 1e-4, "m")
    _close(l, ref_l, 2e-3, 0.0, "l")
    ref = fgt.train_attention_backward_reference(qkv, datt, h)
    e = h * d
    for i, name in enumerate(("dq", "dk", "dv")):
        sl = slice(i * e, (i + 1) * e)
        _close(dqkv[..., sl].float(), ref[..., sl].float(), 0.08, 1e-4, name)
    # the kernels' delta (from the rounded att) against the sum JAX takes
    _close(delta, jax_delta, 0.01, 0.0, "delta")
    # on the CPU the wrappers are the plain versions themselves
    got = fgt.train_attention(qkv, h)
    assert all(torch.equal(a, b) for a, b in zip(got, (ref_att, ref_m, ref_l)))
    assert torch.equal(fgt.train_attention_backward(qkv, datt, *got, h), ref)


def _chunk(e, h, t, seed):
    """A one-layer chunk's numpy weights, residual stream and top gradient."""
    rng = np.random.RandomState(seed)
    w = [rng.randn(1, e, 3 * e) * 0.15, rng.randn(1, e, e) * 0.05,
         rng.randn(1, e, 4 * e) * 0.05, rng.randn(1, 4 * e, e) * 0.05]
    g = [1.0 + 0.1 * rng.randn(1, e), 1.0 + 0.1 * rng.randn(1, e)]
    x = rng.randn(2, t, e) * 0.5
    dxin = rng.randn(2, t, e) * 0.1
    return ([a.astype(np.float32) for a in w], [a.astype(np.float32) for a in g],
            x.astype(np.float32), dxin.astype(np.float32))


def _emulated_layer(x, dxin, st, h):
    """A one-layer chunk's forward and backward as the kernels run them:
    the plain versions' LayerNorm, products and MLP around the emulated
    attention.  Returns (out, dx, (dwqkv, dwproj, dwfc, dwfc2, dg1, dg2))."""
    rows = lambda z: z.reshape(-1, z.shape[-1])
    xn1f, xhat1, rstd1 = fgt._ln(x.float(), st.g1[0])
    xn1 = xn1f.to(BF16)
    qkv = fgt._mm(xn1, st.wqkv[0]).to(BF16)
    dxb_top = dxin.float()
    # forward
    att = emulated_attention(qkv, torch.zeros(x.shape, dtype=BF16), h)[0]
    xm = (x.float() + fgt._mm(att, st.wproj[0]).to(BF16).float()).to(BF16)
    xn2f, xhat2, rstd2 = fgt._ln(xm.float(), st.g2[0])
    xn2 = xn2f.to(BF16)
    hmid = fgt._mm(xn2, st.wfc[0])
    hact = fgt._gelu_tanh(hmid).to(BF16)
    out = (xm.float() + fgt._mm(hact, st.wfc2[0]).to(BF16).float()).to(BF16)
    # backward: the MLP, then the attention from the recomputed q|k|v
    dxb = dxb_top.to(BF16)
    dwfc2 = fgt._mm(rows(hact).T, rows(dxb))
    dhb = (fgt._mm(dxb, st.wfc2[0].T) * fgt._gelu_tanh_grad(hmid)).to(BF16)
    dwfc = fgt._mm(rows(xn2).T, rows(dhb))
    dx_ln2, dg2_rows = fgt._ln_bwd(fgt._mm(dhb, st.wfc[0].T), xhat2, rstd2, st.g2[0])
    dx = dxb_top + dx_ln2
    dxb = dx.to(BF16)
    dwproj = fgt._mm(rows(att).T, rows(dxb))
    datt = fgt._mm(dxb, st.wproj[0].T).to(BF16)
    dqkv = emulated_attention(qkv, datt, h)[3]
    dwqkv = fgt._mm(rows(xn1).T, rows(dqkv))
    dx_ln1, dg1_rows = fgt._ln_bwd(fgt._mm(dqkv, st.wqkv[0].T), xhat1, rstd1, st.g1[0])
    dx = dx + dx_ln1
    return out, dx.to(BF16), (dwqkv, dwproj, dwfc, dwfc2, rows(dg1_rows).sum(0),
                              rows(dg2_rows).sum(0))


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("d,h", HEADS)
def test_emulated_chunk_matches_jax_fwd_and_bwd_calls(d, h, t):
    e = h * d
    w, g, x, dxin = _chunk(e, h, t, seed=7 * d + t)
    cfg = JGPTConfig(n_layer=1, n_head=h, n_embd=e, block_size=t)
    jstacks = tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in w) + tuple(
        jnp.asarray(a) for a in g)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jout, jxsave = jfgt._fwd_call(jstacks, jx, cfg, 2, True, last_only=False)
    jgrads = jfgt._bwd_call(jstacks, jxsave, jnp.asarray(dxin).astype(jnp.bfloat16), cfg, 2,
                            True)
    f32 = lambda a: np.array(jnp.asarray(a).astype(jnp.float32))
    st = fgt.TrainStacks(*(torch.from_numpy(f32(a)).to(BF16) for a in w),
                         *(torch.from_numpy(a) for a in g), n_head=h)
    xt = torch.from_numpy(f32(jx)).to(BF16)
    out, dx, grads = _emulated_layer(xt, torch.from_numpy(dxin).to(BF16), st, h)
    _close(out.float(), f32(jout), 0.02, 0.02, "out")
    for name, got, want in zip(("dx", "dwqkv", "dwproj", "dwfc", "dwfc2", "dg1", "dg2"),
                               (dx, *grads), jgrads):
        _close(got.float(), f32(want)[0] if name != "dx" else f32(want), 0.08, 1e-4, name)


ROUTE_CASES = [   # (T, n_embd, heads, route)
    (256, 160, 5, "wgmma"), (256, 256, 8, "wgmma"), (256, 768, 12, "wgmma"),   # 2M, 6M, 85M
    (1, 256, 16, "wgmma"), (130, 192, 4, "wgmma"), (200, 64, 4, "wgmma"),      # 16, 48, 16
    (256, 200, 25, "wgmma"), (256, 96, 4, "wgmma"),   # head dims 8 and 24: padded to 16, 32
    (257, 256, 8, "tile"), (300, 768, 12, "tile"),     # T past 256
    (256, 384, 4, "tile"), (256, 256, 2, "tile"),      # head dims 96 and 128
    (256, 320, 4, "tile"),                             # head dim 80
    (256, 1032, 4, "wide"), (300, 256, 1, "wide"),     # past 128 columns: slabs
]


@pytest.mark.parametrize("t,e,h,want", ROUTE_CASES)
def test_route_names_the_kernels_of_each_shape(t, e, h, want, monkeypatch):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    assert fgt.check_train_width(t, e, h) == want == fgt.attention_route(t, e, h)


def test_route_mirror_reads_the_launchers_constants():
    """attention_route's constants are the C launcher's: T_MAX and takes()
    of csrc/attn_wgmma.cuh, the 128-column slab of csrc/fused_train.cu's
    heads_of, and attention_route there built from them."""
    csrc = pathlib.Path(fgt.__file__).resolve().parent.parent / "csrc"
    wg = (csrc / "attn_wgmma.cuh").read_text()
    tr = (csrc / "fused_train.cu").read_text()
    assert int(re.search(r"constexpr int T_MAX = (\d+);", wg)[1]) == fgt._T_WGMMA
    takes = re.search(r"constexpr bool takes\(int d\) \{\s*return ([^;]*);", wg)[1]
    assert tuple(int(w) for w in re.findall(r"d == (\d+)", takes)) == fgt._WGMMA_WIDTHS
    assert int(re.search(r"const int ns = \(dh \+ (\d+)\) / (\d+);", tr)[2]) == fgt._D_TILE
    route = re.search(r"Route attention_route\(int T, Heads hd\) \{(.*?)\n\}", tr, re.S)[1]
    assert "if (hd.NS > 1) return ROUTE_WIDE;" in route
    assert "T <= aw::T_MAX && aw::takes(hd.DP) ? ROUTE_WGMMA : ROUTE_TILE" in route
    codes = re.search(r"enum Route \{([^}]*)\}", tr)[1]
    assert tuple(c.split("=")[0].strip()[len("ROUTE_"):].lower()
                 for c in codes.split(",")) == fgt.ROUTES


@pytest.mark.parametrize("t,e,h,match", [
    (0, 256, 8, "T must be"), (256, 250, 3, "not a multiple"), (256, 1040, 2, "up to 512")])
def test_wrappers_raise_before_building_on_shapes_no_kernel_takes(t, e, h, match, monkeypatch):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    x = torch.zeros((2, t, e), dtype=BF16, device="meta")
    stacks = fgt.TrainStacks(*(torch.zeros(s, device="meta") for s in (
        (1, e, 3 * e), (1, e, e), (1, e, 4 * e), (1, 4 * e, e), (1, e), (1, e))), n_head=h)
    with pytest.raises(ValueError, match=match):
        fgt.train_forward(x, stacks, last_only=False)
    with pytest.raises(ValueError, match=match):
        fgt.train_backward(torch.zeros((2, 2, t, e), dtype=BF16, device="meta"), x, stacks)
    with pytest.raises(ValueError, match=match):
        fgt.train_attention(torch.zeros((2, t, 3 * e), dtype=BF16, device="meta"), h)


def test_attention_wrappers_raise_for_padded_heads_before_building(monkeypatch):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    qkv = torch.zeros((2, 8, 3 * 96), dtype=BF16, device="meta")
    with pytest.raises(ValueError, match="need padding"):
        fgt.train_attention(qkv, 4)                  # head dim 24 -> 32 columns
    z = torch.zeros((2, 8, 96), dtype=BF16, device="meta")
    with pytest.raises(ValueError, match="need padding"):
        fgt.train_attention_backward(qkv, z, z, None, None, 4)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fgt.train_attention(torch.zeros((2, 8, 3 * 128), dtype=BF16, device="meta"), 4)
