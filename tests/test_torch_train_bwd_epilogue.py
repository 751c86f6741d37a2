"""The training backward's two epilogue kernels (``csrc/train_bwd_gemm.cuh``:
``mlp_front_kernel`` and ``ln_dx_kernel``) on the CPU: a plain PyTorch
emulation of each kernel's order of work against the plain versions and the
JAX package, the LayerNorm route, and the wrappers' checks.

- ``emulate_mlp_front`` repeats the MLP front: [128 x 128] output tiles,
  each with two fp32 accumulators over K in 64-deep tiles in order (hmid =
  xn2 Wfc, dhact = dxb Wfc2^T), then hact = bf16(gelu(hmid)) and dh =
  bf16(dhact gelu'(hmid)) from the registers.
- ``emulate_ln_dx`` repeats the LN epilogue: each CTA (each cluster)
  walks its 128-row tiles of dY = A W^T as the persistent loop takes them
  (``ln_walks``), the row's 256-column tiles one a cluster rank; x and dx
  come as the producer stages them after the tile's k-tiles, a ring stage
  a 64-column chunk (the four chunks' stages distinct, so pass 1 holds them
  all), in TMA boxes of 64 rows, zero past the tensor and NaN where a box
  holds no row or column and is not loaded; a row's sums of d = dY g and d
  xhat over the first EL columns taken by each thread of the quad that
  holds the row (columns 8 j + 2 c and + 1, j ascending), x zero on rows
  past M, the quad's four sums added as its two xor-shuffles add them, the
  ranks' sums added in rank order; dx += (d - m1 - xhat m2) rstd, dxb =
  bf16(dx), columns past EL kept, only rows below M and columns below E
  stored; each 128-row tile's gain partial the 8 warps' column sums in
  order (each a warp's 16 rows: two rows a thread, then the xor-shuffles'
  tree over the eight quads), the partials added in row-tile order.
- Each is held against its plain version (``mlp_front_reference``,
  ``ln_backward_dx_reference``), and a whole one-layer backward chunk with
  both emulated (the plain attention around them, the stored width padded
  to a multiple of 8 where n_embd is not) against ``train_bwd_reference``
  and JAX ``_bwd_call`` in interpret mode, at n_embd 64 (4 heads, a CTA a
  row), 250 (5 heads, stored padded to 256, LayerNorm over 250) and 768
  (12 heads, a cluster of three) at T <= 16 and 2 contexts for the last.
  Tolerances: hact and dh within 0.01 * max|ref| + 1e-3 (bf16 products of
  the same fp32 sums in another order); dx and the gradients within 0.08 *
  max|ref| + 1e-4 (``tests/test_fused_gpt_train.py``'s).
- ``ln_route`` (the mirror of the header's ``ln_ranks``, held to its
  constants here and to the library's answers by ``chip_smoke.py``) names
  which widths take the epilogue, a cluster or the separate kernels; the
  launch counts a chunk makes; the wrappers raise on shapes the kernels do
  not take before anything is built.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.ops import fused_gpt_train as jfgt
from mapf_gpt_tpu_torch.ops import _build
from mapf_gpt_tpu_torch.ops import fused_gpt_train as fgt
from mapf_gpt_tpu_torch.ops.fused_blocks import stored_width

BF16 = torch.bfloat16
BM, BN_FRONT, BK, BN_LN = 128, 128, 64, 256
SMS = 132                      # the LN launcher's grid: min(row tiles, SMs) CTAs
LN_STAGES, LN_CHUNK = 4, 64    # csrc/train_bwd_gemm.cuh's LnCfg::STAGES and LN_CHUNK
LN_CHUNKS = BN_LN // LN_CHUNK  # a tile's epilogue chunks, a ring stage each
HALF_ROWS = 64                 # a TMA box's rows: a consumer warpgroup's half


def _tiled(a, b):
    """a [M, K] @ b [K, N] in fp32, K in 64-deep tiles added in order."""
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], BK):
        acc += a[:, k0:k0 + BK].float() @ b[k0:k0 + BK].float()
    return acc


def emulate_mlp_front(xn2, wfc, dxb, wfc2):
    """The MLP front on bf16 xn2, dxb [M, E], wfc [E, F], wfc2 [F, E] ->
    (hact, dh) bf16 [M, F]."""
    m, f = xn2.shape[0], wfc.shape[1]
    hact = torch.empty((m, f), dtype=BF16)
    dh = torch.empty((m, f), dtype=BF16)
    for m0 in range(0, m, BM):
        r = slice(m0, m0 + BM)
        for n0 in range(0, f, BN_FRONT):
            c = slice(n0, n0 + BN_FRONT)
            h = _tiled(xn2[r], wfc[:, c])
            d = _tiled(dxb[r], wfc2[c].T)
            hact[r, c] = fgt._gelu_tanh(h).to(BF16)
            dh[r, c] = (d * fgt._gelu_tanh_grad(h)).to(BF16)
    return hact, dh


def _pairs_tree(v):
    """v [8, ...] summed as the xor-shuffles over lane bits 2-4 sum it at
    lane g = 0: ((v0 + v1) + (v2 + v3)) + ((v4 + v5) + (v6 + v7))."""
    while v.shape[0] > 1:
        v = v[0::2] + v[1::2]
    return v[0]


def _quad_sums(z, el, col0):
    """Each quad thread's sum of z's columns (its 64 of a 256-column tile
    starting at col0, those below el), then the quad's two shuffles."""
    sums = []
    for c in range(4):
        s = torch.zeros(z.shape[0])
        for j in range(BN_LN // 8):
            for e in range(2):
                col = 8 * j + 2 * c + e
                if col0 + col < el:
                    s = s + z[:, col]
        sums.append(s)
    return (sums[0] + sums[1]) + (sums[2] + sums[3])


def ln_walks(m, ctas=None):
    """The row tiles each CTA (each cluster) walks, first, first + step, ..., as
    the persistent kernel's loop takes them; the launcher starts min(row
    tiles, SMS) of them."""
    mt = -(-m // BM)
    ctas = min(mt, SMS) if ctas is None else ctas
    return [list(range(first, mt, ctas)) for first in range(ctas)]


def _stage(src, r0, c0, halves, e, box_cols, width):
    """A tile's region of the epilogue's stages, [128, width] fp32, as the
    producer loads it: TMA boxes of 64 rows x box_cols columns, zero past the
    tensor's edges; a box that holds no row (a second half past M) or no
    column (past E) is not loaded, and reads NaN here."""
    out = torch.full((BM, width), float("nan"))
    m = src.shape[0]
    for h in range(halves):
        for c in range(0, width, box_cols):
            if c0 + c >= e:
                continue
            box = torch.zeros((HALF_ROWS, box_cols))
            r = r0 + HALF_ROWS * h
            rows = src[r:min(m, r + HALF_ROWS), c0 + c:c0 + c + box_cols]
            box[:rows.shape[0], :rows.shape[1]] = rows.float()
            out[HALF_ROWS * h:HALF_ROWS * (h + 1), c:c + box_cols] = box
    return out


def emulate_ln_dx(a, w, x, g, dx, mu, rstd, el, ctas=None):
    """The LN epilogue on bf16 a [M, K], w [E, K], x [M, E], fp32 g [E], dx
    [M, E], mu, rstd [M] -> (dx fp32, dxb bf16, dg [E]), each CTA walking its
    row tiles (:func:`ln_walks`; `ctas` overrides the launcher's count) with
    the ring positions the producer, the consumers and the storer each
    compute, and x and dx read from the stages as TMA leaves them (NaN where
    a box is not loaded: nothing stored may depend on it)."""
    m, e = x.shape
    k = a.shape[1]
    ranks = -(-e // BN_LN)
    width = ranks * BN_LN
    wp = F.pad(w.float(), (0, 0, 0, width - e))
    gp = F.pad(g, (0, width - e))   # the staged g: 0 past E
    ktiles = -(-k // BK)
    out = dx.clone()
    dxb = torch.empty((m, e), dtype=BF16)
    partial = torch.full((-(-m // BM), e), float("nan"))
    for walk in ln_walks(m, ctas):
        seq = 0   # the ring's positions so far: a tile's k-tiles, then its chunks
        for it, t in enumerate(walk):
            seq += ktiles
            stages = [(seq + q) % LN_STAGES for q in range(LN_CHUNKS)]
            assert len(set(stages)) == LN_CHUNKS   # pass 1 holds every chunk at once
            seq += LN_CHUNKS
            m0 = t * BM
            rows = min(BM, m - m0)
            halves = 2 if m0 + HALF_ROWS < m else 1
            live = torch.arange(BM) < rows   # the consumers' row guard in pass 1
            mu_t = torch.where(live, F.pad(mu[m0:m0 + rows], (0, BM - rows)), torch.zeros(()))
            rs_t = torch.where(live, F.pad(rstd[m0:m0 + rows], (0, BM - rows)), torch.zeros(()))
            dy = _tiled(F.pad(a[m0:m0 + rows], (0, 0, 0, BM - rows)), wp.T)
            xs = _stage(x, m0, 0, halves, e, LN_CHUNK, width)
            dxs = _stage(dx, m0, 0, halves, e, 32, width)
            x1 = torch.where(live[:, None], xs, torch.zeros(()))
            xhat1 = (x1 - mu_t[:, None]) * rs_t[:, None]
            d = dy * gp
            t1 = t2 = torch.zeros(BM)
            for rk in range(ranks):   # pass 1 on each rank; the row sums in rank order
                cols = slice(rk * BN_LN, (rk + 1) * BN_LN)
                s1 = _quad_sums(d[:, cols], el, rk * BN_LN)
                s2 = _quad_sums((d * xhat1)[:, cols], el, rk * BN_LN)
                t1, t2 = (s1, s2) if ranks == 1 else (t1 + s1, t2 + s2)
                # the gain partial: the 8 warps' column sums in order
                per_thread = (dy * xhat1)[:, cols].reshape(8, 2, 8, BN_LN)   # warp, half, g
                per_thread = per_thread[:, 0] + per_thread[:, 1]    # a thread's two rows
                warp_sums = _pairs_tree(per_thread.transpose(0, 1))  # [8 warps, BN_LN]
                part = torch.zeros(BN_LN)
                for wi in range(8):
                    part = part + warp_sums[wi]
                n = min(BN_LN, e - rk * BN_LN)
                partial[t, rk * BN_LN:rk * BN_LN + n] = part[:n]
            m1, m2 = t1 / el, t2 / el
            # pass 2 over the staged x and dx, rows unguarded (not stored past M)
            xhat2 = (xs - mu_t[:, None]) * rs_t[:, None]
            upd = (d - m1[:, None] - xhat2 * m2[:, None]) * rs_t[:, None]
            v = dxs + torch.where(torch.arange(width) < el, upd, torch.zeros(()))
            out[m0:m0 + rows] = v[:rows, :e]
            dxb[m0:m0 + rows] = v[:rows, :e].to(BF16)
    dg = torch.zeros(e)
    for row in partial:   # the caller adds the partials in row-tile order
        dg = dg + row
    return out, dxb, dg


def _close(got, ref, rel, floor, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    tol = rel * np.abs(ref).max() + floor
    assert err <= tol, (what, err, tol)


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(BF16)


@pytest.mark.parametrize("m,e,f", [(200, 64, 256), (140, 256, 1000), (32, 768, 3072),
                                   (130, 136, 552)])
def test_mlp_front_order_of_work_matches_plain_version(m, e, f):
    rng = np.random.RandomState(m + e)
    xn2, dxb = _bf16(rng, m, e), _bf16(rng, m, e, scale=0.1)
    wfc, wfc2 = _bf16(rng, e, f, scale=0.05), _bf16(rng, f, e, scale=0.05)
    hact, dh = emulate_mlp_front(xn2, wfc, dxb, wfc2)
    ref_h, ref_d = fgt.mlp_front_reference(xn2, wfc, dxb, wfc2)
    _close(hact.float(), ref_h.float(), 0.01, 1e-3, "hact")
    _close(dh.float(), ref_d.float(), 0.01, 1e-3, "dh")
    # on the CPU the wrapper is the plain version
    got = fgt.mlp_front(xn2, wfc, dxb, wfc2)
    assert all(torch.equal(a, b) for a, b in zip(got, (ref_h, ref_d)))
    # hact is the forward's GELU epilogue on a product in gemm_kernel's K order
    assert torch.equal(hact, fgt._gelu_tanh(_tiled(xn2, wfc)).to(BF16))


# (rows, stored n_embd, the true n_embd, K, CTAs or None for the launcher's):
# a CTA a row at 64 and 256 (250 normalised), clusters of 2, 3 and 5 ranks
# (264, 768, 1032); then the persistent walk's edges: a CTA that walks three
# row tiles (an odd count: the column sums' buffers and the storer's barrier
# phases alternate), a last row tile of 18 rows (its second 64-row half not
# loaded) beside a rank whose last chunks lie past E, and one cluster of
# five walking both tiles of 150 rows
LN_CASES = [(200, 64, 64, 256, None), (140, 256, 250, 1000, None), (140, 256, 250, 768, None),
            (32, 768, 768, 2304, None), (150, 264, 264, 1056, None), (40, 1032, 1032, 1032, None),
            (600, 256, 250, 768, 2), (530, 264, 264, 1056, 2), (150, 1032, 1032, 1032, 1)]


@pytest.mark.parametrize("m,e,el,k,ctas", LN_CASES)
def test_ln_dx_order_of_work_matches_plain_version(m, e, el, k, ctas):
    rng = np.random.RandomState(m + e + k)
    a, w = _bf16(rng, m, k, scale=0.1), _bf16(rng, e, k, scale=0.05)
    w[el:] = 0          # the padded layout's zero rows: dY is zero past EL
    x = _bf16(rng, m, e, scale=0.5)
    x[:, el:] = 0
    g = torch.from_numpy((1.0 + 0.1 * rng.randn(e)).astype(np.float32))
    g[el:] = 0
    dx = torch.from_numpy((rng.randn(m, e) * 0.1).astype(np.float32))
    dx[:, el:] = 0
    mu = x[:, :el].float().mean(-1)
    rstd = torch.rsqrt(((x[:, :el].float() - mu[:, None]) ** 2).mean(-1) + 1e-5)
    got = emulate_ln_dx(a, w, x, g, dx, mu, rstd, el, ctas)
    ref = fgt.ln_backward_dx_reference(a, w, x, g, dx, mu, rstd, el)
    for name, u, v in zip(("dx", "dxb", "dg"), got, ref):
        _close(u.float(), v.float(), 0.08, 1e-4, name)
    # columns past EL keep dx (zero) and get dxb = 0
    assert not got[0][:, el:].any() and not got[1][:, el:].float().any()
    dx_inplace = dx.clone()   # the wrapper updates dx as the backward does
    got = fgt.ln_backward_dx(a, w, x, g, dx_inplace, mu, rstd, el)
    assert got[0] is dx_inplace and all(torch.equal(u, v) for u, v in zip(got, ref))


def emulated_bwd_chunk(xsave, dxin, st):
    """``train_bwd_reference`` with the MLP front and both LayerNorm
    backwards as the kernels run them, on the stored width (n_embd padded
    to a multiple of 8 with zero columns, LayerNorm over the true n_embd);
    the attention as the plain version runs it."""
    n, t, e = dxin.shape
    es, h = stored_width(e), st.n_head
    pe = es - e
    padc = lambda z: F.pad(z, (0, pe))
    rows = lambda z: z.reshape(n * t, -1)
    grads = [torch.zeros(s.shape) for s in st[:6]]
    dwqkv, dwproj, dwfc, dwfc2, dg1, dg2 = grads
    dx = padc(rows(dxin.float()))
    dxb = dx.to(BF16)
    for l in range(st.wqkv.shape[0] - 1, -1, -1):
        x_in, x_mid = rows(xsave[2 * l]), rows(xsave[2 * l + 1])
        wfc, wfc2 = F.pad(st.wfc[l], (0, 0, 0, pe)), F.pad(st.wfc2[l], (0, pe))
        xn2f, _, rstd2 = fgt._ln(x_mid.float(), st.g2[l])
        xn2 = padc(xn2f.to(BF16))
        hact, dh = emulate_mlp_front(xn2, wfc, dxb, wfc2)
        dwfc2[l] = fgt._mm(hact.T, dxb)[:, :e]
        dwfc[l] = fgt._mm(xn2.T, dh)[:e]
        dx, dxb, dg = emulate_ln_dx(dh, wfc, padc(x_mid), padc(st.g2[l]), dx,
                                    x_mid.float().mean(-1), rstd2[:, 0], e)
        dg2[l] = dg[:e]
        xn1f, _, rstd1 = fgt._ln(x_in.float(), st.g1[l])
        xn1 = xn1f.to(BF16)
        qkv = fgt._mm(xn1, st.wqkv[l]).to(BF16).reshape(n, t, 3 * e)
        att = fgt.train_attention_reference(qkv, h)[0]
        dwproj[l] = fgt._mm(rows(att).T, dxb[:, :e])
        datt = fgt._mm(dxb[:, :e], st.wproj[l].T).to(BF16).reshape(n, t, e)
        dqkv = rows(fgt.train_attention_backward_reference(qkv, datt, h))
        dwqkv[l] = fgt._mm(xn1.T, dqkv)
        dx, dxb, dg = emulate_ln_dx(dqkv, F.pad(st.wqkv[l], (0, 0, 0, pe)), padc(x_in),
                                    padc(st.g1[l]), dx, x_in.float().mean(-1), rstd1[:, 0], e)
        dg1[l] = dg[:e]
    return dxb[:, :e].reshape(n, t, e), tuple(grads)


def _chunk(e, t, seed):
    """A one-layer chunk's numpy weights, residual stream and top gradient."""
    rng = np.random.RandomState(seed)
    w = [rng.randn(1, e, 3 * e) * 0.15, rng.randn(1, e, e) * 0.05,
         rng.randn(1, e, 4 * e) * 0.05, rng.randn(1, 4 * e, e) * 0.05]
    g = [1.0 + 0.1 * rng.randn(1, e), 1.0 + 0.1 * rng.randn(1, e)]
    x = rng.randn(2, t, e) * 0.5
    dxin = rng.randn(2, t, e) * 0.1
    return ([a.astype(np.float32) for a in w], [a.astype(np.float32) for a in g],
            x.astype(np.float32), dxin.astype(np.float32))


# (n_embd, heads, T): a CTA a row; stored padded to 256; a cluster of three
CHUNKS = [(64, 4, 100), (250, 5, 70), (768, 12, 16)]


@pytest.mark.parametrize("e,h,t", CHUNKS)
def test_emulated_chunk_matches_plain_version_and_jax_bwd_call(e, h, t):
    w, g, x, dxin = _chunk(e, t, seed=e + t)
    cfg = JGPTConfig(n_layer=1, n_head=h, n_embd=e, block_size=t)
    jstacks = tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in w) + tuple(
        jnp.asarray(a) for a in g)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jdxin = jnp.asarray(dxin).astype(jnp.bfloat16)
    _, jxsave = jfgt._fwd_call(jstacks, jx, cfg, 2, True, last_only=False)
    jgrads = jfgt._bwd_call(jstacks, jxsave, jdxin, cfg, 2, True)
    f32 = lambda a: np.array(jnp.asarray(a).astype(jnp.float32))
    st = fgt.TrainStacks(*(torch.from_numpy(f32(a)).to(BF16) for a in jstacks[:4]),
                         *(torch.from_numpy(a) for a in g), n_head=h)
    xsave = torch.from_numpy(f32(jxsave)).to(BF16)
    dxt = torch.from_numpy(f32(jdxin)).to(BF16)
    dx, grads = emulated_bwd_chunk(xsave, dxt, st)
    ref_dx, ref_grads = fgt.train_bwd_reference(xsave, dxt, st)
    names = ("dx", "dwqkv", "dwproj", "dwfc", "dwfc2", "dg1", "dg2")
    for name, got, plain, want in zip(names, (dx, *grads), (ref_dx, *ref_grads), jgrads):
        _close(got.float(), plain.float(), 0.08, 1e-4, f"{name} vs plain")
        _close(got.float(), f32(want), 0.08, 1e-4, f"{name} vs JAX")


LN_ROUTE_CASES = [   # (n_embd, route, cluster ranks)
    (64, "epilogue", 1), (160, "epilogue", 1), (250, "epilogue", 1), (256, "epilogue", 1),
    (258, "cluster", 2), (384, "cluster", 2), (768, "cluster", 3), (1032, "cluster", 5),
    (2048, "cluster", 8), (2049, "kernels", 0), (2304, "kernels", 0)]


@pytest.mark.parametrize("e,route,ranks", LN_ROUTE_CASES)
def test_ln_route_names_each_width(e, route, ranks, monkeypatch):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    assert fgt.ln_route(e) == route and fgt.ln_cluster_ranks(e) == ranks
    ln = 0 if route == "kernels" else 2   # LN epilogues a layer and group
    assert tuple(fgt.bwd_gemm_launch_count(3, 200, e).values()) == (3, 3 * ln)   # one group
    assert tuple(fgt.bwd_gemm_launch_count(1, 257, e).values()) == (2, 2 * ln)   # two


def test_ln_route_mirror_reads_the_headers_constants():
    """ln_route's constants are csrc/train_bwd_gemm.cuh's, ln_ranks there
    is built from them, and csrc/fused_train.cu picks the epilogue by it."""
    csrc = pathlib.Path(fgt.__file__).resolve().parent.parent / "csrc"
    hdr = (csrc / "train_bwd_gemm.cuh").read_text()
    tr = (csrc / "fused_train.cu").read_text()
    assert int(re.search(r"constexpr int LN_BN = (\d+);", hdr)[1]) == fgt._LN_BN
    assert int(re.search(r"constexpr int LN_MAX_RANKS = (\d+);", hdr)[1]) == fgt._LN_MAX_RANKS
    body = re.search(r"inline int ln_ranks\(int E\) \{(.*?)\n\}", hdr, re.S)[1]
    assert "cdiv(E, LN_BN)" in body and "r <= LN_MAX_RANKS ? r : 0" in body
    assert "if (tbg::ln_ranks(E) > 0) {" in tr
    assert "EpiGeluGrad" not in tr and "EpiF32Gelu" not in tr and "hmid =" not in tr.split(
        "int backward_impl")[1]
    assert tuple(re.findall(r"(\w+_kernel)\(", hdr)[:2]) == fgt.BWD_GEMM_KERNELS


def test_ln_ring_mirror_reads_the_headers_constants():
    """emulate_ln_dx's ring and boxes are csrc/train_bwd_gemm.cuh's: LnCfg's
    stages and chunk width, the 64-row boxes of x and dx, and a shared
    memory budget that fits a block."""
    hdr = (pathlib.Path(fgt.__file__).resolve().parent.parent / "csrc" /
           "train_bwd_gemm.cuh").read_text()
    cfg = re.search(r"struct LnCfg \{(.*?)\n\};", hdr, re.S)[1]
    assert int(re.search(r"constexpr int LN_CHUNK = (\d+);", hdr)[1]) == LN_CHUNK
    assert int(re.search(r"static constexpr int STAGES = (\d+);", cfg)[1]) == LN_STAGES
    assert "CHUNKS = LN_BN / LN_CHUNK;" in cfg and "LnCfg::STAGES >= LnCfg::CHUNKS" in hdr
    for name in ("tx, args.x", "tdxb, args.dxb"):
        assert re.search(rf"make_map\(&{name}, M, E, [\w.]+, (\d+)\)", hdr)[1] == str(HALF_ROWS)
    assert re.search(r"make_map_f32\(&tdx, args\.dx, M, E, E, (\d+)\)", hdr)[1] == str(HALF_ROWS)
    stage = BM * BK * 2 + BN_LN * BK * 2
    assert stage == 3 * BM * 128 == BM * LN_CHUNK * (2 + 4)   # a chunk of x and dx fills a stage
    smem = (LN_STAGES * stage + 2 * 8 * BN_LN * 4 + 2 * fgt._LN_MAX_RANKS * BM * 8
            + (2 * LN_STAGES + 2 + LN_CHUNKS) * 8 + BN_LN * 4 + 1024)
    assert smem == 231536 <= 232448


def _meta(*shape, dtype=BF16):
    return torch.zeros(shape, dtype=dtype, device="meta")


def test_wrappers_raise_before_building(monkeypatch):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(ValueError, match="multiples of 8"):
        fgt.mlp_front(_meta(8, 250), _meta(250, 1000), _meta(8, 250), _meta(1000, 250))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fgt.mlp_front(_meta(8, 256), _meta(256, 1024), _meta(8, 256), _meta(1024, 256))
    f32 = torch.float32
    ln = lambda e, el, k=64: fgt.ln_backward_dx(
        _meta(8, k), _meta(e, k), _meta(8, e), _meta(e, dtype=f32), _meta(8, e, dtype=f32),
        _meta(8, dtype=f32), _meta(8, dtype=f32), el)
    with pytest.raises(ValueError, match="up to 2048"):
        ln(2304, 2304)
    with pytest.raises(ValueError, match="multiples of 8"):
        ln(256, 256, k=60)
    with pytest.raises(ValueError, match="el must be"):
        ln(256, 300)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ln(768, 768)
