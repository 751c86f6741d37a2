"""The Moonlight-16B-A3B policy's ops: multi-head latent attention's glue and
the mixture-of-experts layer, each a wrapper of ``csrc/moe.cu``.

CPU tensors take each op's plain PyTorch version, which rounds where the
kernel rounds (bf16 between ops, fp32 accumulation, norms, router and
softmax); CUDA tensors launch the kernel or raise.  Each plain version is
also a function of its own, ``<op>_plain``, that runs on any device, so that
the kernels can be held against it on the card.  :func:`kernel_launches`
reads the library's launch counters by op.

The expert path never reads a count on the host.  :func:`route` gives each
(token, choice) pair a row of the experts' input, grouped by expert, every
expert's segment padded to a multiple of :data:`BM` rows, and a segment
table (``tile_start`` [X + 1] | ``row0`` [X], int32, on the device) that the
grouped GEMMs' tile walker reads; the buffers have the worst case's
:func:`capacity` rows.  The plain version places a pair in token order
inside its segment, the kernel in the order its blocks reserve rows; no
result depends on the place.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

BM = 128                 # rows of a grouped GEMM tile; each segment starts at a multiple
BF16 = torch.bfloat16
LAUNCH_NAMES = ("rms_norm", "linear", "swiglu", "grouped", "topk", "offsets", "scatter",
                "combine", "rope", "compact", "thin_attention")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the library built from csrc/moe.cu."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    sigs = {
        "moe_rms_norm": [p, ll, p, p, ll, i, i, f, p],
        "moe_linear": [p, ll, p, p, i, i, i, i, p, ll, p],
        "moe_swiglu": [p, i, p, i, p, i, i, p, i, p],
        "moe_grouped": [p, i, p, i, p, i, i, p, p],
        "moe_route": [p, p, i, i, i, f, p, p, p, p, p, p, i, p, p, p],
        "moe_combine": [p, p, p, p, p, i, i, i, p],
        "moe_rope": [p, p, i, i, p, i, i, i, i, i, i, p, p, p],
        "moe_compact": [p, p, i, i, i, i, p],
        "moe_thin_attention": [p, p, p, i, i, i, i, i, f, p],
    }
    for name, args in sigs.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    lib.moe_launch_counts.argtypes = [p]
    lib.moe_launch_counts.restype = None
    lib.moe_reset_launches.argtypes = []
    lib.moe_reset_launches.restype = None
    lib.moe_error_string.argtypes = [i]
    lib.moe_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    from mapf_gpt_tpu_torch.ops import _build

    return bind(_build.load("moe"))


def kernel_launches() -> dict[str, int]:
    """The library's launch counters by op since the last reset (zeros when it
    was never loaded)."""
    if not _library.cache_info().currsize:
        return dict.fromkeys(LAUNCH_NAMES, 0)
    got = (ctypes.c_ulonglong * len(LAUNCH_NAMES))()
    _library().moe_launch_counts(ctypes.addressof(got))
    return dict(zip(LAUNCH_NAMES, (int(v) for v in got)))


def reset_kernel_launches() -> None:
    if _library.cache_info().currsize:
        _library().moe_reset_launches()


def _call(name: str, *args) -> None:
    lib = _library()
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    stream = torch.cuda.current_stream(dev).cuda_stream
    raw = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(*raw, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: {lib.moe_error_string(rc).decode()} ({rc})")


def _cuda(op: str, *tensors: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA ones
    (the kernel runs); a raise otherwise."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {dev}")
    return True


def _check_rows(op: str, name: str, x: torch.Tensor, dtype: torch.dtype) -> None:
    """Raise unless x is a 2-D `dtype` tensor with contiguous rows whose row
    stride and address suit the kernels (16 bytes)."""
    if x.dtype != dtype or x.dim() != 2 or x.stride(1) != 1 or \
            (x.stride(0) * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError(f"{op}: {name} must be 2-D {dtype} with contiguous, 16-byte aligned "
                         f"rows; got {x.dtype} {tuple(x.shape)} strides {x.stride()}")


def capacity(rows: int, k: int, experts: int) -> int:
    """Rows of the experts' input for `rows` tokens: every pair, and each
    segment's padding to BM."""
    return rows * k + experts * (BM - 1)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

def rms_norm_plain(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * gain).to(BF16)


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """bf16(x * rsqrt(mean(x^2) + eps) * gain) of bf16 rows x [M, n] (a view
    with a row stride is fine), fp32 arithmetic -> bf16 [M, n]."""
    if not _cuda("rms_norm", x):
        return rms_norm_plain(x, gain, eps)
    _check_rows("rms_norm", "x", x, BF16)
    m, n = x.shape
    y = torch.empty((m, n), dtype=BF16, device=x.device)
    _call("moe_rms_norm", x, x.stride(0), gain, y, n, m, n, ctypes.c_float(eps))
    return y


def linear_plain(a: torch.Tensor, w: torch.Tensor,
                 resid: torch.Tensor | None = None) -> torch.Tensor:
    y = (a.float() @ w.float()).to(BF16)
    if resid is None:
        return y
    resid.copy_((resid.float() + y.float()).to(BF16))
    return resid


def linear(a: torch.Tensor, w: torch.Tensor, resid: torch.Tensor | None = None) -> torch.Tensor:
    """bf16(a @ w), or with `resid` bf16(resid + bf16(a @ w)) written into
    resid; a bf16 [M, K] rows, w bf16 [K, N] (fp32 accumulation)."""
    if not _cuda("linear", a):
        return linear_plain(a, w, resid)
    _check_rows("linear", "a", a, BF16)
    _check_rows("linear", "w", w, BF16)
    m, k = a.shape
    n = w.shape[1]
    if resid is None:
        out = torch.empty((m, n), dtype=BF16, device=a.device)
        _call("moe_linear", a, a.stride(0), w, out, m, n, k, 0, None, 0)
        return out
    if not resid.is_contiguous() or resid.shape != (m, n):
        raise ValueError(f"linear: resid must be contiguous [{m}, {n}]")
    _call("moe_linear", a, a.stride(0), w, resid, m, n, k, 1, resid, n)
    return resid


def rope_tables(t: int, dim: int, theta: float, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) float32 [t, dim / 2]: position p, pair i at angle p theta^(-2i / dim)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv[None]
    return torch.cos(ang).contiguous(), torch.sin(ang).contiguous()


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x0, x1 = x[..., 0::2].float(), x[..., 1::2].float()
    return torch.stack((x0 * cos - x1 * sin, x0 * sin + x1 * cos), dim=-1).flatten(-2).to(BF16)


def rope_plain(q: torch.Tensor | None, kva: torch.Tensor | None, kv: torch.Tensor | None,
               cos: torch.Tensor, sin: torch.Tensor, heads: int, d: int, dn: int, latent: int,
               t: int, fixed: int = -1) -> None:
    ref = q if q is not None else kva
    m = ref.shape[0]
    pos = torch.full((m,), fixed, device=ref.device) if fixed >= 0 else \
        torch.arange(m, device=ref.device) % t
    c, s = cos[pos][:, None], sin[pos][:, None]
    if q is not None:
        qv = q.view(m, heads, d)
        qv[..., dn:] = _rotate(qv[..., dn:], c, s)
    if kva is not None:
        k = _rotate(kva[:, latent:][:, None], c, s)
        kv.view(m, heads, 2 * d)[..., dn:d] = k


def rope(q: torch.Tensor | None, kva: torch.Tensor | None, kv: torch.Tensor | None,
         cos: torch.Tensor, sin: torch.Tensor, heads: int, d: int, dn: int, latent: int,
         t: int, fixed: int = -1) -> None:
    """RoPE in place, pairs (2i, 2i + 1): q [M, H D]'s columns dn .. D of each
    head (row r at position r % t, or at `fixed` when it is >= 0), and the
    shared key kva[:, latent:] rotated into columns dn .. D of every head of
    kv [M, H 2D]."""
    ref = q if q is not None else kva
    if not _cuda("rope", ref):
        return rope_plain(q, kva, kv, cos, sin, heads, d, dn, latent, t, fixed)
    m = ref.shape[0]
    _call("moe_rope", q, kva, 0 if kva is None else kva.stride(0), latent, kv, m, heads, d, dn,
          t, fixed, cos, sin)


def compact_plain(o: torch.Tensor, dv: int) -> torch.Tensor:
    return o[..., :dv].reshape(o.shape[0], o.shape[1] * dv)


def compact(o: torch.Tensor, dv: int) -> torch.Tensor:
    """o [M, H, D] (contiguous) -> the first dv columns of each head, [M, H dv]."""
    m, h, d = o.shape
    if not _cuda("compact", o):
        return compact_plain(o, dv)
    out = torch.empty((m, h * dv), dtype=BF16, device=o.device)
    _call("moe_compact", o, out, m, h, d, dv)
    return out


def thin_attention_plain(q: torch.Tensor, kv: torch.Tensor, heads: int, d: int, dv: int,
                         t: int, scale: float) -> torch.Tensor:
    n = q.shape[0]
    qh = q.view(n, heads, 1, d).float()
    kvh = kv.view(n, t, heads, 2 * d).transpose(1, 2)
    s = (qh @ kvh[..., :d].float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(BF16)
    return (p.float() @ kvh[..., d:d + dv].float()).to(BF16).reshape(n, heads * dv)


def thin_attention(q: torch.Tensor, kv: torch.Tensor, heads: int, d: int, dv: int, t: int,
                   scale: float) -> torch.Tensor:
    """The last position's attention: q [N, H D] against keys kv[..., :D] and
    values kv[..., D:D + dv] of each head of kv [N t, H 2D]: fp32 scores,
    p = bf16(softmax), bf16(p v) -> [N, H dv]."""
    n = q.shape[0]
    if not _cuda("thin_attention", q):
        return thin_attention_plain(q, kv, heads, d, dv, t, scale)
    out = torch.empty((n, heads * dv), dtype=BF16, device=q.device)
    _call("moe_thin_attention", q, kv, out, n, t, heads, d, dv, ctypes.c_float(scale))
    return out


def _swiglu_epilogue(acc: torch.Tensor) -> torch.Tensor:
    """The SwiGLU epilogue on fp32 products whose columns come in blocks of
    16, 8 gate then 8 up: bf16(silu(bf16(g)) * bf16(u))."""
    m, n2 = acc.shape
    gu = acc.view(m, n2 // 16, 2, 8)
    g, u = gu[:, :, 0].to(BF16).float(), gu[:, :, 1].to(BF16).float()
    return (F.silu(g) * u).to(BF16).reshape(m, n2 // 2)


def _segments(table: torch.Tensor, experts: int):
    """(expert, first row, rows) of each segment of a table."""
    ts = table[:experts + 1].tolist()
    row0 = table[experts + 1:].tolist()
    return [(e, row0[e], (ts[e + 1] - ts[e]) * BM) for e in range(experts)]


def swiglu_plain(a: torch.Tensor, w: torch.Tensor, table: torch.Tensor | None = None,
                 experts: int = 1) -> torch.Tensor:
    rows, k = a.shape
    if table is None:
        return _swiglu_epilogue(a.float() @ w.float())
    out = torch.zeros((rows, w.shape[1] // 2), dtype=BF16, device=a.device)
    for e, r0, n in _segments(table, experts):
        if n:
            out[r0:r0 + n] = _swiglu_epilogue(a[r0:r0 + n].float() @ w[e * k:(e + 1) * k].float())
    return out


def swiglu(a: torch.Tensor, w: torch.Tensor, table: torch.Tensor | None = None,
           experts: int = 1) -> torch.Tensor:
    """The SwiGLU epilogue of a @ W_e: with a segment table, segment e's rows
    of a [rows, K] against W_e of w [X K, 2f] (the routed experts); without,
    all rows against w [K, 2f] (a dense SwiGLU).  -> bf16 [rows, f]."""
    rows, k = a.shape
    if not _cuda("swiglu", a):
        return swiglu_plain(a, w, table, experts)
    _check_rows("swiglu", "a", a, BF16)
    n2 = w.shape[1]
    out = torch.empty((rows, n2 // 2), dtype=BF16, device=a.device)
    _call("moe_swiglu", a, rows, w, experts, out, n2, k, table, rows)
    return out


def grouped_plain(a: torch.Tensor, w: torch.Tensor, table: torch.Tensor,
                  experts: int) -> torch.Tensor:
    rows, k = a.shape
    out = torch.zeros((rows, w.shape[1]), dtype=BF16, device=a.device)
    for e, r0, n in _segments(table, experts):
        if n:
            out[r0:r0 + n] = (a[r0:r0 + n].float() @ w[e * k:(e + 1) * k].float()).to(BF16)
    return out


def grouped(a: torch.Tensor, w: torch.Tensor, table: torch.Tensor, experts: int) -> torch.Tensor:
    """bf16(a @ W_e) over the segments of `table`: a [rows, K], w [X K, N]
    -> bf16 [rows, N]."""
    rows, k = a.shape
    if not _cuda("grouped", a):
        return grouped_plain(a, w, table, experts)
    _check_rows("grouped", "a", a, BF16)
    out = torch.empty((rows, w.shape[1]), dtype=BF16, device=a.device)
    _call("moe_grouped", a, rows, w, experts, out, w.shape[1], k, table)
    return out


def router_logits_plain(b: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    return b.float() @ w3.float()


def router_logits(b: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """fp32 [M, 3X]: b @ [hi | mid | lo], the three bf16 terms of the router's
    fp32 weight (:func:`split3`), each product exact, sums in fp32."""
    if not _cuda("router", b):
        return router_logits_plain(b, w3)
    _check_rows("router", "b", b, BF16)
    m, k = b.shape
    out = torch.empty((m, w3.shape[1]), dtype=torch.float32, device=b.device)
    _call("moe_linear", b, b.stride(0), w3, out, m, w3.shape[1], k, 2, None, 0)
    return out


def split3(w: torch.Tensor) -> torch.Tensor:
    """fp32 w [X, E] -> bf16 [E, 3X]: hi | mid | lo with hi + mid + lo == w."""
    hi = w.to(BF16)
    mid = (w - hi.float()).to(BF16)
    lo = (w - hi.float() - mid.float()).to(BF16)
    return torch.cat([hi, mid, lo]).t().contiguous()


def route_plain(b: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor, k: int, scale: float,
                counter: torch.Tensor | None = None):
    m, e = b.shape
    experts = w3.shape[1] // 3
    logits3 = router_logits_plain(b, w3)
    z = (logits3[:, 2 * experts:] + logits3[:, experts:2 * experts]) + logits3[:, :experts]
    s = torch.sigmoid(z)
    idx = torch.sort(s + bias, dim=-1, descending=True, stable=True).indices[:, :k]
    ws = s.gather(1, idx)
    w = ws / (ws.sum(-1, keepdim=True) + 1e-20) * scale
    flat = idx.reshape(-1)
    counts = torch.bincount(flat, minlength=experts)
    tiles = (counts + BM - 1) // BM
    tile_start = torch.cat([tiles.new_zeros(1), tiles.cumsum(0)])
    row0 = tile_start[:-1] * BM
    order = torch.sort(flat, stable=True).indices
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(len(flat), device=b.device) - first[flat[order]]
    slot = (row0[flat] + rank).view(m, k)
    a = torch.zeros((capacity(m, k, experts), e), dtype=BF16, device=b.device)
    a[slot.reshape(-1)] = b.repeat_interleave(k, dim=0)
    if counter is not None:
        counter += counts
    table = torch.cat([tile_start, row0]).int()
    return a, table, slot.int(), w, idx.int()


def route(b: torch.Tensor, w3: torch.Tensor, bias: torch.Tensor, k: int, scale: float,
          scratch: torch.Tensor, counter: torch.Tensor | None = None):
    """The router: fp32 scores s = sigmoid(b Wr) (Wr from :func:`split3`'s
    terms, summed (lo + mid) + hi), the k experts of largest s + bias (ties to
    the lower index), weights scale s / (sum of the chosen s + 1e-20); then the
    permutation.  Returns (a: the experts' input [capacity, E], table int32
    [2X + 1], slot int32 [M, k]: the row of a that holds each pair, w fp32 [M,
    k], idx int32 [M, k]).  `scratch` (int32 [2X]: counts | fill, the counts
    zero) keeps the counts zero (the kernels zero the fill before they add to
    it); `counter` (int64 [X]) gets each expert's count added."""
    if not _cuda("route", b):
        return route_plain(b, w3, bias, k, scale, counter)
    m, e = b.shape
    experts = w3.shape[1] // 3
    cap = capacity(m, k, experts)
    logits3 = router_logits(b, w3)
    idx = torch.empty((m, k), dtype=torch.int32, device=b.device)
    w = torch.empty((m, k), dtype=torch.float32, device=b.device)
    table = torch.empty(2 * experts + 1, dtype=torch.int32, device=b.device)
    slot = torch.empty((m, k), dtype=torch.int32, device=b.device)
    a = torch.empty((cap, e), dtype=BF16, device=b.device)
    _check_rows("route", "b", b, BF16)
    _call("moe_route", logits3, bias, m, experts, k, ctypes.c_float(scale), idx, w, scratch,
          table, counter, b, e, slot, a)
    return a, table, slot, w, idx


def combine_plain(h: torch.Tensor, ys: torch.Tensor, y: torch.Tensor, slot: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    acc = ys.float()
    for j in range(slot.shape[1]):
        acc = acc + w[:, j:j + 1] * y[slot[:, j].long()].float()
    h.copy_((h.float() + acc).to(BF16))
    return h


def combine(h: torch.Tensor, ys: torch.Tensor, y: torch.Tensor, slot: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """h = bf16(h + (ys + sum_k w_k y[slot_k])), k in order, in place: h, ys
    bf16 [M, E], y the experts' outputs [capacity, E]."""
    m, e = h.shape
    if not _cuda("combine", h):
        return combine_plain(h, ys, y, slot, w)
    _call("moe_combine", h, ys, y, slot, w, m, e, slot.shape[1])
    return h
