"""Fused training path: the layer stack's forward and backward as hand-written
kernels, under one ``torch.autograd.Function``.

Port of ``mapf_gpt_tpu/ops/fused_gpt_train.py``:

- :func:`build_train_stacks` stacks a model's layer weights for the kernels,
  differentiably: bf16 [L, in, out] matrices and fp32 LN gains, with no
  scale folded in (the gradients map back to the raw parameters).
- :func:`train_fwd_reference` and :func:`train_bwd_reference` are the plain
  PyTorch versions of one chunk's forward and backward (``_fwd_kernel``,
  ``_bwd_kernel``): fp32 products over bf16 values, the JAX kernels'
  rounding points, no autograd.  The forward saves x before each attention
  and each MLP (``xsave`` [2L, N, T, E]); the backward recomputes LN, q|k|v,
  the attention probabilities and the MLP hidden from those saves, keeps dx
  in fp32 inside the chunk and returns it as bf16, with fp32 gradients of
  the six stacks.
- :func:`train_forward` and :func:`train_backward` are the wrappers: CPU
  tensors take the plain versions; CUDA tensors launch the kernels of
  ``csrc/fused_train.cu`` (one call of its library per chunk, counted in
  ``fwd_launches`` and ``bwd_launches``) or raise.
- :class:`FusedBlocksTrain` is the counterpart of the JAX ``custom_vjp``:
  embeddings [N, T, E] bf16 -> last-position activations [N, E] bf16.  The
  forward runs all layers in one call (x is bf16 at every layer boundary,
  so the JAX package's VMEM-sized forward chunks would not change the
  result); the backward walks 2-layer chunks for E <= 384 and 1-layer
  chunks above, dx bf16 between chunks, as the JAX package does
  (``_bwd_layers_per_call``).  The top gradient is zero at every position
  but the last.  The weight gradients leave it in
  the stacks' dtype (bf16 matrices, fp32 gains).
- :func:`train_attention` and :func:`train_attention_backward` run the
  kernels' attention alone (forward with row statistics; dq|dk|dv), for
  checks and timing on the card, beside their plain versions
  :func:`train_attention_reference` and
  :func:`train_attention_backward_reference` (the attention of
  ``train_fwd_reference`` and ``train_bwd_reference``).
  :func:`attention_route` names the kernels a shape takes (``csrc/fused_train.cu``'s
  ``attention_route``): "wgmma" (``csrc/attn_wgmma.cuh`` and
  ``csrc/attn_wgmma_bwd.cuh``) at T <= 256 and head widths padded to 16,
  32, 48 or 64, "tile" (``csrc/attn_tile.cuh``'s mma.sync tiles) at the
  other widths up to 128 and at T past 256, "wide" (the slabs) past 128.
- :func:`mlp_front` and :func:`ln_backward_dx` run the backward's two
  epilogue kernels alone (``csrc/train_bwd_gemm.cuh``'s ``mlp_front_kernel``:
  hact and dh from one kernel of two products; ``ln_dx_kernel``: the dX
  product with the LayerNorm backward and the gain partials in its
  epilogue), beside their plain versions :func:`mlp_front_reference` and
  :func:`ln_backward_dx_reference`; :func:`ln_route` names how the
  backward takes a width's LayerNorm ("epilogue": one CTA owns a row,
  "cluster": a row's 256-column tiles as one thread-block cluster,
  "kernels": the separate kernels past 2048 columns), the mirror of
  ``tbg::ln_ranks``; :func:`bwd_gemm_launches` reads their launch
  counters.
- :func:`fused_loss_fn` is ``train_step.loss_fn`` through the kernels:
  embedding (ids read as JAX indexing reads them, as the JAX function's
  ``wte[tokens]``), the stack, fp32 LN_f and the tied head, cross-entropy
  at the last position, all but the stack plain PyTorch ops under
  autograd.

Semantics match the module for bias-free, dropout-0 configs with tanh GELU
(the module uses the erf form), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mapf_gpt_tpu_torch.ops.fused_blocks import (check_tensor, kernel_layout, ln_f32,
                                                 pad_width, padded_head_dim, stored_width)
from mapf_gpt_tpu_torch.ops.fused_gpt import jax_index

_EPS = 1e-5
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_GELU_C = 0.044715
GROUP = 256    # contexts a kernel call processes at a time

fwd_launches = 0   # forward kernel calls by train_forward; callers may reset them to 0
bwd_launches = 0   # backward kernel calls by train_backward
ROUTES = ("wgmma", "tile", "wide")   # csrc/fused_train.cu's attention_route codes
WGMMA_KERNELS = ("attn_wgmma_kernel", "attn_bwd_q_wgmma", "attn_bwd_kv_wgmma")
_WGMMA_WIDTHS = (16, 32, 48, 64)   # padded head widths of the wgmma kernels
_T_WGMMA = 256                     # their longest T
_D_TILE = 128                      # the widest head of the mma.sync tiles; slabs past it
BWD_GEMM_KERNELS = ("mlp_front_kernel", "ln_dx_kernel")   # csrc/train_bwd_gemm.cuh
LN_ROUTES = ("epilogue", "cluster", "kernels")
_LN_BN = 256                       # the LN epilogue's output tile (columns of a CTA)
_LN_MAX_RANKS = 8                  # its largest cluster: stored n_embd up to 2048


class TrainStacks(NamedTuple):
    wqkv: torch.Tensor    # bf16 [L, E, 3E]
    wproj: torch.Tensor   # bf16 [L, E, E]
    wfc: torch.Tensor     # bf16 [L, E, 4E]
    wfc2: torch.Tensor    # bf16 [L, 4E, E]
    g1: torch.Tensor      # f32 [L, E]
    g2: torch.Tensor      # f32 [L, E]
    n_head: int

    def chunk(self, lo: int, hi: int) -> "TrainStacks":
        """Layers lo .. hi-1."""
        return TrainStacks(*(s[lo:hi] for s in self[:6]), n_head=self.n_head)


def build_train_stacks(model) -> TrainStacks:
    """Stack a :class:`models.gpt.GPT`'s layer weights (bf16 matrices [in,
    out], fp32 gains), differentiably and without the inference-time scale
    folding."""
    blocks = model.transformer.h
    bf = lambda ts: torch.stack(ts).to(torch.bfloat16).contiguous()
    return TrainStacks(
        wqkv=bf([b.attn.c_attn.weight.t() for b in blocks]),
        wproj=bf([b.attn.c_proj.weight.t() for b in blocks]),
        wfc=bf([b.mlp.c_fc.weight.t() for b in blocks]),
        wfc2=bf([b.mlp.c_proj.weight.t() for b in blocks]),
        g1=torch.stack([b.ln_1.weight for b in blocks]).float().contiguous(),
        g2=torch.stack([b.ln_2.weight for b in blocks]).float().contiguous(),
        n_head=model.cfg.n_head,
    )


def _bwd_layers_per_call(cfg) -> int:
    """Backward chunk: 2 layers for E <= 384, 1 above.  dx is fp32 inside a
    chunk and bf16 between chunks, so this does change the result."""
    return 2 if cfg.n_embd <= 384 else 1


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _ln(x32: torch.Tensor, gain: torch.Tensor):
    """(LN(x) * gain, xhat, rstd): two-pass fp32 LayerNorm, eps 1e-5."""
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + _EPS)
    xhat = xc * rstd
    return xhat * gain, xhat, rstd


def _ln_bwd(dy: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor, gain: torch.Tensor):
    """(dx, dgain rows) of y = xhat * gain."""
    dxhat = dy * gain
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return (dxhat - m1 - xhat * m2) * rstd, dy * xhat


def _gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    u = _SQRT_2_OVER_PI * (h + _GELU_C * h * h * h)
    return 0.5 * h * (1.0 + torch.tanh(u))


def _gelu_tanh_grad(h: torch.Tensor) -> torch.Tensor:
    u = _SQRT_2_OVER_PI * (h + _GELU_C * h * h * h)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * h * h)
    return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * du


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 product with fp32 accumulation (fp32 result)."""
    return a.float() @ b.float()


def _heads(z: torch.Tensor, n_head: int) -> torch.Tensor:
    """[N, T, E] -> [N, H, T, dh]."""
    n, t, e = z.shape
    return z.reshape(n, t, n_head, e // n_head).transpose(1, 2)


def _merge(z: torch.Tensor) -> torch.Tensor:
    """[N, H, T, dh] -> [N, T, E]."""
    n, h, t, dh = z.shape
    return z.transpose(1, 2).reshape(n, t, h * dh)


def _probs(qkv: torch.Tensor, n_head: int):
    """(p fp32 [N, H, T, T], q, k, v [N, H, T, dh]): softmax of the scaled
    scores with the row max subtracted, not rounded."""
    e = qkv.shape[-1] // 3
    q, k, v = (_heads(z, n_head) for z in qkv.split(e, dim=-1))
    s = _mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(e // n_head))
    ex = torch.exp(s - s.amax(-1, keepdim=True))
    return ex / ex.sum(-1, keepdim=True), q, k, v


def train_fwd_reference(x: torch.Tensor, stacks: TrainStacks, last_only: bool):
    """Plain PyTorch version of the forward kernel: bf16 x [N, T, E] through
    the chunk's layers -> (out, xsave): out bf16 [N, E] (the last position)
    when last_only, else [N, T, E]; xsave bf16 [2L, N, T, E]."""
    bf16 = torch.bfloat16
    saves = []
    for l in range(stacks.wqkv.shape[0]):
        saves.append(x)
        xn = _ln(x.float(), stacks.g1[l])[0].to(bf16)
        qkv = _mm(xn, stacks.wqkv[l]).to(bf16)
        p, _, _, v = _probs(qkv, stacks.n_head)
        att = _merge(_mm(p.to(bf16), v).to(bf16))
        x = (x.float() + _mm(att, stacks.wproj[l]).to(bf16).float()).to(bf16)
        saves.append(x)
        xn2 = _ln(x.float(), stacks.g2[l])[0].to(bf16)
        hact = _gelu_tanh(_mm(xn2, stacks.wfc[l])).to(bf16)
        x = (x.float() + _mm(hact, stacks.wfc2[l]).to(bf16).float()).to(bf16)
    return (x[:, -1] if last_only else x), torch.stack(saves)


def train_bwd_reference(xsave: torch.Tensor, dxin: torch.Tensor, stacks: TrainStacks):
    """Plain PyTorch version of the backward kernel: xsave [2L, N, T, E] and
    the gradient of the chunk's output stream dxin bf16 [N, T, E] -> (dx
    bf16 [N, T, E], (dwqkv, dwproj, dwfc, dwfc2, dg1, dg2) fp32)."""
    bf16 = torch.bfloat16
    layers = stacks.wqkv.shape[0]
    n, t, e = dxin.shape
    h = stacks.n_head
    scale = 1.0 / math.sqrt(e // h)
    rows = lambda z: z.reshape(n * t, -1)
    grads = [torch.zeros(s.shape, dtype=torch.float32, device=dxin.device) for s in stacks[:6]]
    dwqkv, dwproj, dwfc, dwfc2, dg1, dg2 = grads
    dx = dxin.float()
    for l in range(layers - 1, -1, -1):
        x_in, x_mid = xsave[2 * l], xsave[2 * l + 1]
        # MLP backward (recompute xn2, hmid)
        xn2f, xhat2, rstd2 = _ln(x_mid.float(), stacks.g2[l])
        xn2 = xn2f.to(bf16)
        dxb = dx.to(bf16)
        hact, dhb = mlp_front_reference(xn2, stacks.wfc[l], dxb, stacks.wfc2[l])
        dwfc2[l] = _mm(rows(hact).T, rows(dxb))
        dwfc[l] = _mm(rows(xn2).T, rows(dhb))
        dx_ln2, dg2_rows = _ln_bwd(_mm(dhb, stacks.wfc[l].T), xhat2, rstd2, stacks.g2[l])
        dg2[l] = rows(dg2_rows).sum(0)
        dx = dx + dx_ln2
        # attention backward (recompute xn1, q|k|v, p)
        xn1f, xhat1, rstd1 = _ln(x_in.float(), stacks.g1[l])
        xn1 = xn1f.to(bf16)
        qkv = _mm(xn1, stacks.wqkv[l]).to(bf16)
        dxb = dx.to(bf16)
        p, q, k, v = _probs(qkv, h)
        pb = p.to(bf16)
        att = _merge(_mm(pb, v).to(bf16))
        dwproj[l] = _mm(rows(att).T, rows(dxb))
        da = _heads(_mm(dxb, stacks.wproj[l].T).to(bf16), h)
        dv = _mm(pb.transpose(-1, -2), da).to(bf16)
        dp = _mm(da, v.transpose(-1, -2))
        ds = ((dp - (dp * p).sum(-1, keepdim=True)) * p * scale).to(bf16)
        dq = _mm(ds, k).to(bf16)
        dk = _mm(ds.transpose(-1, -2), q).to(bf16)
        dqkv = torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)
        dwqkv[l] = _mm(rows(xn1).T, rows(dqkv))
        dx_ln1, dg1_rows = _ln_bwd(_mm(dqkv, stacks.wqkv[l].T), xhat1, rstd1, stacks.g1[l])
        dg1[l] = rows(dg1_rows).sum(0)
        dx = dx + dx_ln1
    return dx.to(bf16), tuple(grads)


def mlp_front_reference(xn2: torch.Tensor, wfc: torch.Tensor, dxb: torch.Tensor,
                        wfc2: torch.Tensor):
    """Plain version of the backward's MLP front: bf16 xn2, dxb [..., E],
    wfc [E, F], wfc2 [F, E] -> (hact, dh) bf16 [..., F]: hmid = xn2 wfc in
    fp32, hact = bf16(gelu(hmid)), dh = bf16((dxb wfc2^T) gelu'(hmid))."""
    hmid = _mm(xn2, wfc)
    return (_gelu_tanh(hmid).to(torch.bfloat16),
            (_mm(dxb, wfc2.T) * _gelu_tanh_grad(hmid)).to(torch.bfloat16))


def ln_backward_dx_reference(a: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                             g: torch.Tensor, dx: torch.Tensor, mu: torch.Tensor,
                             rstd: torch.Tensor, el: int):
    """Plain version of the LN epilogue: dy = a w^T (bf16 a [M, K], w [E,
    K]; fp32) is the gradient of y = LN(x) g (bf16 x [M, E], fp32 g [E], the
    rows' mu and rstd [M]), normalised over the first el columns ->
    (dx + its LN backward fp32 [M, E], that in bf16, the gain gradient [E]).
    Columns past el keep dx."""
    dy = _mm(a, w.T)
    xhat = (x.float() - mu[:, None]) * rstd[:, None]
    d = dy * g
    m1 = d[:, :el].sum(-1, keepdim=True) / el
    m2 = (d * xhat)[:, :el].sum(-1, keepdim=True) / el
    out = dx.clone()
    out[:, :el] += ((d - m1 - xhat * m2) * rstd[:, None])[:, :el]
    return out, out.to(torch.bfloat16), (dy * xhat).sum(0)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def check_train_width(t: int, e: int, n_head: int) -> str:
    """Raise ValueError, naming the constraint, unless csrc/fused_train.cu
    takes T=t, n_embd=e and n_head heads: any T >= 1, any n_embd (one that is
    not a multiple of 8 runs padded with zero columns,
    :func:`fused_blocks.kernel_layout`), head dims up to 512 (one that is not
    a multiple of 16 runs padded with zero columns, one past 128 in slabs,
    :func:`fused_blocks.padded_head_dim`).  Returns the attention's route
    (:func:`attention_route`)."""
    if t < 1:
        raise ValueError(f"fused_train: T must be at least 1; got {t}")
    if n_head <= 0 or e % n_head:
        raise ValueError(f"fused_train: n_embd {e} is not a multiple of n_head {n_head}")
    dh = e // n_head
    if dh > 512:
        raise ValueError(f"fused_train: head dim must be from 1 up to 512; got {dh}")
    return attention_route(t, e, n_head)


def attention_route(t: int, e: int, n_head: int) -> str:
    """The attention kernels csrc/fused_train.cu runs for T=t, n_embd e and
    n_head heads (its ``attention_route``, which ``chip_smoke.py`` holds
    this to): "wgmma" at T <= 256 with the head padded to 16, 32, 48 or 64
    columns, "tile" at the other heads up to 128 columns and at T past 256,
    "wide" past 128."""
    dh = e // n_head
    if dh > _D_TILE:
        return "wide"
    return "wgmma" if t <= _T_WGMMA and padded_head_dim(dh) in _WGMMA_WIDTHS else "tile"


def ln_cluster_ranks(e: int) -> int:
    """CTAs of the LN epilogue's cluster for n_embd e (csrc/train_bwd_gemm.cuh's
    ``ln_ranks`` of the stored width): one a 256-column tile of a row, 0
    past ``_LN_MAX_RANKS`` tiles."""
    ranks = -(-stored_width(e) // _LN_BN)
    return ranks if ranks <= _LN_MAX_RANKS else 0


def ln_route(e: int) -> str:
    """How the backward takes the LayerNorm of n_embd e (``chip_smoke.py``
    holds this to the library's answer): "epilogue", ``ln_dx_kernel`` with
    a CTA owning whole rows (n_embd up to 256); "cluster", ``ln_dx_kernel``
    as clusters of :func:`ln_cluster_ranks` CTAs (up to 2048); "kernels",
    the product into fp32, then ``ln_bwd_kernel`` and ``dg_partial_kernel``."""
    ranks = ln_cluster_ranks(e)
    return LN_ROUTES[2 if ranks == 0 else 0 if ranks == 1 else 1]


def bwd_gemm_launch_count(layers: int, n: int, e: int) -> dict[str, int]:
    """Launches of ``BWD_GEMM_KERNELS`` by one backward chunk of `layers`
    layers on n contexts of n_embd e: an MLP front a layer and group of
    ``GROUP`` contexts, and two LN epilogues where :func:`ln_route` takes
    the width."""
    per = layers * -(-n // GROUP)
    return dict(zip(BWD_GEMM_KERNELS, (per, 0 if ln_route(e) == "kernels" else 2 * per)))


def _unpad_grads(grads: tuple, e: int, n_head: int) -> tuple:
    """The gradients of :func:`fused_blocks.kernel_layout`'s padded stacks
    (n_embd e) back in the stacks' shapes: the zero columns and rows
    dropped."""
    dwqkv, dwproj, dwfc, dwfc2, dg1, dg2 = grads
    layers = dg1.shape[0]
    dh = e // n_head
    dp = padded_head_dim(dh)
    dwqkv = dwqkv[:, :e].reshape(layers, e, 3, n_head, dp)[..., :dh].reshape(layers, e, 3 * e)
    dwproj = dwproj[..., :e].reshape(layers, n_head, dp, e)[:, :, :dh].reshape(layers, e, e)
    return tuple(g.contiguous() for g in (dwqkv, dwproj, dwfc[:, :e, :4 * e],
                                          dwfc2[:, :4 * e, :e], dg1[:, :e], dg2[:, :e]))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from csrc/fused_train.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_train_workspace.argtypes = [i] * 5
    lib.fused_train_workspace.restype = ctypes.c_longlong
    lib.fused_train_attention_route.argtypes = [i] * 3
    lib.fused_train_attention_route.restype = i
    lib.fused_train_attention_fwd.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.fused_train_attention_fwd.restype = i
    lib.fused_train_attention_scratch.argtypes = [i] * 4
    lib.fused_train_attention_scratch.restype = ctypes.c_longlong
    lib.fused_train_attention_bwd.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.fused_train_attention_bwd.restype = i
    lib.fused_train_wgmma_launches.argtypes = [i]
    lib.fused_train_wgmma_launches.restype = ctypes.c_longlong
    lib.fused_train_forward.argtypes = [p] * 10 + [i] * 7 + [p]
    lib.fused_train_forward.restype = i
    lib.fused_train_backward.argtypes = [p] * 16 + [i] * 6 + [p]
    lib.fused_train_backward.restype = i
    lib.fused_train_gemm.argtypes = [p] * 3 + [i] * 7 + [p]
    lib.fused_train_gemm.restype = i
    lib.fused_train_mlp_front.argtypes = [p] * 6 + [i] * 3 + [p]
    lib.fused_train_mlp_front.restype = i
    lib.fused_train_ln_route.argtypes = [i]
    lib.fused_train_ln_route.restype = i
    lib.fused_train_ln_dx.argtypes = [p] * 10 + [i] * 4 + [p]
    lib.fused_train_ln_dx.restype = i
    lib.fused_train_bwd_gemm_launches.argtypes = [i]
    lib.fused_train_bwd_gemm_launches.restype = ctypes.c_longlong
    lib.fused_train_error_string.argtypes = [i]
    lib.fused_train_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    from mapf_gpt_tpu_torch.ops import _build

    return bind(_build.load("fused_train"))


def _check_stacks(stacks: TrainStacks, e: int, dev: torch.device) -> int:
    layers = stacks.wqkv.shape[0]
    if layers == 0:
        raise ValueError("fused_train: no layers")
    f = 4 * e
    for name, ten, dtype, shape in (
            ("wqkv", stacks.wqkv, torch.bfloat16, (layers, e, 3 * e)),
            ("wproj", stacks.wproj, torch.bfloat16, (layers, e, e)),
            ("wfc", stacks.wfc, torch.bfloat16, (layers, e, f)),
            ("wfc2", stacks.wfc2, torch.bfloat16, (layers, f, e)),
            ("g1", stacks.g1, torch.float32, (layers, e)),
            ("g2", stacks.g2, torch.float32, (layers, e))):
        check_tensor("fused_train", name, ten, dtype, shape, dev)
    return layers


def _workspace(lib, kind: int, group: int, t: int, e: int, h: int, dev) -> torch.Tensor:
    nbytes = lib.fused_train_workspace(kind, group, t, e, h)
    if nbytes < 0:
        raise ValueError(f"fused_train: the kernels do not take T={t}, n_embd={e}, {h} heads")
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fused_train {what} launch failed: "
                           f"{lib.fused_train_error_string(rc).decode()} ({rc})")


def train_forward(x: torch.Tensor, stacks: TrainStacks, last_only: bool):
    """One forward chunk: bf16 x [N, T, E] -> (out, xsave) as
    :func:`train_fwd_reference`.  CPU tensors take the plain version; CUDA
    tensors launch the kernel (one call per chunk) or raise."""
    global fwd_launches
    if x.device.type == "cpu":
        return train_fwd_reference(x, stacks, last_only)
    if x.dim() != 3:
        raise ValueError(f"fused_train: x must be [N, T, E]; got {tuple(x.shape)}")
    n, t, e = x.shape
    check_train_width(t, e, stacks.n_head)
    if x.device.type != "cuda":
        raise ValueError(f"fused_train: no kernel for device {x.device}")
    dev = x.device
    check_tensor("fused_train", "x", x, torch.bfloat16, (n, t, e), dev)
    layers = _check_stacks(stacks, e, dev)
    lib = _library()
    es = stored_width(e)   # the kernels' stored width; zero columns past e
    xsave = torch.empty((2 * layers, n, t, es), dtype=torch.bfloat16, device=dev)
    out = torch.empty((n, es) if last_only else (n, t, es), dtype=torch.bfloat16, device=dev)
    if n == 0:
        return out[..., :e], xsave[..., :e]
    group = min(n, GROUP)
    ws = _workspace(lib, 0, group, t, e, stacks.n_head, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    weights = kernel_layout(stacks)
    xk = pad_width(x)
    with torch.cuda.device(dev):
        rc = lib.fused_train_forward(
            xk.data_ptr(), out.data_ptr(), xsave.data_ptr(), *(w.data_ptr() for w in weights),
            ws.data_ptr(), n, t, e, stacks.n_head, layers, int(last_only), group, stream)
    _raise_on(lib, rc, "forward")
    fwd_launches += 1
    if es == e:
        return out, xsave
    return out[..., :e].contiguous(), xsave[..., :e].contiguous()


def train_backward(xsave: torch.Tensor, dxin: torch.Tensor, stacks: TrainStacks):
    """One backward chunk: (dx, grads) as :func:`train_bwd_reference`.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (one call
    per chunk) or raise."""
    global bwd_launches
    if dxin.device.type == "cpu":
        return train_bwd_reference(xsave, dxin, stacks)
    if dxin.dim() != 3:
        raise ValueError(f"fused_train: dxin must be [N, T, E]; got {tuple(dxin.shape)}")
    n, t, e = dxin.shape
    check_train_width(t, e, stacks.n_head)
    if dxin.device.type != "cuda":
        raise ValueError(f"fused_train: no kernel for device {dxin.device}")
    dev = dxin.device
    layers = _check_stacks(stacks, e, dev)
    check_tensor("fused_train", "xsave", xsave, torch.bfloat16, (2 * layers, n, t, e), dev)
    check_tensor("fused_train", "dxin", dxin, torch.bfloat16, (n, t, e), dev)
    lib = _library()
    es = stored_width(e)
    dx = torch.empty((n, t, es), dtype=torch.bfloat16, device=dev)
    weights = kernel_layout(stacks)
    grads = tuple(torch.zeros(w.shape, dtype=torch.float32, device=dev) for w in weights)
    if n == 0:
        return dx[..., :e], _unpad_grads(grads, e, stacks.n_head)
    group = min(n, GROUP)
    ws = _workspace(lib, 1, group, t, e, stacks.n_head, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    xsave_k, dxin_k = pad_width(xsave), pad_width(dxin)
    with torch.cuda.device(dev):
        rc = lib.fused_train_backward(
            xsave_k.data_ptr(), dxin_k.data_ptr(), *(w.data_ptr() for w in weights),
            dx.data_ptr(), *(g.data_ptr() for g in grads), ws.data_ptr(), n, t, e,
            stacks.n_head, layers, group, stream)
    _raise_on(lib, rc, "backward")
    bwd_launches += 1
    return (dx if es == e else dx[..., :e].contiguous()), _unpad_grads(grads, e, stacks.n_head)


def wgmma_launches() -> dict[str, int]:
    """Launches of the wgmma route's attention kernels (``WGMMA_KERNELS``:
    the forward with or without statistics, the query side, the key side)
    since :func:`reset_wgmma_launches`, counted by the library where it
    launches them: inside ``train_forward`` and ``train_backward`` and the
    attention run alone."""
    lib = _library()
    return {name: lib.fused_train_wgmma_launches(k) for k, name in enumerate(WGMMA_KERNELS)}


def reset_wgmma_launches() -> None:
    _library().fused_train_wgmma_launches(-1)


def bwd_gemm_launches() -> dict[str, int]:
    """Launches of the backward's epilogue kernels (``BWD_GEMM_KERNELS``)
    since :func:`reset_bwd_gemm_launches`, counted by the library where it
    launches them: inside ``train_backward`` and the kernels run alone."""
    lib = _library()
    return {name: lib.fused_train_bwd_gemm_launches(k) for k, name in enumerate(BWD_GEMM_KERNELS)}


def reset_bwd_gemm_launches() -> None:
    _library().fused_train_bwd_gemm_launches(-1)


def _check_cuda(what: str, tensors: dict, dtype: torch.dtype, dev: torch.device) -> None:
    for name, (ten, shape) in tensors.items():
        check_tensor(what, name, ten, dtype, shape, dev)


def mlp_front(xn2: torch.Tensor, wfc: torch.Tensor, dxb: torch.Tensor, wfc2: torch.Tensor):
    """The backward's MLP front alone (``mlp_front_kernel``, as
    ``train_backward`` runs it a layer and group): bf16 xn2, dxb [M, E], wfc
    [E, F], wfc2 [F, E], E and F multiples of 8 -> (hact, dh) bf16 [M, F].
    CPU tensors take :func:`mlp_front_reference`; CUDA tensors launch the
    kernel or raise."""
    if xn2.device.type == "cpu":
        return mlp_front_reference(xn2, wfc, dxb, wfc2)
    m, e = xn2.shape
    f = wfc.shape[-1]
    if e % 8 or f % 8:
        raise ValueError(f"mlp_front: E and F must be multiples of 8; got {e}, {f}")
    if xn2.device.type != "cuda":
        raise ValueError(f"mlp_front: no kernel for device {xn2.device}")
    dev = xn2.device
    _check_cuda("mlp_front", {"xn2": (xn2, (m, e)), "dxb": (dxb, (m, e)), "wfc": (wfc, (e, f)),
                              "wfc2": (wfc2, (f, e))}, torch.bfloat16, dev)
    h, d = (torch.empty((m, f), dtype=torch.bfloat16, device=dev) for _ in range(2))
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.fused_train_mlp_front(xn2.data_ptr(), dxb.data_ptr(), wfc.data_ptr(),
                                       wfc2.data_ptr(), h.data_ptr(), d.data_ptr(), m, e, f,
                                       torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "MLP front")
    return h, d


def ln_backward_dx(a: torch.Tensor, w: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                   dx: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor, el: int):
    """The backward's LN epilogue alone (``ln_dx_kernel``, as
    ``train_backward`` runs it twice a layer and group): bf16 a [M, K], w
    [E, K], x [M, E], fp32 g [E], dx [M, E], mu and rstd [M], E and K
    multiples of 8 and E at most 2048 (:func:`ln_route`) -> (dx updated in
    place by the LN backward of dy = a w^T, its bf16, the gain gradient
    [E]), the values of :func:`ln_backward_dx_reference`.  CPU tensors
    take that; CUDA tensors launch the kernel or raise."""
    if a.device.type == "cpu":
        new, dxb, dg = ln_backward_dx_reference(a, w, x, g, dx, mu, rstd, el)
        return dx.copy_(new), dxb, dg
    m, k = a.shape
    e = w.shape[0]
    if e % 8 or k % 8:
        raise ValueError(f"ln_backward_dx: E and K must be multiples of 8; got {e}, {k}")
    if ln_route(e) == "kernels":
        raise ValueError(f"ln_backward_dx: the LN epilogue takes n_embd up to "
                         f"{_LN_BN * _LN_MAX_RANKS}; got {e}")
    if not 1 <= el <= e:
        raise ValueError(f"ln_backward_dx: el must be from 1 to {e}; got {el}")
    if a.device.type != "cuda":
        raise ValueError(f"ln_backward_dx: no kernel for device {a.device}")
    dev = a.device
    _check_cuda("ln_backward_dx", {"a": (a, (m, k)), "w": (w, (e, k)), "x": (x, (m, e))},
                torch.bfloat16, dev)
    _check_cuda("ln_backward_dx", {"g": (g, (e,)), "dx": (dx, (m, e)), "mu": (mu, (m,)),
                                   "rstd": (rstd, (m,))}, torch.float32, dev)
    dxb = torch.empty((m, e), dtype=torch.bfloat16, device=dev)
    partial = torch.empty((-(-m // 128), e), dtype=torch.float32, device=dev)
    dg = torch.zeros(e, dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.fused_train_ln_dx(a.data_ptr(), w.data_ptr(), x.data_ptr(), g.data_ptr(),
                                   mu.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                                   dxb.data_ptr(), partial.data_ptr(), dg.data_ptr(), m, e, k,
                                   el, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "LN epilogue")
    return dx, dxb, dg


def _heads_nopad(what: str, qkv: torch.Tensor, n_head: int) -> tuple[int, int, int]:
    n, t, e3 = qkv.shape
    e = e3 // 3
    check_train_width(t, e, n_head)
    dh = e // n_head
    if dh > _D_TILE or padded_head_dim(dh) != dh:
        raise ValueError(f"{what}: heads of {dh} columns need padding")
    return n, t, e


def train_attention_reference(qkv: torch.Tensor, n_head: int):
    """Plain version of the kernels' attention forward with statistics:
    bf16 q|k|v [N, T, 3E] -> (att bf16 [N, T, E], m, l fp32 [N, H, T]): att
    as ``train_fwd_reference`` computes it, m = max(s) scale log2(e) and l =
    sum 2^(s scale log2(e) - m) per row."""
    n, t, e3 = qkv.shape
    e = e3 // 3
    p, q, k, v = _probs(qkv, n_head)
    att = _merge(_mm(p.to(torch.bfloat16), v).to(torch.bfloat16))
    x = _mm(q, k.transpose(-1, -2)) * (math.log2(math.e) / math.sqrt(e // n_head))
    m = x.amax(-1)
    return att, m, torch.exp2(x - m[..., None]).sum(-1)


def train_attention(qkv: torch.Tensor, n_head: int):
    """The kernels' attention forward alone, as the backward's recompute runs
    it: bf16 q|k|v [N, T, 3E] -> (att [N, T, E], m, l [N, H, T]).  Heads
    must need no padding.  CPU tensors take
    :func:`train_attention_reference`; CUDA tensors launch the kernel or
    raise."""
    if qkv.device.type == "cpu":
        return train_attention_reference(qkv, n_head)
    n, t, e = _heads_nopad("train_attention", qkv, n_head)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_train: no kernel for device {qkv.device}")
    check_tensor("train_attention", "qkv", qkv, torch.bfloat16, (n, t, 3 * e), qkv.device)
    att = torch.empty((n, t, e), dtype=torch.bfloat16, device=qkv.device)
    m, l = (torch.empty((n, n_head, t), dtype=torch.float32, device=qkv.device)
            for _ in range(2))
    lib = _library()
    with torch.cuda.device(qkv.device):
        rc = lib.fused_train_attention_fwd(
            qkv.data_ptr(), att.data_ptr(), m.data_ptr(), l.data_ptr(), n, t, e, n_head,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    _raise_on(lib, rc, "attention forward")
    return att, m, l


def train_attention_backward_reference(qkv: torch.Tensor, datt: torch.Tensor,
                                       n_head: int) -> torch.Tensor:
    """Plain version of the kernels' attention backward: bf16 q|k|v [N, T,
    3E] and the attention's gradient datt [N, T, E] -> dq|dk|dv bf16 [N, T,
    3E], as ``train_bwd_reference`` computes them (p fp32 from q|k|v, delta
    the sum over the keys of dp * p)."""
    p, q, k, v = _probs(qkv, n_head)
    scale = 1.0 / math.sqrt(qkv.shape[-1] // 3 // n_head)
    pb = p.to(torch.bfloat16)
    da = _heads(datt, n_head)
    dv = _mm(pb.transpose(-1, -2), da).to(torch.bfloat16)
    dp = _mm(da, v.transpose(-1, -2))
    ds = ((dp - (dp * p).sum(-1, keepdim=True)) * p * scale).to(torch.bfloat16)
    dq = _mm(ds, k).to(torch.bfloat16)
    dk = _mm(ds.transpose(-1, -2), q).to(torch.bfloat16)
    return torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)


def train_attention_backward(qkv: torch.Tensor, datt: torch.Tensor, att: torch.Tensor,
                             m: torch.Tensor, l: torch.Tensor, n_head: int, sides: int = 3,
                             scratch: torch.Tensor | None = None) -> torch.Tensor:
    """The kernels' attention backward alone (as ``train_backward`` runs it):
    bf16 q|k|v [N, T, 3E], datt and the forward's att [N, T, E], its
    statistics m, l [N, H, T] (:func:`train_attention`) -> dq|dk|dv [N, T,
    3E].  `sides` (the wgmma route): 1 the query side, 2 the key side (which
    reads what the query side left in `scratch`), 3 both.  CPU tensors take
    :func:`train_attention_backward_reference`; CUDA tensors launch the
    kernels or raise."""
    if qkv.device.type == "cpu":
        return train_attention_backward_reference(qkv, datt, n_head)
    n, t, e = _heads_nopad("train_attention_backward", qkv, n_head)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_train: no kernel for device {qkv.device}")
    dev = qkv.device
    check_tensor("train_attention_backward", "qkv", qkv, torch.bfloat16, (n, t, 3 * e), dev)
    for name, ten in (("datt", datt), ("att", att)):
        check_tensor("train_attention_backward", name, ten, torch.bfloat16, (n, t, e), dev)
    for name, ten in (("m", m), ("l", l)):
        check_tensor("train_attention_backward", name, ten, torch.float32, (n, n_head, t), dev)
    lib = _library()
    if scratch is None:
        scratch = torch.empty(lib.fused_train_attention_scratch(n, t, e, n_head),
                              dtype=torch.float32, device=dev)
    dqkv = torch.empty((n, t, 3 * e), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fused_train_attention_bwd(
            qkv.data_ptr(), datt.data_ptr(), att.data_ptr(), m.data_ptr(), l.data_ptr(),
            scratch.data_ptr(), dqkv.data_ptr(), n, t, e, n_head, sides,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, rc, "attention backward")
    return dqkv


def gemm_tile(a: torch.Tensor, b: torch.Tensor, a_mn: bool = False, b_k: bool = False,
              splits: int = 0, gelu: bool = False) -> torch.Tensor:
    """The layer kernels' shared GEMM (``csrc/gemm_tile.cuh``) alone, for its
    checks and its timing beside cuBLAS; on no path of the port.  bf16 CUDA
    tensors a, stored [M, K] or, with a_mn, [K, M], and b, stored [K, N] or,
    with b_k, [N, K] -> op(a) op(b) [M, N] in bf16 (with gelu, the
    forward's tanh-GELU epilogue on it), or, with splits > 0, the fp32
    partial products of the K range split that many ways [splits, M, N]
    (their sum is the product)."""
    if gelu and splits:
        raise ValueError("gemm_tile: the GELU epilogue writes one bf16 product, not splits")
    m, k = a.shape[::-1] if a_mn else a.shape
    n = b.shape[0] if b_k else b.shape[1]
    for name, ten in (("a", a), ("b", b)):
        if ten.dtype != torch.bfloat16 or ten.device.type != "cuda" or not ten.is_contiguous():
            raise ValueError(f"gemm_tile: {name} must be a contiguous bf16 CUDA tensor")
    if (b.shape[1] if b_k else b.shape[0]) != k:
        raise ValueError(f"gemm_tile: depths differ, {tuple(a.shape)} and {tuple(b.shape)}")
    out = torch.empty((splits, m, n) if splits else (m, n),
                      dtype=torch.float32 if splits else torch.bfloat16, device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        rc = lib.fused_train_gemm(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, int(a_mn),
                                  int(b_k), 2 if gelu else int(splits > 0), max(splits, 1),
                                  torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(lib, rc, "gemm")
    return out


class FusedBlocksTrain(torch.autograd.Function):
    """bf16 embeddings x [N, T, E] -> last-position activations [N, E] bf16,
    with the backward through the kernels (the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, n_head, bwd_lpc, wqkv, wproj, wfc, wfc2, g1, g2):
        stacks = TrainStacks(wqkv, wproj, wfc, wfc2, g1, g2, n_head)
        xl, xsave = train_forward(x, stacks, last_only=True)
        ctx.save_for_backward(xsave, *stacks[:6])
        ctx.n_head, ctx.bwd_lpc = n_head, bwd_lpc
        return xl

    @staticmethod
    def backward(ctx, dxl):
        xsave, *tensors = ctx.saved_tensors
        stacks = TrainStacks(*tensors, n_head=ctx.n_head)
        layers = stacks.wqkv.shape[0]
        _, n, t, e = xsave.shape
        # the loss reads the last position only
        dx = torch.zeros((n, t, e), dtype=torch.bfloat16, device=xsave.device)
        dx[:, -1] = dxl.to(torch.bfloat16)
        chunk_grads = []
        for lo in reversed(range(0, layers, ctx.bwd_lpc)):
            hi = min(lo + ctx.bwd_lpc, layers)
            dx, grads = train_backward(xsave[2 * lo:2 * hi], dx, stacks.chunk(lo, hi))
            chunk_grads.append(grads)
        bottom_up = chunk_grads[::-1]
        dstacks = tuple(torch.cat([g[k] for g in bottom_up]).to(stacks[k].dtype)
                        for k in range(6))
        return (dx, None, None) + dstacks


def fused_loss_fn(model, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``train_step.loss_fn`` through the kernels: tokens int [B, T],
    targets int [B] -> mean cross-entropy at the last position,
    differentiable with respect to the model's parameters."""
    cfg = model.cfg
    if cfg.bias or cfg.dropout != 0.0:
        raise ValueError("fused_loss_fn: bias-free, dropout-0 configs only")
    tr = model.transformer
    wte = tr.wte.weight
    t = tokens.shape[1]
    # F.embedding, not wte[ids]: its backward sums the rows of a repeated id
    # in segments, where indexing's serialises them (training contexts
    # repeat a few ids many times)
    x = (F.embedding(jax_index(tokens, wte.shape[0]), wte) + tr.wpe.weight[:t]
         ).to(torch.bfloat16)
    stacks = build_train_stacks(model)
    xl = FusedBlocksTrain.apply(x, cfg.n_head, _bwd_layers_per_call(cfg), *stacks[:6])
    logits = ln_f32(xl.float(), tr.ln_f.weight) @ wte.float().T
    return F.cross_entropy(logits, targets.long())
