"""Fused GPT inference forward: tokens [N, T] -> last-position logits.

Port of ``mapf_gpt_tpu/ops/fused_gpt.py``'s ``fused_logits`` and its two
routes, chosen as the JAX package chooses them
(:func:`default_layers_per_call`):

- the e2e route (2M, 6M; all layers' weights fit one call): embedding, all
  layers, final LN and head in one kernel, ``_e2e_kernel``'s counterpart
  ``csrc/fused_gpt.cu``;
- the chunked route (85M): the embedding and the head in plain PyTorch (the
  JAX package leaves them to XLA), the layers through
  ``ops/fused_blocks.py`` (``_block_kernel``'s counterpart).  The two
  routes round differently, as in the JAX package: the e2e embedding adds
  the bf16 tables (an id outside the vocabulary embeds as wpe alone, as the
  TPU kernel's one-hot product gives) and its head reads the bf16-rounded
  wte; the chunked embedding adds the fp32 tables before rounding (an id
  outside the vocabulary is read as JAX indexing reads it: a negative id
  wraps once, then ids are clamped to the table) and its head reads the
  fp32 wte.

Which kernel runs a route on CUDA is the card's choice (:func:`cuda_plan`),
and the width is built on first use: the e2e route runs on the e2e kernel
where its constraints hold (:func:`e2e_unfit`: T from 1 to 256, any number
of heads with head dims multiples of 16 from 16 to 128, n_embd up to 256;
the 2M's and 6M's widths come from the source as it stands, any other from
``-DFUSED_GPT_E/H``), and otherwise as the same
function in three steps: the plain e2e embedding, the layer-stack kernel
over all layers with the last thinned, the plain e2e head.  The layer-stack
kernel takes any T >= 1, head dims 1 to 128 and n_embd a multiple of 8
(:func:`fused_blocks.check_width`); a width neither kernel can hold raises
``ValueError`` before ``nvcc`` starts.

- :func:`stack_weights` stacks a model's weights into the kernels' layout:
  bf16 [L, in, out] matrices with the attention scale and log2(e) folded
  into the W_q columns, fp32 LN gains, the bf16 and fp32 embedding tables
  and the e2e head as fp32 [E, vocab] of the bf16-rounded token embedding.
- :func:`fused_logits_reference` is the plain PyTorch version of either
  route; the CPU tests and ``chip_smoke.py``'s comparisons use it.
- :func:`fused_logits` is the wrapper: CPU tensors take the plain version;
  CUDA tensors launch the e2e kernel (one launch per call) or, on the
  chunked route, the layer-stack kernel (one launch per call, all layers),
  or raise.  ``launches`` counts the e2e kernel's launches;
  ``fused_blocks.launches`` the layer-stack kernel's.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple

import torch

from mapf_gpt_tpu_torch.ops import fused_blocks
from mapf_gpt_tpu_torch.ops.fused_blocks import (LayerStacks, blocks_reference, check_tensor,
                                                 ln_f32)

_LOG2E = math.log2(math.e)

launches = 0   # e2e kernel launches by fused_logits; callers may reset it to 0


class FusedWeights(NamedTuple):
    wte: torch.Tensor     # bf16 [V, E]
    wpe: torch.Tensor     # bf16 [T, E]
    wht: torch.Tensor     # f32 [E, V] e2e head (bf16-rounded wte, transposed)
    wte32: torch.Tensor   # f32 [V, E] chunked route's embedding and head
    wpe32: torch.Tensor   # f32 [T, E]
    wqkv: torch.Tensor    # bf16 [L, E, 3E], W_q columns pre-scaled
    wproj: torch.Tensor   # bf16 [L, E, E]
    wfc: torch.Tensor     # bf16 [L, E, 4E]
    wfc2: torch.Tensor    # bf16 [L, 4E, E]
    g1: torch.Tensor      # f32 [L, E]
    g2: torch.Tensor      # f32 [L, E]
    gf: torch.Tensor      # f32 [E]
    n_head: int

    def stacks(self) -> LayerStacks:
        return LayerStacks(self.wqkv, self.wproj, self.wfc, self.wfc2, self.g1, self.g2,
                           self.n_head)


def stack_weights(model) -> FusedWeights:
    """Stack a :class:`models.gpt.GPT`'s weights into the kernels' layout,
    on the model's device."""
    cfg = model.cfg
    e = cfg.n_embd
    blocks = model.transformer.h
    kernel = lambda lin: lin.weight.detach().float().T        # [in, out]
    wqkv = torch.stack([kernel(b.attn.c_attn) for b in blocks])
    fold = (1.0 / math.sqrt(e // cfg.n_head)) * _LOG2E
    wqkv[:, :, :e] *= fold
    wte32 = model.transformer.wte.weight.detach().float().contiguous()
    wpe32 = model.transformer.wpe.weight.detach().float().contiguous()
    wte = wte32.to(torch.bfloat16)
    bf = lambda ts: torch.stack(ts).to(torch.bfloat16).contiguous()
    return FusedWeights(
        wte=wte,
        wpe=wpe32.to(torch.bfloat16),
        wht=wte.float().T.contiguous(),
        wte32=wte32,
        wpe32=wpe32,
        wqkv=wqkv.to(torch.bfloat16).contiguous(),
        wproj=bf([kernel(b.attn.c_proj) for b in blocks]),
        wfc=bf([kernel(b.mlp.c_fc) for b in blocks]),
        wfc2=bf([kernel(b.mlp.c_proj) for b in blocks]),
        g1=torch.stack([b.ln_1.weight.detach().float() for b in blocks]).contiguous(),
        g2=torch.stack([b.ln_2.weight.detach().float() for b in blocks]).contiguous(),
        gf=model.transformer.ln_f.weight.detach().float().contiguous(),
        n_head=cfg.n_head,
    )


def default_layers_per_call(n_embd: int, n_layer: int) -> int:
    """Layers per kernel call in the JAX package: all while the stacked
    weights fit its VMEM budget (2M, 6M), chunks otherwise (85M: 3)."""
    per_layer_bytes = 2 * (n_embd * 3 * n_embd + n_embd ** 2 + 8 * n_embd ** 2)
    budget = 48 * 2 ** 20
    return max(1, min(n_layer, budget // per_layer_bytes))


def _route(e: int, layers: int) -> str:
    """The JAX package's route: "e2e" (one call) or "chunked"."""
    return "e2e" if default_layers_per_call(e, layers) >= layers else "chunked"


def _e2e_reference(w: FusedWeights, tokens: torch.Tensor,
                   blocks: Callable = blocks_reference) -> torch.Tensor:
    """The e2e route: bf16 embedding (an id outside [0, vocab) embeds as wpe
    alone), `blocks` over all layers with the last thinned, the head on the
    bf16-rounded wte."""
    t = tokens.shape[1]
    tok = tokens.long()
    valid = (tok >= 0) & (tok < w.wte.shape[0])
    emb = torch.where(valid[..., None], w.wte[tok.clamp(0, w.wte.shape[0] - 1)].float(), 0.0)
    x = (emb + w.wpe[:t].float()).to(torch.bfloat16)  # [N, T, E]
    x = blocks(x, w.stacks(), True)
    return ln_f32(x[:, -1].float(), w.gf) @ w.wht


def jax_index(tokens: torch.Tensor, size: int) -> torch.Tensor:
    """Row ids as JAX's ``table[tokens]`` reads them: a negative id wraps
    once, then every id is clamped to [0, size)."""
    tok = tokens.long()
    return torch.where(tok < 0, tok + size, tok).clamp(0, size - 1)


def chunked_logits(w: FusedWeights, tokens: torch.Tensor, layers_per_call: int,
                   blocks: Callable = blocks_reference) -> torch.Tensor:
    """The chunked route: plain embedding, `blocks` over chunks of
    `layers_per_call` layers (the last chunk thinned), plain head."""
    t = tokens.shape[1]
    layers = w.wqkv.shape[0]
    x = (w.wte32[jax_index(tokens, w.wte32.shape[0])] + w.wpe32[:t]).to(torch.bfloat16)
    stacks = w.stacks()
    for lo in range(0, layers, layers_per_call):
        hi = min(lo + layers_per_call, layers)
        x = blocks(x, stacks.chunk(lo, hi), hi == layers)
    return ln_f32(x[:, 0].float(), w.gf) @ w.wte32.T


def fused_logits_reference(w: FusedWeights, tokens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_logits`, on any device: tokens
    int [N, T] -> fp32 logits [N, vocab] at the last position."""
    layers, e, _ = w.wqkv.shape
    if _route(e, layers) == "e2e":
        return _e2e_reference(w, tokens)
    return chunked_logits(w, tokens, default_layers_per_call(e, layers))


_DEFAULT_WIDTHS = ((160, 5), (256, 8))   # built by the source with no defines (2M, 6M)
_TMAX = 256                               # the e2e kernel's longest T
_MAX_E2E_EMBD = 256                       # fc2 sums of 16 rows x E: E / 2 registers a lane


def e2e_unfit(e: int, n_head: int, t: int = _TMAX) -> str | None:
    """Why the e2e kernel cannot take this shape, or None where it can: the
    shape rules of ``Fwd``'s static_asserts in csrc/fused_gpt.cu (T from 1
    to 256, head dims multiples of 16 from 16 to 128, n_embd up to 256).
    Its shared-memory budget holds at every width these admit; the
    static_asserts own it."""
    if not 1 <= t <= _TMAX:
        return f"T={t} is outside 1..{_TMAX}"
    if n_head <= 0 or e % n_head:
        return f"n_embd={e} is not a multiple of {n_head} heads"
    dh = e // n_head
    if dh % 16 or not 16 <= dh <= 128:
        return f"head dim {dh} is not a multiple of 16 from 16 to 128"
    if e > _MAX_E2E_EMBD:
        return (f"n_embd={e} > {_MAX_E2E_EMBD}: the fc2 sums of 16 rows take "
                "n_embd / 2 registers a lane")
    return None


def e2e_defines(e: int, n_head: int) -> dict[str, int]:
    """The -D defines that build the e2e kernel for this width (none for the
    2M's and 6M's)."""
    if (e, n_head) in _DEFAULT_WIDTHS:
        return {}
    why = e2e_unfit(e, n_head)
    if why is not None:
        raise ValueError(f"fused_gpt: the e2e kernel cannot hold n_embd={e}, {n_head} heads: "
                         f"{why}")
    return {"FUSED_GPT_E": e, "FUSED_GPT_H": n_head}


def cuda_plan(e: int, n_head: int, layers: int, t: int = _TMAX) -> tuple[str, str]:
    """(route, kernel) that :func:`fused_logits` takes on CUDA for this
    shape, without building anything: route "e2e" or "chunked" (the JAX
    package's choice), kernel "fused_gpt" (the e2e kernel) or
    "fused_blocks" (the layer-stack kernel).  Raises ValueError, naming the
    constraint, for a shape neither kernel can hold."""
    route = _route(e, layers)
    why = e2e_unfit(e, n_head, t) if route == "e2e" else None
    if route == "e2e" and why is None:
        return route, "fused_gpt"
    try:
        fused_blocks.check_width(t, e, n_head)
    except ValueError as err:
        e2e = f"the e2e kernel cannot: {why}; " if why else ""
        raise ValueError(f"fused_gpt: no kernel for n_embd={e}, {n_head} heads, T={t} "
                         f"on the {route} route: {e2e}{err}") from None
    return route, "fused_blocks"


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from csrc/fused_gpt.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_gpt_config.argtypes = [i] + [ctypes.POINTER(i)] * 6
    lib.fused_gpt_config.restype = i
    lib.fused_gpt_forward.argtypes = [i, i] + [p] * 14 + [i] * 5 + [p]
    lib.fused_gpt_forward.restype = i
    lib.fused_gpt_weight_maps.argtypes = [i, i] + [p] * 5
    lib.fused_gpt_weight_maps.restype = i
    lib.fused_gpt_weight_maps_bytes.argtypes = []
    lib.fused_gpt_weight_maps_bytes.restype = i
    lib.fused_gpt_error_string.argtypes = [i]
    lib.fused_gpt_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library(e: int = 160, n_head: int = 5) -> ctypes.CDLL:
    """The kernel's library holding this width, built on first use."""
    from mapf_gpt_tpu_torch.ops import _build

    return bind(_build.load("fused_gpt", e2e_defines(e, n_head)))


@functools.cache
def kernel_config(e: int = 160, n_head: int = 5) -> dict[tuple[int, int], dict[str, int]]:
    """The widths of the library that holds (e, n_head), (n_embd, n_head) ->
    its shape constants (builds it if needed)."""
    lib = _library(e, n_head)
    built = {}
    for i in range(16):
        vals = [ctypes.c_int() for _ in range(6)]
        if lib.fused_gpt_config(i, *[ctypes.byref(v) for v in vals]):
            break
        cfg = dict(zip(("t", "e", "h", "max_vocab", "smem_bytes", "ws_elems"),
                       (v.value for v in vals)))
        built[(cfg["e"], cfg["h"])] = cfg
    return built


_weight_maps_cache: dict[tuple, ctypes.Array] = {}


def weight_maps(lib: ctypes.CDLL, w: FusedWeights) -> ctypes.Array:
    """The TMA tensor maps of w's four weight stacks, built by the library
    once per set of weights: a map holds only the addresses, shapes and
    boxes, so the key (library, addresses, width, layers) names it."""
    layers, e, _ = w.wqkv.shape
    key = (id(lib), e, layers, w.wqkv.data_ptr(), w.wproj.data_ptr(), w.wfc.data_ptr(),
           w.wfc2.data_ptr())
    maps = _weight_maps_cache.get(key)
    if maps is None:
        maps = ctypes.create_string_buffer(lib.fused_gpt_weight_maps_bytes())
        rc = lib.fused_gpt_weight_maps(e, layers, w.wqkv.data_ptr(), w.wproj.data_ptr(),
                                       w.wfc.data_ptr(), w.wfc2.data_ptr(), maps)
        if rc != 0:
            raise RuntimeError("fused_gpt: the weights' tensor maps failed: "
                               f"{lib.fused_gpt_error_string(rc).decode()} ({rc})")
        _weight_maps_cache[key] = maps
    return maps


def _e2e_kernel(w: FusedWeights, tokens: torch.Tensor) -> torch.Tensor:
    global launches
    n, t = tokens.shape
    layers, e, _ = w.wqkv.shape
    lib = _library(e, w.n_head)
    cfg = kernel_config(e, w.n_head).get((e, w.n_head))
    if cfg is None or not 1 <= t <= cfg["t"]:
        raise ValueError(
            f"fused_gpt: the library is built for T in 1..{_TMAX} and (n_embd, n_head) in "
            f"{sorted(kernel_config(e, w.n_head))}; got T={t}, n_embd={e}, {w.n_head} heads")
    vocab = w.wte.shape[0]
    if vocab > cfg["max_vocab"]:
        raise ValueError(f"fused_gpt: vocab {vocab} > {cfg['max_vocab']}")
    dev = tokens.device
    tokens = tokens.to(torch.int32).contiguous()
    f = 4 * e
    for name, ten, dtype, shape in (
            ("wte", w.wte, torch.bfloat16, (vocab, e)),
            ("wpe", w.wpe, torch.bfloat16, (w.wpe.shape[0], e)),
            ("wht", w.wht, torch.float32, (e, vocab)),
            ("wqkv", w.wqkv, torch.bfloat16, (layers, e, 3 * e)),
            ("wproj", w.wproj, torch.bfloat16, (layers, e, e)),
            ("wfc", w.wfc, torch.bfloat16, (layers, e, f)),
            ("wfc2", w.wfc2, torch.bfloat16, (layers, f, e)),
            ("g1", w.g1, torch.float32, (layers, e)),
            ("g2", w.g2, torch.float32, (layers, e)),
            ("gf", w.gf, torch.float32, (e,))):
        check_tensor("fused_gpt", name, ten, dtype, shape, dev)
    if w.wpe.shape[0] < t:
        raise ValueError(f"fused_gpt: wpe has {w.wpe.shape[0]} positions < T={t}")
    out = torch.empty((n, vocab), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    grid = min(n, torch.cuda.get_device_properties(dev).multi_processor_count)
    workspace = torch.empty((grid, cfg["ws_elems"]), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        maps = weight_maps(lib, w)
        rc = lib.fused_gpt_forward(
            e, w.n_head, maps, tokens.data_ptr(), w.wte.data_ptr(), w.wpe.data_ptr(),
            w.wht.data_ptr(), w.wqkv.data_ptr(), w.wproj.data_ptr(), w.wfc.data_ptr(),
            w.wfc2.data_ptr(), w.g1.data_ptr(), w.g2.data_ptr(), w.gf.data_ptr(),
            out.data_ptr(), workspace.data_ptr(), n, t, layers, vocab, grid, stream)
    if rc != 0:
        raise RuntimeError("fused_gpt kernel launch failed: "
                           f"{lib.fused_gpt_error_string(rc).decode()} ({rc})")
    launches += 1
    return out


def fused_logits(w: FusedWeights, tokens: torch.Tensor) -> torch.Tensor:
    """tokens int [N, T] -> fp32 logits [N, vocab] at the last position.

    The route is the JAX package's: e2e when :func:`default_layers_per_call`
    covers every layer, chunked otherwise.  CPU tensors take
    :func:`fused_logits_reference`; CUDA tensors launch the kernel
    :func:`cuda_plan` names: the e2e kernel, or the layer-stack kernel once
    over all layers (on the GPU the chunk size does not change the result:
    x is bf16 at every layer boundary), or raise."""
    if tokens.device.type == "cpu":
        return fused_logits_reference(w, tokens)
    if tokens.device.type != "cuda":
        raise ValueError(f"fused_gpt: no kernel for device {tokens.device}")
    layers, e, _ = w.wqkv.shape
    route, kernel = cuda_plan(e, w.n_head, layers, tokens.shape[1])
    if kernel == "fused_gpt":
        return _e2e_kernel(w, tokens)
    if route == "e2e":
        return _e2e_reference(w, tokens, fused_blocks.fused_blocks)
    return chunked_logits(w, tokens, layers, fused_blocks.fused_blocks)
