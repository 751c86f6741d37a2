"""The yardstick's arithmetic, frozen with the benchmark: the card's peaks, the
operations and bytes of the policy's forward and of a training micro-batch,
counted from shapes, and the least time they need.

The counts are those of the program's ``chip_smoke.py`` (``layer_ops``,
``train_ops``, ``bound``, ``e2e_bound``, ``blocks_bound``, ``train_bounds``),
copied here so that later changes to the program cannot move them, and taken
from a configuration's sizes instead of the program's weight tensors.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, without sparsity (NVIDIA's data sheet, at 700 W)
PEAK_BF16 = 989e12               # FLOP/s on the tensor cores, bf16 and fp16
PEAK_FP32 = 67e12                # FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def layer_ops(t: int, e: int, h: int, layers: int, last_only: bool) -> tuple[int, int]:
    """(bf16 product FLOP, fp32 exp2 count) of a layer stack on one context,
    the final layer thinned to one query row when last_only."""
    f = 4 * e
    full = 2 * t * e * 3 * e + 2 * 2 * t * t * e + 2 * t * e * e + 2 * 2 * t * e * f
    last = 2 * t * e * 2 * e + 2 * e * e + 2 * 2 * t * e + 2 * e * e + 2 * 2 * e * f
    if not last_only:
        return layers * full, layers * h * t * t
    return (layers - 1) * full + last, (layers - 1) * h * t * t + h * t


def train_ops(t: int, e: int, h: int, layers: int, last_only: bool, backward: bool
              ) -> tuple[int, int]:
    """(bf16 product FLOP, exp count) of a training chunk on one context.

    Forward, a layer: q|k|v 6TE^2, scores and P@V 4T^2E, projection 2TE^2,
    MLP 16TE^2 (for the last row alone in a last_only chunk's final layer).
    Backward, a layer (recompute included): q|k|v, attention and fc
    recomputed 14TE^2 + 4T^2E, dX and dW of the five products 48TE^2, the
    four attention-backward products 8T^2E.  One exp per score a layer."""
    if backward:
        return layers * (62 * t * e * e + 12 * t * t * e), layers * h * t * t
    attn = 8 * t * e * e + 4 * t * t * e
    ops = layers * (attn + 16 * t * e * e)
    if last_only:
        ops -= 16 * t * e * e - 16 * e * e
    return ops, layers * h * t * t


def bound(bf16_ops: float, fp32_ops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) for this work on the card, and what bounds it."""
    t_ops = bf16_ops / PEAK_BF16 + fp32_ops / PEAK_FP32
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _stack_bytes(cfg: dict) -> int:
    """The layer stacks as the kernels read them: bf16 products, fp32 gains."""
    e, layers = cfg["n_embd"], cfg["n_layer"]
    return layers * (2 * (3 * e * e + e * e + 4 * e * e + 4 * e * e) + 4 * 2 * e)


def e2e_bound(cfg: dict, n: int) -> tuple[float, str]:
    """Least time (ms) of the e2e kernel's forward on n contexts: the bf16
    products (last layer thinned to one query row) at the tensor rate, the fp32
    head and one exp2 a score at the fp32 rate; tokens and the weights read
    once, logits written once."""
    t, e, v, h = cfg["block_size"], cfg["n_embd"], cfg["vocab_size"], cfg["n_head"]
    prod, exps = layer_ops(t, e, h, cfg["n_layer"], last_only=True)
    io_bytes = n * t * 4 + n * v * 4
    weights = 2 * v * e + 2 * t * e + 4 * e * v + _stack_bytes(cfg) + 4 * e
    return bound(n * prod, n * (exps + 2 * e * v), weights + io_bytes)


def blocks_bound(cfg: dict, n: int, last_only: bool = True) -> tuple[float, str]:
    """Least time (ms) of the layer-stack kernels on n contexts: their bf16
    products and exp2s, against x read once, the output written once and the
    weights read once."""
    t, e, h = cfg["block_size"], cfg["n_embd"], cfg["n_head"]
    prod, exps = layer_ops(t, e, h, cfg["n_layer"], last_only)
    io_bytes = n * t * e * 2 + n * (1 if last_only else t) * e * 2
    return bound(n * prod, n * exps, _stack_bytes(cfg) + io_bytes)


def train_bounds(cfg: dict, n: int) -> tuple[tuple[float, str], tuple[float, str]]:
    """(forward, backward) least times (ms) of the training kernels on a
    micro-batch of n contexts, last position out: x read, out and the saved
    streams written; the saves read once, the top gradient and the backward
    chunks' dx in and out, weights, fp32 gradients."""
    t, e, h, layers = cfg["block_size"], cfg["n_embd"], cfg["n_head"], cfg["n_layer"]
    weights = _stack_bytes(cfg)
    chunks = -(-layers // (2 if e <= 384 else 1))     # the backward's calls: 2 layers, 1 past 384
    stream = n * t * e * 2
    ops, exps = train_ops(t, e, h, layers, True, False)
    fwd = bound(n * ops, n * exps, stream + 2 * layers * stream + n * e * 2 + weights)
    ops, exps = train_ops(t, e, h, layers, True, True)
    grads = 4 * layers * (3 * e * e + e * e + 4 * e * e + 4 * e * e + 2 * e)
    bwd = bound(n * ops, n * exps, 2 * layers * stream + 2 * chunks * stream + weights + grads)
    return fwd, bwd


def forward_model_flops(cfg: dict) -> int:
    """The products one context's policy forward needs: the layers with the
    final one thinned to the last position, and the head at that position."""
    t, e, h, v = cfg["block_size"], cfg["n_embd"], cfg["n_head"], cfg["vocab_size"]
    return layer_ops(t, e, h, cfg["n_layer"], last_only=True)[0] + 2 * e * v


def train_model_flops(cfg: dict) -> int:
    """The products one sample of a last-token loss needs: the thinned forward
    and head, and a backward of twice that (dX and dW of every product; no
    recompute)."""
    return 3 * forward_model_flops(cfg)


def kernel_key(name: str) -> str:
    """A kernel's qualified name from the demangled name the profiler records,
    without its return type, template arguments, parameters and anonymous
    namespaces: ``void gemm::gemm_kernel<...>(...)`` gives ``gemm::gemm_kernel``,
    ``void (anonymous namespace)::ln_kernel(...)`` gives ``ln_kernel``."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].strip()
    return head.split()[-1] if head else name
