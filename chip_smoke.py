#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mapf_gpt_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Drives the port's main path, the batched rollout, for each published model
(2M, 6M, 85M) and for a ``bias=True`` model on the module route through
the attention kernel, and the 6M trainer, through the entry points a user
calls, and holds every CUDA kernel of those paths against its plain
PyTorch version.  Phases, one line each (flushed); phase 12 runs right
after phase 2, so that a faulty attention kernel fails within seconds:

1. device: the card's name and power limit (nvidia-smi) and torch's CUDA.
2. build: every kernel source under ``mapf_gpt_tpu_torch/csrc``, and the
   widths of phase 8, one nvcc each, all started together; build seconds
   and ptxas' register report.
3. 2M kernel vs plain version: the trained 2M
   (``checkpoints/MAPF-GPT-2M-r4.pt``) at full width on 512 contexts,
   random tokens from ``--seed`` and the real tokens of a reset batch.
   Logits within atol 0.02 * max|ref| + 0.02 and argmax agreement over the
   5 action logits >= 95 % (the tolerances of ``tests/test_fused_gpt.py``);
   then 300 random contexts (not a multiple of the grid) cut to T = 200.
4. 2M rollout: 16 envs x 32 agents x 64 steps on ``random_grid(21, 0.3, s)``
   maps, argmax actions.  Every agent on a free cell, positions unique per
   env, metrics in range, and the e2e kernel's launch counter exactly one
   per step (the layer-stack and attention kernels' 0).  Prints CSR, ISR,
   SoC and env-steps/s.
5. 2M timing: the kernel on the rollout's 512 contexts beside a whole
   rollout step and its bound; then one forward at 8192 contexts (the
   rollout benchmark's 256 envs x 32 agents), kernel and plain version,
   beside the card's bound.
6. 6M: phases 3-5 for the trained 6M (``checkpoints/MAPF-GPT-6M-r5.pt``,
   E=256) through the same e2e kernel: 512 contexts compared, T = 200, the
   same 16 x 32 x 64 rollout, timing at 512 and 8192 contexts.  Then the
   e2e kernel at the shapes it takes beyond the 2M's and 6M's
   (``E2E_SHAPES``: head dims 16, 64 and 128, 12 heads, T = 130 and 1,
   n_embd 144), random weights, 300 contexts each, phase 3's tolerances,
   its counter exactly one a forward; the last shape (head dim 128, T =
   130) with the layers' matrices scaled 3x, so that the layers and not
   the embedding set the logits.
7. 85M at full width and depth (12L/12H/768d), weights from
   ``models.gpt.init_params`` under ``--seed``, on the chunked route (plain
   embedding and head, the layer-stack kernel): 128 contexts compared with
   the plain route, random and reset-batch tokens, and 300 random contexts
   (a group of 256 and one of 44, whose thinned layer fills part of a row
   tile), same tolerances; one
   3-layer chunk of the layer-stack kernel alone against
   ``blocks_reference`` (stream within atol 0.02 * max|ref|); a 4 x 32 x 32
   rollout with the layer-stack counter exactly one per step and the e2e
   counter 0; timing at 2048 contexts (the JAX harness's 85M cap).
8. Widths built on demand: eight widths no published model has, random
   weights from ``init_params``, 64 contexts each against
   ``fused_logits_reference`` with phase 3's tolerances: E=192/6 heads/4
   layers, 160/10 and 256/16 (head dim 16) on the e2e route and kernel
   (built with -D defines), E=384/6/8 (e2e route on the layer-stack kernel:
   n_embd past the e2e kernel's 256), E=512/8/12 (chunked route), and on
   the layer-stack kernel the widths its N-tile mask and head dims of 16 to
   128 admit: E=320/10 (n_embd not a multiple of 128), 384/4 (head dim 96),
   4 layers each, and 512/32/12 (head dim 16, chunked route); each kernel's
   counter exactly one.  Each width's whole forward timed at 2048 contexts
   beside its plain version and its bound.
9. Training kernels (``csrc/fused_train.cu``) against their plain versions
   on the reset batch's tokens: the trained 2M on 512 contexts (two groups
   of 256) and the 6M on 300 (a group of 256 and one of 44), at full width
   and depth (forward over all layers: ``out`` and ``xsave`` within
   0.02 * max|ref| + 0.02, the max taken per channel and, for ``xsave``,
   per save, so that the residual stream's outlier channels set no other
   channel's tolerance; backward in 2-layer chunks: dx and the six
   gradients each within 0.08 * max|ref| + 1e-4, the tolerances of
   ``tests/test_fused_gpt.py`` and ``tests/test_fused_gpt_train.py``), and
   the 85M's width (E=768, 12 heads), head dim 16 (E=256, 16 heads), head
   dim 96 (E=384, 4 heads) and T=200 (the 6M's width; T needs no longer
   be a multiple of 64) on a 2-layer forward and a 1-layer backward chunk
   each; a second backward launch must equal the first bit for bit.
10. The trainer through its entry point: ``train.loop.train`` with
   ``--model 6M --device cuda``, batch 256, grad-accum 2, 20 iterations,
   eval every 10, on shards written here with ``write_arrow_shard``: the
   tokens the tokenizer makes on the reset instances stepped with the
   trained 6M's argmax actions, and those actions as targets.  The
   training kernels' counters, set to 0 just before, must read one forward
   per micro-batch and four backward chunks per micro-batch; every loss
   finite; the last logged loss below the first by ``LOSS_DROP``; the
   newest checkpoint loads with ``load_reference_checkpoint`` and drives
   one rollout step through the e2e kernel.
11. Training timing: one forward + backward of the 6M at the reference
   micro-batch of 2048 contexts, the kernels alone and the whole
   ``fused_loss_fn`` + backward, beside the plain versions and the bound;
   the trainer's it/s and MFU.
12. The attention kernel (``csrc/attention.cu``, for ``attn_impl="pallas"``)
   against its plain version ``attention_einsum``, fp32 and bf16, at
   [B, H, T, D] = [64, 5, 256, 32] (2M-like), [32, 8, 256, 32] (6M-like),
   [16, 12, 256, 64] (85M-like), [1, 3, 256, 32] (3 pairs), [4, 10, 256,
   16] (D=16), [4, 4, 256, 128] (D=128), [4, 5, 200, 32] (a masked T),
   [4, 5, 300, 32] and [2, 4, 1024, 32] (T past 256; K and V in two
   windows at 1024), [1, 4, 1024, 128] (four windows), head dims 8, 24 and
   72 (zero columns in bf16), and the 6M-like shape and a D=24 shape as the
   module's strided views of a q|k|v product:
   fp32 within rtol = atol = 1e-4 (``tests/test_attention.py``), bf16
   within 0.01 * max|ref| + 1e-3.
13. The module route at full width: the trained 6M with
   ``attn_impl="pallas"`` through ``make_forward(model, use_fused=False)``
   on phase 6's 512 contexts against the same model with "einsum", phase
   3's tolerances; the attention counter exactly 8 a forward.
14. The slice through its entry point: a ``bias=True``,
   ``attn_impl="pallas"`` model at the 6M's width and depth (8L/8H/256d,
   ``init_params`` weights under ``--seed``, the biases drawn nonzero from
   the same generator): its logits against "einsum" on 512 reset contexts,
   then ``make_batch_rollout`` over 16 envs x 32 agents x 64 steps, argmax,
   phase 4's invariants, the attention counter exactly 8 x 64 and both
   fused counters 0; CSR, ISR, SoC and env-steps/s; the module's forward
   on the rollout's 512 contexts timed beside a rollout step.
15. Attention timing by CUDA events at [8192, 5, 256, 32] (the 2M rollout
   at 256 envs x 32 agents) and [2048, 12, 256, 64] (the 85M at the
   harness cap), bf16: the kernel, its plain version (in chunks), one
   ``scaled_dot_product_attention`` call (a yardstick, never on the port's
   path) and the bound.

Then the kernels' JSON line and, last, ``{"ok": true, "device": {...}}``.
Any failed check raises, and the script exits non-zero with no result line;
so it does without a GPU, and outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from mapf_gpt_tpu_torch.envs import env as menv  # noqa: E402
from mapf_gpt_tpu_torch.maps import random_grid, sample_instance  # noqa: E402
from mapf_gpt_tpu_torch.models.convert import (load_model,  # noqa: E402
                                               load_reference_checkpoint)
from mapf_gpt_tpu_torch.models.gpt import (CONFIGS, GPTConfig, act,  # noqa: E402
                                           init_params, make_forward)
from mapf_gpt_tpu_torch.ops import _build, fused_blocks, fused_gpt  # noqa: E402
from mapf_gpt_tpu_torch.ops import attention as tatt  # noqa: E402
from mapf_gpt_tpu_torch.ops import fused_gpt_train as fgt  # noqa: E402
from mapf_gpt_tpu_torch.parallel.rollout import (_tokens_of,  # noqa: E402
                                                 batch_reset, make_batch_rollout)
from mapf_gpt_tpu_torch.train import loop as train_loop  # noqa: E402
from mapf_gpt_tpu_torch.train.data import write_arrow_shard  # noqa: E402
from mapf_gpt_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from mapf_gpt_tpu_torch.utils import profiling  # noqa: E402

CKPT = os.path.join(ROOT, "checkpoints", "MAPF-GPT-2M-r4.pt")
CKPT_6M = os.path.join(ROOT, "checkpoints", "MAPF-GPT-6M-r5.pt")
B, A, STEPS, MAP_SIZE, DENSITY = 16, 32, 64, 21, 0.3
B_85M, STEPS_85M = 4, 32         # 128 contexts a step
N_TIME = 8192                    # 256 envs x 32 agents
N_TIME_85M = 2048                # the JAX harness's 85M context cap
PLAIN_CHUNK = {"2M": 1024, "6M": 1024, "85M": 256}   # contexts per plain-version call
WIDTHS = ((192, 6, 4), (384, 6, 8), (512, 8, 12),   # (n_embd, heads, layers) built on demand
          (320, 10, 4), (160, 10, 4), (256, 16, 4), (384, 4, 4), (512, 32, 12))
# shapes the e2e kernel takes beyond the 2M's and 6M's, (n_embd, heads, layers, T,
# scale of the layers' matrices): head dims 16, 64 and 128, 12 heads, T = 200, 130
# and 1 (T = 200 at the 6M's width is phase 6's, on the trained 6M), n_embd 144
# (not a multiple of 32: a K slab of 16 rows, a q|k|v tile of 48 columns); the last
# at head dim 128 and T = 130 (keys 130 .. 191 of the last chunk masked) with the
# layers' matrices 3x init_params', so that the layers set the logits and a wrong
# attention (a denominator counting the masked keys) moves them by several
# tolerances, which at std 0.02 it may not
E2E_SHAPES = ((160, 10, 4, 200, 1.0), (256, 4, 4, 256, 1.0), (192, 12, 3, 256, 1.0),
              (128, 1, 2, 100, 1.0), (192, 3, 3, 130, 1.0), (160, 5, 3, 1, 1.0),
              (144, 9, 3, 200, 1.0), (256, 2, 2, 130, 3.0))
N_E2E_SHAPES = 300               # not a multiple of the grid's 132 CTAs
N_WIDTHS = 64                    # contexts of each width's compare
N_WIDTHS_TIME = 2048             # contexts of each width's timing
# contexts of the training kernels' compares: the kernels run groups of
# fgt.GROUP = 256, so the 2M's two full groups and the 6M's 256 + 44 check the
# group offsets, the gradients summed across groups and a partial group
N_TRAIN_CMP = {"2M": 512, "6M": 300, "85M": 64}
TRAIN_WIDTHS = {"85M width": (768, 12, 256), "head dim 16": (256, 16, 256),   # (E, heads, T)
                "head dim 96": (384, 4, 256), "T 200": (256, 8, 200)}
N_TRAIN_TIME = 2048              # the 6M's reference micro-batch
TRAIN_PLAIN_CHUNK = 256          # contexts per plain training-version call
TRAIN_ITERS, TRAIN_BATCH, TRAIN_ACCUM = 20, 256, 2
LOSS_DROP = 0.5                  # the trainer's last logged loss must be this far below its first
ATT_SHAPES = ((64, 5, 256, 32), (32, 8, 256, 32), (16, 12, 256, 64), (1, 3, 256, 32),
              (4, 10, 256, 16), (4, 4, 256, 128), (4, 5, 200, 32),   # [B, H, T, D] compared
              (4, 5, 300, 32), (2, 4, 1024, 32), (1, 4, 1024, 128), (8, 5, 256, 8),
              (8, 5, 256, 24), (4, 4, 256, 72))
ATT_STRIDED = ((32, 8, 256, 32), (8, 5, 256, 24))   # also as views of a q|k|v product
ATT_TIME = {"2M": (8192, 5, 256, 32), "85M": (2048, 12, 256, 64)}   # [B, H, T, D] timed
ATT_PLAIN_PAIRS = 2560           # (batch, head) pairs per plain-version call
PEAK_BF16 = 989e12               # H100 SXM dense bf16 FLOP/s
PEAK_FP32 = 67e12                # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def layer_ops(t: int, e: int, h: int, layers: int, last_only: bool) -> tuple[int, int]:
    """(bf16 product FLOP, fp32 exp2 count) of a layer stack on one context,
    the final layer thinned to one query row when last_only."""
    f = 4 * e
    full = 2 * t * e * 3 * e + 2 * 2 * t * t * e + 2 * t * e * e + 2 * 2 * t * e * f
    last = 2 * t * e * 2 * e + 2 * e * e + 2 * 2 * t * e + 2 * e * e + 2 * 2 * e * f
    if not last_only:
        return layers * full, layers * h * t * t
    return (layers - 1) * full + last, (layers - 1) * h * t * t + h * t


def bound(bf16_ops: float, fp32_ops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms) for this work on the card, and what bounds it."""
    t_ops = bf16_ops / PEAK_BF16 + fp32_ops / PEAK_FP32
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def e2e_bound(n: int, w: fused_gpt.FusedWeights, t: int) -> tuple[float, str]:
    """Least time (ms) of the e2e forward on n contexts, and what bounds it.

    Operations: the bf16 products the forward needs (the last layer thinned
    to one query row) at the bf16 tensor rate, plus the fp32 head and one
    exp2 per attention score at the fp32 rate.  Bytes: tokens and the
    weights the kernel reads once, logits written once."""
    layers, e, _ = w.wqkv.shape
    vocab = w.wte.shape[0]
    prod, exps = layer_ops(t, e, w.n_head, layers, last_only=True)
    io_bytes = n * t * 4 + n * vocab * 4
    weights = nbytes(w.wte, w.wpe, w.wht, *w.stacks()[:6], w.gf)
    return bound(n * prod, n * (exps + 2 * e * vocab), weights + io_bytes)


def blocks_bound(n: int, stacks: fused_blocks.LayerStacks, t: int,
                 last_only: bool) -> tuple[float, str]:
    """Least time (ms) of the layer stack on n contexts: its bf16 products
    and exp2s, against x read once, the output written once and the
    weights read once."""
    layers, e, _ = stacks.wqkv.shape
    prod, exps = layer_ops(t, e, stacks.n_head, layers, last_only)
    io_bytes = n * t * e * 2 + n * (1 if last_only else t) * e * 2
    return bound(n * prod, n * exps, nbytes(*stacks[:6]) + io_bytes)


def check_close(name: str, got: torch.Tensor, ref: torch.Tensor, floor: float,
                argmax: bool, rel: float = 0.02) -> float:
    """got vs ref within atol rel * max|ref| + floor (and >= 95 % argmax
    agreement over the 5 action logits); returns max |got - ref|."""
    if got.shape != ref.shape or not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{name}: kernel output {tuple(got.shape)} not finite or "
                           f"not of shape {tuple(ref.shape)}")
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = rel * scale + floor
    msg = f"[compare] {name}: n={got.shape[0]} max|err|={err:.5f} tol={tol:.5f} " \
          f"(max|ref|={scale:.3f})"
    agree = 1.0
    if argmax:
        agree = (got[:, :5].argmax(-1) == ref[:, :5].argmax(-1)).float().mean().item()
        msg += f" argmax agreement={agree:.4f}"
    log(msg)
    if err > tol or agree < 0.95:
        raise RuntimeError(f"{name}: kernel disagrees with the plain version")
    return err


def check_close_channels(name: str, got: torch.Tensor, ref: torch.Tensor, lead: int,
                         rel: float = 0.02, floor: float = 0.02) -> float:
    """got vs ref within atol rel * max|ref| + floor, the max taken per
    channel (the last dim) and per index of the first `lead` dims, over the
    dims between; returns max |got - ref|."""
    if got.shape != ref.shape or not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{name}: kernel output {tuple(got.shape)} not finite or "
                           f"not of shape {tuple(ref.shape)}")
    parts = int(np.prod(ref.shape[:lead]))
    diff = (got.float() - ref.float()).reshape(parts, -1, ref.shape[-1])
    err = diff.abs().amax(1)
    scale = ref.float().reshape(parts, -1, ref.shape[-1]).abs().amax(1)
    tol = rel * scale + floor
    worst = (err / tol).max().item()
    rms = (diff.square().mean() / ref.float().square().mean()).sqrt().item()
    log(f"[compare] {name}: n={got.shape[lead]} max|err|={err.max().item():.5f} "
        f"per-channel tol {tol.min().item():.5f}..{tol.max().item():.5f} "
        f"(median {tol.median().item():.5f}), worst err/tol={worst:.4f}, "
        f"relative rms err={rms:.2e}")
    if worst > 1.0:
        raise RuntimeError(f"{name}: kernel disagrees with the plain version")
    return err.max().item()


def compare(name: str, w, tokens: torch.Tensor) -> float:
    """The forward's kernel route vs its plain version on the card."""
    got = fused_gpt.fused_logits(w, tokens)
    torch.cuda.synchronize()
    ref = fused_gpt.fused_logits_reference(w, tokens)
    return check_close(name, got, ref, floor=0.02, argmax=True)


def instances(seed: int, b: int):
    insts = [sample_instance(random_grid(MAP_SIZE, DENSITY, seed + s), A, seed=seed + s)
             for s in range(b)]
    return (np.stack([i.grid for i in insts]), np.stack([i.starts for i in insts]),
            np.stack([i.goals for i in insts]))


def check_rollout(final: menv.EnvState, met, steps: int) -> None:
    pos = final.pos.long()
    bi = torch.arange(pos.shape[0], device=pos.device)[:, None]
    if final.grid[bi, pos[..., 0], pos[..., 1]].any():
        raise RuntimeError("rollout: an agent stands on an obstacle")
    lin = pos[..., 0] * final.grid.shape[-1] + pos[..., 1]
    if (lin.sort(-1).values.diff(dim=-1) == 0).any():
        raise RuntimeError("rollout: two agents share a cell")
    for name, vals, hi in (("csr", met.csr, 1.0), ("isr", met.isr, 1.0),
                           ("soc", met.soc, float(A * steps)),
                           ("makespan", met.makespan, float(steps)),
                           ("ep_length", met.ep_length, float(steps))):
        if not torch.isfinite(vals).all() or (vals < 0).any() or (vals > hi).any():
            raise RuntimeError(f"rollout: {name} outside [0, {hi}]: {vals.tolist()}")
    solved = (final.pos == final.goal).all(-1).float().mean(-1)
    if not torch.allclose(solved, met.isr, rtol=0, atol=1e-6):
        raise RuntimeError("rollout: ISR does not match the final positions")


def reset_batch(seed: int, b: int, steps: int, dev):
    grids, starts, goals = instances(seed, b)
    spec = menv.MapfEnvSpec(height=grids.shape[1], width=grids.shape[2], num_agents=A,
                            max_episode_steps=steps)
    states = batch_reset(spec, grids, starts, goals, np.ones((b, A), bool), device=dev)
    return spec, states, _tokens_of(states).reshape(b * A, -1)


def random_tokens(seed: int, n: int, cfg, dev) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(n, cfg.block_size))).to(dev, torch.int32)


def rollout(label: str, spec, model, states, b: int, steps: int, e2e: int,
            blocks: int, attn: int = 0) -> tuple[float, tuple[int, int, int]]:
    """The rollout with the inference kernels' launch counters set to 0 just
    before it; checks they read (e2e, blocks, attn) just after.  Returns its
    seconds and the counts."""
    run = make_batch_rollout(spec, model, do_sample=False)
    torch.cuda.synchronize()
    fused_gpt.launches = fused_blocks.launches = tatt.launches = 0
    t0 = time.perf_counter()
    final, met = run(states)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = (fused_gpt.launches, fused_blocks.launches, tatt.launches)
    log(f"[rollout] {label} B={b} A={A} steps={steps}: {dt:.3f} s, "
        f"{b * steps / dt:.1f} env-steps/s, kernel launches e2e {got[0]} blocks {got[1]} "
        f"attention {got[2]}")
    if got != (e2e, blocks, attn):
        raise RuntimeError(f"rollout {label}: kernel launches (e2e, blocks, attention) {got}, "
                           f"expected {(e2e, blocks, attn)}")
    check_rollout(final, met, steps)
    log(f"[rollout] {label} CSR {met.csr.mean().item():.4f} ISR {met.isr.mean().item():.4f} "
        f"SoC {met.soc.mean().item():.2f} makespan {met.makespan.mean().item():.2f} "
        f"ep_length {met.ep_length.mean().item():.2f}")
    return dt, got


def e2e_model(label: str, model, seed: int, dev) -> dict:
    """Compare, rollout and timing of a model on the e2e route."""
    cfg = model.cfg
    w = fused_gpt.stack_weights(model)
    spec, states, real = reset_batch(seed, B, STEPS, dev)
    rand = random_tokens(seed, B * A, cfg, dev)
    max_err = max(compare(f"{label} random tokens", w, rand),
                  compare(f"{label} reset-batch tokens", w, real))
    dt, (launches, _, _) = rollout(label, spec, model, states, B, STEPS, e2e=STEPS, blocks=0)

    # T = 200 on the trained weights, 300 contexts (a partial wave of the grid)
    short = random_tokens(seed + 1, N_E2E_SHAPES, cfg, dev)[:, :200].contiguous()
    max_err = max(max_err, compare(f"{label} random tokens, T=200", w, short))

    # timing: the rollout's own 512 contexts, then the benchmark's 8192
    ms_step = cuda_ms(lambda: fused_gpt.fused_logits(w, real), reps=10)
    bound_step, _ = e2e_bound(real.shape[0], w, cfg.block_size)
    log(f"[timing] {label} N={real.shape[0]}: kernel {ms_step:.3f} ms of a "
        f"{1e3 * dt / STEPS:.3f} ms rollout step, bound {bound_step:.3f} ms, "
        f"{100 * bound_step / ms_step:.2f} % of bound")
    tokens = real.repeat(N_TIME // real.shape[0], 1)
    ms = cuda_ms(lambda: fused_gpt.fused_logits(w, tokens), reps=5)
    plain_ms = cuda_ms(lambda: [fused_gpt.fused_logits_reference(w, c)
                                for c in tokens.split(PLAIN_CHUNK[label])], reps=2)
    bound_ms, bound_by = e2e_bound(N_TIME, w, cfg.block_size)
    log(f"[timing] {label} N={N_TIME}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}), {100 * bound_ms / ms:.2f} % of bound")
    return {"name": "fused_gpt_e2e", "model": label, "route": "cuda",
            "source": "mapf_gpt_tpu_torch/csrc/fused_gpt.cu",
            "replaces": "mapf_gpt_tpu/ops/fused_gpt.py:182",
            "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "n_contexts": N_TIME, "ms_at_512": ms_step, "bound_ms_at_512": bound_step}


def e2e_shapes_phase(seed: int, dev) -> float:
    """The e2e kernel at E2E_SHAPES on N_E2E_SHAPES contexts, random
    weights from init_params, against fused_logits_reference; the e2e
    counter exactly one a forward.  Returns the largest max |err|."""
    err = 0.0
    for e, h, layers, t, scale in E2E_SHAPES:
        cfg = GPTConfig(n_layer=layers, n_head=h, n_embd=e)
        sd = init_params(cfg, torch.Generator().manual_seed(seed + e + h + t))
        for k in sd:
            if k.startswith("transformer.h.") and ".ln_" not in k:
                sd[k] = sd[k] * scale
        model = load_model(cfg, sd, device=dev)
        w = fused_gpt.stack_weights(model)
        if fused_gpt.cuda_plan(e, h, layers, t) != ("e2e", "fused_gpt"):
            raise RuntimeError(f"e2e shape E={e} H={h} T={t}: not planned on the e2e kernel")
        tokens = random_tokens(seed + e + t, N_E2E_SHAPES, cfg, dev)[:, :t].contiguous()
        fused_gpt.launches = fused_blocks.launches = 0
        err = max(err, compare(f"e2e E={e} H={h} (head dim {e // h}) L={layers} T={t} "
                               f"weights x{scale:g}", w, tokens))
        if (fused_gpt.launches, fused_blocks.launches) != (1, 0):
            raise RuntimeError(f"e2e shape E={e} H={h} T={t}: launches (e2e, blocks) "
                               f"{(fused_gpt.launches, fused_blocks.launches)}, expected (1, 0)")
    return err


def blocks_model(seed: int, dev) -> dict:
    """The 85M on the chunked route: compare, the layer-stack kernel alone,
    rollout and timing."""
    cfg = CONFIGS["85M"]
    gen = torch.Generator().manual_seed(seed)
    model = load_model(cfg, init_params(cfg, gen), device=dev)
    w = fused_gpt.stack_weights(model)
    stacks = w.stacks()
    spec, states, real = reset_batch(seed, B_85M, STEPS_85M, dev)
    rand = random_tokens(seed, B_85M * A, cfg, dev)
    odd = random_tokens(seed + 1, 300, cfg, dev)
    max_err = max(compare("85M random tokens", w, rand),
                  compare("85M reset-batch tokens", w, real),
                  compare("85M random tokens, groups of 256 + 44", w, odd))

    # the layer-stack kernel alone: one 3-layer chunk, every position out
    x = (w.wte32[real.long()] + w.wpe32).to(torch.bfloat16)
    chunk = stacks.chunk(0, 3)
    got = fused_blocks.fused_blocks(x, chunk, last_only=False)
    torch.cuda.synchronize()
    ref = fused_blocks.blocks_reference(x, chunk, last_only=False)
    check_close("85M blocks 3-layer chunk, stream", got, ref, floor=0.0, argmax=False)

    # one layer-stack launch per forward: the chunked route runs all 12 layers in one call
    dt, (_, launches, _) = rollout("85M", spec, model, states, B_85M, STEPS_85M, e2e=0,
                                   blocks=STEPS_85M)

    ms_step = cuda_ms(lambda: fused_gpt.fused_logits(w, real), reps=5)
    log(f"[timing] 85M N={real.shape[0]}: forward {ms_step:.3f} ms of a "
        f"{1e3 * dt / STEPS_85M:.3f} ms rollout step")
    tokens = real.repeat(N_TIME_85M // real.shape[0], 1)
    x = (w.wte32[tokens.long()] + w.wpe32).to(torch.bfloat16)
    ms = cuda_ms(lambda: fused_blocks.fused_blocks(x, stacks, last_only=True), reps=3)
    fwd_ms = cuda_ms(lambda: fused_gpt.fused_logits(w, tokens), reps=2)
    plain_ms = cuda_ms(lambda: [fused_blocks.blocks_reference(c, stacks, last_only=True)
                                for c in x.split(PLAIN_CHUNK["85M"])], reps=2)
    bound_ms, bound_by = blocks_bound(N_TIME_85M, stacks, cfg.block_size, last_only=True)
    log(f"[timing] 85M N={N_TIME_85M}: kernel {ms:.3f} ms (whole forward {fwd_ms:.3f} ms), "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
        f"{100 * bound_ms / ms:.2f} % of bound")
    return {"name": "fused_blocks", "model": "85M", "route": "cuda",
            "source": "mapf_gpt_tpu_torch/csrc/fused_blocks.cu",
            "replaces": "mapf_gpt_tpu/ops/fused_gpt.py:167",
            "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "n_contexts": N_TIME_85M}


def widths_phase(seed: int, dev) -> None:
    """Widths no published model has, each on the kernel cuda_plan names,
    against the plain version, that kernel's counter exactly one; then the
    whole forward timed at N_WIDTHS_TIME contexts beside its plain version
    and its bound."""
    for e, h, layers in WIDTHS:
        cfg = GPTConfig(n_layer=layers, n_head=h, n_embd=e)
        model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(seed + e)),
                           device=dev)
        w = fused_gpt.stack_weights(model)
        route, kernel = fused_gpt.cuda_plan(e, h, layers)
        tokens = random_tokens(seed + e, N_WIDTHS, cfg, dev)
        fused_gpt.launches = fused_blocks.launches = 0
        check_close(f"width E={e} H={h} L={layers} ({route} route, {kernel})",
                    fused_gpt.fused_logits(w, tokens), fused_gpt.fused_logits_reference(w, tokens),
                    floor=0.02, argmax=True)
        got = (fused_gpt.launches, fused_blocks.launches)
        want = (1, 0) if kernel == "fused_gpt" else (0, 1)
        if got != want:
            raise RuntimeError(f"width {e}: launches (e2e, blocks) {got}, expected {want}")
        tokens = random_tokens(seed + e, N_WIDTHS_TIME, cfg, dev)
        ms = cuda_ms(lambda: fused_gpt.fused_logits(w, tokens), reps=2)
        plain_ms = cuda_ms(lambda: [fused_gpt.fused_logits_reference(w, c)
                                    for c in tokens.split(256)], reps=1)
        bound_ms, bound_by = e2e_bound(N_WIDTHS_TIME, w, cfg.block_size)
        log(f"[timing] width E={e} H={h} L={layers} ({kernel}) N={N_WIDTHS_TIME}: forward "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
            f"{100 * bound_ms / ms:.2f} % of bound")


def train_stacks(model) -> fgt.TrainStacks:
    """The model's training stacks, detached (the kernels alone)."""
    st = fgt.build_train_stacks(model)
    return fgt.TrainStacks(*(t.detach() for t in st[:6]), n_head=st.n_head)


def embed(model, tokens: torch.Tensor) -> torch.Tensor:
    """The trainer's embedding: bf16(wte[tokens] + wpe), fp32 tables."""
    tr = model.transformer
    with torch.no_grad():
        return (tr.wte.weight[tokens.long()] + tr.wpe.weight[:tokens.shape[1]]).to(torch.bfloat16)


def top_gradient(model, out: torch.Tensor, seed: int) -> torch.Tensor:
    """The loss's gradient at the last position, as the trainer's backward
    receives it: bf16 [N, T, E], zero but at position T-1, for random
    targets in 0..4."""
    n, e = out.shape
    targets = torch.from_numpy(np.random.RandomState(seed).randint(0, 5, n)).to(out.device)
    xl = out.float().requires_grad_()
    tr = model.transformer
    logits = fused_blocks.ln_f32(xl, tr.ln_f.weight.detach()) @ tr.wte.weight.detach().T
    (dxl,) = torch.autograd.grad(torch.nn.functional.cross_entropy(logits, targets), xl)
    dx = torch.zeros((n, model.cfg.block_size, e), dtype=torch.bfloat16, device=out.device)
    dx[:, -1] = dxl.to(torch.bfloat16)
    return dx


GRAD_NAMES = ("dx", "dwqkv", "dwproj", "dwfc", "dwfc2", "dg1", "dg2")


def compare_backward(label: str, xsave, dxin, stacks) -> tuple[float, torch.Tensor]:
    """One backward chunk, kernel vs plain version, and the kernel twice:
    the second launch must equal the first bit for bit.  Returns (max
    |err|, the kernel's dx)."""
    got = fgt.train_backward(xsave, dxin, stacks)
    again = fgt.train_backward(xsave, dxin, stacks)
    torch.cuda.synchronize()
    ref = fgt.train_bwd_reference(xsave, dxin, stacks)
    err = max(check_close(f"{label} {name}", a, b, floor=1e-4, argmax=False, rel=0.08)
              for name, a, b in zip(GRAD_NAMES, (got[0], *got[1]), (ref[0], *ref[1])))
    if not all(torch.equal(a, b) for a, b in zip((got[0], *got[1]), (again[0], *again[1]))):
        raise RuntimeError(f"{label}: a second backward launch differs from the first")
    log(f"[compare] {label}: a second launch equals the first bit for bit")
    return err, got[0]


def train_kernels_phase(models: dict, seed: int, dev) -> tuple[float, float]:
    """The training kernels against their plain versions: the 2M and 6M at
    full width and depth, the 85M's width on one chunk each way.  Returns
    the max |err| of the forward and of the backward."""
    fwd_err = bwd_err = 0.0
    for label, model in models.items():
        n = N_TRAIN_CMP[label]
        stacks = train_stacks(model)
        layers = stacks.wqkv.shape[0]
        _, _, real = reset_batch(seed, B, STEPS, dev)
        x = embed(model, real[:n])
        out, xsave = fgt.train_forward(x, stacks, last_only=True)
        torch.cuda.synchronize()
        ref_out, ref_xsave = fgt.train_fwd_reference(x, stacks, True)
        fwd_err = max(fwd_err,
                      check_close_channels(f"{label} train forward out", out, ref_out, 0),
                      check_close_channels(f"{label} train forward xsave", xsave, ref_xsave, 1))
        dx = top_gradient(model, out, seed)
        for lo in reversed(range(0, layers, 2)):
            hi = min(lo + 2, layers)
            err, dx = compare_backward(f"{label} train backward layers {lo}-{hi - 1}",
                                       xsave[2 * lo:2 * hi], dx, stacks.chunk(lo, hi))
            bwd_err = max(bwd_err, err)

    # other widths (the 85M's, head dims 16 and 96, T=200): a 2-layer forward
    # chunk, a 1-layer backward chunk
    _, _, real = reset_batch(seed, B_85M, STEPS_85M, dev)
    for label, (e, h, t) in TRAIN_WIDTHS.items():
        cfg = GPTConfig(n_layer=2, n_head=h, n_embd=e, block_size=t)
        gen = torch.Generator().manual_seed(seed if label == "85M width" else seed + e + h + t)
        model = load_model(cfg, init_params(cfg, gen), device=dev)
        stacks = train_stacks(model)
        x = embed(model, real[:N_TRAIN_CMP["85M"], :t])
        out, xsave = fgt.train_forward(x, stacks, last_only=False)
        torch.cuda.synchronize()
        ref_out, ref_xsave = fgt.train_fwd_reference(x, stacks, False)
        fwd_err = max(fwd_err,
                      check_close_channels(f"{label} train forward 2 layers, stream", out,
                                           ref_out, 0),
                      check_close_channels(f"{label} train forward xsave", xsave, ref_xsave, 1))
        gen = torch.Generator(device=dev).manual_seed(seed)
        dxin = (torch.randn(out.shape, generator=gen, device=dev) * 0.01).to(torch.bfloat16)
        err, _ = compare_backward(f"{label} train backward layer 1", xsave[2:4].contiguous(),
                                  dxin, stacks.chunk(1, 2))
        bwd_err = max(bwd_err, err)
    return fwd_err, bwd_err


def distill_shard(path: str, model, seed: int, b: int, steps: int, dev) -> int:
    """Write a shard of the tokenizer's contexts on reset instances stepped
    with `model`'s argmax actions, the actions as targets.  Returns its
    contexts."""
    spec, states, _ = reset_batch(seed, b, steps, dev)
    forward = make_forward(model)
    tokens, actions = [], []
    for _ in range(steps):
        tok = _tokens_of(states).reshape(b * A, -1)
        a = act(forward(tok), do_sample=False)
        tokens.append(tok.cpu())
        actions.append(a.cpu())
        states = menv.step(spec, states, a.reshape(b, A))
    write_arrow_shard(path, torch.cat(tokens).numpy().astype(np.int8),
                      torch.cat(actions).numpy().astype(np.int8))
    return b * A * steps


def trainer_phase(teacher, seed: int, dev) -> dict:
    """The 6M trainer through train.loop.train on shards made here, the
    training kernels' counters set to 0 just before and read just after;
    then the newest checkpoint drives one rollout step."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        for name, s, steps in (("train", seed + 100, 8), ("valid", seed + 200, 4)):
            os.makedirs(os.path.join(tmp, name))
            n = distill_shard(os.path.join(tmp, name, "chunk_0_part_0.arrow"), teacher, s, B,
                              steps, dev)
            log(f"[trainer] {name} shard: {n} contexts")
        out_dir = os.path.join(tmp, "out")
        args = train_loop.parse_args([
            "--model", "6M", "--device", str(dev), "--train-data", os.path.join(tmp, "train"),
            "--valid-data", os.path.join(tmp, "valid"), "--out-dir", out_dir,
            "--batch-size", str(TRAIN_BATCH), "--grad-accum", str(TRAIN_ACCUM),
            "--max-iters", str(TRAIN_ITERS), "--eval-interval", "10", "--eval-iters", "4",
            "--log-interval", "5", "--seed", str(seed)])
        torch.cuda.synchronize()
        fgt.fwd_launches = fgt.bwd_launches = 0
        fused_gpt.launches = fused_blocks.launches = 0
        t0 = time.perf_counter()
        result = train_loop.train(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (fgt.fwd_launches, fgt.bwd_launches)
        micro = TRAIN_ITERS * TRAIN_ACCUM
        bwd_per_micro = -(-CONFIGS["6M"].n_layer // fgt._bwd_layers_per_call(CONFIGS["6M"]))
        log(f"[trainer] 6M {TRAIN_ITERS} iterations x {TRAIN_ACCUM} micro-batches of "
            f"{TRAIN_BATCH}: {wall:.2f} s, launches forward {launches[0]} backward "
            f"{launches[1]} (inference kernels {fused_gpt.launches}, {fused_blocks.launches})")
        if launches != (micro, micro * bwd_per_micro):
            raise RuntimeError(f"trainer: training kernel launches {launches}, expected "
                               f"{(micro, micro * bwd_per_micro)}")
        losses = [h["loss"] for h in result["history"]]
        evals = [(e["val_loss"], e["val_acc"]) for e in result["evals"]]
        log(f"[trainer] losses {losses}; evals (val_loss, val_acc) {evals}")
        if not all(np.isfinite(v) for v in losses + [x for e in evals for x in e]):
            raise RuntimeError("trainer: a loss is not finite")
        if not losses[-1] < losses[0] - LOSS_DROP:
            raise RuntimeError(f"trainer: last loss {losses[-1]:.4f} is not {LOSS_DROP} below "
                               f"the first {losses[0]:.4f}")
        meter = result["meter"]
        its = meter.smoothed or 0.0
        mfu = its * meter.flops_per_step / meter.peak_flops if meter.peak_flops else None
        mfu_text = "not measured" if mfu is None else f"{100 * mfu:.3f} %"
        log(f"[trainer] {its:.3f} it/s, MFU {mfu_text} against {meter.peak_flops} FLOP/s "
            f"(the trainer's meter); {micro * TRAIN_BATCH / wall:.1f} contexts/s over the run")

        step = ckpt.latest_step(out_dir)
        cfg, sd = load_reference_checkpoint(ckpt.checkpoint_path(out_dir, step))
        spec, states, _ = reset_batch(seed, B, 1, dev)
        rollout(f"6M trained here (iter {step})", spec, load_model(cfg, sd, device=dev), states,
                B, 1, e2e=1, blocks=0)
    return {"launches": launches, "it_per_s": its, "mfu": mfu,
            "losses": losses, "wall_s": wall}


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


def train_timing(model, seed: int, dev, fwd_err: float, bwd_err: float,
                 trainer: dict) -> list[dict]:
    """One forward + backward of the 6M at N_TRAIN_TIME contexts: the
    kernels alone, the whole fused loss + backward, the plain versions."""
    cfg = model.cfg
    stacks = train_stacks(model)
    layers, e, _ = stacks.wqkv.shape
    t, h = cfg.block_size, cfg.n_head
    blpc = fgt._bwd_layers_per_call(cfg)
    _, _, real = reset_batch(seed, B, STEPS, dev)
    tokens = real.repeat(N_TRAIN_TIME // real.shape[0], 1)
    x = embed(model, tokens)
    out, xsave = fgt.train_forward(x, stacks, last_only=True)
    dxin = top_gradient(model, out, seed)
    chunks = [(lo, min(lo + blpc, layers)) for lo in reversed(range(0, layers, blpc))]

    def backward():
        dx = dxin
        for lo, hi in chunks:
            dx, _ = fgt.train_backward(xsave[2 * lo:2 * hi], dx, stacks.chunk(lo, hi))

    def plain_forward():
        for c in x.split(TRAIN_PLAIN_CHUNK):
            fgt.train_fwd_reference(c, stacks, True)

    def plain_backward():
        for c0 in range(0, x.shape[0], TRAIN_PLAIN_CHUNK):
            dx = dxin[c0:c0 + TRAIN_PLAIN_CHUNK]
            for lo, hi in chunks:
                dx, _ = fgt.train_bwd_reference(
                    xsave[2 * lo:2 * hi, c0:c0 + TRAIN_PLAIN_CHUNK], dx, stacks.chunk(lo, hi))

    targets = torch.from_numpy(np.random.RandomState(seed).randint(0, 5, tokens.shape[0])).to(dev)

    def whole():
        model.zero_grad(set_to_none=True)
        fgt.fused_loss_fn(model, tokens, targets).backward()

    fwd_ms = cuda_ms(lambda: fgt.train_forward(x, stacks, last_only=True), reps=3)
    bwd_ms = cuda_ms(backward, reps=3)
    lib = fgt._library()
    log("[timing] backward workspace for groups of 256 contexts: " + ", ".join(
        f"{label} {lib.fused_train_workspace(1, fgt.GROUP, 256, e_, h_)} bytes"
        for label, (e_, h_) in (("6M", (256, 8)), ("85M", (768, 12)))))
    split = profiling.kernel_times(backward, reps=1)   # warmed up by the timing above
    traced = sum(r[0] for r in split)
    log(f"[timing] 6M train N={N_TRAIN_TIME} backward by kernel ({traced:.3f} ms traced):")
    for ms_k, calls, name in split[:12]:
        log(f"[timing]   {ms_k:10.3f} ms {100 * ms_k / traced:5.1f} % {calls:6.1f} launches  "
            f"{name[:100]}")
    whole_ms = cuda_ms(whole, reps=3)
    plain_fwd_ms = cuda_ms(plain_forward, reps=1)
    plain_bwd_ms = cuda_ms(plain_backward, reps=1)
    n = N_TRAIN_TIME
    weights = nbytes(*stacks[:6])
    stream = n * t * e * 2
    ops, exps = train_ops(t, e, h, layers, True, False)
    fwd_bound, fwd_by = bound(n * ops, n * exps, stream + 2 * layers * stream + n * e * 2 + weights)
    ops, exps = train_ops(t, e, h, layers, True, True)
    grads = sum(4 * g.numel() for g in stacks[:6])
    # xsave read once, the top gradient and the chunks' dx in and out, weights, fp32 grads
    bwd_bytes = 2 * layers * stream + 2 * len(chunks) * stream + weights + grads
    bwd_bound, bwd_by = bound(n * ops, n * exps, bwd_bytes)
    log(f"[timing] 6M train N={n}: forward kernel {fwd_ms:.3f} ms (plain {plain_fwd_ms:.3f} ms, "
        f"bound {fwd_bound:.3f} ms {fwd_by}, {100 * fwd_bound / fwd_ms:.2f} % of bound); "
        f"backward kernels {bwd_ms:.3f} ms in {len(chunks)} calls (plain {plain_bwd_ms:.3f} ms, "
        f"bound {bwd_bound:.3f} ms {bwd_by}, {100 * bwd_bound / bwd_ms:.2f} % of bound); "
        f"fused_loss_fn + backward {whole_ms:.3f} ms (bound of both {fwd_bound + bwd_bound:.3f} ms)")
    common = {"model": "6M", "route": "cuda", "source": "mapf_gpt_tpu_torch/csrc/fused_train.cu",
              "library_ms": None, "n_contexts": n}
    return [
        {"name": "fused_train_fwd", **common,
         "replaces": "mapf_gpt_tpu/ops/fused_gpt_train.py:98", "launches": trainer["launches"][0],
         "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": plain_fwd_ms, "bound_ms": fwd_bound,
         "bound_by": fwd_by, "whole_loss_and_backward_ms": whole_ms},
        {"name": "fused_train_bwd", **common,
         "replaces": "mapf_gpt_tpu/ops/fused_gpt_train.py:133",
         "launches": trainer["launches"][1], "max_abs_err": bwd_err, "ms": bwd_ms,
         "plain_ms": plain_bwd_ms, "bound_ms": bwd_bound, "bound_by": bwd_by,
         "calls": len(chunks),
         "attention_kernels_ms": {name.split("<")[0].split("(")[0]: ms_k
                                  for ms_k, _, name in split if "attn" in name}},
    ]


def check_attention(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """fp32 within rtol = atol = 1e-4 (tests/test_attention.py), bf16 within
    0.01 * max|ref| + 1e-3; returns max |got - ref|."""
    if got.shape != ref.shape or got.dtype != ref.dtype or not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: kernel output {got.dtype} {tuple(got.shape)} not finite "
                           f"or not {ref.dtype} {tuple(ref.shape)}")
    diff = (got.float() - ref.float()).abs()
    if got.dtype == torch.float32:
        tol = 1e-4 + 1e-4 * ref.abs()
    else:
        tol = torch.full_like(diff, 0.01 * ref.float().abs().max().item() + 1e-3)
    worst = (diff / tol).max().item()
    log(f"[compare] {name}: max|err|={diff.max().item():.6f} worst err/tol={worst:.4f} "
        f"(max|ref|={ref.float().abs().max().item():.3f})")
    if worst > 1.0:
        raise RuntimeError(f"{name}: kernel disagrees with the plain version")
    return diff.max().item()


def attention_phase(seed: int, dev) -> float:
    """The attention kernel against its plain version at ATT_SHAPES, fp32
    and bf16, and at the 6M-like shape as the module's strided views.
    Returns the largest max |err|."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    err = 0.0
    for shape in ATT_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev) for _ in range(3))
        scale = 1.0 / math.sqrt(shape[-1])
        for dtype in (torch.float32, torch.bfloat16):
            x = [t.to(dtype) for t in (q, k, v)]
            got = tatt.attention_pallas(*x, scale)
            torch.cuda.synchronize()
            err = max(err, check_attention(f"attention {list(shape)} {dtype}", got,
                                           tatt.attention_einsum(*x, scale)))
    for b, h, t, d in ATT_STRIDED:
        qkv = torch.randn((b, t, 3 * h * d), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = [z.reshape(b, t, h, d).transpose(1, 2) for z in qkv.to(dtype).split(h * d, dim=-1)]
            got = tatt.attention_pallas(*x, 1.0 / math.sqrt(d))
            torch.cuda.synchronize()
            err = max(err, check_attention(
                f"attention {[b, h, t, d]} {dtype}, strided views of q|k|v", got,
                tatt.attention_einsum(*x, 1.0 / math.sqrt(d))))
    return err


def module_route_phase(seed: int, dev) -> None:
    """The trained 6M on the module route, attn_impl "pallas" against
    "einsum", on phase 6's 512 contexts; 8 attention launches a forward."""
    cfg, sd = load_reference_checkpoint(CKPT_6M)
    forwards = {impl: make_forward(load_model(dataclasses.replace(cfg, attn_impl=impl), sd,
                                              device=dev), use_fused=False)
                for impl in ("pallas", "einsum")}
    _, _, real = reset_batch(seed, B, STEPS, dev)
    for label, tokens in (("reset-batch", real), ("random", random_tokens(seed, B * A, cfg, dev))):
        torch.cuda.synchronize()
        tatt.launches = 0
        got = forwards["pallas"](tokens)
        torch.cuda.synchronize()
        if tatt.launches != cfg.n_layer:
            raise RuntimeError(f"module route: {tatt.launches} attention launches in a "
                               f"forward, expected {cfg.n_layer}")
        check_close(f"6M module route, attn_impl pallas vs einsum, {label} tokens", got,
                    forwards["einsum"](tokens), floor=0.02, argmax=True)


def bias_rollout_phase(seed: int, dev) -> tuple[int, float]:
    """A bias=True, attn_impl="pallas" model at the 6M's width and depth
    through make_batch_rollout: the attention kernel once a layer and step,
    neither fused kernel.  Returns the attention launches and the rollout's
    seconds."""
    cfg = dataclasses.replace(CONFIGS["6M"], bias=True, attn_impl="pallas")
    gen = torch.Generator().manual_seed(seed)
    sd = init_params(cfg, gen)
    for name in sd:
        if name.endswith(".bias"):
            sd[name] = torch.randn(sd[name].shape, generator=gen) * 0.02
    model = load_model(cfg, sd, device=dev)
    spec, states, real = reset_batch(seed, B, STEPS, dev)
    einsum = load_model(dataclasses.replace(cfg, attn_impl="einsum"), sd, device=dev)
    check_close("6M-width bias=True, attn_impl pallas vs einsum, reset-batch tokens",
                make_forward(model)(real), make_forward(einsum)(real), floor=0.02, argmax=True)
    dt, (_, _, launches) = rollout("6M-width bias=True attn_impl=pallas (module route)", spec,
                                   model, states, B, STEPS, e2e=0, blocks=0,
                                   attn=cfg.n_layer * STEPS)
    forward = make_forward(model)
    ms = cuda_ms(lambda: forward(real), reps=10)
    log(f"[timing] 6M-width bias=True module route N={real.shape[0]}: forward {ms:.3f} ms of a "
        f"{1e3 * dt / STEPS:.3f} ms rollout step")
    return launches, dt


def attention_timing(seed: int, dev, launches: int, max_err: float) -> dict:
    """The attention kernel at ATT_TIME in bf16, beside its plain version,
    one scaled_dot_product_attention call and the bound."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = {}
    for label, (b, h, t, d) in ATT_TIME.items():
        q, k, v = (torch.randn((b, h, t, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        chunk = max(1, ATT_PLAIN_PAIRS // h)
        ms = cuda_ms(lambda: tatt.attention_pallas(q, k, v, scale), reps=5)
        plain_ms = cuda_ms(lambda: [tatt.attention_einsum(q[i:i + chunk], k[i:i + chunk],
                                                          v[i:i + chunk], scale)
                                    for i in range(0, b, chunk)], reps=1)
        sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=scale), reps=5)
        n = b * h
        bound_ms, bound_by = bound(4 * n * t * t * d, n * t * t, 4 * n * t * d * 2)
        log(f"[timing] attention {label} [{b}, {h}, {t}, {d}] bf16: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, scaled_dot_product_attention {sdpa_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}), {100 * bound_ms / ms:.2f} % of bound")
        rows[label] = {"shape": [b, h, t, d], "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": sdpa_ms}
    return {"name": "attention", "model": "bias=True 6M width, attn_impl=pallas",
            "route": "cuda", "source": "mapf_gpt_tpu_torch/csrc/attention.cu",
            "replaces": "mapf_gpt_tpu/ops/attention.py:37", "launches": launches,
            "max_abs_err": max_err, **rows["2M"], "at_85m_shape": rows["85M"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.stdout.reconfigure(line_buffering=True)   # the trainer's own lines in order
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in full fp32
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = nvidia_smi_line()
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build: every source (attention.cu among them), and the widths of phase 8, one
    # nvcc each, together
    sources = sorted(p[:-3] for p in os.listdir(_build.CSRC) if p.endswith(".cu"))
    jobs = [(name, None) for name in sources]
    for e, h, layers in WIDTHS:
        kernel = fused_gpt.cuda_plan(e, h, layers)[1]
        jobs.append((kernel, fused_gpt.e2e_defines(e, h) if kernel == "fused_gpt"
                     else fused_blocks.kernel_defines(e, h)))
    jobs += [("fused_gpt", fused_gpt.e2e_defines(e, h)) for e, h, *_ in E2E_SHAPES]
    jobs = list({_build.library_path(*job): job for job in jobs}.values())   # each library once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: _build.build(*job), jobs))
    log(f"[build] {sources} and {len(jobs) - len(sources)} widths in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] fused_gpt kernel config {fused_gpt.kernel_config()}")
    log(f"[build] fused_blocks kernel config {fused_blocks.kernel_config()}")

    # 12. the attention kernel against its plain version, first
    att_err = attention_phase(args.seed, dev)

    # 3-5. the trained 2M at full width; 6. the trained 6M; 7. the 85M
    cfg, sd = load_reference_checkpoint(CKPT)
    model_2m = load_model(cfg, sd, device=dev)
    entries = [e2e_model("2M", model_2m, args.seed, dev)]
    cfg, sd = load_reference_checkpoint(CKPT_6M)
    model_6m = load_model(cfg, sd, device=dev)
    entries.append(e2e_model("6M", model_6m, args.seed, dev))
    e2e_shapes_err = e2e_shapes_phase(args.seed, dev)
    for entry in entries:
        entry["max_abs_err_other_shapes"] = e2e_shapes_err
    entries.append(blocks_model(args.seed, dev))
    log(f"[done] inference phases {time.perf_counter() - t_start:.1f} s")

    # 8. widths built on demand; 9. training kernels; 10. the trainer; 11. timing
    widths_phase(args.seed, dev)
    fwd_err, bwd_err = train_kernels_phase({"2M": model_2m, "6M": model_6m}, args.seed, dev)
    trainer = trainer_phase(model_6m, args.seed, dev)
    entries += train_timing(model_6m.train().requires_grad_(), args.seed, dev, fwd_err, bwd_err,
                            trainer)
    log(f"[done] trainer phases {time.perf_counter() - t_start:.1f} s")

    # 13. the module route with attn_impl="pallas"; 14. the bias=True rollout; 15. timing
    module_route_phase(args.seed, dev)
    att_launches, _ = bias_rollout_phase(args.seed, dev)
    entries.append(attention_timing(args.seed, dev, att_launches, att_err))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    log(nvidia_smi_line())
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
