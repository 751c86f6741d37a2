#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mapf_gpt_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Drives the port's main path, the batched 2M rollout, through the entry
points a user calls, and holds every CUDA kernel of that path against its
plain PyTorch version.  Phases, one line each (flushed):

1. device: the card's name and power limit (nvidia-smi) and torch's CUDA.
2. build: every kernel source under ``mapf_gpt_tpu_torch/csrc``, one nvcc
   each, all started together; build seconds and ptxas' register report.
3. kernel vs plain version: the trained 2M (``checkpoints/MAPF-GPT-2M-r4.pt``)
   at full width on 512 contexts, random tokens from ``--seed`` and the real
   tokens of a reset batch.  Logits within atol 0.02 * max|ref| + 0.02 and
   argmax agreement over the 5 action logits >= 95 % (the tolerances of
   ``tests/test_fused_gpt.py``).
4. rollout: 16 envs x 32 agents x 64 steps on ``random_grid(21, 0.3, s)``
   maps, argmax actions.  Every agent on a free cell, positions unique per
   env, metrics in range, and the kernel's launch counter exactly one per
   step.  Prints CSR, ISR, SoC and env-steps/s.
5. timing: the kernel on the rollout's 512 contexts beside a whole rollout
   step; then one forward at 8192 contexts (the rollout benchmark's 256
   envs x 32 agents), kernel and plain version, beside the card's bound.

Then the kernels' JSON line and, last, ``{"ok": true, "device": {...}}``.
Any failed check raises, and the script exits non-zero with no result line;
so it does without a GPU, and outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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
from mapf_gpt_tpu_torch.ops import _build, fused_gpt  # noqa: E402
from mapf_gpt_tpu_torch.parallel.rollout import (_tokens_of,  # noqa: E402
                                                 batch_reset, make_batch_rollout)

CKPT = os.path.join(ROOT, "checkpoints", "MAPF-GPT-2M-r4.pt")
B, A, STEPS, MAP_SIZE, DENSITY = 16, 32, 64, 21, 0.3
N_TIME = 8192                    # 256 envs x 32 agents
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


def e2e_bound(n: int, w: fused_gpt.FusedWeights, t: int) -> tuple[float, str]:
    """Least time (ms) of the fused forward on n contexts, and what bounds it.

    Operations: the bf16 products the forward needs (the last layer thinned
    to one query row) at the bf16 tensor rate, plus the fp32 head and one
    exp2 per attention score at the fp32 rate.  Bytes: tokens and weights
    read once, logits written once."""
    layers, e, _ = w.wqkv.shape
    f, vocab = 4 * e, w.wte.shape[0]
    full = 2 * t * e * 3 * e + 2 * 2 * t * t * e + 2 * t * e * e + 2 * 2 * t * e * f
    last = 2 * t * e * 2 * e + 2 * e * e + 2 * 2 * t * e + 2 * e * e + 2 * 2 * e * f
    bf16_ops = n * ((layers - 1) * full + last)
    fp32_ops = n * (2 * e * vocab + (layers - 1) * w.n_head * t * t + w.n_head * t)
    weight_bytes = sum(x.numel() * x.element_size() for x in w if torch.is_tensor(x))
    io_bytes = n * t * 4 + n * vocab * 4
    t_ops = bf16_ops / PEAK_BF16 + fp32_ops / PEAK_FP32
    t_bytes = (weight_bytes + io_bytes) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def compare(name: str, w, tokens: torch.Tensor) -> float:
    """Kernel vs plain version on the card; returns max |kernel - plain|."""
    got = fused_gpt.fused_logits(w, tokens)
    torch.cuda.synchronize()
    ref = fused_gpt.fused_logits_reference(w, tokens)
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: kernel logits {tuple(got.shape)} not finite or "
                           f"not of shape {tuple(ref.shape)}")
    err = (got - ref).abs()
    scale = ref.abs().max().item()
    tol = 0.02 * scale + 0.02
    agree = (got[:, :5].argmax(-1) == ref[:, :5].argmax(-1)).float().mean().item()
    log(f"[compare] {name}: n={tokens.shape[0]} max|err|={err.max().item():.5f} "
        f"tol={tol:.5f} (max|ref|={scale:.3f}) argmax agreement={agree:.4f}")
    if err.max().item() > tol or agree < 0.95:
        raise RuntimeError(f"{name}: kernel disagrees with the plain version")
    return err.max().item()


def instances(seed: int, b: int):
    insts = [sample_instance(random_grid(MAP_SIZE, DENSITY, seed + s), A, seed=seed + s)
             for s in range(b)]
    return (np.stack([i.grid for i in insts]), np.stack([i.starts for i in insts]),
            np.stack([i.goals for i in insts]))


def check_rollout(final: menv.EnvState, met) -> None:
    pos = final.pos.long()
    bi = torch.arange(pos.shape[0], device=pos.device)[:, None]
    if final.grid[bi, pos[..., 0], pos[..., 1]].any():
        raise RuntimeError("rollout: an agent stands on an obstacle")
    lin = pos[..., 0] * final.grid.shape[-1] + pos[..., 1]
    if (lin.sort(-1).values.diff(dim=-1) == 0).any():
        raise RuntimeError("rollout: two agents share a cell")
    for name, vals, hi in (("csr", met.csr, 1.0), ("isr", met.isr, 1.0),
                           ("soc", met.soc, float(A * STEPS)),
                           ("makespan", met.makespan, float(STEPS)),
                           ("ep_length", met.ep_length, float(STEPS))):
        if not torch.isfinite(vals).all() or (vals < 0).any() or (vals > hi).any():
            raise RuntimeError(f"rollout: {name} outside [0, {hi}]: {vals.tolist()}")
    solved = (final.pos == final.goal).all(-1).float().mean(-1)
    if not torch.allclose(solved, met.isr, rtol=0, atol=1e-6):
        raise RuntimeError("rollout: ISR does not match the final positions")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in full fp32
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = nvidia_smi_line()
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    sources = sorted(p[:-3] for p in os.listdir(_build.CSRC) if p.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    log(f"[build] {sources} in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] fused_gpt kernel config {fused_gpt.kernel_config()}")

    # 3. kernel vs plain version, trained 2M at full width
    cfg, sd = load_reference_checkpoint(CKPT)
    model = load_model(cfg, sd, device=dev)
    w = fused_gpt.stack_weights(model)
    grids, starts, goals = instances(args.seed, B)
    spec = menv.MapfEnvSpec(height=grids.shape[1], width=grids.shape[2], num_agents=A,
                            max_episode_steps=STEPS)
    states = batch_reset(spec, grids, starts, goals, np.ones((B, A), bool), device=dev)
    real = _tokens_of(states).reshape(B * A, -1)
    rand = torch.from_numpy(np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, size=(B * A, cfg.block_size))).to(dev, torch.int32)
    max_err = max(compare("random tokens", w, rand), compare("reset-batch tokens", w, real))

    # 4. rollout through the kernel
    run = make_batch_rollout(spec, model, do_sample=False)
    torch.cuda.synchronize()
    fused_gpt.launches = 0
    t0 = time.perf_counter()
    final, met = run(states)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fused_gpt.launches
    log(f"[rollout] B={B} A={A} steps={STEPS}: {dt:.3f} s, {B * STEPS / dt:.1f} env-steps/s, "
        f"kernel launches {launches}")
    if launches != STEPS:
        raise RuntimeError(f"rollout: {launches} kernel launches, expected {STEPS}")
    check_rollout(final, met)
    log(f"[rollout] CSR {met.csr.mean().item():.4f} ISR {met.isr.mean().item():.4f} "
        f"SoC {met.soc.mean().item():.2f} makespan {met.makespan.mean().item():.2f} "
        f"ep_length {met.ep_length.mean().item():.2f}")

    # 5. timing: the rollout's own 512 contexts, then the benchmark's 8192
    ms_step = cuda_ms(lambda: fused_gpt.fused_logits(w, real), reps=10)
    log(f"[timing] N={real.shape[0]}: kernel {ms_step:.3f} ms of a "
        f"{1e3 * dt / STEPS:.3f} ms rollout step")
    tokens = real.repeat(N_TIME // real.shape[0], 1)
    ms = cuda_ms(lambda: fused_gpt.fused_logits(w, tokens), reps=5)
    plain_ms = cuda_ms(lambda: [fused_gpt.fused_logits_reference(w, c)
                                for c in tokens.split(1024)], reps=2)
    bound_ms, bound_by = e2e_bound(N_TIME, w, cfg.block_size)
    log(f"[timing] N={N_TIME}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}), {100 * bound_ms / ms:.2f} % of bound")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    log(nvidia_smi_line())
    log(json.dumps({"kernels": [{
        "name": "fused_gpt_e2e", "route": "cuda",
        "source": "mapf_gpt_tpu_torch/csrc/fused_gpt.cu",
        "replaces": "mapf_gpt_tpu/ops/fused_gpt.py:182",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "n_contexts": N_TIME}]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
