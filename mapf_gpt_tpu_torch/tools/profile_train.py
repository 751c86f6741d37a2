"""Where a training micro-batch's device time goes, kernel by kernel.

    python3 -m mapf_gpt_tpu_torch.tools.profile_train [--model 6M] [--n 2048] [--reps 3]

Builds the model on the card with ``init_params`` weights from ``--seed``,
runs the trainer's loss and its backward (``ops/fused_gpt_train.fused_loss_fn``
then ``.backward()``, as ``train/train_step.py`` does on CUDA) once to build
and warm up, then traces ``--reps`` of them with ``torch.profiler`` and
prints each CUDA kernel's device time per micro-batch, its launches and its
share, beside the micro-batch's time by CUDA events.  The contexts are the
tokenizer's, on reset instances of 32 agents on ``random_grid(21, 0.3)``
maps, so the token ids are as skewed as in training data; the targets are
random actions.  This splits ``csrc/fused_train.cu``'s calls into their GEMM
variants, attention and LayerNorm kernels, and shows the PyTorch work
around them (embedding, head, stacking and casting).  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from mapf_gpt_tpu_torch.envs.env import MapfEnvSpec
from mapf_gpt_tpu_torch.maps import random_grid, sample_instance
from mapf_gpt_tpu_torch.models.convert import load_model
from mapf_gpt_tpu_torch.models.gpt import CONFIGS, init_params
from mapf_gpt_tpu_torch.ops.fused_gpt_train import fused_loss_fn
from mapf_gpt_tpu_torch.parallel.rollout import _tokens_of, batch_reset
from mapf_gpt_tpu_torch.utils.profiling import kernel_times

AGENTS = 32


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(CONFIGS), default="6M")
    ap.add_argument("--n", type=int, default=2048, help="contexts per micro-batch")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA GPU")
    cfg = CONFIGS[args.model]
    model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(args.seed)),
                       device="cuda").train().requires_grad_()
    envs = -(-args.n // AGENTS)
    insts = [sample_instance(random_grid(21, 0.3, args.seed + s), AGENTS, seed=args.seed + s)
             for s in range(envs)]
    grids = np.stack([i.grid for i in insts])
    spec = MapfEnvSpec(height=grids.shape[1], width=grids.shape[2], num_agents=AGENTS,
                       max_episode_steps=1)
    states = batch_reset(spec, grids, np.stack([i.starts for i in insts]),
                         np.stack([i.goals for i in insts]), np.ones((envs, AGENTS), bool))
    tokens = _tokens_of(states).reshape(envs * AGENTS, -1)[:args.n]
    targets = torch.from_numpy(np.random.RandomState(args.seed).randint(0, 5, size=args.n)
                               ).to("cuda")

    def micro_batch():
        model.zero_grad(set_to_none=True)
        fused_loss_fn(model, tokens, targets).backward()

    micro_batch()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.reps):
        micro_batch()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / args.reps
    rows = kernel_times(micro_batch, args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    traced = sum(r[0] for r in rows)
    print(f"{smi} | {args.model} N={args.n} | loss + backward {ms:.3f} ms (CUDA events), "
          f"{traced:.3f} ms of kernels traced per micro-batch")
    if not rows:
        print("  the profiler recorded no device time")
    for t, calls, name in rows:
        print(f"  {t:10.3f} ms {100 * t / traced:5.1f} %  {calls:6.1f} launches  {name[:110]}")


if __name__ == "__main__":
    main()
