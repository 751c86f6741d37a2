"""Where a policy forward's device time goes, kernel by kernel.

    python3 -m mapf_gpt_tpu_torch.tools.profile_forward [--model 85M] [--n 2048] [--reps 3]

Builds the model on the card with ``init_params`` weights from ``--seed``
(the kernels' times do not depend on the weights' values), runs its forward
(``make_forward``, as the rollout does) once to build and warm up, then
traces ``--reps`` forwards on random tokens with ``torch.profiler`` and
prints each CUDA kernel's device time per forward, its launches per
forward and its share, beside the forward's time by CUDA events.  On the
85M this splits the layer-stack kernel's calls (``csrc/fused_blocks.cu``)
into its GEMM variants and attention.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from mapf_gpt_tpu_torch.models.convert import load_model
from mapf_gpt_tpu_torch.models.gpt import CONFIGS, init_params, make_forward
from mapf_gpt_tpu_torch.utils.profiling import kernel_times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(CONFIGS), default="85M")
    ap.add_argument("--n", type=int, default=2048, help="contexts per forward")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: needs a CUDA GPU")
    cfg = CONFIGS[args.model]
    sd = init_params(cfg, torch.Generator().manual_seed(args.seed))
    forward = make_forward(load_model(cfg, sd, device="cuda"))
    tokens = torch.from_numpy(np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, size=(args.n, cfg.block_size))).to("cuda", torch.int32)
    forward(tokens)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.reps):
        forward(tokens)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / args.reps
    rows = kernel_times(lambda: forward(tokens), args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    traced = sum(r[0] for r in rows)
    print(f"{smi} | {args.model} N={args.n} | forward {ms:.3f} ms (CUDA events), "
          f"{traced:.3f} ms of kernels traced per forward")
    if not rows:
        print("  the profiler recorded no device time")
    for t, calls, name in rows:
        print(f"  {t:10.3f} ms {100 * t / traced:5.1f} %  {calls:6.1f} launches  {name[:110]}")


if __name__ == "__main__":
    main()
