"""The trainer's it/s and MFU meter, read as ``chip_smoke.py``'s phase 10 reads it, over runs.

    python3 mapf_gpt_tpu_torch/tools/trainer_meter.py [--model 6M] [--runs 3] [--seed 0]

Writes a train and a valid shard of random tokens and actions (the speed
does not depend on their values), then runs ``train.loop.train`` --runs
times in this process with phase 10's arguments (micro-batches of 256,
2 accumulated, 20 iterations, an eval of 4 batches and a checkpoint every
10, a meter tick every 5: two of its three intervals hold an eval and a
checkpoint) and once more with 40 iterations, an eval every 40 and a tick
every 10 (no eval or checkpoint inside an interval: the steady rate).
Prints one line a run: the meter's smoothed it/s and MFU and the run's wall
seconds, beside ``nvidia-smi``'s name and power limit.  It uses only
``train.loop``'s command line and ``train.data.write_arrow_shard``, so
it runs unchanged on another checkout's package (``PYTHONPATH=<checkout>``,
the script by its path), which puts two commits' meters in one call.
Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile

import numpy as np
import torch

from mapf_gpt_tpu_torch.models.gpt import CONFIGS
from mapf_gpt_tpu_torch.train import loop as train_loop
from mapf_gpt_tpu_torch.train.data import write_arrow_shard

PHASE_10 = ["--batch-size", "256", "--grad-accum", "2", "--max-iters", "20",
            "--eval-interval", "10", "--eval-iters", "4", "--log-interval", "5"]
STEADY = ["--batch-size", "256", "--grad-accum", "2", "--max-iters", "40",
          "--eval-interval", "40", "--eval-iters", "4", "--log-interval", "10"]
CONTEXTS = 4096


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(CONFIGS), default="6M")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trainer_meter: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True
                         ).stdout.strip().splitlines()[0]
    cfg = CONFIGS[args.model]
    print(f"[meter] package {os.path.dirname(os.path.abspath(train_loop.__file__))}", flush=True)
    rng = np.random.RandomState(args.seed)
    with tempfile.TemporaryDirectory(prefix="trainer_meter_") as tmp:
        for name in ("train", "valid"):
            os.makedirs(os.path.join(tmp, name))
            write_arrow_shard(os.path.join(tmp, name, "chunk_0_part_0.arrow"),
                              rng.randint(0, cfg.vocab_size, (CONTEXTS, cfg.block_size)
                                          ).astype(np.int8),
                              rng.randint(0, 5, CONTEXTS).astype(np.int8))
        for run, (kind, extra) in enumerate([("phase 10", PHASE_10)] * args.runs
                                            + [("steady", STEADY)]):
            argv = ["--model", args.model, "--device", "cuda", "--seed", str(args.seed),
                    "--train-data", os.path.join(tmp, "train"),
                    "--valid-data", os.path.join(tmp, "valid"),
                    "--out-dir", os.path.join(tmp, f"out{run}"), *extra]
            result = train_loop.train(train_loop.parse_args(argv))
            torch.cuda.synchronize()
            meter = result["meter"]
            its = meter.smoothed or 0.0
            mfu = (f"{100 * its * meter.flops_per_step / meter.peak_flops:.3f} %"
                   if meter.peak_flops else "not measured")
            print(f"[meter] {smi} | {args.model} {kind} run {run}: {its:.3f} it/s, MFU {mfu}, "
                  f"wall {result['wall_s']:.3f} s", flush=True)


if __name__ == "__main__":
    main()
