"""The readings that the limits of ``limits/<cell>.json`` are set from: on the
card, at the cell's own size, for each seed given, the program's compared
numbers and the control's, and for training cells a fault's.

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> [<n> ...]

The control is the plain reference put in the program's place, computed in
float8 (e4m3, one scale a tensor), the step below the bfloat16 that the
configurations state:

- rollout cells: the program runs the cell's smallest window (two episodes),
  as a run does; on the same contexts the reference reads the program's action
  logits against float32 (``logit_err``) and the float8 reference's
  (``control.logit_err``);
- training cells: the program's set-up steps give its readings; the float8
  reference, and the float32 reference with half of each step's rows left out
  (``fault.half_batch``), follow the same steps and are read against the
  float32 reference.  A state left unchanged reads 1 on ``change_gap`` by
  definition and needs no run.

Prints one JSON line a seed and reading; the benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if not __package__:              # run as a script: the checkout's root, not perfbench/
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.drivers import rollout, train  # noqa: E402
from perfbench.reference import gpt as ref_gpt  # noqa: E402
from perfbench.reference import train as ref_train  # noqa: E402


def rollout_readings(run) -> dict:
    s = rollout.setup(run)
    rollout.window(s, run)
    rollout.release(s)
    checks = {c.name: c.value for c in rollout.check(s, run)}
    tr, dev = run.traffic, torch.device(run.device)
    tokens = []
    for e, rec in enumerate(s.records):
        grids, starts, goals = s.episodes[e]
        for j, env in enumerate(s.check_idx[e]):
            got, _, _, _ = rollout.reference_episode(grids[env], starts[env], goals[env],
                                                     tr["steps"], rec["actions"][:, j])
            tokens.append(got.reshape(-1, got.shape[-1]))
    tokens = torch.from_numpy(np.concatenate(tokens)).to(dev)
    with ref_gpt.fp32_exact():
        ref = ref_gpt.logits_in_blocks(s.weights, tokens, run.config, tr["check_rows"])
        low = ref_gpt.logits_in_blocks(s.weights, tokens, run.config, tr["check_rows"], "fp8")
    control = float((low[:, :5].double() - ref[:, :5].double()).abs().max())
    return {"program": checks, "control": {"logit_err": control}}


def train_readings(run) -> dict:
    s = train.setup(run)
    train.release(s)
    program = {c.name: c.value for c in train.check(s, run)}
    tr, dev = run.traffic, torch.device(run.device)
    hp = train.hyperparameters(run.config)
    batches = [(torch.from_numpy(s.tokens[r].astype(np.int64)).to(dev),
                torch.from_numpy(s.targets[r].astype(np.int64)).to(dev)) for r in s.fed]
    out = {"program": program}
    with ref_gpt.fp32_exact():
        ref = ref_train.run_steps(s.weights, run.config, hp, batches, tr["reference_rows"])
        low = ref_train.run_steps(s.weights, run.config, hp, batches, tr["reference_rows"], "fp8")
        out["control"] = ref_train.gaps(low, ref)
        half = ref_train.run_steps(s.weights, run.config, hp, batches, tr["reference_rows"],
                                   half_batch=True)
        out["fault.half_batch"] = ref_train.gaps(half, ref)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    config, traffic, limits, _, _, _ = harness.load_cell(args.workload)
    read = rollout_readings if traffic["kind"] == "rollout" else train_readings
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.Run(workload=args.workload, config=config, traffic=traffic,
                          limits=limits, seed=seed, seconds=0.0, trace=False)
        got = read(run)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **got}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
