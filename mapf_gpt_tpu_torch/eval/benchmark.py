"""Full POGEMA-suite benchmark CLI — the ``benchmark.py`` equivalent, on the port.

    python -m mapf_gpt_tpu_torch.eval.benchmark --configs-root <eval_configs dir> \
        [--weights ... [--model 2M] | --random-init 2M] [--suites 01-random 02-mazes ...] \
        [--device cuda] [--limit N] [--out-dir results]

Port of ``mapf_gpt_tpu/eval/benchmark.py``: runs every suite (01-random,
02-mazes, 03-warehouse, 04-movingai, 05-puzzles) through ``eval.run`` and
prints a summary table.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

DEFAULT_SUITES = ["01-random", "02-mazes", "03-warehouse", "04-movingai",
                  "05-puzzles"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--configs-root", required=True,
                   help="directory holding one directory per suite")
    p.add_argument("--suites", nargs="*", default=DEFAULT_SUITES)
    p.add_argument("--weights", default=None)
    p.add_argument("--model", default=None,
                   help="the checkpoint's size (passed through to eval.run)")
    p.add_argument("--random-init", default=None)
    p.add_argument("--algo", default=None,
                   help="key into each suite yaml's algorithms block "
                        "(passed through to eval.run)")
    p.add_argument("--weights-root", default=None,
                   help="directory to resolve yaml path_to_weights in")
    p.add_argument("--mask", nargs="*", default=None,
                   help="input ablations, passed through to eval.run")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch-envs", type=int, default=128)
    p.add_argument("--out-dir", default="results")
    p.add_argument("--argmax", action="store_true")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--policy-batch", type=int, default=8192)
    p.add_argument("--max-contexts", type=int, default=None,
                   help="default: sized from the card's free memory "
                        "(harness.default_max_contexts)")
    args = p.parse_args(argv)

    from mapf_gpt_tpu_torch.eval import run as eval_run

    summaries = []
    for suite in args.suites:
        suite_dir = os.path.join(args.configs_root, suite)
        if not os.path.isdir(suite_dir):
            print(f"skipping {suite}: {suite_dir} not found")
            continue
        argv2 = ["--suite", suite_dir, "--out-dir", args.out_dir,
                 "--batch-envs", str(args.batch_envs),
                 "--policy-batch", str(args.policy_batch), "--device", args.device]
        if args.max_contexts is not None:
            argv2 += ["--max-contexts", str(args.max_contexts)]
        for flag, value in (("--weights", args.weights), ("--model", args.model),
                            ("--random-init", args.random_init),
                            ("--algo", args.algo), ("--weights-root", args.weights_root)):
            if value:
                argv2 += [flag, value]
        if args.mask:
            argv2 += ["--mask", *args.mask]
        if args.seed is not None:
            argv2 += ["--seed", str(args.seed)]
        if args.argmax:
            argv2 += ["--argmax"]
        if args.limit:
            argv2 += ["--limit", str(args.limit)]
        print(f"===== {suite} =====", flush=True)
        eval_run.main(argv2)
        result_files = [f for f in os.listdir(os.path.join(args.out_dir, suite))
                        if f.endswith(".json")]
        for rf in result_files:
            with open(os.path.join(args.out_dir, suite, rf)) as f:
                rows = json.load(f)
            summaries.append({
                "suite": suite, "algo": rf[:-5],
                "CSR": float(np.mean([r["CSR"] for r in rows])),
                "ISR": float(np.mean([r["ISR"] for r in rows])),
                "SoC": float(np.mean([r["SoC"] for r in rows])),
            })
    print("\n===== summary =====")
    for s in summaries:
        print(f"{s['suite']:>14} {s['algo']:>24} CSR={s['CSR']:.3f} "
              f"ISR={s['ISR']:.3f} SoC={s['SoC']:.1f}")


if __name__ == "__main__":
    main()
