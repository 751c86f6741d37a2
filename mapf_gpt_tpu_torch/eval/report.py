"""Results-tree -> markdown summary tables.

    python -m mapf_gpt_tpu_torch.eval.report --results results [--metrics CSR ...]

The port's copy of ``mapf_gpt_tpu/eval/report.py`` (numpy only).  Reads
every ``<results>/<suite>/<algo>.json`` written by eval.run and prints
one markdown table per suite/algo: rows = num_agents, columns = metrics —
the shape of the paper's per-suite curves."""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

DEFAULT_METRICS = ("CSR", "ISR", "SoC", "makespan", "ep_length")


def suite_table(rows: list[dict], metrics) -> str:
    agents = sorted({r["num_agents"] for r in rows})
    lines = ["| num_agents | episodes | " + " | ".join(metrics) + " |",
             "|---" * (len(metrics) + 2) + "|"]
    for a in agents:
        sub = [r for r in rows if r["num_agents"] == a]
        cells = [str(a), str(len(sub))]
        for m in metrics:
            vals = [r[m] for r in sub if m in r]
            cells.append(f"{np.mean(vals):.3f}" if vals else "—")
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--results", required=True)
    p.add_argument("--metrics", nargs="*", default=list(DEFAULT_METRICS))
    args = p.parse_args(argv)

    for path in sorted(glob.glob(os.path.join(args.results, "*", "*.json"))):
        suite = os.path.basename(os.path.dirname(path))
        algo = os.path.basename(path)[:-5]
        with open(path) as f:
            rows = json.load(f)
        print(f"\n### {suite} — {algo} ({len(rows)} episodes)\n")
        print(suite_table(rows, args.metrics))


if __name__ == "__main__":
    main()
