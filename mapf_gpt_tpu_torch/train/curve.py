"""Extract a training curve from trainer logs into a committed JSON artifact
(a copy of ``mapf_gpt_tpu/train/curve.py``).

The trainer prints ``iter N: loss L | S it/s | mfu M%`` and
``iter N: val_loss VL val_acc VA`` lines (train/loop.py); this CLI collects
them (across resumed segments, later segments winning on overlap) into
``{train: [[iter, loss], ...], val: [[iter, val_loss, val_acc], ...]}``.

Usage: python -m mapf_gpt_tpu_torch.train.curve --logs a.log b.log --out curve.json
"""

from __future__ import annotations

import argparse
import json
import re

TRAIN_RE = re.compile(r"iter (\d+): loss ([\d.]+)")
VAL_RE = re.compile(r"iter (\d+): val_loss ([\d.]+) val_acc ([\d.]+)")


def parse_logs(paths: list[str]) -> dict:
    train: dict[int, float] = {}
    val: dict[int, tuple[float, float]] = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                m = TRAIN_RE.search(line)
                if m:
                    train[int(m.group(1))] = float(m.group(2))
                    continue
                m = VAL_RE.search(line)
                if m:
                    val[int(m.group(1))] = (float(m.group(2)),
                                            float(m.group(3)))
    return {
        "train": [[i, l] for i, l in sorted(train.items())],
        "val": [[i, vl, va] for i, (vl, va) in sorted(val.items())],
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--logs", nargs="+", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    curve = parse_logs(args.logs)
    with open(args.out, "w") as f:
        json.dump(curve, f)
    print(f"{len(curve['train'])} train points, {len(curve['val'])} val "
          f"points -> {args.out}")


if __name__ == "__main__":
    main()
