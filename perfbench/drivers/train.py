"""Training traffic: the program's ``train/train_step.make_train_step`` (gradient
accumulation, global-norm clip, AdamW) on micro-batches that the program's
``train/data.ArrowShardStream`` streams from Arrow shards, as ``train/loop.py``
feeds it.

Traffic keys: ``micro_batch``, ``grad_accum``, ``shard_files`` (shards of one
iteration's rows each, written at set-up under ``TMPDIR`` from the seed: random
tokens over the vocabulary, targets over the actions), ``setup_steps`` (the
iterations that warm up every shape before the window), ``reference_steps``
(how many of them the reference follows), ``reference_rows`` (contexts a
reference block).

The comparison: set-up builds one training step (model, optimizer state) from
the seed, drives it through its first iterations by the window's own call and
feed, and hands that same object to the window.  The benchmark records which of
its rows the feed served, each step's loss, each leaf's first gradient as the
optimizer got it (its first moment after one step over 1 - beta1) and each
leaf's change after the followed steps.  The reference computes the same from
the benchmark's weights and rows.
"""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench.harness import MARK, Check, Window
from perfbench.reference import gpt as ref_gpt
from perfbench.reference import train as ref_train
from perfbench.shards import RowIndex, make_rows, write_arrow_shard
from perfbench.weights import make_weights

ACTIONS = 5


def hyperparameters(cfg: dict) -> dict:
    """The optimizer's settings of a configuration file's ``train`` group."""
    t = cfg["train"]
    return {"learning_rate": t["learning_rate"], "min_lr": t["min_lr"],
            "warmup_iters": t["warmup_iters"], "lr_decay_iters": t["lr_decay_iters"],
            "weight_decay": t["weight_decay"], "beta1": t["beta1"], "beta2": t["beta2"],
            "grad_clip": t["grad_clip"]}


@dataclass
class Session:
    step: object
    stream: object
    tmp: tempfile.TemporaryDirectory
    weights: dict
    tokens: np.ndarray
    targets: np.ndarray
    fed: list                      # row indices of each followed step
    feed_faults: int
    prog: dict                     # the program's readings
    iterations: int
    setup_peak: int
    losses: list = field(default_factory=list)


def _on_device(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(a).to(dev, non_blocking=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(run) -> Session:
    from mapf_gpt_tpu_torch.train.data import ArrowShardStream
    from mapf_gpt_tpu_torch.train.train_step import TrainConfig, make_optimizer, make_train_step

    from perfbench.program import build_model

    cfg, tr, dev = run.config, run.traffic, torch.device(run.device)
    micro, accum = tr["micro_batch"], tr["grad_accum"]
    need = micro * accum
    tokens, targets = make_rows(run.seed, tr["shard_files"] * need, cfg["block_size"],
                                cfg["vocab_size"], ACTIONS)
    tmp = tempfile.TemporaryDirectory(prefix="perfbench-shards-")
    for f in range(tr["shard_files"]):
        write_arrow_shard(os.path.join(tmp.name, f"shard_{f:03d}.arrow"),
                          tokens[f * need:(f + 1) * need], targets[f * need:(f + 1) * need])
    weights = make_weights(cfg, run.seed, dev)
    model = build_model(cfg, weights, dev, train=True)
    hp = hyperparameters(cfg)
    tc = TrainConfig(grad_accum=accum, **hp)
    optimizer = make_optimizer(model, tc)
    step = make_train_step(model, tc, optimizer)
    stream = iter(ArrowShardStream(tmp.name, micro, accum, seed=run.seed % (1 << 31)))
    names = [n for n, _ in model.named_parameters()]
    index = RowIndex(tokens)

    follow = tr["reference_steps"]
    fed, faults, losses = [], 0, []
    prog = {"losses": [], "first_grad": {}, "first_grad_vectors": {}, "change": {}}
    for k in range(tr["setup_steps"]):
        x, y = next(stream)
        if k < follow:
            rows = index.find(x.reshape(-1, x.shape[-1]))
            faults += int((rows < 0).sum())
            ok = rows >= 0
            faults += int((targets[rows[ok]] != y.reshape(-1)[ok]).sum())
            fed.append(rows)
        t0 = time.perf_counter()
        loss = step(_on_device(x, dev), _on_device(y, dev))
        _sync(dev)
        pace = time.perf_counter() - t0
        losses.append(float(loss))
        with torch.no_grad():
            if k == 0:
                first = {n: m / (1.0 - tc.beta1) for n, m in zip(names, optimizer.mu)}
                prog["first_grad"] = {n: float(g.double().norm()) for n, g in first.items()}
                prog["first_grad_vectors"] = {n: g.to("cpu", copy=True) for n, g in first.items()}
            if k == follow - 1:
                prog["change"] = {n: float((p.detach() - weights[n]).double().norm())
                                  for n, p in zip(names, optimizer.params)}
    prog["losses"] = losses[:follow]
    seen = np.concatenate(fed)
    faults += len(seen) - len(np.unique(seen[seen >= 0])) - int((seen < 0).sum())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return Session(step=step, stream=stream, tmp=tmp, weights=weights, tokens=tokens,
                   targets=targets, fed=fed, feed_faults=faults, prog=prog,
                   iterations=max(1, int(run.seconds // pace)), setup_peak=peak)


def window(s: Session, run) -> Window:
    tr, dev = run.traffic, torch.device(run.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(s.iterations + 1)] if cuda else []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(s.iterations):
        if cuda:
            marks[i].record()
        with torch.profiler.record_function(MARK + "iteration"):
            x, y = next(s.stream)
            s.losses.append(s.step(_on_device(x, dev), _on_device(y, dev)))
    if cuda:
        marks[-1].record()
    _sync(dev)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    failed = int(sum(not np.isfinite(float(v)) for v in s.losses))
    samples = s.iterations * tr["micro_batch"] * tr["grad_accum"]
    counts = {"iterations": s.iterations, "micro_batches": s.iterations * tr["grad_accum"],
              "micro_batch": tr["micro_batch"], "samples": samples,
              "setup_peak_bytes": s.setup_peak,
              "phase_ms": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]}
    return Window(seconds=seconds,
                  metrics={"train_samples_per_s": samples / seconds,
                           "train_peak_mem_gib": peak / 2 ** 30},
                  attempted=s.iterations, failed=failed, counts=counts)


def release(s: Session) -> None:
    s.step = s.stream = None
    s.losses = []
    gc.collect()
    s.tmp.cleanup()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(s: Session, run) -> list[Check]:
    tr, dev = run.traffic, torch.device(run.device)
    batches = []
    for rows in s.fed:
        rows = np.where(rows < 0, 0, rows)
        batches.append((torch.from_numpy(s.tokens[rows].astype(np.int64)).to(dev),
                        torch.from_numpy(s.targets[rows].astype(np.int64)).to(dev)))
    with ref_gpt.fp32_exact():
        ref = ref_train.run_steps(s.weights, run.config, hyperparameters(run.config), batches,
                                  tr["reference_rows"])
    gaps = ref_train.gaps(s.prog, ref)
    for name, value in gaps.items():
        if name not in run.limits:
            print(f"perfbench: {name} {value!r} (not compared in this cell)", file=sys.stderr)
    return [Check("feed_faults", s.feed_faults, 0)] + [
        Check(name, value, run.limits[name]) for name, value in gaps.items() if name in run.limits]
