"""One run of one cell: set-up, the measured window, the per-layer readings of a
traced run, the comparison with the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer metric
is data found by name (``BENCHMARK.json``, ``configs/``, ``traffic/``,
``limits/``, ``metrics/<name>.py``); a traffic mix names its driver
(``drivers/<kind>.py``), which knows how to drive the program for that kind of
work.  A driver module has:

- ``setup(run) -> session``: builds the program's objects from the seed and warms
  up every shape the window uses;
- ``window(session, run) -> Window``: drives the program for about
  ``run.seconds`` and ends in a synchronize;
- ``release(session)``: frees the program's state on the device;
- ``check(session, run) -> list[Check]``: the comparison with the reference.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mapf_gpt_tpu")
MARK = "perfbench."          # prefix of the benchmark's own profiler ranges


@dataclass
class Check:
    """One number compared with its limit: ok when value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclass
class Window:
    """What a driver's window did: its length on the host clock, its end-to-end
    readings, and the counts the per-layer readers divide by."""

    seconds: float
    metrics: dict[str, float]
    attempted: int
    failed: int
    counts: dict = field(default_factory=dict)


@dataclass
class Run:
    """The cell and the run's arguments, as the drivers and readers see them."""

    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str) -> tuple[dict, dict, dict, int, list, list]:
    """(config, traffic, limits, chips, end-to-end entries, per-layer entries)
    of one cell of ``BENCHMARK.json``."""
    bench = _read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"perfbench: no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(ROOT / configs[cell["config"]]["file"])
    traffic = _read_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = _read_json(HERE / "limits" / f"{workload}.json")
    mine = lambda m: "workloads" not in m or workload in m["workloads"]
    return (config, traffic, limits, int(cell["chips"]),
            [m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def metric_reader(name: str):
    """The ``read(trace)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + "".join(c if c.isalnum() else "_" for c in name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# the traced window
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    """A traced window as the per-layer readers see it.  Times in seconds from
    the window's start; ``kernels`` are (qualified name, start, end) of every
    operation that ran on the device; ``host_ops`` (name, start, end) of the
    host's profiled operations."""

    window_s: float
    kernels: list
    host_ops: list
    config: dict
    traffic: dict
    counts: dict

    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.kernels])

    def device_seconds(self, names, exclude=False) -> float:
        """Summed device time of the operations whose qualified name is in
        `names` (or, with exclude, of all the others)."""
        names = set(names)
        return sum(e - s for k, s, e in self.kernels if (k in names) != exclude)


def union_seconds(intervals) -> float:
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _ns(ev, which: str) -> int:
    f = getattr(ev, f"{which}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{which}_us")() * 1000)


def trace_from_profiler(prof, config: dict, traffic: dict, counts: dict) -> Trace:
    """Device operations and host operations of the ``perfbench.window`` range."""
    from torch.autograd import DeviceType
    from perfbench.frozen import kernel_key

    events = list(prof.profiler.kineto_results.events())
    win = [e for e in events if e.name() == MARK + "window" and e.device_type() == DeviceType.CPU]
    if not win:
        raise RuntimeError("perfbench: the profiler recorded no window range")
    t0, t1 = _ns(win[0], "start"), _ns(win[0], "end")
    sec = lambda ns: (ns - t0) * 1e-9
    kernels, host = [], []
    for e in events:
        s, t = _ns(e, "start"), _ns(e, "end")
        if t < t0 or s > t1:
            continue
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            user = getattr(e, "is_user_annotation", None)
            if name.startswith(MARK) or (user is not None and user()):
                continue
            kernels.append((kernel_key(name), sec(max(s, t0)), sec(min(t, t1))))
        elif not name.startswith(MARK + "window"):
            host.append((name, sec(s), sec(t)))
    return Trace(window_s=sec(t1), kernels=kernels, host_ops=host, config=config,
                 traffic=traffic, counts=counts)


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time, and the ten longest idle
    gaps named by the innermost host operation running at their middle."""
    by_name: dict[str, float] = {}
    for k, s, e in trace.kernels:
        by_name[k] = by_name.get(k, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, end = [], 0.0
    for s, e in sorted((s, e) for _, s, e in trace.kernels):
        if s > end:
            gaps.append((s - end, (s + end) / 2))
        end = max(end, e)
    if trace.window_s > end:
        gaps.append((trace.window_s - end, (trace.window_s + end) / 2))
    gaps = sorted(gaps, reverse=True)[:10]
    if trace.host_ops:
        names = [h[0] for h in trace.host_ops]
        starts = np.array([h[1] for h in trace.host_ops])
        ends = np.array([h[2] for h in trace.host_ops])
    idle = []
    for length, mid in gaps:
        label = "no host operation"
        if trace.host_ops:
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            if len(inside):
                label = names[inside[np.argmax(starts[inside])]]
            else:
                before = np.flatnonzero(ends < mid)
                if len(before):
                    label = "after " + names[before[np.argmax(ends[before])]]
        idle.append([label, length])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: float | None = None, require_chip: bool = True,
         device: str = "cuda", overrides: dict | None = None) -> int:
    """Run one cell once and print its result line; the exit code.

    `require_chip`, `device` and `overrides` (replacements for the cell's
    ``config``, ``traffic`` and ``limits`` dicts) are for the CPU tests, which
    drive the rest of a run at a small size without a card."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    config, traffic, limits, chips, e2e, per_layer = load_cell(args.workload)
    for key, val in (overrides or {}).items():
        {"config": config, "traffic": traffic, "limits": limits}[key].update(val)

    import torch

    if require_chip:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"perfbench: {args.workload} needs {chips} CUDA device(s); found {have}",
                  file=sys.stderr)
            return 2
    run = Run(workload=args.workload, config=config, traffic=traffic, limits=limits,
              seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=device)
    driver = importlib.import_module(f"perfbench.drivers.{traffic['kind']}")
    cuda = torch.device(device).type == "cuda"

    session = driver.setup(run)
    setup_s = time.perf_counter() - t_start
    prof = None
    if run.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    with torch.profiler.record_function(MARK + "window"):
        win = driver.window(session, run)
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    peak = max(peak, int(win.counts.get("setup_peak_bytes", 0)))

    metrics = {}
    if run.trace:
        trace = trace_from_profiler(prof, config, traffic, win.counts)
        del prof
        for m in per_layer:
            value = metric_reader(m["name"])(trace)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        readings = dict(win.metrics, setup_s=setup_s)
        for m in e2e:
            if m["name"] in readings:
                metrics[m["name"]] = {"value": float(readings[m["name"]]), "unit": m["unit"]}

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": chips, "memory_peak_bytes": int(peak),
                   "power_limit": _power_limit() if cuda else "not read"}
    if run.trace:
        device_info["busy_s"] = trace.busy_s()
        device_info["window_s"] = trace.window_s
    window_end = time.perf_counter()
    driver.release(session)
    checks = driver.check(session, run)
    timing = (f"perfbench: setup {setup_s:.1f} s, window {win.seconds:.1f} s, after it "
              f"{time.perf_counter() - window_end:.1f} s (the reference's check included); "
              f"the window's episodes or iterations on the device, ms: "
              f"{[round(v, 1) for v in win.counts.get('phase_ms', [])]}")
    correct = all(c.ok for c in checks)

    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": win.attempted, "failed": win.failed,
              "metrics": metrics, "device": device_info}
    if run.trace:
        result["breakdown"] = breakdown(trace)
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    print(json.dumps(result), flush=True)
    print(timing, file=sys.stderr, flush=True)
    for c in checks:
        print(f"compared {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)
    return 0
