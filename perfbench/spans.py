"""The program's spans in a traced window, set against the device's idle time.

The port opens a ``torch.profiler`` range named ``mapf.<layer>.<part>`` at each
of its layers (``mapf_gpt_tpu_torch/utils/profiling.span``): the rollout step,
``mapf.obs.observe``, ``mapf.policy.forward`` and ``.act``, ``mapf.env.step``
with each ``mapf.env.arbiter_round``, ``mapf.env.reset`` with each
``mapf.cost2go.relax_round``, ``mapf.train.step`` with its ``.forward``,
``.backward`` and ``.optimizer``, and the feed's ``mapf.data.batch`` and
``mapf.data.load_shard``.  They reach the readers as ``harness.Trace.host_ops``,
on the clock of the device's operations.  A program without them (an older
commit) leaves every function here an empty reading, and the readers None.

- :func:`idle_intervals`: the window less the union of the device's operations;
- :func:`span_intervals`: the union of the spans of a name, or under a prefix;
- :func:`overlap_seconds`: the length of two unions' intersection, so that
  nested spans count once;
- :func:`count`: the spans of a name, or those nested in spans of another;
- :func:`idle_by_span`: the idle time split by the innermost program span the
  host was in, and "no program span".

Run as a module, it runs one cell traced, as ``run.py --trace 1`` does, and
prints after the result line one more: that split a step or iteration, the
spans' counts, the ten longest idle gaps with the innermost program span of
each, and any ``mapf.`` name among the device's operations:

    python3 -m perfbench.spans --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import bisect
import heapq
import json
import sys

PREFIX = "mapf."
NONE = "no program span"


def _union(intervals) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def idle_intervals(trace) -> list[tuple[float, float]]:
    """[0, window_s] less the union of ``trace.kernels``, as sorted intervals."""
    gaps, t = [], 0.0
    for s, e in _union((s, e) for _, s, e in trace.kernels):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if trace.window_s > t:
        gaps.append((t, trace.window_s))
    return gaps


def _spans(trace, select) -> list[tuple[float, float]]:
    """The (start, end) of each host span whose name `select` accepts, clipped
    to the window."""
    out = []
    for name, s, e in trace.host_ops:
        if select(name):
            s, e = max(s, 0.0), min(e, trace.window_s)
            if e > s:
                out.append((s, e))
    return out


def span_intervals(trace, name: str | None = None, prefix: str | None = None):
    """The union of the spans named `name`, or of those whose name starts with
    `prefix`."""
    select = (lambda n: n == name) if prefix is None else (lambda n: n.startswith(prefix))
    return _union(_spans(trace, select))


def overlap_seconds(a, b) -> float:
    """The length of the intersection of two sorted unions of intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def count(trace, name: str, within: str | None = None) -> int:
    """The spans named `name` in the window; with `within`, only those that lie
    inside a span named `within` (parentage is nesting)."""
    mine = [(s, e) for n, s, e in trace.host_ops if n == name]
    if within is None:
        return len(mine)
    outer = span_intervals(trace, within)
    starts = [s for s, _ in outer]
    inside = 0
    for s, e in mine:
        k = bisect.bisect_right(starts, s) - 1
        inside += k >= 0 and e <= outer[k][1]
    return inside


def idle_ms(trace, intervals, per: str) -> float | None:
    """Device idle inside `intervals`, in ms per ``trace.counts[per]``; None
    without device operations, spans or the count."""
    n = trace.counts.get(per)
    if not trace.kernels or not intervals or not n:
        return None
    return 1e3 * overlap_seconds(idle_intervals(trace), intervals) / n


def _innermost_at(spans, times) -> list[str]:
    """The name of the innermost of `spans` ((start, end, name); the latest
    started among those open, as spans of one thread nest) at each of the
    sorted `times`, or NONE."""
    spans = sorted(spans)
    out, open_, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            heapq.heappush(open_, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while open_ and open_[0][1] < t:
            heapq.heappop(open_)
        out.append(open_[0][2] if open_ else NONE)
    return out


def _innermost(trace) -> list[tuple[float, float, str]]:
    """The window cut at every program span's ends, each piece labelled by its
    innermost program span, or NONE."""
    mine = [(max(s, 0.0), min(e, trace.window_s), n) for n, s, e in trace.host_ops
            if n.startswith(PREFIX) and min(e, trace.window_s) > max(s, 0.0)]
    cuts = sorted({0.0, trace.window_s, *(s for s, _, _ in mine), *(e for _, e, _ in mine)})
    names = _innermost_at(mine, [(a + b) / 2 for a, b in zip(cuts, cuts[1:])])
    return [(a, b, name) for a, b, name in zip(cuts, cuts[1:], names)]


def _idle_pieces(pieces, gaps) -> list[tuple[float, float, str]]:
    """The idle intervals `gaps` cut where the labelled `pieces` of the window
    change, each with its piece's label."""
    out, i, j = [], 0, 0
    while i < len(pieces) and j < len(gaps):
        lo, hi = max(pieces[i][0], gaps[j][0]), min(pieces[i][1], gaps[j][1])
        if hi > lo:
            out.append((lo, hi, pieces[i][2]))
        if pieces[i][1] < gaps[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_by_span(trace) -> dict[str, float]:
    """Idle seconds by the innermost program span the host was in; the values
    sum to the window's idle time."""
    out: dict[str, float] = {}
    for lo, hi, name in _idle_pieces(_innermost(trace), idle_intervals(trace)):
        out[name] = out.get(name, 0.0) + (hi - lo)
    return out


def report(trace) -> dict:
    """The split a step (rollouts) or iteration (training), in ms, the share of
    the window idle, the spans' counts, the idle a step or iteration by program
    span and innermost host operation (the largest 15, each with its number of
    idle pieces), the ten longest gaps with their innermost program span, and
    the device's operations named ``mapf.``."""
    per = "steps" if "steps" in trace.counts else "iterations"
    n = trace.counts[per]
    pieces, gaps = _innermost(trace), idle_intervals(trace)
    idle = _idle_pieces(pieces, gaps)
    ops = _innermost_at([(s, e, name) for name, s, e in trace.host_ops],
                        [(lo + hi) / 2 for lo, hi, _ in idle])
    split: dict[str, float] = {}
    pairs: dict[str, list] = {}
    for (lo, hi, name), op in zip(idle, ops):
        split[name] = split.get(name, 0.0) + (hi - lo)
        got = pairs.setdefault(f"{name} / {op}", [0.0, 0])
        got[0] += hi - lo
        got[1] += 1
    ends = [b for _, b, _ in pieces]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    names: dict[str, int] = {}
    for name, _, _ in trace.host_ops:
        if name.startswith(PREFIX):
            names[name] = names.get(name, 0) + 1
    return {"per": per, "count": n,
            "idle_share": 100.0 * sum(split.values()) / trace.window_s,
            "idle_ms_per": {k: 1e3 * v / n for k, v in sorted(split.items(), key=lambda kv: -kv[1])},
            "spans": names,
            "idle_by_host_op": [[k, 1e3 * v / n, m] for k, (v, m) in
                                sorted(pairs.items(), key=lambda kv: -kv[1][0])[:15]],
            "longest_gaps": [[1e3 * (e - s), pieces[bisect.bisect_right(ends, (s + e) / 2)][2]
                              if (s + e) / 2 < trace.window_s else NONE]
                             for s, e in longest],
            "device_ops_named_mapf": sorted({k for k, _, _ in trace.kernels
                                             if k.startswith(PREFIX)})}


def main(argv=None, **kwargs) -> int:
    """The traced run of ``harness.main`` (`kwargs` go to it, as the CPU tests
    give them), then the report's line."""
    from perfbench import harness

    traces = []
    plain = harness.trace_from_profiler

    def keep(prof, *args):
        from torch.autograd import DeviceType

        trace = plain(prof, *args)
        marks = [e for e in prof.profiler.kineto_results.events()
                 if e.name().startswith(PREFIX) and e.device_type() == DeviceType.CUDA]
        user = [e for e in marks if getattr(e, "is_user_annotation", lambda: False)()]
        traces.append((trace, {"device_side": len(marks), "user_annotations": len(user)}))
        return trace
    harness.trace_from_profiler = keep
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        rc = harness.main(argv + ["--trace", "1"], **kwargs)
    finally:
        harness.trace_from_profiler = plain
    if rc == 0 and traces:
        trace, marks = traces[0]
        print(json.dumps({"spans_report": dict(report(trace), device_side_mapf_ranges=marks)}),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
