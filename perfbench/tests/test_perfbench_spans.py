"""The span readers (``spans.py`` and the six ``metrics/*`` that read the
program's ``mapf.`` spans) on hand-built traces whose answers are known, and
on traced CPU runs of two cells at the small sizes of ``test_perfbench_run``."""

import json

import pytest

from perfbench import harness, spans
from perfbench.tests.test_perfbench_run import SMALL

ROLLOUT_READERS = ("arbiter_rounds_per_step.rollout", "env_step_idle_ms.rollout",
                   "observe_idle_ms.rollout", "relax_rounds_per_reset.rollout")
TRAIN_READERS = ("feed_idle_ms.train", "step_idle_ms.train")
# The device busy over [0, 2], [3, 4] and [6, 10] of an 11 s window: idle over
# [2, 3], [4, 6] and [10, 11], 4 s.
KERNELS = [("gemm_kernel", 0.0, 2.0), ("elementwise_kernel", 3.0, 4.0),
           ("gemm_kernel", 6.0, 8.0), ("elementwise_kernel", 7.5, 10.0)]
ROLLOUT_SPANS = [
    ("perfbench.reset", 0.0, 1.0), ("mapf.env.reset", 0.0, 1.0),
    ("mapf.cost2go.relax_round", 0.1, 0.3), ("mapf.cost2go.relax_round", 0.4, 0.6),
    ("perfbench.episode", 1.4, 9.6),
    ("mapf.rollout.step", 1.5, 5.5), ("mapf.obs.observe", 1.5, 2.5), ("aten::index", 2.1, 2.2),
    ("mapf.policy.forward", 2.5, 2.8), ("mapf.policy.act", 2.8, 2.9),
    ("mapf.env.step", 2.9, 5.0), ("mapf.env.arbiter_round", 3.0, 3.5),
    ("mapf.env.arbiter_round", 4.2, 4.8), ("aten::item", 4.3, 4.8),
    ("mapf.rollout.step", 5.5, 9.5), ("mapf.obs.observe", 5.5, 6.5),
    ("mapf.env.step", 7.0, 9.0), ("mapf.env.arbiter_round", 7.1, 7.2),
]
TRAIN_SPANS = [
    ("perfbench.iteration", 1.0, 6.5), ("mapf.data.load_shard", 1.0, 3.0),
    ("mapf.data.batch", 2.5, 3.5), ("mapf.data.batch", 2.6, 2.9),       # nested: counted once
    ("mapf.train.step", 3.5, 6.5), ("mapf.train.forward", 3.5, 4.5),
    ("perfbench.iteration", 6.5, 10.5), ("mapf.data.batch", 6.5, 6.6),
    ("mapf.train.step", 6.6, 10.5), ("mapf.train.step", 6.7, 10.4),   # nested: counted once
]


def _trace(host_ops, kernels=KERNELS, **counts):
    return harness.Trace(window_s=11.0, kernels=list(kernels), host_ops=list(host_ops),
                         config={}, traffic={}, counts=counts)


def _read(name, trace):
    return harness.metric_reader(name)(trace)


@pytest.mark.parametrize("name,want", [
    ("arbiter_rounds_per_step.rollout", 1.5),                  # 3 rounds over 2 steps
    ("env_step_idle_ms.rollout", 1e3 * (0.1 + 1.0) / 2),      # [2.9, 3] and [4, 5]
    ("observe_idle_ms.rollout", 1e3 * (0.5 + 0.5) / 2),       # [2, 2.5] and [5.5, 6]
    ("relax_rounds_per_reset.rollout", 2.0),
])
def test_a_rollout_reader_gives_the_known_value(name, want):
    got = _read(name, _trace(ROLLOUT_SPANS, steps=2, episodes=1))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name,want", [
    ("feed_idle_ms.train", 1e3 * 1.0 / 2),                    # [2, 3]; the batch in it once
    ("step_idle_ms.train", 1e3 * (2.0 + 0.5) / 2),            # [4, 6] and [10, 10.5]
])
def test_a_train_reader_counts_nested_spans_once(name, want):
    got = _read(name, _trace(TRAIN_SPANS, iterations=2))
    assert got == pytest.approx(want, rel=1e-12)


def test_rounds_outside_their_parent_are_not_counted():
    """A relaxation round of the lazy env's step is not a reset's; an arbiter
    round counts only inside an env step."""
    extra = [("mapf.cost2go.relax_round", 3.1, 3.2), ("mapf.env.arbiter_round", 9.6, 9.7)]
    trace = _trace(ROLLOUT_SPANS + extra, steps=2)
    assert _read("relax_rounds_per_reset.rollout", trace) == 2.0
    assert _read("arbiter_rounds_per_step.rollout", trace) == 1.5


@pytest.mark.parametrize("name", ROLLOUT_READERS + TRAIN_READERS)
def test_a_reader_is_none_without_program_spans(name):
    older = [op for op in ROLLOUT_SPANS + TRAIN_SPANS if not op[0].startswith("mapf.")]
    assert _read(name, _trace(older, steps=2, iterations=2)) is None


@pytest.mark.parametrize("name", ("env_step_idle_ms.rollout", "observe_idle_ms.rollout")
                         + TRAIN_READERS)
def test_an_idle_reader_is_none_without_device_operations(name):
    assert _read(name, _trace(ROLLOUT_SPANS + TRAIN_SPANS, kernels=[], steps=2,
                              iterations=2)) is None


def test_the_idle_split_goes_to_the_innermost_span_and_sums_to_the_idle_time():
    trace = _trace(ROLLOUT_SPANS, steps=2)
    split = spans.idle_by_span(trace)
    want = {"mapf.obs.observe": 1.0, "mapf.policy.forward": 0.3, "mapf.policy.act": 0.1,
            "mapf.env.step": 0.5, "mapf.env.arbiter_round": 0.6, "mapf.rollout.step": 0.5,
            spans.NONE: 1.0}
    assert set(split) == set(want)
    for k, v in want.items():
        assert split[k] == pytest.approx(v, abs=1e-12), k
    idle = 1.0 - trace.busy_s() / trace.window_s
    assert sum(split.values()) / trace.window_s == pytest.approx(idle, rel=1e-12)
    got = spans.report(trace)
    assert got["idle_share"] == pytest.approx(100 * idle, rel=1e-12)
    assert got["longest_gaps"][0] == [pytest.approx(2000.0), "mapf.rollout.step"]   # at 5 s
    assert got["spans"]["mapf.env.arbiter_round"] == 3 and got["device_ops_named_mapf"] == []
    by_op = {k: (ms, pieces) for k, ms, pieces in got["idle_by_host_op"]}
    assert by_op["mapf.env.arbiter_round / aten::item"] == (pytest.approx(300.0), 1)
    assert by_op["mapf.obs.observe / mapf.obs.observe"] == (pytest.approx(500.0), 2)
    assert by_op[f"{spans.NONE} / {spans.NONE}"] == (pytest.approx(500.0), 1)
    assert sum(ms for ms, _ in by_op.values()) == pytest.approx(2000.0)   # 4 s over 2 steps


def test_overlap_and_union():
    a = spans._union([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)])
    assert a == [(0.0, 3.0), (5.0, 6.0)]
    assert spans.overlap_seconds(a, [(2.5, 5.5), (5.8, 9.0)]) == pytest.approx(0.5 + 0.5 + 0.2)
    assert spans.overlap_seconds(a, []) == 0.0


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_cpu_run_reports_the_program_spans(capsys, cell):
    rc = spans.main(["--workload", cell, "--seed", "3000000019", "--seconds", "0.5"],
                    require_chip=False, device="cpu", overrides=SMALL[cell])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    result, report = json.loads(lines[-2]), json.loads(lines[-1])["spans_report"]
    assert result["correct"] is True
    metrics, counts = result["metrics"], report["spans"]
    if cell.startswith("rollout"):
        assert metrics["arbiter_rounds_per_step.rollout"]["value"] >= 1.0
        assert metrics["relax_rounds_per_reset.rollout"]["value"] >= 1.0
        assert counts["mapf.rollout.step"] == counts["mapf.env.step"] == report["count"]
        assert counts["mapf.env.reset"] >= 2
    else:
        assert counts["mapf.train.step"] == counts["mapf.data.batch"] == report["count"]
        assert counts["mapf.train.forward"] == 2 * report["count"]
    # the CPU has no device operations: the idle readers are left out
    assert not {"env_step_idle_ms.rollout", "feed_idle_ms.train"} & set(metrics)
    assert report["device_ops_named_mapf"] == []
