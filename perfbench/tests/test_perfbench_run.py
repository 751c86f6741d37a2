"""Whole runs of the harness on the CPU at a small size (the look for a card
skipped): the result line's keys, ``correct`` true on the program as it is and
false with the timed path broken underneath, the control against the limits,
and the imports of a run."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import calibrate, harness

ROOT = Path(__file__).resolve().parents[2]
TINY = {"n_layer": 2, "n_head": 2, "n_embd": 32, "gelu": "erf"}
# Limits at this size on the CPU (the module route in bfloat16), between the
# program's readings here (logit_err 0.0014; grad_gap 7e-4, grad_diff 3.5e-3,
# change_gap 9e-4) and the float8 control's (0.011; 8.7e-3, 0.052, 4.2e-3): the
# cells' own limits are set on the card at their own sizes (limits/<cell>.json).
SMALL = {
    "rollout-6M-random21": {"config": TINY, "limits": {"logit_err": 0.005}, "traffic": {
        "envs": 4, "agents": 8, "steps": 6, "warmup_steps": 2, "check_envs": 4,
        "check_rows": 64}},
    "train-85M-ref": {"config": TINY,
                      "limits": {"grad_gap": 0.003, "grad_diff": 0.015, "change_gap": 0.0025},
                      "traffic": {"micro_batch": 8, "grad_accum": 2, "reference_rows": 8}},
}
KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


def run_cell(capsys, cell: str, trace: int = 0, seed: int = 3000000017) -> dict:
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", str(trace)], require_chip=False, device="cpu",
                      overrides=SMALL[cell])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_result_line_has_the_contracts_keys_and_passes(capsys, cell):
    got = run_cell(capsys, cell)
    assert set(got) == KEYS and list(got)[-1] == "compared"
    assert got["correct"] is True and got["failed"] == 0 and got["attempted"] > 0
    assert "setup_s" in got["metrics"] and len(got["metrics"]) >= 2
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(got["device"])
    for c in got["compared"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_run_has_a_breakdown(capsys, cell):
    got = run_cell(capsys, cell, trace=1)
    assert set(got) == KEYS | {"breakdown"} and list(got)[-1] == "compared"
    assert set(got["breakdown"]) == {"device_ops", "idle_gaps"}
    assert got["device"]["window_s"] > 0 and got["correct"] is True


def _stuck_env_step(monkeypatch):
    from mapf_gpt_tpu_torch.envs import env

    monkeypatch.setattr(env, "step", lambda spec, state, actions: state)


def _half_batch_forward(monkeypatch):
    from mapf_gpt_tpu_torch.parallel import rollout

    real = rollout.make_forward

    def half(model):
        forward = real(model)

        def run(tokens):
            got = forward(tokens[:len(tokens) // 2])
            return torch.cat([got, got])[:len(tokens)]
        return run
    monkeypatch.setattr(rollout, "make_forward", half)


def _token_altered(monkeypatch):
    from mapf_gpt_tpu_torch.parallel import rollout

    real = rollout.observe

    def altered(*args):
        tokens = real(*args).clone()
        tokens[..., 0] = (tokens[..., 0] + 1) % 67
        return tokens
    monkeypatch.setattr(rollout, "observe", altered)


def _logit_altered(monkeypatch):
    from mapf_gpt_tpu_torch.parallel import rollout

    real = rollout.make_forward

    def altered(model):
        forward = real(model)

        def run(tokens):
            got = forward(tokens).clone()
            got[0, 0] += 1.0
            return got
        return run
    monkeypatch.setattr(rollout, "make_forward", altered)


def _state_unchanged(monkeypatch):
    from mapf_gpt_tpu_torch.train import train_step

    monkeypatch.setattr(train_step.AdamW, "update", lambda self, grads: None)


def _half_batch_loss(monkeypatch):
    from mapf_gpt_tpu_torch.train import train_step

    real = train_step.select_loss_fn

    def half(model, use_fused=None):
        loss = real(model, use_fused)
        return lambda x, y: loss(x[:len(x) // 2], y[:len(y) // 2])
    monkeypatch.setattr(train_step, "select_loss_fn", half)


def _gradient_altered(monkeypatch):
    from mapf_gpt_tpu_torch.train import train_step

    real = train_step.AdamW.update

    def altered(self, grads):
        grads = list(grads)
        grads[2] = grads[2] * 2.0        # one leaf's gradient, as the backward hands it on
        return real(self, grads)
    monkeypatch.setattr(train_step.AdamW, "update", altered)


@pytest.mark.parametrize("cell,fault", [
    ("rollout-6M-random21", _stuck_env_step),
    ("rollout-6M-random21", _half_batch_forward),
    ("rollout-6M-random21", _token_altered),
    ("rollout-6M-random21", _logit_altered),
    ("train-85M-ref", _state_unchanged),
    ("train-85M-ref", _half_batch_loss),
    ("train-85M-ref", _gradient_altered),
], ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    got = run_cell(capsys, cell)
    assert got["correct"] is False, got["compared"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_float8_control_fails_the_limits(cell):
    config, traffic, limits, _, _, _ = harness.load_cell(cell)
    small = SMALL[cell]
    config, traffic = dict(config, **small["config"]), dict(traffic, **small["traffic"])
    limits = dict(limits, **small["limits"])
    run = harness.Run(workload=cell, config=config, traffic=traffic, limits=limits,
                      seed=4000000011, seconds=0.0, trace=False, device="cpu")
    read = calibrate.rollout_readings if traffic["kind"] == "rollout" else calibrate.train_readings
    got = read(run)
    control = {k: v for k, v in got["control"].items() if k in limits}
    assert any(control[k] > limits[k] for k in control), (control, limits)
    assert all(v <= limits.get(k, 0) for k, v in got["program"].items()), got["program"]


def test_without_a_card_the_run_exits_non_zero_and_prints_no_result():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "rollout-6M-random21",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_run_loads_nothing_of_jax():
    code = ("import sys, json; sys.path.insert(0, '.'); from perfbench import harness; "
            "import perfbench.drivers.rollout, perfbench.drivers.train, perfbench.calibrate; "
            "[harness.metric_reader(m['name']) for m in "
            "json.load(open('BENCHMARK.json'))['per_layer']]; "
            "import mapf_gpt_tpu_torch.parallel.rollout, mapf_gpt_tpu_torch.train.train_step, "
            "mapf_gpt_tpu_torch.train.data; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "rollout-6M-random21",
                          "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


def test_in_a_directory_of_the_benchmark_alone_the_run_fails(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = ['.']; from perfbench import harness; "
            "sys.exit(harness.main(['--workload', 'rollout-6M-random21', '--seed', '1', "
            "'--seconds', '1', '--trace', '0'], require_chip=False, device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "mapf_gpt_tpu_torch" in out.stderr
