"""BENCHMARK.json against the rules it is held to, and every file it names."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and (ROOT / p).is_dir() and not p.endswith("_torch")
    assert (ROOT / BENCH["command"][1]).is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in METRICS]
    names += [w["traffic"] for w in BENCH["workloads"]] + [w["config"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for kind in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in kind}) == len(kind)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and _line(w["why"])
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])


def test_each_cell_reports_what_it_must():
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in E2E["setup_s"]
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        mine = [m["name"] for m in BENCH["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(_reports(m, w["name"]) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_an_end_to_end_metric_its_cells_report(metric):
    moved = E2E[metric["moves"]]
    for cell in metric["workloads"]:
        assert _reports(moved, cell), (metric["name"], cell)
    assert (ROOT / "perfbench" / "metrics" / f"{metric['name']}.py").is_file()


def test_run_seconds_fit_the_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_exist(cell):
    cfg = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert cfg["file"].startswith("perfbench/") and (ROOT / cfg["file"]).is_file()
    traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "perfbench" / "drivers" / f"{traffic['kind']}.py").is_file()
    limits = json.loads((ROOT / "perfbench" / "limits" / f"{cell['name']}.json").read_text())
    assert all(v > 0 for k, v in limits.items() if isinstance(v, (int, float)))


@pytest.mark.parametrize("name,widths", [
    ("mapf-gpt-6M", {"n_layer": 8, "n_head": 8, "n_embd": 256, "batch_size": 2048}),
    ("mapf-gpt-85M", {"n_layer": 12, "n_head": 12, "n_embd": 768, "batch_size": 512}),
])
def test_configurations_keep_the_published_sizes(name, widths):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["reduced"] == [] and cfg["reduced"] == []
    published = dict(widths, block_size=256, vocab_size=67, bias=False, dropout=0.0,
                     gradient_accumulation_steps=16)
    assert {k: cfg[k] for k in published} == published


def test_files_under_paths_are_named_from_name_characters():
    for path in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
        assert NAME.match(path.name), rel
