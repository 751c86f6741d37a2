"""The port's evaluator and its CLIs against the JAX package's
(``tests/test_eval.py`` is the JAX side):

- ``Evaluator.run`` rows equal the JAX ``Evaluator``'s with
  ``do_sample=False``, the trained 2M in fp32, on one-shot specs (two map tiers, several
  agent tiers) and on lifelong warehouse specs (``on_target="restart"``,
  K = 4, lazy and dense cost2go), every key but ``runtime``; the lazy and
  dense runs equal each other;
- the final short chunk is tiered, not padded to the full batch; padding
  slots park on free cells when the free cells run out (arrays equal to
  JAX ``_build_instance``'s);
- ``expand_grid_search``, ``resolve_algorithm``, ``tabular_view`` and
  ``report.suite_table`` equal the JAX versions; the ``benchmark`` CLI
  passes its flags through to ``eval.run``; the SVG string equals JAX
  ``render_episode_svg``'s;
- ``runtime`` rows are positive and shared within a chunk; the context
  cap is fixed on the CPU;
- ``eval.run``, ``eval.example`` and ``eval.bigmap`` run end to end on the
  CPU from an inline suite (``load_policy`` from ``--random-init``, a
  reference ``.pt`` and a trainer's checkpoint directory), and
  ``bench.measure`` at a small size.
"""

import argparse
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.eval import animation as janim
from mapf_gpt_tpu.eval import harness as jh
from mapf_gpt_tpu.eval import report as jreport
from mapf_gpt_tpu.eval import run as jrun
from mapf_gpt_tpu.maps import MapRegistry as JRegistry
from mapf_gpt_tpu.models.convert import load_torch_checkpoint
from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.models.gpt import init_params
from mapf_gpt_tpu_torch import bench
from mapf_gpt_tpu_torch.eval import animation, benchmark, bigmap, example, report
from mapf_gpt_tpu_torch.eval import harness as th
from mapf_gpt_tpu_torch.eval import run as trun
from mapf_gpt_tpu_torch.maps import MapRegistry, grid_to_str, random_grid, warehouse_grid
from mapf_gpt_tpu_torch.models.convert import (load_model, load_reference_checkpoint,
                                               params_to_state_dict)
from mapf_gpt_tpu_torch.models.gpt import GPTConfig
from mapf_gpt_tpu_torch.utils import checkpoint as ckpt

WAREHOUSE = warehouse_grid(2, 3, 1, 3, 1, 1)
CKPT_2M = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "checkpoints", "MAPF-GPT-2M-r4.pt")


@pytest.fixture(scope="module")
def policy():
    """(JAX config, JAX params, the port's model): 1 layer, 2 heads, 32 wide,
    fp32, weights scaled 8x so that actions depend on the inputs."""
    jcfg = JGPTConfig(n_layer=1, n_head=2, n_embd=32, dtype=jnp.float32)
    params = jax.tree_util.tree_map(lambda x: x * 8.0, init_params(jcfg, jax.random.PRNGKey(2)))
    cfg = GPTConfig(n_layer=1, n_head=2, n_embd=32, dtype=torch.float32)
    sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return jcfg, params, load_model(cfg, sd, device="cpu")


@pytest.fixture(scope="module")
def trained():
    """The trained 2M in fp32 on both sides, whose agents do reach their
    goals (the lifelong specs' throughput is not 0)."""
    jcfg, params = load_torch_checkpoint(CKPT_2M)
    cfg, sd = load_reference_checkpoint(CKPT_2M)
    return (dataclasses.replace(jcfg, dtype=jnp.float32), params,
            load_model(dataclasses.replace(cfg, dtype=torch.float32), sd, device="cpu"))


def _registries():
    regs = (MapRegistry(), JRegistry())
    for reg in regs:
        reg.register("tiny", random_grid(8, 0.1, 0))
        reg.register("wide", random_grid(13, 0.2, 1))
        reg.register("wh", WAREHOUSE)
    return regs


def _rows_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        assert {k: v for k, v in g.items() if k != "runtime"} == \
               {k: v for k, v in r.items() if k != "runtime"}


ONE_SHOT = [("tiny", 2, s, 8) for s in range(3)] + [("wide", 5, s, 10) for s in range(2)] \
    + [("tiny", 9, 4, 8)]


@pytest.mark.parametrize("lazy", [True, False])
def test_evaluator_rows_match_jax(trained, lazy):
    jcfg, params, model = trained
    reg, jreg = _registries()
    specs = [dict(map_name=m, num_agents=a, seed=s, max_episode_steps=t)
             for m, a, s, t in ONE_SHOT]
    specs += [dict(map_name="wh", num_agents=6, seed=s, max_episode_steps=12,
                   on_target="restart", num_queued_goals=4) for s in range(3)]
    ev = th.Evaluator(reg, model, batch_envs=2, do_sample=False, lazy_lifelong=lazy,
                      device="cpu")
    got = ev.run([th.EpisodeSpec(**s) for s in specs])
    jev = jh.Evaluator(jreg, jcfg, params, batch_envs=2, do_sample=False, lazy_lifelong=lazy)
    ref = jev.run([jh.EpisodeSpec(**s) for s in specs])
    _rows_equal(got.rows, ref.rows)
    lifelong = [r for r in got.rows if r["map_name"] == "wh"]
    assert all(r["ep_length"] == 12 for r in lifelong)
    assert sum(r["avg_throughput"] for r in lifelong) > 0
    assert all(r["runtime"] > 0 for r in got.rows)


def test_final_chunk_is_tiered_and_runtime_shared(policy):
    _, _, model = policy
    reg, _ = _registries()
    ev = th.Evaluator(reg, model, batch_envs=64, do_sample=False, device="cpu")
    res = ev.run([th.EpisodeSpec("tiny", 2, s, max_episode_steps=4) for s in range(9)])
    assert [r["seed"] for r in res.rows] == list(range(9))
    assert len({r["runtime"] for r in res.rows}) == 1 and res.rows[0]["runtime"] > 0
    # a sampled run is reproducible from sample_seed
    runs = [th.Evaluator(reg, model, batch_envs=4, do_sample=True, sample_seed=5,
                         device="cpu").run([th.EpisodeSpec("tiny", 3, s, max_episode_steps=6)
                                            for s in range(5)]).rows for _ in range(2)]
    _rows_equal(*runs)


def test_build_instance_free_cell_exhaustion():
    grid = np.ones((5, 5), dtype=bool)
    grid[1, 1:4] = False                 # exactly 3 free cells
    reg, jreg = MapRegistry(), JRegistry()
    reg.register("dense", grid)
    jreg.register("dense", grid)
    spec = dict(map_name="dense", num_agents=2, seed=0, max_episode_steps=4)
    got = th.Evaluator(reg, None)._build_instance(th.EpisodeSpec(**spec), (16, 16), 8)
    ref = jh.Evaluator(jreg, None, None)._build_instance(jh.EpisodeSpec(**spec), (16, 16), 8)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    g, starts, goals, active = got
    assert active[:2].all() and not active[2:].any()
    for k in range(2, 8):
        assert not g[starts[k, 0], starts[k, 1]] and (goals[k] == starts[k][None]).all()


def test_grid_search_and_views_match_jax():
    cfg = {"max_episode_steps": 64, "num_agents": {"grid_search": [2, 4]},
           "seed": {"grid_search": [0, 1]}, "map_name": {"grid_search": ["a", "b"]},
           "on_target": {"grid_search": ["nothing", "restart"]}}
    got, ref = th.expand_grid_search(cfg), jh.expand_grid_search(cfg)
    assert [vars(s) for s in got] == [vars(s) for s in ref] and len(got) == 16
    assert th.expand_grid_search({"map_name": "x"}) == [th.EpisodeSpec("x", 1, 0)]
    rows = [{"map_name": "m", "num_agents": a, "seed": s, "CSR": float(s), "ISR": 0.5 * s,
             "SoC": 4.0 + a, "makespan": 2.0, "ep_length": 2.0 + s, "runtime": 0.1,
             "avg_agents_density": 0.1, "avg_throughput": 0.0}
            for a in (2, 4) for s in (0, 1)]
    for drop in ([], ["seed"], ["seed", "map_name"]):
        assert th.tabular_view(rows, drop) == jh.tabular_view(rows, drop)
    metrics = list(report.DEFAULT_METRICS) + ["avg_throughput", "missing"]
    assert report.suite_table(rows, metrics) == jreport.suite_table(rows, metrics)
    assert th._tier(33) == jh._tier(33) == 64 and th._tier(9, 8) == 16


def test_report_cli(tmp_path, capsys):
    rows = [{"algorithm": "x", "num_agents": 4, "CSR": 1.0, "ISR": 1.0, "SoC": 8.0,
             "makespan": 3.0, "ep_length": 3.0}]
    os.makedirs(tmp_path / "suite")
    (tmp_path / "suite" / "algo.json").write_text(json.dumps(rows))
    report.main(["--results", str(tmp_path)])
    out = capsys.readouterr().out
    jreport.main(["--results", str(tmp_path)])
    assert out == capsys.readouterr().out and "| 4 | 1 | 1.000" in out


def test_resolve_algorithm_matches_jax():
    suite_cfg = {"algorithms": {
        "MAPF-GPT-2M": {"name": "MAPF-GPT", "num_process": 4,
                        "path_to_weights": "weights/MAPF-GPT-2M.pt",
                        "mask_greed_action": True}}}
    for algo, mask in (("MAPF-GPT-2M", None), ("MAPF-GPT-2M", ["cost2go"]), (None, ["goal"])):
        args = argparse.Namespace(algo=algo, mask=mask)
        got, ref = trun.resolve_algorithm(suite_cfg, args), jrun.resolve_algorithm(suite_cfg, args)
        assert got[0] == ref[0] and tuple(got[1]) == tuple(ref[1])
    for args in (argparse.Namespace(algo="nope", mask=None),
                 argparse.Namespace(algo=None, mask=["colour"])):
        with pytest.raises(SystemExit):
            trun.resolve_algorithm(suite_cfg, args)


def test_benchmark_cli_passthrough(monkeypatch, tmp_path):
    (tmp_path / "01-random").mkdir()
    (tmp_path / "results" / "01-random").mkdir(parents=True)
    captured = []
    monkeypatch.setattr(trun, "main", lambda argv: captured.append(argv))
    benchmark.main(["--configs-root", str(tmp_path), "--suites", "01-random", "02-mazes",
                    "--out-dir", str(tmp_path / "results"), "--algo", "MAPF-GPT-2M",
                    "--weights-root", "/w", "--mask", "greed_action", "cost2go",
                    "--seed", "7", "--argmax", "--limit", "3", "--device", "cpu"])
    assert len(captured) == 1             # 02-mazes is absent: skipped
    argv = captured[0]

    def val(flag):
        return argv[argv.index(flag) + 1]

    assert val("--algo") == "MAPF-GPT-2M" and val("--weights-root") == "/w"
    assert val("--seed") == "7" and val("--limit") == "3" and val("--device") == "cpu"
    mi = argv.index("--mask")
    assert argv[mi + 1:mi + 3] == ["greed_action", "cost2go"] and "--argmax" in argv
    assert os.path.basename(val("--suite")) == "01-random"


def test_svg_matches_jax():
    grid = np.zeros((6, 6), dtype=bool)
    grid[0] = True
    positions = np.asarray([[[2, 2], [3, 3]], [[2, 3], [3, 4]], [[2, 4], [3, 4]]])
    goals = np.asarray([[2, 5], [3, 5]])
    for kw in ({}, {"active": np.array([True, False]), "trim_border": 1, "step_s": 0.5}):
        svg = animation.render_episode_svg(grid, positions, goals, **kw)
        assert svg == janim.render_episode_svg(grid, positions, goals, **kw)
    assert svg.startswith("<svg") and svg.endswith("</svg>") and svg.count("<animate") == 2


def test_context_cap_on_the_cpu(policy):
    cfg = policy[2].cfg
    assert th.default_max_contexts(cfg, "cpu", (30, 80)) == th.CPU_MAX_CONTEXTS
    small, big = th.context_bytes(cfg, (30, 30), 1, True), th.context_bytes(cfg, (60, 60), 16,
                                                                             False)
    assert 0 < small < big


def _suite(tmp_path):
    """An inline suite: maps.yaml (a random map and a warehouse with
    placement-restricted cells) and its yaml, in the reference's format."""
    suite = tmp_path / "07-inline"
    suite.mkdir()
    maps = {"rand": grid_to_str(random_grid(9, 0.2, 3)),
            "wh": "@@.....\n.#..#..\n$$..!..\n......."}
    (suite / "maps.yaml").write_text("".join(
        f"{name}: |-\n" + "".join(f"  {row}\n" for row in text.split("\n"))
        for name, text in maps.items()))
    (suite / "07-inline.yaml").write_text(
        "environment:\n  max_episode_steps: 6\n  on_target: nothing\n"
        "  map_name:\n    grid_search: [rand, wh]\n  num_agents:\n    grid_search: [2, 3]\n"
        "  seed:\n    grid_search: [0, 1]\n"
        "algorithms:\n  MAPF-GPT-2M:\n    name: MAPF-GPT\n    mask_goal: true\n"
        "results_views:\n  TabularResults:\n    type: tabular\n    drop_keys: [seed]\n")
    return suite


def test_run_example_and_bigmap_clis_on_the_cpu(tmp_path, capsys):
    suite = _suite(tmp_path)
    out = tmp_path / "results"
    trun.main(["--suite", str(suite), "--random-init", "2M", "--device", "cpu", "--argmax",
               "--limit", "5", "--out-dir", str(out), "--algo", "MAPF-GPT-2M",
               "--batch-envs", "4"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["episodes"] == 5 and last["algo"] == "MAPF-GPT-2M-goal"
    rows = json.load(open(out / "07-inline" / "MAPF-GPT-2M-goal.json"))
    assert len(rows) == 5 and all(0 <= r["ISR"] <= 1 for r in rows)
    trun.main(["--suite", str(suite), "--random-init", "2M", "--device", "cpu", "--argmax",
               "--limit", "2", "--out-dir", str(out), "--on-target", "restart",
               "--queued-goals", "3", "--agents", "2"])
    rows = json.load(open(out / "07-inline-lifelong" / "MAPF-GPT-2M-random.json"))
    assert len(rows) == 2 and all(r["ep_length"] == 6 for r in rows)
    capsys.readouterr()

    svg = tmp_path / "ep.svg"
    example.main(["--suite", str(suite), "--map", "wh", "--num-agents", "3",
                  "--max-episode-steps", "5", "--random-init", "2M", "--device", "cpu",
                  "--svg", str(svg)])
    assert svg.read_text().startswith("<svg")
    m = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert m["map"] == "wh" and 0 <= m["isr"] <= 1

    bigmap.main(["--map", "city-24", "--procedural", "--model", "2M", "--envs", "1",
                 "--agents", "4", "--steps", "3", "--device", "cpu",
                 "--out-dir", str(out)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["env_steps_per_s"] > 0 and summary["peak_memory_gb"] is None


def test_load_policy_reads_reference_files_and_trainer_checkpoints(policy, tmp_path):
    _, _, model = policy
    path = ckpt.save_checkpoint(str(tmp_path / "out"), 7, model)
    for weights in (path, str(tmp_path / "out")):
        args = argparse.Namespace(weights=weights, random_init=None, weights_root=None,
                                  device="cpu")
        loaded, name = trun.load_policy(args)
        assert loaded.cfg.n_embd == 32 and ("ckpt" in name)
        for (k, a), b in zip(loaded.state_dict().items(), model.state_dict().values()):
            assert torch.equal(a, b.float()), k
    args = argparse.Namespace(weights=None, random_init=None, weights_root=str(tmp_path),
                              device="cpu")
    with pytest.raises(SystemExit, match="not found"):
        trun.load_policy(args, {"path_to_weights": "missing.pt"})


def test_bench_measures_on_the_cpu():
    assert bench.measure("cpu", b=2, a=4, steps=3, reps=1) > 0
