"""The port's eval CLIs take the reference's ``--model`` (``mapf_gpt_tpu/eval/
run.py``, ``example.py`` and ``benchmark.py``):

- the reference's command lines with ``--model`` run in ``eval.run`` and
  ``eval.example`` and pass through ``eval.benchmark`` to ``eval.run``;
- a trainer directory's rows are named ``MAPF-GPT-<size>-ckpt``, the size
  from ``--model`` or else from the checkpoint's config;
- ``--model`` is inferred from ``path_to_weights`` as the reference infers it;
- a ``--model`` that the checkpoint contradicts exits naming both sizes.

CPU only, on an inline suite and the trained 2M.
"""

import argparse
import json
import os

import pytest
import torch

from mapf_gpt_tpu_torch.eval import benchmark, example
from mapf_gpt_tpu_torch.eval import run as trun
from mapf_gpt_tpu_torch.maps import grid_to_str, random_grid
from mapf_gpt_tpu_torch.models.convert import load_model
from mapf_gpt_tpu_torch.models.gpt import CONFIGS, init_params
from mapf_gpt_tpu_torch.utils import checkpoint as ckpt

CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "checkpoints")
CKPT_2M = os.path.join(CKPT_DIR, "MAPF-GPT-2M-r4.pt")


def _suite(tmp_path):
    """One random map, two agent counts, one seed, 4 steps."""
    suite = tmp_path / "08-cli"
    suite.mkdir()
    (suite / "maps.yaml").write_text(
        "rand: |-\n" + "".join(f"  {row}\n" for row in grid_to_str(random_grid(9, 0.2, 5))
                               .split("\n")))
    (suite / "08-cli.yaml").write_text(
        "environment:\n  max_episode_steps: 4\n  on_target: nothing\n"
        "  map_name:\n    grid_search: [rand]\n  num_agents:\n    grid_search: [2, 3]\n"
        "  seed:\n    grid_search: [0]\n")
    return suite


@pytest.fixture(scope="module")
def trainer_dir(tmp_path_factory):
    """A trainer's output directory holding a 6M checkpoint (random weights)."""
    out = tmp_path_factory.mktemp("trainer") / "out"
    cfg = CONFIGS["6M"]
    model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(3)), device="cpu")
    ckpt.save_checkpoint(str(out), 11, model)
    return str(out)


def _args(**kw):
    base = dict(weights=None, random_init=None, weights_root=None, device="cpu", model=None)
    return argparse.Namespace(**{**base, **kw})


def test_run_and_example_take_the_reference_model_flag(tmp_path, capsys):
    suite = _suite(tmp_path)
    out = tmp_path / "results"
    trun.main(["--suite", str(suite), "--weights", CKPT_2M, "--model", "2M", "--argmax",
               "--limit", "2", "--out-dir", str(out), "--batch-envs", "2", "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["episodes"] == 2 and last["algo"] == "MAPF-GPT-2M-r4"
    svg = tmp_path / "ep.svg"
    example.main(["--suite", str(suite), "--map", "rand", "--num-agents", "2",
                  "--max-episode-steps", "3", "--weights", CKPT_2M, "--model", "2M",
                  "--argmax", "--device", "cpu", "--svg", str(svg)])
    assert json.loads(capsys.readouterr().out.splitlines()[0])["algo"] == "MAPF-GPT-2M-r4"
    assert svg.read_text().startswith("<svg")


def test_benchmark_passes_the_model_flag_through(monkeypatch, tmp_path):
    (tmp_path / "01-random").mkdir()
    (tmp_path / "results" / "01-random").mkdir(parents=True)
    captured = []
    monkeypatch.setattr(trun, "main", lambda argv: captured.append(argv))
    benchmark.main(["--configs-root", str(tmp_path), "--suites", "01-random",
                    "--out-dir", str(tmp_path / "results"), "--weights", CKPT_2M,
                    "--model", "2M", "--device", "cpu"])
    argv = captured[0]
    assert argv[argv.index("--model") + 1] == "2M"
    assert argv[argv.index("--weights") + 1] == CKPT_2M
    captured.clear()
    benchmark.main(["--configs-root", str(tmp_path), "--suites", "01-random",
                    "--out-dir", str(tmp_path / "results"), "--random-init", "2M"])
    assert "--model" not in captured[0]


@pytest.mark.parametrize("model", ["6M", None])
def test_trainer_directory_rows_are_named_by_size(trainer_dir, model):
    loaded, name = trun.load_policy(_args(weights=trainer_dir, model=model))
    assert name == "MAPF-GPT-6M-ckpt" and loaded.cfg.n_embd == 256


def test_trainer_directory_run_writes_size_named_rows(trainer_dir, tmp_path, capsys):
    suite = _suite(tmp_path)
    out = tmp_path / "results"
    trun.main(["--suite", str(suite), "--weights", trainer_dir, "--model", "6M", "--argmax",
               "--limit", "1", "--out-dir", str(out), "--batch-envs", "1", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["algo"] == \
        "MAPF-GPT-6M-ckpt"
    assert len(json.load(open(out / "08-cli" / "MAPF-GPT-6M-ckpt.json"))) == 1


@pytest.mark.parametrize("weights, model, held", [("trainer", "2M", "6M"),
                                                  (CKPT_2M, "6M", "2M"),
                                                  (CKPT_2M, "85M", "2M")])
def test_contradicting_model_exits_with_both_names(trainer_dir, weights, model, held):
    path = trainer_dir if weights == "trainer" else weights
    with pytest.raises(SystemExit, match=rf"--model {model} .* holds {held}"):
        trun.load_policy(_args(weights=path, model=model))


def test_model_is_inferred_from_path_to_weights():
    args = _args(weights_root=CKPT_DIR)
    loaded, name = trun.load_policy(args, {"path_to_weights": "MAPF-GPT-2M-r4.pt"})
    assert args.model == "2M" and name == "MAPF-GPT-2M-r4" and loaded.cfg.n_embd == 160
    assert trun.config_name(loaded.cfg) == "2M"
