"""The port's expert-data slice against the JAX package's, on the CPU.

Every case that builds or loads the solver library is in this file, so that
``--dist loadfile`` builds it in one worker.

- The C++ sources under ``mapf_gpt_tpu_torch/native/lacam/`` are a byte
  copy of ``mapf_gpt_tpu/native/lacam/``'s; the port's ``g++`` build caches
  its library by a hash and raises without ``g++``.
- The port's library and the JAX package's (built with ``cmake`` into a
  directory of the test's own; skipped where ``cmake`` is missing, as
  ``tests/test_dataset_gen.py`` does) give equal
  paths with ``anytime=False``, which stops at the first solution and so is
  exact; anytime refinement runs to a wall-clock deadline and is not.
- ``dedup_goals``, ``paths_to_actions``, ``episode_samples``, ``dedup`` and
  ``balance_waits`` are exact against the JAX functions.
- ``generate_shards`` and the ``solve`` CLI: both packages' solver calls are
  replaced by one shared table of ``anytime=False`` solutions, so that the
  outputs cannot depend on time; the shards are then byte-equal (names,
  bytes, returned stats), and the CLI's metrics line (less its wall time)
  and ``--out`` file equal.
- ``download`` raises its ``RuntimeError`` without ``huggingface_hub``; no
  test calls the Hub.
"""

import filecmp
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mapf_gpt_tpu import maps as jmaps
from mapf_gpt_tpu.dataset import download as jdownload
from mapf_gpt_tpu.dataset import expert as jexpert
from mapf_gpt_tpu.dataset import generate as jgenerate
from mapf_gpt_tpu.dataset import solve as jsolve
from mapf_gpt_tpu_torch import maps
from mapf_gpt_tpu_torch.dataset import _lacam_build, download, expert, generate, solve
from mapf_gpt_tpu_torch.train.data import ArrowShardStream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LACAM = os.path.join(ROOT, "mapf_gpt_tpu", "native", "lacam")

# (map kind, size, agents, seed); random maps at density 0.25
INSTANCES = (("random", 16, 16, 0), ("random", 16, 24, 1), ("maze", 17, 16, 2),
             ("maze", 17, 24, 3))


def _instance(kind, size, agents, seed):
    grid = (maps.random_grid(size, 0.25, seed) if kind == "random"
            else maps.maze_grid(size, seed))
    return maps.sample_instance(grid, agents, seed)


@pytest.fixture(scope="module")
def lib():
    return expert.get_lib()


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's solver, built by its own CMakeLists.txt into a
    directory of this test's own: its shared build/ may be in the middle of
    a build by another test file's worker."""
    if shutil.which("cmake") is None or shutil.which("ninja") is None:
        pytest.skip("the JAX package's solver builds with cmake and ninja")
    out = tmp_path_factory.mktemp("jax_lacam")
    subprocess.run(["cmake", "-S", JAX_LACAM, "-B", str(out), "-G", "Ninja"], check=True,
                   capture_output=True)
    subprocess.run(["cmake", "--build", str(out), "--target", "lacam_tpu"], check=True,
                   capture_output=True)
    return jexpert.LacamLib(str(out / "liblacam_tpu.so"))


def test_lacam_sources_are_a_byte_copy():
    names = sorted(f for f in os.listdir(JAX_LACAM) if f.endswith((".cpp", ".hpp")))
    assert len(names) == 15 and "main.cpp" in names
    port = os.path.join(ROOT, "mapf_gpt_tpu_torch", "native", "lacam")
    assert sorted(f for f in os.listdir(port) if f.endswith((".cpp", ".hpp"))) == names
    match, mismatch, errors = filecmp.cmpfiles(JAX_LACAM, port, names, shallow=False)
    assert (mismatch, errors) == ([], [])
    assert set(_lacam_build.SOURCES) == set(names) - {"main.cpp", "lacam.hpp"}


def test_build_is_cached_and_needs_gxx(lib, monkeypatch):
    path = _lacam_build.library_path()
    assert path.exists() and path.parent == _lacam_build.BUILD_DIR
    mtime = path.stat().st_mtime_ns
    assert _lacam_build.build() == path and path.stat().st_mtime_ns == mtime
    assert not list(_lacam_build.BUILD_DIR.glob("obj.*"))   # objects removed after the link
    monkeypatch.setattr(_lacam_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _lacam_build.find_gxx()


@pytest.mark.parametrize("spec", INSTANCES, ids=lambda s: f"{s[0]}-{s[2]}-{s[3]}")
def test_paths_equal_jax_library_without_anytime(lib, jax_lib, spec):
    inst = _instance(*spec)
    seed = spec[3]
    want = jax_lib.solve(inst.grid, inst.starts, inst.goals, time_limit_s=30.0,
                                   seed=seed, anytime=False)
    got = lib.solve(inst.grid, inst.starts, inst.goals, time_limit_s=30.0, seed=seed,
                    anytime=False)
    assert want is not None and got is not None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], inst.starts)
    np.testing.assert_array_equal(got[-1], inst.goals)
    np.testing.assert_array_equal(expert.paths_to_actions(got), jexpert.paths_to_actions(got))


def test_unsolvable_and_wait_fallback(lib):
    grid = np.ones((5, 7), dtype=bool)
    grid[2, 1:6] = False
    starts = np.asarray([[2, 1], [2, 5]], dtype=np.int32)
    goals = np.asarray([[2, 5], [2, 1]], dtype=np.int32)
    assert expert.solve_with_escalation(grid, starts, goals, time_limits=(0.2,)) is None
    ex = expert.LacamExpert(grid, starts, goals, time_limits=(0.2,))
    assert ex.failed
    np.testing.assert_array_equal(ex.act(), [0, 0])


def test_dedup_goals_and_paths_to_actions_exact():
    rng = np.random.RandomState(0)
    for trial in range(20):
        grid = rng.rand(9, 9) < 0.3
        free = np.argwhere(~grid)
        goals = free[rng.randint(0, len(free), size=8)].astype(np.int32)   # repeats
        np.testing.assert_array_equal(expert.dedup_goals(grid, goals),
                                      jexpert.dedup_goals(grid, goals), err_msg=str(trial))
    deltas = np.asarray([[0, 0], [-1, 0], [1, 0], [0, -1], [0, 1]], dtype=np.int32)
    steps = deltas[rng.randint(0, 5, size=(30, 6))]
    paths = np.concatenate([np.full((1, 6, 2), 5, np.int32), 5 + np.cumsum(steps, 0)])
    np.testing.assert_array_equal(expert.paths_to_actions(paths),
                                  jexpert.paths_to_actions(paths))


def test_episode_samples_exact(lib):
    inst = _instance("maze", 17, 16, 2)
    paths = lib.solve(inst.grid, inst.starts, inst.goals, time_limit_s=30.0, seed=2,
                      anytime=False)
    want_t, want_y = jgenerate.episode_samples(inst, paths)
    got_t, got_y = generate.episode_samples(inst, paths, device="cpu")
    t_plus_1 = len(paths)
    assert got_t.shape == (t_plus_1 * 16, 256) and got_t.dtype == np.int8
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_y, want_y)
    assert (got_y == generate.WAIT_MARKER).any()


def test_dedup_and_balance_waits_exact():
    rng = np.random.RandomState(3)
    toks = rng.randint(-3, 3, size=(400, 4)).astype(np.int8)   # many repeated rows
    gts = rng.choice([0, 1, 2, 3, 4, 5], size=400, p=[0.4, 0.1, 0.1, 0.1, 0.1, 0.2]
                     ).astype(np.int8)
    t1, g1, seen1 = generate.dedup(toks, gts)
    t2, g2, seen2 = jgenerate.dedup(toks, gts)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(g1, g2)
    assert seen1 == seen2 and len(t1) < 400
    for frac in (0.2, 0.5):
        a = generate.balance_waits(t1, g1, np.random.RandomState(7), frac)
        b = jgenerate.balance_waits(t2, g2, np.random.RandomState(7), frac)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert not (a[1] == generate.WAIT_MARKER).any()


@pytest.fixture
def shared_solver(lib, monkeypatch):
    """Replace both packages' solve_with_escalation by one table of
    anytime=False solutions, keyed by the instance and the seed."""
    table = {}

    def solve_with_escalation(grid, starts, goals, seed=0, time_limits=None):
        key = (np.asarray(grid, bool).tobytes(), np.asarray(starts, np.int32).tobytes(),
               np.asarray(goals, np.int32).tobytes(), int(seed))
        if key not in table:
            table[key] = lib.solve(grid, starts, goals, time_limit_s=30.0, seed=seed,
                                   anytime=False)
        return table[key]

    monkeypatch.setattr(jexpert, "solve_with_escalation", solve_with_escalation)
    monkeypatch.setattr(expert, "solve_with_escalation", solve_with_escalation)
    return table


def test_generate_shards_byte_equal(tmp_path, shared_solver):
    """Agent counts and map sizes drawn per episode, mazes and random maps
    (of drawn density), several shards: the RandomState draws, the
    steering, dedup, balancing and the flush order all reach the bytes."""
    kw = dict(agent_counts=(4, 6), map_sizes=(11, 12), maze_fraction=0.5, max_wait_frac=0.2,
              samples_per_shard=150, seed=4)
    want = jgenerate.generate_shards(str(tmp_path / "jax"), 400, jgenerate.GenConfig(**kw))
    got = generate.generate_shards(str(tmp_path / "port"), 400,
                                   generate.GenConfig(**kw, device="cpu"))
    assert got == want and got["shards"] == 3 and 0 < got["maze_share"] < 1
    # keys hold the grid's and the starts' bytes: H * W cells, A * 2 int32
    shapes = {(len(grid), len(starts) // 8) for grid, starts, *_ in shared_solver}
    assert len({hw for hw, _ in shapes}) > 1 and len({a for _, a in shapes}) > 1, shapes
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names == [
        f"chunk_4_part_{i}.arrow" for i in range(3)]
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "port", names,
                                               shallow=False)
    assert (mismatch, errors) == ([], [])
    x, y = next(iter(ArrowShardStream(str(tmp_path / "port"), batch_size=50)))
    assert x.shape == (1, 50, 256) and ((y >= 0) & (y <= 4)).all()


_MAP = """type octile
height 6
width 7
map
.......
..@@...
.......
...@...
.......
@......
"""
_SCEN = "version 1\n" + "".join(
    f"0\tm.map\t7\t6\t{sx}\t{sy}\t{gx}\t{gy}\t0\n"
    for sx, sy, gx, gy in ((0, 0, 6, 4), (6, 0, 0, 4), (1, 4, 5, 0), (4, 2, 2, 0),
                           (2, 2, 6, 2)))


def test_solve_cli_matches_jax(tmp_path, shared_solver, capsys):
    (tmp_path / "m.map").write_text(_MAP)
    (tmp_path / "m.scen").write_text(_SCEN)
    outputs = []
    for name, cli in (("jax", jsolve), ("port", solve)):
        out = tmp_path / f"{name}.txt"
        assert cli.main(["--map", str(tmp_path / "m.map"), "--scen", str(tmp_path / "m.scen"),
                         "-N", "5", "--out", str(out)]) == 0
        metrics = capsys.readouterr().out.splitlines()[0]
        outputs.append((metrics.rsplit(" comp_time=", 1)[0], out.read_text()))
    assert outputs[0] == outputs[1]
    assert outputs[1][0].startswith("solved: agents=5 makespan=")
    first = outputs[1][1].splitlines()[0]
    assert first == "0:(0,0)(6,0)(1,4)(4,2)(2,2)"
    inst = maps.scen_instance(_MAP, _SCEN, num_agents=5)
    assert np.array_equal(inst.starts, jmaps.scen_instance(_MAP, _SCEN, num_agents=5).starts)


def test_generate_cli_on_the_cpu(tmp_path, lib):
    generate.main(["--out", str(tmp_path), "--samples", "200", "--seed", "2",
                   "--num-agents", "6", "--map-size", "11", "--samples-per-shard", "100",
                   "--expert-budget", "0.05", "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == ["chunk_2_part_0.arrow", "chunk_2_part_1.arrow"]
    x, y = next(iter(ArrowShardStream(str(tmp_path), batch_size=100)))
    assert ((y >= 0) & (y <= 4)).all() and (x < 256).all()


def test_generate_cli_workers(tmp_path, lib, monkeypatch):
    """--workers 2: two new processes, seeds seed and seed + 7919, each its
    own shard files."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    with pytest.raises(SystemExit) as done:
        generate.main(["--out", str(tmp_path), "--samples", "200", "--seed", "3",
                       "--workers", "2", "--num-agents", "4", "--map-size", "11",
                       "--expert-budget", "0.05", "--device", "cpu"])
    assert done.value.code == 0
    assert sorted(os.listdir(tmp_path)) == ["chunk_3_part_0.arrow", "chunk_7922_part_0.arrow"]


def test_cuda_default_and_no_fallback(lib):
    inst = _instance("random", 16, 16, 0)
    paths = lib.solve(inst.grid, inst.starts, inst.goals, time_limit_s=30.0, anytime=False)
    assert generate.GenConfig().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            generate.episode_samples(inst, paths)


def test_download_needs_huggingface_hub(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub is not installed"):
        download.download_weights("MAPF-GPT-2M.pt", "unused")
    with pytest.raises(RuntimeError, match="huggingface_hub is not installed"):
        download.download_dataset("unused")
    assert (download.DATASET_REPO, download.WEIGHT_FILES) == (jdownload.DATASET_REPO,
                                                              jdownload.WEIGHT_FILES)
