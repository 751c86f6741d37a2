"""The port's multi-process training and rollout (``parallel/mesh.py``,
``train/loop.py --distributed``) against one process, on the CPU over gloo,
as ``tests/test_multiprocess.py`` holds the JAX package's.

Each case runs ``mapf_gpt_tpu_torch/tools/mp_worker.py`` alone and as two
processes (each on its own port) and compares what they save:

- ``train``: two steps of a small fp32 config on one global batch, each
  process on half of it with the gradients and the loss averaged: the
  losses, the parameters and the Adam moments within rtol 1e-6, atol 1e-7
  (the two halves' means summed in another order);
- ``rollout``: 8 envs, 4 a process, their gathered metrics exactly equal;
- ``loop``: ``train.loop.train --distributed`` for 2 iterations, each
  process on its own shard file: both processes log the same losses and
  eval means, and rank 0 alone writes the checkpoints.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from mapf_gpt_tpu_torch.train.data import write_arrow_shard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cmd(mode, out, *extra):
    return [sys.executable, "-m", "mapf_gpt_tpu_torch.tools.mp_worker", "--mode", mode,
            "--out", out, *extra]


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "MAPF_GPT_TPU_")) and k not in ("RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "2"   # the processes share the CPU with the other test workers
    return env


def _run(cmds, timeout=240):
    procs = [subprocess.Popen(c, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode(errors="replace")[-3000:]


def _run_pair(mode, out, port, *extra):
    _run([_cmd(mode, out, "--rank", str(r), "--world", "2", "--port", str(port), *extra)
          for r in range(2)])


@pytest.mark.parametrize("mode,port", [("train", 12731), ("rollout", 12732)])
def test_two_processes_match_one(tmp_path, mode, port):
    single, pair = str(tmp_path / "single.npz"), str(tmp_path / "pair.npz")
    _run([_cmd(mode, single)])
    _run_pair(mode, pair, port)
    a, b = np.load(single), np.load(pair)
    assert set(a.files) == set(b.files) and len(a.files) > 1
    for k in a.files:
        if mode == "train":
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    if mode == "train":
        moved = max(np.abs(a[k]).max() for k in a.files if k.startswith("mu:"))
        assert moved > 0   # the gradients reached the optimizer


def test_distributed_loop(tmp_path):
    rng = np.random.RandomState(0)
    for split in ("train", "valid"):
        os.makedirs(tmp_path / split)
        for part in range(2):
            write_arrow_shard(str(tmp_path / split / f"chunk_0_part_{part}.arrow"),
                              rng.randint(0, 67, size=(32, 256)).astype(np.int8),
                              rng.randint(0, 5, size=(32,)).astype(np.int8))
    out = str(tmp_path / "loop.npz")
    _run_pair("loop", out, 12733, "--data", str(tmp_path))
    r0, r1 = (np.load(str(tmp_path / f"loop.rank{r}.npz")) for r in range(2))
    assert r0["loss"].shape == (2,) and np.isfinite(r0["loss"]).all()
    np.testing.assert_array_equal(r0["loss"], r1["loss"])
    assert r0["val"].shape == (3, 2)
    np.testing.assert_array_equal(r0["val"], r1["val"])
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("ckpt_")) == [
        "ckpt_00000001.pt", "ckpt_00000002.pt"]
