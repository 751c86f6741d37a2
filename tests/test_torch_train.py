"""The port's trainer against the JAX package's on the CPU (numpy in between):

- ``lr_schedule`` equals the JAX schedule (``optax.warmup_cosine_decay_schedule``
  with the short-run clamp) at iterations 0, 1, warmup-1, warmup, the cosine
  midpoint, the end of the decay and beyond, rtol 1e-6;
- three ``make_train_step`` calls with ``grad_accum=2`` on an fp32 config,
  port against JAX from the same parameters and batches: the loss within
  1e-5 at every step, every parameter within atol 1e-6 + 0.01 * (the sum
  of the steps' learning rates) -- Adam's normalised update can carry an
  fp32 sum-order difference in a near-zero gradient up to lr a step;
- the Arrow shards: a shard the port writes reads back through the JAX
  ``ArrowShardStream`` and the other way round, batch for batch; process
  sharding, the rescan rule and the atomic write behave as the JAX tests
  of ``tests/test_train.py`` check;
- checkpoints: save, restore and resume round trip; a saved file loads with
  ``convert.load_reference_checkpoint``; only the newest 3 are kept;
- the CLI on ``--device cpu`` resumes as ``test_trainer_cli_resume`` does
  for the JAX trainer, and ``--distributed`` without coordinates raises;
- the copied configurator and curve modules, and the meter (no MFU on the
  CPU).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.models.gpt import init_params as jinit_params
from mapf_gpt_tpu.train import data as jdata
from mapf_gpt_tpu.train import train_step as jts
from mapf_gpt_tpu_torch.models.convert import (load_model, load_reference_checkpoint,
                                               params_to_state_dict, state_dict_to_params)
from mapf_gpt_tpu_torch.models.gpt import GPT, GPTConfig
from mapf_gpt_tpu_torch.train import curve, data, loop
from mapf_gpt_tpu_torch.train import train_step as ts
from mapf_gpt_tpu_torch.utils import checkpoint as ckpt
from mapf_gpt_tpu_torch.utils.configurator import apply_config
from mapf_gpt_tpu_torch.utils.profiling import Meter, chip_peak_flops


@pytest.mark.parametrize("tc", [
    ts.TrainConfig(),                                               # warmup 2000 of 30000
    ts.TrainConfig(learning_rate=1e-3, min_lr=1e-4, warmup_iters=2000, lr_decay_iters=4000),
    ts.TrainConfig(learning_rate=3e-4, min_lr=3e-5, warmup_iters=5, lr_decay_iters=50),
])
def test_lr_schedule_matches_optax(tc):
    jsched = jts.lr_schedule(jts.TrainConfig(**tc._asdict()))
    sched = ts.lr_schedule(tc)
    warmup = min(tc.warmup_iters, max(tc.lr_decay_iters // 10, 1))
    mid = (warmup + tc.lr_decay_iters) // 2
    for it in (0, 1, warmup - 1, warmup, mid, tc.lr_decay_iters, 2 * tc.lr_decay_iters):
        np.testing.assert_allclose(sched(it), float(jsched(it)), rtol=1e-6, atol=0,
                                   err_msg=f"iter {it}")


def test_three_train_steps_match_jax_in_fp32():
    jcfg = JGPTConfig(n_layer=2, n_head=2, n_embd=64, block_size=64, dtype=jnp.float32)
    cfg = GPTConfig(n_layer=2, n_head=2, n_embd=64, block_size=64, dtype=torch.float32)
    tc = ts.TrainConfig(learning_rate=1e-3, min_lr=1e-4, warmup_iters=2, lr_decay_iters=20,
                        grad_accum=2)
    params = jinit_params(jcfg, jax.random.PRNGKey(0))
    model = load_model(cfg, params_to_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                                 cfg), device="cpu").train().requires_grad_()
    jstate = jts.init_train_state(params, jts.TrainConfig(**tc._asdict()))
    jstep = jax.jit(jts.make_train_step(jcfg, jts.TrainConfig(**tc._asdict()), use_fused=False))
    step = ts.make_train_step(model, tc, use_fused=False)
    rng = np.random.RandomState(0)
    for i in range(3):
        x = rng.randint(0, 67, size=(2, 8, 64)).astype(np.int32)
        y = (x[:, :, 30] % 5).astype(np.int32)
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        loss = step(torch.from_numpy(x), torch.from_numpy(y))
        assert abs(loss.item() - float(jloss)) < 1e-5, (i, loss.item(), float(jloss))
    assert step.optimizer.count == int(jstate.step) == 3
    sched = ts.lr_schedule(tc)
    tol = 1e-6 + 0.01 * sum(sched(i) for i in range(3))
    got = state_dict_to_params(model.state_dict(), cfg)["params"]
    want = jax.tree_util.tree_map(np.asarray, jstate.params)["params"]
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    init = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, params)["params"]))
    moved = 0.0
    for k, w in jax.tree_util.tree_leaves_with_path(want):
        assert flat[k].shape == w.shape, k
        np.testing.assert_allclose(flat[k], w, rtol=0, atol=tol, err_msg=jax.tree_util.keystr(k))
        moved = max(moved, float(np.abs(w - init[k]).max()))
    assert moved > 10 * tol   # the steps did move the parameters


def test_module_loss_decreases_on_the_cpu():
    """The CPU trainer path (the module under autograd) learns the toy task
    of ``tests/test_train.py::test_loss_decreases``."""
    cfg = GPTConfig(n_layer=2, n_head=2, n_embd=32)
    tc = ts.TrainConfig(grad_accum=2, warmup_iters=5, lr_decay_iters=50, learning_rate=1e-3)
    from mapf_gpt_tpu_torch.models.gpt import init_params

    model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(0)),
                       device="cpu").train().requires_grad_()
    step = ts.make_train_step(model, tc)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(30):
        x = rng.randint(0, 67, size=(2, 16, 256)).astype(np.int32)
        y = (x[:, :, 121] % 5).astype(np.int32)
        losses.append(step(torch.from_numpy(x), torch.from_numpy(y)).item())
    assert losses[-1] < losses[0] * 0.8, losses


def _tokens(rng, n):
    return (rng.randint(-10, 60, size=(n, 256)).astype(np.int8),
            rng.randint(0, 6, size=(n,)).astype(np.int8))


@pytest.mark.parametrize("writer,reader", [(data, jdata), (jdata, data)])
def test_arrow_shards_cross_read(tmp_path, writer, reader):
    """Shards written by one package read back through the other's stream,
    batch for batch under the same seed."""
    rng = np.random.RandomState(0)
    for i in range(3):
        writer.write_arrow_shard(str(tmp_path / f"chunk_0_part_{i}.arrow"), *_tokens(rng, 64))
    got = iter(reader.ArrowShardStream(str(tmp_path), batch_size=16, grad_accum=2, seed=7))
    want = iter(writer.ArrowShardStream(str(tmp_path), batch_size=16, grad_accum=2, seed=7))
    for _ in range(8):   # past one epoch of 3 x 2 batches
        (gx, gy), (wx, wy) = next(got), next(want)
        assert gx.dtype == np.int32 and gx.shape == (2, 16, 256) and gy.shape == (2, 16)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("writer", [data, jdata])
def test_read_arrow_shard_gives_the_rows_in_file_order(tmp_path, writer):
    """`read_arrow_shard` reads a shard of either package back exactly,
    unshuffled."""
    tokens, actions = _tokens(np.random.RandomState(1), 48)
    path = str(tmp_path / "chunk_0_part_0.arrow")
    writer.write_arrow_shard(path, tokens, actions)
    got_tokens, got_actions = data.read_arrow_shard(path)
    assert got_tokens.dtype == np.int8 and got_actions.dtype == np.int8
    np.testing.assert_array_equal(got_tokens, tokens)
    np.testing.assert_array_equal(got_actions, actions)


def test_process_sharding_and_rescan_match_jax(tmp_path):
    def shard(i):
        return str(tmp_path / f"chunk_600_part_{i}.arrow")

    for i in range(9):
        data.write_arrow_shard(shard(i), np.zeros((8, 256), np.int8) + i, np.zeros(8, np.int8))
    mine = [data.ArrowShardStream(str(tmp_path), 4, process_index=p, process_count=2)
            for p in range(2)]
    ref = [jdata.ArrowShardStream(str(tmp_path), 4, process_index=p, process_count=2)
           for p in range(2)]
    assert [s.files for s in mine] == [s.files for s in ref]
    assert set(mine[0].files).isdisjoint(mine[1].files)
    for i in range(9, 14):   # a generator keeps writing, crossing two digits
        data.write_arrow_shard(shard(i), np.zeros((8, 256), np.int8) + i, np.zeros(8, np.int8))
        got = [s._scan() for s in mine]
        assert got == [s._scan() for s in ref]
        assert set(got[0]).isdisjoint(got[1])
        assert sorted(got[0] + got[1]) == sorted(shard(j) for j in range(i + 1))


def test_write_arrow_shard_is_atomic(tmp_path, monkeypatch):
    seen = []
    real_rename = os.rename

    def spy(src, dst):
        seen.append((os.path.exists(dst), src.endswith(".tmp")))
        real_rename(src, dst)

    monkeypatch.setattr(data.os, "rename", spy)
    path = str(tmp_path / "chunk_0_part_0.arrow")
    data.write_arrow_shard(path, np.zeros((8, 256), np.int8), np.zeros(8, np.int8))
    assert seen == [(False, True)]
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")


def test_missing_pyarrow_raises_a_clear_import_error(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "pyarrow", None)
    with pytest.raises(ImportError, match="need the pyarrow package"):
        data.write_arrow_shard("unused.arrow", np.zeros((1, 256), np.int8), np.zeros(1, np.int8))


def _small_model(seed=0):
    from mapf_gpt_tpu_torch.models.gpt import init_params

    cfg = GPTConfig(n_layer=2, n_head=2, n_embd=32)
    return load_model(cfg, init_params(cfg, torch.Generator().manual_seed(seed)), device="cpu")


def test_checkpoint_round_trip_keeps_three_and_loads_as_reference(tmp_path):
    model = _small_model()
    opt = ts.make_optimizer(model, ts.TrainConfig())
    opt.count = 5
    for step in (2, 4, 6, 8):
        ckpt.save_checkpoint(str(tmp_path), step, model, opt.state_dict(),
                             metadata={"model": "test"})
    assert ckpt.latest_step(str(tmp_path)) == 8
    assert sorted(os.listdir(tmp_path)) == [f"ckpt_{s:08d}.pt" for s in (4, 6, 8)]
    saved = ckpt.restore_checkpoint(str(tmp_path))
    assert saved["iter_num"] == 8 and saved["metadata"] == {"model": "test"}
    other = ts.make_optimizer(_small_model(seed=1), ts.TrainConfig())
    other.load_state_dict(saved["optimizer"])
    assert other.count == 5
    cfg, sd = load_reference_checkpoint(ckpt.checkpoint_path(str(tmp_path), 8))
    assert cfg == model.cfg
    for k, v in model.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"))


def test_trainer_cli_resume(tmp_path, capsys):
    """Train 2 iterations on the CPU, save, resume to 4: the second run
    picks up at the checkpointed step, as the JAX trainer's test checks."""
    rng = np.random.RandomState(0)
    (tmp_path / "d").mkdir()
    data.write_arrow_shard(str(tmp_path / "d" / "chunk_0_part_0.arrow"),
                           rng.randint(0, 67, size=(256, 256)).astype(np.int8),
                           rng.randint(0, 5, size=(256,)).astype(np.int8))

    def args(max_iters, resume):
        return loop.parse_args([
            "--model", "2M", "--train-data", str(tmp_path / "d"),
            "--valid-data", str(tmp_path / "d"), "--eval-iters", "1",
            "--out-dir", str(tmp_path / "out"), "--batch-size", "32",
            "--grad-accum", "1", "--max-iters", str(max_iters),
            "--eval-interval", "2", "--log-interval", "1", "--device", "cpu"]
            + (["--resume"] if resume else []))

    r1 = loop.train(args(2, resume=False))
    assert [h["iter"] for h in r1["history"]] == [0, 1]
    r2 = loop.train(args(4, resume=True))
    assert [h["iter"] for h in r2["history"]] == [2, 3]
    assert [e["iter"] for e in r2["evals"]] == [2, 4]
    assert all(np.isfinite(h["loss"]) for h in r1["history"] + r2["history"])
    out = capsys.readouterr().out
    assert "mfu n/a" in out and "resumed from" in out
    log = tmp_path / "train.log"
    log.write_text(out)
    parsed = curve.parse_logs([str(log)])
    assert [p[0] for p in parsed["train"]] == [0, 1, 2, 3]
    assert [p[0] for p in parsed["val"]] == [0, 2, 4]


def test_distributed_flag_raises(tmp_path, monkeypatch):
    """--distributed with no coordinates in the environment raises, naming
    what it needs (the multi-process runs are tests/test_torch_distributed.py)."""
    for name in ("MAPF_GPT_TPU_COORDINATOR", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                 "RANK"):
        monkeypatch.delenv(name, raising=False)
    args = loop.parse_args(["--train-data", str(tmp_path), "--distributed", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="--distributed needs the process group's coordinates"):
        loop.train(args)


def test_configurator_and_meter(tmp_path):
    args = loop.parse_args(["--train-data", "x", "--max_iters=7", "--device", "cpu"])
    assert args.max_iters == 7
    cfg_file = tmp_path / "c.py"
    cfg_file.write_text("batch_size = 64\nmodel = '2M'\n")
    apply_config(args, config_file=str(cfg_file))
    assert (args.batch_size, args.model) == (64, "2M")
    with pytest.raises(ValueError, match="unknown config key"):
        apply_config(args, overrides=["--nope=1"])
    assert chip_peak_flops("cpu") is None
    meter = Meter(1e12, None)
    assert meter.tick() == (0.0, None)
    sps, mfu = meter.tick(steps=2)
    assert sps > 0 and mfu is None
    assert Meter(1e12, 1e15).tick(steps=1)[1] == 0.0
    assert GPT(GPTConfig(n_layer=1, n_head=1, n_embd=32)).num_params() == \
        sum(p.numel() for p in GPT(GPTConfig(n_layer=1, n_head=1, n_embd=32)).parameters()) \
        - 256 * 32
    json.dumps(vars(args))


@pytest.mark.parametrize("field,value", [
    ("bias", True), ("dropout", 0.1), ("attn_impl", "pallas"), ("attn_impl", "flash"),
])
def test_unported_config_options_raise(field, value):
    """Options the module does not run (an attn_impl other than "auto",
    "einsum" and "pallas") raise, rather than run another implementation
    than the one asked for; bias=True, "pallas" and dropout > 0, ported
    since, build and run a forward (tests/test_torch_dropout.py holds
    dropout against the JAX module)."""
    cfg = GPTConfig(n_layer=1, n_head=1, n_embd=32, **{field: value})
    if (field, value) in (("bias", True), ("attn_impl", "pallas"), ("dropout", 0.1)):
        with torch.no_grad():
            assert GPT(cfg)(torch.zeros((2, 256), dtype=torch.long)).shape == (2, 67)
        return
    with pytest.raises(NotImplementedError, match=field):
        GPT(cfg)


def test_einsum_attention_is_the_plain_attention():
    """The JAX package runs "auto" and "einsum" through the same einsum
    attention; the port runs both through its plain attention."""
    cfg = GPTConfig(n_layer=1, n_head=2, n_embd=32, block_size=16, dtype=torch.float32)
    sd = GPT(cfg).state_dict()
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (3, 16)))
    outs = []
    for impl in ("auto", "einsum"):
        model = GPT(GPTConfig(**{**vars(cfg), "attn_impl": impl}))
        model.load_state_dict(sd)
        with torch.no_grad():
            outs.append(model(tokens))
    assert torch.equal(*outs)
