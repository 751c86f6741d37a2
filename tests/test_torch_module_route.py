"""The module route against the JAX package: ``bias=True`` models, the
attention kernel's ``attn_impl="pallas"``, and what carries them.

- A ``bias=True`` fp32 ``GPT`` (2 layers, 2 heads, n_embd 32, random
  nonzero biases carried across by ``params_to_state_dict``) against flax
  ``GPT.apply`` with ``attn_impl`` "pallas" (its kernel in interpret mode)
  and "auto", ``last_only`` true and false, within atol 1e-5 (the fp32
  tolerance of ``tests/test_torch_model.py``).
- Out-of-vocabulary ids (-1, vocab, vocab + 5, -vocab - 2): the port's
  module reads ``wte`` rows as JAX indexing does (a negative id wraps once,
  then ids are clamped): its logits equal, bit for bit, those of the ids
  JAX's indexing maps them to, and the flax module's within atol 1e-5.
- Conversion with biases both ways, and ``load_reference_checkpoint`` on a
  ``bias=True`` reference-layout file.
- ``make_forward``'s route rule (``uses_fused``) as a function of the
  config and the device type, and ``use_fused=False``.
- Training a ``bias=True`` model through the module's autograd: three fp32
  steps against the JAX trainer's (the tolerances of
  ``tests/test_torch_train.py``); with "pallas" the loss raises, as the
  JAX kernel has no gradient.
- The slice whole: the port's ``make_batch_rollout`` against JAX's for an
  fp32 ``bias=True``, ``attn_impl="pallas"`` model, 2 envs x 8 agents x 4
  steps, argmax: the actions of every step, the final positions and the
  per-env metrics equal exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mapf_gpt_tpu.envs import env as jenv
from mapf_gpt_tpu.models.gpt import GPT as JGPT
from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.models.gpt import init_params as jinit_params
from mapf_gpt_tpu.parallel import rollout as jrollout
from mapf_gpt_tpu.train import train_step as jts
from mapf_gpt_tpu_torch.envs import env as tenv
from mapf_gpt_tpu_torch.maps import random_grid, sample_instance
from mapf_gpt_tpu_torch.models.convert import (load_model, load_reference_checkpoint,
                                               params_to_state_dict, state_dict_to_params)
from mapf_gpt_tpu_torch.models.gpt import CONFIGS, GPTConfig, make_forward, uses_fused
from mapf_gpt_tpu_torch.parallel import rollout as trollout
from mapf_gpt_tpu_torch.train import train_step as ts

SMALL = JGPTConfig(n_layer=2, n_head=2, n_embd=32, block_size=64, bias=True, dtype=jnp.float32)


def _port_cfg(jcfg, **kw):
    return GPTConfig(block_size=jcfg.block_size, vocab_size=jcfg.vocab_size,
                     n_layer=jcfg.n_layer, n_head=jcfg.n_head, n_embd=jcfg.n_embd,
                     bias=jcfg.bias, attn_impl=jcfg.attn_impl, dtype=torch.float32, **kw)


def _carried(jcfg, key):
    """(JAX params with random nonzero biases, the port's model with the
    same weights on the CPU)."""
    params = jax.jit(jinit_params, static_argnums=0)(jcfg, jax.random.PRNGKey(key))
    rng = np.random.RandomState(key)

    def nonzero_bias(path, leaf):
        leaf = np.asarray(leaf)
        if getattr(path[-1], "key", "") == "bias":
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(nonzero_bias, params)
    cfg = _port_cfg(jcfg)
    return params, load_model(cfg, params_to_state_dict(params, cfg), device="cpu")


def _flax(jcfg, params, tok, last_only=True):
    """flax ``GPT.apply``, jitted as its callers run it (eager indexing
    raises on an out-of-range id where the jitted gather clamps)."""
    apply = jax.jit(JGPT(jcfg).apply, static_argnames="last_only")
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(apply(params, jnp.asarray(tok), last_only=last_only))


@pytest.mark.parametrize("last_only", [True, False])
@pytest.mark.parametrize("impl", ["pallas", "auto"])
def test_bias_module_matches_flax(impl, last_only):
    jcfg = dataclasses.replace(SMALL, attn_impl=impl)
    params, model = _carried(jcfg, key=1)
    assert any(k.endswith("c_fc.bias") for k in model.state_dict())
    tok = np.random.RandomState(1).randint(0, jcfg.vocab_size, size=(4, jcfg.block_size))
    ref = _flax(jcfg, params, tok, last_only)
    with torch.no_grad():
        got = model(torch.from_numpy(tok), last_only=last_only).numpy()
    assert got.shape == ref.shape == ((4, 67) if last_only else (4, 64, 67))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_module_reads_oov_ids_as_jax_indexing():
    jcfg = dataclasses.replace(SMALL, bias=False)
    params, model = _carried(jcfg, key=2)
    v = jcfg.vocab_size
    tok = np.random.RandomState(2).randint(0, v, size=(4, jcfg.block_size))
    tok[:, -1] = -1
    tok[0, ::3] = v
    tok[1, ::5] = v + 5
    tok[2, ::7] = -v - 2
    mapped = np.array(jax.jit(lambda t: jnp.arange(v)[t])(jnp.asarray(tok)))   # JAX's rows
    assert mapped.min() == 0 and mapped.max() == v - 1
    with torch.no_grad():
        got = model(torch.from_numpy(tok))
        assert torch.equal(got, model(torch.from_numpy(mapped)))
    np.testing.assert_allclose(got.numpy(), _flax(jcfg, params, tok), rtol=0, atol=1e-5)


def test_convert_round_trips_with_biases(tmp_path):
    params, model = _carried(SMALL, key=3)
    cfg = model.cfg
    sd = model.state_dict()
    back = state_dict_to_params(sd, cfg)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want) and any("bias" in jax.tree_util.keystr(k) for k in got)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=jax.tree_util.keystr(k))
    again = params_to_state_dict(back, cfg)
    assert set(again) == set(sd) and all(torch.equal(again[k], sd[k]) for k in sd)

    path = tmp_path / "bias.pt"
    args = {"n_layer": 2, "n_head": 2, "n_embd": 32, "block_size": 64, "vocab_size": 67,
            "bias": True, "dropout": 0.0}
    torch.save({"model": {f"_orig_mod.{k}": t for k, t in sd.items()}, "model_args": args},
               path)
    lcfg, lsd = load_reference_checkpoint(str(path))
    assert lcfg == dataclasses.replace(cfg, attn_impl="auto", dtype=torch.bfloat16)
    assert set(lsd) == set(sd) and all(torch.equal(lsd[k], sd[k]) for k in sd)
    loaded = load_model(dataclasses.replace(lcfg, dtype=torch.float32), lsd, device="cpu")
    tok = torch.from_numpy(np.random.RandomState(3).randint(0, 67, size=(2, 64)))
    with torch.no_grad():
        assert torch.equal(loaded(tok), model(tok))


def test_route_rule_and_use_fused():
    for cfg in CONFIGS.values():
        assert uses_fused(cfg, "cuda") and not uses_fused(cfg, "cpu")
        for change in ({"bias": True}, {"dropout": 0.1}, {"n_head": 7}):
            assert not uses_fused(dataclasses.replace(cfg, **change), "cuda")
    assert not uses_fused(dataclasses.replace(CONFIGS["2M"], attn_impl="pallas", bias=True), "cuda")
    assert uses_fused(dataclasses.replace(CONFIGS["6M"], attn_impl="pallas"), "cuda")

    params, model = _carried(SMALL, key=4)
    tok = torch.from_numpy(np.random.RandomState(4).randint(0, 67, size=(3, 64)))
    with torch.no_grad():
        want = model(tok)
    for use_fused in (None, False):   # on the CPU both run the module itself
        assert torch.equal(make_forward(model, use_fused=use_fused)(tok), want)
    with pytest.raises(ValueError, match="no biases"):
        make_forward(model, use_fused=True)


def test_bias_model_trains_through_the_module_as_jax():
    jcfg = dataclasses.replace(SMALL, attn_impl="auto")
    params, model = _carried(jcfg, key=5)
    model.train().requires_grad_()
    tc = ts.TrainConfig(learning_rate=1e-3, min_lr=1e-4, warmup_iters=2, lr_decay_iters=20,
                        grad_accum=2)
    jtc = jts.TrainConfig(**tc._asdict())
    jstate = jts.init_train_state(jax.tree_util.tree_map(jnp.asarray, params), jtc)
    jstep = jax.jit(jts.make_train_step(jcfg, jtc, use_fused=False))
    step = ts.make_train_step(model, tc)
    rng = np.random.RandomState(5)
    for i in range(3):
        x = rng.randint(0, 67, size=(2, 8, 64)).astype(np.int32)
        y = (x[:, :, 30] % 5).astype(np.int32)
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        loss = step(torch.from_numpy(x), torch.from_numpy(y))
        assert abs(loss.item() - float(jloss)) < 1e-5, (i, loss.item(), float(jloss))
    sched = ts.lr_schedule(tc)
    tol = 1e-6 + 0.01 * sum(sched(i) for i in range(3))
    got = dict(jax.tree_util.tree_leaves_with_path(
        state_dict_to_params(model.state_dict(), model.cfg)))
    for k, w in jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray,
                                                                           jstate.params)):
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol, err_msg=jax.tree_util.keystr(k))

    pallas = load_model(dataclasses.replace(model.cfg, attn_impl="pallas"), model.state_dict(),
                        device="cpu").requires_grad_()
    with pytest.raises(NotImplementedError, match="no gradient"):
        ts.select_loss_fn(pallas)(torch.from_numpy(x[0]), torch.from_numpy(y[0]))


def test_bias_pallas_rollout_matches_jax(monkeypatch):
    b, a, steps = 2, 8, 4
    insts = [sample_instance(random_grid(12, 0.3, s), a, seed=s) for s in range(b)]
    grids = np.stack([i.grid for i in insts])
    starts = np.stack([i.starts for i in insts])
    goals = np.stack([i.goals for i in insts])
    active = np.ones((b, a), bool)
    h, w = grids.shape[1:]
    jcfg = dataclasses.replace(SMALL, block_size=256, attn_impl="pallas")
    params, model = _carried(jcfg, key=6)

    jacts, tacts = [], []
    jact = jrollout.act

    def jax_recording_act(logits, key, do_sample=True):
        actions = jact(logits, key, do_sample=do_sample)
        jax.debug.callback(lambda x: jacts.append(np.asarray(x)), actions, ordered=True)
        return actions

    monkeypatch.setattr(jrollout, "act", jax_recording_act)
    jspec = jenv.MapfEnvSpec(height=h, width=w, num_agents=a, max_episode_steps=steps)
    jstates = jrollout.batch_reset(jspec, jnp.asarray(grids), jnp.asarray(starts),
                                   jnp.asarray(goals)[:, :, None, :], jnp.asarray(active))
    with pltpu.force_tpu_interpret_mode():
        jfinal, jmet = jrollout.make_batch_rollout(jspec, jcfg, do_sample=False)(
            jax.tree_util.tree_map(jnp.asarray, params), jstates, jax.random.PRNGKey(0))
        jax.effects_barrier()

    tact = trollout.act
    monkeypatch.setattr(trollout, "act", lambda *x, **k: tacts.append(tact(*x, **k)) or tacts[-1])
    spec = tenv.MapfEnvSpec(height=h, width=w, num_agents=a, max_episode_steps=steps)
    states = trollout.batch_reset(spec, grids, starts, goals, active, device="cpu")
    final, met = trollout.make_batch_rollout(spec, model, do_sample=False)(states)

    assert len(jacts) == len(tacts) == steps
    for t, (got, want) in enumerate(zip(tacts, jacts)):
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"actions@{t}")
    np.testing.assert_array_equal(final.pos.numpy(), np.asarray(jfinal.pos))
    for f in met._fields:
        np.testing.assert_array_equal(getattr(met, f).numpy(), np.asarray(getattr(jmet, f)),
                                      err_msg=f)
    assert (final.pos != states.pos).any()   # the agents did move
