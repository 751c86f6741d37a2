"""The rest of the rollout against the JAX package, exactly, with the same
weights carried across and argmax actions in fp32:

- ``replay_rollout`` on the committed golden episode
  (``tests/fixtures/episode_golden.npz``): positions and tokens at every
  step equal the fixture and JAX ``replay_rollout``;
- ``make_recorded_rollout``: the trajectory, final positions and metrics
  equal JAX ``make_recorded_rollout``'s, with and without an input mask;
- ``make_batch_rollout`` with input masks (``mask_cfg``) and on lifelong
  episodes (dense and lazy cost2go, K = 4): final state and per-env
  metrics equal JAX ``make_batch_rollout``'s, and masking changes the
  trajectory.

The policy is a small fp32 model whose JAX ``init_params`` weights are
scaled 8x, as ``tests/test_eval.py`` does, so that its actions depend on the
masked inputs.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.envs import env as jenv
from mapf_gpt_tpu.maps import sample_instance as jsample_instance
from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.models.gpt import init_params
from mapf_gpt_tpu.ops.masking import MaskConfig as JMaskConfig
from mapf_gpt_tpu.parallel import rollout as jrollout
from mapf_gpt_tpu_torch.envs import env as tenv
from mapf_gpt_tpu_torch.maps import maze_grid, random_grid, sample_instance
from mapf_gpt_tpu_torch.models.convert import load_model, params_to_state_dict
from mapf_gpt_tpu_torch.models.gpt import GPTConfig
from mapf_gpt_tpu_torch.ops.masking import MaskConfig
from mapf_gpt_tpu_torch.parallel.rollout import (batch_reset, make_batch_rollout,
                                                 make_recorded_rollout, replay_rollout)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "episode_golden.npz")
MASK = (True, False, False, True)   # history and greedy action masked


@pytest.fixture(scope="module")
def policy():
    """(JAX config, JAX params, the port's model): 2 layers, 4 heads, 64
    wide, fp32, weights scaled 8x."""
    jcfg = JGPTConfig(n_layer=2, n_head=4, n_embd=64, dtype=jnp.float32)
    params = jax.tree_util.tree_map(lambda x: x * 8.0,
                                    jax.jit(init_params, static_argnums=0)(
                                        jcfg, jax.random.PRNGKey(1)))
    cfg = GPTConfig(n_layer=2, n_head=4, n_embd=64, dtype=torch.float32)
    sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return jcfg, params, load_model(cfg, sd, device="cpu")


def test_replay_rollout_on_the_golden_episode():
    g = np.load(FIXTURE)
    steps, a = g["actions"].shape
    h, w = g["grid"].shape
    spec = tenv.MapfEnvSpec(height=h, width=w, num_agents=a, max_episode_steps=steps)
    state = batch_reset(spec, g["grid"][None], g["starts"][None], g["goals"][None],
                        np.ones((1, a), bool), device="cpu")
    positions, tokens = replay_rollout(spec, state, torch.from_numpy(g["actions"]))
    np.testing.assert_array_equal(positions.numpy(), g["positions"])
    np.testing.assert_array_equal(tokens.numpy(), g["tokens"])
    jspec = jenv.MapfEnvSpec(height=h, width=w, num_agents=a, max_episode_steps=steps)
    jstate = jenv.reset(jspec, jnp.asarray(g["grid"]), jnp.asarray(g["starts"]),
                        jnp.asarray(g["goals"])[:, None], jnp.ones((a,), bool))
    jpos, jtok = jrollout.replay_rollout(jspec, jstate, jnp.asarray(g["actions"], jnp.int32))
    np.testing.assert_array_equal(positions.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("mask", [None, MASK])
def test_recorded_rollout_matches_jax(policy, mask):
    jcfg, params, model = policy
    inst = sample_instance(random_grid(10, 0.2, 4), 6, seed=4)
    h, w = inst.grid.shape
    spec = tenv.MapfEnvSpec(height=h, width=w, num_agents=6, max_episode_steps=12)
    state = batch_reset(spec, inst.grid[None], inst.starts[None], inst.goals[None],
                        np.ones((1, 6), bool), device="cpu")
    final, met, positions = make_recorded_rollout(
        spec, model, do_sample=False, mask_cfg=mask and MaskConfig(*mask))(state)
    jspec = jenv.MapfEnvSpec(height=h, width=w, num_agents=6, max_episode_steps=12)
    jstate = jenv.reset(jspec, jnp.asarray(inst.grid), jnp.asarray(inst.starts),
                        jnp.asarray(inst.goals)[:, None], jnp.ones((6,), bool))
    jfinal, jmet, jpositions = jrollout.make_recorded_rollout(
        jspec, jcfg, do_sample=False, mask_cfg=mask and JMaskConfig(*mask))(
        params, jstate, jax.random.PRNGKey(0))
    assert positions.shape == (13, 6, 2)
    np.testing.assert_array_equal(positions.numpy(), np.asarray(jpositions))
    np.testing.assert_array_equal(final.pos[0].numpy(), np.asarray(jfinal.pos))
    for f in met._fields:
        np.testing.assert_array_equal(getattr(met, f).numpy()[0], np.asarray(getattr(jmet, f)),
                                      err_msg=f)


def _batch(k: int, b: int = 2, a: int = 6):
    insts = [jsample_instance(maze_grid(9, seed=s), a, seed=s, num_lifelong_goals=k)
             if k > 1 else jsample_instance(random_grid(10, 0.2, s), a, seed=s)
             for s in range(b)]
    goals = np.stack([i.lifelong_goals if k > 1 else i.goals[:, None] for i in insts])
    return (np.stack([i.grid for i in insts]), np.stack([i.starts for i in insts]), goals,
            np.ones((b, a), bool))


@pytest.mark.parametrize("case", ["masked", "lifelong dense", "lifelong lazy"])
def test_batch_rollout_matches_jax(policy, case):
    jcfg, params, model = policy
    k = 1 if case == "masked" else 4
    grids, starts, goals, active = _batch(k)
    h, w = grids.shape[1:]
    kw = dict(height=h, width=w, num_agents=6, max_episode_steps=14, num_queued_goals=k,
              on_target="nothing" if k == 1 else "restart", lazy_c2g=case == "lifelong lazy")
    mask = MASK if case == "masked" else None
    spec, jspec = tenv.MapfEnvSpec(**kw), jenv.MapfEnvSpec(**kw)
    states = batch_reset(spec, grids, starts, goals, active, device="cpu")
    final, met = make_batch_rollout(spec, model, do_sample=False,
                                    mask_cfg=mask and MaskConfig(*mask))(states)
    jstates = jrollout.batch_reset(jspec, *(jnp.asarray(x) for x in (grids, starts, goals,
                                                                      active)))
    jfinal, jmet = jrollout.make_batch_rollout(
        jspec, jcfg, do_sample=False, mask_cfg=mask and JMaskConfig(*mask))(
        params, jstates, jax.random.PRNGKey(0))
    for f in ("pos", "goal", "hist", "goals_reached", "cost", "ep_len"):
        np.testing.assert_array_equal(getattr(final, f).numpy(), np.asarray(getattr(jfinal, f)),
                                      err_msg=f)
    for f in met._fields:
        np.testing.assert_array_equal(getattr(met, f).numpy(), np.asarray(getattr(jmet, f)),
                                      err_msg=f)
    if mask:   # the mask changes what the policy does
        plain, _ = make_batch_rollout(spec, model, do_sample=False)(states)
        assert not torch.equal(plain.hist, final.hist)
    else:
        assert float(met.throughput.sum()) > 0
