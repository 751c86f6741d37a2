"""The slice as a whole against the JAX package.

- The committed golden episode (``tests/fixtures/episode_golden.npz``)
  replayed through the port's env, tokenizer and bf16 policy: tokens and
  positions exact at every step; logits, from the weights of JAX
  ``init_params(PRNGKey(0))`` carried across, within the bf16 tolerance of
  ``tests/test_fused_gpt.py`` (atol 0.02 * max|ref| + 0.02), because bf16
  rounds at other places in the two frameworks.
- The port's ``make_batch_rollout(do_sample=False)`` against JAX
  ``make_batch_rollout`` in fp32 on B=2, A=8, 16 steps: equal final
  positions and equal per-env metrics.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mapf_gpt_tpu.envs import env as jenv
from mapf_gpt_tpu.models.gpt import CONFIGS as JCONFIGS
from mapf_gpt_tpu.models.gpt import init_params
from mapf_gpt_tpu.parallel import rollout as jrollout
from mapf_gpt_tpu_torch.envs import env as tenv
from mapf_gpt_tpu_torch.maps import random_grid, sample_instance
from mapf_gpt_tpu_torch.models.convert import load_model, params_to_state_dict
from mapf_gpt_tpu_torch.models.gpt import CONFIGS, action_logits, make_forward
from mapf_gpt_tpu_torch.parallel.rollout import _tokens_of, batch_reset, make_batch_rollout

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "episode_golden.npz")


def _model(cfg, key=0, init=jax.jit(init_params, static_argnums=0)):
    """(JAX config, JAX params, the port's model with the same weights).
    The jitted init is faster; the golden episode needs the eager one's
    exact weights."""
    jcfg = dataclasses.replace(JCONFIGS["2M"], dtype=jnp.float32 if cfg.dtype == torch.float32
                               else jnp.bfloat16)
    params = init(jcfg, jax.random.PRNGKey(key))
    sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return jcfg, params, load_model(cfg, sd, device="cpu")


def test_golden_episode_replay():
    g = np.load(FIXTURE)
    steps, agents = g["actions"].shape
    _, _, model = _model(CONFIGS["2M"], init=init_params)
    forward = make_forward(model)
    h, w = g["grid"].shape
    spec = tenv.MapfEnvSpec(height=h, width=w, num_agents=agents, max_episode_steps=steps)
    state = batch_reset(spec, g["grid"][None], g["starts"][None], g["goals"][None],
                        np.ones((1, agents), bool), device="cpu")
    np.testing.assert_array_equal(state.pos[0].numpy(), g["positions"][0])
    agree = []
    for t in range(steps):
        tok = _tokens_of(state)[0]
        np.testing.assert_array_equal(tok.numpy(), g["tokens"][t], err_msg=f"tokens@{t}")
        logits = action_logits(forward(tok)).numpy()
        ref = g["logits"][t]
        np.testing.assert_allclose(logits, ref, atol=0.02 * np.abs(ref).max() + 0.02,
                                   err_msg=f"logits@{t}")
        agree.append(logits.argmax(-1) == g["actions"][t])
        state = tenv.step(spec, state, torch.from_numpy(g["actions"][t][None].astype(np.int64)))
        np.testing.assert_array_equal(state.pos[0].numpy(), g["positions"][t + 1],
                                      err_msg=f"positions@{t}")
    assert np.mean(agree) >= 0.95


def test_batch_rollout_fp32_matches_jax():
    b, a, steps = 2, 8, 16
    insts = [sample_instance(random_grid(12, 0.3, s), a, seed=s) for s in range(b)]
    grids = np.stack([i.grid for i in insts])
    starts = np.stack([i.starts for i in insts])
    goals = np.stack([i.goals for i in insts])
    active = np.ones((b, a), bool)
    h, w = grids.shape[1:]
    cfg = dataclasses.replace(CONFIGS["2M"], dtype=torch.float32)
    jcfg, params, model = _model(cfg, key=0)

    jspec = jenv.MapfEnvSpec(height=h, width=w, num_agents=a, max_episode_steps=steps)
    jstates = jrollout.batch_reset(jspec, jnp.asarray(grids), jnp.asarray(starts),
                                   jnp.asarray(goals)[:, :, None, :], jnp.asarray(active))
    jfinal, jmet = jrollout.make_batch_rollout(jspec, jcfg, do_sample=False)(
        params, jstates, jax.random.PRNGKey(0))

    spec = tenv.MapfEnvSpec(height=h, width=w, num_agents=a, max_episode_steps=steps)
    states = batch_reset(spec, grids, starts, goals, active, device="cpu")
    final, met = make_batch_rollout(spec, model, do_sample=False)(states)

    np.testing.assert_array_equal(final.pos.numpy(), np.asarray(jfinal.pos))
    for f in met._fields:
        np.testing.assert_array_equal(getattr(met, f).numpy(), np.asarray(getattr(jmet, f)),
                                      err_msg=f)
    assert (final.pos != states.pos).any()   # the agents did move


def test_batch_rollout_policy_batch_and_sampling():
    """Chunked policy forward gives the unchunked actions; sampled runs are
    reproducible from the generator's seed and keep the env's invariants."""
    b, a, steps = 2, 6, 6
    insts = [sample_instance(random_grid(10, 0.3, s), a, seed=s) for s in range(b)]
    grids = np.stack([i.grid for i in insts])
    spec = tenv.MapfEnvSpec(height=grids.shape[1], width=grids.shape[2], num_agents=a,
                            max_episode_steps=steps)
    states = batch_reset(spec, grids, np.stack([i.starts for i in insts]),
                         np.stack([i.goals for i in insts]), np.ones((b, a), bool),
                         device="cpu")
    _, _, model = _model(CONFIGS["2M"], key=1)
    whole, _ = make_batch_rollout(spec, model, do_sample=False)(states)
    chunked, _ = make_batch_rollout(spec, model, do_sample=False, policy_batch=5)(states)
    assert torch.equal(whole.pos, chunked.pos)
    run = make_batch_rollout(spec, model, do_sample=True)
    s1, m1 = run(states, torch.Generator().manual_seed(3))
    s2, m2 = run(states, torch.Generator().manual_seed(3))
    assert torch.equal(s1.pos, s2.pos) and torch.equal(m1.soc, m2.soc)
    lin = s1.pos[..., 0] * grids.shape[2] + s1.pos[..., 1]
    assert all(len(set(row.tolist())) == a for row in lin)
    assert not torch.from_numpy(grids)[torch.arange(b)[:, None], s1.pos[..., 0].long(),
                                       s1.pos[..., 1].long()].any()
