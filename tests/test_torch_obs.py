"""The port's tokenizer equals the JAX package's, token for token: on the
committed golden fixture, and against JAX ``observe`` on random states
(random positions, goals, histories and active masks)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.maps import pad_grid, random_grid
from mapf_gpt_tpu.ops.cost2go import cost2go_host
from mapf_gpt_tpu.ops.obs import observe as jax_observe
from mapf_gpt_tpu_torch.envs import env as tenv
from mapf_gpt_tpu_torch.ops.obs import observe

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "obs_golden.npz")
_jax_observe = jax.jit(jax.vmap(jax_observe))


def test_obs_golden_fixture_replay():
    g = np.load(FIXTURE)
    a = g["starts"].shape[0]
    h, w = g["grid"].shape
    spec = tenv.MapfEnvSpec(height=h, width=w, num_agents=a, max_episode_steps=10**6)
    state = tenv.reset(spec, g["grid"][None], g["starts"][None], g["goals"][None],
                       np.ones((1, a), bool), device="cpu")
    for t in range(len(g["tokens"])):
        tok = observe(tenv.current_c2g(state), state.pos, state.goal, state.hist,
                      state.active)
        assert tok.dtype == torch.int32
        np.testing.assert_array_equal(tok[0].numpy(), g["tokens"][t], err_msg=f"step {t}")
        if t < len(g["actions"]):
            state = tenv.step(spec, state, torch.from_numpy(g["actions"][t][None]))


def _random_states(seed, b, a, size, inactive_p):
    rng = np.random.RandomState(seed)
    grids, pos, goal, hist, active = [], [], [], [], []
    for k in range(b):
        grid = pad_grid(random_grid(size, 0.25, seed * 100 + k))
        free = np.argwhere(~grid)
        # crowd the agents into one corner so many neighbours fall within radius
        near = free[np.argsort(free.sum(1), kind="stable")[:3 * a]]
        pos.append(near[rng.choice(len(near), a, replace=False)])
        goal.append(free[rng.choice(len(free), a, replace=False)])
        hist.append(rng.randint(0, 6, size=(a, 5)))
        active.append(rng.rand(a) >= inactive_p)
        grids.append(grid)
    return [np.asarray(x) for x in (grids, pos, goal, hist, active)]


@pytest.mark.parametrize("seed,b,a,size,inactive_p", [
    (0, 3, 16, 12, 0.0),     # more than 13 neighbours in reach
    (1, 2, 9, 10, 0.3),      # fewer agents than records, inactive slots
    (2, 2, 24, 20, 0.1),
])
def test_observe_matches_jax_on_random_states(seed, b, a, size, inactive_p):
    grids, pos, goal, hist, active = _random_states(seed, b, a, size, inactive_p)
    c2g = np.stack([np.stack([cost2go_host(grids[k], g) for g in goal[k]])
                    for k in range(b)])
    ref = _jax_observe(jnp.asarray(c2g), jnp.asarray(pos, jnp.int32),
                               jnp.asarray(goal, jnp.int32), jnp.asarray(hist, jnp.int32),
                               jnp.asarray(active))
    got = observe(torch.from_numpy(c2g), torch.from_numpy(pos).int(),
                  torch.from_numpy(goal).int(), torch.from_numpy(hist).int(),
                  torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_observe_unpadded_grid_reads_zero_like_jax():
    """Without the obstacle border the window reads 0 outside the field,
    as the JAX package's one-hot extraction does (the documented
    precondition, kept bit for bit)."""
    grid = np.zeros((9, 9), bool)
    pos = np.array([[[0, 0], [4, 4], [8, 7]]])
    goal = np.array([[[8, 8], [2, 3], [0, 0]]])
    c2g = np.stack([np.stack([cost2go_host(grid, g) for g in goal[0]])])
    hist = np.zeros((1, 3, 5), np.int32)
    active = np.ones((1, 3), bool)
    ref = _jax_observe(jnp.asarray(c2g), jnp.asarray(pos, jnp.int32),
                               jnp.asarray(goal, jnp.int32), jnp.asarray(hist),
                               jnp.asarray(active))
    got = observe(torch.from_numpy(c2g), torch.from_numpy(pos).int(),
                  torch.from_numpy(goal).int(), torch.from_numpy(hist),
                  torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
