"""The port's env equals the JAX package's exactly: ``step_positions`` and
``step`` on random action streams (pos, hist, cost, done, t and ep_len at
every step), and ``episode_metrics`` on the states they reach."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.envs import env as jenv
from mapf_gpt_tpu.envs.dynamics import step_positions as jax_step_positions
from mapf_gpt_tpu.envs.metrics import episode_metrics as jax_metrics
from mapf_gpt_tpu.maps import pad_grid, random_grid
from mapf_gpt_tpu_torch.envs import env as tenv
from mapf_gpt_tpu_torch.envs.dynamics import step_positions
from mapf_gpt_tpu_torch.envs.metrics import episode_metrics

_jax_metrics = jax.jit(jax.vmap(jax_metrics))


def _batch(seed, b, a, size, density, inactive_p=0.0):
    """B instances with unique starts/goals; inactive slots sit on their goal."""
    rng = np.random.RandomState(seed)
    grids, starts, goals, active = [], [], [], []
    for k in range(b):
        grid = pad_grid(random_grid(size, density, seed * 31 + k))
        free = np.argwhere(~grid)
        cells = free[rng.choice(len(free), 2 * a, replace=False)]
        act = rng.rand(a) >= inactive_p
        st, gl = cells[:a].copy(), cells[a:].copy()
        gl[~act] = st[~act]
        grids.append(grid)
        starts.append(st)
        goals.append(gl)
        active.append(act)
    return [np.asarray(x) for x in (grids, starts, goals, active)]


def _jax_states(spec, grids, starts, goals, active):
    jspec = jenv.MapfEnvSpec(height=spec.height, width=spec.width,
                             num_agents=spec.num_agents,
                             max_episode_steps=spec.max_episode_steps)
    states = jax.jit(jax.vmap(partial(jenv.reset, jspec)))(
        jnp.asarray(grids), jnp.asarray(starts, jnp.int32),
        jnp.asarray(goals, jnp.int32)[:, :, None, :], jnp.asarray(active))
    return jspec, states


@pytest.mark.parametrize("seed,b,a,size,density", [(0, 4, 24, 8, 0.1),
                                                   (1, 3, 12, 12, 0.3)])
def test_step_positions_matches_jax(seed, b, a, size, density):
    grids, pos, _, active = _batch(seed, b, a, size, density, inactive_p=0.2)
    rng = np.random.RandomState(seed + 100)
    jfn = jax.jit(jax.vmap(jax_step_positions))
    for _ in range(12):
        actions = rng.randint(0, 5, size=(b, a))
        ref = np.asarray(jfn(jnp.asarray(grids), jnp.asarray(pos, jnp.int32),
                             jnp.asarray(actions, jnp.int32), jnp.asarray(active)))
        got = step_positions(torch.from_numpy(grids), torch.from_numpy(pos).int(),
                             torch.from_numpy(actions), torch.from_numpy(active))
        np.testing.assert_array_equal(got.numpy(), ref)
        pos = ref.copy()


@pytest.mark.parametrize("seed,b,a,size,density,steps,inactive_p", [
    (0, 3, 16, 8, 0.15, 24, 0.0),     # crowded: cascading cancellations
    (2, 2, 10, 10, 0.3, 20, 0.25),    # inactive slots, truncation at 16 steps
])
def test_step_and_metrics_match_jax(seed, b, a, size, density, steps, inactive_p):
    grids, starts, goals, active = _batch(seed, b, a, size, density, inactive_p)
    h, w = grids.shape[1:]
    spec = tenv.MapfEnvSpec(height=h, width=w, num_agents=a, max_episode_steps=16)
    jspec, jstate = _jax_states(spec, grids, starts, goals, active)
    tstate = tenv.reset(spec, grids, starts, goals, active, device="cpu")
    np.testing.assert_array_equal(tstate.c2g.numpy(), np.asarray(jstate.c2g))
    jstep = jax.jit(jax.vmap(partial(jenv.step, jspec)))
    rng = np.random.RandomState(seed + 7)
    for t in range(steps):
        actions = rng.randint(0, 5, size=(b, a))
        jstate = jstep(jstate, jnp.asarray(actions, jnp.int32))
        tstate = tenv.step(spec, tstate, torch.from_numpy(actions))
        for f in ("pos", "hist", "cost", "done", "t", "ep_len"):
            np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                          np.asarray(getattr(jstate, f)),
                                          err_msg=f"{f} at step {t}")
    ref = _jax_metrics(jstate)
    got = episode_metrics(tstate)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_episode_ends_when_all_agents_arrive():
    grid = pad_grid(np.zeros((6, 6), bool))
    starts = np.array([[[6, 6], [8, 8], [9, 9]]])
    goals = np.array([[[6, 7], [7, 8], [9, 9]]])     # agent 2 starts on its goal
    active = np.ones((1, 3), bool)
    spec = tenv.MapfEnvSpec(height=16, width=16, num_agents=3, max_episode_steps=8)
    jspec, jstate = _jax_states(spec, grid[None], starts, goals, active)
    tstate = tenv.reset(spec, grid[None], starts, goals, active, device="cpu")
    jstep = jax.jit(jax.vmap(partial(jenv.step, jspec)))
    for actions in ([4, 1, 0], [0, 0, 0], [2, 2, 2]):    # arrive, then frozen
        act = np.array([actions])
        jstate = jstep(jstate, jnp.asarray(act, jnp.int32))
        tstate = tenv.step(spec, tstate, torch.from_numpy(act))
    assert bool(tstate.done[0]) and int(tstate.ep_len[0]) == 1 and int(tstate.t[0]) == 1
    ref, got = _jax_metrics(jstate), episode_metrics(tstate)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    assert float(got.csr[0]) == 1.0 and float(got.soc[0]) == 2.0
