"""The port's lifelong env (``on_target="restart"``, K queued goals, lazy
cost2go) equals the JAX package's exactly, mirroring ``tests/test_env.py``:

- goal advance and goals-reached counting on a one-agent corridor, and the
  throughput metric;
- the dense reset computed in chunks (``c2g_chunk``) equals the unchunked
  one, including a chunk that does not divide B*A*K;
- the lazy layout ([B, A, 1, H, W], relaxed in every step) equals the
  dense one ([B, A, K, H, W]) over an episode of greedy actions that
  advances the queues: positions, goals, goals reached, current fields and
  tokens at every step;
- both layouts against JAX ``step`` under ``vmap`` on random actions, every
  field of the state at every step, and the metrics at the end;
- the sweep (a segmented cumulative minimum) against its plain version
  ``relax_fixpoint_rows`` (a loop over the rows, the JAX ``lax.scan``'s
  form) and against JAX ``relax_fixpoint`` on warm-started seeds;
- ``batch_reset`` takes goal queues [B, A, K, 2] and one goal each [B, A, 2].
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.envs import env as jenv
from mapf_gpt_tpu.envs.metrics import episode_metrics as jax_metrics
from mapf_gpt_tpu.maps import maze_grid, pad_grid, sample_instance
from mapf_gpt_tpu.ops import cost2go as jc2g
from mapf_gpt_tpu_torch.envs import env as tenv
from mapf_gpt_tpu_torch.envs.metrics import episode_metrics
from mapf_gpt_tpu_torch.ops import cost2go as tc2g
from mapf_gpt_tpu_torch.parallel.rollout import _tokens_of, batch_reset

A_WAIT, A_UP, A_DOWN, A_LEFT, A_RIGHT = range(5)


def _mini_grid(h=5, w=7):
    return pad_grid(np.zeros((h, w), dtype=bool), 1)


def test_lifelong_goal_advance_and_counting():
    spec = tenv.MapfEnvSpec(height=7, width=9, num_agents=1, max_episode_steps=8,
                            on_target="restart", num_queued_goals=2)
    state = tenv.reset(spec, _mini_grid()[None], np.array([[[1, 1]]]),
                       np.array([[[[1, 2], [1, 3]]]]), np.ones((1, 1), bool), device="cpu")
    state = tenv.step(spec, state, torch.tensor([[A_RIGHT]]))       # goal 1
    assert state.goal[0, 0].tolist() == [1, 3] and int(state.goals_reached[0, 0]) == 1
    assert not bool(state.done[0])                                  # lifelong never ends early
    state = tenv.step(spec, state, torch.tensor([[A_RIGHT]]))       # goal 2
    assert int(state.goals_reached[0, 0]) == 2
    for _ in range(2):                   # waiting on the spent queue's last goal: no recount
        state = tenv.step(spec, state, torch.tensor([[A_WAIT]]))
    assert int(state.goals_reached[0, 0]) == 2 and int(state.goal_idx[0, 0]) == 1
    assert float(episode_metrics(state).throughput[0]) == 2.0 / 4.0


def test_one_shot_throughput_is_zero():
    spec = tenv.MapfEnvSpec(height=7, width=9, num_agents=1, max_episode_steps=4)
    state = tenv.reset(spec, _mini_grid()[None], np.array([[[1, 1]]]), np.array([[[1, 2]]]),
                       np.ones((1, 1), bool), device="cpu")
    state = tenv.step(spec, state, torch.tensor([[A_RIGHT]]))
    assert float(episode_metrics(state).throughput[0]) == 0.0
    assert state.c2g.shape == (1, 1, 1, 7, 9)


def _instances(seeds, agents, k, size=9):
    insts = [sample_instance(maze_grid(size, seed=s), agents, seed=s + 2,
                             num_lifelong_goals=k) for s in seeds]
    return (np.stack([i.grid for i in insts]), np.stack([i.starts for i in insts]),
            np.stack([i.lifelong_goals for i in insts]), np.ones((len(seeds), agents), bool))


def test_chunked_reset_equals_unchunked():
    grids, starts, goals, active = _instances([3, 4], 3, 4)
    base = tenv.MapfEnvSpec(height=grids.shape[1], width=grids.shape[2], num_agents=3,
                            max_episode_steps=8, on_target="restart", num_queued_goals=4)
    dense = tenv.reset(base, grids, starts, goals, active, device="cpu")
    assert dense.c2g.shape == (2, 3, 4, *grids.shape[1:])
    for chunk in (1, 4, 5):             # 5 does not divide 2 * 3 * 4
        chunked = tenv.reset(base._replace(c2g_chunk=chunk), grids, starts, goals, active,
                             device="cpu")
        assert torch.equal(dense.c2g, chunked.c2g)


def _greedy(state) -> torch.Tensor:
    """Walk each agent down its own cost2go field (conflicts ignored), so
    that queues advance within the episode."""
    c2g = tenv.current_c2g(state).numpy()
    pos = state.pos.numpy()
    acts = np.zeros(pos.shape[:2], np.int64)
    for b in range(pos.shape[0]):
        for a in range(pos.shape[1]):
            i, j = pos[b, a]
            d = c2g[b, a, i, j]
            for cand, (ni, nj) in ((1, (i - 1, j)), (2, (i + 1, j)), (3, (i, j - 1)),
                                   (4, (i, j + 1))):
                if 0 <= c2g[b, a, ni, nj] < d:
                    acts[b, a] = cand
                    break
    return torch.from_numpy(acts)


def test_lazy_equals_dense_over_an_episode():
    grids, starts, goals, active = _instances([5, 6], 4, 6)
    base = tenv.MapfEnvSpec(height=grids.shape[1], width=grids.shape[2], num_agents=4,
                            max_episode_steps=24, on_target="restart", num_queued_goals=6)
    lazy_spec = base._replace(lazy_c2g=True)
    dense = tenv.reset(base, grids, starts, goals, active, device="cpu")
    lazy = tenv.reset(lazy_spec, grids, starts, goals, active, device="cpu")
    assert lazy.c2g.shape == (2, 4, 1, *grids.shape[1:])
    for t in range(24):
        assert torch.equal(tenv.current_c2g(dense), tenv.current_c2g(lazy)), t
        assert torch.equal(_tokens_of(dense), _tokens_of(lazy)), t
        acts = _greedy(dense)
        dense = tenv.step(base, dense, acts)
        lazy = tenv.step(lazy_spec, lazy, acts)
        for f in ("pos", "goal", "goal_idx", "goals_reached", "cost"):
            assert torch.equal(getattr(dense, f), getattr(lazy, f)), (f, t)
    assert int(dense.goals_reached.sum()) > 0


@pytest.mark.parametrize("lazy", [False, True])
def test_lifelong_step_matches_jax(lazy):
    grids, starts, goals, active = _instances([7, 8, 9], 5, 3, size=8)
    active[1, -1] = False
    starts[1, -1] = goals[1, -1, 0]          # an inactive slot sits on its goal
    goals[1, -1] = goals[1, -1, :1]
    h, w = grids.shape[1:]
    spec = tenv.MapfEnvSpec(height=h, width=w, num_agents=5, max_episode_steps=20,
                            on_target="restart", num_queued_goals=3, lazy_c2g=lazy)
    jspec = jenv.MapfEnvSpec(height=h, width=w, num_agents=5, max_episode_steps=20,
                             on_target="restart", num_queued_goals=3, lazy_c2g=lazy)
    jstate = jax.jit(jax.vmap(partial(jenv.reset, jspec)))(
        jnp.asarray(grids), jnp.asarray(starts), jnp.asarray(goals), jnp.asarray(active))
    tstate = batch_reset(spec, grids, starts, goals, active, device="cpu")
    jstep = jax.jit(jax.vmap(partial(jenv.step, jspec)))
    rng = np.random.RandomState(11)
    fields = ("pos", "goal", "goal_idx", "hist", "t", "done", "cost", "ep_len",
              "goals_reached", "c2g", "goals_queue", "active")
    for t in range(24):                  # past max_episode_steps: frozen
        acts = _greedy(tstate) if t % 3 else torch.from_numpy(rng.randint(0, 5, (3, 5)))
        jstate = jstep(jstate, jnp.asarray(acts.numpy(), jnp.int32))
        tstate = tenv.step(spec, tstate, acts)
        for f in fields:
            np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                          np.asarray(getattr(jstate, f)), err_msg=f"{f}@{t}")
    ref, got = jax.vmap(jax_metrics)(jstate), episode_metrics(tstate)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert int(tstate.goals_reached.sum()) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_relax_fixpoint_matches_row_loop_and_jax(seed):
    rng = np.random.RandomState(seed)
    grid = pad_grid(maze_grid(11, seed=seed))
    n = 6
    free = np.broadcast_to(~grid, (n,) + grid.shape)
    cells = np.argwhere(~grid)
    seed_d = np.full((n,) + grid.shape, int(tc2g.INF), np.int32)
    for k in range(n):                   # goals, and warm starts with stale values
        for i, j in cells[rng.choice(len(cells), 1 + k % 3, replace=False)]:
            seed_d[k, i, j] = rng.randint(0, 7)
    seed_d[0, grid] = 5                  # obstacles may carry any value
    got = tc2g.relax_fixpoint(torch.from_numpy(seed_d), torch.from_numpy(free.copy()))
    assert got.dtype == torch.int32
    assert torch.equal(got, tc2g.relax_fixpoint_rows(torch.from_numpy(seed_d),
                                                     torch.from_numpy(free.copy())))
    ref = jc2g.relax_fixpoint(jnp.asarray(seed_d), jnp.asarray(free))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_batch_reset_takes_queues_and_single_goals():
    grids, starts, goals, active = _instances([1, 2], 3, 1)
    spec = tenv.MapfEnvSpec(height=grids.shape[1], width=grids.shape[2], num_agents=3)
    one = batch_reset(spec, grids, starts, goals[:, :, 0], active, device="cpu")
    queue = batch_reset(spec, grids, starts, goals, active, device="cpu")
    for f in one._fields:
        assert torch.equal(getattr(one, f), getattr(queue, f)), f
    with pytest.raises(ValueError, match="goals"):
        batch_reset(spec._replace(num_queued_goals=2), grids, starts, goals, active,
                    device="cpu")
