"""The port's cost2go fields equal the JAX package's, exactly: the numpy BFS
against ``cost2go_host``, the batched sweep relaxation against
``cost2go_device``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.maps import maze_grid, pad_grid, random_grid
from mapf_gpt_tpu.ops import cost2go as jc2g
from mapf_gpt_tpu_torch.ops import cost2go as tc2g

GRIDS = {
    "random": lambda: pad_grid(random_grid(14, 0.3, 3)),
    "maze": lambda: pad_grid(maze_grid(15, 4)),
    "walled": lambda: pad_grid(np.eye(12, dtype=bool)[::-1] | np.eye(12, dtype=bool)),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_cost2go_host_matches_jax(name):
    grid = GRIDS[name]()
    goals = np.argwhere(np.ones_like(grid))[::17]   # free and obstacle cells
    for g in goals:
        np.testing.assert_array_equal(tc2g.cost2go_host(grid, tuple(g)),
                                      jc2g.cost2go_host(grid, tuple(g)))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_cost2go_device_matches_jax(name):
    grid = GRIDS[name]()
    rng = np.random.RandomState(0)
    goals = np.argwhere(~grid)[rng.choice(int((~grid).sum()), 12, replace=False)]
    goals = np.concatenate([goals, np.argwhere(grid)[:2]]).astype(np.int32)
    got = tc2g.cost2go_device(torch.from_numpy(grid), torch.from_numpy(goals))
    ref = jc2g.cost2go_device(jnp.asarray(grid), jnp.asarray(goals))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for k, g in enumerate(goals):
        np.testing.assert_array_equal(got[k].numpy(), tc2g.cost2go_host(grid, tuple(g)))


def test_cost2go_device_per_goal_grids():
    grids = np.stack([pad_grid(random_grid(10, 0.3, s)) for s in range(3)])
    goals = np.stack([np.argwhere(~g)[5] for g in grids]).astype(np.int32)
    got = tc2g.cost2go_device(torch.from_numpy(grids), torch.from_numpy(goals))
    for k in range(3):
        ref = jc2g.cost2go_device(jnp.asarray(grids[k]), jnp.asarray(goals[k:k + 1]))
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref)[0])
