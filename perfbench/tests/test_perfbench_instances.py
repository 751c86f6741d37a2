"""Instances and training rows repeat from a seed, and the frozen generator
gives the program's instances."""

import numpy as np
import pytest

from perfbench import instances, shards
from mapf_gpt_tpu_torch import maps


@pytest.mark.parametrize("seed", [0, 7, 3000000019])
def test_instances_repeat_from_a_seed(seed):
    seeds = np.random.SeedSequence([seed, 1, 0]).generate_state(3)
    a = instances.instance_batch(21, 0.3, 3, 32, seeds)
    b = instances.instance_batch(21, 0.3, 3, 32, seeds)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    grids, starts, goals = a
    assert grids.shape == (3, 31, 31) and starts.shape == goals.shape == (3, 32, 2)
    for g, s, t in zip(grids, starts, goals):
        assert not g[s[:, 0], s[:, 1]].any() and not g[t[:, 0], t[:, 1]].any()
        assert len({tuple(p) for p in s}) == 32 and len({tuple(p) for p in t}) == 32


def test_instances_differ_between_seeds():
    a = instances.instance_batch(21, 0.3, 2, 32, [1, 2])
    b = instances.instance_batch(21, 0.3, 2, 32, [3, 4])
    assert not np.array_equal(a[0], b[0])


@pytest.mark.parametrize("seed", [5, 4000000007])
def test_frozen_copy_equals_the_programs_generator(seed):
    grid, starts, goals = instances.sample_instance(instances.random_grid(21, 0.3, seed), 32, seed)
    inst = maps.sample_instance(maps.random_grid(21, 0.3, seed), 32, seed=seed)
    np.testing.assert_array_equal(grid, inst.grid)
    np.testing.assert_array_equal(starts, inst.starts)
    np.testing.assert_array_equal(goals, inst.goals)


def test_rows_repeat_and_are_found_by_content():
    tokens, targets = shards.make_rows(11, 64, 256, 67, 5)
    again, _ = shards.make_rows(11, 64, 256, 67, 5)
    np.testing.assert_array_equal(tokens, again)
    assert tokens.min() >= 0 and tokens.max() < 67 and targets.max() < 5
    index = shards.RowIndex(tokens)
    order = np.random.default_rng(0).permutation(64)
    np.testing.assert_array_equal(index.find(tokens[order]), order)
    other, _ = shards.make_rows(12, 4, 256, 67, 5)
    assert (index.find(other) == -1).all()


def test_shard_written_is_what_the_programs_reader_reads(tmp_path):
    pytest.importorskip("pyarrow")
    from mapf_gpt_tpu_torch.train.data import read_arrow_shard

    tokens, targets = shards.make_rows(3, 32, 256, 67, 5)
    path = str(tmp_path / "a.arrow")
    shards.write_arrow_shard(path, tokens, targets)
    got_tokens, got_targets = read_arrow_shard(path)
    np.testing.assert_array_equal(got_tokens, tokens)
    np.testing.assert_array_equal(got_targets, targets)
