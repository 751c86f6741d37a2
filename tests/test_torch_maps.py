"""The port's own copies of the vocabulary and the map generators equal the
JAX package's: same constants, and the same arrays from the same seeds."""

import numpy as np
import pytest

from mapf_gpt_tpu import maps as jmaps
from mapf_gpt_tpu.ops import vocab as jvocab
from mapf_gpt_tpu_torch import maps as tmaps
from mapf_gpt_tpu_torch.ops import vocab as tvocab


def test_vocab_copy_is_equal():
    names = [n for n in dir(jvocab) if n.isupper()]
    assert names and names == [n for n in dir(tvocab) if n.isupper()]
    for n in names:
        assert getattr(tvocab, n) == getattr(jvocab, n), n
    for v in range(-jvocab.C2G_LIMIT, jvocab.C2G_LIMIT + 1):
        assert tvocab.coord_token(v) == jvocab.coord_token(v)


@pytest.mark.parametrize("size,density,seed", [(21, 0.3, 0), (16, 0.25, 7),
                                               (33, 0.4, 2**33 + 5)])
def test_random_grid_and_pad(size, density, seed):
    g = tmaps.random_grid(size, density, seed)
    np.testing.assert_array_equal(g, jmaps.random_grid(size, density, seed))
    np.testing.assert_array_equal(tmaps.pad_grid(g), jmaps.pad_grid(g))
    np.testing.assert_array_equal(tmaps._components(g), jmaps._components(g))


@pytest.mark.parametrize("size,agents,seed", [(21, 32, 0), (21, 32, 5),
                                              (12, 20, 3)])
def test_sample_instance(size, agents, seed):
    grid = tmaps.random_grid(size, 0.3, seed)
    got = tmaps.sample_instance(grid, agents, seed)
    ref = jmaps.sample_instance(grid, agents, seed)
    for field in ("grid", "starts", "goals"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))
        assert getattr(got, field).dtype == getattr(ref, field).dtype
