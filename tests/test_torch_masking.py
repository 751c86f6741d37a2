"""The port's input masks and decoder equal the JAX package's exactly:

- ``apply_masks`` for all 16 combinations of the four switches, on the
  golden episode's real contexts and on random token ids (the unreachable
  id among them), ints in and the same dtype out;
- ``decode_context`` and ``token_to_str`` on real contexts and on every id
  of the vocabulary.
"""

import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.ops import masking as jmask
from mapf_gpt_tpu_torch.ops import masking as tmask
from mapf_gpt_tpu_torch.ops import vocab as V

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "episode_golden.npz")


def _contexts() -> np.ndarray:
    g = np.load(FIXTURE)
    real = g["tokens"][::4].reshape(-1, V.CONTEXT_SIZE)[:40]
    rand = np.random.RandomState(3).randint(0, V.VOCAB_SIZE, size=(24, V.CONTEXT_SIZE))
    return np.concatenate([real, rand]).astype(np.int32)


@pytest.mark.parametrize("flags", list(itertools.product([False, True], repeat=4)))
def test_apply_masks_matches_jax(flags):
    tokens = _contexts()
    cfg = tmask.MaskConfig(*flags)
    got = tmask.apply_masks(torch.from_numpy(tokens).reshape(4, -1, V.CONTEXT_SIZE), cfg)
    ref = np.asarray(jmask.apply_masks(jnp.asarray(tokens), jmask.MaskConfig(*flags)))
    assert got.dtype == torch.int32 and cfg.any == any(flags)
    np.testing.assert_array_equal(got.reshape(-1, V.CONTEXT_SIZE).numpy(), ref)
    if any(flags):
        assert not np.array_equal(ref, tokens)


def test_decode_context_and_token_to_str_match_jax():
    for tok in range(V.VOCAB_SIZE + 2):
        assert tmask.token_to_str(tok) == jmask.token_to_str(tok), tok
    for ctx in _contexts()[::7]:
        got, ref = tmask.decode_context(ctx), jmask.decode_context(ctx)
        np.testing.assert_array_equal(got["cost2go"], ref["cost2go"])
        assert got["agents"] == ref["agents"]
    with pytest.raises(ValueError, match="one context"):
        tmask.decode_context(np.zeros(10, np.int32))
