"""The trained 85M (``checkpoints/MAPF-GPT-85M-r5.pt``) in the port against
the JAX package:

- the checkpoint loads with ``strict=True``, and its state dict equals
  ``convert.torch_state_dict_to_params``'s arrays both ways;
- the whole forward on the chunked route (``fused_logits`` on CPU tensors:
  the plain embedding, ``blocks_reference`` over 3-layer chunks, the plain
  head) against JAX ``fused_logits(..., interpret=True)`` on 2 contexts:
  within the fused tolerance of ``tests/test_fused_gpt.py`` (atol
  0.02 * max|ref| + 0.02) with the same argmax over the 5 action logits.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.models import convert as jconvert
from mapf_gpt_tpu.ops.fused_gpt import fused_logits as jax_fused_logits
from mapf_gpt_tpu_torch.models.convert import (load_model, load_reference_checkpoint,
                                               params_to_state_dict)
from mapf_gpt_tpu_torch.ops.fused_gpt import default_layers_per_call, fused_logits, stack_weights

CKPT_85M = os.path.join(os.path.dirname(os.path.dirname(__file__)), "checkpoints",
                        "MAPF-GPT-85M-r5.pt")


@pytest.fixture(scope="module")
def trained_85m():
    """(port config, port state dict, JAX config, JAX params) of the checkpoint."""
    cfg, sd = load_reference_checkpoint(CKPT_85M)
    jcfg, params = jconvert.load_torch_checkpoint(CKPT_85M)
    return cfg, sd, jcfg, params


def test_85m_checkpoint_loads_strict_and_matches_jax_convert(trained_85m):
    cfg, sd, jcfg, params = trained_85m
    assert (cfg.n_layer, cfg.n_head, cfg.n_embd) == (12, 12, 768) and len(sd) == 76
    model = load_model(cfg, sd, device="cpu")   # strict=True
    assert model.lm_head.weight is model.transformer.wte.weight
    back = jconvert.torch_state_dict_to_params({k: v.numpy() for k, v in sd.items()}, jcfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    carried = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    assert sorted(carried) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(carried[k].numpy(), sd[k].numpy(), err_msg=k)


def test_trained_85m_chunked_forward_matches_jax(trained_85m):
    cfg, sd, jcfg, params = trained_85m
    assert default_layers_per_call(cfg.n_embd, cfg.n_layer) == 3   # the chunked route
    tok = np.random.RandomState(85).randint(0, cfg.vocab_size, size=(2, cfg.block_size))
    ref = np.asarray(jax_fused_logits(params, jnp.asarray(tok), jcfg, interpret=True))
    w = stack_weights(load_model(cfg, sd, device="cpu"))
    got = fused_logits(w, torch.from_numpy(tok)).numpy()
    assert got.shape == ref.shape == (2, cfg.vocab_size) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=0.02 * np.abs(ref).max() + 0.02)
    np.testing.assert_array_equal(got[:, :5].argmax(-1), ref[:, :5].argmax(-1))
