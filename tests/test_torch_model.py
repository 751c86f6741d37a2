"""The port's policy against the JAX package's, on the same weights carried
across by ``models/convert.py``:

- ``GPT`` against flax ``GPT.apply``: fp32 within atol 1e-5 (the same
  arithmetic, summed in another order), bf16 within the fused-kernel
  tolerance of ``tests/test_fused_gpt.py`` (atol 0.02 * max|ref| + 0.02),
  since bf16 rounds at other places in the two frameworks;
- ``fused_logits_reference`` (the plain version of the CUDA kernel) against
  JAX ``fused_logits(..., interpret=True)``: the same tolerance, plus at
  least 95 % argmax agreement over the 5 action logits;
- the reference ``.pt`` loader against ``convert.torch_state_dict_to_params``:
  equal arrays.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.models import convert as jconvert
from mapf_gpt_tpu.models.gpt import CONFIGS as JCONFIGS
from mapf_gpt_tpu.models.gpt import GPT as JGPT
from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.models.gpt import init_params
from mapf_gpt_tpu.ops.fused_gpt import fused_logits as jax_fused_logits
from mapf_gpt_tpu_torch.models.convert import (load_model, load_reference_checkpoint,
                                               params_to_state_dict)
from mapf_gpt_tpu_torch.models.gpt import GPTConfig, act, make_forward
from mapf_gpt_tpu_torch.ops.fused_gpt import (fused_logits, fused_logits_reference,
                                              stack_weights)

CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "checkpoints",
                    "MAPF-GPT-2M-r4.pt")
SMALL = JGPTConfig(n_layer=2, n_head=2, n_embd=64, block_size=64)
_init_params = jax.jit(init_params, static_argnums=0)   # eager init takes seconds


def _port_cfg(jcfg, dtype=torch.bfloat16):
    return GPTConfig(block_size=jcfg.block_size, vocab_size=jcfg.vocab_size,
                     n_layer=jcfg.n_layer, n_head=jcfg.n_head, n_embd=jcfg.n_embd,
                     dtype=dtype)


def _carried(jcfg, key, dtype=torch.bfloat16):
    """(JAX params, the port's model on the CPU with the same weights)."""
    params = _init_params(jcfg, jax.random.PRNGKey(key))
    cfg = _port_cfg(jcfg, dtype)
    sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return params, load_model(cfg, sd, device="cpu")


def _tokens(jcfg, n, seed):
    return np.random.RandomState(seed).randint(0, jcfg.vocab_size,
                                               size=(n, jcfg.block_size))


def _assert_close(got, ref, argmax=False):
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=0.02 * np.abs(ref).max() + 0.02)
    if argmax:
        assert (got[:, :5].argmax(-1) == ref[:, :5].argmax(-1)).mean() >= 0.95


@pytest.mark.parametrize("name,n", [("small", 6), ("2M", 3)])
def test_gpt_fp32_matches_flax(name, n):
    jcfg = dataclasses.replace(SMALL if name == "small" else JCONFIGS["2M"],
                               dtype=jnp.float32)
    params, model = _carried(jcfg, key=1, dtype=torch.float32)
    tok = _tokens(jcfg, n, seed=1)
    ref = np.asarray(jax.jit(JGPT(jcfg).apply)(params, jnp.asarray(tok)))
    got = model(torch.from_numpy(tok)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,n", [("small", 6), ("2M", 3)])
def test_gpt_bf16_matches_flax(name, n):
    jcfg = SMALL if name == "small" else JCONFIGS["2M"]
    params, model = _carried(jcfg, key=2)
    tok = _tokens(jcfg, n, seed=2)
    ref = np.asarray(jax.jit(JGPT(jcfg).apply)(params, jnp.asarray(tok)))
    _assert_close(model(torch.from_numpy(tok)).numpy(), ref)


@pytest.mark.parametrize("name,n", [("small", 16), ("2M", 8)])
def test_fused_reference_matches_jax_kernel(name, n):
    jcfg = SMALL if name == "small" else JCONFIGS["2M"]
    params, model = _carried(jcfg, key=3)
    tok = _tokens(jcfg, n, seed=3)
    kw = {"ctx_per_program": 8} if name == "small" else {}
    ref = np.asarray(jax_fused_logits(params, jnp.asarray(tok), jcfg, interpret=True, **kw))
    got = fused_logits_reference(stack_weights(model), torch.from_numpy(tok)).numpy()
    _assert_close(got, ref, argmax=True)


def test_fused_reference_trained_2m_matches_jax_kernel():
    jcfg, params = jconvert.load_torch_checkpoint(CKPT)
    cfg, sd = load_reference_checkpoint(CKPT)
    tok = _tokens(jcfg, 8, seed=4)
    ref = np.asarray(jax_fused_logits(params, jnp.asarray(tok), jcfg, interpret=True))
    w = stack_weights(load_model(cfg, sd, device="cpu"))
    _assert_close(fused_logits_reference(w, torch.from_numpy(tok)).numpy(), ref, argmax=True)


def test_reference_checkpoint_loader_matches_jax_convert():
    cfg, sd = load_reference_checkpoint(CKPT)
    assert len(sd) == 34 and (cfg.n_layer, cfg.n_head, cfg.n_embd) == (5, 5, 160)
    jcfg, params = jconvert.load_torch_checkpoint(CKPT)
    carried = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    assert sorted(carried) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(carried[k].numpy(), sd[k].numpy(), err_msg=k)
    # and back: the port's state dict converts to the same JAX params
    back = jconvert.torch_state_dict_to_params({k: v.numpy() for k, v in sd.items()}, jcfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    model = load_model(cfg, sd, device="cpu")
    assert model.lm_head.weight is model.transformer.wte.weight


def test_cpu_forward_and_wrapper_take_the_plain_paths():
    jcfg = SMALL
    _, model = _carried(jcfg, key=5)
    tok = torch.from_numpy(_tokens(jcfg, 4, seed=5))
    np.testing.assert_array_equal(make_forward(model)(tok).numpy(), model(tok).numpy())
    w = stack_weights(model)
    np.testing.assert_array_equal(fused_logits(w, tok).numpy(),
                                  fused_logits_reference(w, tok).numpy())
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_logits(w, tok.to("meta"))


def test_act_argmax_and_sampling():
    logits = torch.from_numpy(np.random.RandomState(0).randn(64, 67).astype(np.float32))
    np.testing.assert_array_equal(act(logits, do_sample=False).numpy(),
                                  logits[:, :5].numpy().argmax(-1))
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    a1, a2 = act(logits, g1), act(logits, g2)
    assert torch.equal(a1, a2) and 0 <= int(a1.min()) and int(a1.max()) < 5
    with pytest.raises(ValueError):
        act(logits, None, do_sample=True)
