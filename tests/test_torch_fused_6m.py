"""The 6M on the port's e2e route against the JAX package, on weights carried
across by ``models/convert.py`` (numpy in between):

- ``fused_logits_reference`` (the plain version of the CUDA kernel, here at
  E=256 / 8 heads) against JAX ``fused_logits(..., interpret=True)`` on
  random-init and on the trained ``MAPF-GPT-6M-r5.pt``: within the fused
  tolerance of ``tests/test_fused_gpt.py`` (atol 0.02 * max|ref| + 0.02),
  plus at least 95 % argmax agreement over the 5 action logits;
- the 6M checkpoint loaded with ``strict=True``, its state dict equal to
  ``convert.torch_state_dict_to_params``'s arrays;
- ``default_layers_per_call``, the port's copy, equal to the JAX package's;
- on the CPU, ``make_forward`` runs the module and ``fused_logits`` the
  plain version, and the chunked route's result does not depend on its
  chunk size;
- a B=2, A=8, 16-step fp32 rollout of a 6M-shaped model equal to JAX
  ``make_batch_rollout``: equal final positions and per-env metrics.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.envs import env as jenv
from mapf_gpt_tpu.models import convert as jconvert
from mapf_gpt_tpu.models.gpt import CONFIGS as JCONFIGS
from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.models.gpt import init_params as jinit_params
from mapf_gpt_tpu.ops.fused_gpt import default_layers_per_call as jdefault_layers_per_call
from mapf_gpt_tpu.ops.fused_gpt import fused_logits as jax_fused_logits
from mapf_gpt_tpu.parallel import rollout as jrollout
from mapf_gpt_tpu_torch.envs import env as tenv
from mapf_gpt_tpu_torch.maps import random_grid, sample_instance
from mapf_gpt_tpu_torch.models.convert import (load_model, load_reference_checkpoint,
                                               params_to_state_dict)
from mapf_gpt_tpu_torch.models.gpt import CONFIGS, GPTConfig, make_forward
from mapf_gpt_tpu_torch.ops.fused_blocks import blocks_reference
from mapf_gpt_tpu_torch.ops.fused_gpt import (chunked_logits, default_layers_per_call,
                                              fused_logits, fused_logits_reference,
                                              stack_weights)
from mapf_gpt_tpu_torch.parallel.rollout import batch_reset, make_batch_rollout

CKPT_6M = os.path.join(os.path.dirname(os.path.dirname(__file__)), "checkpoints",
                       "MAPF-GPT-6M-r5.pt")
_init_params = jax.jit(jinit_params, static_argnums=0)


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
    return np.random.RandomState(seed).randint(0, jcfg.vocab_size, size=(n, jcfg.block_size))


def _assert_close(got, ref):
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=0.02 * np.abs(ref).max() + 0.02)
    assert (got[:, :5].argmax(-1) == ref[:, :5].argmax(-1)).mean() >= 0.95


def test_default_layers_per_call_matches_jax():
    for name, jcfg in JCONFIGS.items():
        assert default_layers_per_call(jcfg.n_embd, jcfg.n_layer) == \
            jdefault_layers_per_call(jcfg), name
    for e, layers in ((64, 4), (512, 24), (1024, 16), (2048, 2)):
        jcfg = JGPTConfig(n_layer=layers, n_head=4, n_embd=e)
        assert default_layers_per_call(e, layers) == jdefault_layers_per_call(jcfg)
    assert default_layers_per_call(768, 12) == 3 < 12


@pytest.mark.parametrize("weights", ["random", "trained"])
def test_fused_reference_6m_matches_jax_kernel(weights):
    if weights == "random":
        jcfg = JCONFIGS["6M"]
        params, model = _carried(jcfg, key=6)
    else:
        jcfg, params = jconvert.load_torch_checkpoint(CKPT_6M)
        cfg, sd = load_reference_checkpoint(CKPT_6M)
        model = load_model(cfg, sd, device="cpu")
    assert (jcfg.n_layer, jcfg.n_head, jcfg.n_embd) == (8, 8, 256)
    tok = _tokens(jcfg, 8, seed=6)
    ref = np.asarray(jax_fused_logits(params, jnp.asarray(tok), jcfg, interpret=True))
    w = stack_weights(model)
    got = fused_logits_reference(w, torch.from_numpy(tok)).numpy()
    _assert_close(got, ref)
    # fused_logits on CPU tensors is the plain version
    np.testing.assert_array_equal(fused_logits(w, torch.from_numpy(tok)).numpy(), got)


def test_6m_checkpoint_loads_strict_and_matches_jax_convert():
    cfg, sd = load_reference_checkpoint(CKPT_6M)
    assert (cfg.n_layer, cfg.n_head, cfg.n_embd) == (8, 8, 256) and len(sd) == 52
    model = load_model(cfg, sd, device="cpu")   # strict=True
    assert model.lm_head.weight is model.transformer.wte.weight
    jcfg, params = jconvert.load_torch_checkpoint(CKPT_6M)
    back = jconvert.torch_state_dict_to_params({k: v.numpy() for k, v in sd.items()}, jcfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    carried = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    assert sorted(carried) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(carried[k].numpy(), sd[k].numpy(), err_msg=k)


def test_cpu_forward_and_wrapper_take_the_plain_routes():
    jcfg = JGPTConfig(n_layer=4, n_head=2, n_embd=64, block_size=64)
    _, model = _carried(jcfg, key=7)
    tok = torch.from_numpy(_tokens(jcfg, 4, seed=7))
    np.testing.assert_array_equal(make_forward(model)(tok).numpy(), model(tok).numpy())
    w = stack_weights(model)
    # the e2e route (all 4 layers fit one JAX call)
    np.testing.assert_array_equal(fused_logits(w, tok).numpy(),
                                  fused_logits_reference(w, tok).numpy())
    # the chunked route's result does not depend on the chunk size
    chunked = chunked_logits(w, tok, 2)
    np.testing.assert_array_equal(chunked.numpy(), chunked_logits(w, tok, 4).numpy())
    np.testing.assert_array_equal(chunked.numpy(),
                                  chunked_logits(w, tok, 1, blocks_reference).numpy())
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_logits(w, tok.to("meta"))


def test_batch_rollout_6m_fp32_matches_jax():
    b, a, steps = 2, 8, 16
    insts = [sample_instance(random_grid(12, 0.3, s + 20), a, seed=s + 20) for s in range(b)]
    grids = np.stack([i.grid for i in insts])
    starts = np.stack([i.starts for i in insts])
    goals = np.stack([i.goals for i in insts])
    active = np.ones((b, a), bool)
    h, w = grids.shape[1:]
    jcfg = dataclasses.replace(JCONFIGS["6M"], dtype=jnp.float32)
    cfg = dataclasses.replace(CONFIGS["6M"], dtype=torch.float32)
    params = _init_params(jcfg, jax.random.PRNGKey(8))
    model = load_model(cfg, params_to_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                                 cfg), device="cpu")

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
