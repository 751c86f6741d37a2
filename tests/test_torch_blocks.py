"""The 85M's chunked route against the JAX package (numpy in between):

- ``blocks_reference`` (the plain version of the layer-stack CUDA kernel)
  against JAX ``_blocks_call(..., interpret=True)`` at the 85M's width
  (E=768, 12 heads, T=256) on 2 contexts, one or two layers, with and
  without ``last_only``: the bf16 stream within 0.02 * max|ref| + 0.02,
  the fused tolerance of ``tests/test_fused_gpt.py``;
- the chunked route's plain version (``chunked_logits`` over
  ``blocks_reference``) against JAX
  ``fused_logits(..., layers_per_call=2, interpret=True)`` at a small
  config (4 layers, E=64): logits within atol 0.02 * max|ref| + 0.02 and
  at least 95 % argmax agreement over the 5 action logits;
- ``models.gpt.init_params``, the port's counterpart of the JAX
  ``init_params``: the reference layout, normal(0.02), ``c_proj`` scaled by
  1/sqrt(2L), LayerNorm gains 1, drawn from the generator alone;
- the ``fused_blocks`` wrapper: CPU tensors take the plain version, other
  devices raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.models.gpt import init_params as jinit_params
from mapf_gpt_tpu.ops.fused_gpt import _blocks_call, stack_block_weights
from mapf_gpt_tpu.ops.fused_gpt import fused_logits as jax_fused_logits
from mapf_gpt_tpu_torch.models.convert import load_model, params_to_state_dict
from mapf_gpt_tpu_torch.models.gpt import CONFIGS, GPT, GPTConfig
from mapf_gpt_tpu_torch.models.gpt import init_params
from mapf_gpt_tpu_torch.ops.fused_blocks import LayerStacks, blocks_reference, fused_blocks
from mapf_gpt_tpu_torch.ops.fused_gpt import chunked_logits, stack_weights

_init_params = jax.jit(jinit_params, static_argnums=0)


def _carried(jcfg, key):
    """(JAX params, the port's model on the CPU with the same weights)."""
    params = _init_params(jcfg, jax.random.PRNGKey(key))
    cfg = GPTConfig(block_size=jcfg.block_size, vocab_size=jcfg.vocab_size,
                    n_layer=jcfg.n_layer, n_head=jcfg.n_head, n_embd=jcfg.n_embd)
    sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return params, load_model(cfg, sd, device="cpu")


@pytest.mark.parametrize("layers,last_only", [(1, False), (1, True), (2, False), (2, True)])
def test_blocks_reference_matches_jax_blocks_call_at_85m_width(layers, last_only):
    jcfg = JGPTConfig(n_layer=layers, n_head=12, n_embd=768)
    params, model = _carried(jcfg, key=10 + layers)
    # a residual stream of the embedding's scale, rounded to bf16 once
    x = (np.random.RandomState(layers).randn(2, 256, 768) * 0.05).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    ref = _blocks_call(xj, stack_block_weights(params, jcfg), jcfg, ctx=2,
                       last_only=last_only, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = blocks_reference(xt, stack_weights(model).stacks(), last_only)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert ref.shape == (2, 1 if last_only else 256, 768)
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, atol=0.02 * np.abs(ref).max() + 0.02)


def test_chunked_route_matches_jax_chunked_fused_logits():
    jcfg = JGPTConfig(n_layer=4, n_head=2, n_embd=64, block_size=64)
    params, model = _carried(jcfg, key=12)
    tok = np.random.RandomState(12).randint(0, jcfg.vocab_size, size=(16, 64))
    ref = np.asarray(jax_fused_logits(params, jnp.asarray(tok), jcfg, interpret=True,
                                      layers_per_call=2, ctx_per_program=8))
    got = chunked_logits(stack_weights(model), torch.from_numpy(tok), 2).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=0.02 * np.abs(ref).max() + 0.02)
    assert (got[:, :5].argmax(-1) == ref[:, :5].argmax(-1)).mean() >= 0.95


def test_init_params_follows_the_jax_scheme():
    cfg = CONFIGS["6M"]
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    assert sorted(sd) == sorted(GPT(cfg).state_dict())
    model = load_model(cfg, sd, device="cpu")   # strict=True
    assert model.lm_head.weight is model.transformer.wte.weight
    proj = [k for k in sd if k.endswith("c_proj.weight")]
    gains = [k for k in sd if k.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight"))]
    assert len(proj) == 2 * cfg.n_layer and len(gains) == 2 * cfg.n_layer + 1
    for k in gains:
        assert torch.equal(sd[k], torch.ones_like(sd[k])), k
    std = lambda keys: torch.cat([sd[k].flatten() for k in keys]).std().item()
    rest = [k for k in sd if k not in proj and k not in gains and k != "lm_head.weight"]
    assert abs(std(rest) / 0.02 - 1) < 0.01
    assert abs(std(proj) / (0.02 / np.sqrt(2 * cfg.n_layer)) - 1) < 0.01
    # the JAX package's weights have the same spread
    jparams = _init_params(JGPTConfig(n_layer=8, n_head=8, n_embd=256), jax.random.PRNGKey(0))
    jstd = np.asarray(jparams["params"]["h_0"]["attn"]["c_proj"]["kernel"]).std()
    assert abs(sd["transformer.h.0.attn.c_proj.weight"].std().item() / jstd - 1) < 0.05
    again = init_params(cfg, torch.Generator().manual_seed(0))
    other = init_params(cfg, torch.Generator().manual_seed(1))
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["transformer.wte.weight"], other["transformer.wte.weight"])


def test_fused_blocks_wrapper_takes_the_plain_version_on_cpu():
    jcfg = JGPTConfig(n_layer=2, n_head=2, n_embd=64, block_size=64)
    _, model = _carried(jcfg, key=13)
    stacks = stack_weights(model).stacks()
    x = torch.from_numpy(np.random.RandomState(13).randn(3, 64, 64).astype(np.float32)
                         * 0.05).to(torch.bfloat16)
    for last_only in (False, True):
        np.testing.assert_array_equal(fused_blocks(x, stacks, last_only).float().numpy(),
                                      blocks_reference(x, stacks, last_only).float().numpy())
    # a chunk of layers is the stack's slice; two chunks make the whole stack
    assert isinstance(stacks.chunk(0, 1), LayerStacks) and stacks.chunk(0, 1).wqkv.shape[0] == 1
    two = blocks_reference(blocks_reference(x, stacks.chunk(0, 1), False), stacks.chunk(1, 2),
                           True)
    np.testing.assert_array_equal(two.float().numpy(),
                                  blocks_reference(x, stacks, True).float().numpy())
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_blocks(x.to("meta"), stacks, True)
