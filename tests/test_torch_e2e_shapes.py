"""The e2e route at the shapes the e2e kernel (``csrc/fused_gpt.cu``) takes
beyond the 2M's and 6M's: T below 256 (200 and 1), head dims 16 and 64,
and 12 heads, at small widths.

- ``fused_logits_reference`` (the plain version the kernel is held
  against on the card) against JAX ``fused_logits`` in interpret mode, on
  weights carried across by ``models/convert.py`` and tokens from numpy:
  logits within 0.02 * max|ref| + 0.02 with >= 95 % argmax agreement over
  the 5 action logits (the fused tolerance of ``tests/test_fused_gpt.py``);
- ``cuda_plan`` sends each of these shapes to the e2e kernel and names its
  -D defines, without building anything.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.models.gpt import init_params as jinit_params
from mapf_gpt_tpu.ops.fused_gpt import fused_logits as jax_fused_logits
from mapf_gpt_tpu_torch.models.convert import load_model, params_to_state_dict
from mapf_gpt_tpu_torch.models.gpt import GPTConfig
from mapf_gpt_tpu_torch.ops import _build, fused_gpt

_init = jax.jit(jinit_params, static_argnums=0)

# (n_embd, heads, layers, T): T = 200 and T = 1 at the 2M's width, head dim
# 16 with 12 heads, head dim 64, T = 200 with head dim 16
SHAPES = [(160, 5, 2, 200), (160, 5, 3, 1), (192, 12, 2, 256), (128, 2, 3, 256),
          (192, 3, 2, 130), (160, 10, 2, 200)]


def _carried(jcfg, key):
    params = _init(jcfg, jax.random.PRNGKey(key))
    cfg = GPTConfig(block_size=jcfg.block_size, vocab_size=jcfg.vocab_size,
                    n_layer=jcfg.n_layer, n_head=jcfg.n_head, n_embd=jcfg.n_embd)
    sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return params, load_model(cfg, sd, device="cpu")


@pytest.mark.parametrize("e,h,layers,t", SHAPES)
def test_e2e_reference_matches_jax_at_new_shapes(e, h, layers, t):
    jcfg = JGPTConfig(n_layer=layers, n_head=h, n_embd=e, block_size=256)
    params, model = _carried(jcfg, key=e + h + t)
    # 32 contexts: at init the action logits are close together, so one
    # near-tie flipped by bf16 rounding is 1/32 of the argmax agreement
    tok = np.random.RandomState(e + h + t).randint(0, jcfg.vocab_size, size=(32, t))
    ref = np.asarray(jax_fused_logits(params, jnp.asarray(tok), jcfg, interpret=True,
                                      ctx_per_program=8))
    with torch.no_grad():
        got = fused_gpt.fused_logits_reference(fused_gpt.stack_weights(model),
                                               torch.from_numpy(tok)).numpy()
    assert got.shape == ref.shape == (32, jcfg.vocab_size) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.02 * np.abs(ref).max() + 0.02)
    assert (got[:, :5].argmax(-1) == ref[:, :5].argmax(-1)).mean() >= 0.95


@pytest.mark.parametrize("e,h,layers,t", SHAPES)
def test_cuda_plan_sends_new_shapes_to_the_e2e_kernel(monkeypatch, e, h, layers, t):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    assert fused_gpt.cuda_plan(e, h, layers, t) == ("e2e", "fused_gpt")
    want = {} if (e, h) == (160, 5) else {"FUSED_GPT_E": e, "FUSED_GPT_H": h}
    assert fused_gpt.e2e_defines(e, h) == want


# The shapes the e2e kernel admitted before its Hopper rebuild, restated here
# on their own (T from 1 to 256, head dims multiples of 16 from 16 to 128,
# n_embd up to 256), and the outcome of cuda_plan over a grid of n_embd
# 16-272, 1-32 heads, T from 1 to 300 and 1, 5 or 8 layers, counted and
# digested as it stood then: the rebuilt kernel admits and refuses exactly
# the same shapes.
T_GRID = (1, 2, 63, 64, 65, 128, 129, 200, 255, 256, 257, 300)
PLAN_GRID = [(e, h, t, layers) for e in range(16, 273, 8) for h in range(1, 33)
             for t in T_GRID for layers in (1, 5, 8)]
PLAN_COUNTS = {"no:raise": 28656, "no:e2e/fused_blocks": 8100, "ok:e2e/fused_gpt": 1260}
PLAN_DIGEST = "569341644cf125584cadfb571c3bec4ec6e7e9f83f13364783d4e7c809424df3"


def _admitted_before(e, h, t):
    dh = e // h if h > 0 else 0
    return (1 <= t <= 256 and h > 0 and e % h == 0 and dh % 16 == 0 and 16 <= dh <= 128
            and e <= 256)


def _plan(e, h, t, layers):
    why = fused_gpt.e2e_unfit(e, h, t)
    try:
        plan = "/".join(fused_gpt.cuda_plan(e, h, layers, t))
    except ValueError:
        plan = "raise"
    return f"{e},{h},{t},{layers}:{'ok' if why is None else 'no'}:{plan}"


@pytest.mark.parametrize("t", T_GRID)
def test_e2e_kernel_admits_exactly_the_earlier_shapes(monkeypatch, t):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    for e in range(16, 273, 8):
        for h in range(1, 33):
            admitted = _admitted_before(e, h, t)
            assert (fused_gpt.e2e_unfit(e, h, t) is None) == admitted, (e, h, t)
            for layers in (1, 5, 8):
                if admitted:
                    assert fused_gpt.cuda_plan(e, h, layers, t) == ("e2e", "fused_gpt")
                else:
                    assert not _plan(e, h, t, layers).endswith("fused_gpt")


def test_cuda_plan_table_is_unchanged(monkeypatch):
    import collections
    import hashlib

    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    out = [_plan(*shape) for shape in PLAN_GRID]
    assert collections.Counter(o.split(":", 1)[1] for o in out) == PLAN_COUNTS
    assert hashlib.sha256("\n".join(out).encode()).hexdigest() == PLAN_DIGEST
