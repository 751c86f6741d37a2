"""The port's ``GPT`` with ``dropout > 0`` against the flax module, on the CPU:

- at dropout 0.1, fp32, the module route (``deterministic=True``, the
  default on both sides): the logits, the cross-entropy loss and every
  parameter's gradient equal the JAX module's within atol 1e-5 (the same
  arithmetic, summed in another order); ``train_step.loss_fn`` and
  ``select_loss_fn`` take that route, so the trainer's loss has no dropout;
- at ``deterministic=False``: each of the four dropout sites zeroes a share
  near p (within 5 standard deviations of a binomial over the elements) and
  scales the kept values by 1 / (1 - p) exactly in fp32; two runs from one
  generator seed are equal, another seed differs; no generator raises;
- ``attn_impl="pallas"`` with dropout: deterministic, the CPU kernel
  wrapper's plain version; not deterministic, the probabilities dropped on
  the plain attention, as the flax module's einsum path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.models.gpt import GPT as JGPT
from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.models.gpt import init_params as jinit_params
from mapf_gpt_tpu.train import train_step as jts
from mapf_gpt_tpu_torch.models import gpt as tgpt
from mapf_gpt_tpu_torch.models.convert import grads_to_params, load_model, params_to_state_dict
from mapf_gpt_tpu_torch.models.gpt import GPT, GPTConfig
from mapf_gpt_tpu_torch.ops import attention as tatt
from mapf_gpt_tpu_torch.train import train_step as ts

P = 0.1
JCFG = JGPTConfig(n_layer=2, n_head=2, n_embd=64, block_size=64, dropout=P, dtype=jnp.float32)
CFG = GPTConfig(n_layer=2, n_head=2, n_embd=64, block_size=64, dropout=P, dtype=torch.float32)
ATOL = 1e-5


@pytest.fixture(scope="module")
def carried():
    params = jax.jit(jinit_params, static_argnums=0)(JCFG, jax.random.PRNGKey(0))
    model = load_model(CFG, params_to_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                                 CFG), device="cpu")
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 67, size=(6, 64)).astype(np.int32)
    targets = rng.randint(0, 5, size=(6,)).astype(np.int32)
    return params, model, tokens, targets


def test_dropout_config_builds_and_routes_to_the_module():
    model = GPT(CFG)
    assert model.cfg.dropout == P
    assert not tgpt.uses_fused(CFG, "cuda") and not tgpt.uses_fused(CFG, "cpu")
    assert tgpt.uses_fused(dataclasses.replace(CFG, dropout=0.0), "cuda")


@pytest.mark.parametrize("last_only", [True, False])
def test_deterministic_logits_match_flax(carried, last_only):
    params, model, tokens, _ = carried
    want = np.asarray(JGPT(JCFG).apply(params, jnp.asarray(tokens), last_only=last_only))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), last_only=last_only).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_loss_and_grads_match_flax(carried):
    params, model, tokens, targets = carried
    model = model.train().requires_grad_()
    try:
        want_loss, want_grads = jax.value_and_grad(
            lambda p: jts.loss_fn(JCFG, p, jnp.asarray(tokens), jnp.asarray(targets)))(params)
        model.zero_grad(set_to_none=True)
        loss = ts.select_loss_fn(model)(torch.from_numpy(tokens), torch.from_numpy(targets))
        loss.backward()
        assert abs(loss.item() - float(want_loss)) < ATOL
        got = dict(jax.tree_util.tree_leaves_with_path(grads_to_params(model)))
        for k, w in jax.tree_util.tree_leaves_with_path(want_grads):
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w), rtol=0, atol=ATOL,
                                       err_msg=jax.tree_util.keystr(k))
    finally:
        model.eval().requires_grad_(False)


def test_trainer_loss_is_deterministic(carried):
    _, model, tokens, targets = carried
    x, y = torch.from_numpy(tokens), torch.from_numpy(targets)
    with torch.no_grad():
        a, b = ts.loss_fn(model, x, y), ts.loss_fn(model, x, y)
        ref = torch.nn.functional.cross_entropy(model(x, deterministic=True), y.long())
    assert a.item() == b.item() == ref.item()


def _recording_dropout(monkeypatch):
    """Record (input, output) of every dropout call."""
    calls = []
    inner = tgpt.dropout

    def record(x, p, generator):
        y = inner(x, p, generator)
        calls.append((x.detach().clone(), y.detach().clone()))
        return y

    monkeypatch.setattr(tgpt, "dropout", record)
    return calls


def test_dropout_sites_share_and_scale(carried, monkeypatch):
    _, model, tokens, _ = carried
    calls = _recording_dropout(monkeypatch)
    with torch.no_grad():
        model(torch.from_numpy(tokens), deterministic=False,
              generator=torch.Generator().manual_seed(5))
    # the embedding, then per layer: probabilities, attention output, MLP output
    assert len(calls) == 1 + 3 * CFG.n_layer
    shapes = [tuple(x.shape) for x, _ in calls]
    assert shapes[0] == (6, 64, 64) and shapes[1] == (6, 2, 64, 64)
    for x, y in calls:
        nz = x != 0
        dropped = (y == 0) & nz
        n = int(nz.sum())
        share = dropped.sum().item() / n
        assert abs(share - P) < 5 * np.sqrt(P * (1 - P) / n), (share, n)
        kept = ~dropped & nz
        torch.testing.assert_close(y[kept], x[kept] / (1 - P), rtol=0, atol=0)


def test_dropout_reproducible_from_the_generator(carried):
    _, model, tokens, _ = carried
    x = torch.from_numpy(tokens)
    with torch.no_grad():
        run = lambda seed: model(x, deterministic=False,
                                 generator=torch.Generator().manual_seed(seed))
        a, b, c = run(3), run(3), run(4)
        det = model(x)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, det)
    with pytest.raises(ValueError, match="Generator"):
        model(x, deterministic=False)


def test_pallas_config_with_dropout(carried, monkeypatch):
    """attn_impl="pallas": the kernel's wrapper runs deterministic (its plain
    version on the CPU); with dropout the probabilities go through the
    plain attention, as the flax module's einsum path."""
    _, model, tokens, _ = carried
    cfg = dataclasses.replace(CFG, attn_impl="pallas")
    pallas = load_model(cfg, model.state_dict(), device="cpu")
    x = torch.from_numpy(tokens)
    tatt.launches = 0
    with torch.no_grad():
        torch.testing.assert_close(pallas(x), model(x), rtol=0, atol=ATOL)
        calls = _recording_dropout(monkeypatch)
        gen = lambda: torch.Generator().manual_seed(9)
        a = pallas(x, deterministic=False, generator=gen())
        b = model(x, deterministic=False, generator=gen())
    assert len(calls) == 2 * (1 + 3 * CFG.n_layer)
    torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
    assert tatt.launches == 0   # CPU tensors never launch
