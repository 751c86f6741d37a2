"""The inference kernels at the width a caller asks for, and out-of-vocabulary
ids, without a CUDA toolkit:

- ``fused_gpt.cuda_plan`` picks the JAX package's route and the kernel that
  runs it on CUDA for (160, 5), (256, 8), (768, 12), (192, 6), (384, 6),
  (512, 8), (320, 10), (160, 10), (256, 16) and (384, 4), computing the e2e
  kernel's chunk without building anything; a width neither kernel can
  hold (n_embd not a multiple of 32, a head dim not a multiple of 16, too
  many heads for the thin attention's shared memory) raises ``ValueError``
  naming the constraint, before ``nvcc`` would start;
- ``_build`` passes a caller's defines to ``nvcc`` and keys the library by
  them (a stand-in ``nvcc`` plays the compiler);
- the e2e route run as three steps (the plain bf16 embedding,
  ``blocks_reference`` over all layers with the last thinned, the plain
  head on the bf16-rounded wte) equals ``_e2e_reference`` exactly;
- out-of-vocabulary ids: the e2e route's plain version embeds an id outside
  [0, vocab) as wpe alone, as JAX ``_e2e_call`` does (interpret mode); the
  chunked route reads them as JAX indexing does (a negative id wraps once,
  then ids are clamped), held against JAX ``fused_logits`` on its chunked
  route.  Logits within 0.02 * max|ref| + 0.02 with >= 95 % argmax
  agreement (``tests/test_fused_gpt.py``).
"""

import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapf_gpt_tpu.models.gpt import GPTConfig as JGPTConfig
from mapf_gpt_tpu.models.gpt import init_params as jinit_params
from mapf_gpt_tpu.ops.fused_gpt import default_layers_per_call as jax_layers_per_call
from mapf_gpt_tpu.ops.fused_gpt import fused_logits as jax_fused_logits
from mapf_gpt_tpu_torch.models.convert import load_model, params_to_state_dict
from mapf_gpt_tpu_torch.models.gpt import GPTConfig
from mapf_gpt_tpu_torch.ops import _build, fused_blocks, fused_gpt
from mapf_gpt_tpu_torch.ops.fused_blocks import blocks_reference, ln_f32


@pytest.mark.parametrize("e,h,layers,route,kernel,defines", [
    (160, 5, 5, "e2e", "fused_gpt", {}),
    (256, 8, 8, "e2e", "fused_gpt", {}),
    (768, 12, 12, "chunked", "fused_blocks", {}),
    (192, 6, 4, "e2e", "fused_gpt",
     {"FUSED_GPT_E": 192, "FUSED_GPT_H": 6, "FUSED_GPT_CH": 128}),
    (384, 6, 8, "e2e", "fused_blocks", {"FUSED_BLOCKS_E": 384, "FUSED_BLOCKS_DH": 64}),
    (512, 8, 12, "chunked", "fused_blocks", {"FUSED_BLOCKS_E": 512, "FUSED_BLOCKS_DH": 64}),
    # n_embd not a multiple of 128, head dims 16 and 96: built since the layer-stack kernel
    # masks its N tiles and takes any head dim that is a multiple of 16 up to 128
    (320, 10, 4, "e2e", "fused_blocks", {"FUSED_BLOCKS_E": 320, "FUSED_BLOCKS_DH": 32}),
    (160, 10, 4, "e2e", "fused_blocks", {"FUSED_BLOCKS_E": 160, "FUSED_BLOCKS_DH": 16}),
    (256, 16, 4, "e2e", "fused_blocks", {"FUSED_BLOCKS_E": 256, "FUSED_BLOCKS_DH": 16}),
    (384, 4, 4, "e2e", "fused_blocks", {"FUSED_BLOCKS_E": 384, "FUSED_BLOCKS_DH": 96}),
    (160, 5, 90, "chunked", "fused_blocks", {"FUSED_BLOCKS_E": 160, "FUSED_BLOCKS_DH": 32}),
])
def test_cuda_plan_without_building(monkeypatch, e, h, layers, route, kernel, defines):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    jroute = "e2e" if jax_layers_per_call(JGPTConfig(n_layer=layers, n_head=h, n_embd=e)) \
        >= layers else "chunked"
    assert fused_gpt.cuda_plan(e, h, layers) == (route, kernel) and route == jroute
    got = fused_gpt.e2e_defines(e, h) if kernel == "fused_gpt" \
        else fused_blocks.kernel_defines(e, h)
    assert got == defines


def test_e2e_chunk_reproduces_the_published_builds():
    # the source's own instantiations: Fwd<160, 5, 128> and Fwd<256, 8, 64>
    assert fused_gpt.e2e_chunk(160, 5) == 128 and fused_gpt.e2e_chunk(256, 8) == 64
    src = (_build.CSRC / "fused_gpt.cu").read_text()
    assert "Fwd<160, 5, 128>" in src and "Fwd<256, 8, 64>" in src
    for e, h in ((384, 12), (320, 5), (160, 10), (256, 4)):   # 12 heads; head dim 64, 16, 64
        assert fused_gpt.e2e_chunk(e, h) is None


@pytest.mark.parametrize("e,h,match", [
    (144, 9, "multiple of 32"),                    # head dim 16, n_embd % 32 != 0
    (192, 24, "head dim must be a multiple of 16"),   # head dim 8
    (4096, 256, "thin attention"),                 # 256 heads' scores over 227 KB
    (250, 5, "head dim"),
])
def test_unsupported_width_raises_before_any_build(monkeypatch, e, h, match):
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built"))
    monkeypatch.setattr(_build, "find_nvcc", lambda: pytest.fail("looked for nvcc"))
    with pytest.raises(ValueError, match=match):
        fused_gpt.cuda_plan(e, h, 4)
    with pytest.raises(ValueError):
        fused_gpt.e2e_defines(e, h)


def test_blocks_width_checks():
    fused_blocks.check_width(256, 384, 6)
    fused_blocks.check_width(256, 1024, 32)
    fused_blocks.check_width(256, 1536, 48)   # 48 KB of scores: dynamic shared memory
    fused_blocks.check_width(256, 2048, 128)
    with pytest.raises(ValueError, match="T must be 256"):
        fused_blocks.check_width(128, 768, 12)
    with pytest.raises(ValueError, match="thin attention"):
        fused_blocks.check_width(256, 3584, 224)


def test_build_passes_defines_and_keys_the_library(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('extern "C" int k() { return K; }\n')
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", src / "build")
    args = tmp_path / "args"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> {args}\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo lib > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(tmp_path))
    plain = _build.build("k")
    wide = _build.build("k", {"K": 7, "A": 1})
    assert plain != wide and wide == _build.library_path("k", {"A": 1, "K": 7})
    assert _build.library_path("k", {"K": 8}) != wide
    assert _build.build("k", {"K": 7, "A": 1}) == wide   # cached, no second run
    lines = args.read_text().splitlines()
    assert len(lines) == 2
    assert "-D" not in lines[0] and "-DA=1 -DK=7" in lines[1]


def _model(e, h, layers, t=256, seed=0):
    cfg = GPTConfig(n_layer=layers, n_head=h, n_embd=e, block_size=t)
    from mapf_gpt_tpu_torch.models.gpt import init_params

    return load_model(cfg, init_params(cfg, torch.Generator().manual_seed(seed)), device="cpu")


def test_e2e_route_in_three_steps_equals_e2e_reference():
    """What the card runs for an e2e-route width the e2e kernel cannot hold
    (the layer-stack kernel in the middle) is the same function."""
    w = fused_gpt.stack_weights(_model(128, 4, 3, t=64))
    tok = torch.from_numpy(np.random.RandomState(0).randint(-3, 70, size=(6, 64)))
    calls = []

    def blocks(x, stacks, last_only):
        calls.append(last_only)
        return blocks_reference(x, stacks, last_only)

    with torch.no_grad():
        valid = (tok >= 0) & (tok < w.wte.shape[0])
        emb = torch.where(valid[..., None], w.wte[tok.clamp(0, w.wte.shape[0] - 1)].float(), 0.0)
        x = (emb + w.wpe[:64].float()).to(torch.bfloat16)
        x = blocks_reference(x, w.stacks(), True)
        three = ln_f32(x[:, -1].float(), w.gf) @ w.wht
        ref = fused_gpt._e2e_reference(w, tok)
        routed = fused_gpt._e2e_reference(w, tok, blocks)
    assert calls == [True]
    assert torch.equal(three, ref) and torch.equal(routed, ref)


def _carried(jcfg, key):
    params = jax.jit(jinit_params, static_argnums=0)(jcfg, jax.random.PRNGKey(key))
    cfg = GPTConfig(block_size=jcfg.block_size, vocab_size=jcfg.vocab_size,
                    n_layer=jcfg.n_layer, n_head=jcfg.n_head, n_embd=jcfg.n_embd)
    sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return params, load_model(cfg, sd, device="cpu")


def _oov_tokens(vocab, n, t, seed):
    tok = np.random.RandomState(seed).randint(0, vocab, size=(n, t))
    tok[:, -1] = -1                      # the position the head reads
    tok[0, :] = vocab                    # a whole context out of range
    tok[1, ::3] = -1
    tok[2, ::5] = vocab + 5
    tok[3, ::7] = -vocab - 2             # wraps once to -2, then clamps to 0
    return tok


def _assert_close(got, ref):
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.02 * np.abs(ref).max() + 0.02)
    assert (got[:, :5].argmax(-1) == ref[:, :5].argmax(-1)).mean() >= 0.95


def test_e2e_reference_embeds_oov_ids_as_the_jax_kernel():
    jcfg = JGPTConfig(n_layer=2, n_head=2, n_embd=64, block_size=64)
    params, model = _carried(jcfg, key=21)
    w = fused_gpt.stack_weights(model)
    tok = _oov_tokens(jcfg.vocab_size, 8, 64, seed=21)
    ref = np.asarray(jax_fused_logits(params, jnp.asarray(tok), jcfg, interpret=True,
                                      ctx_per_program=8))
    with torch.no_grad():
        got = fused_gpt.fused_logits_reference(w, torch.from_numpy(tok)).numpy()
        # the rule itself: an OOV id adds nothing to wpe
        only_wpe = fused_gpt._e2e_reference(w, torch.full((1, 64), -1))
        zero_wte = w._replace(wte=torch.zeros_like(w.wte))
        assert torch.equal(only_wpe, fused_gpt._e2e_reference(zero_wte, torch.zeros(1, 64,
                                                                                     dtype=int)))
    _assert_close(got, ref)


def test_chunked_route_reads_oov_ids_as_jax_indexing():
    jcfg = JGPTConfig(n_layer=2, n_head=2, n_embd=64, block_size=64)
    params, model = _carried(jcfg, key=22)
    w = fused_gpt.stack_weights(model)
    tok = _oov_tokens(jcfg.vocab_size, 8, 64, seed=22)
    ref = np.asarray(jax_fused_logits(params, jnp.asarray(tok), jcfg, interpret=True,
                                      layers_per_call=1, ctx_per_program=8))
    with torch.no_grad():
        got = fused_gpt.chunked_logits(w, torch.from_numpy(tok), 1).numpy()
    _assert_close(got, ref)
    ids = fused_gpt.jax_index(torch.tensor([-1, 67, 72, -69, -67, 0, 66]), 67)
    table = jnp.arange(67)[jnp.asarray([-1, 67, 72, -69, -67, 0, 66])]
    assert ids.tolist() == np.asarray(table).tolist() == [66, 66, 66, 0, 0, 0, 66]
