"""The frozen counts against hand counts at a tiny shape: each product of the
policy's layers listed by its (rows, inner, columns)."""

import pytest

from perfbench import frozen

T, E, H, L, V = 4, 8, 2, 3, 11


def _products(last_only: bool) -> int:
    """2 m k n summed over every product of a forward on one context."""
    dh = E // H
    full = [(T, E, 3 * E)] + [(T, dh, T)] * H + [(T, T, dh)] * H + [(T, E, E), (T, E, 4 * E),
                                                                   (T, 4 * E, E)]
    last = ([(T, E, 2 * E), (1, E, E)] + [(1, dh, T)] * H + [(1, T, dh)] * H
            + [(1, E, E), (1, E, 4 * E), (1, 4 * E, E)])
    layers = [full] * (L - 1) + [last if last_only else full]
    return sum(2 * m * k * n for layer in layers for m, k, n in layer)


@pytest.mark.parametrize("last_only", [False, True])
def test_layer_ops_against_hand_count(last_only):
    ops, exps = frozen.layer_ops(T, E, H, L, last_only)
    assert ops == _products(last_only)
    assert exps == (L - 1) * H * T * T + (H * T if last_only else H * T * T)


def test_model_flops_are_forward_plus_head_and_a_backward_of_twice_that():
    cfg = {"block_size": T, "n_embd": E, "n_head": H, "n_layer": L, "vocab_size": V}
    assert frozen.forward_model_flops(cfg) == _products(True) + 2 * E * V
    assert frozen.train_model_flops(cfg) == 3 * frozen.forward_model_flops(cfg)


def test_train_ops_forward_and_backward_per_layer():
    fwd, _ = frozen.train_ops(T, E, H, 1, False, False)
    assert fwd == _products(False) // L            # one full layer
    bwd, exps = frozen.train_ops(T, E, H, 2, True, True)
    # recompute (q|k|v, attention, fc: 14TE^2 + 4T^2E) and dX, dW of every product
    assert bwd == 2 * (14 * T * E * E + 4 * T * T * E + 2 * (24 * T * E * E + 4 * T * T * E))
    assert exps == 2 * H * T * T


def test_bound_takes_the_larger_of_operations_and_bytes():
    ms, what = frozen.bound(frozen.PEAK_BF16, 0, 1.0)
    assert ms == pytest.approx(1e3) and what == "operations"
    ms, what = frozen.bound(0, 0, frozen.HBM_BYTES_PER_S * 2)
    assert ms == pytest.approx(2e3) and what == "bytes"
    ms, _ = frozen.bound(0, frozen.PEAK_FP32, 0)
    assert ms == pytest.approx(1e3)


def test_e2e_bound_at_the_6m_size_is_the_kernel_tables_figure():
    cfg = {"block_size": 256, "n_embd": 256, "n_head": 8, "n_layer": 8, "vocab_size": 67}
    assert frozen.e2e_bound(cfg, 8192)[0] == pytest.approx(28.26, abs=0.01)


@pytest.mark.parametrize("name,key", [
    ("void gemm::gemm_kernel<128, 2, gemm::Plain>(CUtensorMap, CUtensorMap, int)",
     "gemm::gemm_kernel"),
    ("void (anonymous namespace)::ln_kernel<768>(__nv_bfloat16 const*, long long)", "ln_kernel"),
    ("(anonymous namespace)::fused_gpt_kernel(Maps, int const*)", "fused_gpt_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >(int)",
     "at::native::vectorized_elementwise_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "HtoD"),
])
def test_kernel_key(name, key):
    assert frozen.kernel_key(name) == key
