"""The kernel build (``ops/_build.py``) without a CUDA toolkit: nvcc is
looked for and its absence raises; the library is keyed by a hash of the
source and of the headers it includes from ``csrc/`` (so a header change
cannot load a stale library), built once, and a failed build raises with
the compiler's output.
A stand-in ``nvcc`` script plays the compiler."""

import os
import stat

import pytest

from mapf_gpt_tpu_torch.ops import _build


def _fake_nvcc(directory, body):
    path = directory / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return directory


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('extern "C" int k() { return 0; }\n')
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", src / "build")
    return src


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_is_keyed_by_source(csrc):
    first = _build.library_path("k")
    assert first.parent == csrc / "build" and first.name.startswith("libk-")
    assert _build.library_path("k") == first
    (csrc / "k.cu").write_text('extern "C" int k() { return 1; }\n')
    assert _build.library_path("k") != first


def test_library_is_keyed_by_included_headers(csrc):
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n#include "t.cuh"\n'
                               'extern "C" int k() { return T; }\n')
    (csrc / "t.cuh").write_text('#pragma once\n  #  include "u.cuh"\n#define T U\n')
    (csrc / "u.cuh").write_text('#define U 1\n')
    (csrc / "other.cuh").write_text('#define V 1\n')
    assert [p.name for p in _build.source_files("k")] == ["k.cu", "t.cuh", "u.cuh"]
    first = _build.library_path("k")
    (csrc / "other.cuh").write_text('#define V 2\n')   # not included: same library
    assert _build.library_path("k") == first
    (csrc / "u.cuh").write_text('#define U 2\n')       # included through t.cuh
    assert _build.library_path("k") != first


def test_kernel_sources_name_the_shared_attention_header():
    """attention.cu, fused_train.cu, fused_gpt.cu and fused_blocks.cu share
    csrc/attn_tile.cuh; all four also share csrc/attn_wgmma.cuh, which
    reaches csrc/wgmma.cuh through csrc/gemm_tile.cuh, as the layer kernels
    do (fused_gpt.cu includes attn_wgmma.cuh alone: its attention tile, TMA
    and mbarrier helpers and tensor-map encoding come through it);
    fused_train.cu includes the training attention's backward,
    csrc/attn_wgmma_bwd.cuh, and the backward's MLP front and LayerNorm
    epilogue, csrc/train_bwd_gemm.cuh; each library's key follows the
    headers its source includes."""
    for name in ("attention", "fused_blocks"):
        assert [p.name for p in _build.source_files(name)] == [
            f"{name}.cu", "attn_tile.cuh", "attn_wgmma.cuh", "gemm_tile.cuh", "wgmma.cuh"]
    assert [p.name for p in _build.source_files("fused_gpt")] == [
        "fused_gpt.cu", "attn_wgmma.cuh", "attn_tile.cuh", "gemm_tile.cuh", "wgmma.cuh"]
    assert [p.name for p in _build.source_files("fused_train")] == [
        "fused_train.cu", "attn_tile.cuh", "attn_wgmma.cuh", "attn_wgmma_bwd.cuh",
        "gemm_tile.cuh", "train_bwd_gemm.cuh", "wgmma.cuh"]


def test_e2e_kernel_is_warp_specialised_on_tma_and_wgmma():
    """csrc/fused_gpt.cu (the counterpart of _e2e_kernel) loads its weight
    tiles by TMA (cp.async.bulk.tensor) from a producer thread, moves
    registers to its consumers with setmaxnreg, runs its products on
    wgmma.mma_async (the MLP's fc2 with register A) and its attention on
    attn_wgmma.cuh's tile, and uses no WMMA, library or CUTLASS kernel."""
    src = (_build.CSRC / "fused_gpt.cu").read_text()
    unit = "".join(p.read_text() for p in _build.source_files("fused_gpt"))
    for ptx in ("cp.async.bulk.tensor", "setmaxnreg", "wgmma.mma_async", "mbarrier.try_wait"):
        assert ptx in unit, ptx
    for call in ("gemm::tma_load(", "gemm::setmaxnreg_dec<", "gemm::setmaxnreg_inc<",
                 "wg::Mma<NP>", "wg::Mma<FC>", "wg::MmaRs<NP>", "aw::tile<DH, bf16, true>",
                 "gemm::make_map("):
        assert call in src, call
    for banned in ("wmma::", "<mma.h>", "cublas", "cuBLAS", "cutlass::", "mma_half(",
                   "pipeline<"):
        assert banned not in src, banned


def test_layer_kernels_share_the_hopper_gemm():
    """fused_blocks.cu and fused_train.cu run every product through
    csrc/gemm_tile.cuh (TMA into shared memory, wgmma.mma_async), with no
    WMMA GEMM of their own and no library GEMM."""
    tile = (_build.CSRC / "gemm_tile.cuh").read_text()
    assert "cp.async.bulk.tensor" in tile and "setmaxnreg" in tile
    assert "wgmma.mma_async" in (_build.CSRC / "wgmma.cuh").read_text()
    for name in ("fused_blocks", "fused_train"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "gemm_tile.cuh"' in src and "gemm::run<" in src
        for banned in ("wmma::", "<mma.h>", "cublas_v2.h", "cublasGemm", "cublasLt", "cutlass::"):
            assert banned not in src, (name, banned)


def test_build_once_then_reuse(csrc, tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    # the stand-in compiler writes the file named after -o and counts its runs
    bindir = _fake_nvcc(tmp_path, f'echo run >> {calls}\nwhile [ "$1" != "-o" ]; do shift; done\n'
                                  'echo lib > "$2"\n')
    monkeypatch.setenv("PATH", str(bindir))
    out = _build.build("k")
    assert out.exists() and out == _build.library_path("k")
    assert _build.build("k") == out
    assert calls.read_text().count("run") == 1
    assert not [p for p in os.listdir(out.parent) if p.endswith(".tmp")]


def test_failed_build_raises_with_compiler_output(csrc, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(_fake_nvcc(tmp_path, 'echo "k.cu(1): error: bad" >&2\nexit 2\n')))
    with pytest.raises(RuntimeError, match=r"(?s)nvcc failed \(2\).*k\.cu\(1\): error: bad"):
        _build.build("k")
    assert not _build.library_path("k").exists()


def test_kernel_phase_variants_find_each_phase_once():
    """tools/kernel_phases.py builds the real kernel source with each
    phase's FUSED_GPT_SKIP bit in turn; every phase's bit must be declared
    once, tested by the code, and distinct."""
    from mapf_gpt_tpu_torch.tools import kernel_phases

    src = (_build.CSRC / "fused_gpt.cu").read_text()
    bits = kernel_phases.skip_bits(src)
    assert sorted(bits.values()) == [1, 2, 4, 8, 16, 32]
    variants = kernel_phases.variant_defines(src)
    assert variants["full"] == {} and len(variants) == len(kernel_phases.PHASES) + 2
    assert sorted(d["FUSED_GPT_SKIP"] for n, d in variants.items() if n != "full") == \
        sorted(bits.values())
    with pytest.raises(RuntimeError, match="not declared once and tested"):
        kernel_phases.skip_bits(src.replace("SKIP & SKIP_MLP", "SKIP_MLP"))
    with pytest.raises(RuntimeError, match="not declared once and tested"):
        kernel_phases.skip_bits(src.replace("SKIP_QKV = 1", "SKIP_QKV_ = 1"))


def test_kernel_clock_instruments_every_phase():
    """tools/kernel_clock.py instruments a copy of the real kernel source:
    every anchor is found as often as it expects, each phase counter is
    placed, and a missing anchor raises before nvcc starts."""
    from mapf_gpt_tpu_torch.tools import kernel_clock

    src = (_build.CSRC / "fused_gpt.cu").read_text()
    out = kernel_clock.instrumented(src)
    for k in range(kernel_clock.WHOLE):
        if k != 8:
            assert f"CLOCK_PHASE({k});" in out, k
    assert out.count("CLOCK_PHASE(8);") == 2
    for k in range(kernel_clock.WHOLE, len(kernel_clock.PHASES)):
        assert f"CLOCK_SPAN({k}, s0);" in out, k
    assert "fused_gpt_clock" in out and len(kernel_clock.PHASES) <= 16
    with pytest.raises(RuntimeError, match="kernel_clock: .* found 0 times"):
        kernel_clock.instrumented(src.replace("mlp_half(xh(hf), sA, g2 + l * E, active, ring);",
                                              "mlp_half(xh(hf), sA, g2 + l * E, active,ring);"))


def test_attention_tile_is_on_tma_setmaxnreg_and_wgmma():
    """csrc/attn_wgmma.cuh (the attention forward of attention.cu,
    fused_blocks.cu, fused_train.cu and the e2e kernel) loads by TMA
    (cp.async.bulk.tensor) from a producer thread, moves registers with
    setmaxnreg, runs S and P V on wgmma.mma_async, and uses no WMMA, library
    or CUTLASS kernel; every tile goes through its one softmax (softmax_pv),
    whose P V goes out in two groups and whose turns pass once a warp."""
    src = (_build.CSRC / "attn_wgmma.cuh").read_text()
    for ptx in ("cp.async.bulk.tensor", "wgmma.mma_async", "mbarrier.arrive"):
        assert ptx in src, ptx
    for call in ("gemm::setmaxnreg_dec<PRODUCER_REGS>()", "gemm::setmaxnreg_inc<CONSUMER_REGS>()",
                 "softmax_pv<D, T_, BLOCKS>(", "issue_pv<D, T_>(o, sc, vs, k0, k0 + NS / 2)",
                 "pass_ticket<false>(ticket)", "pass_ticket<true>(ticket)"):
        assert call in src, call
    assert src.count("softmax_pv<D, T_, BLOCKS>(") == 2   # the kernel's tiles and tile()'s
    for banned in ("wmma::", "<mma.h>", "cublas", "cuBLAS", "cutlass::"):
        assert banned not in src, banned


def test_attn_clock_marks_every_phase():
    """tools/attn_clock.py reads csrc/attn_wgmma.cuh's clock counters by the
    header's ClockPhase order; every phase is marked in the header, and the
    marks compile to nothing unless AW_CLOCK is defined."""
    import re

    from mapf_gpt_tpu_torch.tools import attn_clock

    src = (_build.CSRC / "attn_wgmma.cuh").read_text()
    phases = re.search(r"enum ClockPhase \{([^}]*)\}", src)[1].replace(" ", "").split(",")
    assert phases[-1].strip() == "CLK_PHASES"
    phases = [p.strip() for p in phases[:-1]]
    assert len(phases) == len(attn_clock.PHASES)
    for p in phases:
        assert f"AW_MARK({p});" in src, p
    assert re.search(r"#else\s*\n#define AW_CLOCK_START do \{\} while \(0\)\s*\n"
                     r"#define AW_MARK\(k\) do \{\} while \(0\)", src)
    assert 'extern "C" int aw_clock_read(' in src
