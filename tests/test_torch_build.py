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
    csrc/attn_tile.cuh; attention.cu and fused_blocks.cu also share
    csrc/attn_wgmma.cuh, which reaches csrc/wgmma.cuh through
    csrc/gemm_tile.cuh, as the layer kernels do; fused_gpt.cu includes
    csrc/wgmma.cuh; each library's key follows the headers its source
    includes."""
    for name in ("attention", "fused_blocks"):
        assert [p.name for p in _build.source_files(name)] == [
            f"{name}.cu", "attn_tile.cuh", "attn_wgmma.cuh", "gemm_tile.cuh", "wgmma.cuh"]
    assert [p.name for p in _build.source_files("fused_gpt")] == [
        "fused_gpt.cu", "attn_tile.cuh", "wgmma.cuh"]
    assert [p.name for p in _build.source_files("fused_train")] == [
        "fused_train.cu", "attn_tile.cuh", "gemm_tile.cuh", "wgmma.cuh"]


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
    """tools/kernel_phases.py compiles each phase of the real kernel source
    out in turn; every phase must still be found exactly once."""
    from mapf_gpt_tpu_torch.tools import kernel_phases

    src = (_build.CSRC / "fused_gpt.cu").read_text()
    for phase in kernel_phases.PHASES:
        variant = kernel_phases.variant_source(src, phase)
        assert variant.count("#if 0\n") == 1 and len(variant) == len(src) + len("#if 0\n#endif\n")
    with pytest.raises(RuntimeError, match="not found once"):
        kernel_phases.variant_source(src.replace("ln_rows(xh(hf)", "ln_rows(xh( hf)"), "qkv")
    # the variant without weight-tile copies edits the ring's two loads
    assert kernel_phases.no_weight_loads(src).count("&& n < 0) load(") == 2
