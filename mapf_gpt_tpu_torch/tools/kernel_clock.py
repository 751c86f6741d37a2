"""Where the fused kernel's time goes, by the SM clock: an instrumented copy.

    python3 -m mapf_gpt_tpu_torch.tools.kernel_clock [--model 6M] [--n 8192] [--seed 0]

Builds a copy of ``csrc/fused_gpt.cu`` in which thread 0 of each consumer
warpgroup reads ``clock64()`` at the boundaries of the phases of its
context loop and adds each phase's cycles to a counter in device memory
(``atomicAdd``), and times the waits inside them (ring tiles, attention
stages), the q|k|v epilogue and the LN2 rows separately.  Runs the trained
``--model`` (2M or 6M) on ``--n`` random contexts once to warm up and once
counted, and prints each phase's share of a warpgroup's cycles and that
share of the counted run's time.  Unlike ``tools/kernel_phases.py``, which
compiles a phase out (and so changes the registers the compiler gives the
rest), the kernel runs whole; the counters add a few instructions at each
boundary.  The copy is built into ``csrc/build/clock/``; its logits are the
kernel's.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from unittest import mock

import numpy as np
import torch

from mapf_gpt_tpu_torch.models.convert import load_model, load_reference_checkpoint
from mapf_gpt_tpu_torch.ops import _build, fused_gpt
from mapf_gpt_tpu_torch.tools.kernel_phases import CHECKPOINTS

# counter -> phase; the phases 0-8 add up to a warpgroup's time, the rest are
# parts of them
PHASES = ("embedding", "half swaps", "LN1", "q|k|v", "thin last position", "attention",
          "projection", "MLP (with LN2)", "barriers", "(q|k|v epilogue)", "(ring waits)",
          "(attention stage waits)", "(LN2)")
WHOLE = 9   # counters 0 .. WHOLE - 1 partition the time

COUNTERS = r'''
__device__ unsigned long long g_clock[16];
#define CLOCK_PHASE(k) do { if ((threadIdx.x & 127) == 0) { const long long n_ = clock64(); \
  atomicAdd(&g_clock[k], (unsigned long long)(n_ - t_)); t_ = n_; } } while (0)
#define CLOCK_SPAN(k, s0) do { if ((threadIdx.x & 127) == 0) \
  atomicAdd(&g_clock[k], (unsigned long long)(clock64() - (s0))); } while (0)
'''

READOUT = r'''
extern "C" int fused_gpt_clock(unsigned long long* out, int reset) {
  cudaMemcpyFromSymbol(out, g_clock, sizeof(g_clock));
  if (reset) {
    unsigned long long z[16] = {};
    cudaMemcpyToSymbol(g_clock, z, sizeof(z));
  }
  return (int)cudaDeviceSynchronize();
}
'''

# (text in csrc/fused_gpt.cu, code put before it, code put after it, times it occurs)
START = "      const long long s0 = clock64();\n"
EDITS = (
    ("#ifndef FUSED_GPT_SKIP", COUNTERS, "", 1),
    ("      gemm::mbar_wait(B::full(i % STAGES), (i / STAGES) & 1);\n", START,
     "      CLOCK_SPAN(10, s0);\n", 1),
    ("      gemm::mbar_wait(B::att_full(s), (a / ATT_STAGES) & 1);\n", START,
     "      CLOCK_SPAN(11, s0);\n", 1),
    ("      const int c0 = n_off + nt * E;\n", START, "", 1),
    ("          st32(o + 8 * E3 + 8 * j, acc[j][2], acc[j][3]);\n        }\n      }\n",
     "", "      CLOCK_SPAN(9, s0);\n", 1),
    ("    if (RUN && active) ln_rows(xh + warp * 16 * LDX, sA, warp * 16, g2);\n", START,
     "    CLOCK_SPAN(12, s0);\n", 1),
    ("    int a = 0, item = 0;   // attention stages and query tiles so far\n", "",
     "    long long t_ = clock64();\n", 1),
    ("      embed(tokens + (size_t)c * T, wte, wpe, sX, park, T, halves, vocab);\n      cbar();\n",
     "", "      CLOCK_PHASE(0);\n", 1),
    ("            swap_halves(sX, park, pk);\n            res = hf;\n", "",
     "            CLOCK_PHASE(1);\n", 2),
    ("          qkv_half(maps, sA, qkv", "          CLOCK_PHASE(2);\n", "", 1),
    ("                   last ? 2 : 3, active, ring);\n", "", "          CLOCK_PHASE(3);\n", 1),
    ("          if (threadIdx.x == 0) gemm::mbar_arrive(B::ctx_done());\n", "",
     "          CLOCK_PHASE(4);\n", 1),
    ("          gemm::mbar_arrive(B::ws_ready());\n        }\n        cbar();\n", "",
     "        CLOCK_PHASE(8);\n", 1),
    ("          attention_sync(qkv, T, reinterpret_cast<bf16*>(smem));\n", "",
     "        CLOCK_PHASE(5);\n", 1),
    ("        if (threadIdx.x == 0) gemm::mbar_arrive(B::att_done());\n", "",
     "        CLOCK_PHASE(8);\n", 1),
    ("          proj_half(xh(hf), sA, qkv + (size_t)hf * HALF * E3, wg_active, active, ring);\n",
     "", "          CLOCK_PHASE(6);\n", 1),
    ("          mlp_half(xh(hf), sA, g2 + l * E, active, ring);\n", "",
     "          CLOCK_PHASE(7);\n", 1),
)


def instrumented(src: str) -> str:
    """The kernel source with the clock counters; raises if an anchor is
    not found the expected number of times."""
    for old, before, after, count in EDITS:
        if src.count(old) != count:
            raise RuntimeError(f"kernel_clock: {old.splitlines()[0]!r} found {src.count(old)} "
                               f"times in fused_gpt.cu, expected {count}")
        src = src.replace(old, before + old + after)
    return src + READOUT


def build() -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "clock"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "fused_gpt_clock.cu"
    cu.write_text(instrumented((_build.CSRC / "fused_gpt.cu").read_text()))
    so = out_dir / "libfused_gpt_clock.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the instrumented copy:\n{proc.stderr}")
    lib = fused_gpt.bind(ctypes.CDLL(str(so)))
    lib.fused_gpt_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fused_gpt_clock.restype = ctypes.c_int
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=sorted(CHECKPOINTS), default="6M")
    ap.add_argument("--n", type=int, default=8192, help="contexts per forward")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_clock: needs a CUDA GPU")
    lib = build()
    cfg, sd = load_reference_checkpoint(CHECKPOINTS[args.model])
    w = fused_gpt.stack_weights(load_model(cfg, sd, device="cuda"))
    tokens = torch.from_numpy(np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, size=(args.n, cfg.block_size))).to("cuda", torch.int32)
    counts = (ctypes.c_ulonglong * 16)()
    with mock.patch.object(fused_gpt, "_library", lambda *_: lib):
        fused_gpt.fused_logits(w, tokens)
        lib.fused_gpt_clock(counts, 1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fused_gpt.fused_logits(w, tokens)
        end.record()
        torch.cuda.synchronize()
        lib.fused_gpt_clock(counts, 1)
    ms = start.elapsed_time(end)
    vals = list(counts)
    whole = sum(vals[:WHOLE])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"{smi} | {args.model} N={args.n} | instrumented kernel {ms:.3f} ms")
    for k, name in enumerate(PHASES):
        print(f"  {name:26s} {100 * vals[k] / whole:6.2f} %  {ms * vals[k] / whole:8.3f} ms")


if __name__ == "__main__":
    main()
