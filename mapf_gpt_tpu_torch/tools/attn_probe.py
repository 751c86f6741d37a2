"""What bounds the wgmma attention's softmax on the card: micro-benchmarks
and the kernel's own instruction count; and whether the kernel's
registers would hold the head dims it does not take.

    python3 -m mapf_gpt_tpu_torch.tools.attn_probe [--regs]

Builds two probe kernels (written out below, compiled with ``nvcc`` into
``csrc/build/``) and prints, on the card:

- the special-function unit's ``ex2`` rate in the softmax's pattern (V
  values a thread in registers, y = ex2(fma(x, c, -m)), s += y, looped so
  that the code stays in the instruction cache), with one and two warps a
  sub-partition;
- the tile's softmax alone (max, fma + ex2, sum, normalise, pack to bf16
  on 128 values a thread), looped, against the 1,024 clocks its 128 ex2s a
  thread take at 16 a clock an SM;
- the issue rate of straight-line code against its size: a loop whose body
  is N independent max/multiply steps, the body's SASS size taken from
  ``cuobjdump``, with one and two warps a sub-partition;
- the rate of single instructions the softmax is made of (``ex2``, the
  bf16 pack ``cvt.rn.bf16x2.f32``, ``max``, ``mul``, ``fma``) at four warps
  a sub-partition;
- the SASS size of ``csrc/attn_wgmma.cuh``'s kernels in
  ``libattention`` and ``libfused_blocks`` (instructions, and the ``ex2``
  among them), which a tile runs once each, and the opcode mix of the
  attention's at head dims 32 and 64;
- (alone with ``--regs``) ptxas's registers and spills of the training
  attention's kernels in ``csrc/fused_train.cu`` (the wgmma forward
  through TrainIo, ``csrc/attn_wgmma_bwd.cuh``'s two backward kernels and
  the mma.sync ones) at each head width; and of
  ``csrc/attn_wgmma.cuh``'s kernel compiled at head dims 64 (as the
  library builds it) and 80, 96, 112 and 128, both arithmetics, bf16.
  Those four are instantiated for this count only, with stand-in
  geometries: rows of 2 D bytes unswizzled, one stage, P V as
  m64nDk16 from registers.  They are not working kernels (their shared
  memory layout is not one TMA and wgmma agree on), but the consumer's
  registers are the tile's: 128 scores, 64 words of P and D / 2 of O a
  thread, under the same 240 of ``setmaxnreg``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import re
import subprocess
from pathlib import Path

import torch

from mapf_gpt_tpu_torch.ops import _build

PROBE_SRC = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
template <int V>
__global__ void soft(float* out, long long* clk, int iters, float c) {
  float x[V];
  for (int i = 0; i < V; ++i) x[i] = out[(threadIdx.x + i) % 64] * 0.01f;
  float s[4] = {0, 0, 0, 0};
  const float m = out[70];
  const long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      x[i] = ex2(fmaf(x[i], c, -m));
      s[i % 4] += x[i];
    }
  }
  const long long c1 = clock64();
  float t = s[0] + s[1] + s[2] + s[3];
  for (int i = 0; i < V; ++i) t += x[i];
  out[100 + blockIdx.x * blockDim.x + threadIdx.x] = t;
  if (threadIdx.x == 0 && blockIdx.x == 0) clk[0] = c1 - c0;
}
template <int N>
__global__ void straight(float* out, long long* clk, int iters) {
  float x[16];
  for (int i = 0; i < 16; ++i) x[i] = threadIdx.x * 0.001f + i;
  const float y = out[0];
  const long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i % 16] = fmaxf(x[i % 16] * 0.999f, y);
  }
  const long long c1 = clock64();
  float s = 0;
  for (int i = 0; i < 16; ++i) s += x[i];
  out[1 + blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) clk[0] = c1 - c0;
}
// the tile's softmax on 128 values a thread, as csrc/attn_wgmma.cuh runs it
// (16-way max, fma + ex2, 16-way sum, normalise, pack to bf16), looped
__global__ void softmax(float* out, long long* clk, int iters, float c2) {
  float x[128];
  unsigned pk[64];
  for (int i = 0; i < 128; ++i) x[i] = out[(threadIdx.x + i) % 64];
  const long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
    float mx[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) mx[i] = x[i];
#pragma unroll
    for (int i = 16; i < 128; ++i) mx[i % 16] = fmaxf(mx[i % 16], x[i]);
#pragma unroll
    for (int i = 8; i > 0; i >>= 1)
      for (int k = 0; k < i; ++k) mx[k] = fmaxf(mx[k], mx[k + i]);
    float m = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2)) * c2;
    float rs[16] = {};
#pragma unroll
    for (int i = 0; i < 128; ++i) {
      x[i] = ex2(fmaf(x[i], c2, -m));
      rs[i % 16] += x[i];
    }
#pragma unroll
    for (int i = 8; i > 0; i >>= 1)
      for (int k = 0; k < i; ++k) rs[k] += rs[k + i];
    float l = rs[0] + __shfl_xor_sync(0xffffffffu, rs[0], 1);
    const float inv = 1.f / (l + __shfl_xor_sync(0xffffffffu, l, 2));
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float a = x[2 * i] * inv, b = x[2 * i + 1] * inv;
      asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(pk[i]) : "f"(b), "f"(a));
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {   // the next pass's scores from this one's P
      x[2 * i] = __uint_as_float(pk[i] << 16);
      x[2 * i + 1] = __uint_as_float(pk[i] & 0xffff0000u);
    }
  }
  const long long c1 = clock64();
  float t = 0;
  for (int i = 0; i < 128; ++i) t += x[i];
  out[100 + blockIdx.x * blockDim.x + threadIdx.x] = t;
  if (threadIdx.x == 0 && blockIdx.x == 0) clk[0] = c1 - c0;
}
extern "C" int probe_softmax(float* out, long long* clk, int threads, int iters) {
  softmax<<<132, threads>>>(out, clk, iters, 0.18f);
  return (int)cudaGetLastError();
}
// one instruction's rate: 16 independent chains a thread of op OP (0 ex2, 1
// cvt.rn.bf16x2.f32, 2 fmax, 3 fmul, 4 fma), looped
template <int OP>
__global__ void rate(float* out, long long* clk, int iters) {
  float x[16];
  for (int i = 0; i < 16; ++i) x[i] = out[(threadIdx.x + i) % 64] * 0.01f;
  const float y = out[65], z = out[66];
  const long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (OP == 0) {
        x[i] = ex2(x[i]);
      } else if (OP == 1) {
        unsigned u;
        asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(x[i]), "f"(y));
        x[i] = __uint_as_float(u);
      } else if (OP == 2) {
        x[i] = fmaxf(x[i], y);
      } else if (OP == 3) {
        x[i] = x[i] * y;
      } else {
        x[i] = fmaf(x[i], y, z);
      }
    }
  }
  const long long c1 = clock64();
  float t = 0;
  for (int i = 0; i < 16; ++i) t += x[i];
  out[100 + blockIdx.x * blockDim.x + threadIdx.x] = t;
  if (threadIdx.x == 0 && blockIdx.x == 0) clk[0] = c1 - c0;
}
extern "C" int probe_rate(int op, float* out, long long* clk, int iters) {
  switch (op) {
    case 0: rate<0><<<132, 512>>>(out, clk, iters); break;
    case 1: rate<1><<<132, 512>>>(out, clk, iters); break;
    case 2: rate<2><<<132, 512>>>(out, clk, iters); break;
    case 3: rate<3><<<132, 512>>>(out, clk, iters); break;
    case 4: rate<4><<<132, 512>>>(out, clk, iters); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
#define SIZES(X) X(128) X(256) X(384) X(512) X(768) X(1024) X(1536)
extern "C" int probe_soft(float* out, long long* clk, int threads, int iters) {
  soft<128><<<132, threads>>>(out, clk, iters, 0.5f);
  return (int)cudaGetLastError();
}
extern "C" int probe_straight(int n, float* out, long long* clk, int threads, int iters) {
  switch (n) {
#define CASE(N) case N: straight<N><<<132, threads>>>(out, clk, iters); break;
    SIZES(CASE)
    default: return -1;
  }
  return (int)cudaGetLastError();
}
"""
SIZES = (128, 256, 384, 512, 768, 1024, 1536)
RATES = ("ex2.approx.ftz.f32", "cvt.rn.bf16x2.f32", "max.f32", "mul.f32", "fma.rn.f32")
WIDE_HEADS = (80, 96, 112, 128)


def wide_source() -> str:
    """csrc/attn_wgmma.cuh with stand-in geometries and P V products for
    WIDE_HEADS, and its kernel instantiated at 64 and at each of those,
    both arithmetics (see the module's docstring)."""
    parts = ['#include "attn_wgmma.cuh"', "namespace aw {"]
    for d in WIDE_HEADS:
        n = d // 2   # O's fp32 accumulators a thread
        outs = ", ".join(f"%{i}" for i in range(n))
        acc = ", ".join(f'"+f"(d[{i // 4}][{i % 4}])' for i in range(n))
        parts.append(f"""template <> struct Geo<{d}> {{
  static constexpr int RB = {2 * d}, BOX = {d}, TILE = T_MAX * RB, STAGE = 3 * TILE, STAGES = 1;
  static constexpr int OUT = ROWS * RB;
  static constexpr bool TURNS = true;
  static constexpr int SMEM = STAGE + 2 * OUT + 3 * 8 + 1024;
  static constexpr unsigned SW = 0;
  static constexpr uint64_t LAYOUT = 0;
  static constexpr CUtensorMapSwizzle MAP_SWIZZLE = CU_TENSOR_MAP_SWIZZLE_NONE;
}};
template <> __device__ __forceinline__ void Elem<bf16>::rs<{d}>(float (*d)[4], const unsigned a[4],
                                                               uint64_t b) {{
  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n + 5}, 0;\\n"
               "wgmma.mma_async.sync.aligned.m64n{d}k16.f32.bf16.bf16 {{{outs}}}, "
               "{{%{n}, %{n + 1}, %{n + 2}, %{n + 3}}}, %{n + 4}, p, 1, 1, 1;\\n}}\\n"
               : {acc}
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}}""")
    parts.append("}  // namespace aw")
    parts.append('extern "C" int probe_wide_regs(int d, int blocks, int* regs, int* local) {')
    parts.append("  cudaFuncAttributes a;")
    parts.append("  cudaError_t e = cudaErrorInvalidValue;")
    for d in (64,) + WIDE_HEADS:
        parts.append(f"  if (d == {d})")
        parts.append(f"    e = blocks ? cudaFuncGetAttributes(&a, aw::attn_wgmma_kernel<{d}, "
                     "aw::bf16, true, aw::BlocksIo>)")
        parts.append(f"           : cudaFuncGetAttributes(&a, aw::attn_wgmma_kernel<{d}, "
                     "aw::bf16, false, aw::AttnIo>);")
    parts.append("  if (e == cudaSuccess) {")
    parts.append("    *regs = a.numRegs;")
    parts.append("    *local = (int)a.localSizeBytes;")
    parts.append("  }")
    parts.append("  return (int)e;")
    parts.append("}")
    return "\n".join(parts)


def build_probe() -> Path:
    """The probe library, built once per source into csrc/build/."""
    digest = hashlib.sha256(PROBE_SRC.encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / f"libattn_probe-{digest}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = _build.BUILD_DIR / f"attn_probe-{digest}.cu"
        src.write_text(PROBE_SRC)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True, text=True)
    return out


def sass_sizes(lib: Path) -> dict[str, tuple[int, int]]:
    """(instructions, MUFU.EX2 among them) of each function in a library."""
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    sizes = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        body = fn.split("\n", 1)[1]
        sizes[fn.split("\n")[0].strip()] = (len(re.findall(r"/\*[0-9a-f]{4}\*/", body)),
                                            body.count("MUFU.EX2"))
    return sizes


def opcode_mix(lib: Path) -> dict[str, collections.Counter]:
    """Each function's SASS opcodes (the mnemonic before the first '.'), counted."""
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    mixes = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)", fn)
        mixes[fn.split("\n")[0].strip()] = collections.Counter(ops)
    return mixes


def wide_registers() -> None:
    """Compile wide_source() (ptxas -v) and print each kernel's registers and
    spills as ptxas reports them, and the registers and local memory the
    runtime reports."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = wide_source()
    digest = hashlib.sha256(src.encode()).hexdigest()[:16]
    cu = _build.BUILD_DIR / f"attn_wide-{digest}.cu"
    out = _build.BUILD_DIR / f"libattn_wide-{digest}.so"
    cu.write_text(src)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                           str(out), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.probe_wide_regs.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    for entry in re.split(r"Compiling entry function '", proc.stdout + proc.stderr)[1:]:
        name = entry.split("'")[0]
        if "attn_wgmma_kernel" not in name:
            continue
        d, blocks = int(re.search(r"ILi(\d+)E", name)[1]), int(re.search(r"Lb([01])E", name)[1])
        spills = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                           r"spill loads", entry)
        used = re.search(r"Used (\d+) registers", entry)
        regs, local = ctypes.c_int(), ctypes.c_int()
        rc = lib.probe_wide_regs(d, blocks, ctypes.byref(regs), ctypes.byref(local))
        print(f"[probe] wgmma attention kernel at D={d}, "
              f"{'the layer stack' if blocks else 'attention'}'s arithmetic, bf16: ptxas "
              f"{used[1]} registers, {spills[1]} bytes stack frame, {spills[2]} bytes spill "
              f"stores, {spills[3]} bytes spill loads; runtime (rc {rc}): {regs.value} "
              f"registers, {local.value} bytes local memory a thread", flush=True)


TRAIN_KERNELS = ("attn_wgmma_kernel", "attn_bwd_q_wgmma", "attn_bwd_kv_wgmma",
                 "attn_bwd_q_kernel", "attn_bwd_kv_kernel")


def train_registers() -> None:
    """Compile csrc/fused_train.cu as ops/_build.py does (ptxas -v) and
    print the registers and spills of its attention kernels: the wgmma
    forward through TrainIo, attn_bwd_q_wgmma and attn_bwd_kv_wgmma
    (csrc/attn_wgmma_bwd.cuh) and the mma.sync backward, at each head
    width.  ptxas reports a warp-specialised kernel's registers at launch
    (168 under 384 threads a block); the spills are those of its regions
    under the counts setmaxnreg sets (the consumers' and the producer's)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "libfused_train-regs.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(_build.CSRC / "fused_train.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on fused_train.cu:\n{proc.stdout}{proc.stderr}")
    for entry in re.split(r"Compiling entry function '", proc.stdout + proc.stderr)[1:]:
        name = entry.split("'")[0]
        kernel = next((k for k in TRAIN_KERNELS if k in name), None)
        if kernel is None:
            continue
        d = int(re.search(r"ILi(\d+)E", name)[1])
        spills = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                           r"spill loads", entry)
        used = re.search(r"Used (\d+) registers", entry)
        print(f"[probe] fused_train {kernel} D={d}: ptxas {used[1]} registers, {spills[1]} "
              f"bytes stack frame, {spills[2]} bytes spill stores, {spills[3]} bytes spill "
              f"loads", flush=True)
    out.unlink(missing_ok=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--regs", action="store_true",
                        help="only the registers and spills of the kernel at D = 64 and 80-128, "
                             "and of the training attention's kernels")
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[probe] {smi}")
    if args.regs:
        wide_registers()
        train_registers()
        return
    dev = torch.device("cuda", 0)
    path = build_probe()
    lib = ctypes.CDLL(str(path))
    lib.probe_soft.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.probe_softmax.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.probe_straight.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int]
    out = torch.rand(132 * 1024 + 200, device=dev)
    clk = torch.zeros(1, dtype=torch.int64, device=dev)
    for threads in (128, 256):
        lib.probe_soft(out.data_ptr(), clk.data_ptr(), threads, 200)
        torch.cuda.synchronize()
        print(f"[probe] ex2 in the softmax's pattern, {threads // 128} warp(s) a sub-partition: "
              f"{threads * 200 * 128 / clk.item():.2f} ex2 a clock an SM")
    sizes = sass_sizes(path)
    soft_n = next(v for k, v in sizes.items() if k.startswith("_Z7softmax"))
    for threads in (128, 256):
        lib.probe_softmax(out.data_ptr(), clk.data_ptr(), threads, 200)
        torch.cuda.synchronize()
        print(f"[probe] the tile's softmax on 128 values a thread, looped, {threads // 128} "
              f"warp(s) a sub-partition: {clk.item() / 200:.0f} clocks a pass a warp "
              f"(the kernel has {soft_n[0]} instructions, {soft_n[1]} MUFU.EX2; 128 ex2 a "
              f"thread take {1024 * threads // 128} clocks at 16 a clock an SM)")
    base = next(v[0] for k, v in sizes.items() if "straightILi128E" in k)
    for n in SIZES:
        body = next(v[0] for k, v in sizes.items() if f"straightILi{n}E" in k) - base + 2 * 128
        for threads in (128, 256):
            iters = max(8, 40000 // n)
            lib.probe_straight(n, out.data_ptr(), clk.data_ptr(), threads, iters)
            torch.cuda.synchronize()
            print(f"[probe] straight-line body of {body} instructions ({body * 16 / 1024:.1f} KB), "
                  f"{threads // 128} warp(s) a sub-partition: "
                  f"{clk.item() / (iters * body):.2f} clocks an instruction a warp")
    lib.probe_rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    for op, name in enumerate(RATES):
        lib.probe_rate(op, out.data_ptr(), clk.data_ptr(), 100)
        torch.cuda.synchronize()
        print(f"[probe] {name} at 4 warps a sub-partition, 16 chains a thread: "
              f"{512 * 16 * 100 / clk.item():.1f} a clock an SM")
    for name in ("attention", "fused_blocks"):
        lib_path = _build.build(name)
        for fn, (n, ex2) in sorted(sass_sizes(lib_path).items()):
            if "attn_wgmma_kernel" in fn:
                print(f"[probe] {name} {fn[:72]}: {n} instructions ({n * 16 / 1024:.1f} KB), "
                      f"{ex2} MUFU.EX2")
        for fn, mix in sorted(opcode_mix(lib_path).items()):
            if "attn_wgmma_kernel" in fn and ("Li32E13" in fn or "Li64E13" in fn):
                print(f"[probe] {name} {fn[:72]} opcodes: " +
                      ", ".join(f"{op} {n}" for op, n in mix.most_common(16)))


if __name__ == "__main__":
    main()
