// wgmma.mma_async (Hopper, sm_90a) for bf16 operands and fp32 accumulators:
// one warpgroup (4 warps) computes a 64 x N tile, k = 16 a call.
//   Mma<N>::run<TA, TB>(d, a, b, acc): A and B from shared memory, N = 64,
//     128, 192 or 256; TA = 1 reads A MN-major (transposed), TB = 0 reads B
//     K-major (transposed), the instruction's imm-trans-a and imm-trans-b;
//     acc = 0 overwrites d instead of adding to it.
//   MmaRs<N>::run<TB>(d, a, b, acc): A from registers (a[4], mma.m16n8k16's
//     A fragment of the warp's 16 rows), B from shared memory, N = 64, 128,
//     192 or 256.
//   ss<128>(d, a, b) = Mma<128>::run<0, 1>(d, a, b, 1): A K-major, B
//     MN-major (a [k][n] row-major weight goes in as it is), adding to d.
// a and b are matrix descriptors: make_desc for no-swizzle core-matrix
// layouts (csrc/fused_gpt.cu), make_desc_sw128 for the 128-byte-swizzled
// tiles TMA writes (csrc/gemm_tile.cuh).  d holds the accumulator as n8
// tiles, d[j][0..3] = (row g, columns 8j + 2c and + 1), (row g + 8, the
// same) of the warp's 16 rows, g = lane / 4, c = lane % 4: the C layout of
// mma.m16n8k16, so epilogues and C-to-A repacking read it unchanged.  A call
// only issues the product: fence() before (after the registers it reads
// were written), commit() and wait<n>() after, and fence_operands() around,
// which keeps the compiler off the accumulators while the product runs.

#pragma once

#include <stdint.h>

namespace wg {

// Descriptor of a core-matrix layout (8 rows x 16 bytes each, dense) at
// `smem`: lbo and sbo the byte strides between core matrices adjacent in the
// leading (K) and the strided (M or N) dimension.
__device__ __forceinline__ uint64_t make_desc(const void* smem, unsigned lbo, unsigned sbo) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Descriptor of a 128-byte-swizzled layout (layout type 1, bits 62-63):
// rows of 128 bytes in atoms of 8 rows (1024 bytes, 1024-byte aligned), as
// TMA writes a box whose inner dimension is 64 bf16 with
// CU_TENSOR_MAP_SWIZZLE_128B.  K-major: rows along M or N, sbo = 1024 the
// stride of 8-row groups, lbo unused; the k-th 16-deep slice starts 32 k
// bytes in.  MN-major: rows along K, sbo = 1024 the stride of 8-row (8-deep)
// groups, lbo the stride between 64-wide atoms along M or N; the k-th slice
// starts 2048 k bytes in.
__device__ __forceinline__ uint64_t make_desc_sw128(const void* smem, unsigned lbo,
                                                    unsigned sbo) {
  return make_desc(smem, lbo, sbo) | (1ull << 62);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// makes the CTA's generic-proxy shared-memory writes (stores, cp.async)
// visible to wgmma's async-proxy reads; before the barrier that publishes them
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int NT>
__device__ __forceinline__ void fence_operands(float (*d)[4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

template <int N>
struct Mma;

// The widths, written by macro: the accumulators of n8 tiles j .. j + 7
// (32 registers) as operands, and their names in the instruction.
#define WG_D4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define WG_D32(j) WG_D4(j), WG_D4(j + 1), WG_D4(j + 2), WG_D4(j + 3), WG_D4(j + 4), \
                  WG_D4(j + 5), WG_D4(j + 6), WG_D4(j + 7)
#define WG_N0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
              "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_N1 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
              "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "  \
              "%62, %63"
#define WG_N2 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, " \
              "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, "  \
              "%94, %95"
#define WG_N3 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "  \
              "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
              "%122, %123, %124, %125, %126, %127"
// OPS: the accumulators' operand list in parentheses
#define WG_LIST(...) __VA_ARGS__
// A and B from shared memory; IA the number of the first operand after the
// accumulators
#define WG_SS(N, NAMES, OPS, IA, IB, IP, ITA, ITB)                                        \
  template <>                                                                             \
  struct Mma<N> {                                                                         \
    template <int TA, int TB>                                                             \
    static __device__ __forceinline__ void run(float (*d)[4], uint64_t a, uint64_t b,     \
                                               int acc) {                                 \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                       \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" NAMES      \
                   "}, %" IA ", %" IB ", p, 1, 1, %" ITA ", %" ITB ";\n}\n"                \
                   : WG_LIST OPS                                                          \
                   : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));                         \
    }                                                                                     \
  };
// A from registers (four, named IA), B from shared memory
#define WG_RS(N, NAMES, OPS, IA, IB, IP, ITB)                                             \
  template <>                                                                             \
  struct MmaRs<N> {                                                                       \
    template <int TB>                                                                     \
    static __device__ __forceinline__ void run(float (*d)[4], const unsigned a[4],        \
                                               uint64_t b, int acc) {                     \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                       \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" NAMES      \
                   "}, {" IA "}, %" IB ", p, 1, 1, %" ITB ";\n}\n"                          \
                   : WG_LIST OPS                                                          \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),        \
                     "n"(TB));                                                            \
    }                                                                                     \
  };

WG_SS(64, WG_N0, (WG_D32(0)), "32", "33", "34", "35", "36")
WG_SS(128, WG_N0 ", " WG_N1, (WG_D32(0), WG_D32(8)), "64", "65", "66", "67", "68")
WG_SS(192, WG_N0 ", " WG_N1 ", " WG_N2, (WG_D32(0), WG_D32(8), WG_D32(16)), "96", "97", "98",
      "99", "100")
WG_SS(256, WG_N0 ", " WG_N1 ", " WG_N2 ", " WG_N3,
      (WG_D32(0), WG_D32(8), WG_D32(16), WG_D32(24)), "128", "129", "130", "131", "132")

template <int N>
struct MmaRs;

WG_RS(64, WG_N0, (WG_D32(0)), "%32, %33, %34, %35", "36", "37", "38")
WG_RS(128, WG_N0 ", " WG_N1, (WG_D32(0), WG_D32(8)), "%64, %65, %66, %67", "68", "69", "70")
WG_RS(192, WG_N0 ", " WG_N1 ", " WG_N2, (WG_D32(0), WG_D32(8), WG_D32(16)),
      "%96, %97, %98, %99", "100", "101", "102")
WG_RS(256, WG_N0 ", " WG_N1 ", " WG_N2 ", " WG_N3,
      (WG_D32(0), WG_D32(8), WG_D32(16), WG_D32(24)), "%128, %129, %130, %131", "132", "133",
      "134")

#undef WG_D4
#undef WG_D32
#undef WG_N0
#undef WG_N1
#undef WG_N2
#undef WG_N3
#undef WG_SS
#undef WG_RS
#undef WG_LIST

template <int N>
__device__ __forceinline__ void ss(float (*d)[4], uint64_t a, uint64_t b) {
  Mma<N>::template run<0, 1>(d, a, b, 1);
}

}  // namespace wg
