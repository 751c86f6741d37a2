// wgmma.mma_async (Hopper, sm_90a) for bf16 operands and fp32 accumulators:
// one warpgroup (4 warps) computes a 64 x N tile, k = 16 a call.
//   ss<N>(d, a, b): A and B from shared memory, N = 128.
// a and b are matrix descriptors (make_desc) of no-swizzle core-matrix
// layouts: A K-major, B MN-major (the product reads B transposed, so a
// [k][n] row-major weight goes in as it is).  d holds the accumulator as n8
// tiles, d[j][0..3] = (row g, columns 8j + 2c and + 1), (row g + 8, the
// same) of the warp's 16 rows, g = lane / 4, c = lane % 4: the C layout of
// mma.m16n8k16, so epilogues and C-to-A repacking read it unchanged.  A call
// adds A B to d and only issues the product: fence() before (after the
// registers it reads were written), commit() and wait<n>() after, and
// fence_operands() around, which keeps the compiler off the accumulators
// while the product runs.

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
__device__ void ss(float (*d)[4], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void ss<128>(float (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(1));
}

}  // namespace wg
