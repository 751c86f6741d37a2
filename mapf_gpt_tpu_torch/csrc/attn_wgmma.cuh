// The attention forward for Hopper (sm_90a) on wgmma, TMA and warp
// specialisation, shared by csrc/attention.cu (the counterpart of
// mapf_gpt_tpu/ops/attention.py::_attn_kernel) and csrc/fused_blocks.cu
// (the attention of mapf_gpt_tpu/ops/fused_gpt.py::_block_kernel):
// non-causal, T <= 256 keys, head dims 16, 32, 48 and 64, bf16 or fp16.
//
// Two arithmetics, one template flag (BLOCKS), each that of its TPU kernel:
//   attention (BLOCKS = false), for each (batch, head) pair:
//     x = s * scale * log2(e),  p = T(2^(x - max x) / sum 2^(x - max x)),
//     o = T(p v)                     (s and p v summed in fp32, T = bf16 or fp16)
//   the layer stack's (BLOCKS = true), the scale and log2(e) folded into W_q:
//     e = bf16(exp2(min(s, 100))),  att = bf16((e v) * (1 / sum e))
//
// Bound: bytes at the models' head dims (8 n T D bytes against 4 n T^2 D
// FLOP), and the exp2s close behind: one a score on the special-function
// unit, 16 a clock on an SM, so n T^2 = 2.7 G at [8192, 5, 256, 32] take
// about 0.64 ms against the bytes' 0.80 ms.  What the design does for that:
//   * persistent: one CTA an SM walks (batch, head) pairs with a stride of
//     the grid, so the loads of the next pairs run under this one's work;
//   * one producer thread keeps Q, K and V of the next pairs in flight by
//     TMA, into a ring of STAGES pair-sized stages (2 at D >= 48, 4 below)
//     with a "full" and an "empty" mbarrier each; K and V of a pair come
//     from device memory once; every box is 256 rows, TMA zero-filling the
//     rows past T (and, at D = 48, the columns past 48 of a 64-wide box);
//   * two consumer warpgroups take the pair's 64-row query tiles in turn
//     (tile i of the CTA's sequence to warpgroup i % 2).  A tile: S = Q K^T
//     by wgmma with both operands in shared memory, m64n256, so the scores
//     of all 256 key slots stay in registers (128 fp32 a thread); the
//     softmax on those accumulators; P rounded in registers and fed back as
//     wgmma's register A operand for P V (m64nDk16, V the B operand read
//     N-major from the tile TMA wrote); O rounded in registers, written
//     over the warp's Q rows of the tile in shared memory (free once S is
//     done) and stored by TMA, which clips the rows past T;
//   * at D >= 48 the two warpgroups' softmaxes take turns (a "ticket"
//     mbarrier: tile i's exp2s start when tile i - 1's are done), so one
//     warpgroup's exp2s run while the other's products and epilogue do;
//   * setmaxnreg moves registers from the producer warpgroup (24) to the
//     consumers (240): scores 128, P 64, O up to 32 a thread.
// On the card the tile runs well below the special-function units' rate
// for its exp2s; PERF.md (PR 13) has what was measured and ruled out.
// Shared-memory layout: rows of RB = 2 D bytes (128 at D = 48, whose box is
// 64 wide), swizzled by TMA at the span RB (128, 64 or 32 bytes), which the
// wgmma descriptors name: K-major for Q (A) and K (B), N-major for V (B).
//
// Limits (the callers route other shapes to csrc/attn_tile.cuh's kernels):
// T from 1 to 256; q, k, v and o with 16-byte aligned rows and strides
// (TMA); D in {16, 32, 48, 64}.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "gemm_tile.cuh"

namespace aw {

typedef __nv_bfloat16 bf16;

constexpr int ROWS = 64;                  // query rows of a tile: a warpgroup's wgmma M
constexpr int T_MAX = 256;                // keys whose scores the registers hold
constexpr int THREADS = 384;              // two consumer warpgroups + the producer's
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float EXP2_CLAMP = 100.f;
// error codes of the launchers besides CUDA's (attention_error_string)
constexpr int ERR_NO_ENCODER = 2001;      // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = 2002;      // the driver refused a tensor map

__host__ __device__ constexpr bool takes(int d) {
  return d == 16 || d == 32 || d == 48 || d == 64;
}

template <int D>
struct Geo {
  static_assert(takes(D), "head dims 16, 32, 48 and 64");
  static constexpr int RB = D == 48 ? 128 : 2 * D;   // bytes of a staged row = the swizzle span
  static constexpr int BOX = RB / 2;                  // a TMA box's columns; P V's N
  static constexpr int TILE = T_MAX * RB;             // Q, K or V of a pair
  static constexpr int STAGE = 3 * TILE;
  static constexpr int STAGES = RB == 128 ? 2 : 4;
  // the softmaxes take turns at D >= 48, where turns ran faster on the
  // card; at D <= 32 they ran slower
  static constexpr bool TICKET = D >= 48;
  static constexpr int SMEM = STAGES * STAGE + (2 * STAGES + 1) * 8 + 1024;
  static constexpr unsigned SW = RB / 16 - 1;         // swizzle: 16-byte chunk ^= (row bits)
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;   // descriptor bits 62-63
  static constexpr CUtensorMapSwizzle MAP_SWIZZLE =
      RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};
static_assert(Geo<64>::SMEM <= 232448 && Geo<32>::SMEM <= 232448, "a block's shared memory");

// A byte offset in a swizzled tile (from a 1024-aligned base) as TMA lays it
// out: the 16-byte chunk index XOR the row bits above 128 bytes.
template <int D>
__device__ __forceinline__ unsigned swz(unsigned off) {
  return off ^ (((off >> 7) & Geo<D>::SW) << 4);
}

// wgmma descriptors of the swizzled tiles: K-major (rows of RB bytes along M
// or N, 8-row groups RB * 8 apart; the k-th 16-deep slice 32 k bytes in),
// and N-major for V (rows along K, 8-deep groups RB * 8 apart; the k-th
// slice 16 RB k bytes in; N is one swizzle atom wide, so LBO is unused).
template <int D>
__device__ __forceinline__ uint64_t desc(const void* p) {
  return wg::make_desc(p, 16, 8 * Geo<D>::RB) | (Geo<D>::LAYOUT << 62);
}

#define AW_ACC4(C, d, j) C(d[j][0]), C(d[j][1]), C(d[j][2]), C(d[j][3])
#define AW_ACC8(C, d) AW_ACC4(C, d, 0), AW_ACC4(C, d, 1)
#define AW_ACC16(C, d) AW_ACC8(C, d), AW_ACC4(C, d, 2), AW_ACC4(C, d, 3)
#define AW_ACC32(C, d) AW_ACC16(C, d), AW_ACC4(C, d, 4), AW_ACC4(C, d, 5), AW_ACC4(C, d, 6), \
                       AW_ACC4(C, d, 7)
#define AW_ACC64(C, d) AW_ACC32(C, d), AW_ACC4(C, d, 8), AW_ACC4(C, d, 9), AW_ACC4(C, d, 10), \
                       AW_ACC4(C, d, 11), AW_ACC4(C, d, 12), AW_ACC4(C, d, 13), \
                       AW_ACC4(C, d, 14), AW_ACC4(C, d, 15)
#define AW_ACC128(C, d) AW_ACC64(C, d), AW_ACC4(C, d, 16), AW_ACC4(C, d, 17), \
                        AW_ACC4(C, d, 18), AW_ACC4(C, d, 19), AW_ACC4(C, d, 20), \
                        AW_ACC4(C, d, 21), AW_ACC4(C, d, 22), AW_ACC4(C, d, 23), \
                        AW_ACC4(C, d, 24), AW_ACC4(C, d, 25), AW_ACC4(C, d, 26), \
                        AW_ACC4(C, d, 27), AW_ACC4(C, d, 28), AW_ACC4(C, d, 29), \
                        AW_ACC4(C, d, 30), AW_ACC4(C, d, 31)
#define AW_R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define AW_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define AW_R32                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define AW_R128                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "  \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "  \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "    \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "  \
  "%123, %124, %125, %126, %127}"
// S (+)= A B^T, m64n256k16, A and B K-major in shared memory: C "=f" and
// ACC 0 overwrite S, C "+f" and ACC 1 add to it
#define AW_SS256(TY, C, ACC)                                                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                             \
               "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " AW_R128     \
               ", %128, %129, p, 1, 1, 0, 0;\n}\n"                                       \
               : AW_ACC128(C, d)                                                         \
               : "l"(a), "l"(b), "r"(ACC))
// d += A B, A (4 registers a thread) from registers, B N-major in shared memory
#define AW_RS(TY, N, RL, ACC, IA, IB, IS)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                           \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " " RL          \
               ", {%" IA "}, %" IB ", p, 1, 1, 1;\n}\n"                                   \
               : ACC("+f", d)                                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// The products and roundings of an element type.
template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&v);
  }
  template <bool ACC>
  static __device__ __forceinline__ void ss256(float (*d)[4], uint64_t a, uint64_t b) {
    if constexpr (ACC)
      AW_SS256("bf16", "+f", 1);
    else
      AW_SS256("bf16", "=f", 0);
  }
  template <int N>
  static __device__ __forceinline__ void rs(float (*d)[4], const unsigned a[4], uint64_t b) {
    if constexpr (N == 64)
      AW_RS("bf16", "64", AW_R32, AW_ACC32, "32, %33, %34, %35", "36", "37");
    else if constexpr (N == 32)
      AW_RS("bf16", "32", AW_R16, AW_ACC16, "16, %17, %18, %19", "20", "21");
    else
      AW_RS("bf16", "16", AW_R8, AW_ACC8, "8, %9, %10, %11", "12", "13");
  }
};

template <>
struct Elem<__half> {
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&v);
  }
  template <bool ACC>
  static __device__ __forceinline__ void ss256(float (*d)[4], uint64_t a, uint64_t b) {
    if constexpr (ACC)
      AW_SS256("f16", "+f", 1);
    else
      AW_SS256("f16", "=f", 0);
  }
  template <int N>
  static __device__ __forceinline__ void rs(float (*d)[4], const unsigned a[4], uint64_t b) {
    if constexpr (N == 64)
      AW_RS("f16", "64", AW_R32, AW_ACC32, "32, %33, %34, %35", "36", "37");
    else if constexpr (N == 32)
      AW_RS("f16", "32", AW_R16, AW_ACC16, "16, %17, %18, %19", "20", "21");
    else
      AW_RS("f16", "16", AW_R8, AW_ACC8, "8, %9, %10, %11", "12", "13");
  }
};

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(gemm::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(gemm::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 1 / the sum of each of the thread's two rows from its 16 partial sums
// rs[j % 4][e] (e >> 1 the row), the quad's four lanes added.
__device__ __forceinline__ void row_inverses(const float (*rs)[4], float inv[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int a = 2 * r, b = 2 * r + 1;
    inv[r] = 1.f / quad_sum(((rs[0][a] + rs[0][b]) + (rs[1][a] + rs[1][b])) +
                           ((rs[2][a] + rs[2][b]) + (rs[3][a] + rs[3][b])));
  }
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(gemm::smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// csrc/attention.cu's operands: q, k, v and o [B, H, T, D] through rank-4
// tensor maps (D, T, H, B) built from their own strides.
struct AttnIo {
  CUtensorMap q, k, v, o;
  int H;
  __device__ __forceinline__ void load(int pair, unsigned char* st, int tile, uint64_t* bar) const {
    const int b = pair / H, h = pair % H;
    tma_load_4d(st, &q, bar, 0, 0, h, b);
    tma_load_4d(st + tile, &k, bar, 0, 0, h, b);
    tma_load_4d(st + 2 * tile, &v, bar, 0, 0, h, b);
  }
  __device__ __forceinline__ void store(int pair, int row, const void* src) const {
    tma_store_4d(&o, src, 0, row, pair % H, pair / H);
  }
};

// csrc/fused_blocks.cu's operands: the q|k|v workspace [n, T, 3 EA] as [n,
// T, 3 H, DP] through one rank-4 map (DP, 3 H, T, n), head h's q, k and v
// at h, H + h and 2 H + h; att [n, T, EA] as (DP, H, T, n).
struct BlocksIo {
  CUtensorMap qkv, att;
  int H;
  __device__ __forceinline__ void load(int pair, unsigned char* st, int tile, uint64_t* bar) const {
    const int ctx = pair / H, h = pair % H;
    tma_load_4d(st, &qkv, bar, 0, h, 0, ctx);
    tma_load_4d(st + tile, &qkv, bar, 0, H + h, 0, ctx);
    tma_load_4d(st + 2 * tile, &qkv, bar, 0, 2 * H + h, 0, ctx);
  }
  __device__ __forceinline__ void store(int pair, int row, const void* src) const {
    tma_store_4d(&att, src, 0, pair % H, row, pair / H);
  }
};

// One 64-row query tile t of a pair whose Q, K and V are at qs, ks, vs: S,
// the softmax (after tile item - 1's, the ticket), P V, O out.  Every key
// slot of the 256 takes part in the products (TMA zero-fills the rows past
// T, and those keys are masked), so that no branch sits between two
// products: ptxas would fence each product of a branching sequence alone.
template <int D, typename T_, bool BLOCKS, class Io>
__device__ __forceinline__ void tile(const Io& io, int pair, int t, int item, int T, float c2,
                                     unsigned char* qs, const unsigned char* ks,
                                     const unsigned char* vs, uint64_t* ticket) {
  using G = Geo<D>;
  constexpr int NT = T_MAX / 8;   // n8 tiles of the scores
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = lane & 3;
  unsigned char* qt = qs + t * ROWS * G::RB;

  // S = Q K^T over all 256 key slots, the first k-slice overwriting
  float sc[NT][4];
  wg::fence();
  Elem<T_>::template ss256<false>(sc, desc<D>(qt), desc<D>(ks));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    Elem<T_>::template ss256<true>(sc, desc<D>(qt + 32 * kk), desc<D>(ks + 32 * kk));
  wg::commit();
  wg::wait<0>();
  wg::fence_operands<NT>(sc);

  if (Geo<D>::TICKET && item > 0) gemm::mbar_wait(ticket, (item - 1) & 1);
  // the softmax on the accumulators: (j, e) is key 8 j + 2 c4 + (e & 1) of
  // row g + 8 (e >> 1) of the warp's 16; keys at or past T masked
  unsigned pa[NT / 2][4];
  // the rows' max and sum, each over 16 accumulators [j % 4][e] so that
  // one warp's dependency chains do not set the pace
  float rs[4][4] = {}, inv[2];
  if constexpr (!BLOCKS) {
    // p = 2^(s c2 - m) / l with m = max(s c2), taken as max(s) |c2| over s
    // or -s by the sign of c2: one fma and one ex2 a score.  Masked keys
    // get an s that never wins the max, then p = 0.
    const bool pos = c2 >= 0.f;
    const float NEG_INF = __int_as_float(0xff800000), FAR = pos ? NEG_INF : -NEG_INF;
    if (T < T_MAX) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + 2 * c4 + (e & 1) >= T) sc[j][e] = FAR;
    }
    float mx[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[j][e] = pos ? sc[j][e] : -sc[j][e];
    if (pos) {
#pragma unroll
      for (int j = 4; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[j % 4][e] = fmaxf(mx[j % 4][e], sc[j][e]);
    } else {
#pragma unroll
      for (int j = 4; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[j % 4][e] = fmaxf(mx[j % 4][e], -sc[j][e]);
    }
    float mr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float(*m)[4] = mx;
      const int a = 2 * r, b = 2 * r + 1;
      mr[r] = quad_max(fmaxf(fmaxf(fmaxf(m[0][a], m[0][b]), fmaxf(m[1][a], m[1][b])),
                             fmaxf(fmaxf(m[2][a], m[2][b]), fmaxf(m[3][a], m[3][b])))) *
              fabsf(c2);
    }
    const float m0 = mr[0], m1 = mr[1];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = ex2(fmaf(sc[j][e], c2, -(e < 2 ? m0 : m1)));
    if (T < T_MAX) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + 2 * c4 + (e & 1) >= T) sc[j][e] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[j % 4][e] += sc[j][e];
    row_inverses(rs, inv);
    // P as the A fragments of 16 keys (n8 tiles 2 kk and 2 kk + 1), normalised, rounded
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const float* lo = sc[2 * kk];
      const float* hi = sc[2 * kk + 1];
      pa[kk][0] = Elem<T_>::pack(lo[0] * inv[0], lo[1] * inv[0]);
      pa[kk][1] = Elem<T_>::pack(lo[2] * inv[1], lo[3] * inv[1]);
      pa[kk][2] = Elem<T_>::pack(hi[0] * inv[0], hi[1] * inv[0]);
      pa[kk][3] = Elem<T_>::pack(hi[2] * inv[1], hi[3] * inv[1]);
    }
  } else {
    // e = bf16(2^min(s, 100)), rounded once by the packing; the sums add the rounded e
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = ex2(fminf(sc[j][e], EXP2_CLAMP));
    if (T < T_MAX) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + 2 * c4 + (e & 1) >= T) sc[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* f = sc[2 * kk + (i >> 1)] + 2 * (i & 1);
        const unsigned u = Elem<T_>::pack(f[0], f[1]);
        pa[kk][i] = u;
        rs[kk % 4][2 * (i & 1)] += __uint_as_float(u << 16);
        rs[kk % 4][2 * (i & 1) + 1] += __uint_as_float(u & 0xffff0000u);
      }
    row_inverses(rs, inv);
  }
  if (Geo<D>::TICKET && tid == 0) gemm::mbar_arrive(ticket);

  // O = P V over the 16 slices of 16 keys
  float o[G::BOX / 8][4];
#pragma unroll
  for (int n = 0; n < G::BOX / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk)
    Elem<T_>::template rs<G::BOX>(o, pa[kk], desc<D>(vs + kk * 16 * G::RB));
  wg::commit();
  wg::wait<0>();
  wg::fence_operands<G::BOX / 8>(o);

  // O rounded (the layer stack's scaled by 1 / sum e first) into the warp's
  // 16 Q rows of the tile (free once S is done) in TMA's swizzle, then one
  // bulk store of them, which clips rows past T and columns past D
  const float on0 = BLOCKS ? inv[0] : 1.f, on1 = BLOCKS ? inv[1] : 1.f;
#pragma unroll
  for (int n = 0; n < G::BOX / 8; ++n) {
    const unsigned off = (warp * 16 + g) * G::RB + n * 16 + c4 * 4;
    *reinterpret_cast<unsigned*>(qt + swz<D>(off)) =
        Elem<T_>::pack(o[n][0] * on0, o[n][1] * on0);
    *reinterpret_cast<unsigned*>(qt + swz<D>(off + 8 * G::RB)) =
        Elem<T_>::pack(o[n][2] * on1, o[n][3] * on1);
  }
  wg::fence_proxy();
  __syncwarp();
  if (lane == 0) {
    io.store(pair, t * ROWS + warp * 16, qt + warp * 16 * G::RB);
    gemm::bulk_commit();
  }
}

// The persistent kernel: `pairs` (batch or context, head) pairs of T keys;
// c2 = scale * log2(e) for the attention (unused by the layer stack's).
template <int D, typename T_, bool BLOCKS, class Io>
__global__ void __launch_bounds__(THREADS, 1)
attn_wgmma_kernel(const __grid_constant__ Io io, int pairs, int T, float c2) {
  using G = Geo<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::STAGES * G::STAGE);
  uint64_t* empty = full + G::STAGES;
  uint64_t* ticket = empty + G::STAGES;
  const int wg = threadIdx.x >> 7;
  const int nt = (T + ROWS - 1) / ROWS;   // query tiles of a pair

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      gemm::mbar_init(&full[s], 1);
      gemm::mbar_init(&empty[s], 2);   // each consumer warpgroup frees the stage
    }
    gemm::mbar_init(ticket, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    gemm::setmaxnreg_dec<PRODUCER_REGS>();
    if ((threadIdx.x & 127) != 0) return;
    const unsigned bytes = 3u * G::TILE;
    for (int pair = blockIdx.x, j = 0; pair < pairs; pair += gridDim.x, ++j) {
      const int s = j % G::STAGES;
      gemm::mbar_wait(&empty[s], ((j / G::STAGES) & 1) ^ 1);
      gemm::mbar_expect_tx(&full[s], bytes);
      io.load(pair, smem + s * G::STAGE, G::TILE, &full[s]);
    }
    return;
  }

  // consumers: warpgroup wg takes the CTA's tiles wg, wg + 2, ...
  gemm::setmaxnreg_inc<CONSUMER_REGS>();
  int item = 0;
  for (int pair = blockIdx.x, j = 0; pair < pairs; pair += gridDim.x, ++j) {
    const int s = j % G::STAGES;
    gemm::mbar_wait(&full[s], (j / G::STAGES) & 1);
    unsigned char* qs = smem + s * G::STAGE;
    for (int t = 0; t < nt; ++t, ++item)
      if ((item & 1) == wg)
        tile<D, T_, BLOCKS>(io, pair, t, item, T, c2, qs, qs + G::TILE, qs + 2 * G::TILE, ticket);
    // the stage's O stores have read it, and its O writes come before TMA's
    // next writes there; then free it
    if ((threadIdx.x & 31) == 0) gemm::bulk_wait<true>();
    wg::fence_proxy();
    gemm::wg_barrier(1 + wg);
    if ((threadIdx.x & 127) == 0) gemm::mbar_arrive(&empty[s]);
  }
  if ((threadIdx.x & 31) == 0) gemm::bulk_wait<false>();   // the last stores have landed
}

// ------------------------------------------------------------------ host side

// A rank-4 tensor map of 16-bit words at p: dims and byte strides (dims[0]
// contiguous), boxes of Geo<D>::BOX columns by `rows` along dim `row_dim`
// (1 or 2), one along the others, swizzled at the staged row's span; what
// lies past the dims reads as zeros and is not stored.
template <int D>
int encode(CUtensorMap* map, CUtensorMapDataType type, const void* p, const cuuint64_t* dims,
           const cuuint64_t* strides, int row_dim, int rows) {
  const gemm::EncodeTiled enc = gemm::encode_tiled();
  if (enc == nullptr) return ERR_NO_ENCODER;
  cuuint32_t box[4] = {(cuuint32_t)Geo<D>::BOX, 1, 1, 1};
  box[row_dim] = rows;
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, type, 4, const_cast<void*>(p), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, Geo<D>::MAP_SWIZZLE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

template <int D, typename T_, bool BLOCKS, class Io>
int launch(const Io& io, int pairs, int T, float c2, cudaStream_t stream) {
  auto kernel = attn_wgmma_kernel<D, T_, BLOCKS, Io>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int grid = pairs < gemm::sm_count() ? pairs : gemm::sm_count();
  kernel<<<grid, THREADS, Geo<D>::SMEM, stream>>>(io, pairs, T, c2);
  return (int)cudaGetLastError();
}

// o = attention(q, k, v) over B x H pairs (csrc/attention.cu): q, k, v, o
// [B, H, T, D] with element strides st[0..3] (the last dim contiguous),
// 1 <= T <= 256.  Returns 0, a CUDA error or ERR_*.
template <int D, typename T_>
int attention(const void* q, const void* k, const void* v, void* o, const attn::Strides* st,
              int B, int H, int T, float scale, cudaStream_t stream) {
  if (T < 1 || T > T_MAX) return (int)cudaErrorInvalidValue;
  AttnIo io;
  const void* ptr[4] = {q, k, v, o};
  CUtensorMap* maps[4] = {&io.q, &io.k, &io.v, &io.o};
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  for (int i = 0; i < 4; ++i) {
    // byte strides of T, H and B; a dim of one element may carry any
    // stride, so it gets one TMA takes
    const cuuint64_t strides[3] = {T > 1 ? (cuuint64_t)st[i].t * 2 : 16,
                                   H > 1 ? (cuuint64_t)st[i].h * 2 : 16,
                                   B > 1 ? (cuuint64_t)st[i].b * 2 : 16};
    // q, k, v: a pair's 256 rows (past T zeros); o: a warp's 16
    const int rc = encode<D>(maps[i], Elem<T_>::MAP, ptr[i], dims, strides, 1,
                             i < 3 ? T_MAX : 16);
    if (rc != 0) return rc;
  }
  io.H = H;
  return launch<D, T_, false>(io, B * H, T, scale * LOG2E, stream);
}

// att = the layer stack's attention of nc contexts x H heads (csrc/fused_blocks.cu):
// qkv [nc, T, 3 EA], att [nc, T, EA], EA = H D, 1 <= T <= 256.
template <int D>
int blocks_attention(const bf16* qkv, bf16* att, int nc, int T, int H, cudaStream_t stream) {
  if (T < 1 || T > T_MAX) return (int)cudaErrorInvalidValue;
  BlocksIo io;
  const cuuint64_t ea = (cuuint64_t)H * D;
  const cuuint64_t dq[4] = {(cuuint64_t)D, 3 * (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)nc};
  const cuuint64_t sq[3] = {D * 2, 3 * ea * 2, 3 * ea * 2 * T};
  const cuuint64_t da[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)nc};
  const cuuint64_t sa[3] = {D * 2, ea * 2, ea * 2 * T};
  int rc = encode<D>(&io.qkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qkv, dq, sq, 2, T_MAX);
  if (rc == 0) rc = encode<D>(&io.att, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, att, da, sa, 2, 16);
  if (rc != 0) return rc;
  io.H = H;
  return launch<D, bf16, true>(io, nc * H, T, 1.f, stream);
}

#undef AW_ACC4
#undef AW_ACC8
#undef AW_ACC16
#undef AW_ACC32
#undef AW_ACC64
#undef AW_ACC128
#undef AW_R8
#undef AW_R16
#undef AW_R32
#undef AW_R128
#undef AW_SS256
#undef AW_RS

}  // namespace aw
