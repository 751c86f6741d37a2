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
//     softmax on those accumulators (softmax_pv: the exp2s and the sums
//     interleaved, P packed in place); P fed back as wgmma's register A
//     operand for P V (m64nDk16, V the B operand read N-major from the tile
//     TMA wrote), in two groups, the first under the second's packing; O
//     rounded in registers and stored by TMA from the warpgroup's own
//     staging rows, which clips the rows past T, so that a warpgroup frees
//     the stage (one arrival a warp) as soon as its last P V of the pair is
//     done;
//   * at D >= 48 the two warpgroups' exp2s take turns (a "ticket" mbarrier:
//     tile i's exp2s start when all four warps of tile i - 1 are done with
//     theirs), so one warpgroup's exp2s run while the other's max pass,
//     packing, products and epilogue do;
//   * setmaxnreg moves registers from the producer warpgroup (24) to the
//     consumers (240), but ptxas holds the consumers to 168 registers a
//     thread here (PERF.md), which the tile is written to: scores
//     128, O up to 32, P in the scores' registers.
// tools/attn_clock.py splits a tile's time by phase (the AW_MARK marks).
// Shared-memory layout: rows of RB = 2 D bytes (128 at D = 48, whose box is
// 64 wide), swizzled by TMA at the span RB (128, 64 or 32 bytes), which the
// wgmma descriptors name: K-major for Q (A) and K (B), N-major for V (B).
// csrc/fused_gpt.cu inlines the tile in its layer loop (tile(): O written
// over the tile's Q rows, its own stages).
//
// csrc/fused_train.cu runs the attention's arithmetic (BLOCKS = false) over
// the layer stack's q|k|v workspace as the training forward and the
// backward's recompute (mapf_gpt_tpu/ops/fused_gpt_train.py::_fwd_kernel and
// ::_bwd_kernel), through TrainIo, which also stores each row's statistics
// m = max(s) c2 and l = sum 2^(s c2 - m) for the backward
// (csrc/attn_wgmma_bwd.cuh) when asked.
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
  static constexpr int OUT = ROWS * RB;               // O staging rows of a tile
  // the two warpgroups' exp2s take turns at D >= 48, where turns ran faster
  // on the card, not below (tools/attn_ab.py, PERF.md)
  static constexpr bool TURNS = D >= 48;
  // the ring, an O staging buffer a consumer warpgroup, barriers
  static constexpr int SMEM = STAGES * STAGE + 2 * OUT + (2 * STAGES + 1) * 8 + 1024;
  static constexpr unsigned SW = RB / 16 - 1;         // swizzle: 16-byte chunk ^= (row bits)
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;   // descriptor bits 62-63
  static constexpr CUtensorMapSwizzle MAP_SWIZZLE =
      RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};
static_assert(Geo<64>::SMEM <= 232448 && Geo<48>::SMEM <= 232448 && Geo<32>::SMEM <= 232448 &&
                  Geo<16>::SMEM <= 232448,
              "a block's shared memory");

// SM-clock counters of a tile's phases (tools/attn_clock.py builds with
// -DAW_CLOCK=1): thread 0 of each consumer warpgroup adds the clocks since
// its last mark to g_clock[k] at mark k; without AW_CLOCK the marks are empty.
enum ClockPhase { CLK_STAGE, CLK_S, CLK_TICKET, CLK_MAX, CLK_EXP2, CLK_SUMS, CLK_PV, CLK_EPILOGUE,
                  CLK_FREE, CLK_PHASES };
#if AW_CLOCK
__device__ unsigned long long g_clock[CLK_PHASES];
// a predicated reduction, not a branch (see pass_ticket)
__device__ __forceinline__ void clock_add(int k, long long v) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %2, 0;\n@p red.global.add.u64 [%0], %1;\n}\n" ::"l"(
          &g_clock[k]),
      "l"(v), "r"(threadIdx.x & 127)
      : "memory");
}
#define AW_CLOCK_START long long clk_t_ = clock64()
#define AW_MARK(k)                       \
  do {                                   \
    const long long n_ = clock64();      \
    clock_add(k, n_ - clk_t_);           \
    clk_t_ = n_;                         \
  } while (0)
#define AW_CLOCK_RESTART clk_t_ = clock64()
#else
#define AW_CLOCK_START do {} while (0)
#define AW_MARK(k) do {} while (0)
#define AW_CLOCK_RESTART do {} while (0)
#endif

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

// The sum of each of the thread's two rows from its 16 partial sums
// rs[j % 4][e] (e >> 1 the row), the quad's four lanes added, and 1 / it.
__device__ __forceinline__ void row_sums(const float (*rs)[4], float sum[2], float inv[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int a = 2 * r, b = 2 * r + 1;
    sum[r] = quad_sum(((rs[0][a] + rs[0][b]) + (rs[1][a] + rs[1][b])) +
                      ((rs[2][a] + rs[2][b]) + (rs[3][a] + rs[3][b])));
    inv[r] = 1.f / sum[r];
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

// Arrive at bar where `arrive`: a predicated instruction, not a branch.  A
// branch is a divergent path to ptxas, and one among products in flight
// makes it serialise every wgmma of the kernel.
__device__ __forceinline__ void arrive_if(uint64_t* bar, bool arrive) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(gemm::smem_u32(bar)),
      "r"((int)arrive)
      : "memory");
}

// csrc/attention.cu's operands: q, k, v and o [B, H, T, D] through rank-4
// tensor maps (D, T, H, B) built from their own strides.
struct AttnIo {
  static constexpr bool STATS = false;
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
  static constexpr bool STATS = false;
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

// csrc/fused_train.cu's: BlocksIo's operands, and (m not null) each row's
// statistics m, l [pairs, T] fp32 for the backward.
struct TrainIo : BlocksIo {
  static constexpr bool STATS = true;
  float *m, *l;
  int T;
  // rows g and g + 8 of the warp's 16 from `row0` (lane c4 = 0 of each quad)
  __device__ __forceinline__ void stats(int pair, int row0, const float mr[2],
                                        const float sum[2]) const {
    if (m == nullptr || (threadIdx.x & 3)) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + ((threadIdx.x & 31) >> 2) + 8 * r;
      if (row < T) {
        m[(size_t)pair * T + row] = mr[r];
        l[(size_t)pair * T + row] = sum[r];
      }
    }
  }
};

// The tile's pieces.  A 64-row query tile t of a pair whose Q, K and V are
// at qs, ks, vs: S = Q K^T, the softmax on the accumulators, O = P V, O
// out.  Every key slot of the 256 takes part in the products (TMA
// zero-fills the rows past T, and those keys are masked), so that no branch
// sits between two products: ptxas would fence each product of a branching
// sequence alone.  The scores' (j, e) is key 8 j + 2 c4 + (e & 1) of row
// g + 8 (e >> 1) of the warp's 16.

constexpr int NT = T_MAX / 8;   // n8 tiles of the scores
constexpr int NS = NT / 2;      // 16-key slices of P V

// S = Q K^T of the 64 query rows at qt over all 256 key slots, issued and
// committed (the first k-slice overwriting)
template <int D, typename T_>
__device__ __forceinline__ void issue_s(float (*sc)[4], const unsigned char* qt,
                                        const unsigned char* ks) {
  wg::fence();
  Elem<T_>::template ss256<false>(sc, desc<D>(qt), desc<D>(ks));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    Elem<T_>::template ss256<true>(sc, desc<D>(qt + 32 * kk), desc<D>(ks + 32 * kk));
  wg::commit();
}

// scores whose key reaches key_lim = T - 2 c4 set to v: a compare with an
// immediate, so that no per-thread key index is held in a register (the e2e
// kernel, which inlines this tile in its layer loop, spilled them)
__device__ __forceinline__ void mask_keys(float (*sc)[4], int key_lim, float v) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j * 8 + (e & 1) >= key_lim) sc[j][e] = v;
}

// Slice kk's P (its A fragment, four words) is packed into the registers of
// the slice's first n8 tile of scores, sc[2 kk], so that P takes no
// registers beside the scores'.

// e = bf16(2^min(s, 100)) of slice kk (the layer stack's), packed in place;
// the sums add the rounded e
template <typename T_>
__device__ __forceinline__ void blocks_slice(float (*sc)[4], int kk, float (*rs)[4]) {
#pragma unroll
  for (int j = 2 * kk; j < 2 * kk + 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = ex2(fminf(sc[j][e], EXP2_CLAMP));
  unsigned u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* f = sc[2 * kk + (i >> 1)] + 2 * (i & 1);
    u[i] = Elem<T_>::pack(f[0], f[1]);
    rs[kk % 4][2 * (i & 1)] += __uint_as_float(u[i] << 16);
    rs[kk % 4][2 * (i & 1) + 1] += __uint_as_float(u[i] & 0xffff0000u);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) sc[2 * kk][i] = __uint_as_float(u[i]);
}

// P of slice kk normalised and rounded (the attention's), packed in place
template <typename T_>
__device__ __forceinline__ void attn_slice(float (*sc)[4], int kk, const float inv[2]) {
  const float* lo = sc[2 * kk];
  const float* hi = sc[2 * kk + 1];
  const unsigned u[4] = {Elem<T_>::pack(lo[0] * inv[0], lo[1] * inv[0]),
                         Elem<T_>::pack(lo[2] * inv[1], lo[3] * inv[1]),
                         Elem<T_>::pack(hi[0] * inv[0], hi[1] * inv[0]),
                         Elem<T_>::pack(hi[2] * inv[1], hi[3] * inv[1])};
#pragma unroll
  for (int i = 0; i < 4; ++i) sc[2 * kk][i] = __uint_as_float(u[i]);
}

template <int D>
__device__ __forceinline__ void zero_o(float (*o)[4]) {
#pragma unroll
  for (int n = 0; n < Geo<D>::BOX / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
}

// O += P V over slices [k0, k1), P packed in place in sc, issued between
// the fence that orders the P writes and a commit: a group of its own, so
// that ptxas sees no write of a product's input inside a group in flight
// (the callers' loops unroll, so that the registers are indexed by
// constants)
template <int D, typename T_>
__device__ __forceinline__ void issue_pv(float (*o)[4], const float (*sc)[4],
                                         const unsigned char* vs, int k0, int k1) {
  wg::fence();
#pragma unroll
  for (int kk = k0; kk < k1; ++kk) {
    const unsigned a[4] = {__float_as_uint(sc[2 * kk][0]), __float_as_uint(sc[2 * kk][1]),
                           __float_as_uint(sc[2 * kk][2]), __float_as_uint(sc[2 * kk][3])};
    Elem<T_>::template rs<Geo<D>::BOX>(o, a, desc<D>(vs + kk * 16 * Geo<D>::RB));
  }
  wg::commit();
}

// The turn passes once every warp of the warpgroup is past its wait: were
// one thread to arrive alone, a warp still polling the previous phase would
// see the next one and wait for the other warpgroup's next turn, which may
// never come (the ticket counts 4 arrivals, one a warp).  IN_FLIGHT: P V
// products may be in flight, so the arrival is predicated (arrive_if).
template <bool IN_FLIGHT>
__device__ __forceinline__ void pass_ticket(uint64_t* ticket) {
  __syncwarp();
  if constexpr (IN_FLIGHT)
    arrive_if(ticket, (threadIdx.x & 31) == 0);
  else if ((threadIdx.x & 31) == 0)
    gemm::mbar_arrive(ticket);
}

// The softmax of the scores sc of the tile at query row row0 (tile item of
// the CTA's sequence) and O = P V into o, waited for; inv: 1 / sum of each
// of the thread's two rows.  ptxas lays a softmax out as blocks of one
// instruction (128 FFMA, 128 MUFU.EX2, 128 FADD), and a warp issues in
// order, so a block of ex2s kept its warp from anything else for 1,024
// clocks in the tile's first schedule.  Here no branch sits between the
// exp2s and the sums, so that each sum is issued beside a later ex2; at
// TURNS head dims the two warpgroups' exp2s alone take turns (tile item's
// wait for item - 1's), so that the max pass, the sums and the packing run
// beside the other warpgroup's exp2s; P is packed in place, into the
// registers of its first n8 tile of scores (ptxas holds the attention
// kernels to 168 registers a thread whatever setmaxnreg gives), and P V
// goes out in two groups of eight slices, the first under the second's
// packing: after l for the attention, whose p is normalised before it is
// rounded, and with the exp2s for the layer stack's, which normalises
// after P V.
template <int D, typename T_, bool BLOCKS, class Io>
__device__ __forceinline__ void softmax_pv(const Io& io, int pair, int row0, int item, int T,
                                           float c2, float (*sc)[4], const unsigned char* vs,
                                           uint64_t* ticket, float (*o)[4], float inv[2]) {
  using G = Geo<D>;
  const float NEG_INF = __int_as_float(0xff800000);
  const int c4 = threadIdx.x & 3, key_lim = T - 2 * c4;
  const bool turns = G::TURNS && item > 0;
  AW_CLOCK_START;
  // the rows' sums, each over 16 accumulators [j % 4][e] so that one warp's
  // dependency chains do not set the pace
  float rs[4][4] = {}, sum[2];
  if constexpr (!BLOCKS) {
    // p = 2^(s c2 - m) / l with m = max(s c2), taken as max(s) |c2| over s
    // or -s by the sign of c2: one fma and one ex2 a score.  Masked keys get
    // an s that never wins the max, then an exponent of -inf, p = 0.
    const bool pos = c2 >= 0.f;
    if (T < T_MAX) mask_keys(sc, key_lim, pos ? NEG_INF : -NEG_INF);
    float mx[2][4];   // by j % 2: max is exact in any order
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[j][e] = pos ? sc[j][e] : -sc[j][e];
    if (pos) {
#pragma unroll
      for (int j = 2; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[j % 2][e] = fmaxf(mx[j % 2][e], sc[j][e]);
    } else {
#pragma unroll
      for (int j = 2; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[j % 2][e] = fmaxf(mx[j % 2][e], -sc[j][e]);
    }
    float mr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mr[r] = quad_max(fmaxf(fmaxf(mx[0][2 * r], mx[0][2 * r + 1]),
                             fmaxf(mx[1][2 * r], mx[1][2 * r + 1]))) *
              fabsf(c2);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = fmaf(sc[j][e], c2, -mr[e >> 1]);
    if (T < T_MAX) mask_keys(sc, key_lim, NEG_INF);
    AW_MARK(CLK_MAX);
    if (turns) gemm::mbar_wait(ticket, (item - 1) & 1);
    AW_MARK(CLK_TICKET);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = ex2(sc[j][e]);
        rs[j % 4][e] += sc[j][e];
      }
    if (G::TURNS) pass_ticket<false>(ticket);
    AW_MARK(CLK_EXP2);
    row_sums(rs, sum, inv);
    if constexpr (Io::STATS) io.stats(pair, row0, mr, sum);
#pragma unroll
    for (int k0 = 0; k0 < NS; k0 += NS / 2) {
#pragma unroll
      for (int kk = k0; kk < k0 + NS / 2; ++kk) attn_slice<T_>(sc, kk, inv);
      if (k0 == 0) zero_o<D>(o);
      issue_pv<D, T_>(o, sc, vs, k0, k0 + NS / 2);
    }
  } else {
    // masked keys' scores to -inf, 2^-inf = +0
    if (T < T_MAX) mask_keys(sc, key_lim, NEG_INF);
    if (turns) gemm::mbar_wait(ticket, (item - 1) & 1);
    AW_MARK(CLK_TICKET);
#pragma unroll
    for (int k0 = 0; k0 < NS; k0 += NS / 2) {
#pragma unroll
      for (int kk = k0; kk < k0 + NS / 2; ++kk) blocks_slice<T_>(sc, kk, rs);
      if (k0 == 0) zero_o<D>(o);
      issue_pv<D, T_>(o, sc, vs, k0, k0 + NS / 2);
      // the turn passes with the first half's exp2s (ran faster on the card
      // than after all of them; the attention's passes after all)
      if (G::TURNS && k0 == 0) pass_ticket<true>(ticket);
    }
    AW_MARK(CLK_EXP2);
    row_sums(rs, sum, inv);
  }
  AW_MARK(CLK_SUMS);
  wg::wait<0>();
  wg::fence_operands<G::BOX / 8>(o);
  AW_MARK(CLK_PV);
}

// O rounded (the layer stack's scaled by 1 / sum e first) into the warp's
// 16 rows of the 64 at ot (in TMA's swizzle), then one bulk store of them
// to their rows of the tile at query row row0, which clips rows past T and
// columns past D
template <int D, typename T_, bool BLOCKS, class Io>
__device__ __forceinline__ void store_o(const Io& io, int pair, int row0, const float (*o)[4],
                                        const float inv[2], unsigned char* ot) {
  using G = Geo<D>;
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const float on0 = BLOCKS ? inv[0] : 1.f, on1 = BLOCKS ? inv[1] : 1.f;
#pragma unroll
  for (int n = 0; n < G::BOX / 8; ++n) {
    const unsigned off = (warp * 16 + g) * G::RB + n * 16 + c4 * 4;
    *reinterpret_cast<unsigned*>(ot + swz<D>(off)) = Elem<T_>::pack(o[n][0] * on0, o[n][1] * on0);
    *reinterpret_cast<unsigned*>(ot + swz<D>(off + 8 * G::RB)) =
        Elem<T_>::pack(o[n][2] * on1, o[n][3] * on1);
  }
  wg::fence_proxy();
  __syncwarp();
  if (lane == 0) {
    io.store(pair, row0 + warp * 16, ot + warp * 16 * G::RB);
    gemm::bulk_commit();
  }
}

// One 64-row query tile in one go, O written over the tile's Q rows (free
// once S is done): the layer loop of csrc/fused_gpt.cu calls it.
template <int D, typename T_, bool BLOCKS, class Io>
__device__ __forceinline__ void tile(const Io& io, int pair, int t, int item, int T, float c2,
                                     unsigned char* qs, const unsigned char* ks,
                                     const unsigned char* vs, uint64_t* ticket) {
  unsigned char* qt = qs + t * ROWS * Geo<D>::RB;
  const int row0 = t * ROWS + ((threadIdx.x & 127) >> 5) * 16;
  AW_CLOCK_START;
  float sc[NT][4], o[Geo<D>::BOX / 8][4], inv[2];
  issue_s<D, T_>(sc, qt, ks);
  wg::wait<0>();
  wg::fence_operands<NT>(sc);
  AW_MARK(CLK_S);
  softmax_pv<D, T_, BLOCKS>(io, pair, row0, item, T, c2, sc, vs, ticket, o, inv);
  AW_CLOCK_RESTART;
  store_o<D, T_, BLOCKS>(io, pair, t * ROWS, o, inv, qt);
  AW_MARK(CLK_EPILOGUE);
}

// The persistent kernel: `pairs` (batch or context, head) pairs of T keys;
// c2 = scale * log2(e) for the attention (unused by the layer stack's).
// The CTA's query tiles form one sequence (tile t of its j-th pair is item
// j nt + t); warpgroup wg takes items wg, wg + 2, ...  O goes out through
// the warpgroup's own staging rows, not over Q, so a warpgroup frees a
// stage (one arrival a warp) as soon as its last P V of the pair is done,
// and the producer loads the next pair there while the epilogue runs; a
// warpgroup with no tile in a pair (one tile a pair, T <= 64) frees it once
// it is full.
template <int D, typename T_, bool BLOCKS, class Io>
__global__ void __launch_bounds__(THREADS, 1)
attn_wgmma_kernel(const __grid_constant__ Io io, int pairs, int T, float c2) {
  using G = Geo<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::STAGES * G::STAGE + 2 * G::OUT);
  uint64_t* empty = full + G::STAGES;
  uint64_t* ticket = empty + G::STAGES;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int nt = (T + ROWS - 1) / ROWS;   // query tiles of a pair
  const int np = (pairs - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;   // CTA's pairs

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      gemm::mbar_init(&full[s], 1);
      gemm::mbar_init(&empty[s], 8);   // a consumer warp's arrival each
    }
    gemm::mbar_init(ticket, 4);   // a warpgroup's warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    gemm::setmaxnreg_dec<PRODUCER_REGS>();
    if ((threadIdx.x & 127) != 0) return;
    for (int j = 0; j < np; ++j) {
      const int s = j % G::STAGES;
      gemm::mbar_wait(&empty[s], ((j / G::STAGES) & 1) ^ 1);
      gemm::mbar_expect_tx(&full[s], 3u * G::TILE);
      io.load(blockIdx.x + j * gridDim.x, smem + s * G::STAGE, G::TILE, &full[s]);
    }
    return;
  }

  // consumers
  gemm::setmaxnreg_inc<CONSUMER_REGS>();
  unsigned char* ot = smem + G::STAGES * G::STAGE + wg * G::OUT;   // O staging rows
  // a warp's arrival at the stage's empty barrier, once its P V are done
  auto free_stage = [&](int s) {
    __syncwarp();
    if (lane == 0) gemm::mbar_arrive(&empty[s]);
  };
  int item = 0;   // the CTA's tiles before this pair's
  AW_CLOCK_START;
  for (int pair = blockIdx.x, j = 0; pair < pairs; pair += gridDim.x, ++j, item += nt) {
    const int s = j % G::STAGES;
    unsigned char* qs = smem + s * G::STAGE;
    gemm::mbar_wait(&full[s], (j / G::STAGES) & 1);
    AW_MARK(CLK_STAGE);
    const int t0 = (item & 1) == wg ? 0 : 1;   // this warpgroup's first tile of the pair
    for (int t = t0; t < nt; t += 2) {
      AW_CLOCK_RESTART;
      float sc[NT][4], o[G::BOX / 8][4], inv[2];
      issue_s<D, T_>(sc, qs + t * ROWS * G::RB, qs + G::TILE);
      wg::wait<0>();
      wg::fence_operands<NT>(sc);
      AW_MARK(CLK_S);
      softmax_pv<D, T_, BLOCKS>(io, pair, t * ROWS + ((threadIdx.x & 127) >> 5) * 16,
                                      item + t, T, c2, sc, qs + 2 * G::TILE, ticket, o, inv);
      AW_CLOCK_RESTART;
      if (t + 2 >= nt) free_stage(s);   // the warpgroup's last P V of the pair
      AW_MARK(CLK_FREE);
      // the staging rows' previous store has read them
      if (lane == 0) gemm::bulk_wait<true>();
      __syncwarp();
      store_o<D, T_, BLOCKS>(io, pair, t * ROWS, o, inv, ot);
      AW_MARK(CLK_EPILOGUE);
    }
    if (t0 >= nt) free_stage(s);   // no tile of this warpgroup in the pair
  }
  if (lane == 0) gemm::bulk_wait<false>();   // the last stores have landed
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

// att = the training attention of nc contexts x H heads (csrc/fused_train.cu,
// the attention's arithmetic with scale = 1/sqrt(dh)): qkv [nc, T, 3 EA], att
// [nc, T, EA], EA = H D, 1 <= T <= 256; and each row's statistics m, l [nc, H,
// T] when m is not null.
template <int D>
int train_attention(const bf16* qkv, bf16* att, float* m, float* l, int nc, int T, int H,
                    float scale, cudaStream_t stream) {
  if (T < 1 || T > T_MAX) return (int)cudaErrorInvalidValue;
  TrainIo io;
  const cuuint64_t ea = (cuuint64_t)H * D;
  const cuuint64_t dq[4] = {(cuuint64_t)D, 3 * (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)nc};
  const cuuint64_t sq[3] = {D * 2, 3 * ea * 2, 3 * ea * 2 * T};
  const cuuint64_t da[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)nc};
  const cuuint64_t sa[3] = {D * 2, ea * 2, ea * 2 * T};
  int rc = encode<D>(&io.qkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qkv, dq, sq, 2, T_MAX);
  if (rc == 0) rc = encode<D>(&io.att, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, att, da, sa, 2, 16);
  if (rc != 0) return rc;
  io.H = H;
  io.m = m;
  io.l = l;
  io.T = T;
  return launch<D, bf16, false>(io, nc * H, T, scale * LOG2E, stream);
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

#if AW_CLOCK
// tools/attn_clock.py's readout: the counters into out[aw::CLK_PHASES], then zeroed if reset
extern "C" int aw_clock_read(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, aw::g_clock, sizeof(aw::g_clock));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[aw::CLK_PHASES] = {};
    err = cudaMemcpyToSymbol(aw::g_clock, zero, sizeof(zero));
  }
  return err == cudaSuccess ? (int)cudaDeviceSynchronize() : (int)err;
}
#endif
