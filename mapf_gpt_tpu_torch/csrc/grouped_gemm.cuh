// Grouped Hopper GEMM over row segments, for the mixture-of-experts layers
// of csrc/moe.cu: segment e of A's rows is multiplied by weight matrix e,
//
//   C[rows of e] = epilogue(A[rows of e] W_e),  A [rows, K] K-major bf16,
//   W stacked [segments * K, N] row-major bf16 (W_e = rows e K .. e K + K - 1),
//   fp32 accumulation,
//
// with the segments read from device memory at run time, so that a layer's
// expert counts never travel to the host.  It is gemm_tile.cuh's kernel
// (one TMA producer thread keeping a ring of 128-byte-swizzled (A, B) tiles
// in flight, two wgmma consumer warpgroups on rows 0-63 and 64-127 of a BM =
// 128 row tile, BN = 256 columns, the output staged in shared memory and
// stored by TMA while the next tile's products run; gemm_tile.cuh's
// barrier, TMA and tensor-map helpers) with two changes:
//   * the persistent tile walker takes its tiles from a segment table:
//     tile_start[e] .. tile_start[e + 1] - 1 are segment e's row tiles, the
//     first at row row0[e]; a row tile lies inside one segment (the router
//     pads each segment to a multiple of BM rows: csrc/moe.cu's
//     route_offsets_kernel), so a tile reads one weight matrix and its TMA
//     store never reaches another segment's rows.  A null table is one
//     segment of all M rows (the dense SwiGLU layers);
//   * the SwiGLU epilogue: W's columns come in blocks of 16, the gate of 8
//     hidden units then their up (models/moonlight.py::interleave_gate_up),
//     so a thread's accumulators hold gate and up of the same units in
//     adjacent n8 tiles, and it stores bf16(silu(bf16(gate)) * bf16(up)),
//     an output tile of BN / 2 columns.  The other epilogue stores bf16(acc).
//
// Two kernels of one body, so that a trace tells them apart by name:
// expert_gemm_kernel (the routed experts, with a table) and dense_gemm_kernel
// (one segment: a dense SwiGLU).
//
// Limits: K a multiple of BK = 64 (a k-tile never straddles two weight
// matrices); N a multiple of 16 (SwiGLU) or 8; every row stride a multiple
// of 8 elements and every base 16-byte aligned (TMA).

#pragma once

#include "gemm_tile.cuh"

namespace grouped {

using gemm::BK;
using gemm::BM;
using gemm::BOX;
using gemm::BOX_BYTES;
using gemm::THREADS;
typedef __nv_bfloat16 bf16;

constexpr int BN = 256;

// Segment table in device memory: tile_start [nseg + 1], row0 [nseg]; a null
// tile_start is one segment of M rows.
struct Segments {
  const int* tile_start;
  const int* row0;
  int nseg;
  int M;
};

template <bool SWIGLU>
struct Cfg {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int C_BYTES = SWIGLU ? BM * BN : BM * BN * 2;
  static constexpr int STAGES = (232448 - 1024 - C_BYTES) / (STAGE + 16);
  static constexpr int SMEM = STAGES * STAGE + C_BYTES + 2 * STAGES * 8 + 1024;
};
static_assert(Cfg<true>::STAGES >= 3 && Cfg<false>::STAGES >= 3, "a ring of three stages");
static_assert(Cfg<true>::SMEM <= 232448 && Cfg<false>::SMEM <= 232448,
              "a block's shared memory on sm_90");

__device__ __forceinline__ int row_tiles(const Segments& s) {
  return s.tile_start != nullptr ? s.tile_start[s.nseg] : gemm::cdiv(s.M, BM);
}

// (segment, first row) of row tile mt
__device__ __forceinline__ int2 locate(const Segments& s, int mt) {
  if (s.tile_start == nullptr) return make_int2(0, mt * BM);
  int lo = 0, hi = s.nseg;   // tile_start[lo] <= mt < tile_start[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (s.tile_start[mid] <= mt)
      lo = mid;
    else
      hi = mid;
  }
  return make_int2(lo, s.row0[lo] + (mt - s.tile_start[lo]) * BM);
}

__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ float swiglu(float g, float u) {
  const float gb = rbf(g);
  return gb / (1.f + __expf(-gb)) * rbf(u);
}

template <bool SWIGLU>
__device__ __forceinline__ void body(const CUtensorMap* ta, const CUtensorMap* tb,
                                     const CUtensorMap* tc, int N, int K, const Segments& seg) {
  using C = Cfg<SWIGLU>;
  using namespace gemm;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* cbuf = smem + C::STAGES * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(cbuf + C::C_BYTES);
  uint64_t* empty = full + C::STAGES;
  const int wg = threadIdx.x >> 7;
  const int nt = cdiv(N, BN), ktiles = K / BK;
  const int tiles = row_tiles(seg) * nt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tiles in the order (row tile, n tile), n fastest: the CTAs in flight
  // share A's rows and read one weight matrix from L2
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % nt) * BN;
      const int2 sm = locate(seg, tile / nt);
      const int kw = sm.x * K;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], C::STAGE);
        unsigned char* a = smem + stage * C::STAGE;
        unsigned char* b = a + C::A_BYTES;
        const int k0 = kt * BK;
        tma_load(a, ta, &full[stage], k0, sm.y);
#pragma unroll
        for (int j = 0; j < BN / BOX; ++j)
          tma_load(b + j * BOX_BYTES, tb, &full[stage], n0 + j * BOX, kw + k0);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  int stage = 0, phase = 0;
  float acc[BN / 8][4];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % nt) * BN;
    const int m0 = locate(seg, tile / nt).y;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&full[stage], phase);
      const unsigned char* a = smem + stage * C::STAGE + cw * 64 * 128;
      const unsigned char* b = smem + stage * C::STAGE + C::A_BYTES;
      wg::fence_operands<BN / 8>(acc);
      wg::fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        const uint64_t da = wg::make_desc_sw128(a + k * 32, 16, 1024);
        const uint64_t db = wg::make_desc_sw128(b + k * 2048, BOX_BYTES, 1024);
        wg::Mma<BN>::template run<0, 1>(acc, da, db, 1);
      }
      wg::commit();
      wg::wait<1>();
      wg::fence_operands<BN / 8>(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg::wait<0>();
    wg::fence_operands<BN / 8>(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

    // epilogue: the warpgroup's 64 rows into shared memory as 64 x 64
    // boxes in TMA's 128-byte swizzle, then one thread stores them by TMA
    unsigned char* crow = cbuf + cw * (64 * 128) + (warp * 16 + g) * 128;
    if ((threadIdx.x & 127) == 0) bulk_wait<true>();
    wg_barrier(1 + cw);
    if constexpr (SWIGLU) {
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {
        unsigned char* at = crow + (i >> 3) * (BM * 128) + (((i & 7) ^ g) << 4) + 4 * c;
        *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(
            swiglu(acc[2 * i][0], acc[2 * i + 1][0]), swiglu(acc[2 * i][1], acc[2 * i + 1][1]));
        *reinterpret_cast<__nv_bfloat162*>(at + 8 * 128) = __floats2bfloat162_rn(
            swiglu(acc[2 * i][2], acc[2 * i + 1][2]), swiglu(acc[2 * i][3], acc[2 * i + 1][3]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        unsigned char* at = crow + (j >> 3) * (BM * 128) + (((j & 7) ^ g) << 4) + 4 * c;
        *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
        *reinterpret_cast<__nv_bfloat162*>(at + 8 * 128) =
            __floats2bfloat162_rn(acc[j][2], acc[j][3]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_barrier(1 + cw);
    if ((threadIdx.x & 127) == 0) {
      constexpr int OUT = SWIGLU ? BN / 2 : BN;
      const int on0 = SWIGLU ? n0 / 2 : n0, on = SWIGLU ? N / 2 : N;
#pragma unroll
      for (int jb = 0; jb < OUT / BOX; ++jb)
        if (on0 + jb * BOX < on)
          tma_store(tc, cbuf + jb * (BM * 128) + cw * (64 * 128), on0 + jb * BOX, m0 + cw * 64);
      bulk_commit();
    }
  }
  if ((threadIdx.x & 127) == 0) bulk_wait<false>();
}

template <bool SWIGLU>
__global__ void __launch_bounds__(THREADS, 1)
expert_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tc, int N, int K, const Segments seg) {
  body<SWIGLU>(&ta, &tb, &tc, N, K, seg);
}

__global__ void __launch_bounds__(THREADS, 1)
dense_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tc, int N, int K, const Segments seg) {
  body<true>(&ta, &tb, &tc, N, K, seg);
}

// C = epilogue(A W_e) over the segments of `seg`: A [a_rows, K] (row stride
// K), W [nw K, N] (row stride N), C [a_rows, N / 2] with SWIGLU, else [a_rows,
// N] (row stride its width).  A null seg.tile_start runs dense_gemm_kernel
// (SwiGLU, one segment of seg.M rows).  Returns the first CUDA error.
template <bool SWIGLU>
cudaError_t run(const bf16* A, int a_rows, const bf16* W, int nw, bf16* Cout, int N, int K,
                const Segments& seg, cudaStream_t stream) {
  using C = Cfg<SWIGLU>;
  if (a_rows < 1 || nw < 1 || N < 1 || K < BK || K % BK || N % (SWIGLU ? 16 : 8))
    return cudaErrorInvalidValue;
  if (seg.tile_start == nullptr && (!SWIGLU || seg.M < 1 || seg.M > a_rows))
    return cudaErrorInvalidValue;
  const int out = SWIGLU ? N / 2 : N;
  CUtensorMap ta, tb, tc;
  cudaError_t err = gemm::make_map(&ta, A, a_rows, K, K, BM);
  if (err != cudaSuccess) return err;
  err = gemm::make_map(&tb, W, nw * K, N, N, BK);
  if (err != cudaSuccess) return err;
  err = gemm::make_map(&tc, Cout, a_rows, out, out, 64);
  if (err != cudaSuccess) return err;
  auto kernel = seg.tile_start == nullptr ? dense_gemm_kernel : expert_gemm_kernel<SWIGLU>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  int grid = gemm::sm_count();
  if (seg.tile_start == nullptr) {
    const int work = gemm::cdiv(seg.M, BM) * gemm::cdiv(N, BN);
    grid = work < grid ? work : grid;
  }
  kernel<<<grid, THREADS, C::SMEM, stream>>>(ta, tb, tc, N, K, seg);
  return cudaGetLastError();
}

}  // namespace grouped
