// The Hopper GEMM shared by csrc/fused_blocks.cu (the products of
// mapf_gpt_tpu/ops/fused_gpt.py::_block_kernel) and csrc/fused_train.cu
// (those of mapf_gpt_tpu/ops/fused_gpt_train.py::_fwd_kernel and
// ::_bwd_kernel):
//
//   C = epilogue(op(A) op(B)),  op(A) [M, K], op(B) [K, N], bf16 operands,
//   fp32 accumulation, rows past M and columns past N never stored,
//
// with each operand read as it lies in device memory:
//   A K-major   stored [M, K] row-major   (every forward product, dX = dY W^T)
//   A MN-major  stored [K, M] row-major   (dW = A^T dY: A's rows are the depth)
//   B MN-major  stored [K, N] row-major   (a weight [in, out]; dY in dW)
//   B K-major   stored [N, K] row-major   (W^T in dX = dY W^T)
// so no operand is copied or transposed first: wgmma's imm-trans-a and
// imm-trans-b (csrc/wgmma.cuh) say which.
//
// Bound: operations at the repo's shapes (2 M N K FLOP against 2 (M K + K N
// + M N) bytes; at the 85M's fc, [65536, 768] x [768, 3072], 309 GFLOP
// against 0.5 GB: 0.31 ms at 989 TFLOP/s, 0.15 ms at 3.35 TB/s).  What the
// design does for that:
//   * a CTA of three warpgroups: one producer thread keeps a ring of STAGES
//     (A, B) tiles, each BK = 64 deep, in flight by TMA
//     (cp.async.bulk.tensor, completion counted on the stage's "full"
//     mbarrier), and two consumer warpgroups run wgmma.mma_async
//     m64nBNk16 from those tiles, rows 0-63 and 64-127 of a BM = 128 row
//     tile, BN = 128 or 256 columns by the output's width; each consumer
//     warp frees a stage on its "empty" mbarrier once the products that
//     read it have completed (one product group kept in flight);
//   * setmaxnreg moves registers from the producer (40) to the consumers
//     (232: 128 accumulators a thread at BN = 256);
//   * tiles are 128-byte swizzled, which TMA writes and wgmma reads free of
//     bank conflicts; TMA zero-fills what lies past the tensor, so M, N and
//     K need no padding: K tails add zeros, M and N tails are not stored;
//   * persistent: one CTA an SM walks the output tiles (and, for a split
//     K, the splits), so the producer loads the next tile while the
//     consumers run the epilogue;
//   * the epilogue runs on the accumulators in registers (mma's C layout)
//     and calls the caller's functor for each pair of adjacent columns (N
//     is a multiple of 8, so a pair never straddles it): epi.load(row,
//     col) reads what the pair combines with (a residual, a saved
//     activation; Side is NoSide where there is none), for 8 n8 tiles at a
//     time before any is stored, so those reads overlap.  A bf16 output
//     (Epi::STAGED, epi.c and epi.ldc) takes epi.value(row, col, v0, v1,
//     side), staged in shared memory and stored by TMA while the next
//     tile's products run; an fp32 one is stored from registers by
//     epi(row, col, v0, v1, side, split).
// Split K (weight gradients): split z of `splits` runs k-tiles [z per, (z +
// 1) per); the caller stores each split's partial and reduces them in a
// fixed order, so results do not depend on timing.
//
// Limits: TMA wants 16-byte global strides and base addresses, so every
// operand's row stride is a multiple of 8 elements and its base 16-byte
// aligned; M, N, K >= 1.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace gemm {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128, BK = 64;
constexpr int THREADS = 384;           // producer warpgroup + 2 consumer warpgroups
constexpr int BOX = 64;                // bf16 of a 128-byte swizzle row
constexpr int BOX_BYTES = BOX * BK * 2;  // an MN-major box [BK][64]: 8 KB

// Shared memory: the ring, then (a staged epilogue) the bf16 output tile,
// then the ring's barriers; + 1024 bytes to align the base.
template <int BN, bool STAGED>
struct Cfg {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = STAGED ? (BN == 256 ? 3 : 5) : (BN == 256 ? 4 : 6);
  static constexpr int C_BYTES = STAGED ? BM * BN * 2 : 0;
  static constexpr int SMEM = STAGES * STAGE + C_BYTES + 2 * STAGES * 8 + 1024;
};
static_assert(Cfg<256, true>::SMEM <= 232448 && Cfg<256, false>::SMEM <= 232448 &&
                  Cfg<128, true>::SMEM <= 232448 && Cfg<128, false>::SMEM <= 232448,
              "a block's shared memory on sm_90");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The side input of an epilogue that reads nothing but the accumulators.
struct NoSide {};

// ---------------------------------------------------------------- device side

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase `parity` has completed.  A wait past ~10 s
// (a lost TMA transaction, a miscounted arrival) traps, so a fault ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// box at (c0 inner, c1 outer) of the tensor map -> dst, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// box at (c0 inner, c1 outer) of the tensor map <- src, in the thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the thread's bulk stores have read their shared memory (READ) or completed
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the 128 threads of warpgroup-sized barrier `id` (1..15; 0 is __syncthreads)
__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// C = epi(op(A) op(B)) as the header says; A_MN: A stored [K, M]; B_K: B
// stored [N, K].  Tensor maps: ta over A as stored with box {64, BM} (K-major)
// or {64, BK} (MN-major); tb over B as stored with box {64, BN} (K-major) or
// {64, BK} (MN-major); tc (a staged epilogue) over the bf16 output with box
// {64, 64}; all 128-byte swizzled.
template <int BN, bool A_MN, bool B_K, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap tc, int M, int N, int K, int splits,
            const Epi epi) {
  using C = Cfg<BN, Epi::STAGED>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* cbuf = smem + C::STAGES * C::STAGE;   // the staged output tile
  uint64_t* full = reinterpret_cast<uint64_t*>(cbuf + C::C_BYTES);
  uint64_t* empty = full + C::STAGES;
  const int wg = threadIdx.x >> 7;
  const int mt = cdiv(M, BM), nt = cdiv(N, BN), ktiles = cdiv(K, BK);
  const int per = cdiv(ktiles, splits);
  const int tiles = mt * nt * splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // each consumer warp frees the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tiles in the order (n tile, m tile, split), n fastest, so the CTAs in
  // flight share A's rows and read B from L2
  if (wg == 0) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % nt) * BN, m0 = (tile / nt % mt) * BM, z = tile / (nt * mt);
      const int kt1 = min(ktiles, (z + 1) * per);
      for (int kt = z * per; kt < kt1; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], C::STAGE);
        unsigned char* a = smem + stage * C::STAGE;
        unsigned char* b = a + C::A_BYTES;
        const int k0 = kt * BK;
        if (!A_MN) {
          tma_load(a, &ta, &full[stage], k0, m0);
        } else {
#pragma unroll
          for (int j = 0; j < BM / BOX; ++j)
            tma_load(a + j * BOX_BYTES, &ta, &full[stage], m0 + j * BOX, k0);
        }
        if (B_K) {
          tma_load(b, &tb, &full[stage], k0, n0);
        } else {
#pragma unroll
          for (int j = 0; j < BN / BOX; ++j)
            tma_load(b + j * BOX_BYTES, &tb, &full[stage], n0 + j * BOX, k0);
        }
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw computes rows 64 cw .. 64 cw + 63 of each tile
  setmaxnreg_inc<232>();
  const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  int stage = 0, phase = 0;
  float acc[BN / 8][4];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % nt) * BN, m0 = (tile / nt % mt) * BM, z = tile / (nt * mt);
    const int kt1 = min(ktiles, (z + 1) * per);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    int prev = -1;
    for (int kt = z * per; kt < kt1; ++kt) {
      mbar_wait(&full[stage], phase);
      const unsigned char* a = smem + stage * C::STAGE + (A_MN ? cw * BOX_BYTES : cw * 64 * 128);
      const unsigned char* b = smem + stage * C::STAGE + C::A_BYTES;
      wg::fence_operands<BN / 8>(acc);
      wg::fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        const uint64_t da = A_MN ? wg::make_desc_sw128(a + k * 2048, BOX_BYTES, 1024)
                                 : wg::make_desc_sw128(a + k * 32, 16, 1024);
        const uint64_t db = B_K ? wg::make_desc_sw128(b + k * 32, 16, 1024)
                                : wg::make_desc_sw128(b + k * 2048, BOX_BYTES, 1024);
        wg::Mma<BN>::template run<A_MN ? 1 : 0, B_K ? 0 : 1>(acc, da, db, 1);
      }
      wg::commit();
      wg::wait<1>();   // the previous stage's products are done: free it
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

    // epilogue, 8 n8 tiles at a time: their side inputs loaded first, so
    // that 16 loads a thread are in flight, then combined and stored.  A
    // staged epilogue writes the warpgroup's 64 rows to shared memory as
    // 64 x 64 boxes in TMA's 128-byte swizzle (conflict-free: a warp's
    // rows g land on 16-byte chunks j ^ g), and one thread stores them by
    // TMA, which drains while the next tile's products run; the tile's
    // previous store must have read the buffer before it is written.
    const int r0 = m0 + cw * 64 + warp * 16 + g;
    unsigned char* crow = cbuf + cw * (64 * 128) + (warp * 16 + g) * 128;
    if constexpr (Epi::STAGED) {
      if ((threadIdx.x & 127) == 0) bulk_wait<true>();
      wg_barrier(1 + cw);
    }
    constexpr int JC = 8;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += JC) {
      typename Epi::Side side[JC][2] = {};
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int col = n0 + 8 * (j0 + jj) + 2 * c;
        if (col < N) {
          if (r0 < M) side[jj][0] = epi.load(r0, col);
          if (r0 + 8 < M) side[jj][1] = epi.load(r0 + 8, col);
        }
      }
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int j = j0 + jj, col = n0 + 8 * j + 2 * c;
        if constexpr (Epi::STAGED) {
          // rows and columns past M and N are written here and clipped by TMA
          const float2 lo = epi.value(r0, col, acc[j][0], acc[j][1], side[jj][0]);
          const float2 hi = epi.value(r0 + 8, col, acc[j][2], acc[j][3], side[jj][1]);
          unsigned char* at = crow + (j >> 3) * (BM * 128) + (((j & 7) ^ g) << 4) + 4 * c;
          *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(lo.x, lo.y);
          *reinterpret_cast<__nv_bfloat162*>(at + 8 * 128) = __floats2bfloat162_rn(hi.x, hi.y);
        } else if (col < N) {
          if (r0 < M) epi(r0, col, acc[j][0], acc[j][1], side[jj][0], z);
          if (r0 + 8 < M) epi(r0 + 8, col, acc[j][2], acc[j][3], side[jj][1], z);
        }
      }
    }
    if constexpr (Epi::STAGED) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_barrier(1 + cw);
      if ((threadIdx.x & 127) == 0) {
#pragma unroll
        for (int jb = 0; jb < BN / BOX; ++jb)
          if (n0 + jb * BOX < N)
            tma_store(&tc, cbuf + jb * (BM * 128) + cw * (64 * 128), n0 + jb * BOX, m0 + cw * 64);
        bulk_commit();
      }
    }
  }
  if constexpr (Epi::STAGED) {
    if ((threadIdx.x & 127) == 0) bulk_wait<false>();
  }
}

// ------------------------------------------------------------------ host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, looked up through the
// runtime so that the library links against nothing but cudart.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map over a row-major bf16 matrix [rows, cols] (rows ld elements
// apart), boxes of {64 columns, box_rows rows}, 128-byte swizzled, zero fill
// past its edges.
inline cudaError_t make_map(CUtensorMap* map, const bf16* p, int rows, int cols, long long ld,
                            int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(p) & 15) || (ld & 7) || rows < 1 || cols < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {BOX, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(p), dims,
                         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

// The output tile width the launcher picks for N columns.
inline int tile_n(int N) { return N > 128 ? 256 : 128; }

// Output tiles of an [M, N] product.
inline int tiles(int M, int N) { return cdiv(M, BM) * cdiv(N, tile_n(N)); }

template <int BN, bool A_MN, bool B_K, class Epi>
cudaError_t launch(const bf16* A, long long lda, const bf16* B, long long ldb, int M, int N, int K,
                   int splits, const Epi& epi, cudaStream_t stream) {
  using C = Cfg<BN, Epi::STAGED>;
  CUtensorMap ta, tb, tc = {};
  cudaError_t err = A_MN ? make_map(&ta, A, K, M, lda, BK) : make_map(&ta, A, M, K, lda, BM);
  if (err != cudaSuccess) return err;
  err = B_K ? make_map(&tb, B, N, K, ldb, BN) : make_map(&tb, B, K, N, ldb, BK);
  if (err != cudaSuccess) return err;
  if constexpr (Epi::STAGED) {
    if (splits != 1) return cudaErrorInvalidValue;
    err = make_map(&tc, epi.c, M, N, epi.ldc, 64);
    if (err != cudaSuccess) return err;
  }
  auto kernel = gemm_kernel<BN, A_MN, B_K, Epi>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int work = tiles(M, N) * splits;
  const int grid = work < sm_count() ? work : sm_count();
  kernel<<<grid, THREADS, C::SMEM, stream>>>(ta, tb, tc, M, N, K, splits, epi);
  return cudaGetLastError();
}

// C = epi(op(A) op(B)): A stored [M, K] (lda) or, with A_MN, [K, M]; B
// stored [K, N] (ldb) or, with B_K, [N, K]; K split `splits` ways (epi gets
// the split).  Returns the first CUDA error of the launch.
template <bool A_MN, bool B_K, class Epi>
cudaError_t run(const bf16* A, long long lda, const bf16* B, long long ldb, int M, int N, int K,
                const Epi& epi, cudaStream_t stream, int splits = 1) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || (N & 7)) return cudaErrorInvalidValue;
  return tile_n(N) == 256 ? launch<256, A_MN, B_K>(A, lda, B, ldb, M, N, K, splits, epi, stream)
                          : launch<128, A_MN, B_K>(A, lda, B, ldb, M, N, K, splits, epi, stream);
}

}  // namespace gemm
