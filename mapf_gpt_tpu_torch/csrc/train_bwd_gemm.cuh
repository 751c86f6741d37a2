// Two products of the training backward (csrc/fused_train.cu's
// backward_impl, the port of mapf_gpt_tpu/ops/fused_gpt_train.py::_bwd_kernel)
// with the work around them moved into their epilogues, on
// csrc/gemm_tile.cuh's machinery (a TMA ring of 128-byte-swizzled tiles, one
// producer thread, two wgmma consumer warpgroups of 64 rows each, persistent
// CTAs, the epilogue on the accumulators in registers):
//
//   mlp_front_kernel, for each [128 x 128] tile of the MLP's [M, F]:
//     hmid  = xn2 Wfc          (A K-major, B MN-major: Wfc stored [E, F])
//     dhact = dxb Wfc2^T       (B K-major: Wfc2 stored [F, E])
//     hact  = bf16(gelu_tanh(hmid)),  dh = bf16(dhact * gelu_tanh'(hmid))
//   two fp32 accumulators over the same K = E (64 + 64 registers a consumer
//   thread), a ring stage of four tiles (xn2, Wfc, dxb, Wfc2; 64 KB, three
//   stages), hact and dh staged in turn through one buffer and stored by
//   TMA.  hmid never leaves registers (the TPU kernel keeps it in VMEM,
//   mapf_gpt_tpu/ops/fused_gpt_train.py:157-180).  Each product walks K in
//   the order gemm_kernel does, so hact and dh are those of the two-GEMM
//   route (hact equals gemm_kernel's with the forward's GELU epilogue bit
//   for bit).
//
//   ln_dx_kernel, dY = A W^T (dh Wfc^T with LN2, dqkv Wqkv^T with LN1; W
//   stored [E, K], read K-major) with the LayerNorm backward in the
//   epilogue (the TPU kernel's :240-245): for each row, from the recompute's
//   mu and rstd (ln_kernel writes them) and x,
//     d = dY g,  xhat = (x - mu) rstd,
//     m1 = sum(d) / EL,  m2 = sum(d xhat) / EL     (over the first EL columns)
//     dx += (d - m1 - xhat m2) rstd;  dxb = bf16(dx)
//   and the gain gradient's rows, sum over the tile's 128 rows of dY xhat,
//   as one partial row a row tile (reduced by the caller in a fixed order).
//   In wgmma's C layout a row lies in one quad of a warp: a thread sums its
//   64 columns, two shuffles finish the row.  The output tile is BN = 256
//   wide; at E <= 256 a CTA owns whole rows.  Up to LN_MAX_RANKS tiles (E
//   <= 2048) a row's tiles run as one thread-block cluster, rank r on
//   columns [256 r, 256 r + 256): each CTA pushes its rows' two partial sums
//   into every rank's shared memory (st.shared::cluster, then a release
//   arrive on that rank's mbarrier), waits for all ranks' on its own, and
//   adds them in rank order, so every rank forms the same m1, m2.  dY never
//   leaves registers.  Columns past EL (an n_embd stored padded to a
//   multiple of 8) keep dx and get dxb = bf16(dx).
//
// Bounds on an H100 (989 TFLOP/s bf16, 3.35 TB/s): the front at the 6M (M =
// 65536, E = 256, F = 1024) does 69 GFLOP and writes 268 MB (hact and dh):
// bytes, about 0.1 ms a launch; ln_dx there reads dh (134 MB) and x, reads
// and writes dx in fp32: bytes, about 0.1 ms.  Neither writes an fp32
// intermediate; the old route wrote hmid [M, F] and dY [M, E] in fp32 and
// read them back.
//
// Limits: operand strides multiples of 8 elements (TMA); M, E, F, K >= 1;
// the LN epilogue E <= 256 x LN_MAX_RANKS = 2048.

#pragma once

#include "attn_tile.cuh"
#include "gemm_tile.cuh"

namespace tbg {

using gemm::bf16;
using gemm::BK;
using gemm::BM;
using gemm::BOX;
using gemm::BOX_BYTES;
using gemm::cdiv;
using gemm::THREADS;

constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;
constexpr float GELU_C = 0.044715f;
constexpr int LN_BN = 256;        // the LN epilogue's output tile
constexpr int LN_MAX_RANKS = 8;   // a portable cluster: E up to 2048

// The ranks of the LN epilogue's cluster for a stored width E: 1 when a CTA
// owns whole rows, 0 past LN_MAX_RANKS tiles (the separate kernels run).
__host__ __device__ inline int ln_ranks(int E) {
  const int r = cdiv(E, LN_BN);
  return r <= LN_MAX_RANKS ? r : 0;
}

// Three stages and one staging buffer that hact, then dh, pass through: on
// the card this ran faster than two stages with a buffer for each output.
struct FrontCfg {
  static constexpr int BN = 128;
  static constexpr int TILE = BM * BK * 2;          // each of the four tiles: 16 KB
  static constexpr int STAGE = 4 * TILE;            // xn2, Wfc, dxb, Wfc2
  static constexpr int STAGES = 3;
  static constexpr int C_BYTES = BM * BN * 2;       // hact, then dh
  static constexpr int SMEM = STAGES * STAGE + C_BYTES + 2 * STAGES * 8 + 1024;
};

// Four stages, the most that fit beside the epilogue's buffers: the producer
// loads the next tile's first four k-tiles while the consumers run the
// epilogue, which the card showed to matter (dxb staged for TMA at the cost
// of a stage ran slower than dxb stored from registers).
struct LnCfg {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE = A_BYTES + LN_BN * BK * 2;
  static constexpr int STAGES = 4;
  static constexpr int COL_BYTES = 2 * 8 * LN_BN * 4;              // 8 warps' column sums, x2
  static constexpr int X_BYTES = 2 * LN_MAX_RANKS * BM * 8;        // ranks' row sums, x2
  static constexpr int SMEM = STAGES * STAGE + COL_BYTES + X_BYTES + (2 * STAGES + 2) * 8 + 1024;
};
static_assert(FrontCfg::SMEM <= 232448 && LnCfg::SMEM <= 232448, "a block's shared memory");

// ---------------------------------------------------------------- device side

__device__ __forceinline__ float sigmoid2(float u) {
  return __fdividef(1.f, 1.f + attn::ex2(-2.f * attn::LOG2E * u));
}

// tanh-approximated GELU and its derivative, with tanh(u) = 2 s - 1, s =
// sigmoid(2u) = 1 / (1 + 2^(-2u log2(e))): one ex2.approx and a fast
// division (as csrc/fused_gpt.cu), within a few fp32 ulp of the accurate
// tanh's.  gelu = h s; gelu' = 0.5 (1 + t) + 0.5 h (1 - t^2) du = s + 2 h
// du s (1 - s).  For u below about -44 the power is inf and s = 0.
__device__ __forceinline__ float gelu_tanh(float h) {
  return h * sigmoid2(SQRT_2_OVER_PI * (h + GELU_C * h * h * h));
}

__device__ __forceinline__ float gelu_tanh_grad(float h) {
  const float s = sigmoid2(SQRT_2_OVER_PI * (h + GELU_C * h * h * h));
  const float du = SQRT_2_OVER_PI * (1.f + 3.f * GELU_C * h * h);
  return s + 2.f * h * du * s * (1.f - s);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// the shared::cluster address of `p` (this CTA's shared memory) in rank's
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(gemm::smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(unsigned addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b)
               : "memory");
}

__device__ __forceinline__ void arrive_cluster(unsigned addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}

// gemm::mbar_wait with the cluster's acquire: what other ranks stored before
// their release arrive is visible after it
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, unsigned parity) {
  const unsigned addr = gemm::smem_u32(bar);
  unsigned done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// the two consumer warpgroups' 256 threads
__device__ __forceinline__ void consumers_barrier() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// hact, dh [M, F] from xn2, dxb [M, E], Wfc [E, F], Wfc2 [F, E].  Maps: ta1
// xn2 and ta2 dxb {64, BM}; tb1 Wfc {64, BK}; tb2 Wfc2 {64, BN}; tc1 hact
// and tc2 dh {64, 64}.
__global__ void __launch_bounds__(THREADS, 1)
mlp_front_kernel(const __grid_constant__ CUtensorMap ta1, const __grid_constant__ CUtensorMap tb1,
                 const __grid_constant__ CUtensorMap ta2, const __grid_constant__ CUtensorMap tb2,
                 const __grid_constant__ CUtensorMap tc1, const __grid_constant__ CUtensorMap tc2,
                 int M, int F, int E) {
  using C = FrontCfg;
  constexpr int BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* cbuf = smem + C::STAGES * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(cbuf + C::C_BYTES);
  uint64_t* empty = full + C::STAGES;
  const int wg = threadIdx.x >> 7;
  const int mt = cdiv(M, BM), nt = cdiv(F, BN), ktiles = cdiv(E, BK);
  const int tiles = mt * nt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      gemm::mbar_init(&full[s], 1);
      gemm::mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    gemm::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % nt) * BN, m0 = (tile / nt) * BM;
      for (int kt = 0; kt < ktiles; ++kt) {
        gemm::mbar_wait(&empty[stage], phase ^ 1);
        gemm::mbar_expect_tx(&full[stage], C::STAGE);
        unsigned char* s = smem + stage * C::STAGE;
        const int k0 = kt * BK;
        gemm::tma_load(s, &ta1, &full[stage], k0, m0);
#pragma unroll
        for (int j = 0; j < BN / BOX; ++j)
          gemm::tma_load(s + C::TILE + j * BOX_BYTES, &tb1, &full[stage], n0 + j * BOX, k0);
        gemm::tma_load(s + 2 * C::TILE, &ta2, &full[stage], k0, m0);
        gemm::tma_load(s + 3 * C::TILE, &tb2, &full[stage], k0, n0);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  gemm::setmaxnreg_inc<232>();
  const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const bool lead = (threadIdx.x & 127) == 0;
  int stage = 0, phase = 0;
  float h[BN / 8][4], d[BN / 8][4];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % nt) * BN, m0 = (tile / nt) * BM;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[j][e] = d[j][e] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt) {
      gemm::mbar_wait(&full[stage], phase);
      const unsigned char* s = smem + stage * C::STAGE;
      const unsigned char* a1 = s + cw * 64 * 128;
      const unsigned char* b1 = s + C::TILE;
      const unsigned char* a2 = s + 2 * C::TILE + cw * 64 * 128;
      const unsigned char* b2 = s + 3 * C::TILE;
      wg::fence_operands<BN / 8>(h);
      wg::fence_operands<BN / 8>(d);
      wg::fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        wg::Mma<BN>::template run<0, 1>(h, wg::make_desc_sw128(a1 + k * 32, 16, 1024),
                                        wg::make_desc_sw128(b1 + k * 2048, BOX_BYTES, 1024), 1);
        wg::Mma<BN>::template run<0, 0>(d, wg::make_desc_sw128(a2 + k * 32, 16, 1024),
                                        wg::make_desc_sw128(b2 + k * 32, 16, 1024), 1);
      }
      wg::commit();
      wg::wait<1>();
      wg::fence_operands<BN / 8>(h);
      wg::fence_operands<BN / 8>(d);
      if (prev >= 0 && lane == 0) gemm::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg::wait<0>();
    wg::fence_operands<BN / 8>(h);
    wg::fence_operands<BN / 8>(d);
    if (prev >= 0 && lane == 0) gemm::mbar_arrive(&empty[prev]);

    // hact through the staging buffer (as gemm_kernel's: 64 x 64 boxes in
    // TMA's swizzle), d scaled by gelu'(hmid) meanwhile; then dh through it
    unsigned char* crow = cbuf + cw * (64 * 128) + (warp * 16 + g) * 128;
    if (lead) gemm::bulk_wait<true>();   // the previous tile's dh has left the buffer
    gemm::wg_barrier(1 + cw);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      unsigned char* at = crow + (j >> 3) * (BM * 128) + (((j & 7) ^ g) << 4) + 4 * c;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v0 = h[j][2 * i], v1 = h[j][2 * i + 1];
        *reinterpret_cast<__nv_bfloat162*>(at + i * 8 * 128) =
            __floats2bfloat162_rn(gelu_tanh(v0), gelu_tanh(v1));
        d[j][2 * i] *= gelu_tanh_grad(v0);
        d[j][2 * i + 1] *= gelu_tanh_grad(v1);
      }
    }
    auto store = [&](const CUtensorMap* map) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      gemm::wg_barrier(1 + cw);
      if (lead) {
#pragma unroll
        for (int jb = 0; jb < BN / BOX; ++jb)
          if (n0 + jb * BOX < F)
            gemm::tma_store(map, cbuf + jb * (BM * 128) + cw * (64 * 128), n0 + jb * BOX,
                            m0 + cw * 64);
        gemm::bulk_commit();
      }
    };
    store(&tc1);
    if (lead) gemm::bulk_wait<true>();   // hact has left the buffer
    gemm::wg_barrier(1 + cw);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      unsigned char* at = crow + (j >> 3) * (BM * 128) + (((j & 7) ^ g) << 4) + 4 * c;
      *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(d[j][0], d[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(at + 8 * 128) = __floats2bfloat162_rn(d[j][2], d[j][3]);
    }
    store(&tc2);
  }
  if ((threadIdx.x & 127) == 0) gemm::bulk_wait<false>();
}

// What the LN epilogue reads and writes besides the product: x [M, E] (ldx),
// g [E], the rows' mu and rstd [M]; dx [M, E] fp32 updated, dxb [M, E] bf16,
// partial [row tiles, E].
struct LnArgs {
  const bf16* x;
  long long ldx;
  const float* g;
  const float* mu;
  const float* rs;
  float* dx;
  bf16* dxb;
  float* partial;
  int EL;
};

// dY = A W^T (A [M, K] by map ta {64, BM}, W [E, K] by tb {64, 256}) and the
// LayerNorm backward on it, as the header says; CLUSTER: E spans ranks > 1
// tiles, launched as clusters of that many CTAs.
template <bool CLUSTER>
__global__ void __launch_bounds__(THREADS, 1)
ln_dx_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, int M,
             int E, int K, const LnArgs a) {
  using C = LnCfg;
  constexpr int BN = LN_BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* colsum = reinterpret_cast<float*>(smem + C::STAGES * C::STAGE);   // [2][8][BN]
  float2* xrow = reinterpret_cast<float2*>(smem + C::STAGES * C::STAGE + C::COL_BYTES);
  // xrow [2][LN_MAX_RANKS][BM]: each rank's (sum d, sum d xhat) of a row
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE + C::COL_BYTES +
                                               C::X_BYTES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* xbar = empty + C::STAGES;   // [2]: the ranks' row sums have arrived
  const int wg = threadIdx.x >> 7;
  const int ranks = CLUSTER ? cdiv(E, BN) : 1;
  const int rank = CLUSTER ? (int)cluster_rank() : 0;
  const int n0 = rank * BN;
  const int mt = cdiv(M, BM), ktiles = cdiv(K, BK);
  const int first = blockIdx.x / ranks, step = gridDim.x / ranks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      gemm::mbar_init(&full[s], 1);
      gemm::mbar_init(&empty[s], 8);
    }
    // every rank's 8 consumer warps x 8 quads push a tile's row sums
    gemm::mbar_init(&xbar[0], 64 * ranks);
    gemm::mbar_init(&xbar[1], 64 * ranks);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (CLUSTER)
    cluster_sync();   // every rank's barriers exist before any is arrived on
  else
    __syncthreads();

  if (wg == 0) {
    gemm::setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int stage = 0, phase = 0;
    for (int m = first; m < mt; m += step) {
      for (int kt = 0; kt < ktiles; ++kt) {
        gemm::mbar_wait(&empty[stage], phase ^ 1);
        gemm::mbar_expect_tx(&full[stage], C::STAGE);
        unsigned char* s = smem + stage * C::STAGE;
        gemm::tma_load(s, &ta, &full[stage], kt * BK, m * BM);
        gemm::tma_load(s + C::A_BYTES, &tb, &full[stage], kt * BK, n0);
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  gemm::setmaxnreg_inc<232>();
  const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int cwarp = cw * 4 + warp;          // 0..7
  const int ct = threadIdx.x - 128;         // 0..255
  int stage = 0, phase = 0, it = 0;
  float acc[BN / 8][4];
  for (int m = first; m < mt; m += step, ++it) {
    const int m0 = m * BM;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt) {
      gemm::mbar_wait(&full[stage], phase);
      const unsigned char* s = smem + stage * C::STAGE;
      const unsigned char* ap = s + cw * 64 * 128;
      const unsigned char* bp = s + C::A_BYTES;
      wg::fence_operands<BN / 8>(acc);
      wg::fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        wg::Mma<BN>::template run<0, 0>(acc, wg::make_desc_sw128(ap + k * 32, 16, 1024),
                                        wg::make_desc_sw128(bp + k * 32, 16, 1024), 1);
      wg::commit();
      wg::wait<1>();
      wg::fence_operands<BN / 8>(acc);
      if (prev >= 0 && lane == 0) gemm::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg::wait<0>();
    wg::fence_operands<BN / 8>(acc);
    if (prev >= 0 && lane == 0) gemm::mbar_arrive(&empty[prev]);

    // pass 1: the rows' sums of d and d xhat over this tile's columns, and the
    // columns' sums of dY xhat over the warp's 16 rows
    const int par = it & 1;
    const int rl = cw * 64 + warp * 16 + g;   // the thread's rows rl, rl + 8 of the tile
    float mu[2], rs[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + rl + 8 * i;
      mu[i] = r < M ? a.mu[r] : 0.f;
      rs[i] = r < M ? a.rs[r] : 0.f;
    }
    float* cs = colsum + par * 8 * BN + cwarp * BN;
    constexpr int JC = 8;
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += JC) {
      __nv_bfloat162 xv[JC][2];
      float2 gv[JC];
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int col = n0 + 8 * (j0 + jj) + 2 * c;
        gv[jj] = col < E ? *reinterpret_cast<const float2*>(a.g + col) : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = m0 + rl + 8 * i;
          xv[jj][i] = col < E && r < M
                          ? *reinterpret_cast<const __nv_bfloat162*>(a.x + (size_t)r * a.ldx + col)
                          : __floats2bfloat162_rn(0.f, 0.f);
        }
      }
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int j = j0 + jj, col = n0 + 8 * j + 2 * c;
        float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 xf = __bfloat1622float2(xv[jj][i]);
          const float xh0 = (xf.x - mu[i]) * rs[i], xh1 = (xf.y - mu[i]) * rs[i];
          const float dy0 = acc[j][2 * i], dy1 = acc[j][2 * i + 1];
          if (col < a.EL) {
            const float d0 = dy0 * gv[jj].x;
            s1[i] += d0;
            s2[i] += d0 * xh0;
          }
          if (col + 1 < a.EL) {
            const float d1 = dy1 * gv[jj].y;
            s1[i] += d1;
            s2[i] += d1 * xh1;
          }
          cs0 += dy0 * xh0;
          cs1 += dy1 * xh1;
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
          cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
        }
        if (g == 0) *reinterpret_cast<float2*>(cs + 8 * j + 2 * c) = make_float2(cs0, cs1);
      }
    }
    // pass 2's chunks of g, x and dx; in a cluster the first goes out
    // before the row sums are exchanged, so the exchange hides its trip to
    // memory (a CTA that owns whole rows ran no faster for it on the card)
    __nv_bfloat162 xv[JC][2];
    float2 gv[JC], dv[JC][2];
    auto load_chunk = [&](int j0) {
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int col = n0 + 8 * (j0 + jj) + 2 * c;
        gv[jj] = col < E ? *reinterpret_cast<const float2*>(a.g + col) : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = m0 + rl + 8 * i;
          const bool in = col < E && r < M;
          xv[jj][i] = in ? *reinterpret_cast<const __nv_bfloat162*>(a.x + (size_t)r * a.ldx + col)
                         : __floats2bfloat162_rn(0.f, 0.f);
          dv[jj][i] = in ? *reinterpret_cast<const float2*>(a.dx + (size_t)r * E + col)
                         : make_float2(0.f, 0.f);
        }
      }
    };
    if (CLUSTER) load_chunk(0);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], o);
        s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], o);
      }
    float m1[2], m2[2];
    if constexpr (CLUSTER) {
      // push this rank's row sums to every rank, then add all ranks' in order
      float2* slot = xrow + (par * LN_MAX_RANKS + rank) * BM;
      if (c == 0) {
        for (int k = 0; k < ranks; ++k) {
          st_cluster(map_rank(slot + rl, k), s1[0], s2[0]);
          st_cluster(map_rank(slot + rl + 8, k), s1[1], s2[1]);
          arrive_cluster(map_rank(&xbar[par], k));
        }
      }
      mbar_wait_cluster(&xbar[par], (it >> 1) & 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float t1 = 0.f, t2 = 0.f;
        for (int k = 0; k < ranks; ++k) {
          const float2 v = xrow[(par * LN_MAX_RANKS + k) * BM + rl + 8 * i];
          t1 += v.x;
          t2 += v.y;
        }
        m1[i] = t1 / a.EL;
        m2[i] = t2 / a.EL;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m1[i] = s1[i] / a.EL;
        m2[i] = s2[i] / a.EL;
      }
    }

    // pass 2: dx += (d - m1 - xhat m2) rstd, dxb = bf16(dx)
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += JC) {
      if (j0 > 0 || !CLUSTER) load_chunk(j0);
#pragma unroll
      for (int jj = 0; jj < JC; ++jj) {
        const int j = j0 + jj, col = n0 + 8 * j + 2 * c;
        if (col >= E) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = m0 + rl + 8 * i;
          if (r >= M) continue;
          const float2 xf = __bfloat1622float2(xv[jj][i]);
          const float xh0 = (xf.x - mu[i]) * rs[i], xh1 = (xf.y - mu[i]) * rs[i];
          const float d0 = acc[j][2 * i] * gv[jj].x, d1 = acc[j][2 * i + 1] * gv[jj].y;
          float2 v = dv[jj][i];
          if (col < a.EL) v.x = v.x + (d0 - m1[i] - xh0 * m2[i]) * rs[i];
          if (col + 1 < a.EL) v.y = v.y + (d1 - m1[i] - xh1 * m2[i]) * rs[i];
          *reinterpret_cast<float2*>(a.dx + (size_t)r * E + col) = v;
          *reinterpret_cast<__nv_bfloat162*>(a.dxb + (size_t)r * E + col) =
              __floats2bfloat162_rn(v.x, v.y);
        }
      }
    }

    // the tile's gain partial: the 8 warps' column sums in order
    consumers_barrier();
    {
      const float* cp = colsum + par * 8 * BN;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) v += cp[w * BN + ct];
      if (n0 + ct < E) a.partial[(size_t)m * E + n0 + ct] = v;
    }
  }
}

// ------------------------------------------------------------------ host side

inline int sms() { return gemm::sm_count(); }

// hact, dh from xn2, dxb [M, E], Wfc [E, F], Wfc2 [F, E], all rows dense.
inline cudaError_t mlp_front(const bf16* xn2, const bf16* dxb, const bf16* wfc, const bf16* wfc2,
                             bf16* hact, bf16* dh, int M, int E, int F, cudaStream_t stream) {
  if (M < 1 || E < 1 || F < 1 || (E & 7) || (F & 7)) return cudaErrorInvalidValue;
  CUtensorMap ta1, tb1, ta2, tb2, tc1, tc2;
  cudaError_t err = gemm::make_map(&ta1, xn2, M, E, E, BM);
  if (err == cudaSuccess) err = gemm::make_map(&tb1, wfc, E, F, F, BK);
  if (err == cudaSuccess) err = gemm::make_map(&ta2, dxb, M, E, E, BM);
  if (err == cudaSuccess) err = gemm::make_map(&tb2, wfc2, F, E, E, FrontCfg::BN);
  if (err == cudaSuccess) err = gemm::make_map(&tc1, hact, M, F, F, 64);
  if (err == cudaSuccess) err = gemm::make_map(&tc2, dh, M, F, F, 64);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlp_front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FrontCfg::SMEM);
  if (err != cudaSuccess) return err;
  const int work = cdiv(M, BM) * cdiv(F, FrontCfg::BN);
  const int grid = work < sms() ? work : sms();
  mlp_front_kernel<<<grid, THREADS, FrontCfg::SMEM, stream>>>(ta1, tb1, ta2, tb2, tc1, tc2, M, F,
                                                              E);
  return cudaGetLastError();
}

// dY = A W^T (A [M, K], W [E, K] dense) with the LayerNorm backward in the
// epilogue; E must take the route (ln_ranks(E) > 0).
inline cudaError_t ln_dx(const bf16* A, const bf16* W, int M, int E, int K, const LnArgs& args,
                         cudaStream_t stream) {
  const int ranks = ln_ranks(E);
  if (M < 1 || E < 1 || K < 1 || (E & 7) || (K & 7) || ranks == 0 || args.EL < 1 ||
      args.EL > E)
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t err = gemm::make_map(&ta, A, M, K, K, BM);
  if (err == cudaSuccess) err = gemm::make_map(&tb, W, E, K, K, LN_BN);
  if (err != cudaSuccess) return err;
  const int mt = cdiv(M, BM);
  if (ranks == 1) {
    err = cudaFuncSetAttribute(ln_dx_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               LnCfg::SMEM);
    if (err != cudaSuccess) return err;
    const int grid = mt < sms() ? mt : sms();
    ln_dx_kernel<false><<<grid, THREADS, LnCfg::SMEM, stream>>>(ta, tb, M, E, K, args);
    return cudaGetLastError();
  }
  err = cudaFuncSetAttribute(ln_dx_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             LnCfg::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = LnCfg::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(ranks * (mt < sms() ? mt : sms()));
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, ln_dx_kernel<true>, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(ranks * (mt < clusters ? mt : clusters));
  return cudaLaunchKernelEx(&cfg, ln_dx_kernel<true>, ta, tb, M, E, K, args);
}

}  // namespace tbg
