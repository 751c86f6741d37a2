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
//   The epilogue's traffic moves by TMA, beside the products: after a tile's
//   k-tiles the producer loads the tile's x (bf16) and dx (fp32) through
//   the same ring, a stage a chunk of 64 columns (128 x 64 x (2 + 4) bytes
//   is a k-tile's 48 KB), as the last k-tiles free their stages; the two
//   passes read them from shared memory, pass 2 writes dx and dxb over them
//   in place, and a storer warp of the producer's warpgroup stores each
//   chunk by TMA and frees its stage once the store has read it, so the
//   next tile's k-tiles load while the stores drain, then adds the gain
//   partial from the warps' column sums.  The consumers start no bulk copy:
//   with TMA stores among them ptxas held them to 168 registers and they
//   spilled; without, the epilogue has the 232 that setmaxnreg allows.
//   Shared memory: the four 48 KB stages, the warps' column sums (2 x 8 KB),
//   the ranks' row sums (2 x 8 KB), g (1 KB), barriers: 231,536 of 232,448
//   bytes.  A tile's epilogue moves 448 KB: x 64 KB read once, dx 128 KB in
//   and 128 KB out, dxb 64 KB out.
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

// Four stages of a k-tile of A and W each; after a tile's k-tiles the same
// ring carries its epilogue's chunks, a stage one: x [128 rows][64] bf16 and
// dx [128][2 x 32] fp32, three regions of 128 rows of 128 bytes (TMA's
// 128-byte swizzle).  Pass 1 reads all four chunks at once, so the ring holds
// at least CHUNKS stages.
constexpr int LN_CHUNK = 64;
struct LnCfg {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE = A_BYTES + LN_BN * BK * 2;
  static constexpr int STAGES = 4;
  static constexpr int CHUNKS = LN_BN / LN_CHUNK;
  static constexpr int REGION = BM * 128;
  static constexpr int COL_BYTES = 2 * 8 * LN_BN * 4;              // 8 warps' column sums, x2
  static constexpr int X_BYTES = 2 * LN_MAX_RANKS * BM * 8;        // ranks' row sums, x2
  static constexpr int G_BYTES = LN_BN * 4;                        // g of the tile's columns
  static constexpr int SMEM =
      STAGES * STAGE + COL_BYTES + X_BYTES + (2 * STAGES + 2 + CHUNKS) * 8 + G_BYTES + 1024;
};
static_assert(3 * LnCfg::REGION == LnCfg::STAGE && LnCfg::STAGES >= LnCfg::CHUNKS,
              "an epilogue chunk fills a ring stage, and the ring holds a tile's chunks");
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
// partial [row tiles, E].  x, dx and dxb move by TMA (the launcher's maps).
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

// the thread's bulk stores but the newest group have read their shared memory
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// `count` arrivals on the barrier at once
__device__ __forceinline__ void mbar_arrive_n(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(gemm::smem_u32(bar)),
               "r"(count)
               : "memory");
}

// dY = A W^T (A [M, K] by map ta {64, BM}, W [E, K] by tb {64, 256}) and the
// LayerNorm backward on it, as the header says; x by tx {64, 64}, dx by tdx
// {32, 64} (fp32, loaded and stored), dxb by tdxb {64, 64}.  CLUSTER: E spans
// ranks > 1 tiles, launched as clusters of that many CTAs.
template <bool CLUSTER>
__global__ void __launch_bounds__(THREADS, 1)
ln_dx_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
             const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdx,
             const __grid_constant__ CUtensorMap tdxb, int M, int E, int K, const LnArgs a) {
  using C = LnCfg;
  constexpr int BN = LN_BN, HALF = C::REGION / 2;   // a warpgroup's 64 rows of a region
  extern __shared__ unsigned char smem_raw[];
  // aligned by pointer arithmetic, so the compiler keeps the shared space
  unsigned char* smem = smem_raw + ((1024 - (gemm::smem_u32(smem_raw) & 1023)) & 1023);
  float* colsum = reinterpret_cast<float*>(smem + C::STAGES * C::STAGE);   // [2][8][BN]
  float2* xrow = reinterpret_cast<float2*>(smem + C::STAGES * C::STAGE + C::COL_BYTES);
  // xrow [2][LN_MAX_RANKS][BM]: each rank's (sum d, sum d xhat) of a row
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE + C::COL_BYTES +
                                               C::X_BYTES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* xbar = empty + C::STAGES;   // [2]: the ranks' row sums have arrived
  uint64_t* done = xbar + 2;            // [CHUNKS]: the consumers have written chunk q's outputs
  float* gsm = reinterpret_cast<float*>(done + C::CHUNKS);   // [BN]: the rank's g, 0 past E
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
    for (int q = 0; q < C::CHUNKS; ++q) gemm::mbar_init(&done[q], 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (CLUSTER)
    cluster_sync();   // every rank's barriers exist before any is arrived on
  else
    __syncthreads();

  if (wg == 0) {
    // the producer: a tile's k-tiles, then its epilogue chunks through the
    // same ring (the boxes that hold no row or column are not loaded)
    gemm::setmaxnreg_dec<40>();
    if ((threadIdx.x >> 5) == 1) {
      // the storer warp: each chunk's dxb and dx by TMA once the consumers
      // have written them, its stage freed once those stores have read it;
      // then the tile's gain partial
      const int lane = threadIdx.x & 31;
      int it = 0, seq = 0;   // ring positions: ktiles + CHUNKS a tile
      for (int m = first; m < mt; m += step, ++it) {
        seq += ktiles;
        for (int q = 0; q < C::CHUNKS; ++q) {
          const int col = n0 + q * LN_CHUNK;
          unsigned char* s = smem + ((seq + q) % C::STAGES) * C::STAGE;
          gemm::mbar_wait(&done[q], it & 1);
          if (lane == 0) {
            for (int h = 0; h < 2; ++h) {
              const int r = m * BM + 64 * h;
              if (col < E && r < M) {
                gemm::tma_store(&tdxb, s + h * HALF, col, r);
                gemm::tma_store(&tdx, s + C::REGION + h * HALF, col, r);
                if (col + 32 < E) gemm::tma_store(&tdx, s + 2 * C::REGION + h * HALF, col + 32, r);
              }
            }
            gemm::bulk_commit();
            if (q > 0) {
              bulk_wait_read_all_but_one();
              mbar_arrive_n(&empty[(seq + q - 1) % C::STAGES], 8);
            }
          }
          __syncwarp();
        }
        // the 8 warps' column sums in order: each warp's pass 1 came before
        // its arrival on done
        const float* cp = colsum + (it & 1) * 8 * BN;
        for (int col = lane; col < BN; col += 32) {
          float v = 0.f;
#pragma unroll
          for (int w = 0; w < 8; ++w) v += cp[w * BN + col];
          if (n0 + col < E) a.partial[(size_t)m * E + n0 + col] = v;
        }
        __syncwarp();
        if (lane == 0) {
          gemm::bulk_wait<true>();
          mbar_arrive_n(&empty[(seq + C::CHUNKS - 1) % C::STAGES], 8);
        }
        __syncwarp();
        seq += C::CHUNKS;
      }
      if (lane == 0) gemm::bulk_wait<false>();
      return;
    }
    if (threadIdx.x != 0) return;
    int stage = 0, phase = 0;
    auto next = [&] {
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    for (int m = first; m < mt; m += step) {
      for (int kt = 0; kt < ktiles; ++kt) {
        gemm::mbar_wait(&empty[stage], phase ^ 1);
        gemm::mbar_expect_tx(&full[stage], C::STAGE);
        unsigned char* s = smem + stage * C::STAGE;
        gemm::tma_load(s, &ta, &full[stage], kt * BK, m * BM);
        gemm::tma_load(s + C::A_BYTES, &tb, &full[stage], kt * BK, n0);
        next();
      }
      const int halves = m * BM + 64 < M ? 2 : 1;
      for (int q = 0; q < C::CHUNKS; ++q) {
        const int col = n0 + q * LN_CHUNK;
        const int regions = col >= E ? 0 : col + 32 < E ? 3 : 2;   // x, dx's two column halves
        gemm::mbar_wait(&empty[stage], phase ^ 1);
        gemm::mbar_expect_tx(&full[stage], halves * regions * HALF);
        unsigned char* s = smem + stage * C::STAGE;
        for (int h = 0; h < halves; ++h) {
          const int r = m * BM + 64 * h;
          if (regions > 0) gemm::tma_load(s + h * HALF, &tx, &full[stage], col, r);
          for (int d = 0; d + 1 < regions; ++d)
            gemm::tma_load(s + (1 + d) * C::REGION + h * HALF, &tdx, &full[stage], col + 32 * d, r);
        }
        next();
      }
    }
    return;
  }

  gemm::setmaxnreg_inc<232>();
  const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int cwarp = cw * 4 + warp;          // 0..7
  const int ct = threadIdx.x - 128;         // 0..255
  const int rw = warp * 16 + g;             // the thread's rows rw, rw + 8 of its warpgroup's 64
  const int rl = cw * 64 + rw;              // ... and of the tile
  gsm[ct] = n0 + ct < E ? a.g[n0 + ct] : 0.f;
  consumers_barrier();
  int stage = 0, phase = 0, it = 0;
  float acc[BN / 8][4];
  for (int m = first; m < mt; m += step, ++it) {
    const int m0 = m * BM;
    // the rows' mu and rstd, read while the products run; 0 past M, where
    // pass 1 takes x as 0 too (a 64-row half past M is not loaded)
    bool in[2];
    float mu[2], rs[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = m0 + rl + 8 * i;
      in[i] = r < M;
      mu[i] = in[i] ? a.mu[r] : 0.f;
      rs[i] = in[i] ? a.rs[r] : 0.f;
    }
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

    // The epilogue's chunks q = 0..3 (columns n0 + 64 q ..) lie in the next
    // four stages.  In a region a row is 128 bytes whose 16-byte pieces sit
    // at piece ^ (row & 7), and row & 7 = g: x's piece of n8 tile jl is jl,
    // dx's is 2 (jl & 3) + (c >> 1) of region 1 + (jl >> 2); a warp's reads
    // and writes touch each bank once (x) or twice (dx, 256 bytes).
    const int st0 = stage;
    auto chunk = [&](int q) {
      return smem + ((st0 + q) % C::STAGES) * C::STAGE + cw * HALF + rw * 128;
    };
    auto x_at = [&](unsigned char* p, int jl, int i) {
      return reinterpret_cast<__nv_bfloat162*>(p + i * 1024 + ((jl ^ g) << 4) + 4 * c);
    };
    auto dx_at = [&](unsigned char* p, int jl, int i) {
      return reinterpret_cast<float2*>(p + (1 + (jl >> 2)) * C::REGION + i * 1024 +
                                       (((2 * (jl & 3) + (c >> 1)) ^ g) << 4) + 8 * (c & 1));
    };

    // pass 1: the rows' sums of d and d xhat over this tile's columns, and the
    // columns' sums of dY xhat over the warp's 16 rows; two n8 tiles at a
    // time, their x and g read first
    const int par = it & 1;
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
    float* cs = colsum + par * 8 * BN + cwarp * BN;
#pragma unroll
    for (int q = 0; q < C::CHUNKS; ++q) {
      gemm::mbar_wait(&full[stage], phase);
      unsigned char* p = chunk(q);
#pragma unroll
      for (int jl = 0; jl < LN_CHUNK / 8; jl += 2) {
        const int j0 = q * (LN_CHUNK / 8) + jl;
        float2 xf[2][2], gv[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          gv[jj] = *reinterpret_cast<const float2*>(gsm + 8 * (j0 + jj) + 2 * c);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            xf[jj][i] = in[i] ? __bfloat1622float2(*x_at(p, jl + jj, i)) : make_float2(0.f, 0.f);
        }
        float v[4];   // the four columns' dY xhat over the thread's two rows
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = j0 + jj, col = n0 + 8 * j + 2 * c;
          float cs0 = 0.f, cs1 = 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float xh0 = (xf[jj][i].x - mu[i]) * rs[i], xh1 = (xf[jj][i].y - mu[i]) * rs[i];
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
          v[2 * jj] = cs0;
          v[2 * jj + 1] = cs1;
        }
        // each column's sum over the warp's eight quads in the xor-shuffles'
        // tree, ((g0 + g1) + (g2 + g3)) + ((g4 + g5) + (g6 + g7)), with the
        // values halved at the first two steps: lanes g and g + 4 end with
        // value g & 3's
        const bool b0 = lane & 4, b1 = lane & 8;
        const float w0 = (b0 ? v[1] : v[0]) + __shfl_xor_sync(0xffffffffu, b0 ? v[0] : v[1], 4);
        const float w1 = (b0 ? v[3] : v[2]) + __shfl_xor_sync(0xffffffffu, b0 ? v[2] : v[3], 4);
        float z = (b1 ? w1 : w0) + __shfl_xor_sync(0xffffffffu, b1 ? w0 : w1, 8);
        z += __shfl_xor_sync(0xffffffffu, z, 16);
        if (g < 4) cs[8 * (j0 + (g >> 1)) + 2 * c + (g & 1)] = z;
      }
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
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

    // pass 2, a chunk at a time: dx += (d - m1 - xhat m2) rstd in dx's place
    // in the stage and dxb = bf16(dx) in x's; each warp then tells the storer
#pragma unroll
    for (int q = 0; q < C::CHUNKS; ++q) {
      unsigned char* p = chunk(q);
#pragma unroll
      for (int jl = 0; jl < LN_CHUNK / 8; ++jl) {
        const int j = q * (LN_CHUNK / 8) + jl, col = n0 + 8 * j + 2 * c;
        const float2 gv = *reinterpret_cast<const float2*>(gsm + 8 * j + 2 * c);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          __nv_bfloat162* xp = x_at(p, jl, i);
          float2* dp = dx_at(p, jl, i);
          const float2 xf = __bfloat1622float2(*xp);
          const float xh0 = (xf.x - mu[i]) * rs[i], xh1 = (xf.y - mu[i]) * rs[i];
          const float d0 = acc[j][2 * i] * gv.x, d1 = acc[j][2 * i + 1] * gv.y;
          float2 v = *dp;
          if (col < a.EL) v.x = v.x + (d0 - m1[i] - xh0 * m2[i]) * rs[i];
          if (col + 1 < a.EL) v.y = v.y + (d1 - m1[i] - xh1 * m2[i]) * rs[i];
          *dp = v;
          *xp = __floats2bfloat162_rn(v.x, v.y);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) gemm::mbar_arrive(&done[q]);
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

// A tensor map over a row-major fp32 matrix [rows, cols] (rows ld elements
// apart), boxes of {32 columns, box_rows rows}, as gemm::make_map's: 128-byte
// rows, swizzled, zero fill past its edges.
inline cudaError_t make_map_f32(CUtensorMap* map, const float* p, int rows, int cols,
                                long long ld, int box_rows) {
  const gemm::EncodeTiled enc = gemm::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(p) & 15) || (ld & 3) || rows < 1 || cols < 1)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims,
                         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// dY = A W^T (A [M, K], W [E, K] dense) with the LayerNorm backward in the
// epilogue; E must take the route (ln_ranks(E) > 0).
inline cudaError_t ln_dx(const bf16* A, const bf16* W, int M, int E, int K, const LnArgs& args,
                         cudaStream_t stream) {
  const int ranks = ln_ranks(E);
  if (M < 1 || E < 1 || K < 1 || (E & 7) || (K & 7) || ranks == 0 || args.EL < 1 ||
      args.EL > E)
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb, tx, tdx, tdxb;
  cudaError_t err = gemm::make_map(&ta, A, M, K, K, BM);
  if (err == cudaSuccess) err = gemm::make_map(&tb, W, E, K, K, LN_BN);
  if (err == cudaSuccess) err = gemm::make_map(&tx, args.x, M, E, args.ldx, 64);
  if (err == cudaSuccess) err = make_map_f32(&tdx, args.dx, M, E, E, 64);
  if (err == cudaSuccess) err = gemm::make_map(&tdxb, args.dxb, M, E, E, 64);
  if (err != cudaSuccess) return err;
  const int mt = cdiv(M, BM);
  if (ranks == 1) {
    err = cudaFuncSetAttribute(ln_dx_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               LnCfg::SMEM);
    if (err != cudaSuccess) return err;
    const int grid = mt < sms() ? mt : sms();
    ln_dx_kernel<false><<<grid, THREADS, LnCfg::SMEM, stream>>>(ta, tb, tx, tdx, tdxb, M, E, K,
                                                                args);
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
  return cudaLaunchKernelEx(&cfg, ln_dx_kernel<true>, ta, tb, tx, tdx, tdxb, M, E, K, args);
}

}  // namespace tbg
