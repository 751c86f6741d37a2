// Fused GPT forward for Hopper (sm_90a): tokens [N, T] -> last-position
// logits [N, vocab] in one launch, for any T from 1 to 256.  Built with no
// defines for the 2M (E=160, 5 heads) and the 6M (E=256, 8 heads); built with
// -DFUSED_GPT_E=<E> -DFUSED_GPT_H=<heads> for that one width instead
// (ops/fused_gpt.py checks the shape rules of Fwd's static_asserts before
// nvcc starts).
// Any number of heads with a head dim that is a multiple of 16 from 16 to
// 128, and E up to 256.
//
// Replaces the TPU kernel mapf_gpt_tpu/ops/fused_gpt.py::_e2e_kernel and
// computes what it computes:
//   embedding  x = bf16(wte[tok] + wpe[t])                    (bf16 tables; an id
//                                                              outside the vocabulary
//                                                              embeds as wpe alone)
//   per layer  xn = bf16(LN(x) * g1)                          (fp32, two-pass, eps 1e-5)
//              q|k|v = bf16(xn @ Wqkv)                        (attention scale * log2(e)
//                                                              folded into W_q)
//              per head: e = bf16(exp2(min(q k^T, 100)))      (no max subtraction)
//                        att = bf16((e @ v) * (1 / sum e))    (the sum of the rounded e)
//              x = bf16(x + bf16(att @ Wproj))
//              x = bf16(x + bf16(gelu_tanh(bf16(bf16(LN(x) * g2) @ Wfc)) @ Wfc2))
//   the last layer is thinned: K/V over all T positions, but Q, attention,
//   projection and MLP for position T-1 only (the only row the head reads);
//   then fp32 LN and the tied head in fp32.
// bf16 between ops, fp32 accumulation; the plain PyTorch version of the same
// arithmetic is mapf_gpt_tpu_torch/ops/fused_gpt.py::fused_logits_reference.
//
// Bound on an H100 SXM at N = 8192 contexts, T = 256 (the rollout benchmark's
// batch): the 2M needs 6.75 TFLOP of bf16 products (4 full layers at 199
// MFLOP a context, the thinned fifth at 27 MFLOP) -> 6.8 ms at 989 TFLOP/s,
// against 13.8 MB of tokens, weights and logits -> 4.1 us at 3.35 TB/s; the
// 6M needs 27.5 TFLOP (7 full layers at 470 MFLOP, the thinned eighth at 68
// MFLOP) -> 27.8 ms.  Both are bound by operations: the design keeps every
// intermediate on chip or in L2 and feeds the tensor cores from shared
// memory and registers.
//
// Design (one CTA of 8 warps per SM, persistent over contexts; a context's
// rows in two halves of 128, warp w owning rows 16w .. 16w + 15 of each half
// and warpgroup w / 4 rows 64 (w / 4) .. + 63):
//   * weights through shared memory: every product streams its weight tiles
//     through a ring of STAGES (4) slots filled by cp.async, STAGES - 1
//     tiles ahead of the tile in use, one __syncthreads a tile.  Every warp
//     reads the same slot for its own rows, so a weight byte crosses L2 once
//     per half-context and serves 128 rows: about 0.18 TB of weights
//     through L2 at the 6M and N = 8192, where reading every B fragment
//     from L2 once per warp and 16 rows would move about 1.6 TB.
//   * q|k|v and the projection by wgmma: each warpgroup issues
//     m64n128k16 products for its 64 rows, A (the LN1 rows, or the attention
//     rows copied in by cp.async) and B (a [64 x 128] tile of Wqkv or Wproj)
//     both read by the tensor cores from shared memory through matrix
//     descriptors (wgmma.cuh).  sA is kept in wgmma's K-major core-matrix
//     layout (8 rows x 16 bytes a core matrix), and the weight tiles are
//     copied in the MN-major one, 16 bytes of a weight row a cp.async, so
//     the [k][n] weights go in as they are;
//   * the MLP by mma.sync m16n8k16 (attn_tile.cuh's helpers), a warp's 16
//     rows: A by ldmatrix from sA (each 8 x 8 matrix one core matrix), B by
//     ldmatrix from [E x FC] tiles of Wfc and [FC x E] tiles of Wfc2
//     (row-major, 8 columns of padding against bank conflicts; FC = 64 hidden
//     columns at E <= 192, 32 above).  The fc chunk (16 rows x FC) is
//     rounded, put through GELU and
//     repacked from its C fragments into fc2's A fragments; the fc2 sums
//     (16 rows x E, E / 2 registers a lane) stay in registers over all 4E
//     hidden columns.  As wgmma products (fc2 sums in wgmma accumulators)
//     the 6M's MLP spilled registers and ran slower;
//   * epilogues run on the accumulators in registers: q|k|v rounded to bf16
//     and stored to the CTA's workspace (through a small per-warp stage, 16
//     bytes a lane, after the rounding); the residual adds read and write
//     the warp's rows of the stream in shared memory;
//   * attention streams keys: per head, K and V of all T positions are
//     staged by cp.async from the workspace into shared memory once per
//     context (double-buffered: head h + 1 loads while head h runs, where
//     two buffers fit), and every warp runs its 16-row blocks against them:
//     Q as A fragments straight from the workspace, scores of 64 keys in
//     registers, e = bf16(exp2(min(s, 100))) summed as rounded and repacked
//     as the A fragments of P V; no running max, no second pass, no rescale
//     (not attn_tile.cuh's forward, which normalises p before rounding);
//   * keys at or past T are masked (e = 0, K and V rows zero-filled), rows
//     past T are computed on finite padding and never read; a warpgroup
//     whose rows all lie past T skips its products;
//   * the thinned last layer's row T-1 and the head run as fp32 dot products
//     over the CTA, weights from L2 (one row a context): 8 columns a thread
//     by 16-byte loads, the depth split in ranges added in a fixed order;
//   * tanh GELU as x * sigmoid(2u) (one ex2.approx and a fast division,
//     within a few fp32 ulp of the accurate tanh's; see gelu_tanh).
// Budgets (shared memory a block can have: 232,448 bytes; 255 registers a
// thread at one CTA of 256 threads an SM):
//   6M, E=256: the stream of one half (128 x 264 bf16, 67,584 B; the other
//     half parks in the workspace and the two swap twice a layer: 16-byte
//     stores out, cp.async in), sA 128 x 256 bf16 = 65,536 B, the ring
//     4 x 20,480 B = 81,920 B, the warps' q|k|v store stages 8 x 16 x 40
//     bf16 = 10,240 B: 225,280 B.  K and V of a head (2 x 256 x 40 bf16,
//     40,960 B, two buffers) alias sA and the ring, and so does the thin
//     path's fp32 scratch (27,680 B).  Registers: fc2 sums 128 a lane (16
//     rows x 256 fp32 a warp; 128 KiB for the 8 warps' 128 rows, half the
//     register file), the fc chunk 16, its A fragments 8; the q|k|v and
//     projection accumulators 64 (a 64 x 128 tile a warpgroup).
//   2M, E=160: the whole stream stays (256 x 168 bf16, 86,016 B; no swap),
//     sA 40,960 B, the ring 4 x 23,040 B (MLP tiles of 64 hidden columns),
//     the store stages 10,240 B: 229,376 B; fc2 sums 80 registers, the fc
//     chunk 32, its A fragments 16.
//   E above 256 would take fc2 sums over 128 registers a lane beside the rest;
//   ops/fused_gpt.py::cuda_plan sends such widths to the layer-stack kernel.
//   More warps would each get fewer than 255 registers (16 warps: 128), less
//   than the 6M's fc2 sums alone; the 8 warps keep several loads and
//   products in flight each instead.
// Workspace per CTA: q|k|v [256, 3E] bf16 (Q's columns are overwritten by
// the attention output) and, where the stream does not stay, two parking
// slots [128, E] (the parked half, and the slot the next swap writes):
// 512 KiB at the 6M (69 MB over 132 CTAs; L2 holds 50 MB), 240 KiB at the
// 2M (32 MB).
// Grid: min(N, SMs) CTAs, each walking contexts c = blockIdx.x, + gridDim.x,
// ...: at N = 8192 on 132 SMs, 8 CTAs take 63 contexts and 124 take 62 (62.06
// a CTA on average: 98.5 % of the last wave busy); at the rollout's N = 512,
// 116 CTAs take 4 and 16 take 3 (3.88 on average, 97 %).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_gpt.so fused_gpt.cu   (ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "wgmma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TMAX = 256;        // longest context
constexpr int HALF = 128;        // rows of a half-context: 16 a warp
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_VOCAB = THREADS;
constexpr float EXP2_CLAMP = 100.f;
constexpr float LN_EPS = 1e-5f;
constexpr int SMEM_LIMIT = 232448;
constexpr int KS = 64;           // K-slab rows of a Wqkv / Wproj tile
constexpr int NT = 128;          // columns of a Wqkv / Wproj tile
constexpr int KC = 64;           // keys of an attention chunk
constexpr int MAX_STAGES = 4;
constexpr int EPI_LD = 40;       // row stride of a warp's q|k|v store stage (32 columns)
constexpr int EPI_BYTES = WARPS * 16 * EPI_LD * 2;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// tanh-approximated GELU, 0.5 x (1 + tanh(u)) written as x * sigmoid(2u) =
// x / (1 + 2^(-2u log2(e))): one ex2.approx (relative error about 2^-22) and
// a fast division, so the result stays within a few fp32 ulp of the
// accurate tanh's, with no cancellation in the negative tail (where
// 1 + tanh(u) is small).  For u below about -44 the power is inf and the
// result -0.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;           // sqrt(2 / pi)
  const float k1 = -2.f * 1.4426950408889634f;    // -2 log2(e)
  const float u = k0 * (x + 0.044715f * x * x * x);
  return __fdividef(x, 1.f + attn::ex2(k1 * u));
}

// Two bf16 of the workspace, read through L2 (the CTA wrote them).
__device__ __forceinline__ unsigned ldcg32(const bf16* p) {
  return __ldcg(reinterpret_cast<const unsigned*>(p));
}

__device__ __forceinline__ void st32(bf16* p, float lo, float hi) {
  *reinterpret_cast<unsigned*>(p) = attn::pack_bf16(lo, hi);
}

// 8 consecutive bf16 <-> 8 floats (16-byte aligned addresses).
__device__ __forceinline__ void load8(const bf16* src, float v[8]) {
  uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* dst, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

template <int N>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// rows x cols bf16 of a row-major matrix (rows ld apart) -> dst (rows lds
// apart) by cp.async, 16 bytes a thread, the CTA's threads in turn.
__device__ __forceinline__ void copy_tile(bf16* dst, int lds, const bf16* src, long long ld,
                                          int rows, int cols) {
  const int vec = cols >> 3;
  for (int i = threadIdx.x; i < rows * vec; i += THREADS) {
    const int r = i / vec, c = (i - r * vec) * 8;
    attn::cp_async16(dst + r * lds + c, src + r * ld + c);
  }
}

// The weight ring: n tiles, load(i, slot) issues tile i's cp.async into a
// slot, use(i, slot) consumes it.  STAGES - 1 tiles are in flight ahead of
// the one in use; the barrier of iteration i also frees the slot that
// iteration i - 1 read, which tile i + STAGES - 1 then fills.  Every thread
// commits one group an iteration (empty past the end), so the wait counts
// hold; a group committed just before the call (the A rows of a product)
// completes with tile 0.
template <int STAGES, int STAGE_BYTES, class Load, class Use>
__device__ __forceinline__ void pipeline(unsigned char* ring, int n, Load load, Use use) {
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, reinterpret_cast<bf16*>(ring + s * STAGE_BYTES));
    attn::cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    attn::cp_async_wait<STAGES - 2>();
    wg::fence_proxy();   // cp.async and st.shared writes, before wgmma reads them
    __syncthreads();
    const int j = i + STAGES - 1;
    if (j < n) load(j, reinterpret_cast<bf16*>(ring + (j % STAGES) * STAGE_BYTES));
    attn::cp_async_commit();
    use(i, reinterpret_cast<const bf16*>(ring + (i % STAGES) * STAGE_BYTES));
  }
  attn::cp_async_wait<0>();
  __syncthreads();
}

// rows x cols bf16 of a row-major matrix (rows ld apart; rows and cols
// multiples of 8) -> the MN-major core-matrix layout at dst (wgmma's B
// operand): 16 bytes of row k and columns 8n .. 8n + 7 at byte
// (n * sbo + k / 8 * 128 + k % 8 * 16), sbo the stride of 8-column groups.
// Eight lanes write one core matrix (128 contiguous bytes) and the next
// eight the next 8 columns of the same rows, so each warp reads whole
// sectors; by cp.async, the CTA's threads in turn.
__device__ __forceinline__ void copy_tile_mn(bf16* dst, int sbo, const bf16* src, long long ld,
                                             int rows, int cols) {
  const int ng = cols >> 3;
  for (int i = threadIdx.x; i < rows * ng; i += THREADS) {
    const int r = i & 7, q = i >> 3, n = q % ng, k = (q / ng) * 8 + r;
    attn::cp_async16(reinterpret_cast<unsigned char*>(dst) + n * sbo + (k >> 3) * 128 + r * 16,
                     src + k * ld + n * 8);
  }
}

// The forward for one width: E, H heads.  Fwd<...>::forward is the body of
// fused_gpt_kernel<Fwd<...>>.
template <int E_, int H_>
struct Fwd {
  static constexpr int E = E_;
  static constexpr int H = H_;
  static constexpr int DH = E / H;               // head dim
  static constexpr int E3 = 3 * E;               // q|k|v width
  static constexpr int F = 4 * E;                // MLP hidden width
  // hidden columns of an MLP chunk: 64 where the fc2 sums leave the
  // registers (E <= 192), 32 above
  static constexpr int FC = E <= 192 ? 64 : 32;
  static constexpr int LDX = E + 8;              // row stride of the stream
  static constexpr int LDK = DH + 8;             // row stride of K and V
  static constexpr int HALF_BYTES = HALF * LDX * 2;        // a half of the stream
  static constexpr int SA_BYTES = HALF * E * 2;            // sA, core matrices
  // a weight tile: q|k|v and projection tiles in core matrices (wgmma), the
  // MLP's row-major with 8 columns of padding (mma.sync)
  static constexpr int TILE_ELEMS = cmax(KS * NT, cmax(E * (FC + 8), FC * (E + 8)));
  static constexpr int STAGE_BYTES = TILE_ELEMS * 2;
  // the whole stream stays in shared memory where it fits beside sA and a
  // full ring; otherwise one half at a time, the other parked
  static constexpr bool RESIDENT =
      2 * HALF_BYTES + SA_BYTES + MAX_STAGES * STAGE_BYTES + EPI_BYTES <= SMEM_LIMIT;
  static constexpr int SX_BYTES = (RESIDENT ? 2 : 1) * HALF_BYTES;
  static constexpr int STAGES =
      cmin(MAX_STAGES, (SMEM_LIMIT - SX_BYTES - SA_BYTES - EPI_BYTES) / STAGE_BYTES);
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int KV_ELEMS = 2 * TMAX * LDK;   // K then V of one head
  static constexpr int KV_BUFS = SX_BYTES + 2 * KV_ELEMS * 2 <= SMEM_LIMIT ? 2 : 1;
  static constexpr int SMEM_BYTES =
      cmax(SX_BYTES + SA_BYTES + RING_BYTES + EPI_BYTES, SX_BYTES + KV_BUFS * KV_ELEMS * 2);
  static constexpr int THIN_PART = THREADS * 8;   // partial sums of the thin path's products
  static constexpr int THIN_FLOATS = THIN_PART + 7 * E + F + H + H * TMAX;
  static constexpr int WS_ELEMS = TMAX * E3 + (RESIDENT ? 0 : 2 * HALF * E);
  static_assert(E == H * DH && DH % 16 == 0 && DH >= 16 && DH <= 128,
                "head dim a multiple of 16 from 16 to 128");
  static_assert(E <= 256, "fc2 sums of 16 rows x E in registers: E / 2 a lane");
  static_assert(STAGES >= 3, "at least three weight tiles in flight");
  static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared memory per block");
  static_assert(THIN_FLOATS * 4 <= RING_BYTES, "thin-path scratch in the ring");

  // Element offset of (row r, column k) of sA: the K-major core-matrix
  // layout of wgmma's A operand, 8-row groups 128 bytes apart, 8-column
  // groups HALF * 16 bytes apart.
  static __device__ __forceinline__ int sa(int r, int k) {
    return (k >> 3) * (HALF * 8) + (r >> 3) * 64 + (r & 7) * 8 + (k & 7);
  }
  // Descriptors of sA's rows r0 .. r0 + 63 at columns k0 .. k0 + 15, and of a
  // weight tile's rows k0 .. k0 + 15 (tile of 8-column groups sbo apart).
  static __device__ __forceinline__ uint64_t desc_a(const bf16* sA, int r0, int k0) {
    return wg::make_desc(sA + sa(r0, k0), HALF * 16, 128);
  }
  static __device__ __forceinline__ uint64_t desc_b(const bf16* tile, int k0, int sbo) {
    return wg::make_desc(reinterpret_cast<const unsigned char*>(tile) + (k0 >> 3) * 128, 128,
                         sbo);
  }

  // acc[NTW / 8] += sA's rows r0 .. r0 + 15 (all E columns, by ldmatrix: each
  // 8 x 8 matrix is one core matrix) times the [E x NTW] row-major tile b
  // (rows LDS apart), by mma.sync.
  template <int NTW, int LDS>
  static __device__ __forceinline__ void tile_mma_sa(float (*acc)[4], const bf16* sA, int r0,
                                                     const bf16* b) {
    const int l = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < E / 16; ++ks) {
      unsigned af[4];
      attn::ldsm_x4(af, sA + sa(r0 + (l & 15), ks * 16 + (l >> 4) * 8));
#pragma unroll
      for (int np = 0; np < NTW / 16; ++np) {
        unsigned bf[4];
        attn::frag_b_kn(bf, b + ks * 16 * LDS + np * 16, LDS);
        attn::mma(acc[2 * np], af, bf[0], bf[1]);
        attn::mma(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }
  }

  // sA rows r0 .. r0 + 15 = bf16(LN(src) * g), src the stream's rows (LDX apart).
  static __device__ __forceinline__ void ln_rows(const bf16* src, bf16* sA, int r0,
                                                 const float* g) {
    constexpr int NV = (E + 31) / 32;
    const int lane = threadIdx.x & 31;
    float gl[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) gl[j] = lane + 32 * j < E ? g[lane + 32 * j] : 0.f;
#pragma unroll 1
    for (int r = 0; r < 16; ++r) {
      float v[NV];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = lane + 32 * j;
        v[j] = c < E ? __bfloat162float(src[r * LDX + c]) : 0.f;
        s += v[j];
      }
      const float mu = warp_sum(s) * (1.f / E);
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        v[j] = lane + 32 * j < E ? v[j] - mu : 0.f;
        q += v[j] * v[j];
      }
      const float rs = rsqrtf(warp_sum(q) * (1.f / E) + LN_EPS);
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (lane + 32 * j < E) sA[sa(r0 + r, lane + 32 * j)] = __float2bfloat16(v[j] * rs * gl[j]);
    }
  }

  // fp32 LN of one row held in shared memory, by one warp.
  static __device__ __forceinline__ void ln_vec(const float* src, float* dst, const float* g,
                                                bool round) {
    constexpr int NV = (E + 31) / 32;
    const int lane = threadIdx.x & 31;
    float v[NV];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      v[j] = lane + 32 * j < E ? src[lane + 32 * j] : 0.f;
      s += v[j];
    }
    const float mu = warp_sum(s) * (1.f / E);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      v[j] = lane + 32 * j < E ? v[j] - mu : 0.f;
      q += v[j] * v[j];
    }
    const float rs = rsqrtf(warp_sum(q) * (1.f / E) + LN_EPS);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lane + 32 * j < E) {
        const float y = v[j] * rs * g[lane + 32 * j];
        dst[lane + 32 * j] = round ? rbf(y) : y;
      }
  }

  // x rows 0 .. halves * 128 - 1 of a context: bf16(wte[tok] + wpe[t]) for
  // t < T, zero past it; the first half to sX, the second to sX's second
  // half (resident) or the first parking slot.
  static __device__ void embed(const int* tok, const bf16* wte, const bf16* wpe, bf16* sX,
                               bf16* park, int T, int halves, int vocab) {
    constexpr int V8 = E / 8;
    for (int i = threadIdx.x; i < halves * HALF * V8; i += THREADS) {
      const int t = i / V8, col = (i - t * V8) * 8;
      float b[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (t < T) {
        load8(wpe + t * E + col, b);
        const int id = tok[t];
        if (id >= 0 && id < vocab) {
          float a[8];
          load8(wte + id * E + col, a);
#pragma unroll
          for (int k = 0; k < 8; ++k) b[k] += a[k];
        }
      }
      store8(RESIDENT || t < HALF ? sX + t * LDX + col : park + (t - HALF) * E + col, b);
    }
  }

  // Exchange the half in sX with the parked one: sX's rows to the free
  // parking slot (16-byte stores), then the parked rows into sX by cp.async;
  // the two slots trade roles.
  static __device__ void swap_halves(bf16* sX, bf16* park, int& pk) {
    constexpr int V8 = E / 8;
    bf16* out = park + (pk ^ 1) * HALF * E;
    const bf16* in = park + pk * HALF * E;
    __syncthreads();
    for (int i = threadIdx.x; i < HALF * V8; i += THREADS) {
      const int r = i / V8, col = (i - r * V8) * 8;
      __stcg(reinterpret_cast<uint4*>(out + r * E + col),
             *reinterpret_cast<const uint4*>(sX + r * LDX + col));
    }
    __syncthreads();
    copy_tile(sX, LDX, in, E, HALF, E);
    attn::cp_async_commit();
    attn::cp_async_wait<0>();
    __syncthreads();
    pk ^= 1;
  }

  // q|k|v columns n_off .. n_off + N - 1 of the half's rows (LN1 in sA) ->
  // the workspace rows `out` (3E apart), rounded to bf16.  Each warpgroup
  // runs wgmma on its 64 rows; tiles of 64 K rows x 128 columns.
  static __device__ void qkv_half(const bf16* sA, const bf16* W, bf16* out, int n_off, int N,
                                  bool wg_active, bool active, unsigned char* ring, bf16* epi) {
    constexpr int NK = (E + KS - 1) / KS;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, c4 = lane & 3;
    const int r0 = (warp >> 2) * 64;
    float acc[NT / 8][4];
    pipeline<STAGES, STAGE_BYTES>(
        ring, (N + NT - 1) / NT * NK,
        [&](int i, bf16* slot) {
          const int nt = i / NK, kt = i - nt * NK;
          copy_tile_mn(slot, KS * 16, W + (size_t)kt * KS * E3 + n_off + nt * NT, E3,
                       cmin(KS, E - kt * KS), cmin(NT, N - nt * NT));
        },
        [&](int i, const bf16* slot) {
          if (!wg_active) return;
          const int nt = i / NK, kt = i - nt * NK;
          const int ncols = cmin(NT, N - nt * NT), ksteps = cmin(KS, E - kt * KS) / 16;
          if (kt == 0) zero<NT / 8>(acc);
          wg::fence_operands<NT / 8>(acc);
          wg::fence();
          for (int k = 0; k < ksteps; ++k)
            wg::ss<NT>(acc, desc_a(sA, r0, kt * KS + 16 * k), desc_b(slot, 16 * k, KS * 16));
          wg::commit();
          wg::wait<0>();
          wg::fence_operands<NT / 8>(acc);
          if (kt == NK - 1 && active) {
            // rounded to bf16 in registers, then through the warp's stage
            // 32 columns at a time so that each lane stores 16 bytes
            bf16* st = epi + warp * 16 * EPI_LD;
            bf16* o = out + (size_t)(warp * 16) * E3 + n_off + nt * NT;
#pragma unroll
            for (int p = 0; p < NT / 32; ++p) {
              if (p * 32 < ncols) {
                __syncwarp();
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  st32(st + g * EPI_LD + j * 8 + 2 * c4, acc[4 * p + j][0], acc[4 * p + j][1]);
                  st32(st + (g + 8) * EPI_LD + j * 8 + 2 * c4, acc[4 * p + j][2],
                       acc[4 * p + j][3]);
                }
                __syncwarp();
#pragma unroll
                for (int k = 0; k < 2; ++k) {
                  const int i2 = lane + 32 * k, r = i2 >> 2, ch = (i2 & 3) * 8;
                  if (p * 32 + ch < ncols)
                    *reinterpret_cast<uint4*>(o + (size_t)r * E3 + p * 32 + ch) =
                        *reinterpret_cast<const uint4*>(st + r * EPI_LD + ch);
                }
              }
            }
          }
        });
  }

  // Attention of the warp's rows r0 .. r0 + 15 for head h against K and V
  // (keys 0 .. T - 1, rows LDK apart, zero past T up to a multiple of KC);
  // the output overwrites the rows' Q columns of head h in the workspace.
  static __device__ __forceinline__ void attention_rows(bf16* qkv, int r0, int h, const bf16* ks,
                                                        const bf16* vs, int T) {
    const int lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
    bf16* q = qkv + (size_t)r0 * E3 + h * DH + 2 * c4;
    unsigned qa[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      qa[kk][0] = ldcg32(q + g * E3 + kk * 16);
      qa[kk][1] = ldcg32(q + (g + 8) * E3 + kk * 16);
      qa[kk][2] = ldcg32(q + g * E3 + kk * 16 + 8);
      qa[kk][3] = ldcg32(q + (g + 8) * E3 + kk * 16 + 8);
    }
    float acc[DH / 8][4];
    zero<DH / 8>(acc);
    float sm[2] = {0.f, 0.f};   // this lane's part of rows g and g + 8
#pragma unroll 1
    for (int c0 = 0; c0 < T; c0 += KC) {
      float s[KC / 8][4];
      attn::scores<DH, KC / 16>(s, qa, ks + c0 * LDK, LDK);
      const bool edge = c0 + KC > T;
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = rbf(attn::ex2(fminf(s[j][e], EXP2_CLAMP)));
          if (edge && c0 + j * 8 + 2 * c4 + (e & 1) >= T) x = 0.f;
          s[j][e] = x;
          sm[e >> 1] += x;
        }
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        unsigned pa[4];
        attn::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        attn::accumulate<DH>(acc, pa, vs + (c0 + kk * 16) * LDK, LDK);
      }
    }
    const float inv0 = 1.f / attn::quad_sum(sm[0]), inv1 = 1.f / attn::quad_sum(sm[1]);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      st32(q + g * E3 + j * 8, acc[j][0] * inv0, acc[j][1] * inv0);
      st32(q + (g + 8) * E3 + j * 8, acc[j][2] * inv1, acc[j][3] * inv1);
    }
  }

  // Attention of every row block and head; K and V of head h staged once
  // into kv (one buffer, or two in turn so that head h + 1 loads while h runs).
  static __device__ void attention(bf16* qkv, int T, bf16* kv) {
    const int tid = threadIdx.x, warp = tid >> 5;
    const int TK = attn::round_up(T, KC), TP = attn::round_up(T, 16);
    auto stage = [&](int h, bf16* buf) {
      attn::stage_rows_async<DH>(buf, qkv + E + h * DH, E3, 0, TK, T, tid, THREADS);
      attn::stage_rows_async<DH>(buf + TMAX * LDK, qkv + 2 * E + h * DH, E3, 0, TK, T, tid,
                                 THREADS);
    };
    stage(0, kv);
    attn::cp_async_commit();
#pragma unroll 1
    for (int h = 0; h < H; ++h) {
      const bf16* buf = kv + (KV_BUFS == 2 ? (h & 1) * KV_ELEMS : 0);
      if constexpr (KV_BUFS == 2) {
        if (h + 1 < H) stage(h + 1, kv + ((h + 1) & 1) * KV_ELEMS);
        attn::cp_async_commit();
        attn::cp_async_wait<1>();
      } else {
        attn::cp_async_wait<0>();
      }
      __syncthreads();
      for (int r0 = warp * 16; r0 < TP; r0 += WARPS * 16)
        attention_rows(qkv, r0, h, buf, buf + TMAX * LDK, T);
      __syncthreads();
      if constexpr (KV_BUFS == 1) {
        if (h + 1 < H) {
          stage(h + 1, kv);
          attn::cp_async_commit();
        }
      }
    }
  }

  // x = bf16(x + bf16(att @ Wproj)) for the half's rows: the attention rows
  // `att` (3E apart in the workspace) into sA by cp.async, then the product.
  static __device__ void proj_half(bf16* xh, bf16* sA, const bf16* att, const bf16* W,
                                   bool wg_active, bool active, unsigned char* ring) {
    constexpr int NK = (E + KS - 1) / KS, NN = (E + NT - 1) / NT, KG = E / 8;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, c4 = lane & 3;
    const int r0 = (warp >> 2) * 64;
    // 16-byte chunk (row m, columns 8kg ..): 8 lanes a core matrix, as copy_tile_mn
    for (int i = threadIdx.x; i < HALF * KG; i += THREADS) {
      const int q = i >> 3, kg = q % KG, m = (q / KG) * 8 + (i & 7);
      attn::cp_async16(sA + sa(m, kg * 8), att + (size_t)m * E3 + kg * 8);
    }
    attn::cp_async_commit();
    float acc[NT / 8][4];
    pipeline<STAGES, STAGE_BYTES>(
        ring, NN * NK,
        [&](int i, bf16* slot) {
          const int nt = i / NK, kt = i - nt * NK;
          copy_tile_mn(slot, KS * 16, W + (size_t)kt * KS * E + nt * NT, E,
                       cmin(KS, E - kt * KS), cmin(NT, E - nt * NT));
        },
        [&](int i, const bf16* slot) {
          if (!wg_active) return;
          const int nt = i / NK, kt = i - nt * NK;
          const int ncols = cmin(NT, E - nt * NT), ksteps = cmin(KS, E - kt * KS) / 16;
          if (kt == 0) zero<NT / 8>(acc);
          wg::fence_operands<NT / 8>(acc);
          wg::fence();
          for (int k = 0; k < ksteps; ++k)
            wg::ss<NT>(acc, desc_a(sA, r0, kt * KS + 16 * k), desc_b(slot, 16 * k, KS * 16));
          wg::commit();
          wg::wait<0>();
          wg::fence_operands<NT / 8>(acc);
          if (kt == NK - 1 && active) {
            bf16* x = xh + (warp * 16 + g) * LDX + nt * NT + 2 * c4;
#pragma unroll
            for (int j = 0; j < NT / 8; ++j)
              if (j * 8 < ncols) {
                residual_add(x + j * 8, acc[j][0], acc[j][1]);
                residual_add(x + 8 * LDX + j * 8, acc[j][2], acc[j][3]);
              }
          }
        });
  }

  // x = bf16(x + bf16(v)) on two neighbouring values of the stream.
  static __device__ __forceinline__ void residual_add(bf16* x, float v0, float v1) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
    st32(x, f.x + rbf(v0), f.y + rbf(v1));
  }

  // x = bf16(x + bf16(gelu(bf16(bf16(LN(x) * g2) @ Wfc)) @ Wfc2)) for the
  // half's rows, FC hidden columns at a time, by mma.sync (a warp's 16 rows):
  // the fc chunk's C fragments are rounded, put through GELU and repacked as
  // fc2's A fragments; the fc2 sums stay in registers throughout.
  static __device__ void mlp_half(bf16* xh, bf16* sA, const bf16* Wfc, const bf16* Wfc2,
                                  const float* g2, bool active, unsigned char* ring) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, c4 = lane & 3;
    if (active) ln_rows(xh + warp * 16 * LDX, sA, warp * 16, g2);
    __syncwarp();
    float acc2[E / 8][4];
    zero<E / 8>(acc2);
    unsigned ha[FC / 16][4];
    pipeline<STAGES, STAGE_BYTES>(
        ring, 2 * (F / FC),
        [&](int i, bf16* slot) {
          const int f0 = (i >> 1) * FC;
          if ((i & 1) == 0)
            copy_tile(slot, FC + 8, Wfc + f0, F, E, FC);
          else
            copy_tile(slot, E + 8, Wfc2 + (size_t)f0 * E, E, FC, E);
        },
        [&](int i, const bf16* slot) {
          if (!active) return;
          if ((i & 1) == 0) {   // fc: the chunk's 16 x FC tile, over all of E
            float hc[FC / 8][4];
            zero<FC / 8>(hc);
            tile_mma_sa<FC, FC + 8>(hc, sA, warp * 16, slot);
#pragma unroll
            for (int j = 0; j < FC / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) hc[j][e] = gelu_tanh(rbf(hc[j][e]));
#pragma unroll
            for (int kk = 0; kk < FC / 16; ++kk) attn::c_to_a(ha[kk], hc[2 * kk], hc[2 * kk + 1]);
          } else {              // fc2: acc2 += the chunk (A in registers) @ Wfc2 rows
#pragma unroll
            for (int kk = 0; kk < FC / 16; ++kk)
#pragma unroll
              for (int np = 0; np < E / 16; ++np) {
                unsigned bf[4];
                attn::frag_b_kn(bf, slot + kk * 16 * (E + 8) + np * 16, E + 8);
                attn::mma(acc2[2 * np], ha[kk], bf[0], bf[1]);
                attn::mma(acc2[2 * np + 1], ha[kk], bf[2], bf[3]);
              }
          }
        });
    if (active) {
      bf16* x = xh + (warp * 16 + g) * LDX + 2 * c4;
#pragma unroll
      for (int j = 0; j < E / 8; ++j) {
        residual_add(x + j * 8, acc2[j][0], acc2[j][1]);
        residual_add(x + 8 * LDX + j * 8, acc2[j][2], acc2[j][3]);
      }
    }
  }

  // y[j] = sum_k x[k] W[k * ld + j] for j < M (x fp32 in shared memory, W
  // bf16), by the CTA: 8 columns a thread (16-byte loads), the K rows split
  // into THREADS / (M / 8) ranges whose partial sums (part) add in order.
  template <int K, int M>
  static __device__ void gemv(const float* x, const bf16* W, int ld, float* part, float* y) {
    constexpr int G = M / 8, S = THREADS / G, KR = (K + S - 1) / S;
    static_assert(G <= THREADS && S * M <= THIN_PART, "gemv ranges");
    const int tid = threadIdx.x;
    if (tid < G * S) {
      const int col = (tid % G) * 8, s = tid / G, k1 = cmin(K, (s + 1) * KR);
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int k = s * KR; k < k1; ++k) {
        float w[8];
        load8(W + (size_t)k * ld + col, w);
        const float xk = x[k];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(xk, w[i], acc[i]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) part[s * M + col + i] = acc[i];
    }
    __syncthreads();
    for (int j = tid; j < M; j += THREADS) {
      float sum = 0.f;
      for (int r = 0; r < S; ++r) sum += part[r * M + j];
      y[j] = sum;
    }
    __syncthreads();
  }

  // The thinned last layer for position T-1, final LN and the tied head, as
  // fp32 dot products over the CTA (weights and K/V read through L2).
  // K/V of all positions are in qkv; sA's row r is LN1 of the last row, x the row.
  static __device__ void last_position(const bf16* qkv, const bf16* x, const bf16* sA, int r,
                                       const bf16* Wqkv, const bf16* Wproj, const bf16* Wfc,
                                       const bf16* Wfc2, const float* g2, const float* gf,
                                       const float* wht, int T, int vocab, float* thin,
                                       float* out) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    float* part = thin;            // [THIN_PART]
    float* v_s = part + THIN_PART; // [E] scratch vector
    float* q_s = v_s + E;          // [E]
    float* att_s = q_s + E;        // [E]
    float* xl_s = att_s + E;       // [E]
    float* xn2_s = xl_s + E;       // [E]
    float* xf_s = xn2_s + E;       // [E]
    float* h_s = xf_s + E;         // [F]
    float* den_s = h_s + F;        // [H]
    float* p_s = den_s + H;        // [H * TMAX]

    for (int j = tid; j < E; j += THREADS) v_s[j] = __bfloat162float(sA[sa(r, j)]);
    __syncthreads();
    gemv<E, E>(v_s, Wqkv, E3, part, q_s);
    for (int j = tid; j < E; j += THREADS) q_s[j] = rbf(q_s[j]);
    __syncthreads();
    for (int i = tid; i < H * T; i += THREADS) {
      const int h = i / T, t = i - h * T;
      const bf16* kr = qkv + (size_t)t * E3 + E + h * DH;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 8) {
        const uint4 u = __ldcg(reinterpret_cast<const uint4*>(kr + d));
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(k2[k]);
          s += q_s[h * DH + d + 2 * k] * f.x + q_s[h * DH + d + 2 * k + 1] * f.y;
        }
      }
      p_s[h * TMAX + t] = rbf(exp2f(fminf(s, EXP2_CLAMP)));
    }
    __syncthreads();
    for (int h = warp; h < H; h += WARPS) {
      float s = 0.f;
      for (int t = lane; t < T; t += 32) s += p_s[h * TMAX + t];
      s = warp_sum(s);
      if (lane == 0) den_s[h] = s;
    }
    {   // att = bf16((p @ V) / sum p): 8 columns a thread, the keys split in ranges
      constexpr int G = E / 8, S = THREADS / G;
      const int TR = (T + S - 1) / S;
      if (tid < G * S) {
        const int col = (tid % G) * 8, s = tid / G, h = col / DH, t1 = min(T, (s + 1) * TR);
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int t = s * TR; t < t1; ++t) {
          const uint4 u = __ldcg(reinterpret_cast<const uint4*>(qkv + (size_t)t * E3 + 2 * E + col));
          const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&u);
          const float pt = p_s[h * TMAX + t];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(v2[k]);
            acc[2 * k] = fmaf(pt, f.x, acc[2 * k]);
            acc[2 * k + 1] = fmaf(pt, f.y, acc[2 * k + 1]);
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) part[s * E + col + i] = acc[i];
      }
      __syncthreads();
      for (int j = tid; j < E; j += THREADS) {
        float sum = 0.f;
        for (int r = 0; r < S; ++r) sum += part[r * E + j];
        att_s[j] = rbf(sum * (1.f / den_s[j / DH]));
      }
      __syncthreads();
    }
    gemv<E, E>(att_s, Wproj, E, part, v_s);
    for (int j = tid; j < E; j += THREADS) xl_s[j] = rbf(__bfloat162float(x[j]) + rbf(v_s[j]));
    __syncthreads();
    if (warp == 0) ln_vec(xl_s, xn2_s, g2, true);
    __syncthreads();
    gemv<E, F>(xn2_s, Wfc, F, part, h_s);
    for (int m = tid; m < F; m += THREADS) h_s[m] = rbf(gelu_tanh(rbf(h_s[m])));
    __syncthreads();
    gemv<F, E>(h_s, Wfc2, E, part, v_s);
    for (int j = tid; j < E; j += THREADS) xl_s[j] = rbf(xl_s[j] + rbf(v_s[j]));
    __syncthreads();
    if (warp == 0) ln_vec(xl_s, xf_s, gf, false);
    __syncthreads();
    {   // the tied head: vocab columns, E split in S ranges
      const int S = THREADS / vocab, KR = (E + S - 1) / S;
      if (tid < S * vocab) {
        const int v = tid % vocab, s = tid / vocab, k1 = cmin(E, (s + 1) * KR);
        float acc = 0.f;
#pragma unroll 4
        for (int k = s * KR; k < k1; ++k) acc = fmaf(xf_s[k], wht[k * vocab + v], acc);
        part[s * vocab + v] = acc;
      }
      __syncthreads();
      if (tid < vocab) {
        float sum = 0.f;
        for (int r = 0; r < S; ++r) sum += part[r * vocab + tid];
        out[tid] = sum;
      }
    }
  }

  static __device__ void forward(const int* __restrict__ tokens, const bf16* __restrict__ wte,
                                 const bf16* __restrict__ wpe, const float* __restrict__ wht,
                                 const bf16* __restrict__ wqkv, const bf16* __restrict__ wproj,
                                 const bf16* __restrict__ wfc, const bf16* __restrict__ wfc2,
                                 const float* __restrict__ g1, const float* __restrict__ g2,
                                 const float* __restrict__ gf, float* __restrict__ out,
                                 bf16* __restrict__ workspace, int n, int T, int layers,
                                 int vocab) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* sX = reinterpret_cast<bf16*>(smem);                  // the stream (a half or both)
    bf16* sA = reinterpret_cast<bf16*>(smem + SX_BYTES);       // LN / attention rows of a half
    unsigned char* ring = smem + SX_BYTES + SA_BYTES;          // weight tiles
    bf16* epi = reinterpret_cast<bf16*>(ring + RING_BYTES);     // q|k|v store stages
    bf16* kv = sA;                                             // K and V (attention only)
    const int warp = threadIdx.x >> 5;
    bf16* qkv = workspace + (size_t)blockIdx.x * WS_ELEMS;
    bf16* park = qkv + TMAX * E3;   // two slots of a half each (not RESIDENT)
    const int TP = attn::round_up(T, 16);
    const int halves = TP > HALF ? 2 : 1;
    // the stream rows of half hf: resident, or the one half in sX
    auto xh = [&](int hf) { return RESIDENT ? sX + hf * HALF * LDX : sX; };

    for (int c = blockIdx.x; c < n; c += gridDim.x) {
      embed(tokens + (size_t)c * T, wte, wpe, sX, park, T, halves, vocab);
      __syncthreads();
      int res = 0, pk = 0;   // the half in sX, the slot of the parked half
      for (int l = 0; l < layers; ++l) {
        const bool last = l == layers - 1;
        const bf16* Wqkv = wqkv + (size_t)l * E * E3;
        const bf16* Wproj = wproj + (size_t)l * E * E;
        const bf16* Wfc = wfc + (size_t)l * E * F;
        const bf16* Wfc2 = wfc2 + (size_t)l * F * E;
        // LN1 and q|k|v of every row, a half at a time (the last layer: K and V)
        for (int hf = 0; hf < halves; ++hf) {
          if (!RESIDENT && hf != res) {
            swap_halves(sX, park, pk);
            res = hf;
          }
          const bool active = hf * HALF + warp * 16 < TP;
          const bool wg_active = hf * HALF + (warp >> 2) * 64 < TP;
          if (active) ln_rows(xh(hf) + warp * 16 * LDX, sA, warp * 16, g1 + l * E);
          qkv_half(sA, Wqkv, qkv + (size_t)hf * HALF * E3, last ? E : 0, last ? 2 * E : E3,
                   wg_active, active, ring, epi);
        }
        if (last) {
          const int r = T - 1 - (halves - 1) * HALF;   // row T-1 in the last half
          last_position(qkv, xh(halves - 1) + r * LDX, sA, r, Wqkv, Wproj, Wfc, Wfc2,
                        g2 + l * E, gf, wht, T, vocab, reinterpret_cast<float*>(ring),
                        out + (size_t)c * vocab);
          __syncthreads();
          break;
        }
        attention(qkv, T, kv);
        // projection and MLP, the half in sX first
        for (int i = 0; i < halves; ++i) {
          const int hf = halves - 1 - i;
          if (!RESIDENT && hf != res) {
            swap_halves(sX, park, pk);
            res = hf;
          }
          const bool active = hf * HALF + warp * 16 < TP;
          const bool wg_active = hf * HALF + (warp >> 2) * 64 < TP;
          proj_half(xh(hf), sA, qkv + (size_t)hf * HALF * E3, Wproj, wg_active, active, ring);
          mlp_half(xh(hf), sA, Wfc, Wfc2, g2 + l * E, active, ring);
        }
      }
    }
  }
};

#ifdef FUSED_GPT_E
using FwdA = Fwd<FUSED_GPT_E, FUSED_GPT_H>;   // the width asked for
#else
using FwdA = Fwd<160, 5>;   // 2M
using FwdB = Fwd<256, 8>;   // 6M
#endif

template <class S>
__global__ void __launch_bounds__(THREADS, 1)
fused_gpt_kernel(const int* __restrict__ tokens, const bf16* __restrict__ wte,
                 const bf16* __restrict__ wpe, const float* __restrict__ wht,
                 const bf16* __restrict__ wqkv, const bf16* __restrict__ wproj,
                 const bf16* __restrict__ wfc, const bf16* __restrict__ wfc2,
                 const float* __restrict__ g1, const float* __restrict__ g2,
                 const float* __restrict__ gf, float* __restrict__ out,
                 bf16* __restrict__ workspace, int n, int T, int layers, int vocab) {
  S::forward(tokens, wte, wpe, wht, wqkv, wproj, wfc, wfc2, g1, g2, gf, out, workspace, n, T,
             layers, vocab);
}

template <class S>
int config_of(int* t, int* e, int* h, int* max_vocab, int* smem_bytes, int* ws_elems) {
  *t = TMAX;
  *e = S::E;
  *h = S::H;
  *max_vocab = MAX_VOCAB;
  *smem_bytes = S::SMEM_BYTES;
  *ws_elems = S::WS_ELEMS;
  return 0;
}

template <class S>
int launch(const int* tokens, const bf16* wte, const bf16* wpe, const float* wht,
           const bf16* wqkv, const bf16* wproj, const bf16* wfc, const bf16* wfc2,
           const float* g1, const float* g2, const float* gf, float* out, bf16* workspace,
           int n, int T, int layers, int vocab, int grid, cudaStream_t stream) {
  if (T < 1 || T > TMAX || vocab > MAX_VOCAB || layers < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_gpt_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  fused_gpt_kernel<S><<<grid, THREADS, S::SMEM_BYTES, stream>>>(
      tokens, wte, wpe, wht, wqkv, wproj, wfc, wfc2, g1, g2, gf, out, workspace, n, T, layers,
      vocab);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape constants of the i-th width the library was built for, for the
// wrapper's checks (t: the longest T; ws_elems: bf16 workspace a CTA);
// returns 1 when there is no i-th width.
int fused_gpt_config(int i, int* t, int* e, int* h, int* max_vocab, int* smem_bytes,
                     int* ws_elems) {
  if (i == 0) return config_of<FwdA>(t, e, h, max_vocab, smem_bytes, ws_elems);
#ifndef FUSED_GPT_E
  if (i == 1) return config_of<FwdB>(t, e, h, max_vocab, smem_bytes, ws_elems);
#endif
  return 1;
}

// Launches the forward of width e with h heads on `stream`; returns the CUDA
// error code (0 = launched; cudaErrorInvalidValue for a width not built or
// T outside 1..256).  tokens: int32 [n, T]; workspace: bf16 [grid, ws_elems];
// out: fp32 [n, vocab].
int fused_gpt_forward(int e, int h, const int* tokens, const bf16* wte, const bf16* wpe,
                      const float* wht, const bf16* wqkv, const bf16* wproj, const bf16* wfc,
                      const bf16* wfc2, const float* g1, const float* g2, const float* gf,
                      float* out, bf16* workspace, int n, int T, int layers, int vocab, int grid,
                      cudaStream_t stream) {
  if (e == FwdA::E && h == FwdA::H)
    return launch<FwdA>(tokens, wte, wpe, wht, wqkv, wproj, wfc, wfc2, g1, g2, gf, out,
                        workspace, n, T, layers, vocab, grid, stream);
#ifndef FUSED_GPT_E
  if (e == FwdB::E && h == FwdB::H)
    return launch<FwdB>(tokens, wte, wpe, wht, wqkv, wproj, wfc, wfc2, g1, g2, gf, out,
                        workspace, n, T, layers, vocab, grid, stream);
#endif
  return (int)cudaErrorInvalidValue;
}

const char* fused_gpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
