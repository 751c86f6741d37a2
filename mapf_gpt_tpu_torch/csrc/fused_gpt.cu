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
// MFLOP) -> 27.8 ms.  Both are bound by operations; behind them the
// special-function units (an ex2 per attention score, an ex2 and a
// reciprocal per GELU, 16 a clock on an SM).  The design keeps every
// intermediate on chip or in L2 and feeds the tensor cores by wgmma from
// shared memory and registers:
//   * warp specialisation: a CTA of three warpgroups, one CTA an SM,
//     persistent over contexts.  One producer thread (warpgroup 2) walks the
//     same sequence of weight tiles as the consumers and keeps them in
//     flight by TMA (cp.async.bulk.tensor, 128-byte swizzle) in a ring of
//     STAGES slots with a "full" and an "empty" mbarrier each; the two
//     consumer warpgroups take rows 0-63 and 64-127 of a half-context (warp
//     w owning rows 16 w .. 16 w + 15 of each half), and both read every
//     weight tile, so a weight byte crosses L2 once per 128 rows;
//     setmaxnreg moves registers from the producer (40) to the consumers
//     (232);
//   * the weights are [k][n] row-major and go in as they are: every B
//     operand is MN-major (64-column TMA boxes of 64 K rows, or of all E rows
//     for fc); a product's width is E rounded up to 64 columns (NP), whose
//     columns past E TMA fills or which are not stored;
//   * q|k|v (three tiles of NP columns, q, k and v) and the projection: A
//     the LN1 rows, or the attention rows, in sA (wgmma's K-major core
//     matrices, no swizzle), B the ring's tile, m64nNPk16, the k-tiles of 64
//     rows in flight one behind the other; epilogues on the accumulators in
//     registers: q|k|v rounded and stored to the CTA's workspace by TMA,
//     a 64 x 64 box at a time staged in the warpgroup's half of the last
//     k-tile's slot (both warpgroups done with it; the slot is freed once
//     the stores have read it; 4-byte stores from the registers had taken
//     a sixth of the 6M's time), the projection rounded and added to the
//     stream in shared memory;
//   * the MLP, 64 hidden columns a chunk: fc = m64n64k16 from sA (LN2 rows)
//     and the chunk's [E x 64] tile of Wfc; GELU on the accumulators,
//     rounded to bf16 into register A fragments; fc2 = m64nNPk16 with A
//     from those registers and B the chunk's [64 x NP] tile of Wfc2, its sums
//     in wgmma accumulators over all 4E hidden columns.  One warpgroup's
//     GELU runs while the other's products do;
//   * attention at head dims 16-64: csrc/attn_wgmma.cuh's tile with the
//     layer stack's arithmetic (BLOCKS): per head, Q, K and V of all T rows
//     by TMA from the CTA's workspace into a stage (rows past T zero-filled),
//     S = Q K^T m64n256 with both operands in shared memory, e rounded in
//     registers and fed as register A to P V, the sum over the rounded e,
//     keys at or past T masked; the two warpgroups take the 64-row query
//     tiles in turn and their exp2 phases take turns at head dims 48 and 64
//     (the header's ticket); O goes back over the head's Q columns by TMA.
//     Head dims 80-128 keep the mma.sync attention below (K and V staged by
//     cp.async, every consumer warp on its 16-row blocks);
//   * the thinned last layer's row T-1 and the head run as fp32 dot products
//     over the consumers, weights from L2 (one row a context): 8 columns a
//     thread by 16-byte loads, the depth split in ranges added in a fixed
//     order;
//   * tanh GELU as x * sigmoid(2u) (one ex2.approx and a fast division,
//     within a few fp32 ulp of the accurate tanh's; see gelu_tanh).
// Order of work in a context, and who waits for whom (besides the ring):
//   embed; per layer: LN1 + q|k|v a half at a time (the 6M swapping halves
//   through the workspace) -> the consumers' workspace stores, "ws_ready" ->
//   the producer drains the ring and loads the heads' Q, K and V into the
//   attention stages, which alias the ring and sA ("att_full"/"att_empty") ->
//   "att_done" -> projection and MLP a half at a time, the tiles streaming
//   again; the last layer's K|V, then the thin path, which uses the ring as
//   scratch, so the producer waits for "ctx_done" before a context's first
//   tile.
// Budgets (shared memory a block can have: 232,448 bytes; 65,536 registers
// an SM):
//   6M, E=256: the ring 3 x 32 KB slots ([64 x 256] tiles: q|k|v,
//     projection, fc2; fc's [256 x 64] the same), sA 128 x 256 bf16 =
//     65,536 B, the stream of one half (128 x 264 bf16, 67,584 B; the other
//     half parks in the workspace and the two swap twice a layer: 16-byte
//     stores out, cp.async in), the barriers: 231,680 B.  The attention's
//     stages (3 x 48 KB at head dim 32) alias the ring and sA, and so does
//     the thin path's fp32 scratch (27,680 B, in the ring).  Registers a
//     consumer thread: fc2 sums 128, the fc chunk 32, its A fragments 16;
//     q|k|v and projection accumulators 128; the attention tile's scores
//     128 and e 64.  The consumer code passes thread indices and k-step
//     offsets through opaque() so that the compiler derives addresses and
//     descriptors where they are used instead of holding them beside the
//     accumulators (ptxas -v: 0 spill bytes at the 2M and 6M widths).
//   2M, E=160: the whole stream stays (256 x 168 bf16, 86,016 B; no swap),
//     sA 40,960 B, the ring 4 x 24 KB (NP = 192): 225,536 B; fc2 sums 96
//     registers.
// Workspace per CTA: q|k|v [256, 3E] bf16 (Q's columns are overwritten by
// the attention output) and, where the stream does not stay, two parking
// slots [128, E] (the parked half, and the slot the next swap writes):
// 512 KiB at the 6M (69 MB over 132 CTAs; L2 holds 50 MB), 240 KiB at the
// 2M (32 MB).
// Grid: min(N, SMs) CTAs, each walking contexts c = blockIdx.x, + gridDim.x,
// ...: at N = 8192 on 132 SMs, 8 CTAs take 63 contexts and 124 take 62 (62.06
// a CTA on average: 98.5 % of the last wave busy); at the rollout's N = 512,
// 116 CTAs take 4 and 16 take 3 (3.88 on average, 97 %).
// Tensor maps: the four weight stacks' (2-D, [layers x rows, columns]) are
// built on the host once per set of weights (fused_gpt_weight_maps, cached by
// ops/fused_gpt.py), the workspace's (attn_wgmma.cuh's layer-stack layout,
// T rows a context) by the launcher; all passed as __grid_constant__.
// tools/kernel_phases.py builds this source with -DFUSED_GPT_SKIP=<bits>:
// the phases whose bit is set skip their products and epilogues (their
// tiles still stream and every barrier sees the same sequence), and
// SKIP_LOADS issues no TMA copies of the weights.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_gpt.so fused_gpt.cu   (ops/_build.py)

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "attn_wgmma.cuh"

#ifndef FUSED_GPT_SKIP
#define FUSED_GPT_SKIP 0
#endif

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TMAX = 256;        // longest context
constexpr int HALF = 128;        // rows of a half-context: 16 a consumer warp
constexpr int WARPS = 8;         // consumer warps: two warpgroups
constexpr int CT = WARPS * 32;   // consumer threads
constexpr int THREADS = CT + 128;   // and the producer's warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int MAX_VOCAB = CT;
constexpr float EXP2_CLAMP = 100.f;
constexpr float LN_EPS = 1e-5f;
constexpr int SMEM_LIMIT = 232448;
constexpr int KS = 64;           // K rows of a q|k|v, projection or fc2 tile
constexpr int FC = 64;           // hidden columns of an MLP chunk
constexpr int BOX_BYTES = 64 * 64 * 2;   // a [64 rows][64 columns] swizzled box
constexpr int KC = 64;           // keys of an mma.sync attention chunk
constexpr int MAX_STAGES = 4;
constexpr int BAR_BYTES = 256;   // the mbarriers
constexpr int CBAR = 3;          // the consumers' named barrier (1, 2: a warpgroup's)
// phases tools/kernel_phases.py compiles out
constexpr int SKIP_QKV = 1, SKIP_ATTENTION = 2, SKIP_PROJ = 4, SKIP_MLP = 8, SKIP_LAST = 16,
              SKIP_LOADS = 32;
constexpr int SKIP = FUSED_GPT_SKIP;
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

// A value the compiler cannot see through, so that what is derived from it
// (a thread's offsets, the descriptors of a product's k-step) is computed
// where it is used and not hoisted out of the loops to sit in registers
// beside the accumulators; tid_here() is threadIdx.x so.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}
__device__ __forceinline__ int tid_here() { return opaque(threadIdx.x); }

// the consumers' barrier (the producer thread never takes part)
__device__ __forceinline__ void cbar() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(CBAR), "n"(CT) : "memory");
}

// generic-proxy writes of global memory, before the async proxy (TMA) reads
// them, and async-proxy writes before generic reads
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
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

// keeps registers that an issued wgmma reads live until the asm (after its wait)
template <int N>
__device__ __forceinline__ void keep(unsigned (*a)[4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// rows x cols bf16 of a row-major matrix (rows ld apart) -> dst (rows lds
// apart) by cp.async, 16 bytes a thread, the consumer threads in turn.
__device__ __forceinline__ void copy_tile(bf16* dst, int lds, const bf16* src, long long ld,
                                          int rows, int cols) {
  const int vec = cols >> 3;
  for (int i = tid_here(); i < rows * vec; i += CT) {
    const int r = i / vec, c = (i - r * vec) * 8;
    attn::cp_async16(dst + r * lds + c, src + r * ld + c);
  }
}

// The CTA's tensor maps: the weight stacks' (2-D: [layers x in, out],
// 64-column boxes, 128-byte swizzle) and, at head dims 16-64, the
// workspace's for the attention (aw::BlocksIo: q|k|v [grid, T, 3H, DH], att
// over the Q columns).
struct Maps {
  CUtensorMap wqkv, wproj, wfc, wfc2;
  aw::BlocksIo io;
  CUtensorMap qkv_out;   // the workspace's q|k|v [grid][256][3E], 64 x 64 boxes
};

// box (c0 columns, c1 rows, c2 the CTA's workspace) of a rank-3 map <- src,
// in the thread's bulk group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(gemm::smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The block's shared memory (dynamic): the region (ring + sA, or the
// attention's buffers), the stream, the mbarriers.  Every address below is
// an offset from it, which the compiler can rematerialise instead of keeping
// pointers in registers.
extern __shared__ __align__(1024) unsigned char smem[];

// The mbarriers, at byte OFF of shared memory (after the stream).
template <int OFF>
struct Bars {
  static __device__ __forceinline__ uint64_t* at(int i) {
    return reinterpret_cast<uint64_t*>(smem + OFF) + i;
  }
  // a ring slot holds its tile (TMA bytes); the 8 consumer warps are done with it
  static __device__ __forceinline__ uint64_t* full(int s) { return at(s); }
  static __device__ __forceinline__ uint64_t* empty(int s) { return at(MAX_STAGES + s); }
  // an attention stage holds a head's Q, K, V; both consumer warpgroups are done with it
  static __device__ __forceinline__ uint64_t* att_full(int s) { return at(2 * MAX_STAGES + s); }
  static __device__ __forceinline__ uint64_t* att_empty(int s) {
    return at(2 * MAX_STAGES + 3 + s);
  }
  // the consumers' q|k|v stores are in the workspace
  static __device__ __forceinline__ uint64_t* ws_ready() { return at(2 * MAX_STAGES + 6); }
  // the attention is done: its stages may be overwritten
  static __device__ __forceinline__ uint64_t* att_done() { return at(2 * MAX_STAGES + 7); }
  // the thin path is done with its scratch in the ring
  static __device__ __forceinline__ uint64_t* ctx_done() { return at(2 * MAX_STAGES + 8); }
  // the warpgroups' exp2 turns in the attention tile
  static __device__ __forceinline__ uint64_t* ticket() { return at(2 * MAX_STAGES + 9); }
};
static_assert((2 * MAX_STAGES + 6 + 4) * 8 <= BAR_BYTES, "barriers");

// The forward for one width: E, H heads.  Fwd<...>::forward is the body of
// fused_gpt_kernel<Fwd<...>>.
template <int E_, int H_>
struct Fwd {
  static constexpr int E = E_;
  static constexpr int H = H_;
  static constexpr int DH = E / H;               // head dim
  static constexpr int E3 = 3 * E;               // q|k|v width
  static constexpr int F = 4 * E;                // MLP hidden width
  static constexpr int NP = (E + 63) / 64 * 64;  // a product's width: E in whole boxes
  static constexpr int NK = (E + KS - 1) / KS;   // k-tiles over E
  static constexpr int KS_LAST = (E - (NK - 1) * KS) / 16;   // 16-deep steps of the last
  static constexpr int NC = F / FC;              // MLP chunks
  static constexpr int LDX = E + 8;              // row stride of the stream
  static constexpr int LDK = DH + 8;             // row stride of K and V (mma.sync attention)
  static constexpr int HALF_BYTES = HALF * LDX * 2;        // a half of the stream
  static constexpr int SA_BYTES = HALF * E * 2;            // sA, core matrices
  // a ring slot: a [64 x NP] tile of Wqkv, Wproj or Wfc2; Wfc's [E x 64] fits too
  static constexpr int SLOT = KS * NP * 2;
  // the whole stream stays in shared memory where it fits beside sA and a
  // ring of three; otherwise one half at a time, the other parked
  static constexpr bool RESIDENT =
      2 * HALF_BYTES + SA_BYTES + 3 * SLOT + BAR_BYTES <= SMEM_LIMIT;
  static constexpr int SX_BYTES = (RESIDENT ? 2 : 1) * HALF_BYTES;
  // the region before the stream: the ring then sA, or the attention's buffers
  static constexpr int AVAIL = SMEM_LIMIT - BAR_BYTES - SX_BYTES;
  static constexpr int STAGES = cmin(MAX_STAGES, (AVAIL - SA_BYTES) / SLOT);
  static constexpr int RING_BYTES = STAGES * SLOT;
  // attention on attn_wgmma.cuh's tile at head dims 16-64 (stages of a
  // head's Q, K and V), on mma.sync above (K and V of a head, one buffer
  // or two in turn)
  static constexpr bool ATT_WGMMA = aw::takes(DH);
  using G = aw::Geo<ATT_WGMMA ? DH : 16>;
  static constexpr int ATT_STAGES = ATT_WGMMA ? cmin(3, AVAIL / G::STAGE) : 0;
  static constexpr int KV_ELEMS = 2 * TMAX * LDK;   // K then V of one head
  static constexpr int KV_BUFS = ATT_WGMMA ? 0 : (2 * KV_ELEMS * 2 <= AVAIL ? 2 : 1);
  static constexpr int ATT_BYTES = ATT_WGMMA ? ATT_STAGES * G::STAGE : KV_BUFS * KV_ELEMS * 2;
  static constexpr int REGION = cmax(RING_BYTES + SA_BYTES, ATT_BYTES);
  static constexpr int SMEM_BYTES = REGION + SX_BYTES + BAR_BYTES;
  using B = Bars<REGION + SX_BYTES>;
  static constexpr int THIN_PART = CT * 8;   // partial sums of the thin path's products
  static constexpr int THIN_FLOATS = THIN_PART + 7 * E + F + H + H * TMAX;
  static constexpr int WS_ELEMS = TMAX * E3 + (RESIDENT ? 0 : 2 * HALF * E);
  static_assert(E == H * DH && DH % 16 == 0 && DH >= 16 && DH <= 128,
                "head dim a multiple of 16 from 16 to 128");
  static_assert(E <= 256, "fc2 sums of 64 rows x E in a warpgroup's registers: E / 2 a thread");
  static_assert(STAGES >= 3, "the MLP's pipeline holds three tiles");
  static_assert(!ATT_WGMMA || ATT_STAGES >= 1, "an attention stage");
  static_assert(ATT_WGMMA || KV_BUFS >= 1, "a K and V buffer");
  static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared memory per block");
  static_assert(THIN_FLOATS * 4 <= RING_BYTES, "thin-path scratch in the ring");
  static_assert(SLOT % 1024 == 0 && SA_BYTES % 1024 == 0, "swizzled tiles 1024-aligned");

  // Element offset of (row r, column k) of sA: the K-major core-matrix
  // layout of wgmma's A operand, 8-row groups 128 bytes apart, 8-column
  // groups HALF * 16 bytes apart.
  static __device__ __forceinline__ int sa(int r, int k) {
    return (k >> 3) * (HALF * 8) + (r >> 3) * 64 + (r & 7) * 8 + (k & 7);
  }
  // Descriptors of sA's rows r0 .. r0 + 63 at columns k0 .. k0 + 15, and of
  // the k-th 16-row slice of a ring tile (64-column boxes BOX_BYTES apart,
  // 128-byte swizzle, MN-major).
  static __device__ __forceinline__ uint64_t desc_a(const bf16* sA, int r0, int k0) {
    return wg::make_desc(sA + sa(r0, k0), HALF * 16, 128);
  }
  static __device__ __forceinline__ uint64_t desc_w(const unsigned char* tile, int k) {
    return wg::make_desc_sw128(tile + k * 2048, BOX_BYTES, 1024);
  }

  // The consumers' side of the ring: tile t sits in slot t % STAGES.
  struct Ring {
    int t;   // the next tile
    static __device__ __forceinline__ const unsigned char* wait(int i) {
      gemm::mbar_wait(B::full(i % STAGES), (i / STAGES) & 1);
      return smem + (i % STAGES) * SLOT;
    }
    static __device__ __forceinline__ void release(int i) {
      if ((threadIdx.x & 31) == 0) gemm::mbar_arrive(B::empty(i % STAGES));
    }
  };

  // sA rows r0 .. r0 + 15 = bf16(LN(src) * g), src the stream's rows (LDX
  // apart), by one warp, 8 rows at a time: lane l takes row l % 8 and the
  // 8-column chunks l / 8, + 4, ..., 16-byte loads and stores (the 8 lanes
  // of a chunk write one core matrix of sA), the row's sums over the 4
  // lanes that share it.  Each pass (sum, squares, output) reads the rows
  // again from shared memory, so that few registers are live beside the
  // products' accumulators.
  static __device__ __forceinline__ void ln_rows(const bf16* src, bf16* sA, int r0,
                                                 const float* g) {
    constexpr int Q = E / 8, NQ = (Q + 3) / 4;   // chunks of a row, of a lane
    const int lane = tid_here() & 31, q0 = lane >> 3;
#pragma unroll 1
    for (int p = 0; p < 2; ++p) {
      const int r = 8 * p + (lane & 7);
      const bf16* row = src + r * LDX + 8 * q0;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        if (q0 + 4 * i < Q) {
          float v[8];
          load8(row + 32 * i, v);
#pragma unroll
          for (int k = 0; k < 8; ++k) s += v[k];
        }
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      const float mu = s * (1.f / E);
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        if (q0 + 4 * i < Q) {
          float v[8];
          load8(row + 32 * i, v);
#pragma unroll
          for (int k = 0; k < 8; ++k) q += (v[k] - mu) * (v[k] - mu);
        }
      q += __shfl_xor_sync(0xffffffffu, q, 8);
      q += __shfl_xor_sync(0xffffffffu, q, 16);
      const float rs = rsqrtf(q * (1.f / E) + LN_EPS);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int c = 8 * (q0 + 4 * i);
        if (c < E) {
          float v[8];
          load8(row + 32 * i, v);
          const float4 g0 = *reinterpret_cast<const float4*>(g + c);
          const float4 g1 = *reinterpret_cast<const float4*>(g + c + 4);
          const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = (v[k] - mu) * rs * gs[k];
          store8(sA + sa(r0 + r, c), v);
        }
      }
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
  static __device__ __forceinline__ void embed(const int* tok, const bf16* wte, const bf16* wpe,
                                               bf16* sX, bf16* park, int T, int halves,
                                               int vocab) {
    constexpr int V8 = E / 8;
    for (int i = tid_here(); i < halves * HALF * V8; i += CT) {
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
  static __device__ __forceinline__ void swap_halves(bf16* sX, bf16* park, int& pk) {
    constexpr int V8 = E / 8;
    bf16* out = park + (pk ^ 1) * HALF * E;
    const bf16* in = park + pk * HALF * E;
    cbar();
    for (int i = tid_here(); i < HALF * V8; i += CT) {
      const int r = i / V8, col = (i - r * V8) * 8;
      __stcg(reinterpret_cast<uint4*>(out + r * E + col),
             *reinterpret_cast<const uint4*>(sX + r * LDX + col));
    }
    cbar();
    copy_tile(sX, LDX, in, E, HALF, E);
    attn::cp_async_commit();
    attn::cp_async_wait<0>();
    cbar();
    pk ^= 1;
  }

  // acc = sA's 64 rows of the warpgroup (all E columns) times the NK ring
  // tiles from ring.t on ([64 x NP] each), one k-tile in flight behind the
  // next; each tile freed once its products are done.  The loops unroll
  // whole, so that no branch sits between two products (ptxas serialises
  // the products of a branching sequence); a warpgroup whose rows all lie
  // past T computes on finite padding and stores nothing.
  // With KEEP_LAST the last tile is not freed: the caller stages its
  // epilogue there (returned) and frees it.
  template <bool RUN, bool KEEP_LAST = false>
  static __device__ __forceinline__ unsigned char* product(float (*acc)[4], const bf16* sA,
                                                           Ring& ring) {
    const int r0 = (tid_here() >> 7) * 64;
    const unsigned char* tile = nullptr;
#pragma unroll
    for (int kt = 0; kt < NK; ++kt) {
      tile = ring.wait(ring.t + kt);
      if constexpr (RUN) {
        wg::fence_operands<NP / 8>(acc);
        wg::fence();
#pragma unroll
        for (int k = 0; k < KS / 16; ++k)
          if (kt < NK - 1 || k < KS_LAST)
            wg::Mma<NP>::template run<0, 1>(acc, desc_a(sA, r0, opaque(kt * KS + 16 * k)),
                                            desc_w(tile, opaque(k)), kt + k > 0 ? 1 : 0);
        wg::commit();
        wg::wait<1>();   // the previous tile's products are done: free it
        wg::fence_operands<NP / 8>(acc);
      }
      if (kt > 0) ring.release(ring.t + kt - 1);
    }
    if constexpr (RUN) {
      wg::wait<0>();
      wg::fence_operands<NP / 8>(acc);
    }
    if constexpr (!KEEP_LAST) ring.release(ring.t + NK - 1);
    ring.t += NK;
    return const_cast<unsigned char*>(tile);
  }

  // q|k|v columns n_off .. of the half's rows (LN1 in sA), `tiles` products
  // of NP columns E apart (q, k, v; the last layer's k, v) -> the workspace
  // rows `out` (3E apart), rounded to bf16 in registers.  Where a product is
  // at least two boxes wide (STAGED), each warpgroup stages a 64 x 64 box at
  // a time in its half of the last k-tile's slot (128-byte swizzle, kept
  // from the producer until the stores have read it) and stores it by TMA;
  // a box that reaches past E is stored from the registers.
  static constexpr bool STAGED = NP >= 128;
  static __device__ __forceinline__ void qkv_half(const Maps& maps, const bf16* sA, bf16* out,
                                                  int row0, int n_off, int tiles, bool active,
                                                  Ring& ring) {
    const int tid = tid_here(), lane = tid & 31, warp = tid >> 5, g = lane >> 2, c4 = lane & 3;
    const int cw = warp >> 2;
    constexpr bool RUN = !(SKIP & SKIP_QKV);
#pragma unroll 1
    for (int nt = 0; nt < tiles; ++nt) {
      float acc[NP / 8][4];
      unsigned char* last = product<RUN, STAGED>(acc, sA, ring);
      const int c0 = n_off + nt * E;
      if constexpr (STAGED) {
        cbar();   // both warpgroups' products have read the tile
        unsigned char* box = last + cw * BOX_BYTES;
        unsigned char* row = box + ((warp & 3) * 16 + g) * 128 + 4 * c4;
#pragma unroll
        for (int b = 0; b < NP / 64; ++b) {
          if (64 * (b + 1) <= E) {
            if (b > 0) {   // the previous box's store has read the buffer
              if ((tid & 127) == 0) gemm::bulk_wait<true>();
              gemm::wg_barrier(1 + cw);
            }
            if (RUN) {
#pragma unroll
              for (int jj = 0; jj < 8; ++jj) {
                const int j = 8 * b + jj;
                *reinterpret_cast<unsigned*>(row + ((jj ^ g) << 4)) =
                    attn::pack_bf16(acc[j][0], acc[j][1]);
                *reinterpret_cast<unsigned*>(row + 8 * 128 + ((jj ^ g) << 4)) =
                    attn::pack_bf16(acc[j][2], acc[j][3]);
              }
            }
            wg::fence_proxy();
            gemm::wg_barrier(1 + cw);
            if ((tid & 127) == 0) {
              tma_store_3d(&maps.qkv_out, box, c0 + 64 * b, row0 + cw * 64, blockIdx.x);
              gemm::bulk_commit();
            }
          } else if (64 * b < E && RUN && active) {
            bf16* o = out + (size_t)(warp * 16 + g) * E3 + c0 + 2 * c4;
#pragma unroll
            for (int j = 8 * b; j < E / 8; ++j) {
              st32(o + 8 * j, acc[j][0], acc[j][1]);
              st32(o + 8 * E3 + 8 * j, acc[j][2], acc[j][3]);
            }
          }
        }
        if ((tid & 127) == 0) gemm::bulk_wait<true>();   // the slot is read: free it
        gemm::wg_barrier(1 + cw);
        ring.release(ring.t - 1);
      } else if (RUN && active) {
        bf16* o = out + (size_t)(warp * 16 + g) * E3 + c0 + 2 * c4;
#pragma unroll
        for (int j = 0; j < E / 8; ++j) {
          st32(o + 8 * j, acc[j][0], acc[j][1]);
          st32(o + 8 * E3 + 8 * j, acc[j][2], acc[j][3]);
        }
      }
    }
  }

  // The warpgroup's TMA stores of q|k|v have landed (the thread that issued
  // them waits), before the attention's loads or the thin path read them.
  static __device__ __forceinline__ void qkv_stored() {
    if (STAGED && (threadIdx.x & 127) == 0) {
      gemm::bulk_wait<false>();
      fence_proxy_global();
    }
  }

  // Attention of the warp's rows r0 .. r0 + 15 for head h against K and V
  // (keys 0 .. T - 1, rows LDK apart, zero past T up to a multiple of KC);
  // the output overwrites the rows' Q columns of head h in the workspace.
  // mma.sync, for head dims 80-128.
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

  // Attention of every row block and head at head dims 80-128; K and V of
  // head h staged once into kv (one buffer, or two in turn so that head
  // h + 1 loads while h runs), by the consumers.
  static __device__ __forceinline__ void attention_sync(bf16* qkv, int T, bf16* kv) {
    const int tid = threadIdx.x, warp = tid >> 5;
    const int TK = attn::round_up(T, KC), TP = attn::round_up(T, 16);
    auto stage = [&](int h, bf16* buf) {
      attn::stage_rows_async<DH>(buf, qkv + E + h * DH, E3, 0, TK, T, tid, CT);
      attn::stage_rows_async<DH>(buf + TMAX * LDK, qkv + 2 * E + h * DH, E3, 0, TK, T, tid, CT);
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
      cbar();
      for (int r0 = warp * 16; r0 < TP; r0 += WARPS * 16)
        attention_rows(qkv, r0, h, buf, buf + TMAX * LDK, T);
      cbar();
      if constexpr (KV_BUFS == 1) {
        if (h + 1 < H) {
          stage(h + 1, kv);
          attn::cp_async_commit();
        }
      }
    }
  }

  // Attention of every head at head dims 16-64 on attn_wgmma.cuh's tile:
  // the producer fills the stages (head a of the CTA's sequence in stage
  // a % ATT_STAGES); the warpgroups take the 64-row query tiles in turn
  // (item: the CTA's running count of tiles, which the ticket follows); O
  // stored by TMA over the head's Q columns, complete when this returns.
  static __device__ __forceinline__ void attention_wgmma(const aw::BlocksIo& io, int T, int& a,
                                                         int& item) {
    const int cw = threadIdx.x >> 7;
    const int nt = (T + aw::ROWS - 1) / aw::ROWS;
#pragma unroll 1
    for (int h = 0; h < H; ++h, ++a) {
      const int s = a % ATT_STAGES;
      gemm::mbar_wait(B::att_full(s), (a / ATT_STAGES) & 1);
      unsigned char* qs = smem + s * G::STAGE;
#pragma unroll 1
      for (int t = 0; t < nt; ++t, ++item)
        if (!(SKIP & SKIP_ATTENTION) && (item & 1) == cw)
          aw::tile<DH, bf16, true>(io, blockIdx.x * H + h, t, item, T, 1.f, qs, qs + G::TILE,
                                   qs + 2 * G::TILE, B::ticket());
      // the stage's O stores have read it; then free it
      if ((threadIdx.x & 31) == 0) gemm::bulk_wait<true>();
      wg::fence_proxy();
      gemm::wg_barrier(1 + cw);
      if ((threadIdx.x & 127) == 0) gemm::mbar_arrive(B::att_empty(s));
    }
    if ((threadIdx.x & 31) == 0) {   // the O stores have landed
      gemm::bulk_wait<false>();
      fence_proxy_global();
    }
  }

  // x = bf16(x + bf16(v)) on two neighbouring values of the stream.
  static __device__ __forceinline__ void residual_add(bf16* x, float v0, float v1) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
    st32(x, f.x + rbf(v0), f.y + rbf(v1));
  }

  // the warp's 16 rows of the stream += the accumulators' E columns
  static __device__ __forceinline__ void residual_rows(bf16* xh, const float (*acc)[4]) {
    const int tid = tid_here(), lane = tid & 31, warp = tid >> 5;
    bf16* x = xh + (warp * 16 + (lane >> 2)) * LDX + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < E / 8; ++j) {
      residual_add(x + j * 8, acc[j][0], acc[j][1]);
      residual_add(x + 8 * LDX + j * 8, acc[j][2], acc[j][3]);
    }
  }

  // x = bf16(x + bf16(att @ Wproj)) for the half's rows: each warpgroup
  // copies its 64 attention rows `att` (3E apart in the workspace) into sA
  // by cp.async, then the product.
  static __device__ __forceinline__ void proj_half(bf16* xh, bf16* sA, const bf16* att,
                                                   bool wg_active, bool active, Ring& ring) {
    constexpr int KG = E / 8;
    constexpr bool RUN = !(SKIP & SKIP_PROJ);
    const int cw = tid_here() >> 7, tid = tid_here() & 127;
    if (RUN && wg_active) {
      // 16-byte chunk (row m, columns 8kg ..): 8 lanes a core matrix
      for (int i = tid; i < 64 * KG; i += 128) {
        const int q = i >> 3, kg = q % KG, m = cw * 64 + (q / KG) * 8 + (i & 7);
        attn::cp_async16(sA + sa(m, kg * 8), att + (size_t)m * E3 + kg * 8);
      }
      attn::cp_async_commit();
      attn::cp_async_wait<0>();
      wg::fence_proxy();
    }
    gemm::wg_barrier(1 + cw);
    float acc[NP / 8][4];
    product<RUN>(acc, sA, ring);
    if (RUN && active) residual_rows(xh, acc);
  }

  // 16 hidden columns kk of hc (the fc chunk's C fragments) ->
  // bf16(gelu(bf16(hc))) as fc2's register A fragment.
  static __device__ __forceinline__ void gelu_pack(const float (*hc)[4], int kk, unsigned ha[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* f = hc[2 * kk + (i >> 1)] + 2 * (i & 1);
      ha[i] = attn::pack_bf16(gelu_tanh(rbf(f[0])), gelu_tanh(rbf(f[1])));
    }
  }

  // fc of chunk c: hc = sA's 64 rows (LN2, all E columns) times the [E x 64] tile
  static __device__ __forceinline__ void issue_fc(float (*hc)[4], const bf16* sA, int r0,
                                                  const unsigned char* tile) {
#pragma unroll
    for (int k = 0; k < E / 16; ++k)
      wg::Mma<FC>::template run<0, 1>(hc, desc_a(sA, r0, opaque(16 * k)), desc_w(tile, opaque(k)),
                                      k == 0 ? 0 : 1);
  }

  // One MLP chunk c whose fc is done (in hc): its GELU into the register A
  // fragments, then its fc2 (acc2 += the fragments times the chunk's
  // [64 x NP] tile of Wfc2) and (MORE) chunk c + 1's fc into hc, issued
  // together and waited for.  Ring tiles: fc of chunk c at t0 + 2c, its fc2
  // at t0 + 2c + 1.  While one warpgroup runs its GELU, the other's products
  // have the tensor cores.
  template <bool MORE>
  static __device__ __forceinline__ void mlp_chunk(int c, int t0, float (*acc2)[4],
                                                   float (*hc)[4], const bf16* sA, Ring& ring) {
    const int r0 = (tid_here() >> 7) * 64;
    unsigned ha[FC / 16][4];
#pragma unroll
    for (int kk = 0; kk < FC / 16; ++kk) gelu_pack(hc, kk, ha[kk]);
    const unsigned char* tile2 = ring.wait(t0 + 2 * c + 1);
    wg::fence_operands<NP / 8>(acc2);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < FC / 16; ++kk)
      wg::MmaRs<NP>::template run<1>(acc2, ha[kk], desc_w(tile2, opaque(kk)),
                                     c == 0 && kk == 0 ? 0 : 1);
    wg::commit();
    if constexpr (MORE) {
      const unsigned char* tile = ring.wait(t0 + 2 * c + 2);
      wg::fence_operands<FC / 8>(hc);
      wg::fence();
      issue_fc(hc, sA, r0, tile);
      wg::commit();
    }
    wg::wait<0>();
    wg::fence_operands<NP / 8>(acc2);
    wg::fence_operands<FC / 8>(hc);
    keep<FC / 16>(ha);
    ring.release(t0 + 2 * c + 1);
    if constexpr (MORE) ring.release(t0 + 2 * c + 2);
  }

  // x = bf16(x + bf16(gelu(bf16(bf16(LN(x) * g2) @ Wfc)) @ Wfc2)) for the
  // half's rows, FC hidden columns a chunk: each warpgroup's 64 rows by
  // wgmma, the fc2 sums in its accumulators throughout.
  static __device__ __forceinline__ void mlp_half(bf16* xh, bf16* sA, const float* g2,
                                                  bool active, Ring& ring) {
    constexpr bool RUN = !(SKIP & SKIP_MLP);
    const int warp = tid_here() >> 5, cw = warp >> 2, r0 = cw * 64;
    if (RUN && active) ln_rows(xh + warp * 16 * LDX, sA, warp * 16, g2);
    wg::fence_proxy();
    gemm::wg_barrier(1 + cw);
    const int t0 = ring.t;
    if constexpr (!RUN) {
#pragma unroll 1
      for (int i = t0; i < t0 + 2 * NC; ++i) {
        ring.wait(i);
        ring.release(i);
      }
    } else {
      float acc2[NP / 8][4];
      float hc[FC / 8][4];
      const unsigned char* tile = ring.wait(t0);
      wg::fence_operands<FC / 8>(hc);
      wg::fence();
      issue_fc(hc, sA, r0, tile);
      wg::commit();
      wg::wait<0>();
      wg::fence_operands<FC / 8>(hc);
      ring.release(t0);
#pragma unroll 1
      for (int c = 0; c < NC - 1; ++c) mlp_chunk<true>(c, t0, acc2, hc, sA, ring);
      mlp_chunk<false>(NC - 1, t0, acc2, hc, sA, ring);
      if (active) residual_rows(xh, acc2);
    }
    ring.t = t0 + 2 * NC;
  }

  // y[j] = sum_k x[k] W[k * ld + j] for j < M (x fp32 in shared memory, W
  // bf16), by the consumers: 8 columns a thread (16-byte loads), the K rows
  // split into CT / (M / 8) ranges whose partial sums (part) add in order.
  template <int K, int M>
  static __device__ __forceinline__ void gemv(const float* x, const bf16* W, int ld, float* part,
                                              float* y) {
    constexpr int G8 = M / 8, S = CT / G8, KR = (K + S - 1) / S;
    static_assert(G8 <= CT && S * M <= THIN_PART, "gemv ranges");
    const int tid = threadIdx.x;
    if (tid < G8 * S) {
      const int col = (tid % G8) * 8, s = tid / G8, k1 = cmin(K, (s + 1) * KR);
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
    cbar();
    for (int j = tid; j < M; j += CT) {
      float sum = 0.f;
      for (int r = 0; r < S; ++r) sum += part[r * M + j];
      y[j] = sum;
    }
    cbar();
  }

  // The thinned last layer for position T-1, final LN and the tied head, as
  // fp32 dot products over the consumers (weights and K/V read through L2).
  // K/V of all positions are in qkv; sA's row r is LN1 of the last row, x the row.
  static __device__ __forceinline__ void last_position(
      const bf16* qkv, const bf16* x, const bf16* sA, int r, const bf16* Wqkv, const bf16* Wproj,
      const bf16* Wfc, const bf16* Wfc2, const float* g2, const float* gf, const float* wht,
      int T, int vocab, float* thin, float* out) {
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

    for (int j = tid; j < E; j += CT) v_s[j] = __bfloat162float(sA[sa(r, j)]);
    cbar();
    gemv<E, E>(v_s, Wqkv, E3, part, q_s);
    for (int j = tid; j < E; j += CT) q_s[j] = rbf(q_s[j]);
    cbar();
    for (int i = tid; i < H * T; i += CT) {
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
    cbar();
    for (int h = warp; h < H; h += WARPS) {
      float s = 0.f;
      for (int t = lane; t < T; t += 32) s += p_s[h * TMAX + t];
      s = warp_sum(s);
      if (lane == 0) den_s[h] = s;
    }
    {   // att = bf16((p @ V) / sum p): 8 columns a thread, the keys split in ranges
      constexpr int G8 = E / 8, S = CT / G8;
      const int TR = (T + S - 1) / S;
      if (tid < G8 * S) {
        const int col = (tid % G8) * 8, s = tid / G8, h = col / DH, t1 = min(T, (s + 1) * TR);
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
      cbar();
      for (int j = tid; j < E; j += CT) {
        float sum = 0.f;
        for (int r2 = 0; r2 < S; ++r2) sum += part[r2 * E + j];
        att_s[j] = rbf(sum * (1.f / den_s[j / DH]));
      }
      cbar();
    }
    gemv<E, E>(att_s, Wproj, E, part, v_s);
    for (int j = tid; j < E; j += CT) xl_s[j] = rbf(__bfloat162float(x[j]) + rbf(v_s[j]));
    cbar();
    if (warp == 0) ln_vec(xl_s, xn2_s, g2, true);
    cbar();
    gemv<E, F>(xn2_s, Wfc, F, part, h_s);
    for (int m = tid; m < F; m += CT) h_s[m] = rbf(gelu_tanh(rbf(h_s[m])));
    cbar();
    gemv<F, E>(h_s, Wfc2, E, part, v_s);
    for (int j = tid; j < E; j += CT) xl_s[j] = rbf(xl_s[j] + rbf(v_s[j]));
    cbar();
    if (warp == 0) ln_vec(xl_s, xf_s, gf, false);
    cbar();
    {   // the tied head: vocab columns, E split in S ranges
      const int S = CT / vocab, KR = (E + S - 1) / S;
      if (tid < S * vocab) {
        const int v = tid % vocab, s = tid / vocab, k1 = cmin(E, (s + 1) * KR);
        float acc = 0.f;
#pragma unroll 4
        for (int k = s * KR; k < k1; ++k) acc = fmaf(xf_s[k], wht[k * vocab + v], acc);
        part[s * vocab + v] = acc;
      }
      cbar();
      if (tid < vocab) {
        float sum = 0.f;
        for (int r2 = 0; r2 < S; ++r2) sum += part[r2 * vocab + tid];
        out[tid] = sum;
      }
    }
  }

  // The producer thread: every weight tile the consumers read, in their
  // order, into the ring; the attention stages; the waits that keep the
  // ring and the stages from overwriting what the consumers still use.
  static __device__ __forceinline__ void produce(const Maps& m, int n, int T, int layers) {
    const int halves = attn::round_up(T, 16) > HALF ? 2 : 1;
    int t = 0, a = 0, nws = 0, nad = 0, ncd = 0;
    // the next ring slot, once free, expecting `bytes`
    auto slot = [&](unsigned bytes, uint64_t*& bar) {
      const int s = t % STAGES;
      gemm::mbar_wait(B::empty(s), ((t / STAGES) & 1) ^ 1);
      bar = B::full(s);
      if (SKIP & SKIP_LOADS)
        gemm::mbar_arrive(bar);
      else
        gemm::mbar_expect_tx(bar, bytes);
      ++t;
      return smem + s * SLOT;
    };
    auto load = [&](unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
      if (!(SKIP & SKIP_LOADS)) gemm::tma_load(dst, map, bar, c0, c1);
    };
    // NP / 64 boxes of 64 rows from (column c0, row c1)
    auto boxes = [&](const CUtensorMap* map, int c0, int c1) {
      uint64_t* bar;
      unsigned char* dst = slot(SLOT, bar);
#pragma unroll
      for (int j = 0; j < NP / 64; ++j) load(dst + j * BOX_BYTES, map, bar, c0 + 64 * j, c1);
    };
#pragma unroll 1
    for (int c = blockIdx.x; c < n; c += gridDim.x) {
      if (c != (int)blockIdx.x) gemm::mbar_wait(B::ctx_done(), (ncd++) & 1);
#pragma unroll 1
      for (int l = 0; l < layers; ++l) {
        const bool last = l == layers - 1;
#pragma unroll 1
        for (int hf = 0; hf < halves; ++hf)
#pragma unroll 1
          for (int nt = last ? 1 : 0; nt < 3; ++nt)
#pragma unroll 1
            for (int kt = 0; kt < NK; ++kt) boxes(&m.wqkv, nt * E, l * E + kt * KS);
        if (last) break;
        if constexpr (ATT_WGMMA) {
          gemm::mbar_wait(B::ws_ready(), (nws++) & 1);
          fence_proxy_global();
          // the ring drained: the stages alias it and sA
#pragma unroll 1
          for (int i = t; i < t + STAGES; ++i)
            gemm::mbar_wait(B::empty(i % STAGES), ((i / STAGES) & 1) ^ 1);
#pragma unroll 1
          for (int h = 0; h < H; ++h, ++a) {
            const int s = a % ATT_STAGES;
            gemm::mbar_wait(B::att_empty(s), ((a / ATT_STAGES) & 1) ^ 1);
            gemm::mbar_expect_tx(B::att_full(s), 3u * G::TILE);
            m.io.load(blockIdx.x * H + h, smem + s * G::STAGE, G::TILE, B::att_full(s));
          }
        }
        gemm::mbar_wait(B::att_done(), (nad++) & 1);
#pragma unroll 1
        for (int hf = 0; hf < halves; ++hf) {
#pragma unroll 1
          for (int kt = 0; kt < NK; ++kt) boxes(&m.wproj, 0, l * E + kt * KS);
#pragma unroll 1
          for (int ch = 0; ch < NC; ++ch) {
            uint64_t* bar;
            unsigned char* dst = slot(E * 128, bar);   // [E x 64]: one box of E rows
            load(dst, &m.wfc, bar, ch * FC, l * E);
            boxes(&m.wfc2, 0, l * F + ch * FC);
          }
        }
      }
    }
  }

  static __device__ __forceinline__ void forward(
      const Maps& maps, const int* __restrict__ tokens, const bf16* __restrict__ wte,
      const bf16* __restrict__ wpe, const float* __restrict__ wht, const bf16* __restrict__ wqkv,
      const bf16* __restrict__ wproj, const bf16* __restrict__ wfc, const bf16* __restrict__ wfc2,
      const float* __restrict__ g1, const float* __restrict__ g2, const float* __restrict__ gf,
      float* __restrict__ out, bf16* __restrict__ workspace, int n, int T, int layers,
      int vocab) {
    bf16* sA = reinterpret_cast<bf16*>(smem + RING_BYTES);   // LN / attention rows of a half
    bf16* sX = reinterpret_cast<bf16*>(smem + REGION);       // the stream (a half or both)
    if (threadIdx.x == 0) {
      // TMA's swizzled tiles need a 1024-aligned base
      if (gemm::smem_u32(smem) & 1023) __trap();
      for (int s = 0; s < MAX_STAGES; ++s) {
        gemm::mbar_init(B::full(s), 1);
        gemm::mbar_init(B::empty(s), WARPS);   // each consumer warp frees a tile
      }
      for (int s = 0; s < 3; ++s) {
        gemm::mbar_init(B::att_full(s), 1);
        gemm::mbar_init(B::att_empty(s), 2);   // each consumer warpgroup frees a stage
      }
      gemm::mbar_init(B::ws_ready(), CT);
      gemm::mbar_init(B::att_done(), 1);
      gemm::mbar_init(B::ctx_done(), 1);
      gemm::mbar_init(B::ticket(), 4);   // attn_wgmma.cuh's tile: a warpgroup's warps
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= CT) {
      gemm::setmaxnreg_dec<PRODUCER_REGS>();
      if (threadIdx.x == CT) produce(maps, n, T, layers);
      return;
    }
    gemm::setmaxnreg_inc<CONSUMER_REGS>();

    const int warp = threadIdx.x >> 5, cw = warp >> 2;
    bf16* qkv = workspace + (size_t)blockIdx.x * WS_ELEMS;
    bf16* park = qkv + TMAX * E3;   // two slots of a half each (not RESIDENT)
    const int TP = attn::round_up(T, 16);
    const int halves = TP > HALF ? 2 : 1;
    // the stream rows of half hf: resident, or the one half in sX
    auto xh = [&](int hf) { return RESIDENT ? sX + hf * HALF * LDX : sX; };
    Ring ring{0};
    int a = 0, item = 0;   // attention stages and query tiles so far

#pragma unroll 1
    for (int c = blockIdx.x; c < n; c += gridDim.x) {
      embed(tokens + (size_t)c * T, wte, wpe, sX, park, T, halves, vocab);
      cbar();
      int res = 0, pk = 0;   // the half in sX, the slot of the parked half
#pragma unroll 1
      for (int l = 0; l < layers; ++l) {
        const bool last = l == layers - 1;
        // LN1 and q|k|v of every row, a half at a time (the last layer: K and V)
#pragma unroll 1
        for (int hf = 0; hf < halves; ++hf) {
          if (!RESIDENT && hf != res) {
            swap_halves(sX, park, pk);
            res = hf;
          }
          const bool active = hf * HALF + warp * 16 < TP;
          if (active) ln_rows(xh(hf) + warp * 16 * LDX, sA, warp * 16, g1 + l * E);
          wg::fence_proxy();
          gemm::wg_barrier(1 + cw);
          qkv_half(maps, sA, qkv + (size_t)hf * HALF * E3, hf * HALF, last ? E : 0,
                   last ? 2 : 3, active, ring);
        }
        qkv_stored();
        if (last) {
          cbar();
          const int r = T - 1 - (halves - 1) * HALF;   // row T-1 in the last half
          if (!(SKIP & SKIP_LAST))
            last_position(qkv, xh(halves - 1) + r * LDX, sA, r, wqkv + (size_t)l * E * E3,
                          wproj + (size_t)l * E * E, wfc + (size_t)l * E * F,
                          wfc2 + (size_t)l * F * E, g2 + l * E, gf, wht, T, vocab,
                          reinterpret_cast<float*>(smem), out + (size_t)c * vocab);
          wg::fence_proxy();   // the scratch writes, before TMA refills the ring
          cbar();
          if (threadIdx.x == 0) gemm::mbar_arrive(B::ctx_done());
          break;
        }
        if constexpr (ATT_WGMMA) {
          fence_proxy_global();   // this thread's q|k|v stores, before TMA reads them
          gemm::mbar_arrive(B::ws_ready());
        }
        cbar();
        if constexpr (ATT_WGMMA)
          attention_wgmma(maps.io, T, a, item);
        else if (!(SKIP & SKIP_ATTENTION))
          attention_sync(qkv, T, reinterpret_cast<bf16*>(smem));
        wg::fence_proxy();   // the stages' writes, before TMA refills the ring
        cbar();
        if (threadIdx.x == 0) gemm::mbar_arrive(B::att_done());
        // projection and MLP, the half in sX first
#pragma unroll 1
        for (int i = 0; i < halves; ++i) {
          const int hf = halves - 1 - i;
          if (!RESIDENT && hf != res) {
            swap_halves(sX, park, pk);
            res = hf;
          }
          const bool active = hf * HALF + warp * 16 < TP;
          const bool wg_active = hf * HALF + cw * 64 < TP;
          proj_half(xh(hf), sA, qkv + (size_t)hf * HALF * E3, wg_active, active, ring);
          mlp_half(xh(hf), sA, g2 + l * E, active, ring);
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
fused_gpt_kernel(const __grid_constant__ Maps maps, const int* __restrict__ tokens,
                 const bf16* __restrict__ wte, const bf16* __restrict__ wpe,
                 const float* __restrict__ wht, const bf16* __restrict__ wqkv,
                 const bf16* __restrict__ wproj, const bf16* __restrict__ wfc,
                 const bf16* __restrict__ wfc2, const float* __restrict__ g1,
                 const float* __restrict__ g2, const float* __restrict__ gf,
                 float* __restrict__ out, bf16* __restrict__ workspace, int n, int T, int layers,
                 int vocab) {
  S::forward(maps, tokens, wte, wpe, wht, wqkv, wproj, wfc, wfc2, g1, g2, gf, out, workspace, n,
             T, layers, vocab);
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

// The weight stacks' tensor maps, [layers x in, out] each: Wqkv, Wproj and
// Wfc2 in boxes of 64 rows, Wfc in boxes of all E rows.
int weight_maps(int e, int layers, const bf16* wqkv, const bf16* wproj, const bf16* wfc,
                const bf16* wfc2, CUtensorMap* maps) {
  if (gemm::encode_tiled() == nullptr) return aw::ERR_NO_ENCODER;
  const long long le = (long long)layers * e, f = 4LL * e;
  const cudaError_t errs[4] = {gemm::make_map(&maps[0], wqkv, (int)le, 3 * e, 3 * e, KS),
                               gemm::make_map(&maps[1], wproj, (int)le, e, e, KS),
                               gemm::make_map(&maps[2], wfc, (int)le, (int)f, f, e),
                               gemm::make_map(&maps[3], wfc2, (int)(layers * f), e, e, KS)};
  for (cudaError_t err : errs)
    if (err != cudaSuccess) return aw::ERR_TENSOR_MAP;
  return 0;
}

template <class S>
int launch(const CUtensorMap* wmaps, const int* tokens, const bf16* wte, const bf16* wpe,
           const float* wht, const bf16* wqkv, const bf16* wproj, const bf16* wfc,
           const bf16* wfc2, const float* g1, const float* g2, const float* gf, float* out,
           bf16* workspace, int n, int T, int layers, int vocab, int grid, cudaStream_t stream) {
  if (T < 1 || T > TMAX || vocab > MAX_VOCAB || layers < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  memcpy(&maps.wqkv, wmaps, 4 * sizeof(CUtensorMap));
  if constexpr (S::STAGED) {
    const gemm::EncodeTiled enc = gemm::encode_tiled();
    if (enc == nullptr) return aw::ERR_NO_ENCODER;
    const cuuint64_t dims[3] = {(cuuint64_t)S::E3, (cuuint64_t)TMAX, (cuuint64_t)grid};
    const cuuint64_t strides[2] = {(cuuint64_t)S::E3 * 2, (cuuint64_t)S::WS_ELEMS * 2};
    const cuuint32_t box[3] = {64, 64, 1}, estr[3] = {1, 1, 1};
    if (enc(&maps.qkv_out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, workspace, dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return aw::ERR_TENSOR_MAP;
  }
  if constexpr (S::ATT_WGMMA) {
    // the workspace as [grid, T, 3H, DH] q|k|v and [grid, T, H, DH] att (Q's
    // columns), T rows a context: TMA zero-fills the rows past T
    constexpr int D = S::DH;
    const cuuint64_t dq[4] = {(cuuint64_t)D, 3 * (cuuint64_t)S::H, (cuuint64_t)T,
                              (cuuint64_t)grid};
    const cuuint64_t da[4] = {(cuuint64_t)D, (cuuint64_t)S::H, (cuuint64_t)T, (cuuint64_t)grid};
    const cuuint64_t st[3] = {D * 2, (cuuint64_t)S::E3 * 2, (cuuint64_t)S::WS_ELEMS * 2};
    int rc = aw::encode<D>(&maps.io.qkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, workspace, dq, st, 2,
                           TMAX);
    if (rc == 0)
      rc = aw::encode<D>(&maps.io.att, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, workspace, da, st, 2,
                         16);
    if (rc != 0) return rc;
    maps.io.H = S::H;
  }
  cudaError_t err = cudaFuncSetAttribute(fused_gpt_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  fused_gpt_kernel<S><<<grid, THREADS, S::SMEM_BYTES, stream>>>(
      maps, tokens, wte, wpe, wht, wqkv, wproj, wfc, wfc2, g1, g2, gf, out, workspace, n, T,
      layers, vocab);
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

// The bytes of the weight maps fused_gpt_weight_maps writes.
int fused_gpt_weight_maps_bytes() { return 4 * (int)sizeof(CUtensorMap); }

// The tensor maps of a set of weights at width e (layers x [e, 3e], [e, e],
// [e, 4e], [4e, e] bf16, 16-byte aligned) -> maps (fused_gpt_weight_maps_bytes
// bytes, any alignment); the caller keeps them for every forward on those
// weights.  Returns 0, or a code fused_gpt_error_string names.
int fused_gpt_weight_maps(int e, int layers, const bf16* wqkv, const bf16* wproj, const bf16* wfc,
                          const bf16* wfc2, void* maps) {
  CUtensorMap m[4];
  const int rc = weight_maps(e, layers, wqkv, wproj, wfc, wfc2, m);
  if (rc == 0) memcpy(maps, m, sizeof(m));
  return rc;
}

// Launches the forward of width e with h heads on `stream`; returns the CUDA
// error code (0 = launched; cudaErrorInvalidValue for a width not built or
// T outside 1..256) or one of the tensor-map codes.  wmaps: the weights'
// maps from fused_gpt_weight_maps; tokens: int32 [n, T]; workspace: bf16
// [grid, ws_elems]; out: fp32 [n, vocab].
int fused_gpt_forward(int e, int h, const void* wmaps, const int* tokens, const bf16* wte,
                      const bf16* wpe, const float* wht, const bf16* wqkv, const bf16* wproj,
                      const bf16* wfc, const bf16* wfc2, const float* g1, const float* g2,
                      const float* gf, float* out, bf16* workspace, int n, int T, int layers,
                      int vocab, int grid, cudaStream_t stream) {
  const CUtensorMap* m = static_cast<const CUtensorMap*>(wmaps);
  if (e == FwdA::E && h == FwdA::H)
    return launch<FwdA>(m, tokens, wte, wpe, wht, wqkv, wproj, wfc, wfc2, g1, g2, gf, out,
                        workspace, n, T, layers, vocab, grid, stream);
#ifndef FUSED_GPT_E
  if (e == FwdB::E && h == FwdB::H)
    return launch<FwdB>(m, tokens, wte, wpe, wht, wqkv, wproj, wfc, wfc2, g1, g2, gf, out,
                        workspace, n, T, layers, vocab, grid, stream);
#endif
  return (int)cudaErrorInvalidValue;
}

const char* fused_gpt_error_string(int code) {
  if (code == aw::ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found in the driver";
  if (code == aw::ERR_TENSOR_MAP) return "the driver refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
