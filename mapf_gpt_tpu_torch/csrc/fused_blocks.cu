// GPT layer stack for Hopper (sm_90a): bf16 x [N, T, E] through a chunk of
// layers -> bf16 [N, T, E], or [N, 1, E] (the last position) with the
// chunk's final layer thinned.  T is a runtime argument, any T >= 1.  Built
// with no defines for the 85M's width (E=768, head dim 64, 12 heads);
// -DFUSED_BLOCKS_E=<E> -DFUSED_BLOCKS_DH=<dh> build another width: any E
// and any head dim from 1 to 512 (the static asserts below, which
// ops/fused_blocks.py checks before it starts nvcc).  An E that is not a
// multiple of 8 is stored padded with zero columns to the next one (TMA's
// 16-byte row strides; the wrapper pads x, the weights and the gains, and
// the MLP's 4E likewise), and LayerNorm takes its mean and variance over
// the true E, so that the padding changes nothing.
//
// Replaces the TPU kernel mapf_gpt_tpu/ops/fused_gpt.py::_block_kernel and
// computes what it computes, per layer:
//   xn = bf16(LN(x) * g1)                     (fp32, two-pass, eps 1e-5)
//   q|k|v = bf16(xn @ Wqkv)                   (attention scale * log2(e) folded into W_q)
//   per head: e = bf16(exp2(min(q k^T, 100))) (no max subtraction)
//             att = bf16((e @ v) * (1 / sum e))   (normalised after P@V)
//   x = bf16(x + bf16(att @ Wproj))
//   x = bf16(x + bf16(gelu_tanh(bf16(bf16(LN(x) * g2) @ Wfc)) @ Wfc2))
// and, when last_only, the chunk's final layer thinned: K/V over all T
// positions, but Q, attention, projection and MLP for position T-1 only.
// bf16 between ops, fp32 accumulation; the plain PyTorch version of the same
// arithmetic is mapf_gpt_tpu_torch/ops/fused_blocks.py::blocks_reference.
//
// Heads are laid out padded: each head's q, k, v and attention columns
// take DP = DH rounded up to 16 (the attention tiles' depth), so Wqkv is
// [E, 3 H DP] and Wproj [H DP, E], their extra columns and rows zero (the
// wrapper pads them; none at the repo's models, whose head dims are
// multiples of 16).  Zero columns change neither the scores nor P@V.  A
// head past 128 columns (more than the attention tile holds in registers)
// is cut into NS slabs of DV <= 128 columns, DP = NS DV:
// blocks_attention_wide runs one slab of a head's output a CTA, its scores
// over all DP columns read from shared memory (attn::scores_w).
//
// Bound on an H100 SXM for the 85M's whole stack (12 layers, the last
// thinned) at N = 2048 contexts (the JAX harness's 85M context cap):
// 87.4 TFLOP of bf16 products (11 full layers at 3.825 GFLOP a context, the
// thinned twelfth at 0.617 GFLOP) -> 88 ms at 989 TFLOP/s, against 0.97 GB
// (x in, the last positions out, 170 MB of weights) -> 0.29 ms at 3.35 TB/s.
// It is bound by operations, 95 % of them the GEMMs (24 T E^2 against
// 4 T^2 E a layer).  The bound counts x once in and once out: this design
// sends x to device memory and back between layers, but the function does
// not need that, so those bytes are not in the bound.
//
// Why not the e2e kernel's plan: one context's residual stream is 384 KiB
// (over a block's 227 KB of shared memory) and one layer's weights are
// 14.2 MB (all 12 layers, 170 MB, are over the 50 MB L2; one layer fits).
// So the layer runs as a few wide kernels over a group of up to 256
// contexts (65,536 rows), one layer after another, the group's
// intermediates in a workspace in device memory:
//   * ln_kernel: xn = bf16(LN(x) * g), a warp a row, its own pass (TMA
//     writes the GEMM's A tiles straight to shared memory, so LN is not
//     applied as they are staged);
//   * the GEMMs (LN1 -> QKV, projection, LN2 -> fc, fc2): gemm_tile.cuh,
//     TMA into a ring of 128-byte-swizzled tiles, wgmma.mma_async from two
//     consumer warpgroups, the epilogue on the accumulators: bf16 round,
//     tanh GELU (fc), the residual add (projection, fc2);
//   * blocks_attention: one (64-row query tile, head, context) a CTA, 16
//     query rows a warp, the scores of 64 keys at a time in mma.sync
//     registers (csrc/attn_tile.cuh), K and V staged in windows of 128 keys
//     with zero rows past T; keys at or past T get e = 0, rows past T are
//     not stored;
//   * thin_attention_kernel: the last position's attention, one context a
//     CTA, a warp a head at a time in fp32 on the CUDA cores, the scores of
//     32 keys at a time, so its shared memory does not grow with H or T.
// A full layer is 7 kernel launches per group (LN1, QKV, attention,
// projection, LN2, fc, fc2), the thinned layer 9.  One call of
// fused_blocks_forward runs a whole chunk of layers; the port's chunked
// route makes one such call per forward.  The group's q|k|v (302 MB at the
// 85M) and MLP hidden (403 MB) make a round trip through device memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_blocks.so fused_blocks.cu   (ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "gemm_tile.cuh"

typedef __nv_bfloat16 bf16;

namespace {

#ifndef FUSED_BLOCKS_E
#define FUSED_BLOCKS_E 768       // n_embd of the 85M
#endif
#ifndef FUSED_BLOCKS_DH
#define FUSED_BLOCKS_DH 64       // its head dim
#endif

constexpr int EL = FUSED_BLOCKS_E;     // n_embd
constexpr int E = (EL + 7) / 8 * 8;    // its stored width (TMA's 16-byte row strides)
constexpr int DH = FUSED_BLOCKS_DH;
constexpr int H = EL / DH;             // heads (12 for the 85M)
constexpr int NS = (DH + 127) / 128;   // slabs of a head's attention output
constexpr int DV = ((DH + NS - 1) / NS + 15) / 16 * 16;   // a slab's width
constexpr int DP = NS * DV;            // a head's padded width (DH rounded up to 16 for NS = 1)
constexpr int EA = H * DP;             // attention width (E when DH % 16 == 0)
constexpr int E3 = 3 * EA;             // q|k|v width
constexpr int F = (4 * EL + 7) / 8 * 8;   // MLP hidden width, stored
constexpr float EXP2_CLAMP = 100.f;
constexpr float LN_EPS = 1e-5f;
static_assert(DH >= 1 && DH <= 512, "head dim from 1 to 512");
static_assert(EL % DH == 0, "whole heads");
constexpr int LN_J = (E / 8 + 31) / 32;  // 8-value chunks a lane holds in ln_kernel

constexpr int ATT_WINDOW = 128;        // keys a window of K and V holds
constexpr int THIN_WARPS = 8;

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// tanh-approximated GELU, 0.5 x (1 + tanh(u)) written as x * sigmoid(2u) =
// x / (1 + 2^(-2u log2(e))), as csrc/fused_gpt.cu computes it: one
// ex2.approx and a fast division, within a few fp32 ulp of the accurate
// tanh's.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;           // sqrt(2 / pi)
  const float k1 = -2.f * 1.4426950408889634f;    // -2 log2(e)
  const float u = k0 * (x + 0.044715f * x * x * x);
  return __fdividef(x, 1.f + attn::ex2(k1 * u));
}

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

// y[r] = bf16(LN(x[r]) * g) for M rows [E] (rows ldx and E apart), a warp a
// row: fp32, two passes over the row held in registers.
__global__ void __launch_bounds__(256)
ln_kernel(const bf16* __restrict__ x, long long ldx, const float* __restrict__ g,
          bf16* __restrict__ y, int M) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * ldx;
  float v[LN_J][8];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < LN_J; ++j) {
    const int ci = lane + 32 * j;
    if (ci < E / 8) {
      load8(xr + ci * 8, v[j]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[j][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) s += v[j][i];
  }
  const float mu = warp_sum(s) * (1.f / EL);   // the padding columns hold 0
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < LN_J; ++j) {
    if (lane + 32 * j >= E / 8) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = v[j][i] - mu;
      if (E == EL || (lane + 32 * j) * 8 + i < EL) q += d * d;
    }
  }
  const float rs = rsqrtf(warp_sum(q) * (1.f / EL) + LN_EPS);
  bf16* yr = y + (size_t)row * E;
#pragma unroll
  for (int j = 0; j < LN_J; ++j) {
    const int ci = lane + 32 * j;
    if (ci >= E / 8) continue;
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = (v[j][i] - mu) * rs * g[ci * 8 + i];
    store8(yr + ci * 8, o);
  }
}

// GEMM epilogues (gemm_tile.cuh calls them on adjacent column pairs; each
// output is bf16, staged through shared memory and stored by TMA):
// C = bf16(acc)
struct EpiRound {
  using Side = gemm::NoSide;
  static constexpr bool STAGED = true;
  bf16* c;
  int ldc;
  __device__ Side load(int, int) const { return {}; }
  __device__ float2 value(int, int, float v0, float v1, Side) const { return {v0, v1}; }
};

// C = bf16(gelu_tanh(bf16(acc)))
struct EpiGelu {
  using Side = gemm::NoSide;
  static constexpr bool STAGED = true;
  bf16* c;
  int ldc;
  __device__ Side load(int, int) const { return {}; }
  __device__ float2 value(int, int, float v0, float v1, Side) const {
    return {gelu_tanh(rbf(v0)), gelu_tanh(rbf(v1))};
  }
};

// C = bf16(R + bf16(acc)); R may be C
struct EpiResid {
  using Side = __nv_bfloat162;
  static constexpr bool STAGED = true;
  bf16* c;
  int ldc;
  const bf16* r;
  long long ldr;
  __device__ Side load(int row, int col) const {
    return *reinterpret_cast<const __nv_bfloat162*>(r + (size_t)row * ldr + col);
  }
  __device__ float2 value(int, int, float v0, float v1, Side s) const {
    const float2 x = __bfloat1622float2(s);
    return {x.x + rbf(v0), x.y + rbf(v1)};
  }
};

// Attention of one (64-row query tile, head, context) a CTA, 16 query rows
// a warp: att[c, rows, h*DP ..] from qkv [n, T, 3 EA].  K and V of the head
// in windows of W keys (zero rows past T), e of 64 keys at a time in
// registers, repacked as the A operand of P V.
template <int D>
__global__ void __launch_bounds__(attn::WARPS * 32)
blocks_attention(const bf16* __restrict__ qkv, bf16* __restrict__ att, int T, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = D + 8, NC = attn::KC / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c4 = lane & 3;
  const int h = blockIdx.y, ctx = blockIdx.z;
  const int r0 = blockIdx.x * attn::TILE + warp * 16;
  const bool active = r0 < T;
  const bf16* q = qkv + (size_t)ctx * T * E3 + h * D;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)W * LD;
  bf16* stage = vs + (size_t)W * LD + warp * 16 * LD;

  unsigned qa[D / 16][4];
  if (active) attn::load_q<D>(qa, stage, q, E3, r0, T);
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float rs[2] = {0.f, 0.f};   // this lane's part of its rows' sums of e
  for (int w0 = 0; w0 < T; w0 += W) {
    __syncthreads();   // the previous window's readers are done
    attn::stage_rows_async<D>(ks, q + EA, E3, w0, W, T, threadIdx.x, blockDim.x);
    attn::stage_rows_async<D>(vs, q + 2 * EA, E3, w0, W, T, threadIdx.x, blockDim.x);
    attn::cp_async_commit();
    attn::cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    const int wend = min(W, attn::round_up(T - w0, attn::KC));
    for (int c0 = 0; c0 < wend; c0 += attn::KC) {
      float s[NC][4];
      attn::scores<D, attn::KC / 16>(s, qa, ks + c0 * LD, LD);
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool key_ok = w0 + c0 + j * 8 + 2 * c4 + (e & 1) < T;
          const float x = key_ok ? rbf(exp2f(fminf(s[j][e], EXP2_CLAMP))) : 0.f;
          s[j][e] = x;
          rs[e >> 1] += x;
        }
#pragma unroll
      for (int kk = 0; kk < attn::KC / 16; ++kk) {
        unsigned pa[4];
        attn::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        attn::accumulate<D>(acc, pa, vs + (c0 + kk * 16) * LD, LD);
      }
    }
  }
  if (!active) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / attn::quad_sum(rs[r]);
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= inv[e >> 1];
  attn::store_rows<D>(acc, stage, att + (size_t)ctx * T * EA + h * D, EA, r0, T);
}

// Attention of one (64-row query tile, head, slab of DV output columns,
// context) a CTA for heads wider than 128 columns: the warp's query rows
// staged whole [16][DP + 8] and read as A fragments from shared memory, K
// in windows of W keys at full width, V at the slab's columns; as
// blocks_attention otherwise.  Every slab computes the same e.
__global__ void __launch_bounds__(attn::WARPS * 32)
blocks_attention_wide(const bf16* __restrict__ qkv, bf16* __restrict__ att, int T, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDT = DP + 8, LDV = DV + 8, NC = attn::KC / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c4 = lane & 3;
  const int h = blockIdx.y / NS, slab = blockIdx.y % NS, ctx = blockIdx.z;
  const int r0 = blockIdx.x * attn::TILE + warp * 16;
  const bool active = r0 < T;
  const bf16* q = qkv + (size_t)ctx * T * E3 + h * DP;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)W * LDT;
  bf16* stage = vs + (size_t)W * LDV + warp * 16 * LDT;

  if (active) attn::stage_rows_warp_w(stage, q, E3, r0, 16, T, DP);
  __syncwarp();
  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float rs[2] = {0.f, 0.f};
  for (int w0 = 0; w0 < T; w0 += W) {
    __syncthreads();
    attn::stage_rows_async_w(ks, q + EA, E3, w0, W, T, DP, threadIdx.x, blockDim.x);
    attn::stage_rows_async_w(vs, q + 2 * EA + slab * DV, E3, w0, W, T, DV, threadIdx.x,
                             blockDim.x);
    attn::cp_async_commit();
    attn::cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    const int wend = min(W, attn::round_up(T - w0, attn::KC));
    for (int c0 = 0; c0 < wend; c0 += attn::KC) {
      float s[NC][4];
      attn::scores_w<attn::KC / 16>(s, stage, LDT, ks + c0 * LDT, LDT, DP);
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool key_ok = w0 + c0 + j * 8 + 2 * c4 + (e & 1) < T;
          const float x = key_ok ? rbf(exp2f(fminf(s[j][e], EXP2_CLAMP))) : 0.f;
          s[j][e] = x;
          rs[e >> 1] += x;
        }
#pragma unroll
      for (int kk = 0; kk < attn::KC / 16; ++kk) {
        unsigned pa[4];
        attn::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        attn::accumulate<DV>(acc, pa, vs + (c0 + kk * 16) * LDV, LDV);
      }
    }
  }
  if (!active) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / attn::quad_sum(rs[r]);
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= inv[e >> 1];
  attn::store_rows<DV>(acc, stage, att + (size_t)ctx * T * EA + h * DP + slab * DV, EA, r0, T);
}

// Attention of the last position, one context a CTA, a warp a head at a
// time: att_last[c] from q_last [n, EA] and the K/V of qkv [n, T, 3 EA].  A
// lane scores one key of each 32 (fp32 dot product over DP), then the warp
// adds those 32 keys' e v to its DP columns.
__global__ void __launch_bounds__(THIN_WARPS * 32)
thin_attention_kernel(const bf16* __restrict__ q_last, const bf16* __restrict__ qkv,
                      bf16* __restrict__ att_last, int T) {
  constexpr int DJ = (DP + 31) / 32;
  __shared__ float q_s[THIN_WARPS][DP];
  __shared__ float p_s[THIN_WARPS][32];
  const int c = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kv = qkv + (size_t)c * T * E3;
  for (int h = warp; h < H; h += THIN_WARPS) {
    for (int d = lane; d < DP; d += 32)
      q_s[warp][d] = __bfloat162float(q_last[(size_t)c * EA + h * DP + d]);
    __syncwarp();
    float acc[DJ], den = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[j] = 0.f;
    for (int t0 = 0; t0 < T; t0 += 32) {
      const int t = t0 + lane;
      float p = 0.f;
      if (t < T) {
        const bf16* kr = kv + (size_t)t * E3 + EA + h * DP;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < DP; d += 8) {
          float k8[8];
          load8(kr + d, k8);
#pragma unroll
          for (int i = 0; i < 8; ++i) s += q_s[warp][d + i] * k8[i];
        }
        p = rbf(exp2f(fminf(s, EXP2_CLAMP)));
      }
      den += p;
      p_s[warp][lane] = p;
      __syncwarp();
      const int nt = min(32, T - t0);
      for (int i = 0; i < nt; ++i) {
        const bf16* vr = kv + (size_t)(t0 + i) * E3 + 2 * EA + h * DP;
        const float pi = p_s[warp][i];
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          if (lane + 32 * j < DP) acc[j] += pi * __bfloat162float(vr[lane + 32 * j]);
      }
      __syncwarp();
    }
    const float inv = 1.f / warp_sum(den);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (lane + 32 * j < DP)
        att_last[(size_t)c * EA + h * DP + lane + 32 * j] = __float2bfloat16(acc[j] * inv);
    __syncwarp();
  }
}

cudaError_t layer_norm(const bf16* x, long long ldx, const float* g, bf16* y, int M,
                       cudaStream_t stream) {
  ln_kernel<<<(M + 7) / 8, 256, 0, stream>>>(x, ldx, g, y, M);
  return cudaGetLastError();
}

size_t attention_smem(int W) { return ((size_t)2 * W + attn::TILE) * (DP + 8) * sizeof(bf16); }

// Keys a window of the wide attention holds within attn::WIDE_BUDGET.
constexpr int WIDE_WINDOW =
    (int)((attn::WIDE_BUDGET - (size_t)attn::TILE * (DP + 8) * 2) / ((DP + 8 + DV + 8) * 2)) /
    attn::KC * attn::KC;
static_assert(NS == 1 || WIDE_WINDOW >= attn::KC, "a wide head's window fits shared memory");

cudaError_t attention(const bf16* qkv, bf16* att, int nc, int T, cudaStream_t stream) {
  if constexpr (NS > 1) {
    const int W = T < WIDE_WINDOW ? attn::round_up(T, attn::KC) : WIDE_WINDOW;
    const size_t smem = ((size_t)W * (DP + 8 + DV + 8) + (size_t)attn::TILE * (DP + 8)) * 2;
    cudaError_t err = cudaFuncSetAttribute(blocks_attention_wide,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((T + attn::TILE - 1) / attn::TILE, H * NS, nc);
    blocks_attention_wide<<<grid, attn::WARPS * 32, smem, stream>>>(qkv, att, T, W);
    return cudaGetLastError();
  }
  constexpr int D1 = NS == 1 ? DP : 16;   // the register tile's head (not built for wide heads)
  const int W = T < ATT_WINDOW ? attn::round_up(T, attn::KC) : ATT_WINDOW;
  const size_t smem = attention_smem(W);
  cudaError_t err = cudaFuncSetAttribute(blocks_attention<D1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + attn::TILE - 1) / attn::TILE, H, nc);
  blocks_attention<D1><<<grid, attn::WARPS * 32, smem, stream>>>(qkv, att, T, W);
  return cudaGetLastError();
}

#define RETURN_IF_ERROR(call)                  \
  do {                                         \
    const cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

}  // namespace

extern "C" {

// Shape constants the kernels were built for, for the wrapper's checks:
// n_embd, heads and a head's padded width.
int fused_blocks_config(int* e, int* h, int* dp) {
  *e = EL;
  *h = H;
  *dp = DP;
  return 0;
}

// bf16 elements of the workspace for groups of `group` contexts of T
// positions: xn [group, T, E], q|k|v [group, T, 3 EA], attention [group, T,
// EA], MLP hidden [group, T, 4E], the last positions' xn [group, E], q and
// attention [group, EA] each.  Every piece starts 16-byte aligned.
long long fused_blocks_workspace(int group, int T) {
  return (long long)group * T * (E + E3 + EA + F) + (long long)group * (E + 2 * EA);
}

// Runs `layers` layers on the stream x [n, T, E] in place, on `stream`, in
// groups of `group` contexts; when last_only, the final layer is thinned
// and its last-position output goes to out_last [n, E] (x then holds the
// input of that layer).  Weights: wqkv [layers, E, 3 EA], wproj [layers,
// EA, E], wfc [layers, E, 4E], wfc2 [layers, 4E, E] bf16, heads padded to
// DP columns; gains g1, g2 [layers, E] fp32.  Returns the first CUDA error
// of a launch (0 = all launched).
int fused_blocks_forward(bf16* x, bf16* out_last, const bf16* wqkv, const bf16* wproj,
                         const bf16* wfc, const bf16* wfc2, const float* g1, const float* g2,
                         bf16* workspace, int n, int T, int layers, int last_only, int group,
                         cudaStream_t stream) {
  if (group <= 0 || layers <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)group * T;
  bf16* xn = workspace;
  bf16* qkv = xn + rows * E;
  bf16* att = qkv + rows * E3;
  bf16* hid = att + rows * EA;
  bf16* xn_last = hid + rows * F;
  bf16* q_last = xn_last + (size_t)group * E;
  bf16* att_last = q_last + (size_t)group * EA;
  for (int c0 = 0; c0 < n; c0 += group) {
    const int nc = n - c0 < group ? n - c0 : group;
    const int M = nc * T;
    bf16* xg = x + (size_t)c0 * T * E;
    for (int l = 0; l < layers; ++l) {
      const bf16* Wqkv = wqkv + (size_t)l * E * E3;
      const bf16* Wproj = wproj + (size_t)l * EA * E;
      const bf16* Wfc = wfc + (size_t)l * E * F;
      const bf16* Wfc2 = wfc2 + (size_t)l * F * E;
      const float* G1 = g1 + (size_t)l * E;
      const float* G2 = g2 + (size_t)l * E;
      RETURN_IF_ERROR(layer_norm(xg, E, G1, xn, M, stream));
      if (!(last_only && l == layers - 1)) {
        RETURN_IF_ERROR((gemm::run<false, false>(xn, E, Wqkv, E3, M, E3, E, EpiRound{qkv, E3},
                                                 stream)));
        RETURN_IF_ERROR(attention(qkv, att, nc, T, stream));
        RETURN_IF_ERROR((gemm::run<false, false>(att, EA, Wproj, E, M, E, EA,
                                                 EpiResid{xg, E, xg, E}, stream)));
        RETURN_IF_ERROR(layer_norm(xg, E, G2, xn, M, stream));
        RETURN_IF_ERROR((gemm::run<false, false>(xn, E, Wfc, F, M, F, E, EpiGelu{hid, F},
                                                 stream)));
        RETURN_IF_ERROR((gemm::run<false, false>(hid, F, Wfc2, E, M, E, F,
                                                 EpiResid{xg, E, xg, E}, stream)));
        continue;
      }
      // thinned final layer: K|V of every row, the rest for row T-1 only
      bf16* xl = out_last + (size_t)c0 * E;
      const bf16* xlast = xg + (size_t)(T - 1) * E;
      RETURN_IF_ERROR((gemm::run<false, false>(xn, E, Wqkv + EA, E3, M, 2 * EA, E,
                                               EpiRound{qkv + EA, E3}, stream)));
      RETURN_IF_ERROR(layer_norm(xlast, (long long)T * E, G1, xn_last, nc, stream));
      RETURN_IF_ERROR((gemm::run<false, false>(xn_last, E, Wqkv, E3, nc, EA, E,
                                               EpiRound{q_last, EA}, stream)));
      thin_attention_kernel<<<nc, THIN_WARPS * 32, 0, stream>>>(q_last, qkv, att_last, T);
      RETURN_IF_ERROR(cudaGetLastError());
      RETURN_IF_ERROR((gemm::run<false, false>(att_last, EA, Wproj, E, nc, E, EA,
                                               EpiResid{xl, E, xlast, (long long)T * E},
                                               stream)));
      RETURN_IF_ERROR(layer_norm(xl, E, G2, xn_last, nc, stream));
      RETURN_IF_ERROR((gemm::run<false, false>(xn_last, E, Wfc, F, nc, F, E, EpiGelu{hid, F},
                                               stream)));
      RETURN_IF_ERROR((gemm::run<false, false>(hid, F, Wfc2, E, nc, E, F, EpiResid{xl, E, xl, E},
                                               stream)));
    }
  }
  return 0;
}

const char* fused_blocks_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
