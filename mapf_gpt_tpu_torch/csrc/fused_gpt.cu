// Fused GPT forward for Hopper (sm_90a): tokens [N, 256] -> last-position
// logits [N, vocab] in one launch.  Built with no defines for the 2M (E=160,
// 5 heads) and the 6M (E=256, 8 heads); both have head dim 32.  Built with
// -DFUSED_GPT_E=<E> -DFUSED_GPT_H=<heads> -DFUSED_GPT_CH=<chunk> for that one
// width instead (ops/fused_gpt.py picks CH and checks the static_asserts of
// Fwd before it starts nvcc).
//
// Replaces the TPU kernel mapf_gpt_tpu/ops/fused_gpt.py::_e2e_kernel and
// computes what it computes:
//   embedding  x = bf16(wte[tok] + wpe[t])                    (bf16 tables)
//   per layer  xn = bf16(LN(x) * g1)                          (fp32, two-pass, eps 1e-5)
//              q|k|v = bf16(xn @ Wqkv)                        (attention scale * log2(e)
//                                                              folded into W_q)
//              per head: e = bf16(exp2(min(q k^T, 100)))      (no max subtraction)
//                        att = bf16((e @ v) * (1 / sum e))    (normalised after P@V)
//              x = bf16(x + bf16(att @ Wproj))
//              x = bf16(x + bf16(gelu_tanh(bf16(bf16(LN(x) * g2) @ Wfc)) @ Wfc2))
//   the last layer is thinned: K/V over all 256 positions, but Q, attention,
//   projection and MLP for position 255 only (the only row the head reads);
//   then fp32 LN and the tied head in fp32.
// bf16 between ops, fp32 accumulation; the plain PyTorch version of the same
// arithmetic is mapf_gpt_tpu_torch/ops/fused_gpt.py::fused_logits_reference.
//
// Bound on an H100 SXM at N = 8192 contexts (the rollout benchmark's batch):
// the 2M needs 6.75 TFLOP of bf16 products (4 full layers at 199 MFLOP a
// context, the thinned fifth at 27 MFLOP) -> 6.8 ms at 989 TFLOP/s, against
// 13.8 MB of tokens, weights and logits -> 4.1 us at 3.35 TB/s; the 6M needs
// 27.5 TFLOP (7 full layers at 470 MFLOP, the thinned eighth at 68 MFLOP)
// -> 27.8 ms.  Both are bound by operations, so the design keeps every
// intermediate on chip or in L2 and spends its bytes on tensor-core products:
//   * a persistent grid (one 256-thread CTA per SM) walks over contexts;
//   * a context's residual stream (256 x E bf16: 80 KiB at E=160, 128 KiB
//     at E=256) stays in shared memory for all layers;
//   * the LN / attention output is kept for a warp's own 16 rows only
//     (16 x E bf16 a warp: 5 KiB at E=160, 8 KiB at E=256), because every
//     phase but attention is row-local and attention reads other rows from
//     q|k|v.  A warp owns row blocks warp and warp + 8; after the all-rows
//     QKV phase it runs, per row block, attention for every head and then
//     projection + MLP, with no block barrier in between.  Shared memory:
//     160 KiB at E=160, 216 KiB at E=256 (two full [T, E] buffers would be
//     256 KiB there, over the 227 KB a block can have);
//   * q|k|v (256 x 3E bf16: 240 KiB at E=160, 384 KiB at E=256) goes to a
//     per-CTA workspace in global memory, which stays in L2 at E=160 and
//     mostly at E=256 (51 MB over 132 CTAs);
//   * every product runs on the tensor cores through WMMA bf16 16x16x16
//     tiles (mma.sync), a warp owning 16 rows;
//   * attention runs the scores of CH keys at a time, so the 256x256 score
//     matrix is never stored; the MLP runs CH hidden columns at a time, the
//     fc2 sums kept in registers, so the 256 x 4E hidden activations are
//     never stored.  CH is 128 at E=160 and 64 at E=256 (shared memory); the
//     order of every sum is the same for either.  At E=256 the fc2 sums take
//     128 registers, so the fc product re-reads its A tiles from shared
//     memory instead of holding them in registers as at E=160.
// Weights are read through L1/L2 (3.2 MB at E=160, 12.6 MB at E=256).  This
// first version leaves wgmma, TMA and a deeper pipeline to later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_gpt.so fused_gpt.cu   (ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int T = 256;           // context length
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RB = T / 16;       // 16-row blocks per context
constexpr int MAX_VOCAB = THREADS;
constexpr float EXP2_CLAMP = 100.f;
constexpr float LN_EPS = 1e-5f;
constexpr int STAGE_BYTES = 16 * 16 * 4;   // one fp32 accumulator tile
constexpr int SMEM_LIMIT = 232448;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k0 * (x + 0.044715f * x * x * x)));
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

// A warp's 16x16 accumulator tile -> 8 values per lane: lane holds row
// lane/2, columns (lane%2)*8 .. +7.
__device__ __forceinline__ void frag_to_lane8(const FragC& c, float* stage, float v[8]) {
  wmma::store_matrix_sync(stage, c, 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31;
  const float4* p = reinterpret_cast<const float4*>(stage + lane * 8);
  float4 a = p[0], b = p[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  __syncwarp();
}

__device__ __forceinline__ int lane_row() { return (threadIdx.x & 31) >> 1; }
__device__ __forceinline__ int lane_col() { return (threadIdx.x & 1) * 8; }

// The forward for one shape: width E, H heads, CH keys / hidden columns per
// chunk.  Fwd<...>::forward is the body of fused_gpt_kernel<Fwd<...>>.
template <int E_, int H_, int CH_>
struct Fwd {
  static constexpr int E = E_;
  static constexpr int H = H_;
  static constexpr int DH = E / H;         // head dim
  static constexpr int E3 = 3 * E;         // q|k|v width
  static constexpr int F = 4 * E;          // MLP hidden width
  static constexpr int KT = E / 16;        // k-tiles over E
  static constexpr int CH = CH_;
  static constexpr int SX_BYTES = T * E * 2;
  static constexpr int XW_BYTES = 16 * E * 2;          // a warp's LN/attention rows
  static constexpr int PBUF_BYTES = 16 * CH * 2;       // one bf16 16 x CH tile
  static constexpr int WARP_SCRATCH = STAGE_BYTES + PBUF_BYTES;
  static constexpr int SMEM_BYTES = SX_BYTES + WARPS * (XW_BYTES + WARP_SCRATCH);
  static constexpr int THIN_FLOATS = 5 * E + H * T + 32 + F;
  // fc A tiles in registers beside the fc2 sums only while both fit
  static constexpr bool FC_A_IN_REGS = KT <= 10;
  static_assert(DH == 32 && E % 32 == 0 && H <= WARPS, "head dim 32, one warp per head");
  static_assert(T % CH == 0 && F % CH == 0 && CH % 16 == 0, "chunking");
  static_assert(THIN_FLOATS * 4 <= WARPS * WARP_SCRATCH, "thin-path scratch");
  static_assert(SMEM_BYTES <= SMEM_LIMIT, "shared memory per block");

  // dst[r] = bf16(LN(src[r]) * g) for 16 rows r, E apart in both.
  static __device__ __forceinline__ void ln_rows(const bf16* src, bf16* dst, const float* g) {
    const int lane = threadIdx.x & 31;
    float gl[E / 32];
#pragma unroll
    for (int j = 0; j < E / 32; ++j) gl[j] = g[lane + 32 * j];
    for (int r = 0; r < 16; ++r) {
      float v[E / 32];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < E / 32; ++j) {
        v[j] = __bfloat162float(src[r * E + lane + 32 * j]);
        s += v[j];
      }
      const float mu = warp_sum(s) * (1.f / E);
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < E / 32; ++j) {
        v[j] -= mu;
        q += v[j] * v[j];
      }
      const float rs = rsqrtf(warp_sum(q) * (1.f / E) + LN_EPS);
#pragma unroll
      for (int j = 0; j < E / 32; ++j)
        dst[r * E + lane + 32 * j] = __float2bfloat16(v[j] * rs * gl[j]);
    }
  }

  // fp32 LN of one row held in shared memory, by one warp.
  static __device__ __forceinline__ void ln_vec(const float* src, float* dst, const float* g,
                                                bool round) {
    const int lane = threadIdx.x & 31;
    float v[E / 32];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < E / 32; ++j) {
      v[j] = src[lane + 32 * j];
      s += v[j];
    }
    const float mu = warp_sum(s) * (1.f / E);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < E / 32; ++j) {
      v[j] -= mu;
      q += v[j] * v[j];
    }
    const float rs = rsqrtf(warp_sum(q) * (1.f / E) + LN_EPS);
#pragma unroll
    for (int j = 0; j < E / 32; ++j) {
      const float y = v[j] * rs * g[lane + 32 * j];
      dst[lane + 32 * j] = round ? rbf(y) : y;
    }
  }

  static __device__ __forceinline__ void load_rows(FragA (&a)[KT], const bf16* src) {
#pragma unroll
    for (int k = 0; k < KT; ++k) wmma::load_matrix_sync(a[k], src + k * 16, E);
  }

  // One 16x16 output tile: A (16 x E, in registers) @ W[:, n0 .. n0+15].
  static __device__ __forceinline__ void tile_product(FragC& c, const FragA (&a)[KT],
                                                      const bf16* W, int ldw, int n0) {
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      FragB b;
      wmma::load_matrix_sync(b, W + k * 16 * ldw + n0, ldw);
      wmma::mma_sync(c, a[k], b, c);
    }
  }

  // The same tile with A (16 x E) read from shared memory tile by tile.
  static __device__ __forceinline__ void tile_product_smem(FragC& c, const bf16* a_rows,
                                                           const bf16* W, int ldw, int n0) {
    wmma::fill_fragment(c, 0.f);
#pragma unroll 4
    for (int k = 0; k < KT; ++k) {
      FragA a;
      FragB b;
      wmma::load_matrix_sync(a, a_rows + k * 16, E);
      wmma::load_matrix_sync(b, W + k * 16 * ldw + n0, ldw);
      wmma::mma_sync(c, a, b, c);
    }
  }

  // dst[:, nt*16 ..] = bf16(A @ Wqkv[:, nt*16 ..]) for nt in [nt0, E3/16).
  static __device__ __forceinline__ void qkv_rows(const FragA (&a)[KT], const bf16* W, int nt0,
                                                  bf16* dst, float* stage) {
    for (int nt = nt0; nt < E3 / 16; ++nt) {
      FragC c;
      tile_product(c, a, W, E3, nt * 16);
      float v[8];
      frag_to_lane8(c, stage, v);
      store8(dst + lane_row() * E3 + nt * 16 + lane_col(), v);
    }
  }

  // x = bf16(x + bf16(v)) on a lane's 8 residual values.
  static __device__ __forceinline__ void residual_add8(bf16* x, const float v[8]) {
    float r[8];
    load8(x, r);
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] += rbf(v[i]);
    store8(x, r);
  }

  // Attention of query rows r0..r0+15 and head h; writes out[0..15, h*DH ..]
  // (out: the warp's 16 rows, E apart).
  static __device__ __forceinline__ void attention_item(const bf16* qkv, int r0, int h,
                                                        bf16* out, float* stage, bf16* pbuf) {
    FragA qa[DH / 16];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wmma::load_matrix_sync(qa[kk], qkv + r0 * E3 + h * DH + kk * 16, E3);
    FragC o[DH / 16];
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) wmma::fill_fragment(o[n], 0.f);
    float rs = 0.f;  // sum of this lane's row, complete in both lanes of a pair
    for (int c0 = 0; c0 < T; c0 += CH) {
      for (int j = 0; j < CH / 16; ++j) {
        const int key0 = c0 + j * 16;
        FragC s;
        wmma::fill_fragment(s, 0.f);
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          FragBT kb;  // K^T tile: element (d, key) at K[key][d]
          wmma::load_matrix_sync(kb, qkv + key0 * E3 + E + h * DH + kk * 16, E3);
          wmma::mma_sync(s, qa[kk], kb, s);
        }
        float v[8];
        frag_to_lane8(s, stage, v);
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v[i] = rbf(exp2f(fminf(v[i], EXP2_CLAMP)));
          part += v[i];
        }
        rs += part + __shfl_xor_sync(0xffffffffu, part, 1);
        store8(pbuf + lane_row() * CH + j * 16 + lane_col(), v);
      }
      __syncwarp();
      for (int kk = 0; kk < CH / 16; ++kk) {
        FragA pa;
        wmma::load_matrix_sync(pa, pbuf + kk * 16, CH);
#pragma unroll
        for (int n = 0; n < DH / 16; ++n) {
          FragB vb;
          wmma::load_matrix_sync(vb, qkv + (c0 + kk * 16) * E3 + 2 * E + h * DH + n * 16, E3);
          wmma::mma_sync(o[n], pa, vb, o[n]);
        }
      }
      __syncwarp();
    }
    const float inv = 1.f / rs;
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      float v[8];
      frag_to_lane8(o[n], stage, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= inv;
      store8(out + lane_row() * E + h * DH + n * 16 + lane_col(), v);
    }
  }

  // Rows r0..r0+15: x += proj(att); xn = LN2(x); x += MLP(xn).  xw holds the
  // rows' attention output on entry and is the LN2 output's buffer after.
  static __device__ __forceinline__ void proj_mlp_rows(int r0, bf16* sX, bf16* xw,
                                                       const bf16* Wproj, const bf16* Wfc,
                                                       const bf16* Wfc2, const float* g2,
                                                       float* stage, bf16* pbuf) {
    FragA a[KT];
    load_rows(a, xw);
    for (int nt = 0; nt < KT; ++nt) {
      FragC c;
      tile_product(c, a, Wproj, E, nt * 16);
      float v[8];
      frag_to_lane8(c, stage, v);
      residual_add8(sX + (r0 + lane_row()) * E + nt * 16 + lane_col(), v);
    }
    __syncwarp();
    ln_rows(sX + r0 * E, xw, g2);
    __syncwarp();
    if constexpr (FC_A_IN_REGS) load_rows(a, xw);
    FragC acc[KT];
#pragma unroll
    for (int n = 0; n < KT; ++n) wmma::fill_fragment(acc[n], 0.f);
    for (int f0 = 0; f0 < F; f0 += CH) {
      for (int j = 0; j < CH / 16; ++j) {
        FragC c;
        if constexpr (FC_A_IN_REGS)
          tile_product(c, a, Wfc, F, f0 + j * 16);
        else
          tile_product_smem(c, xw, Wfc, F, f0 + j * 16);
        float v[8];
        frag_to_lane8(c, stage, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = gelu_tanh(rbf(v[i]));
        store8(pbuf + lane_row() * CH + j * 16 + lane_col(), v);
      }
      __syncwarp();
      for (int kk = 0; kk < CH / 16; ++kk) {
        FragA pa;
        wmma::load_matrix_sync(pa, pbuf + kk * 16, CH);
#pragma unroll
        for (int n = 0; n < KT; ++n) {
          FragB b;
          wmma::load_matrix_sync(b, Wfc2 + (f0 + kk * 16) * E + n * 16, E);
          wmma::mma_sync(acc[n], pa, b, acc[n]);
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      float v[8];
      frag_to_lane8(acc[n], stage, v);
      residual_add8(sX + (r0 + lane_row()) * E + n * 16 + lane_col(), v);
    }
  }

  // The thinned last layer for position T-1, final LN and the tied head.
  // K/V of all positions are in qkv; xn is LN1 of the last row.
  static __device__ void last_position(const bf16* qkv, const bf16* sX, const bf16* xn,
                                       const bf16* Wqkv, const bf16* Wproj, const bf16* Wfc,
                                       const bf16* Wfc2, const float* g2, const float* gf,
                                       const float* wht, int vocab, float* thin, float* out) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    float* q_s = thin;             // [E]
    float* att_s = q_s + E;        // [E]
    float* xl_s = att_s + E;       // [E]
    float* xn2_s = xl_s + E;       // [E]
    float* xf_s = xn2_s + E;       // [E]
    float* p_s = xf_s + E;         // [H * T]
    float* den_s = p_s + H * T;    // [32]
    float* h_s = den_s + 32;       // [F]

    for (int j = tid; j < E; j += THREADS) {
      float acc = 0.f;
      for (int k = 0; k < E; ++k)
        acc += __bfloat162float(xn[k]) * __bfloat162float(Wqkv[k * E3 + j]);
      q_s[j] = rbf(acc);
    }
    __syncthreads();
    for (int i = tid; i < H * T; i += THREADS) {
      const int h = i / T, t = i % T;
      const bf16* kr = qkv + t * E3 + E + h * DH;
      float s = 0.f;
      for (int d = 0; d < DH; ++d) s += q_s[h * DH + d] * __bfloat162float(kr[d]);
      p_s[i] = rbf(exp2f(fminf(s, EXP2_CLAMP)));
    }
    __syncthreads();
    if (warp < H) {
      float s = 0.f;
      for (int t = lane; t < T; t += 32) s += p_s[warp * T + t];
      s = warp_sum(s);
      if (lane == 0) den_s[warp] = s;
    }
    __syncthreads();
    for (int j = tid; j < E; j += THREADS) {
      const int h = j / DH;
      float a = 0.f;
      for (int t = 0; t < T; ++t)
        a += p_s[h * T + t] * __bfloat162float(qkv[t * E3 + 2 * E + j]);
      att_s[j] = rbf(a * (1.f / den_s[h]));
    }
    __syncthreads();
    for (int j = tid; j < E; j += THREADS) {
      float acc = 0.f;
      for (int k = 0; k < E; ++k) acc += att_s[k] * __bfloat162float(Wproj[k * E + j]);
      xl_s[j] = rbf(__bfloat162float(sX[(T - 1) * E + j]) + rbf(acc));
    }
    __syncthreads();
    if (warp == 0) ln_vec(xl_s, xn2_s, g2, true);
    __syncthreads();
    for (int m = tid; m < F; m += THREADS) {
      float acc = 0.f;
      for (int k = 0; k < E; ++k) acc += xn2_s[k] * __bfloat162float(Wfc[k * F + m]);
      h_s[m] = rbf(gelu_tanh(rbf(acc)));
    }
    __syncthreads();
    for (int j = tid; j < E; j += THREADS) {
      float acc = 0.f;
      for (int m = 0; m < F; ++m) acc += h_s[m] * __bfloat162float(Wfc2[m * E + j]);
      xl_s[j] = rbf(xl_s[j] + rbf(acc));
    }
    __syncthreads();
    if (warp == 0) ln_vec(xl_s, xf_s, gf, false);
    __syncthreads();
    if (tid < vocab) {
      float acc = 0.f;
      for (int k = 0; k < E; ++k) acc += xf_s[k] * wht[k * vocab + tid];
      out[tid] = acc;
    }
  }

  static __device__ void forward(const int* __restrict__ tokens, const bf16* __restrict__ wte,
                                 const bf16* __restrict__ wpe, const float* __restrict__ wht,
                                 const bf16* __restrict__ wqkv, const bf16* __restrict__ wproj,
                                 const bf16* __restrict__ wfc, const bf16* __restrict__ wfc2,
                                 const float* __restrict__ g1, const float* __restrict__ g2,
                                 const float* __restrict__ gf, float* __restrict__ out,
                                 bf16* __restrict__ workspace, int n, int layers, int vocab) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* sX = reinterpret_cast<bf16*>(smem);   // residual stream [T, E]
    const int tid = threadIdx.x, warp = tid >> 5;
    // this warp's LN / attention output rows [16, E]
    bf16* xw = reinterpret_cast<bf16*>(smem + SX_BYTES + warp * XW_BYTES);
    // LN1 of row T-1: the last row of the warp that owns the last row block
    const bf16* xn_last = reinterpret_cast<const bf16*>(
        smem + SX_BYTES + ((RB - 1) % WARPS) * XW_BYTES) + 15 * E;
    unsigned char* scratch = smem + SX_BYTES + WARPS * XW_BYTES;
    float* stage = reinterpret_cast<float*>(scratch + warp * WARP_SCRATCH);
    bf16* pbuf = reinterpret_cast<bf16*>(scratch + warp * WARP_SCRATCH + STAGE_BYTES);
    float* thin = reinterpret_cast<float*>(scratch);
    bf16* qkv = workspace + (size_t)blockIdx.x * T * E3;

    for (int c = blockIdx.x; c < n; c += gridDim.x) {
      // embedding; an id outside the vocabulary embeds as wpe alone, as the
      // TPU kernel's one-hot product gives
      for (int i = tid; i < T * E / 8; i += THREADS) {
        const int t = i / (E / 8), col = (i % (E / 8)) * 8;
        const int tok = tokens[(size_t)c * T + t];
        float a[8], b[8];
        load8(wpe + t * E + col, b);
        if (tok >= 0 && tok < vocab) {
          load8(wte + tok * E + col, a);
#pragma unroll
          for (int k = 0; k < 8; ++k) b[k] += a[k];
        }
        store8(sX + t * E + col, b);
      }
      __syncthreads();
      for (int l = 0; l < layers; ++l) {
        const bool last = l == layers - 1;
        const bf16* Wqkv = wqkv + (size_t)l * E * E3;
        const bf16* Wproj = wproj + (size_t)l * E * E;
        const bf16* Wfc = wfc + (size_t)l * E * F;
        const bf16* Wfc2 = wfc2 + (size_t)l * F * E;
        for (int rb = warp; rb < RB; rb += WARPS) {
          const int r0 = rb * 16;
          ln_rows(sX + r0 * E, xw, g1 + l * E);
          __syncwarp();
          FragA a[KT];
          load_rows(a, xw);
          // the last layer needs K/V only (Q of the last row comes below)
          qkv_rows(a, Wqkv, last ? E / 16 : 0, qkv + r0 * E3, stage);
        }
        __syncthreads();
        if (last) {
          last_position(qkv, sX, xn_last, Wqkv, Wproj, Wfc, Wfc2, g2 + l * E, gf, wht, vocab,
                        thin, out + (size_t)c * vocab);
          __syncthreads();
          break;
        }
        for (int rb = warp; rb < RB; rb += WARPS) {
          const int r0 = rb * 16;
          for (int h = 0; h < H; ++h)
            attention_item(qkv, r0, h, xw, stage, pbuf);
          __syncwarp();
          proj_mlp_rows(r0, sX, xw, Wproj, Wfc, Wfc2, g2 + l * E, stage, pbuf);
        }
        __syncthreads();
      }
    }
  }
};

#ifdef FUSED_GPT_E
using FwdA = Fwd<FUSED_GPT_E, FUSED_GPT_H, FUSED_GPT_CH>;   // the width asked for
#else
using FwdA = Fwd<160, 5, 128>;   // 2M
using FwdB = Fwd<256, 8, 64>;    // 6M
#endif

template <class S>
__global__ void __launch_bounds__(THREADS, 1)
fused_gpt_kernel(const int* __restrict__ tokens, const bf16* __restrict__ wte,
                 const bf16* __restrict__ wpe, const float* __restrict__ wht,
                 const bf16* __restrict__ wqkv, const bf16* __restrict__ wproj,
                 const bf16* __restrict__ wfc, const bf16* __restrict__ wfc2,
                 const float* __restrict__ g1, const float* __restrict__ g2,
                 const float* __restrict__ gf, float* __restrict__ out,
                 bf16* __restrict__ workspace, int n, int layers, int vocab) {
  S::forward(tokens, wte, wpe, wht, wqkv, wproj, wfc, wfc2, g1, g2, gf, out, workspace, n,
             layers, vocab);
}

template <class S>
int config_of(int* t, int* e, int* h, int* max_vocab, int* smem_bytes) {
  *t = T;
  *e = S::E;
  *h = S::H;
  *max_vocab = MAX_VOCAB;
  *smem_bytes = S::SMEM_BYTES;
  return 0;
}

template <class S>
int launch(const int* tokens, const bf16* wte, const bf16* wpe, const float* wht,
           const bf16* wqkv, const bf16* wproj, const bf16* wfc, const bf16* wfc2,
           const float* g1, const float* g2, const float* gf, float* out, bf16* workspace,
           int n, int layers, int vocab, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_gpt_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  fused_gpt_kernel<S><<<grid, THREADS, S::SMEM_BYTES, stream>>>(
      tokens, wte, wpe, wht, wqkv, wproj, wfc, wfc2, g1, g2, gf, out, workspace, n, layers,
      vocab);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape constants of the i-th width the library was built for, for the
// wrapper's checks; returns 1 when there is no i-th width.
int fused_gpt_config(int i, int* t, int* e, int* h, int* max_vocab, int* smem_bytes) {
  if (i == 0) return config_of<FwdA>(t, e, h, max_vocab, smem_bytes);
#ifndef FUSED_GPT_E
  if (i == 1) return config_of<FwdB>(t, e, h, max_vocab, smem_bytes);
#endif
  return 1;
}

// Launches the forward of width e with h heads on `stream`; returns the CUDA
// error code (0 = launched; cudaErrorInvalidValue for a width not built).
// workspace: bf16 [grid, T, 3e]; out: fp32 [n, vocab].
int fused_gpt_forward(int e, int h, const int* tokens, const bf16* wte, const bf16* wpe,
                      const float* wht, const bf16* wqkv, const bf16* wproj, const bf16* wfc,
                      const bf16* wfc2, const float* g1, const float* g2, const float* gf,
                      float* out, bf16* workspace, int n, int layers, int vocab, int grid,
                      cudaStream_t stream) {
  if (e == FwdA::E && h == FwdA::H)
    return launch<FwdA>(tokens, wte, wpe, wht, wqkv, wproj, wfc, wfc2, g1, g2, gf, out,
                        workspace, n, layers, vocab, grid, stream);
#ifndef FUSED_GPT_E
  if (e == FwdB::E && h == FwdB::H)
    return launch<FwdB>(tokens, wte, wpe, wht, wqkv, wproj, wfc, wfc2, g1, g2, gf, out,
                        workspace, n, layers, vocab, grid, stream);
#endif
  return (int)cudaErrorInvalidValue;
}

const char* fused_gpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
