// GPT layer stack for Hopper (sm_90a): bf16 x [N, 256, E] through a chunk of
// layers -> bf16 [N, 256, E], or [N, 1, E] (the last position) with the
// chunk's final layer thinned.  Built with no defines for the 85M's width
// (E=768, head dim 64, 12 heads); -DFUSED_BLOCKS_E=<E> -DFUSED_BLOCKS_DH=<dh>
// build another width (E a multiple of 32, head dim a multiple of 16 up to
// 128, the thin attention's scores within a block's shared memory; the
// static asserts below, which ops/fused_blocks.py checks before it starts
// nvcc).
//
// Replaces the TPU kernel mapf_gpt_tpu/ops/fused_gpt.py::_block_kernel and
// computes what it computes, per layer:
//   xn = bf16(LN(x) * g1)                     (fp32, two-pass, eps 1e-5)
//   q|k|v = bf16(xn @ Wqkv)                   (attention scale * log2(e) folded into W_q)
//   per head: e = bf16(exp2(min(q k^T, 100))) (no max subtraction)
//             att = bf16((e @ v) * (1 / sum e))   (normalised after P@V)
//   x = bf16(x + bf16(att @ Wproj))
//   x = bf16(x + bf16(gelu_tanh(bf16(bf16(LN(x) * g2) @ Wfc)) @ Wfc2))
// and, when last_only, the chunk's final layer thinned: K/V over all 256
// positions, but Q, attention, projection and MLP for position 255 only.
// bf16 between ops, fp32 accumulation; the plain PyTorch version of the same
// arithmetic is mapf_gpt_tpu_torch/ops/fused_blocks.py::blocks_reference.
//
// Bound on an H100 SXM for the 85M's whole stack (12 layers, the last
// thinned) at N = 2048 contexts (the JAX harness's 85M context cap):
// 87.4 TFLOP of bf16 products (11 full layers at 3.825 GFLOP a context, the
// thinned twelfth at 0.617 GFLOP) -> 88 ms at 989 TFLOP/s, against 0.97 GB
// (x in, the last positions out, 170 MB of weights) -> 0.29 ms at 3.35 TB/s.
// It is bound by operations.  The bound counts x once in and once out: this
// design sends x to device memory and back between layers, but the function
// does not need that, so those bytes are not in the bound.
//
// Why not the e2e kernel's plan: one context's residual stream is 384 KiB
// (over a block's 227 KB of shared memory) and one layer's weights are
// 14.2 MB (all 12 layers, 170 MB, are over the 50 MB L2; one layer fits).
// So the layer runs as a few wide kernels over a group of up to 256
// contexts (65,536 rows), one layer after another, the group's
// intermediates in a workspace in device memory:
//   * gemm_kernel: C = epilogue(A @ W) on the tensor cores, WMMA bf16
//     16x16x16 tiles (mma.sync), a 128 x 128 block tile of 8 warps (64 x 32
//     each), the K loop 32 deep with A and B double-buffered in shared
//     memory (B by cp.async), columns past N zero in the B tile and not
//     stored, so N needs only be a multiple of a warp's 32 columns (a warp
//     whose columns all lie past N skips its products).  Its prologue can
//     compute the rows' LayerNorm statistics and apply LN * g to the A
//     tiles as they are staged (LN1 -> QKV, LN2 -> fc); its epilogue rounds
//     to bf16 and applies tanh GELU (fc) or the residual add (projection,
//     fc2);
//   * attention_kernel: one (context, head, 128-row block) a CTA, 16 query
//     rows a warp, the scores of 128 keys at a time, so the 256x256 score
//     matrix is never stored;
//   * thin_attention_kernel: the last position's attention, one context a
//     CTA, in fp32 on the CUDA cores, its H x 256 scores in dynamic shared
//     memory.
// A full layer is 5 kernel launches per group (LN1+QKV, attention,
// projection, LN2+fc, fc2), the thinned layer 6 (LN1+K|V over all rows,
// LN1+Q of the last rows, attention, projection, LN2+fc, fc2).  One call of
// fused_blocks_forward runs a whole chunk of layers; the port's chunked
// route makes one such call per forward.  The group's q|k|v (302 MB) and
// MLP hidden (403 MB) make a round trip through device memory; this first
// version leaves wgmma, TMA and a fused MLP to later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_blocks.so fused_blocks.cu   (ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

#ifndef FUSED_BLOCKS_E
#define FUSED_BLOCKS_E 768       // n_embd of the 85M
#endif
#ifndef FUSED_BLOCKS_DH
#define FUSED_BLOCKS_DH 64       // its head dim
#endif

constexpr int T = 256;           // context length
constexpr int E = FUSED_BLOCKS_E;
constexpr int DH = FUSED_BLOCKS_DH;
constexpr int H = E / DH;        // heads (12 for the 85M)
constexpr int E3 = 3 * E;        // q|k|v width
constexpr int F = 4 * E;         // MLP hidden width
constexpr float EXP2_CLAMP = 100.f;
constexpr float LN_EPS = 1e-5f;

// gemm_kernel tiles
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WM = 64, WN = 32;           // warp tile; 2 x 4 warps
constexpr int GEMM_THREADS = 256;
constexpr int LDA_S = BK + 8;             // padded shared-memory rows
constexpr int LDB_S = BN + 8;
constexpr int SMEM_MAX = 232448;          // shared memory a block can have on sm_90
static_assert(E % 32 == 0, "N: whole warp column tiles (WN); K: whole BK tiles; LN: 8-value chunks");
static_assert(DH % 16 == 0 && DH <= 128, "head dim a multiple of 16 up to 128");
static_assert(E % DH == 0, "whole heads");
constexpr int LN_J = (E + 255) / 256;    // 8-value chunks a lane holds in the LN prologue
constexpr int THIN_SMEM = (E + H * T + H) * 4;
static_assert(THIN_SMEM <= SMEM_MAX, "thin attention: dynamic shared memory");

// attention tiles
constexpr int ATT_WARPS = 8;
constexpr int ATT_ROWS = ATT_WARPS * 16;  // query rows a CTA
constexpr int CH = 128;                   // keys per chunk

enum Epilogue { EPI_ROUND = 0, EPI_GELU = 1, EPI_RESID = 2 };

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

__device__ __forceinline__ void unpack8(uint4 u, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

// 8 consecutive bf16 <-> 8 floats (16-byte aligned addresses).
__device__ __forceinline__ void load8(const bf16* src, float v[8]) {
  unpack8(*reinterpret_cast<const uint4*>(src), v);
}

__device__ __forceinline__ void store8(bf16* dst, const float v[8]) {
  *reinterpret_cast<uint4*>(dst) = pack8(v);
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct GemmSmem {
  bf16 a[2][BM * LDA_S];
  bf16 b[2][BK * LDB_S];
  float stage[GEMM_THREADS / 32][16 * 16];
  float mu[BM];
  float rs[BM];
};

// C[M, N] = epilogue(A'[M, K] @ W[K, N]), rows of A, C and R lda, ldc, ldr
// elements apart, W's ldw.  A' = A, or bf16(LN(A) * g) when LN (then
// K == E).  Epilogues: EPI_ROUND  C = bf16(acc)
//                      EPI_GELU   C = bf16(gelu_tanh(bf16(acc)))
//                      EPI_RESID  C = bf16(R + bf16(acc))  (R may be C)
// N is a multiple of 32 and K of BK; rows past M and columns past N are
// skipped.
// Two blocks an SM: at most 128 registers a thread (the masking of N costs
// two more otherwise, and the third would halve the blocks an SM holds).
template <bool LN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_kernel(const bf16* __restrict__ A, int lda, const float* __restrict__ g,
            const bf16* __restrict__ W, int ldw, const bf16* R, int ldr, bf16* C, int ldc,
            int M, int N, int K) {
  __shared__ __align__(128) GemmSmem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp >> 2, wn = warp & 3;
  const bool live = n0 + wn * WN < N;   // the warp has columns to compute

  if (LN) {
    // the rows' mean and 1/std: two-pass, fp32, a warp per row
    for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
      float mu = 0.f, rs = 0.f;
      if (m0 + r < M) {
        const bf16* row = A + (size_t)(m0 + r) * lda;
        float v[LN_J][8];
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < LN_J; ++j) {
          const bool in = (lane + 32 * j) * 8 < E;
          if (in) load8(row + (lane + 32 * j) * 8, v[j]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (!in) v[j][i] = 0.f;
            s += v[j][i];
          }
        }
        mu = warp_sum(s) * (1.f / E);
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < LN_J; ++j) {
          if ((lane + 32 * j) * 8 >= E) continue;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float d = v[j][i] - mu;
            q += d * d;
          }
        }
        rs = rsqrtf(warp_sum(q) * (1.f / E) + LN_EPS);
      }
      if (lane == 0) {
        sm.mu[r] = mu;
        sm.rs[r] = rs;
      }
    }
    __syncthreads();
  }

  // A tile [BM, BK]: 512 chunks of 8 bf16, two a thread, through registers
  // (where LN is applied); B tile [BK, BN]: 512 chunks, two a thread, by cp.async
  uint4 ra[2];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS, r = c >> 2, col = (c & 3) * 8;
      ra[i] = m0 + r < M ? *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * lda + k0 + col)
                         : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_a = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS, r = c >> 2, col = (c & 3) * 8;
      uint4 u = ra[i];
      if (LN) {
        float v[8];
        unpack8(u, v);
        const float mu = sm.mu[r], rs = sm.rs[r];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = (v[e] - mu) * rs * g[k0 + col + e];
        u = pack8(v);
      }
      *reinterpret_cast<uint4*>(&sm.a[s][r * LDA_S + col]) = u;
    }
  };
  auto load_b = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS, kr = c >> 4, col = (c & 15) * 8;
      bf16* dst = &sm.b[s][kr * LDB_S + col];
      if (n0 + col < N)
        cp_async16(dst, W + (size_t)(k0 + kr) * ldw + n0 + col);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  };

  FragC acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int ktiles = K / BK;
  load_b(0, 0);
  load_a(0);
  store_a(0, 0);
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1, nxt = cur ^ 1;
    const bool more = kt + 1 < ktiles;
    if (more) {
      load_b(nxt, (kt + 1) * BK);
      load_a((kt + 1) * BK);
    }
    if (live) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        FragA fa[WM / 16];
        FragB fb[WN / 16];
#pragma unroll
        for (int i = 0; i < WM / 16; ++i)
          wmma::load_matrix_sync(fa[i], &sm.a[cur][(wm * WM + i * 16) * LDA_S + kk * 16], LDA_S);
#pragma unroll
        for (int j = 0; j < WN / 16; ++j)
          wmma::load_matrix_sync(fb[j], &sm.b[cur][kk * 16 * LDB_S + wn * WN + j * 16], LDB_S);
#pragma unroll
        for (int i = 0; i < WM / 16; ++i)
#pragma unroll
          for (int j = 0; j < WN / 16; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    if (more) {
      store_a(nxt, (kt + 1) * BK);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  if (!live) return;
  float* stage = sm.stage[warp];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) {
      float v[8];
      frag_to_lane8(acc[i][j], stage, v);
      const int row = m0 + wm * WM + i * 16 + lane_row();
      const int col = n0 + wn * WN + j * 16 + lane_col();
      if (row < M && col < N) {
        if (EPI == EPI_GELU) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = gelu_tanh(rbf(v[e]));
        } else if (EPI == EPI_RESID) {
          float r[8];
          load8(R + (size_t)row * ldr + col, r);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = r[e] + rbf(v[e]);
        }
        store8(C + (size_t)row * ldc + col, v);
      }
      __syncwarp();  // reconverge before the next tile's warp-wide store
    }
}

// Attention of one (context, head, 128-row block) a CTA, 16 query rows a
// warp: att[c, rows, h*DH ..] from qkv [n, T, 3E].
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ att) {
  __shared__ __align__(128) float stage_s[ATT_WARPS][16 * 16];
  __shared__ __align__(128) bf16 pbuf_s[ATT_WARPS][16 * CH];
  const int warp = threadIdx.x >> 5;
  constexpr int BLOCKS = T / ATT_ROWS;
  const int c = blockIdx.x / (H * BLOCKS), h = (blockIdx.x / BLOCKS) % H;
  const int r0 = (blockIdx.x % BLOCKS) * ATT_ROWS + warp * 16;
  const bf16* q = qkv + (size_t)c * T * E3;
  float* stage = stage_s[warp];
  bf16* pbuf = pbuf_s[warp];

  FragA qa[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], q + r0 * E3 + h * DH + kk * 16, E3);
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
        wmma::load_matrix_sync(kb, q + key0 * E3 + E + h * DH + kk * 16, E3);
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
        wmma::load_matrix_sync(vb, q + (c0 + kk * 16) * E3 + 2 * E + h * DH + n * 16, E3);
        wmma::mma_sync(o[n], pa, vb, o[n]);
      }
    }
    __syncwarp();
  }
  const float inv = 1.f / rs;
  bf16* out = att + ((size_t)c * T + r0 + lane_row()) * E + h * DH + lane_col();
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) {
    float v[8];
    frag_to_lane8(o[n], stage, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] *= inv;
    store8(out + n * 16, v);
  }
}

// Attention of the last position, one context a CTA: att_last[c] from
// q_last [n, E] and the K/V of qkv [n, T, 3E]; THIN_SMEM bytes of dynamic
// shared memory.
__global__ void __launch_bounds__(256)
thin_attention_kernel(const bf16* __restrict__ q_last, const bf16* __restrict__ qkv,
                      bf16* __restrict__ att_last) {
  extern __shared__ __align__(16) float thin_s[];
  float* q_s = thin_s;        // [E]
  float* p_s = q_s + E;       // [H * T]
  float* den_s = p_s + H * T; // [H]
  const int c = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* kv = qkv + (size_t)c * T * E3;
  for (int j = tid; j < E; j += blockDim.x) q_s[j] = __bfloat162float(q_last[(size_t)c * E + j]);
  __syncthreads();
  for (int i = tid; i < H * T; i += blockDim.x) {
    const int h = i / T, t = i % T;
    const bf16* kr = kv + t * E3 + E + h * DH;
    float s = 0.f;
    for (int d = 0; d < DH; ++d) s += q_s[h * DH + d] * __bfloat162float(kr[d]);
    p_s[i] = rbf(exp2f(fminf(s, EXP2_CLAMP)));
  }
  __syncthreads();
  for (int h = warp; h < H; h += blockDim.x / 32) {
    float s = 0.f;
    for (int t = lane; t < T; t += 32) s += p_s[h * T + t];
    s = warp_sum(s);
    if (lane == 0) den_s[h] = s;
  }
  __syncthreads();
  for (int j = tid; j < E; j += blockDim.x) {
    const int h = j / DH;
    float a = 0.f;
    for (int t = 0; t < T; ++t) a += p_s[h * T + t] * __bfloat162float(kv[t * E3 + 2 * E + j]);
    att_last[(size_t)c * E + j] = __float2bfloat16(a * (1.f / den_s[h]));
  }
}

template <bool LN, int EPI>
cudaError_t gemm(const bf16* A, int lda, const float* g, const bf16* W, int ldw, const bf16* R,
                 int ldr, bf16* C, int ldc, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<LN, EPI><<<grid, GEMM_THREADS, 0, stream>>>(A, lda, g, W, ldw, R, ldr, C, ldc,
                                                          M, N, K);
  return cudaGetLastError();
}

#define RETURN_IF_ERROR(call)                  \
  do {                                         \
    const cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

}  // namespace

extern "C" {

// Shape constants the kernels were built for, for the wrapper's checks.
int fused_blocks_config(int* t, int* e, int* h) {
  *t = T;
  *e = E;
  *h = H;
  return 0;
}

// bf16 elements of the workspace for groups of `group` contexts:
// q|k|v [group, T, 3E], attention [group, T, E], MLP hidden [group, T, 4E],
// the last positions' q and attention [group, E] each.
long long fused_blocks_workspace(int group) {
  return (long long)group * (T * (E3 + E + F) + 2 * E);
}

// Runs `layers` layers on the stream x [n, T, E] in place, on `stream`, in
// groups of `group` contexts; when last_only, the final layer is thinned
// and its last-position output goes to out_last [n, E] (x then holds the
// input of that layer).  Weights: wqkv [layers, E, 3E], wproj [layers, E, E],
// wfc [layers, E, 4E], wfc2 [layers, 4E, E] bf16; gains g1, g2 [layers, E]
// fp32.  Returns the first CUDA error of a launch (0 = all launched).
int fused_blocks_forward(bf16* x, bf16* out_last, const bf16* wqkv, const bf16* wproj,
                         const bf16* wfc, const bf16* wfc2, const float* g1, const float* g2,
                         bf16* workspace, int n, int layers, int last_only, int group,
                         cudaStream_t stream) {
  if (group <= 0 || layers <= 0) return (int)cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaFuncSetAttribute(thin_attention_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, THIN_SMEM));
  bf16* qkv = workspace;
  bf16* att = qkv + (size_t)group * T * E3;
  bf16* hid = att + (size_t)group * T * E;
  bf16* q_last = hid + (size_t)group * T * F;
  bf16* att_last = q_last + (size_t)group * E;
  for (int c0 = 0; c0 < n; c0 += group) {
    const int nc = n - c0 < group ? n - c0 : group;
    const int M = nc * T;
    bf16* xg = x + (size_t)c0 * T * E;
    for (int l = 0; l < layers; ++l) {
      const bf16* Wqkv = wqkv + (size_t)l * E * E3;
      const bf16* Wproj = wproj + (size_t)l * E * E;
      const bf16* Wfc = wfc + (size_t)l * E * F;
      const bf16* Wfc2 = wfc2 + (size_t)l * F * E;
      const float* G1 = g1 + (size_t)l * E;
      const float* G2 = g2 + (size_t)l * E;
      if (!(last_only && l == layers - 1)) {
        RETURN_IF_ERROR((gemm<true, EPI_ROUND>(xg, E, G1, Wqkv, E3, nullptr, 0, qkv, E3, M, E3,
                                               E, stream)));
        attention_kernel<<<nc * H * (T / ATT_ROWS), ATT_WARPS * 32, 0, stream>>>(qkv, att);
        RETURN_IF_ERROR(cudaGetLastError());
        RETURN_IF_ERROR((gemm<false, EPI_RESID>(att, E, nullptr, Wproj, E, xg, E, xg, E, M, E, E,
                                                stream)));
        RETURN_IF_ERROR((gemm<true, EPI_GELU>(xg, E, G2, Wfc, F, nullptr, 0, hid, F, M, F, E,
                                              stream)));
        RETURN_IF_ERROR((gemm<false, EPI_RESID>(hid, F, nullptr, Wfc2, E, xg, E, xg, E, M, E, F,
                                                stream)));
        continue;
      }
      // thinned final layer: K|V of every row, the rest for row T-1 only
      bf16* xl = out_last + (size_t)c0 * E;
      const bf16* xlast = xg + (size_t)(T - 1) * E;
      RETURN_IF_ERROR((gemm<true, EPI_ROUND>(xg, E, G1, Wqkv + E, E3, nullptr, 0, qkv + E, E3, M,
                                             2 * E, E, stream)));
      RETURN_IF_ERROR((gemm<true, EPI_ROUND>(xlast, T * E, G1, Wqkv, E3, nullptr, 0, q_last, E,
                                             nc, E, E, stream)));
      thin_attention_kernel<<<nc, 256, THIN_SMEM, stream>>>(q_last, qkv, att_last);
      RETURN_IF_ERROR(cudaGetLastError());
      RETURN_IF_ERROR((gemm<false, EPI_RESID>(att_last, E, nullptr, Wproj, E, xlast, T * E, xl,
                                              E, nc, E, E, stream)));
      RETURN_IF_ERROR((gemm<true, EPI_GELU>(xl, E, G2, Wfc, F, nullptr, 0, hid, F, nc, F, E,
                                            stream)));
      RETURN_IF_ERROR((gemm<false, EPI_RESID>(hid, F, nullptr, Wfc2, E, xl, E, xl, E, nc, E, F,
                                              stream)));
    }
  }
  return 0;
}

const char* fused_blocks_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
