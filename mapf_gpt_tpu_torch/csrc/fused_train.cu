// GPT layer stack for training on Hopper (sm_90a): the forward of a chunk of
// layers that saves the residual stream, and the backward of a chunk that
// recomputes everything else from those saves.
//
// Replaces the TPU kernels mapf_gpt_tpu/ops/fused_gpt_train.py::_fwd_kernel
// and ::_bwd_kernel and computes what they compute (bf16 between ops, fp32
// accumulation), per layer l:
//   forward   xsave[2l] = x
//             xn = bf16(LN(x) * g1)                 (fp32, two-pass, eps 1e-5)
//             q|k|v = bf16(xn @ Wqkv)               (no scale folded into W_q)
//             per head: s = (q k^T) * 1/sqrt(dh)     (fp32)
//                       p = bf16(exp(s - max s) / sum)   (normalised before P@V)
//                       att = bf16(p @ v)
//             x = bf16(x + bf16(att @ Wproj));  xsave[2l+1] = x
//             x = bf16(x + bf16(bf16(gelu_tanh(bf16(LN(x) * g2) @ Wfc)) @ Wfc2))
//   every position runs in every layer; with last_only the chunk's output is
//   the last position, so the last layer's MLP runs for that row alone.
//   backward  (layers in reverse; dx fp32 inside the chunk, bf16 at its ends)
//             MLP: recompute xn2, hmid = xn2 @ Wfc (fp32), hact = bf16(gelu(hmid));
//                  dxb = bf16(dx);  dWfc2 += hact^T dxb;
//                  dh = bf16((dxb Wfc2^T) * gelu_tanh'(hmid));  dWfc += xn2^T dh;
//                  dx += LN_bwd(dh Wfc^T);  dg2 += sum_rows(dy * xhat)
//             attention: recompute xn1, q|k|v, att;  dxb = bf16(dx);
//                  dWproj += att^T dxb;  datt = bf16(dxb Wproj^T);
//                  per head (p fp32 recomputed): dv = bf16(bf16(p)^T datt),
//                  dp = datt v^T, ds = bf16(((dp - sum(dp * p)) * p) / sqrt(dh)),
//                  dq = bf16(ds k), dk = bf16(ds^T q);
//                  dWqkv += xn1^T dqkv;  dx += LN_bwd(dqkv Wqkv^T);  dg1 += ...
//             dx0 = bf16(dx)
// The plain PyTorch versions of the same arithmetic are
// mapf_gpt_tpu_torch/ops/fused_gpt_train.py::train_fwd_reference and
// ::train_bwd_reference.
//
// Bound on an H100 SXM: the 6M (E=256, 8 layers) at 2048 contexts does
// 24 T E^2 + 4 T^2 E FLOP a context and layer forward and about 2.6 times
// that backward (recompute included), 28 TFLOP in all -> ~28 ms at 989
// TFLOP/s, against ~4.3 GB of saves written and read -> ~1.3 ms at 3.35 TB/s:
// it is bound by operations (chip_smoke.py computes the bound from each
// run's shapes).  So every product runs on the tensor cores.
//
// Design.  The TPU walks a tile of contexts through all of a chunk's layers
// in VMEM and sums the weight gradients in output blocks that stay resident
// over its sequential grid.  On the GPU a context's stream does not fit a
// block at the 85M's width and blocks run in no order, so a chunk runs as
// wide kernels over a group of up to 256 contexts at a time, one layer after
// another, with the group's intermediates in a workspace in device memory:
//   * gemm_kernel: C = epilogue(op(A) @ op(B)), WMMA bf16 16x16x16 tiles
//     (mma.sync), a 128 x 64 block tile of 8 warps (32 x 32 each), the K
//     loop 32 deep, both operands double-buffered in shared memory by
//     cp.async.  A and B can each be read transposed (dX = dY W^T needs W^T,
//     dW = A^T dY needs A^T), rows and columns past M and N are masked, so
//     any width that is a multiple of 32 runs (the 2M's 160 included).
//     Epilogues: bf16 round, tanh GELU, residual add, fp32 store, fp32 +
//     GELU (the backward's hmid and hact), and the GELU gradient;
//   * the weight gradients: dW = A^T dY over the group's rows, split along
//     the rows into per-CTA partial sums in the workspace, then
//     reduce_add_kernel adds the partials to the fp32 gradient in a fixed
//     order.  No atomics, so two runs give the same gradients bit for bit;
//   * ln_kernel (LN forward), ln_bwd_kernel (a warp per row: dx += LN
//     backward, dxb = bf16(dx)) and dg_partial_kernel (the gain gradient,
//     column sums over fixed row blocks, reduced like the weights');
//   * the attention (redesigned for Hopper): the forward and the backward's
//     recompute run attn::launch_fwd (csrc/attn_tile.cuh, shared with
//     csrc/attention.cu), one CTA a (context, head) at a time, K and V
//     staged once by cp.async, a row's scores in mma.sync accumulators;
//     the recompute also writes each row's max and sum.  The backward's
//     attn_bwd_q_kernel (delta and dq) and attn_bwd_kv_kernel (dk and dv)
//     recompute p from those, so no T x T buffer exists and nothing is
//     summed by atomics.
// Head dim a multiple of 16 up to 128 (a template), any T from 1 to 256 (the
// weight gradients' depth padded to whole BK tiles with zero rows), E a
// multiple of 32.  The GEMMs and LayerNorm kernels leave wgmma, TMA and
// fusing the group's intermediates to later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_train.so fused_train.cu   (ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "attn_tile.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;
using attn::cp_async16;
using attn::cp_async_commit;

namespace {

constexpr int T_MAX = 256;
constexpr float LN_EPS = 1e-5f;
constexpr int SMS = 132;                 // SMs of an H100 SXM (sizes the split of dW)

// gemm_kernel tiles
constexpr int BM = 128, BN = 64, BK = 32;
constexpr int WM = 32, WN = 32;          // warp tile: 4 (M) x 2 (N) warps
constexpr int GEMM_THREADS = 256;
constexpr int LDA_N = BK + 8;            // A [BM][BK] row-major tile, padded
constexpr int LDA_T = BM + 8;            // A^T stored [BK][BM]
constexpr int LDB_N = BN + 8;            // B [BK][BN]
constexpr int LDB_T = BK + 8;            // B^T stored [BN][BK]
constexpr int A_TILE = BM * LDA_N > BK * LDA_T ? BM * LDA_N : BK * LDA_T;
constexpr int B_TILE = BK * LDB_N > BN * LDB_T ? BK * LDB_N : BN * LDB_T;
constexpr int MAX_SPLITS = 32;

constexpr int ROWS_PER_PART = 256;         // rows of one gain-gradient partial

enum Epilogue { EPI_BF16 = 0, EPI_GELU, EPI_RESID, EPI_F32, EPI_F32_GELU, EPI_GELU_GRAD };

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;
constexpr float GELU_C = 0.044715f;

__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ float gelu_tanh(float h) {
  const float u = SQRT_2_OVER_PI * (h + GELU_C * h * h * h);
  return 0.5f * h * (1.f + tanhf(u));
}

__device__ __forceinline__ float gelu_tanh_grad(float h) {
  const float u = SQRT_2_OVER_PI * (h + GELU_C * h * h * h);
  const float t = tanhf(u);
  const float du = SQRT_2_OVER_PI * (1.f + 3.f * GELU_C * h * h);
  return 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * du;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// C[M, N] = epilogue(op(A) @ op(B)) over the K range of split blockIdx.z.
//   op(A) [M, K]: A row-major with rows lda apart, or (AT) A stored [K, M].
//   op(B) [K, N]: B row-major with rows ldb apart, or (BT) B stored [N, K].
// Epilogues, C's rows ldc apart:
//   EPI_BF16      C16 = bf16(acc)
//   EPI_GELU      C16 = bf16(gelu_tanh(acc))
//   EPI_RESID     C16 = bf16(R + bf16(acc))        (R's rows ldr apart)
//   EPI_F32       C32 = acc, split z at C32 + z * split_stride
//   EPI_F32_GELU  C32 = acc, C16 = bf16(gelu_tanh(acc))
//   EPI_GELU_GRAD C16 = bf16(acc * gelu_tanh'(X32))  (X32's rows ldc apart)
// K is a multiple of BK, N of 16 and, with AT, M of 8; rows and columns
// past M and N are masked.
template <bool AT, bool BT, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb, int M,
            int N, int K, bf16* C16, float* C32, int ldc, const bf16* R, int ldr,
            const float* __restrict__ X32, long long split_stride) {
  __shared__ __align__(128) bf16 sa[2][A_TILE];
  __shared__ __align__(128) bf16 sb[2][B_TILE];
  __shared__ __align__(128) float stage_s[GEMM_THREADS / 32][16 * 16];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp >> 1, wn = warp & 1;

  const int ktiles = K / BK;
  const int per = (ktiles + gridDim.z - 1) / gridDim.z;
  const int kt0 = blockIdx.z * per;
  const int kt1 = min(ktiles, kt0 + per);

  auto load_tiles = [&](int s, int k0) {
    // A: 512 chunks of 8 bf16, two a thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;
      if (!AT) {
        const int r = c >> 2, col = (c & 3) * 8;
        bf16* dst = &sa[s][r * LDA_N + col];
        if (m0 + r < M)
          cp_async16(dst, A + (size_t)(m0 + r) * lda + k0 + col);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else {
        const int kr = c >> 4, col = (c & 15) * 8;
        bf16* dst = &sa[s][kr * LDA_T + col];
        if (m0 + col < M)
          cp_async16(dst, A + (size_t)(k0 + kr) * lda + m0 + col);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
    // B: 256 chunks, one a thread
    {
      const int c = tid;
      if (!BT) {
        const int kr = c >> 3, col = (c & 7) * 8;
        bf16* dst = &sb[s][kr * LDB_N + col];
        if (n0 + col < N)
          cp_async16(dst, B + (size_t)(k0 + kr) * ldb + n0 + col);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else {
        const int nr = c >> 2, col = (c & 3) * 8;
        bf16* dst = &sb[s][nr * LDB_T + col];
        if (n0 + nr < N)
          cp_async16(dst, B + (size_t)(n0 + nr) * ldb + k0 + col);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  };

  FragC acc[WM / 16][WN / 16];
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (kt0 < kt1) load_tiles(0, kt0 * BK);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int cur = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load_tiles(cur ^ 1, (kt + 1) * BK);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragB fb[WN / 16];
      FragBT fbt[WN / 16];
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) {
        const int nn = wn * WN + j * 16;
        if (!BT)
          wmma::load_matrix_sync(fb[j], &sb[cur][kk * 16 * LDB_N + nn], LDB_N);
        else
          wmma::load_matrix_sync(fbt[j], &sb[cur][nn * LDB_T + kk * 16], LDB_T);
      }
#pragma unroll
      for (int i = 0; i < WM / 16; ++i) {
        const int mm = wm * WM + i * 16;
        FragA fa;
        FragAT fat;
        if (!AT)
          wmma::load_matrix_sync(fa, &sa[cur][mm * LDA_N + kk * 16], LDA_N);
        else
          wmma::load_matrix_sync(fat, &sa[cur][kk * 16 * LDA_T + mm], LDA_T);
#pragma unroll
        for (int j = 0; j < WN / 16; ++j) {
          if (!AT && !BT) wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
          if (!AT && BT) wmma::mma_sync(acc[i][j], fa, fbt[j], acc[i][j]);
          if (AT && !BT) wmma::mma_sync(acc[i][j], fat, fb[j], acc[i][j]);
          if (AT && BT) wmma::mma_sync(acc[i][j], fat, fbt[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  float* stage = stage_s[warp];
  if (EPI == EPI_F32) C32 += blockIdx.z * split_stride;
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 16; ++j) {
      float v[8];
      frag_to_lane8(acc[i][j], stage, v);
      const int row = m0 + wm * WM + i * 16 + lane_row();
      const int col = n0 + wn * WN + j * 16 + lane_col();
      if (row < M && col < N) {
        const size_t at = (size_t)row * ldc + col;
        if (EPI == EPI_F32 || EPI == EPI_F32_GELU) {
          float4* d = reinterpret_cast<float4*>(C32 + at);
          d[0] = make_float4(v[0], v[1], v[2], v[3]);
          d[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
        if (EPI == EPI_GELU || EPI == EPI_F32_GELU) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = gelu_tanh(v[e]);
        } else if (EPI == EPI_RESID) {
          float r[8];
          load8(R + (size_t)row * ldr + col, r);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = r[e] + rbf(v[e]);
        } else if (EPI == EPI_GELU_GRAD) {
          const float4* x = reinterpret_cast<const float4*>(X32 + at);
          const float4 a = x[0], b = x[1];
          const float h[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] *= gelu_tanh_grad(h[e]);
        }
        if (EPI != EPI_F32) store8(C16 + at, v);
      }
      __syncwarp();  // reconverge before the next tile's warp-wide store
    }
}

// y[r] = bf16(LN(x[r]) * g) for M rows, a warp per row (rows ldx and ldy apart).
__global__ void __launch_bounds__(256)
ln_kernel(const bf16* __restrict__ x, int ldx, const float* __restrict__ g,
          bf16* __restrict__ y, int ldy, int M, int E) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * ldx;
  float s = 0.f;
  for (int c = lane; c < E; c += 32) s += __bfloat162float(xr[c]);
  const float mu = warp_sum(s) / E;
  float q = 0.f;
  for (int c = lane; c < E; c += 32) {
    const float d = __bfloat162float(xr[c]) - mu;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / E + LN_EPS);
  bf16* yr = y + (size_t)row * ldy;
  for (int c = lane; c < E; c += 32)
    yr[c] = __float2bfloat16((__bfloat162float(xr[c]) - mu) * rstd * g[c]);
}

// LayerNorm backward of y = LN(x) * g for M rows [E], a warp per row:
// dx += (dy*g - mean(dy*g) - xhat * mean(dy*g*xhat)) * rstd, then dxb =
// bf16(dx); the rows' mean and 1/std go to mu, rs for dg_partial_kernel.
__global__ void __launch_bounds__(256)
ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ dy, float* __restrict__ dx, bf16* __restrict__ dxb,
              float* __restrict__ mu_out, float* __restrict__ rs_out, int M, int E) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * E;
  const float* dyr = dy + (size_t)row * E;
  float s = 0.f;
  for (int c = lane; c < E; c += 32) s += __bfloat162float(xr[c]);
  const float mu = warp_sum(s) / E;
  float q = 0.f;
  for (int c = lane; c < E; c += 32) {
    const float d = __bfloat162float(xr[c]) - mu;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / E + LN_EPS);
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < E; c += 32) {
    const float xhat = (__bfloat162float(xr[c]) - mu) * rstd;
    const float d = dyr[c] * g[c];
    s1 += d;
    s2 += d * xhat;
  }
  const float m1 = warp_sum(s1) / E, m2 = warp_sum(s2) / E;
  float* dxr = dx + (size_t)row * E;
  bf16* dxbr = dxb + (size_t)row * E;
  for (int c = lane; c < E; c += 32) {
    const float xhat = (__bfloat162float(xr[c]) - mu) * rstd;
    const float d = dyr[c] * g[c];
    const float v = dxr[c] + (d - m1 - xhat * m2) * rstd;
    dxr[c] = v;
    dxbr[c] = __float2bfloat16(v);
  }
  if (lane == 0) {
    mu_out[row] = mu;
    rs_out[row] = rstd;
  }
}

// partial[b][c] = sum over rows r of block b (ROWS_PER_PART rows) of
// dy[r, c] * xhat[r, c]: the gain gradient's rows, summed in a fixed order.
__global__ void __launch_bounds__(256)
dg_partial_kernel(const bf16* __restrict__ x, const float* __restrict__ dy,
                  const float* __restrict__ mu, const float* __restrict__ rs,
                  float* __restrict__ partial, int M, int E) {
  const int r0 = blockIdx.x * ROWS_PER_PART;
  const int r1 = min(M, r0 + ROWS_PER_PART);
  for (int c = threadIdx.x; c < E; c += blockDim.x) {
    float s = 0.f;
    for (int r = r0; r < r1; ++r)
      s += dy[(size_t)r * E + c] * ((__bfloat162float(x[(size_t)r * E + c]) - mu[r]) * rs[r]);
    partial[(size_t)blockIdx.x * E + c] = s;
  }
}

// out[i] += sum_{p < parts} partial[p * count + i], p in order.
__global__ void __launch_bounds__(256)
reduce_add_kernel(const float* __restrict__ partial, int parts, long long count,
                  float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += partial[(size_t)p * count + i];
  out[i] += s;
}

__global__ void __launch_bounds__(256)
to_f32_kernel(const bf16* __restrict__ src, float* __restrict__ dst, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) dst[i] = __bfloat162float(src[i]);
}

// The attention backward, in two deterministic kernels that keep every
// score in registers: the forward's recompute (attn::launch_fwd) leaves
// each row's statistics m, l [ctx][H][T] (p_ij = 2^(s_ij scale' - m_i) /
// l_i, scale' = scale * log2 e); then
//   attn_bwd_q_kernel, one CTA a (64 query rows, head, context), K and V of
//     the head staged whole by cp.async: pass A sums delta_i = sum_j dp_ij
//     p_ij (fp32, dp = dA V^T), the sum the JAX kernel takes; pass B forms
//     ds = bf16(((dp - delta) p) scale) and adds dq += ds K;
//   attn_bwd_kv_kernel, one CTA a (64 keys, head, context), Q and dA of the
//     head staged whole: S^T = K Q^T and dP^T = V dA^T again, p and ds from
//     m, l and delta, then dv += bf16(p)^T dA and dk += ds^T Q.
// Every product runs on mma.sync from ldmatrix'ed shared-memory tiles; the
// outputs leave 16 bytes a lane; no atomics, no T x T buffer.
constexpr int BC = 32;   // keys (query side) or queries (key side) a chunk

template <int DH>
size_t bwd_q_smem(int T) {
  return ((size_t)2 * attn::round_up(T, BC) + attn::TILE) * (DH + 8) * sizeof(bf16);
}

template <int DH>
size_t bwd_kv_smem(int T) {
  const size_t tp = attn::round_up(T, BC);
  return (2 * tp + 2 * attn::TILE) * (DH + 8) * sizeof(bf16) + 3 * tp * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(attn::WARPS * 32)
attn_bwd_q_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ datt,
                  const float* __restrict__ m_in, const float* __restrict__ l_in,
                  float* __restrict__ delta_out, bf16* __restrict__ dqkv, int T, int E,
                  float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = DH + 8, NB = BC / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  const int h = blockIdx.y, ctx = blockIdx.z, H = gridDim.y, E3 = 3 * E;
  const int r0 = blockIdx.x * attn::TILE + warp * 16;
  const int tp = attn::round_up(T, BC);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)tp * LD;
  bf16* stage = vs + (size_t)tp * LD + warp * 16 * LD;
  const bf16* qp = qkv + (size_t)ctx * T * E3 + h * DH;
  const bf16* dap = datt + (size_t)ctx * T * E + h * DH;
  const size_t srow = ((size_t)ctx * H + h) * T;
  attn::stage_rows_async<DH>(ks, qp + E, E3, 0, tp, T, threadIdx.x, blockDim.x);
  attn::stage_rows_async<DH>(vs, qp + 2 * E, E3, 0, tp, T, threadIdx.x, blockDim.x);
  attn::cp_async_commit();
  const bool active = r0 < T;
  unsigned qa[DH / 16][4], daa[DH / 16][4];
  float mr[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  if (active) {
    attn::stage_rows_warp<DH>(stage, qp, E3, r0, 16, T);
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) attn::frag_a(qa[kk], stage + kk * 16, LD);
    __syncwarp();
    attn::stage_rows_warp<DH>(stage, dap, E, r0, 16, T);
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) attn::frag_a(daa[kk], stage + kk * 16, LD);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r0 + g + 8 * r < T) {
        mr[r] = m_in[srow + r0 + g + 8 * r];
        inv[r] = 1.f / l_in[srow + r0 + g + 8 * r];
      }
  }
  attn::cp_async_wait<0>();
  __syncthreads();
  if (!active) return;
  const float c2 = scale * attn::LOG2E;

  // pass A: delta_i = sum_j dp_ij p_ij
  float dl[2] = {0.f, 0.f};
  for (int c0 = 0; c0 < tp; c0 += BC) {
    float s[NB][4], dp[NB][4];
    attn::scores<DH, BC / 16>(s, qa, ks + c0 * LD, LD);
    attn::scores<DH, BC / 16>(dp, daa, vs + c0 * LD, LD);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool key_ok = c0 + j * 8 + 2 * c4 + (e & 1) < T;
        const float p = key_ok ? attn::ex2(s[j][e] * c2 - mr[e >> 1]) * inv[e >> 1] : 0.f;
        dl[e >> 1] += dp[j][e] * p;
      }
  }
  dl[0] = attn::quad_sum(dl[0]);
  dl[1] = attn::quad_sum(dl[1]);

  // pass B: ds = bf16(((dp - delta) p) scale); dq += ds K
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int c0 = 0; c0 < tp; c0 += BC) {
    float s[NB][4], dp[NB][4];
    attn::scores<DH, BC / 16>(s, qa, ks + c0 * LD, LD);
    attn::scores<DH, BC / 16>(dp, daa, vs + c0 * LD, LD);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool key_ok = c0 + j * 8 + 2 * c4 + (e & 1) < T;
        const float p = key_ok ? attn::ex2(s[j][e] * c2 - mr[e >> 1]) * inv[e >> 1] : 0.f;
        s[j][e] = ((dp[j][e] - dl[e >> 1]) * p) * scale;
      }
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      unsigned a[4];
      attn::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
      attn::accumulate<DH>(acc, a, ks + (c0 + kk * 16) * LD, LD);
    }
  }
  attn::store_rows<DH>(acc, stage, dqkv + (size_t)ctx * T * E3 + h * DH, E3, r0, T);
  if (c4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r0 + g + 8 * r < T) delta_out[srow + r0 + g + 8 * r] = dl[r];
  }
}

template <int DH>
__global__ void __launch_bounds__(attn::WARPS * 32)
attn_bwd_kv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ datt,
                   const float* __restrict__ m_in, const float* __restrict__ l_in,
                   const float* __restrict__ delta_in, bf16* __restrict__ dqkv, int T, int E,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = DH + 8, NB = BC / 8;
  constexpr bool REG = DH <= 64;   // K and V fragments in registers (else read as needed)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c4 = lane & 3;
  const int h = blockIdx.y, ctx = blockIdx.z, H = gridDim.y, E3 = 3 * E;
  const int k0 = blockIdx.x * attn::TILE + warp * 16;
  const int tp = attn::round_up(T, BC);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* das = qs + (size_t)tp * LD;
  bf16* kst = das + (size_t)tp * LD + warp * 32 * LD;
  bf16* vst = kst + 16 * LD;
  float* ms = reinterpret_cast<float*>(das + (size_t)tp * LD + attn::WARPS * 32 * LD);
  float* li = ms + tp;
  float* dls = li + tp;
  const bf16* qp = qkv + (size_t)ctx * T * E3 + h * DH;
  const bf16* dap = datt + (size_t)ctx * T * E + h * DH;
  const size_t srow = ((size_t)ctx * H + h) * T;
  attn::stage_rows_async<DH>(qs, qp, E3, 0, tp, T, threadIdx.x, blockDim.x);
  attn::stage_rows_async<DH>(das, dap, E, 0, tp, T, threadIdx.x, blockDim.x);
  attn::cp_async_commit();
  // queries past T: m = +inf, so that p = 2^(-inf) = 0
  for (int i = threadIdx.x; i < tp; i += blockDim.x) {
    const bool ok = i < T;
    ms[i] = ok ? m_in[srow + i] : __int_as_float(0x7f800000);
    li[i] = ok ? 1.f / l_in[srow + i] : 0.f;
    dls[i] = ok ? delta_in[srow + i] : 0.f;
  }
  const bool active = k0 < T;
  unsigned ka[REG ? DH / 16 : 1][4], va[REG ? DH / 16 : 1][4];
  if (active) {
    attn::stage_rows_warp<DH>(kst, qp + E, E3, k0, 16, T);
    attn::stage_rows_warp<DH>(vst, qp + 2 * E, E3, k0, 16, T);
    __syncwarp();
    if constexpr (REG) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        attn::frag_a(ka[kk], kst + kk * 16, LD);
        attn::frag_a(va[kk], vst + kk * 16, LD);
      }
    }
  }
  attn::cp_async_wait<0>();
  __syncthreads();
  if (!active) return;
  const float c2 = scale * attn::LOG2E;

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  for (int c0 = 0; c0 < tp; c0 += BC) {
    float st[NB][4], dpt[NB][4];   // S^T and dP^T: rows are keys, columns queries
    if constexpr (REG) {
      attn::scores<DH, BC / 16>(st, ka, qs + c0 * LD, LD);
      attn::scores<DH, BC / 16>(dpt, va, das + c0 * LD, LD);
    } else {
      attn::scores_smem_a<DH, BC / 16>(st, kst, LD, qs + c0 * LD, LD);
      attn::scores_smem_a<DH, BC / 16>(dpt, vst, LD, das + c0 * LD, LD);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = c0 + j * 8 + 2 * c4 + (e & 1);
        const float p = attn::ex2(st[j][e] * c2 - ms[i]) * li[i];
        st[j][e] = p;
        dpt[j][e] = ((dpt[j][e] - dls[i]) * p) * scale;
      }
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      unsigned a[4];
      attn::c_to_a(a, st[2 * kk], st[2 * kk + 1]);
      attn::accumulate<DH>(dv, a, das + (c0 + kk * 16) * LD, LD);
      attn::c_to_a(a, dpt[2 * kk], dpt[2 * kk + 1]);
      attn::accumulate<DH>(dk, a, qs + (c0 + kk * 16) * LD, LD);
    }
  }
  bf16* out = dqkv + (size_t)ctx * T * E3 + h * DH;
  attn::store_rows<DH>(dk, kst, out + E, E3, k0, T);
  attn::store_rows<DH>(dv, vst, out + 2 * E, E3, k0, T);
}

#define RETURN_IF_ERROR(call)                  \
  do {                                         \
    const cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

template <bool AT, bool BT, int EPI>
cudaError_t gemm(const bf16* A, int lda, const bf16* B, int ldb, int M, int N, int K, bf16* C16,
                 float* C32, int ldc, const bf16* R, int ldr, const float* X32, int splits,
                 cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  gemm_kernel<AT, BT, EPI><<<grid, GEMM_THREADS, 0, stream>>>(
      A, lda, B, ldb, M, N, K, C16, C32, ldc, R, ldr, X32, (long long)M * N);
  return cudaGetLastError();
}

// Row splits of dW = A^T dY ([Mw, Nw] over K rows): enough CTAs for two
// waves of the card, at most MAX_SPLITS and one BK tile a split.
int dw_splits(int Mw, int Nw, int K) {
  const int tiles = ((Mw + BM - 1) / BM) * ((Nw + BN - 1) / BN);
  int s = (2 * SMS + tiles - 1) / tiles;
  s = s < MAX_SPLITS ? s : MAX_SPLITS;
  return s < K / BK ? s : K / BK;
}

// dw[Mw, Nw] += A^T dY over K rows (A [K, Mw], dY [K, Nw] row-major).
cudaError_t weight_grad(const bf16* A, const bf16* dY, int Mw, int Nw, int K, float* partial,
                        float* dw, cudaStream_t stream) {
  const int splits = dw_splits(Mw, Nw, K);
  cudaError_t err = gemm<true, false, EPI_F32>(A, Mw, dY, Nw, Mw, Nw, K, nullptr, partial, Nw,
                                               nullptr, 0, nullptr, splits, stream);
  if (err != cudaSuccess) return err;
  const long long count = (long long)Mw * Nw;
  reduce_add_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(partial, splits, count,
                                                                         dw);
  return cudaGetLastError();
}

cudaError_t gain_grad(const bf16* x, const float* dy, const float* mu, const float* rs, int M,
                      int E, float* partial, float* dg, cudaStream_t stream) {
  const int parts = (M + ROWS_PER_PART - 1) / ROWS_PER_PART;
  dg_partial_kernel<<<parts, 256, 0, stream>>>(x, dy, mu, rs, partial, M, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_add_kernel<<<(E + 255) / 256, 256, 0, stream>>>(partial, parts, E, dg);
  return cudaGetLastError();
}

cudaError_t layer_norm(const bf16* x, int ldx, const float* g, bf16* y, int ldy, int M, int E,
                       cudaStream_t stream) {
  ln_kernel<<<(M + 7) / 8, 256, 0, stream>>>(x, ldx, g, y, ldy, M, E);
  return cudaGetLastError();
}

// 1/sqrt(dh) in double, rounded once to fp32, as the JAX kernels' python scale
float attn_scale(int dh) { return (float)(1.0 / std::sqrt((double)dh)); }

// att = the attention of qkv [nc, T, 3E] -> [nc, T, E] (attn::launch_fwd
// over the nc x H (context, head) pairs), and each row's statistics m, l
// [nc, H, T] when not null.
template <int DH>
cudaError_t attention_fwd(const bf16* qkv, bf16* att, float* m, float* l, int nc, int T, int E,
                          cudaStream_t stream) {
  const int H = E / DH;
  const long long E3 = 3LL * E;
  const attn::Strides sqkv{T * E3, DH, E3}, so{(long long)T * E, DH, E};
  return attn::launch_fwd<DH>(qkv, qkv + E, qkv + 2 * E, att, sqkv, sqkv, sqkv, so, nc * H, H, T,
                              attn_scale(DH), m, l, stream);
}

// dqkv [nc, T, 3E] from qkv, datt [nc, T, E] and the forward's m, l; delta
// [nc, H, T] is the query side's scratch for the key side.
template <int DH>
cudaError_t attention_bwd(const bf16* qkv, const bf16* datt, const float* m, const float* l,
                          float* delta, bf16* dqkv, int nc, int T, int E, cudaStream_t stream) {
  const dim3 grid((T + attn::TILE - 1) / attn::TILE, E / DH, nc);
  const size_t sq = bwd_q_smem<DH>(T), skv = bwd_kv_smem<DH>(T);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_q_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_kv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)skv);
  if (err != cudaSuccess) return err;
  attn_bwd_q_kernel<DH><<<grid, attn::WARPS * 32, sq, stream>>>(qkv, datt, m, l, delta, dqkv, T,
                                                                E, attn_scale(DH));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_kv_kernel<DH><<<grid, attn::WARPS * 32, skv, stream>>>(qkv, datt, m, l, delta, dqkv,
                                                                  T, E, attn_scale(DH));
  return cudaGetLastError();
}

// The workspace of a group of g contexts, carved in 256-byte-aligned pieces.
struct Workspace {
  size_t bytes = 0;
  size_t take(size_t n) {
    const size_t at = bytes;
    bytes += (n + 255) / 256 * 256;
    return at;
  }
};

struct FwdBufs {
  bf16 *xn, *qkv, *att, *hact;
};

FwdBufs fwd_layout(unsigned char* base, Workspace& w, size_t rows, int E) {
  FwdBufs b;
  b.xn = reinterpret_cast<bf16*>(base + w.take(rows * E * 2));
  b.qkv = reinterpret_cast<bf16*>(base + w.take(rows * 3 * E * 2));
  b.att = reinterpret_cast<bf16*>(base + w.take(rows * E * 2));
  b.hact = reinterpret_cast<bf16*>(base + w.take(rows * 4 * E * 2));
  return b;
}

struct BwdBufs {
  float *dx, *hmid, *dxn, *mu, *rs, *partial, *m, *l, *delta;
  bf16 *dxb, *xn, *hact, *dh, *qkv, *att, *datt, *dqkv;
};

// Rows of a group's buffers: g T rounded up to the GEMM's depth BK, so that
// the weight gradients (dW = A^T dY, the rows as the product's depth) run
// over whole BK tiles of rows; the rows past g T of their operands (hact,
// dxb, xn, dh, att, dqkv) are zeroed at the start of each group.
size_t padded_rows(int g, int T) { return (size_t)attn::round_up(g * T, BK); }

BwdBufs bwd_layout(unsigned char* base, Workspace& w, int g, int T, int E, int H) {
  const size_t rows = padded_rows(g, T);
  BwdBufs b;
  b.dx = reinterpret_cast<float*>(base + w.take(rows * E * 4));
  b.hmid = reinterpret_cast<float*>(base + w.take(rows * 4 * E * 4));
  b.dxn = reinterpret_cast<float*>(base + w.take(rows * E * 4));
  b.mu = reinterpret_cast<float*>(base + w.take(rows * 4));
  b.rs = reinterpret_cast<float*>(base + w.take(rows * 4));
  // dW partials: at most MAX_SPLITS x the largest stack slice, or the gains'
  size_t part = 0;
  const int K = (int)rows;
  const int shapes[4][2] = {{E, 3 * E}, {E, E}, {E, 4 * E}, {4 * E, E}};
  for (auto& s : shapes) {
    const size_t need = (size_t)dw_splits(s[0], s[1], K) * s[0] * s[1];
    part = need > part ? need : part;
  }
  const size_t gparts = ((rows + ROWS_PER_PART - 1) / ROWS_PER_PART) * E;
  part = gparts > part ? gparts : part;
  b.partial = reinterpret_cast<float*>(base + w.take(part * 4));
  // the attention's row statistics and delta, [g, H, T] each
  b.m = reinterpret_cast<float*>(base + w.take((size_t)g * H * T * 4));
  b.l = reinterpret_cast<float*>(base + w.take((size_t)g * H * T * 4));
  b.delta = reinterpret_cast<float*>(base + w.take((size_t)g * H * T * 4));
  b.dxb = reinterpret_cast<bf16*>(base + w.take(rows * E * 2));
  b.xn = reinterpret_cast<bf16*>(base + w.take(rows * E * 2));
  b.hact = reinterpret_cast<bf16*>(base + w.take(rows * 4 * E * 2));
  b.dh = reinterpret_cast<bf16*>(base + w.take(rows * 4 * E * 2));
  b.qkv = reinterpret_cast<bf16*>(base + w.take(rows * 3 * E * 2));
  b.att = reinterpret_cast<bf16*>(base + w.take(rows * E * 2));
  b.datt = reinterpret_cast<bf16*>(base + w.take(rows * E * 2));
  b.dqkv = reinterpret_cast<bf16*>(base + w.take(rows * 3 * E * 2));
  return b;
}

// Zero rows M .. padded of the weight gradients' operands.
cudaError_t zero_pad_rows(const BwdBufs& b, size_t M, size_t padded, int E,
                          cudaStream_t stream) {
  if (padded == M) return cudaSuccess;
  const size_t n = padded - M;
  const struct { bf16* p; int cols; } bufs[] = {{b.hact, 4 * E}, {b.dxb, E}, {b.xn, E},
                                                {b.dh, 4 * E},   {b.att, E}, {b.dqkv, 3 * E}};
  for (const auto& x : bufs) {
    cudaError_t err = cudaMemsetAsync(x.p + M * x.cols, 0, n * x.cols * sizeof(bf16), stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool shape_ok(int T, int E, int H) {
  if (H <= 0 || E % H || E % 32 || T < 1 || T > T_MAX) return false;
  const int dh = E / H;
  return dh % 16 == 0 && dh <= 128;
}

// f(std::integral_constant<int, DH>()) for the head dim dh (shape_ok holds).
template <typename Fn>
int with_head_dim(int dh, Fn f) {
  switch (dh) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 48: return f(std::integral_constant<int, 48>());
    case 64: return f(std::integral_constant<int, 64>());
    case 80: return f(std::integral_constant<int, 80>());
    case 96: return f(std::integral_constant<int, 96>());
    case 112: return f(std::integral_constant<int, 112>());
    default: return f(std::integral_constant<int, 128>());
  }
}

template <int DH>
int forward_impl(const bf16* x, bf16* out, bf16* xsave, const bf16* wqkv, const bf16* wproj,
                 const bf16* wfc, const bf16* wfc2, const float* g1, const float* g2,
                 unsigned char* ws, int n, int T, int E, int layers, int last_only, int group,
                 cudaStream_t stream) {
  const int E3 = 3 * E, F = 4 * E;
  const size_t stream_elems = (size_t)n * T * E;
  RETURN_IF_ERROR(cudaMemcpyAsync(xsave, x, stream_elems * 2, cudaMemcpyDeviceToDevice, stream));
  Workspace w;
  const FwdBufs b = fwd_layout(ws, w, (size_t)group * T, E);
  for (int c0 = 0; c0 < n; c0 += group) {
    const int nc = n - c0 < group ? n - c0 : group;
    const int M = nc * T;
    for (int l = 0; l < layers; ++l) {
      const bf16* Wqkv = wqkv + (size_t)l * E * E3;
      const bf16* Wproj = wproj + (size_t)l * E * E;
      const bf16* Wfc = wfc + (size_t)l * E * F;
      const bf16* Wfc2 = wfc2 + (size_t)l * F * E;
      const bf16* xin = xsave + ((size_t)(2 * l) * n + c0) * T * E;
      bf16* xmid = xsave + ((size_t)(2 * l + 1) * n + c0) * T * E;
      RETURN_IF_ERROR(layer_norm(xin, E, g1 + (size_t)l * E, b.xn, E, M, E, stream));
      RETURN_IF_ERROR((gemm<false, false, EPI_BF16>(b.xn, E, Wqkv, E3, M, E3, E, b.qkv, nullptr,
                                                    E3, nullptr, 0, nullptr, 1, stream)));
      RETURN_IF_ERROR(attention_fwd<DH>(b.qkv, b.att, nullptr, nullptr, nc, T, E, stream));
      RETURN_IF_ERROR((gemm<false, false, EPI_RESID>(b.att, E, Wproj, E, M, E, E, xmid, nullptr,
                                                     E, xin, E, nullptr, 1, stream)));
      const bool last = l == layers - 1;
      if (last && last_only) {
        // only the last position leaves the chunk: its MLP alone
        const bf16* xm_last = xmid + (size_t)(T - 1) * E;
        RETURN_IF_ERROR(layer_norm(xm_last, T * E, g2 + (size_t)l * E, b.xn, E, nc, E, stream));
        RETURN_IF_ERROR((gemm<false, false, EPI_GELU>(b.xn, E, Wfc, F, nc, F, E, b.hact, nullptr,
                                                      F, nullptr, 0, nullptr, 1, stream)));
        RETURN_IF_ERROR((gemm<false, false, EPI_RESID>(b.hact, F, Wfc2, E, nc, E, F,
                                                       out + (size_t)c0 * E, nullptr, E, xm_last,
                                                       T * E, nullptr, 1, stream)));
        continue;
      }
      bf16* xnext = last ? out + (size_t)c0 * T * E
                         : xsave + ((size_t)(2 * l + 2) * n + c0) * T * E;
      RETURN_IF_ERROR(layer_norm(xmid, E, g2 + (size_t)l * E, b.xn, E, M, E, stream));
      RETURN_IF_ERROR((gemm<false, false, EPI_GELU>(b.xn, E, Wfc, F, M, F, E, b.hact, nullptr, F,
                                                    nullptr, 0, nullptr, 1, stream)));
      RETURN_IF_ERROR((gemm<false, false, EPI_RESID>(b.hact, F, Wfc2, E, M, E, F, xnext, nullptr,
                                                     E, xmid, E, nullptr, 1, stream)));
    }
  }
  return 0;
}

template <int DH>
int backward_impl(const bf16* xsave, const bf16* dxin, const bf16* wqkv, const bf16* wproj,
                  const bf16* wfc, const bf16* wfc2, const float* g1, const float* g2, bf16* dx0,
                  float* dwqkv, float* dwproj, float* dwfc, float* dwfc2, float* dg1, float* dg2,
                  unsigned char* ws, int n, int T, int E, int layers, int group,
                  cudaStream_t stream) {
  const int E3 = 3 * E, F = 4 * E, H = E / DH;
  RETURN_IF_ERROR(cudaMemsetAsync(dwqkv, 0, (size_t)layers * E * E3 * 4, stream));
  RETURN_IF_ERROR(cudaMemsetAsync(dwproj, 0, (size_t)layers * E * E * 4, stream));
  RETURN_IF_ERROR(cudaMemsetAsync(dwfc, 0, (size_t)layers * E * F * 4, stream));
  RETURN_IF_ERROR(cudaMemsetAsync(dwfc2, 0, (size_t)layers * F * E * 4, stream));
  RETURN_IF_ERROR(cudaMemsetAsync(dg1, 0, (size_t)layers * E * 4, stream));
  RETURN_IF_ERROR(cudaMemsetAsync(dg2, 0, (size_t)layers * E * 4, stream));
  Workspace w;
  const BwdBufs b = bwd_layout(ws, w, group, T, E, H);
  for (int c0 = 0; c0 < n; c0 += group) {
    const int nc = n - c0 < group ? n - c0 : group;
    const int M = nc * T;
    const int Mp = (int)padded_rows(nc, T);   // the weight gradients' depth
    RETURN_IF_ERROR(zero_pad_rows(b, M, Mp, E, stream));
    const long long elems = (long long)M * E;
    const bf16* dxin_g = dxin + (size_t)c0 * T * E;
    to_f32_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, stream>>>(dxin_g, b.dx, elems);
    RETURN_IF_ERROR(cudaGetLastError());
    RETURN_IF_ERROR(cudaMemcpyAsync(b.dxb, dxin_g, elems * 2, cudaMemcpyDeviceToDevice, stream));
    for (int l = layers - 1; l >= 0; --l) {
      const bf16* Wqkv = wqkv + (size_t)l * E * E3;
      const bf16* Wproj = wproj + (size_t)l * E * E;
      const bf16* Wfc = wfc + (size_t)l * E * F;
      const bf16* Wfc2 = wfc2 + (size_t)l * F * E;
      const bf16* xin = xsave + ((size_t)(2 * l) * n + c0) * T * E;
      const bf16* xmid = xsave + ((size_t)(2 * l + 1) * n + c0) * T * E;

      // MLP backward (recompute xn2, hmid, hact)
      RETURN_IF_ERROR(layer_norm(xmid, E, g2 + (size_t)l * E, b.xn, E, M, E, stream));
      RETURN_IF_ERROR((gemm<false, false, EPI_F32_GELU>(b.xn, E, Wfc, F, M, F, E, b.hact, b.hmid,
                                                        F, nullptr, 0, nullptr, 1, stream)));
      RETURN_IF_ERROR(weight_grad(b.hact, b.dxb, F, E, Mp, b.partial, dwfc2 + (size_t)l * F * E,
                                  stream));
      RETURN_IF_ERROR((gemm<false, true, EPI_GELU_GRAD>(b.dxb, E, Wfc2, E, M, F, E, b.dh, nullptr,
                                                        F, nullptr, 0, b.hmid, 1, stream)));
      RETURN_IF_ERROR(weight_grad(b.xn, b.dh, E, F, Mp, b.partial, dwfc + (size_t)l * E * F,
                                  stream));
      RETURN_IF_ERROR((gemm<false, true, EPI_F32>(b.dh, F, Wfc, F, M, E, F, nullptr, b.dxn, E,
                                                  nullptr, 0, nullptr, 1, stream)));
      ln_bwd_kernel<<<(M + 7) / 8, 256, 0, stream>>>(xmid, g2 + (size_t)l * E, b.dxn, b.dx, b.dxb,
                                                     b.mu, b.rs, M, E);
      RETURN_IF_ERROR(cudaGetLastError());
      RETURN_IF_ERROR(gain_grad(xmid, b.dxn, b.mu, b.rs, M, E, b.partial, dg2 + (size_t)l * E,
                                stream));

      // attention backward (recompute xn1, q|k|v, att and p)
      RETURN_IF_ERROR(layer_norm(xin, E, g1 + (size_t)l * E, b.xn, E, M, E, stream));
      RETURN_IF_ERROR((gemm<false, false, EPI_BF16>(b.xn, E, Wqkv, E3, M, E3, E, b.qkv, nullptr,
                                                    E3, nullptr, 0, nullptr, 1, stream)));
      RETURN_IF_ERROR(attention_fwd<DH>(b.qkv, b.att, b.m, b.l, nc, T, E, stream));
      RETURN_IF_ERROR(weight_grad(b.att, b.dxb, E, E, Mp, b.partial, dwproj + (size_t)l * E * E,
                                  stream));
      RETURN_IF_ERROR((gemm<false, true, EPI_BF16>(b.dxb, E, Wproj, E, M, E, E, b.datt, nullptr,
                                                   E, nullptr, 0, nullptr, 1, stream)));
      RETURN_IF_ERROR(attention_bwd<DH>(b.qkv, b.datt, b.m, b.l, b.delta, b.dqkv, nc, T, E, stream));
      RETURN_IF_ERROR(weight_grad(b.xn, b.dqkv, E, E3, Mp, b.partial, dwqkv + (size_t)l * E * E3,
                                  stream));
      RETURN_IF_ERROR((gemm<false, true, EPI_F32>(b.dqkv, E3, Wqkv, E3, M, E, E3, nullptr, b.dxn,
                                                  E, nullptr, 0, nullptr, 1, stream)));
      // the bottom layer's bf16(dx) is the chunk's output
      bf16* dxb_out = l == 0 ? dx0 + (size_t)c0 * T * E : b.dxb;
      ln_bwd_kernel<<<(M + 7) / 8, 256, 0, stream>>>(xin, g1 + (size_t)l * E, b.dxn, b.dx,
                                                     dxb_out, b.mu, b.rs, M, E);
      RETURN_IF_ERROR(cudaGetLastError());
      RETURN_IF_ERROR(gain_grad(xin, b.dxn, b.mu, b.rs, M, E, b.partial, dg1 + (size_t)l * E,
                                stream));
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Bytes of the workspace for groups of `group` contexts (kind 0: forward,
// 1: backward); -1 for a shape the kernels do not take.
long long fused_train_workspace(int kind, int group, int T, int E, int H) {
  if (!shape_ok(T, E, H) || group <= 0) return -1;
  Workspace w;
  if (kind == 0)
    fwd_layout(nullptr, w, (size_t)group * T, E);
  else
    bwd_layout(nullptr, w, group, T, E, H);
  return (long long)w.bytes;
}

// Forward of a chunk of `layers` layers on n contexts, on `stream`, in
// groups of `group`: x [n, T, E] -> out [n, T, E] (or [n, E], the last
// position, when last_only) and xsave [2 layers, n, T, E].  Weights: wqkv
// [layers, E, 3E], wproj [layers, E, E], wfc [layers, E, 4E], wfc2
// [layers, 4E, E] bf16; g1, g2 [layers, E] fp32.  Returns the first CUDA
// error of a launch (0 = all launched).
int fused_train_forward(const bf16* x, bf16* out, bf16* xsave, const bf16* wqkv,
                        const bf16* wproj, const bf16* wfc, const bf16* wfc2, const float* g1,
                        const float* g2, void* workspace, int n, int T, int E, int H, int layers,
                        int last_only, int group, cudaStream_t stream) {
  if (!shape_ok(T, E, H) || group <= 0 || layers <= 0) return (int)cudaErrorInvalidValue;
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  return with_head_dim(E / H, [&](auto dh) {
    return forward_impl<decltype(dh)::value>(x, out, xsave, wqkv, wproj, wfc, wfc2, g1, g2, ws,
                                             n, T, E, layers, last_only, group, stream);
  });
}

// Backward of a chunk: xsave [2 layers, n, T, E] and dxin [n, T, E] (the
// gradient of the chunk's output stream) -> dx0 [n, T, E] bf16 and the fp32
// gradients of the stacks (dwqkv .. dg2, the stacks' shapes), summed over
// all n contexts in a fixed order.
int fused_train_backward(const bf16* xsave, const bf16* dxin, const bf16* wqkv,
                         const bf16* wproj, const bf16* wfc, const bf16* wfc2, const float* g1,
                         const float* g2, bf16* dx0, float* dwqkv, float* dwproj, float* dwfc,
                         float* dwfc2, float* dg1, float* dg2, void* workspace, int n, int T,
                         int E, int H, int layers, int group, cudaStream_t stream) {
  if (!shape_ok(T, E, H) || group <= 0 || layers <= 0) return (int)cudaErrorInvalidValue;
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  return with_head_dim(E / H, [&](auto dh) {
    return backward_impl<decltype(dh)::value>(xsave, dxin, wqkv, wproj, wfc, wfc2, g1, g2, dx0,
                                              dwqkv, dwproj, dwfc, dwfc2, dg1, dg2, ws, n, T, E,
                                              layers, group, stream);
  });
}

const char* fused_train_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
