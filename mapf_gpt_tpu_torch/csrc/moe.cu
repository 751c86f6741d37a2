// The Moonlight-16B-A3B policy's kernels for Hopper (sm_90a): multi-head
// latent attention's glue and the mixture-of-experts layer, as
// mapf_gpt_tpu_torch/ops/moe.py launches them, one C entry point an op.
// Each op's plain PyTorch version is beside its wrapper in ops/moe.py, with
// the same rounding points (bf16 between ops, fp32 accumulation and norms).
//
//   moe_rms_norm      y = bf16(x * rsqrt(mean(x^2) + eps) * g), a warp a row
//   moe_linear        C = bf16(A W) or bf16(R + bf16(A W)) (gemm_tile.cuh's
//                     gemm::run with the round and residual epilogues), or
//                     fp32 (the router's product)
//   moe_swiglu        grouped_gemm.cuh: the routed experts' gate|up product
//                     with the SwiGLU epilogue over the router's segments, or
//                     a dense SwiGLU (layer 0, the shared experts)
//   moe_grouped       the routed experts' down product over the segments
//   moe_route         the router after its product, three kernels:
//                     topk_kernel (sigmoid scores, the k largest of score +
//                     bias, weights), route_offsets_kernel (segments padded
//                     to 128 rows, the tile table) and scatter_kernel (the
//                     permutation: each (token, choice) a row of the
//                     experts' input, grouped by expert)
//   moe_combine       h = bf16(h + shared + sum_k w_k y_k), k in order
//   moe_rope          RoPE on q's rope columns and on the shared rope key
//   moe_compact       the attention's heads [.., D] -> [.., dv] columns
//   moe_thin_attention  one query row a context (the thinned last layer)
//
// Why it is built this way:
//   * The expert counts stay on the device.  topk_kernel counts each block's
//     choices in shared memory and adds them to 64 global counters;
//     route_offsets_kernel (one block) pads each expert's count to a multiple of
//     BM = 128 rows, writes the segment table (tile_start, row0) that the
//     grouped GEMM's tile walker reads, adds the counts to the per-layer
//     counter the benchmark reads, and zeroes the scratch for the next
//     layer; scatter_kernel reserves each block's rows of an expert with one
//     atomic add.  No count, offset or size is read by the host, so a
//     forward has no host sync.  The buffers are sized for the worst case,
//     M k + X (BM - 1) rows.
//   * Determinism: a row's place inside its expert's segment depends on
//     the order in which blocks reserve rows, but no result does: a GEMM
//     row depends on its A row alone, and moe_combine adds each token's k
//     expert outputs in the router's order, from fixed slots, with no float
//     atomics.  A seeded rollout is bit-identical run to run.
//   * The router's product b Wr is float32-exact: Wr is split into three
//     bf16 terms (hi + mid + lo == Wr) on the host once, b is bf16, so the
//     bf16 GEMM's products are exact and its sums fp32; topk_kernel adds the
//     three column blocks ((lo + mid) + hi).  That puts the 0.26 MFLOP a
//     token on the tensor cores instead of the CUDA cores.
//   * The permutation copies each token's row once per choice (786,432
//     rows of 4 KB a layer at the cell's size): TMA on sm_90 cannot gather
//     rows, and the grouped GEMM wants a dense A.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libmoe.so moe.cu   (ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grouped_gemm.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int MAX_EXPERTS = 64;   // two a lane in topk_kernel's warp
constexpr int MAX_K = 8;
constexpr int BM = gemm::BM;

__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void load8(const bf16* src, float v[8]) {
  uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
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

// ------------------------------------------------------------ GEMM epilogues

// C = bf16(acc)
struct EpiRound {
  using Side = gemm::NoSide;
  static constexpr bool STAGED = true;
  bf16* c;
  int ldc;
  __device__ Side load(int, int) const { return {}; }
  __device__ float2 value(int, int, float v0, float v1, Side) const { return {v0, v1}; }
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

// C = acc in fp32, stored from registers
struct EpiF32 {
  using Side = gemm::NoSide;
  static constexpr bool STAGED = false;
  float* c;
  int ldc;
  __device__ Side load(int, int) const { return {}; }
  __device__ void operator()(int row, int col, float v0, float v1, Side, int) const {
    *reinterpret_cast<float2*>(c + (size_t)row * ldc + col) = make_float2(v0, v1);
  }
};

// ------------------------------------------------------------------ kernels

// y[r, :n] = bf16(x[r, :n] * rsqrt(mean(x^2) + eps) * g), a warp a row (n a
// multiple of 8, at most 4096)
__global__ void __launch_bounds__(256)
rms_norm_kernel(const bf16* __restrict__ x, long long ldx, const float* __restrict__ g,
                bf16* __restrict__ y, long long ldy, int M, int n, float eps) {
  constexpr int J = 16;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * ldx;
  float v[J][8];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int ci = lane + 32 * j;
    if (ci < n / 8) {
      load8(xr + ci * 8, v[j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += v[j][i] * v[j][i];
    }
  }
  const float rs = rsqrtf(warp_sum(s) / n + eps);
  bf16* yr = y + (size_t)row * ldy;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int ci = lane + 32 * j;
    if (ci >= n / 8) continue;
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = v[j][i] * rs * g[ci * 8 + i];
    store8(yr + ci * 8, o);
  }
}

// The router's choices, a warp a token: logits3 [M, 3X] (hi | mid | lo
// column blocks of b Wr) -> s = sigmoid, the K largest s + bias (ties to the
// lower expert), w = scale s / (sum of the chosen s + 1e-20).  Each block
// counts its choices in shared memory and adds them to counts[X].
__global__ void __launch_bounds__(256)
topk_kernel(const float* __restrict__ logits3, const float* __restrict__ bias, int M, int X,
            int K, float scale, int* __restrict__ idx, float* __restrict__ w,
            int* __restrict__ counts) {
  __shared__ int hist[MAX_EXPERTS];
  for (int i = threadIdx.x; i < X; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * 8 + (threadIdx.x >> 5); row < M; row += gridDim.x * 8) {
    const float* L = logits3 + (size_t)row * 3 * X;
    float s[2], key[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = lane + 32 * j;
      if (e < X) {
        const float z = (L[2 * X + e] + L[X + e]) + L[e];
        s[j] = 1.f / (1.f + expf(-z));
        key[j] = s[j] + bias[e];
      } else {
        s[j] = 0.f;
        key[j] = -INFINITY;
      }
    }
    bool taken[2] = {false, false};
    int chosen[MAX_K];
    float cs[MAX_K];
    float sum = 0.f;
    for (int k = 0; k < K; ++k) {
      // the lane's best untaken candidate (expert lane first on a tie)
      float bv = -INFINITY;
      int bi = 1 << 30;
      if (!taken[0] && lane < X) {
        bv = key[0];
        bi = lane;
      }
      if (!taken[1] && lane + 32 < X && (key[1] > bv)) {
        bv = key[1];
        bi = lane + 32;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      const float mine = (bi >> 5) ? s[1] : s[0];
      const float sv = __shfl_sync(0xffffffffu, mine, bi & 31);
      if ((bi & 31) == lane) taken[bi >> 5] = true;
      chosen[k] = bi;
      cs[k] = sv;
      sum += sv;
    }
    const float denom = sum + 1e-20f;
    if (lane < K) {
      float mw = 0.f;
      int me = 0;
#pragma unroll
      for (int k = 0; k < MAX_K; ++k)
        if (k == lane) {
          me = chosen[k];
          mw = cs[k];
        }
      idx[(size_t)row * K + lane] = me;
      w[(size_t)row * K + lane] = mw / denom * scale;
      atomicAdd(&hist[me], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < X; i += blockDim.x)
    if (hist[i]) atomicAdd(&counts[i], hist[i]);
}

// One block: segments padded to BM rows.  table = tile_start [X + 1] | row0
// [X]; counter[X] (int64, may be null) += counts; counts and fill zeroed.
__global__ void route_offsets_kernel(int* __restrict__ counts, int* __restrict__ fill, int X,
                                     int* __restrict__ table,
                                     unsigned long long* __restrict__ counter) {
  __shared__ int padded[MAX_EXPERTS];
  const int e = threadIdx.x;
  int cnt = 0;
  if (e < X) {
    cnt = counts[e];
    padded[e] = (cnt + BM - 1) / BM;
  }
  __syncthreads();
  if (e == 0) {
    int t = 0;
    for (int i = 0; i < X; ++i) {
      table[i] = t;
      table[X + 1 + i] = t * BM;
      t += padded[i];
    }
    table[X] = t;
  }
  if (e < X) {
    if (counter != nullptr) counter[e] += (unsigned long long)cnt;
    counts[e] = 0;
    fill[e] = 0;
  }
}

// The permutation: each block takes 256 (token, choice) pairs p = token K +
// k, reserves its rows of each expert with one atomic add, writes slot[p]
// (the pair's row of the experts' input) and copies b's row there.
__global__ void __launch_bounds__(256)
scatter_kernel(const bf16* __restrict__ b, int E, const int* __restrict__ idx, int pairs, int K,
               int X, const int* __restrict__ table, int* __restrict__ fill,
               int* __restrict__ slot, bf16* __restrict__ out) {
  __shared__ int cnt[MAX_EXPERTS], base[MAX_EXPERTS], rows[256], srcs[256];
  for (int i = threadIdx.x; i < X; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int p = blockIdx.x * 256 + threadIdx.x;
  int e = 0, rank = 0;
  if (p < pairs) {
    e = idx[p];
    rank = atomicAdd(&cnt[e], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < X; i += blockDim.x)
    if (cnt[i]) base[i] = atomicAdd(&fill[i], cnt[i]);
  __syncthreads();
  if (p < pairs) {
    const int r = table[X + 1 + e] + base[e] + rank;
    slot[p] = r;
    rows[threadIdx.x] = r;
    srcs[threadIdx.x] = p / K;
  }
  __syncthreads();
  const int n = min(256, pairs - blockIdx.x * 256), chunks = E / 8;
  for (int q = threadIdx.x; q < n * chunks; q += 256) {
    const int i = q / chunks, ch = q % chunks;
    *reinterpret_cast<uint4*>(out + (size_t)rows[i] * E + ch * 8) =
        *reinterpret_cast<const uint4*>(b + (size_t)srcs[i] * E + ch * 8);
  }
}

// h[r] = bf16(h[r] + (ys[r] + sum_k w[r, k] y[slot[r, k]])), k in order; a
// block a row, 8 columns a thread
__global__ void __launch_bounds__(256)
combine_kernel(bf16* __restrict__ h, const bf16* __restrict__ ys, const bf16* __restrict__ y,
               const int* __restrict__ slot, const float* __restrict__ w, int E, int K) {
  const int r = blockIdx.x;
  for (int ch = threadIdx.x; ch < E / 8; ch += blockDim.x) {
    float acc[8], v[8];
    load8(ys + (size_t)r * E + ch * 8, acc);
    for (int k = 0; k < K; ++k) {
      const float wk = w[(size_t)r * K + k];
      load8(y + (size_t)slot[(size_t)r * K + k] * E + ch * 8, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += wk * v[i];
    }
    load8(h + (size_t)r * E + ch * 8, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += v[i];
    store8(h + (size_t)r * E + ch * 8, acc);
  }
}

// RoPE, a thread a pair: on q [M, H D] (q non-null: columns dn .. D of each
// head; row r at position r % T, or at `fixed` when fixed >= 0) in place,
// and (kva non-null) the shared key kva[r, R .. R + dr) rotated into columns
// dn .. D of every head of kv [M, H 2D].  cos, sin: fp32 [T, dr / 2].
__global__ void __launch_bounds__(256)
rope_kernel(bf16* __restrict__ q, const bf16* __restrict__ kva, int ldkva, int R,
            bf16* __restrict__ kv, int M, int H, int D, int dn, int T, int fixed,
            const float* __restrict__ cosv, const float* __restrict__ sinv) {
  const int half = (D - dn) / 2, nq = q != nullptr ? H : 0;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per = (long long)(nq + (kva != nullptr)) * half;
  if (i >= (long long)M * per) return;
  const int r = (int)(i / per), j = (int)(i % per), hh = j / half, pi = j % half;
  const int pos = fixed >= 0 ? fixed : r % T;
  const float c = cosv[pos * half + pi], s = sinv[pos * half + pi];
  if (hh < nq) {
    __nv_bfloat162* at =
        reinterpret_cast<__nv_bfloat162*>(q + (size_t)r * H * D + hh * D + dn + 2 * pi);
    const float2 x = __bfloat1622float2(*at);
    *at = __floats2bfloat162_rn(x.x * c - x.y * s, x.x * s + x.y * c);
    return;
  }
  const float2 x = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(kva + (size_t)r * ldkva + R + 2 * pi));
  const __nv_bfloat162 out = __floats2bfloat162_rn(x.x * c - x.y * s, x.x * s + x.y * c);
  for (int h2 = 0; h2 < H; ++h2)
    *reinterpret_cast<__nv_bfloat162*>(kv + (size_t)r * H * 2 * D + h2 * 2 * D + dn + 2 * pi) =
        out;
}

// out [M, H dv] = the first dv columns of each head of o [M, H, D]
__global__ void __launch_bounds__(256)
compact_kernel(const bf16* __restrict__ o, bf16* __restrict__ out, int M, int H, int D, int dv) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int chunks = dv / 8;
  if (i >= (long long)M * H * chunks) return;
  const long long rh = i / chunks;
  const int ch = (int)(i % chunks);
  *reinterpret_cast<uint4*>(out + rh * dv + ch * 8) =
      *reinterpret_cast<const uint4*>(o + rh * D + ch * 8);
}

// One query row a context (the thinned last layer), a block a (context,
// head): q [N, H D] (roped), keys and values from kv [N T, H 2D] (K in
// columns 0 .. D of a head, V in D .. D + dv); fp32 scores, p =
// bf16(softmax), out [N, H dv] = bf16(p V).  Shared memory: q and T scores.
__global__ void __launch_bounds__(256)
thin_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                      bf16* __restrict__ out, int T, int H, int D, int dv, float scale) {
  extern __shared__ float sh[];
  float* qs = sh;
  float* ps = sh + D;
  __shared__ float red[32];
  const int n = blockIdx.x, hh = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  for (int d = tid; d < D; d += blockDim.x)
    qs[d] = __bfloat162float(q[((size_t)n * H + hh) * D + d]);
  __syncthreads();
  const size_t ld = (size_t)H * 2 * D;
  const bf16* base = kv + (size_t)n * T * ld + (size_t)hh * 2 * D;
  float mx = -INFINITY;
  for (int t = tid; t < T; t += blockDim.x) {
    const bf16* k = base + (size_t)t * ld;
    float acc = 0.f;
    for (int d = 0; d < D; d += 8) {
      float v[8];
      load8(k + d, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc += qs[d + i] * v[i];
    }
    acc *= scale;
    ps[t] = acc;
    mx = fmaxf(mx, acc);
  }
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = -INFINITY;
  for (int i = 0; i < nw; ++i) mx = fmaxf(mx, red[i]);
  __syncthreads();
  float sum = 0.f;
  for (int t = tid; t < T; t += blockDim.x) {
    const float e = expf(ps[t] - mx);
    ps[t] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = 0.f;
  for (int i = 0; i < nw; ++i) sum += red[i];
  for (int t = tid; t < T; t += blockDim.x) ps[t] = rbf(ps[t] / sum);
  __syncthreads();
  for (int d = tid; d < dv; d += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < T; ++t) acc += ps[t] * __bfloat162float(base[(size_t)t * ld + D + d]);
    out[((size_t)n * H + hh) * dv + d] = __float2bfloat16(acc);
  }
}

#define RETURN_IF_ERROR(call)                  \
  do {                                         \
    const cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

int blocks_for(long long work, int per) { return (int)((work + per - 1) / per); }

}  // namespace

extern "C" {

// launches of the library's kernels since the last reset, by op (the order
// of moe_launch_names)
static unsigned long long g_launches[11];

const char* moe_launch_names() {
  return "rms_norm,linear,swiglu,grouped,topk,offsets,scatter,combine,rope,compact,thin_attention";
}

void moe_launch_counts(unsigned long long* out) {
  for (int i = 0; i < 11; ++i) out[i] = g_launches[i];
}

void moe_reset_launches() {
  for (int i = 0; i < 11; ++i) g_launches[i] = 0;
}

int moe_rms_norm(const bf16* x, long long ldx, const float* g, bf16* y, long long ldy, int M,
                 int n, float eps, cudaStream_t stream) {
  if (M < 0 || n < 8 || n % 8 || n > 4096) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  rms_norm_kernel<<<blocks_for(M, 8), 256, 0, stream>>>(x, ldx, g, y, ldy, M, n, eps);
  ++g_launches[0];
  return (int)cudaGetLastError();
}

// mode 0: C = bf16(A W); 1: C = bf16(R + bf16(A W)) (R row stride ldr, may
// be C); 2: C = fp32 A W.  A [M, K] (row stride lda), W [K, N] (row stride N).
int moe_linear(const bf16* A, long long lda, const bf16* W, void* C, int M, int N, int K,
               int mode, const bf16* R, long long ldr, cudaStream_t stream) {
  cudaError_t err;
  if (mode == 0)
    err = gemm::run<false, false>(A, lda, W, N, M, N, K, EpiRound{static_cast<bf16*>(C), N},
                                  stream);
  else if (mode == 1)
    err = gemm::run<false, false>(A, lda, W, N, M, N, K,
                                  EpiResid{static_cast<bf16*>(C), N, R, ldr}, stream);
  else if (mode == 2)
    err = gemm::run<false, false>(A, lda, W, N, M, N, K, EpiF32{static_cast<float*>(C), N},
                                  stream);
  else
    return (int)cudaErrorInvalidValue;
  ++g_launches[1];
  return (int)err;
}

// out [a_rows, N / 2] = SwiGLU of A W_e over the segments of `table`
// (tile_start [X + 1] | row0 [X]), or with a null table of A's first M rows
// against one W (X = 1).
int moe_swiglu(const bf16* A, int a_rows, const bf16* W, int X, bf16* out, int N, int K,
               const int* table, int M, cudaStream_t stream) {
  const grouped::Segments seg{table, table != nullptr ? table + X + 1 : nullptr, X, M};
  ++g_launches[2];
  return (int)grouped::run<true>(A, a_rows, W, table != nullptr ? X : 1, out, N, K, seg, stream);
}

// out [a_rows, N] = bf16(A W_e) over the segments of `table`
int moe_grouped(const bf16* A, int a_rows, const bf16* W, int X, bf16* out, int N, int K,
                const int* table, cudaStream_t stream) {
  if (table == nullptr) return (int)cudaErrorInvalidValue;
  const grouped::Segments seg{table, table + X + 1, X, 0};
  ++g_launches[3];
  return (int)grouped::run<false>(A, a_rows, W, X, out, N, K, seg, stream);
}

// The router after its product: topk, then the segment table and the
// permutation.  scratch: int [2 X] (counts | fill), the counts zero on entry
// and on return (route_offsets_kernel zeroes both before scatter_kernel adds
// to the fill); counter: int64 [X] or null.
int moe_route(const float* logits3, const float* bias, int M, int X, int K, float scale,
              int* idx, float* w, int* scratch, int* table, unsigned long long* counter,
              const bf16* b, int E, int* slot, bf16* out, cudaStream_t stream) {
  if (M < 1 || X < 1 || X > MAX_EXPERTS || K < 1 || K > MAX_K || K > X || E % 8)
    return (int)cudaErrorInvalidValue;
  int grid = blocks_for(M, 8);
  grid = grid < 132 * 8 ? grid : 132 * 8;
  topk_kernel<<<grid, 256, 0, stream>>>(logits3, bias, M, X, K, scale, idx, w, scratch);
  ++g_launches[4];
  RETURN_IF_ERROR(cudaGetLastError());
  route_offsets_kernel<<<1, MAX_EXPERTS, 0, stream>>>(scratch, scratch + X, X, table, counter);
  ++g_launches[5];
  RETURN_IF_ERROR(cudaGetLastError());
  const int pairs = M * K;
  scatter_kernel<<<blocks_for(pairs, 256), 256, 0, stream>>>(b, E, idx, pairs, K, X, table,
                                                             scratch + X, slot, out);
  ++g_launches[6];
  return (int)cudaGetLastError();
}

int moe_combine(bf16* h, const bf16* ys, const bf16* y, const int* slot, const float* w, int M,
                int E, int K, cudaStream_t stream) {
  if (M < 0 || E % 8) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  combine_kernel<<<M, 256, 0, stream>>>(h, ys, y, slot, w, E, K);
  ++g_launches[7];
  return (int)cudaGetLastError();
}

int moe_rope(bf16* q, const bf16* kva, int ldkva, int R, bf16* kv, int M, int H, int D, int dn,
             int T, int fixed, const float* cosv, const float* sinv, cudaStream_t stream) {
  if (M < 0 || (D - dn) % 2 || T < 1) return (int)cudaErrorInvalidValue;
  const long long work =
      (long long)M * ((q != nullptr ? H : 0) + (kva != nullptr)) * ((D - dn) / 2);
  if (work == 0) return 0;
  rope_kernel<<<blocks_for(work, 256), 256, 0, stream>>>(q, kva, ldkva, R, kv, M, H, D, dn, T,
                                                         fixed, cosv, sinv);
  ++g_launches[8];
  return (int)cudaGetLastError();
}

int moe_compact(const bf16* o, bf16* out, int M, int H, int D, int dv, cudaStream_t stream) {
  if (M < 0 || dv % 8 || D % 8 || dv > D) return (int)cudaErrorInvalidValue;
  const long long work = (long long)M * H * (dv / 8);
  if (work == 0) return 0;
  compact_kernel<<<blocks_for(work, 256), 256, 0, stream>>>(o, out, M, H, D, dv);
  ++g_launches[9];
  return (int)cudaGetLastError();
}

int moe_thin_attention(const bf16* q, const bf16* kv, bf16* out, int N, int T, int H, int D,
                       int dv, float scale, cudaStream_t stream) {
  if (N < 0 || T < 1 || D % 8 || dv > D) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const size_t smem = (size_t)(D + T) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  thin_attention_kernel<<<dim3(N, H), 256, smem, stream>>>(q, kv, out, T, H, D, dv, scale);
  ++g_launches[10];
  return (int)cudaGetLastError();
}

const char* moe_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
