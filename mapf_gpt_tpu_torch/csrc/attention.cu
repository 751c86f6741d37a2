// Non-causal softmax attention for Hopper (sm_90a): q, k, v [B, H, T, D] ->
// o [B, H, T, D], bf16 or fp32, T up to 256, D a multiple of 16 up to 128.
//
// Replaces the TPU kernel mapf_gpt_tpu/ops/attention.py::_attn_kernel (via
// attention_pallas) and computes what it computes, for each (batch, head)
// pair:
//   s = (q k^T) * scale                       (fp32 accumulation)
//   p = q.dtype(exp(s - max s) / sum exp(s - max s))   (fp32, then rounded)
//   o = q.dtype(p v)                          (fp32 accumulation)
// The plain PyTorch version of the same arithmetic is
// mapf_gpt_tpu_torch/ops/attention.py::attention_einsum.  Forward only: the
// JAX kernel has no gradient either.
//
// Bound on an H100 SXM at [8192, 5, 256, 32] bf16 (the 2M rollout's shape):
// 4 n T^2 D = 344 GFLOP of bf16 products -> 0.35 ms at 989 TFLOP/s, n T^2 =
// 2.7 G exps -> 0.04 ms at 67 TFLOP/s, against 4 n T D * 2 = 2.7 GB of q, k,
// v read and o written -> 0.80 ms at 3.35 TB/s: bound by bytes, at D=32.
// At D=128 the products weigh four times as much and the two meet.  So the
// design keeps the scores out of device memory (the plain version writes
// and reads n T^2 fp32 scores, 10.7 GB at that shape) and reads q, k and v
// once per 64 query rows.
//
// Where the TPU design does not carry over: the TPU kernel holds a whole
// 256 x 256 fp32 score tile in VMEM (256 KB, more than the 227 KB of shared
// memory a Hopper block can have), K pre-transposed, 16 pairs a program.
// Here one CTA takes one (pair, 64 query rows), 4 warps of 16 rows:
//   * the CTA stages Q, then K in chunks of 64 keys, into shared memory
//     (16-byte loads, rows past T zero-filled, so a T that is not a multiple
//     of 16 needs no other masking); K is read as [T, D] rows through
//     col-major WMMA fragments, so nothing is transposed;
//   * bf16: S = Q K^T on the tensor cores (WMMA 16x16x16, fp32
//     accumulation), the warp's 16 x T fp32 scores in shared memory
//     (64 x 256 x 4 = 64 KB a CTA); fp32: the same products by FMA on the
//     CUDA cores (TF32 would not hold the JAX tests' 1e-4);
//   * the softmax a warp per row, lanes on consecutive keys; bf16(p) is
//     written over the first half of its own fp32 row;
//   * o = P V, V staged in chunks of 64 keys like K, the sums in fp32
//     fragments, rounded once and stored 16 bytes a lane.
// q, k, v and o take any strides but the last (which is 1): the module's
// q, k, v are views of its fused q|k|v product, and its output a view of a
// [B, T, H, D] buffer, so no copy is made around the kernel.  This first
// version leaves wgmma, TMA and online softmax (one pass over K and V) to
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libattention.so attention.cu   (ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = WARPS * 16;   // query rows a CTA
constexpr int KC = 64;             // keys a staged chunk of K or V
constexpr int T_MAX = 256, D_MAX = 128;
constexpr int SMEM_MAX = 232448;   // shared memory a block can have on sm_90

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Element strides of one tensor's batch, head and position dims.
struct Strides {
  long long b, h, t;
};

__host__ __device__ inline int pad16(int t) { return (t + 15) / 16 * 16; }
// fp32 score rows: a multiple of 4 floats, so the bf16 P rows written over
// them (2 * lds elements apart) are a multiple of 8, as WMMA needs
__host__ __device__ inline int score_ld(int t) { return pad16(t) + 4; }

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

// rows r0 .. r0+rows-1 of a [T, D] bf16 matrix (rows ld apart) -> dst
// [rows][D + 8], zero past T; 16 bytes a thread.
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, long long ld, int r0,
                                           int rows, int T) {
  constexpr int V = D / 8, LDC = D + 8;
  for (int i = threadIdx.x; i < rows * V; i += blockDim.x) {
    const int r = i / V, c = (i % V) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r0 + r < T) u = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * LDC + c) = u;
  }
}

// The same for fp32 into dst [rows][D + 1] (odd rows: a lane per row reads
// without bank conflicts).
__device__ __forceinline__ void stage_f32(float* dst, const float* src, long long ld, int r0,
                                          int rows, int T, int D) {
  const int ldc = D + 1;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[r * ldc + c] = r0 + r < T ? src[(r0 + r) * ld + c] : 0.f;
  }
}

// The warp's 16 score rows (lds floats apart): s = s * scale, then
// exp(s - max) / sum over the T keys, in place in fp32.
__device__ __forceinline__ void softmax_rows(float* s, int lds, int T, float scale) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    float* row = s + r * lds;
    float m = __int_as_float(0xff800000);  // -inf
    for (int c = lane; c < T; c += 32) {
      const float x = row[c] * scale;
      row[c] = x;
      m = fmaxf(m, x);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < T; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < T; c += 32) row[c] = row[c] / sum;
  }
  __syncwarp();
}

// bf16: one (pair, 64 query rows) a CTA.
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, Strides sq, Strides sk,
                      Strides sv, Strides so, int H, int T, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDC = D + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x, b = pair / H, h = pair % H;
  const int r0 = blockIdx.y * ROWS;
  const int tp = pad16(T), lds = score_ld(T);
  float* s = reinterpret_cast<float*>(smem) + warp * 16 * lds;   // this warp's rows
  bf16* p = reinterpret_cast<bf16*>(s);                          // bf16(P), 2 * lds apart
  bf16* chunk = reinterpret_cast<bf16*>(smem + (size_t)ROWS * lds * 4);
  const bf16* qp = q + b * sq.b + h * sq.h;
  const bf16* kp = k + b * sk.b + h * sk.h;
  const bf16* vp = v + b * sv.b + h * sv.h;
  bf16* op = o + b * so.b + h * so.h;

  // the warp's Q rows as A fragments
  stage_bf16<D>(chunk, qp, sq.t, r0, ROWS, T);
  __syncthreads();
  FragA qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], chunk + warp * 16 * LDC + kk * 16, LDC);

  // S = Q K^T, KC keys at a time
  for (int c0 = 0; c0 < tp; c0 += KC) {
    __syncthreads();  // every warp is done with the chunk
    stage_bf16<D>(chunk, kp, sk.t, c0, KC, T);
    __syncthreads();
    const int nj = (tp - c0 < KC ? tp - c0 : KC) / 16;
    for (int j = 0; j < nj; ++j) {
      FragC c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragBT kb;  // K^T tile: element (d, key) at K[key][d]
        wmma::load_matrix_sync(kb, chunk + j * 16 * LDC + kk * 16, LDC);
        wmma::mma_sync(c, qa[kk], kb, c);
      }
      wmma::store_matrix_sync(s + c0 + j * 16, c, lds, wmma::mem_row_major);
    }
  }

  softmax_rows(s, lds, T, scale);
  // bf16(p) over the first half of each fp32 row, zero for the keys past T:
  // a step writes floats c0/2 .. c0/2+15, which the steps before it have read
  for (int r = 0; r < 16; ++r) {
    float* row = s + r * lds;
    for (int c0 = 0; c0 < tp; c0 += 32) {
      const int c = c0 + lane;
      const float x = c < T ? row[c] : 0.f;
      __syncwarp();
      if (c < tp) p[r * 2 * lds + c] = __float2bfloat16(x);
      __syncwarp();
    }
  }

  // o = P V, KC keys at a time
  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int c0 = 0; c0 < tp; c0 += KC) {
    __syncthreads();
    stage_bf16<D>(chunk, vp, sv.t, c0, KC, T);
    __syncthreads();
    const int nk = (tp - c0 < KC ? tp - c0 : KC) / 16;
    for (int kk = 0; kk < nk; ++kk) {
      FragA pa;
      wmma::load_matrix_sync(pa, p + c0 + kk * 16, 2 * lds);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        FragB vb;
        wmma::load_matrix_sync(vb, chunk + kk * 16 * LDC + n * 16, LDC);
        wmma::mma_sync(acc[n], pa, vb, acc[n]);
      }
    }
  }

  // the sums -> bf16, through a 16 x 16 fp32 stage over the warp's own rows
  __syncwarp();
  float* stage = s;
  const int row = lane >> 1, col = (lane & 1) * 8, t = r0 + warp * 16 + row;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(stage, acc[n], 16, wmma::mem_row_major);
    __syncwarp();
    if (t < T) {
      uint4 u;
      __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hv[i] = __floats2bfloat162_rn(stage[row * 16 + col + 2 * i],
                                      stage[row * 16 + col + 2 * i + 1]);
      *reinterpret_cast<uint4*>(op + t * so.t + n * 16 + col) = u;
    }
    __syncwarp();
  }
}

// fp32: one (pair, 64 query rows) a CTA, the products by FMA; a lane takes
// keys lane and lane + 32 of a chunk for the warp's 16 rows, then columns
// lane, lane + 32, .. of the output.
__global__ void __launch_bounds__(WARPS * 32)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, Strides sq, Strides sk,
                     Strides sv, Strides so, int H, int T, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x, b = pair / H, h = pair % H;
  const int r0 = blockIdx.y * ROWS;
  const int lds = score_ld(T), ldc = D + 1;
  float* s = reinterpret_cast<float*>(smem) + warp * 16 * lds;
  float* qs = reinterpret_cast<float*>(smem) + ROWS * lds;
  float* chunk = qs + ROWS * ldc;
  const float* qp = q + b * sq.b + h * sq.h;
  const float* kp = k + b * sk.b + h * sk.h;
  const float* vp = v + b * sv.b + h * sv.h;
  float* op = o + b * so.b + h * so.h;
  const float* qw = qs + warp * 16 * ldc;

  stage_f32(qs, qp, sq.t, r0, ROWS, T, D);
  for (int c0 = 0; c0 < T; c0 += KC) {
    __syncthreads();
    stage_f32(chunk, kp, sk.t, c0, KC, T, D);
    __syncthreads();
    float a0[16], a1[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) a0[r] = a1[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float k0 = chunk[lane * ldc + d], k1 = chunk[(lane + 32) * ldc + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float x = qw[r * ldc + d];
        a0[r] = fmaf(x, k0, a0[r]);
        a1[r] = fmaf(x, k1, a1[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (c0 + lane < T) s[r * lds + c0 + lane] = a0[r];
      if (c0 + lane + 32 < T) s[r * lds + c0 + lane + 32] = a1[r];
    }
  }

  softmax_rows(s, lds, T, scale);

  constexpr int NC = D_MAX / 32;
  float acc[16][NC];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  for (int c0 = 0; c0 < T; c0 += KC) {
    __syncthreads();
    stage_f32(chunk, vp, sv.t, c0, KC, T, D);
    __syncthreads();
    const int nk = T - c0 < KC ? T - c0 : KC;
    for (int key = 0; key < nk; ++key) {
      float vv[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? chunk[key * ldc + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float pr = s[r * lds + c0 + key];
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = fmaf(pr, vv[i], acc[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int t = r0 + warp * 16 + r;
    if (t >= T) break;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int d = lane + 32 * i;
      if (d < D) op[t * so.t + d] = acc[r][i];
    }
  }
}

size_t smem_bytes(int dtype, int T, int D) {
  const size_t scores = (size_t)ROWS * score_ld(T) * 4;
  return dtype == 0 ? scores + (size_t)KC * (D + 8) * 2
                    : scores + (size_t)(ROWS + KC) * (D + 1) * 4;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, const Strides* st,
                        int pairs, int H, int T, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(0, T, D);
  cudaError_t err = cudaFuncSetAttribute(attention_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(pairs, (T + ROWS - 1) / ROWS);
  attention_bf16_kernel<D><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), st[0], st[1], st[2], st[3], H, T, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o = softmax(q k^T * scale) v over B x H pairs, on `stream`.  dtype 0:
// bf16, 1: fp32.  strides: 12 element strides, the (batch, head, position)
// strides of q, k, v and o in that order; the last dim of each is
// contiguous (ops/attention.py::check_shape and _kernel_ready hold the
// limits below and the 16-byte alignment).  Returns the CUDA error of the
// launch (0 = launched), or cudaErrorInvalidValue for a shape or type the
// kernel does not take.
int attention_forward(int dtype, const void* q, const void* k, const void* v, void* o,
                      const long long* strides, int B, int H, int T, int D, float scale,
                      cudaStream_t stream) {
  if (B < 0 || H <= 0 || T < 1 || T > T_MAX || D < 16 || D > D_MAX || D % 16 ||
      (dtype != 0 && dtype != 1) || smem_bytes(dtype, T, D) > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int pairs = B * H;
  if (pairs == 0) return 0;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (dtype == 1) {
    const size_t smem = smem_bytes(1, T, D);
    cudaError_t err = cudaFuncSetAttribute(attention_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(pairs, (T + ROWS - 1) / ROWS);
    attention_f32_kernel<<<grid, WARPS * 32, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1], st[2], st[3], H, T,
        D, scale);
    return (int)cudaGetLastError();
  }
  switch (D) {
    case 16: return (int)launch_bf16<16>(q, k, v, o, st, pairs, H, T, scale, stream);
    case 32: return (int)launch_bf16<32>(q, k, v, o, st, pairs, H, T, scale, stream);
    case 48: return (int)launch_bf16<48>(q, k, v, o, st, pairs, H, T, scale, stream);
    case 64: return (int)launch_bf16<64>(q, k, v, o, st, pairs, H, T, scale, stream);
    case 80: return (int)launch_bf16<80>(q, k, v, o, st, pairs, H, T, scale, stream);
    case 96: return (int)launch_bf16<96>(q, k, v, o, st, pairs, H, T, scale, stream);
    case 112: return (int)launch_bf16<112>(q, k, v, o, st, pairs, H, T, scale, stream);
    default: return (int)launch_bf16<128>(q, k, v, o, st, pairs, H, T, scale, stream);
  }
}

const char* attention_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
