// Non-causal softmax attention for Hopper (sm_90a): q, k, v [B, H, T, D] ->
// o [B, H, T, D], bf16, fp16 or fp32, any T >= 1; bf16 and fp16 take D a
// multiple of 16 up to 128 (ops/attention.py pads a narrower head with zero
// columns), fp32 any D from 1 to 128.
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
// At D=128 the products weigh four times as much and the two meet.
//
// bf16: attn::launch_fwd (csrc/attn_tile.cuh, shared with the training
// kernels): one CTA a pair at a time, K and V staged once by cp.async, the
// scores kept in mma.sync accumulators (for T <= 256 a row's all at once,
// one pass; past it two passes, row statistics then the normalised p), p
// rounded to bf16 as the A operand of P V, O leaving 16 bytes a lane.
// Where the TPU kernel holds a whole 256 x 256 fp32 score tile in VMEM
// (more than a Hopper block's 227 KB), no score here leaves the registers.
// fp16 runs the same kernel with the fp16 mma.sync and p and o rounded to
// fp16, as the JAX kernel rounds to the dtype it is given.
//
// fp32: FMA on the CUDA cores (TF32 would not hold the JAX tests' 1e-4), the
// same two passes over the keys: one CTA a (pair, 32 query rows), 8 rows a
// warp, K and V staged 32 keys at a time; pass 1 keeps each row's running
// max and sum, pass 2 adds exp(s - m) / l times V.  No speed target.
//
// q, k, v and o take any strides but the last (which is 1): the module's
// q, k, v are views of its fused q|k|v product, and its output a view of a
// [B, T, H, D] buffer, so no copy is made around the kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libattention.so attention.cu   (ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"

using attn::bf16;
using attn::Strides;

namespace {

constexpr int D_MAX = 128;
constexpr int F_ROWS = 32;        // fp32: query rows a CTA, 8 a warp
constexpr int F_KEYS = 32;        // fp32: keys a staged chunk

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

// rows r0 .. r0+rows-1 of a [T, D] fp32 matrix (rows ld apart) -> dst
// [rows][D + 1] (odd rows: a lane per row reads without bank conflicts),
// zero past T.
__device__ __forceinline__ void stage_f32(float* dst, const float* src, long long ld, int r0,
                                          int rows, int T, int D) {
  const int ldc = D + 1;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    dst[r * ldc + c] = r0 + r < T ? src[(r0 + r) * ld + c] : 0.f;
  }
}

// The warp's 8 rows (qw, [8][D + 1]) times key `lane` of the chunk (kc), scaled.
__device__ __forceinline__ void dots(float x[8], const float* qw, const float* kc, int D,
                                     float scale) {
  const int ldc = D + 1, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 8; ++r) x[r] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float kd = kc[lane * ldc + d];
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = fmaf(qw[r * ldc + d], kd, x[r]);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) x[r] *= scale;
}

__global__ void __launch_bounds__(128)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, Strides sq, Strides sk,
                     Strides sv, Strides so, int H, int T, int D, float scale) {
  extern __shared__ __align__(128) float fs[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x, b = pair / H, h = pair % H;
  const int r0 = blockIdx.y * F_ROWS;
  const int ldc = D + 1;
  float* qs = fs;
  float* ks = qs + F_ROWS * ldc;
  float* vs = ks + F_KEYS * ldc;
  const float* qp = q + b * sq.b + h * sq.h;
  const float* kp = k + b * sk.b + h * sk.h;
  const float* vp = v + b * sv.b + h * sv.h;
  float* op = o + b * so.b + h * so.h;
  const float* qw = qs + warp * 8 * ldc;
  const float NEG_INF = __int_as_float(0xff800000);

  stage_f32(qs, qp, sq.t, r0, F_ROWS, T, D);
  // pass 1: each row's running max and sum over the keys
  float m[8], l[8], x[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  for (int c0 = 0; c0 < T; c0 += F_KEYS) {
    __syncthreads();
    stage_f32(ks, kp, sk.t, c0, F_KEYS, T, D);
    __syncthreads();
    dots(x, qw, ks, D, scale);
    const bool valid = c0 + lane < T;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float mn = fmaxf(m[r], warp_max(valid ? x[r] : NEG_INF));
      l[r] = l[r] * expf(m[r] - mn) + warp_sum(valid ? expf(x[r] - mn) : 0.f);
      m[r] = mn;
    }
  }

  // pass 2: o += (exp(s - m) / l) v, a lane on columns lane, lane + 32, ..
  constexpr int NC = D_MAX / 32;
  float acc[8][NC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  for (int c0 = 0; c0 < T; c0 += F_KEYS) {
    __syncthreads();
    stage_f32(ks, kp, sk.t, c0, F_KEYS, T, D);
    stage_f32(vs, vp, sv.t, c0, F_KEYS, T, D);
    __syncthreads();
    dots(x, qw, ks, D, scale);
    const bool valid = c0 + lane < T;
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = valid ? expf(x[r] - m[r]) / l[r] : 0.f;
    const int nk = T - c0 < F_KEYS ? T - c0 : F_KEYS;
    for (int key = 0; key < nk; ++key) {
      float vv[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? vs[key * ldc + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float pr = __shfl_sync(0xffffffffu, x[r], key);
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = fmaf(pr, vv[i], acc[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = r0 + warp * 8 + r;
    if (t >= T) break;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int d = lane + 32 * i;
      if (d < D) op[t * so.t + d] = acc[r][i];
    }
  }
}

size_t f32_smem(int D) { return (size_t)(F_ROWS + 2 * F_KEYS) * (D + 1) * sizeof(float); }

// The tensor-core kernel for bf16 (T = bf16) or fp16 (T = __half); the
// tiles move as 16-bit words, so the pointers pass typed bf16.
template <int D, typename T>
cudaError_t launch_tile(const void* q, const void* k, const void* v, void* o, const Strides* st,
                        int pairs, int H, int T_, float scale, cudaStream_t stream) {
  return attn::launch_fwd<D, T>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v), static_cast<bf16*>(o), st[0], st[1],
                                st[2], st[3], pairs, H, T_, scale, nullptr, nullptr, stream);
}

template <typename T>
cudaError_t launch_tile_d(const void* q, const void* k, const void* v, void* o, const Strides* st,
                          int pairs, int H, int T_, int D, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_tile<16, T>(q, k, v, o, st, pairs, H, T_, scale, stream);
    case 32: return launch_tile<32, T>(q, k, v, o, st, pairs, H, T_, scale, stream);
    case 48: return launch_tile<48, T>(q, k, v, o, st, pairs, H, T_, scale, stream);
    case 64: return launch_tile<64, T>(q, k, v, o, st, pairs, H, T_, scale, stream);
    case 80: return launch_tile<80, T>(q, k, v, o, st, pairs, H, T_, scale, stream);
    case 96: return launch_tile<96, T>(q, k, v, o, st, pairs, H, T_, scale, stream);
    case 112: return launch_tile<112, T>(q, k, v, o, st, pairs, H, T_, scale, stream);
    default: return launch_tile<128, T>(q, k, v, o, st, pairs, H, T_, scale, stream);
  }
}

}  // namespace

extern "C" {

// o = softmax(q k^T * scale) v over B x H pairs, on `stream`.  dtype 0:
// bf16, 1: fp32, 2: fp16.  strides: 12 element strides, the (batch, head, position)
// strides of q, k, v and o in that order; the last dim of each is
// contiguous (ops/attention.py::check_shape and _kernel_ready hold the
// limits below and, for bf16, the 16-byte alignment).  Returns the CUDA
// error of the launch (0 = launched), or cudaErrorInvalidValue for a shape
// or type the kernel does not take.
int attention_forward(int dtype, const void* q, const void* k, const void* v, void* o,
                      const long long* strides, int B, int H, int T, int D, float scale,
                      cudaStream_t stream) {
  if (B < 0 || H <= 0 || T < 1 || D < 1 || D > D_MAX || dtype < 0 || dtype > 2 ||
      (dtype != 1 && D % 16))
    return (int)cudaErrorInvalidValue;
  const int pairs = B * H;
  if (pairs == 0) return 0;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (dtype == 1) {
    const size_t smem = f32_smem(D);
    cudaError_t err = cudaFuncSetAttribute(attention_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(pairs, (T + F_ROWS - 1) / F_ROWS);
    attention_f32_kernel<<<grid, 128, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1], st[2], st[3], H, T,
        D, scale);
    return (int)cudaGetLastError();
  }
  if (dtype == 2) return (int)launch_tile_d<__half>(q, k, v, o, st, pairs, H, T, D, scale, stream);
  return (int)launch_tile_d<bf16>(q, k, v, o, st, pairs, H, T, D, scale, stream);
}

const char* attention_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
