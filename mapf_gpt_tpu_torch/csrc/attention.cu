// Non-causal softmax attention for Hopper (sm_90a): q, k, v [B, H, T, D] ->
// o [B, H, T, D], bf16, fp16 or fp32, any T >= 1.  Head dims: fp32 and fp16
// any from 1 to 842, bf16 from 1 to 672 (ops/attention.py pads a bf16 or
// fp16 head to the width its kernel takes: a multiple of 16 up to 128, the
// slabs' width past it).
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
// 4 n T D * 2 = 2.7 GB of q, k, v read and o written -> 0.80 ms at 3.35
// TB/s, against 4 n T^2 D = 344 GFLOP of bf16 products -> 0.35 ms and n T^2
// = 2.7 G exp2s on the special-function units (16 a clock an SM) -> about
// 0.64 ms: bound by bytes, the exp2s close behind.  At D=128 the products
// weigh four times as much and meet the bytes.
//
// Routes, chosen by shape in attention_route:
//   * bf16 and fp16, T <= 256, D in {16, 32, 48, 64} (the models' heads):
//     csrc/attn_wgmma.cuh, a persistent kernel with a TMA producer warp
//     feeding an mbarrier ring and two wgmma consumer warpgroups, the
//     scores in registers, P as wgmma's register operand;
//   * bf16 and fp16, D up to 128 otherwise (D = 80..128, or T > 256):
//     attn::launch_fwd (csrc/attn_tile.cuh, shared with the training
//     kernels): mma.sync tiles, one pass for T <= 256, two past it.  D =
//     80..128 stays there because the wgmma tile's pair-sized stages
//     would not make a ring: 3 x 256 x 2 D bytes is 120 KB at D = 80, so
//     one stage fits a block, and rows past 128 bytes need two TMA boxes
//     (its registers would mostly hold them: tools/attn_probe.py --regs);
//   * bf16, D past 128: attn::launch_fwd_wide, the training forward's slab
//     kernel, one CTA a (pair, slab of at most 128 columns);
//   * fp32 (any D), and fp16 past D = 128 (the slab kernel is bf16 only):
//     FMA on the CUDA cores (TF32 would not hold the JAX tests' 1e-4),
//     two passes over the keys: one CTA a (pair, 32 query rows, 128 output
//     columns), 8 rows a warp, K and V staged 32 keys at a time; pass 1
//     keeps each row's running max and sum, pass 2 adds p v with p =
//     exp(s - m) / l rounded to the element type.  No speed target.
//
// q, k, v and o take any strides but the last (which is 1): the module's
// q, k, v are views of its fused q|k|v product, and its output a view of a
// [B, T, H, D] buffer, so no copy is made around the kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libattention.so attention.cu   (ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "attn_wgmma.cuh"

using attn::bf16;
using attn::Strides;

namespace {

constexpr int D_TILE = 128;       // widest head of the register tiles
constexpr int F_ROWS = 32;        // FMA kernel: query rows a CTA, 8 a warp
constexpr int F_KEYS = 32;        // FMA kernel: keys a staged chunk
constexpr int F_COLS = 128;       // FMA kernel: output columns a CTA
constexpr size_t SMEM_MAX = 232448;
enum Route { ROUTE_WGMMA = 0, ROUTE_TILE = 1, ROUTE_WIDE = 2, ROUTE_FMA = 3 };

// The FMA kernel's element types: loads to fp32, p rounded to the type, o stored in it.
template <typename T>
struct Fma;
template <>
struct Fma<float> {
  static __device__ __forceinline__ float ld(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float st(float x) { return x; }
};
template <>
struct Fma<__half> {
  static __device__ __forceinline__ float ld(__half x) { return __half2float(x); }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
  static __device__ __forceinline__ __half st(float x) { return __float2half_rn(x); }
};

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

// rows r0 .. r0+rows-1, columns c0 .. c0+cols-1 of a [T, *] matrix (rows ld
// apart) -> fp32 dst [rows][cols + 1] (odd rows: a lane per row reads
// without bank conflicts), zero past T.
template <typename T>
__device__ __forceinline__ void stage_f32(float* dst, const T* src, long long ld, int r0,
                                          int rows, int T_, int c0, int cols) {
  const int ldc = cols + 1;
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i % cols;
    dst[r * ldc + c] = r0 + r < T_ ? Fma<T>::ld(src[(r0 + r) * ld + c0 + c]) : 0.f;
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

// One CTA a (pair, 32 query rows, 128 output columns): the scores over all
// D columns, p v for the CTA's columns of V.
template <typename T>
__global__ void __launch_bounds__(128)
attention_fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int H,
                     int T_, int D, float scale) {
  extern __shared__ __align__(128) float fs[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x, b = pair / H, h = pair % H;
  const int r0 = blockIdx.y * F_ROWS, c0 = blockIdx.z * F_COLS;
  const int dv = D - c0 < F_COLS ? D - c0 : F_COLS;
  const int ldc = D + 1;
  float* qs = fs;
  float* ks = qs + F_ROWS * ldc;
  float* vs = ks + F_KEYS * ldc;
  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;
  T* op = o + b * so.b + h * so.h;
  const float* qw = qs + warp * 8 * ldc;
  const float NEG_INF = __int_as_float(0xff800000);

  stage_f32(qs, qp, sq.t, r0, F_ROWS, T_, 0, D);
  // pass 1: each row's running max and sum over the keys
  float m[8], l[8], x[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  for (int k0 = 0; k0 < T_; k0 += F_KEYS) {
    __syncthreads();
    stage_f32(ks, kp, sk.t, k0, F_KEYS, T_, 0, D);
    __syncthreads();
    dots(x, qw, ks, D, scale);
    const bool valid = k0 + lane < T_;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float mn = fmaxf(m[r], warp_max(valid ? x[r] : NEG_INF));
      l[r] = l[r] * expf(m[r] - mn) + warp_sum(valid ? expf(x[r] - mn) : 0.f);
      m[r] = mn;
    }
  }

  // pass 2: o += p v, p = T(exp(s - m) / l), a lane on columns c0 + lane, + 32, ..
  constexpr int NC = F_COLS / 32;
  float acc[8][NC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  for (int k0 = 0; k0 < T_; k0 += F_KEYS) {
    __syncthreads();
    stage_f32(ks, kp, sk.t, k0, F_KEYS, T_, 0, D);
    stage_f32(vs, vp, sv.t, k0, F_KEYS, T_, c0, dv);
    __syncthreads();
    dots(x, qw, ks, D, scale);
    const bool valid = k0 + lane < T_;
#pragma unroll
    for (int r = 0; r < 8; ++r) x[r] = valid ? Fma<T>::round(expf(x[r] - m[r]) / l[r]) : 0.f;
    const int nk = T_ - k0 < F_KEYS ? T_ - k0 : F_KEYS;
    for (int key = 0; key < nk; ++key) {
      float vv[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < dv ? vs[key * (dv + 1) + d] : 0.f;
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
    if (t >= T_) break;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int d = lane + 32 * i;
      if (d < dv) op[t * so.t + c0 + d] = Fma<T>::st(acc[r][i]);
    }
  }
}

size_t fma_smem(int D) {
  const int dv = D < F_COLS ? D : F_COLS;
  return ((size_t)(F_ROWS + F_KEYS) * (D + 1) + (size_t)F_KEYS * (dv + 1)) * sizeof(float);
}

template <typename T>
int launch_fma(const void* q, const void* k, const void* v, void* o, const Strides* st, int pairs,
               int H, int T_, int D, float scale, cudaStream_t stream) {
  const size_t smem = fma_smem(D);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_fma_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(pairs, (T_ + F_ROWS - 1) / F_ROWS, (D + F_COLS - 1) / F_COLS);
  attention_fma_kernel<T><<<grid, 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st[0], st[1], st[2], st[3], H, T_, D, scale);
  return (int)cudaGetLastError();
}

// The mma.sync tile kernel for bf16 (T = bf16) or fp16 (T = __half); the
// tiles move as 16-bit words, so the pointers pass typed bf16.
template <int D, typename T>
int launch_tile(const void* q, const void* k, const void* v, void* o, const Strides* st,
                int pairs, int H, int T_, float scale, cudaStream_t stream) {
  return (int)attn::launch_fwd<D, T>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                     static_cast<const bf16*>(v), static_cast<bf16*>(o), st[0],
                                     st[1], st[2], st[3], pairs, H, T_, scale, nullptr, nullptr,
                                     stream);
}

template <typename T>
int launch_tile_d(const void* q, const void* k, const void* v, void* o, const Strides* st,
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

// The wgmma kernel (csrc/attn_wgmma.cuh) for bf16 or fp16.
template <typename T>
int launch_wgmma_d(const void* q, const void* k, const void* v, void* o, const Strides* st,
                   int B, int H, int T_, int D, float scale, cudaStream_t stream) {
  switch (D) {
#define WGMMA(D_) return aw::attention<D_, T>(q, k, v, o, st, B, H, T_, scale, stream);
    case 16: WGMMA(16)
    case 32: WGMMA(32)
    case 48: WGMMA(48)
    default: WGMMA(64)
#undef WGMMA
  }
}

// bf16 heads past 128 columns: D = NS DV, NS = ceil(D / 128) slabs of DV (a
// multiple of 16, 80 to 128) columns, one CTA a (pair, slab).
int launch_wide(const void* q, const void* k, const void* v, void* o, const Strides* st,
                int pairs, int H, int T_, int D, float scale, cudaStream_t stream) {
  const int ns = (D + D_TILE - 1) / D_TILE, dv = D / ns;
  if (D % ns || dv % 16) return (int)cudaErrorInvalidValue;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  switch (dv) {
#define WIDE(DV)                                                                          \
  case DV:                                                                                \
    return (int)attn::launch_fwd_wide<DV>(qb, kb, vb, ob, st[0], st[1], st[2], st[3], pairs, \
                                          H, T_, D, scale, nullptr, nullptr, stream);
    WIDE(80)
    WIDE(96)
    WIDE(112)
    WIDE(128)
#undef WIDE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The kernel attention_forward runs for this dtype (0 bf16, 1 fp32, 2
// fp16), T and (padded) head dim: 0 the wgmma kernel, 1 the mma.sync
// tiles, 2 the bf16 slabs, 3 FMA; -1 for a shape no kernel takes.
int attention_route(int dtype, int T, int D) {
  if (T < 1 || D < 1 || dtype < 0 || dtype > 2) return -1;
  if (dtype == 1 || (dtype == 2 && D > D_TILE)) return fma_smem(D) <= SMEM_MAX ? ROUTE_FMA : -1;
  if (D % 16) return -1;
  if (D > D_TILE) {
    const int ns = (D + D_TILE - 1) / D_TILE;
    return D % ns == 0 && (D / ns) % 16 == 0 && attn::wide_window(T, D, D / ns) > 0 ? ROUTE_WIDE
                                                                                     : -1;
  }
  return T <= aw::T_MAX && aw::takes(D) ? ROUTE_WGMMA : ROUTE_TILE;
}

// o = softmax(q k^T * scale) v over B x H pairs, on `stream`.  dtype 0:
// bf16, 1: fp32, 2: fp16.  strides: 12 element strides, the (batch, head,
// position) strides of q, k, v and o in that order; the last dim of each is
// contiguous (ops/attention.py::check_shape and _kernel_ready hold the
// limits of attention_route and, for the 16-bit types, the 16-byte
// alignment TMA and the tiles want).  Returns 0 (launched), a CUDA error of
// the launch, an aw::ERR_* code (attention_error_string names each), or
// cudaErrorInvalidValue for a shape or type no kernel takes.
int attention_forward(int dtype, const void* q, const void* k, const void* v, void* o,
                      const long long* strides, int B, int H, int T, int D, float scale,
                      cudaStream_t stream) {
  const int route = attention_route(dtype, T, D);
  if (B < 0 || H <= 0 || route < 0) return (int)cudaErrorInvalidValue;
  const int pairs = B * H;
  if (pairs == 0) return 0;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  switch (route) {
    case ROUTE_FMA:
      return dtype == 1 ? launch_fma<float>(q, k, v, o, st, pairs, H, T, D, scale, stream)
                        : launch_fma<__half>(q, k, v, o, st, pairs, H, T, D, scale, stream);
    case ROUTE_WIDE: return launch_wide(q, k, v, o, st, pairs, H, T, D, scale, stream);
    case ROUTE_WGMMA:
      return dtype == 2 ? launch_wgmma_d<__half>(q, k, v, o, st, B, H, T, D, scale, stream)
                        : launch_wgmma_d<bf16>(q, k, v, o, st, B, H, T, D, scale, stream);
    default:
      return dtype == 2 ? launch_tile_d<__half>(q, k, v, o, st, pairs, H, T, D, scale, stream)
                        : launch_tile_d<bf16>(q, k, v, o, st, pairs, H, T, D, scale, stream);
  }
}

const char* attention_error_string(int code) {
  if (code == aw::ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found in the driver (the wgmma route's TMA)";
  if (code == aw::ERR_TENSOR_MAP)
    return "the driver refused a tensor map of q, k or v (TMA wants 16-byte aligned rows and "
           "strides below 2^40 bytes)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
