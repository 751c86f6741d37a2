// Attention tiles for Hopper (sm_90a), shared by csrc/attention.cu (the
// counterpart of mapf_gpt_tpu/ops/attention.py::_attn_kernel) and
// csrc/fused_train.cu (the attention of _fwd_kernel and _bwd_kernel):
//
//   * the PTX building blocks: cp.async (16 bytes a lane, device memory to
//     shared memory without registers), ldmatrix (a warp's 8x8 bf16 tiles
//     from shared memory straight into mma fragments, transposed or not) and
//     mma.sync.m16n8k16 bf16 -> fp32, whose register layout is documented
//     (PTX ISA, "Matrix fragments for mma.m16n8k16"), so the softmax runs on
//     the accumulators and P goes back in as the A operand with no trip
//     through shared memory;
//   * the forward, launch_fwd<D>: non-causal softmax attention over (batch,
//     head) pairs, the scores kept in registers, with the JAX kernel's
//     rounding:
//       s = (q k^T) * scale                                   (fp32)
//       p = bf16(exp(s - max s) / sum exp(s - max s))         (normalised, then rounded)
//       o = bf16(p v)                                         (fp32 accumulation)
//     and, when asked, each row's statistics for the training backward:
//       m = max_j s_j * scale' and l = sum_j 2^(s_j * scale' - m), scale' =
//       scale * log2(e), so that p_j = 2^(s_j * scale' - m) / l.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, c = lane % 4):
//   A 16x16 (row):  a0 (g, 2c..2c+1), a1 (g+8, 2c..), a2 (g, 2c+8..), a3 (g+8, 2c+8..)
//   B 16x8  (col):  b0 (k 2c..2c+1, n g), b1 (k 2c+8.., n g)
//   C 16x8  (fp32): c0, c1 (g, 2c..2c+1), c2, c3 (g+8, 2c..2c+1)
// So the C tiles of 16 keys (two n8 tiles) are, pairwise rounded to bf16,
// the A fragment of those 16 keys for P V.
//
// Design of the forward (bound by bytes at the head dims of the repo's
// models, 4 n T^2 D FLOP against 8 n T D bytes; in practice by the exp2s on
// the special-function units and the products' issue):
//   * a CTA of 4 warps takes a (batch, head) pair and walks its query tiles
//     of 64 rows, 16 a warp, so K and V come from device memory once per
//     pair, staged whole in shared memory by cp.async (rows padded to D + 8
//     so that ldmatrix is free of bank conflicts);
//   * T <= 256 (every model of the repo), attn_fwd_resident: a warp holds
//     its 16 rows' scores for all keys in registers (128 fp32 a lane), so
//     one pass does S, the row max and sum, p normalised and rounded to
//     bf16 as the A operand, and P V: one exp2 a score;
//   * any T, attn_fwd_stream: two passes over the keys, 64 at a time (pass 1
//     the rows' running max and sum, pass 2 S again, p and P V), K and V in
//     windows of the shared memory's size, reloaded in turn past it;
//   * Q is read 16 bytes a lane into the warp's own stage, then ldmatrix'ed
//     into A fragments; O goes back through the same stage and leaves 16
//     bytes a lane, coalesced.
// q, k, v and o take any (batch, head, position) strides with a contiguous
// last dim and rows 16-byte aligned; D is a multiple of 16 up to 128 (the
// callers pad a narrower head with zero columns).  The element type is bf16
// or, for csrc/attention.cu, fp16 (the template T of the products and of the
// roundings of p and o; the tiles are copied as 16-bit words either way, so
// the pointers stay typed bf16).
//
// Heads wider than 128 columns (attn_fwd_wide, the training kernels'): the
// head is padded to DT = NS x DV columns, NS slabs of DV <= 128, and one CTA
// runs one slab of the output: the scores over all DT columns, with the A
// fragments read from the warp's rows in shared memory as they are needed
// (scores_w), then P V for the slab's DV columns of V.  Every slab computes
// the same scores in the same order, so p and the rows' statistics are the
// same in each; slab 0 writes the statistics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 4;                 // warps a CTA, 16 query (or key) rows each
constexpr int TILE = WARPS * 16;         // rows a CTA tile
constexpr int KC = 64;                   // keys a chunk of the forward's passes
constexpr int RES_CH = 4;                // chunks a row holds in registers (T <= 256)
constexpr size_t KV_BUDGET = 144 * 1024; // shared memory for a window of K and V
constexpr float LOG2E = 1.4426950408889634f;

// Element strides of one tensor's batch (or context), head and position dims.
struct Strides {
  long long b, h, t;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b for one 16x8 tile (bf16 operands, fp32 accumulators).
__device__ __forceinline__ void mma(float c[4], const unsigned a[4], unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The products and the roundings of an element type: bf16 (above) or fp16.
template <typename T>
struct Elem;
template <>
struct Elem<bf16> {
  static __device__ __forceinline__ void mma(float c[4], const unsigned a[4], unsigned b0,
                                             unsigned b1) {
    attn::mma(c, a, b0, b1);
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) { return pack_bf16(lo, hi); }
};
template <>
struct Elem<__half> {
  static __device__ __forceinline__ void mma(float c[4], const unsigned a[4], unsigned b0,
                                             unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<unsigned*>(&v);
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragment of a 16x16 tile at `base` of a row-major bf16 tile (rows ld apart).
__device__ __forceinline__ void frag_a(unsigned a[4], const bf16* base, int ld) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, base + (l & 15) * ld + (l >> 4) * 8);
}

// B fragments of two n8 tiles (b[0..1]: n0..n0+7, b[2..3]: n0+8..n0+15) at
// depth k0..k0+15, from a tile stored [n][k] (rows ld apart; base at (n0, k0)):
// K for S = Q K^T, V for dP = dA V^T, Q or dA for the key side's transposes.
__device__ __forceinline__ void frag_b_nk(unsigned b[4], const bf16* base, int ld) {
  const int l = threadIdx.x & 31, i = l >> 3;
  ldsm_x4(b, base + ((i >> 1) * 8 + (l & 7)) * ld + (i & 1) * 8);
}

// The same from a tile stored [k][n] (base at (k0, n0)), transposed by
// ldmatrix: V for P V, K for dQ = dS K, Q and dA for dK and dV.
__device__ __forceinline__ void frag_b_kn(unsigned b[4], const bf16* base, int ld) {
  const int l = threadIdx.x & 31, i = l >> 3;
  ldsm_x4_t(b, base + ((i & 1) * 8 + (l & 7)) * ld + (i >> 1) * 8);
}

// The A fragment of 16 keys from the C tiles c[j], c[j + 1], rounded to T.
template <typename T = bf16>
__device__ __forceinline__ void c_to_a(unsigned a[4], const float c0[4], const float c1[4]) {
  a[0] = Elem<T>::pack(c0[0], c0[1]);
  a[1] = Elem<T>::pack(c0[2], c0[3]);
  a[2] = Elem<T>::pack(c1[0], c1[1]);
  a[3] = Elem<T>::pack(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows r0 .. r0+rows-1 of a [T, D] bf16 matrix (rows ld apart) -> dst
// [rows][D + 8] by cp.async, zero past T; the threads of the CTA (or of a
// warp, with `first`/`step` its lane and 32) in turn, 16 bytes each.
template <int D>
__device__ __forceinline__ void stage_rows_async(bf16* dst, const bf16* src, long long ld, int r0,
                                                 int rows, int T, int first, int step) {
  constexpr int V = D / 8, LD = D + 8;
  for (int i = first; i < rows * V; i += step) {
    const int r = i / V, c = (i % V) * 8;
    bf16* d = dst + r * LD + c;
    if (r0 + r < T)
      cp_async16(d, src + (r0 + r) * ld + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// The same for a width known at run time (a multiple of 8; rows width + 8 apart).
__device__ __forceinline__ void stage_rows_async_w(bf16* dst, const bf16* src, long long ld,
                                                   int r0, int rows, int T, int width, int first,
                                                   int step) {
  const int V = width / 8, LD = width + 8;
  for (int i = first; i < rows * V; i += step) {
    const int r = i / V, c = (i % V) * 8;
    bf16* d = dst + r * LD + c;
    if (r0 + r < T)
      cp_async16(d, src + (r0 + r) * ld + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// The same with plain 16-byte loads, by one warp (no cp.async group).
__device__ __forceinline__ void stage_rows_warp_w(bf16* dst, const bf16* src, long long ld, int r0,
                                                  int rows, int T, int width) {
  const int V = width / 8, LD = width + 8;
  for (int i = threadIdx.x & 31; i < rows * V; i += 32) {
    const int r = i / V, c = (i % V) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r0 + r < T) u = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = u;
  }
}

// The same with plain 16-byte loads, by one warp (no cp.async group).
template <int D>
__device__ __forceinline__ void stage_rows_warp(bf16* dst, const bf16* src, long long ld, int r0,
                                                int rows, int T) {
  constexpr int V = D / 8, LD = D + 8;
  for (int i = threadIdx.x & 31; i < rows * V; i += 32) {
    const int r = i / V, c = (i % V) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r0 + r < T) u = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = u;
  }
}

// A warp's 16 x D fp32 accumulators (n8 tiles acc[D / 8]) -> bf16 rows
// r0.. of dst (rows ld apart, those at or past T skipped), through the
// warp's stage [16][D + 8]: 4-byte writes to the stage, then 16 bytes a lane.
template <int D, typename T_ = bf16>
__device__ __forceinline__ void store_rows(const float (*acc)[4], bf16* stage, bf16* dst,
                                           long long ld, int r0, int T) {
  constexpr int LD = D + 8, V = D / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<unsigned*>(stage + g * LD + n * 8 + 2 * c) =
        Elem<T_>::pack(acc[n][0], acc[n][1]);
    *reinterpret_cast<unsigned*>(stage + (g + 8) * LD + n * 8 + 2 * c) =
        Elem<T_>::pack(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * V; i += 32) {
    const int r = i / V, col = (i % V) * 8;
    if (r0 + r < T)
      *reinterpret_cast<uint4*>(dst + (r0 + r) * ld + col) =
          *reinterpret_cast<const uint4*>(stage + r * LD + col);
  }
  __syncwarp();
}

// s[j] (n8 tiles j = 0..2N-1) = the warp's 16 rows (A fragments a[D/16])
// times the 16 N keys of `kb` ([key][d] rows ld apart) transposed.
template <int D, int N, typename T = bf16>
__device__ __forceinline__ void scores(float (*s)[4], const unsigned (*a)[4], const bf16* kb,
                                       int ld) {
#pragma unroll
  for (int j = 0; j < 2 * N; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int np = 0; np < N; ++np)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned b[4];
      frag_b_nk(b, kb + np * 16 * ld + kk * 16, ld);
      Elem<T>::mma(s[2 * np], a[kk], b[0], b[1]);
      Elem<T>::mma(s[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// The same with the warp's A fragments read from its 16 rows at `ab` (rows
// lda apart) as they are needed, for head dims where holding them in
// registers beside the accumulators would spill.
template <int D, int N>
__device__ __forceinline__ void scores_smem_a(float (*s)[4], const bf16* ab, int lda,
                                              const bf16* kb, int ld) {
#pragma unroll
  for (int j = 0; j < 2 * N; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned a[4];
    frag_a(a, ab + kk * 16, lda);
#pragma unroll
    for (int np = 0; np < N; ++np) {
      unsigned b[4];
      frag_b_nk(b, kb + np * 16 * ld + kk * 16, ld);
      mma(s[2 * np], a, b[0], b[1]);
      mma(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The same over a depth known at run time (a multiple of 16), the A
// fragments read from the warp's 16 rows at `ab` (rows lda apart): heads
// wider than the registers hold.
template <int N>
__device__ __forceinline__ void scores_w(float (*s)[4], const bf16* ab, int lda, const bf16* kb,
                                         int ld, int depth) {
#pragma unroll
  for (int j = 0; j < 2 * N; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  for (int kk = 0; kk < depth; kk += 16) {
    unsigned a[4];
    frag_a(a, ab + kk, lda);
#pragma unroll
    for (int np = 0; np < N; ++np) {
      unsigned b[4];
      frag_b_nk(b, kb + np * 16 * ld + kk, ld);
      mma(s[2 * np], a, b[0], b[1]);
      mma(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[D/8] += A (16 x 16 keys) times 16 rows of `vb` ([key][d], rows ld apart).
template <int D, typename T = bf16>
__device__ __forceinline__ void accumulate(float (*acc)[4], const unsigned a[4], const bf16* vb,
                                           int ld) {
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    unsigned b[4];
    frag_b_kn(b, vb + np * 16, ld);
    Elem<T>::mma(acc[2 * np], a, b[0], b[1]);
    Elem<T>::mma(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// One (batch, head) pair's pointers.
struct Pair {
  const bf16 *q, *k, *v;
  bf16* o;
  __device__ Pair(const bf16* q0, const bf16* k0, const bf16* v0, bf16* o0, const Strides& sq,
                  const Strides& sk, const Strides& sv, const Strides& so, int pair, int H) {
    const int b = pair / H, h = pair % H;
    q = q0 + b * sq.b + h * sq.h;
    k = k0 + b * sk.b + h * sk.h;
    v = v0 + b * sv.b + h * sv.h;
    o = o0 + b * so.b + h * so.h;
  }
};

// The warp's 16 query rows r0.. of a pair as A fragments, through its stage.
template <int D>
__device__ __forceinline__ void load_q(unsigned (*qa)[4], bf16* stage, const bf16* qp,
                                       long long ld, int r0, int T) {
  stage_rows_warp<D>(stage, qp, ld, r0, 16, T);
  __syncwarp();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) frag_a(qa[kk], stage + kk * 16, D + 8);
}

__device__ __forceinline__ void store_stats(float* m_out, float* l_out, int pair, int T, int r0,
                                            const float mx[2], const float sm[2]) {
  if (m_out == nullptr || (threadIdx.x & 3)) return;
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (r0 + g + 8 * r < T) {
      m_out[(size_t)pair * T + r0 + g + 8 * r] = mx[r];
      l_out[(size_t)pair * T + r0 + g + 8 * r] = sm[r];
    }
}

// T <= RES_CH * KC: one pass over the keys, the warp's 16 x T scores in
// registers (a lane holds 4 x 8 x 4 of them): S, each row's max and sum, p =
// 2^(s scale' - m) / l rounded to bf16, P V.  One exp2 a score, two
// products.  K and V are copied in two groups, so that the first tile's
// scores start when K has landed.  At D <= 32 the registers are capped so
// that three CTAs share an SM, which fits without spilling and ran faster
// than two; at wider heads the same cap spills.
template <int D, typename T_ = bf16>
__global__ void __launch_bounds__(WARPS * 32, D <= 32 ? 3 : 1)
attn_fwd_resident(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, Strides sq, Strides sk,
                  Strides sv, Strides so, int H, int T, float scale, float* __restrict__ m_out,
                  float* __restrict__ l_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = D + 8, NC = KC / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c4 = lane & 3;
  const int pair = blockIdx.x, W = round_up(T, KC);
  const Pair pp(q, k, v, o, sq, sk, sv, so, pair, H);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)W * LD;
  bf16* stage = vs + (size_t)W * LD + warp * 16 * LD;
  const float c2 = scale * LOG2E;
  const float NEG_INF = __int_as_float(0xff800000);
  stage_rows_async<D>(ks, pp.k, sk.t, 0, W, T, threadIdx.x, blockDim.x);
  cp_async_commit();
  stage_rows_async<D>(vs, pp.v, sv.t, 0, W, T, threadIdx.x, blockDim.x);
  cp_async_commit();

  for (int t0 = 0; t0 < T; t0 += TILE) {
    const int r0 = t0 + warp * 16;
    const bool active = r0 < T;
    if (t0 == 0) {
      cp_async_wait<1>();
      __syncthreads();
    }
    unsigned qa[D / 16][4];
    float s[RES_CH][NC][4];
    float mx[2] = {NEG_INF, NEG_INF}, sm[2] = {0.f, 0.f}, inv[2];
    if (active) {
      load_q<D>(qa, stage, pp.q, sq.t, r0, T);
#pragma unroll
      for (int ch = 0; ch < RES_CH; ++ch) {
        if (ch * KC >= T) break;
        scores<D, KC / 16, T_>(s[ch], qa, ks + ch * KC * LD, LD);
        const bool edge = ch * KC + KC > T;
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[ch][j][e] * c2;
            if (edge && ch * KC + j * 8 + 2 * c4 + (e & 1) >= T) x = NEG_INF;
            s[ch][j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
      }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
#pragma unroll
      for (int ch = 0; ch < RES_CH; ++ch) {
        if (ch * KC >= T) break;
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = ex2(s[ch][j][e] - mx[e >> 1]);
            s[ch][j][e] = x;
            sm[e >> 1] += x;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sm[r] = quad_sum(sm[r]);
        inv[r] = 1.f / sm[r];
      }
      store_stats(m_out, l_out, pair, T, r0, mx, sm);
    }
    if (t0 == 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int ch = 0; ch < RES_CH; ++ch) {
      if (ch * KC >= T) break;
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[ch][j][e] *= inv[e >> 1];
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        unsigned pa[4];
        c_to_a<T_>(pa, s[ch][2 * kk], s[ch][2 * kk + 1]);
        accumulate<D, T_>(acc, pa, vs + (ch * KC + kk * 16) * LD, LD);
      }
    }
    store_rows<D, T_>(acc, stage, pp.o, so.t, r0, T);
  }
}

// Keys a window of K and V holds for head dim D in the streaming kernel (a
// multiple of KC).
inline int fwd_window(int T, int D) {
  int w = (int)(KV_BUDGET / (4 * (size_t)(D + 8))) / KC * KC;
  w = w < KC ? KC : w;
  const int t = round_up(T, KC);
  return t < w ? t : w;
}

// Any T: one CTA a pair, two passes over the keys, 64 at a time, K and V in
// windows of W keys (one window, copied once, while T fits; else each pass
// reloads the windows in turn).  Pass 1 keeps each row's running max and
// sum; pass 2 computes S again, p = 2^(s scale' - m) / l in fp32, rounds it
// to bf16 in registers and adds P V into fp32 accumulators.
template <int D, typename T_ = bf16>
__global__ void __launch_bounds__(WARPS * 32)
attn_fwd_stream(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, Strides sq, Strides sk,
                Strides sv, Strides so, int H, int T, int W, float scale,
                float* __restrict__ m_out, float* __restrict__ l_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = D + 8, NC = KC / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c4 = lane & 3;
  const int pair = blockIdx.x;
  const Pair pp(q, k, v, o, sq, sk, sv, so, pair, H);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)W * LD;
  bf16* stage = vs + (size_t)W * LD + warp * 16 * LD;
  const float c2 = scale * LOG2E;
  const float NEG_INF = __int_as_float(0xff800000);
  const int nwin = (T + W - 1) / W;
  if (nwin == 1) {  // K, then V, in two groups; they stay for every tile
    stage_rows_async<D>(ks, pp.k, sk.t, 0, W, T, threadIdx.x, blockDim.x);
    cp_async_commit();
    stage_rows_async<D>(vs, pp.v, sv.t, 0, W, T, threadIdx.x, blockDim.x);
    cp_async_commit();
  }

  for (int t0 = 0; t0 < T; t0 += TILE) {
    const int r0 = t0 + warp * 16;
    const bool active = r0 < T;
    unsigned qa[D / 16][4];
    if (active) load_q<D>(qa, stage, pp.q, sq.t, r0, T);

    // pass 1: each row's max and sum (rows g and g + 8 of the warp; a lane
    // sums its own columns, the quad's four partial sums are added at the end)
    float mx[2] = {NEG_INF, NEG_INF}, sm[2] = {0.f, 0.f};
    for (int w0 = 0; w0 < T; w0 += W) {
      if (nwin > 1) {
        __syncthreads();
        stage_rows_async<D>(ks, pp.k, sk.t, w0, W, T, threadIdx.x, blockDim.x);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      } else if (t0 == 0) {
        cp_async_wait<1>();
        __syncthreads();
      }
      if (!active) continue;
      const int wend = min(W, round_up(T - w0, KC));
      for (int c0 = 0; c0 < wend; c0 += KC) {
        float s[NC][4];
        scores<D, KC / 16, T_>(s, qa, ks + c0 * LD, LD);
        const bool edge = w0 + c0 + KC > T;
        float cm[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[j][e] * c2;
            if (edge && w0 + c0 + j * 8 + 2 * c4 + (e & 1) >= T) x = NEG_INF;
            s[j][e] = x;
            cm[e >> 1] = fmaxf(cm[e >> 1], x);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(mx[r], quad_max(cm[r]));
          sm[r] *= ex2(mx[r] - mn);
          mx[r] = mn;
        }
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sm[e >> 1] += ex2(s[j][e] - mx[e >> 1]);
      }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sm[r] = quad_sum(sm[r]);
      inv[r] = 1.f / sm[r];
    }
    if (active) store_stats(m_out, l_out, pair, T, r0, mx, sm);

    // pass 2: p = 2^(s scale' - m) / l, rounded to bf16 in registers; o += P V
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int w0 = 0; w0 < T; w0 += W) {
      if (nwin > 1) {
        __syncthreads();
        stage_rows_async<D>(ks, pp.k, sk.t, w0, W, T, threadIdx.x, blockDim.x);
        stage_rows_async<D>(vs, pp.v, sv.t, w0, W, T, threadIdx.x, blockDim.x);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      } else if (t0 == 0) {
        cp_async_wait<0>();
        __syncthreads();
      }
      if (!active) continue;
      const int wend = min(W, round_up(T - w0, KC));
      for (int c0 = 0; c0 < wend; c0 += KC) {
        float s[NC][4];
        scores<D, KC / 16, T_>(s, qa, ks + c0 * LD, LD);
        const bool edge = w0 + c0 + KC > T;
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool masked = edge && w0 + c0 + j * 8 + 2 * c4 + (e & 1) >= T;
            s[j][e] = masked ? 0.f : ex2(s[j][e] * c2 - mx[e >> 1]) * inv[e >> 1];
          }
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          unsigned pa[4];
          c_to_a<T_>(pa, s[2 * kk], s[2 * kk + 1]);
          accumulate<D, T_>(acc, pa, vs + (c0 + kk * 16) * LD, LD);
        }
      }
    }
    if (active) store_rows<D, T_>(acc, stage, pp.o, so.t, r0, T);
  }
}

template <int D>
inline size_t fwd_smem(int W) {
  return ((size_t)2 * W + WARPS * 16) * (D + 8) * sizeof(bf16);
}

// o = attention over `pairs` (batch, head) pairs on `stream`, one CTA a
// pair, and the rows' statistics when m_out is not null: the one-pass
// kernel for T <= 256, the streaming kernel above.
template <int D, typename T_ = bf16>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, Strides sq,
                       Strides sk, Strides sv, Strides so, int pairs, int H, int T, float scale,
                       float* m_out, float* l_out, cudaStream_t stream) {
  const bool resident = T <= RES_CH * KC;
  const int W = resident ? round_up(T, KC) : fwd_window(T, D);
  const size_t smem = fwd_smem<D>(W);
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if (resident) {
    if ((err = cudaFuncSetAttribute(attn_fwd_resident<D, T_>, attr, (int)smem)) != cudaSuccess)
      return err;
    attn_fwd_resident<D, T_><<<pairs, WARPS * 32, smem, stream>>>(q, k, v, o, sq, sk, sv, so, H,
                                                                  T, scale, m_out, l_out);
  } else {
    if ((err = cudaFuncSetAttribute(attn_fwd_stream<D, T_>, attr, (int)smem)) != cudaSuccess)
      return err;
    attn_fwd_stream<D, T_><<<pairs, WARPS * 32, smem, stream>>>(q, k, v, o, sq, sk, sv, so, H, T,
                                                                W, scale, m_out, l_out);
  }
  return cudaGetLastError();
}

constexpr size_t WIDE_BUDGET = 200 * 1024;   // shared memory of a wide-head CTA

// Wide heads (DT = NS DV columns, DT > 128): one CTA a (pair, slab), two
// passes over the keys as attn_fwd_stream, K staged at full width and V at
// the slab's DV columns, in windows of W keys reloaded for every query tile
// and pass; the warp's query rows staged whole and read as A fragments from
// shared memory (scores_w).  o gets the slab's DV columns.
template <int DV>
__global__ void __launch_bounds__(WARPS * 32)
attn_fwd_wide(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              bf16* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int H, int T,
              int DT, int W, float scale, float* __restrict__ m_out, float* __restrict__ l_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDV = DV + 8, NC = KC / 8;
  const int LDT = DT + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c4 = lane & 3;
  const int pair = blockIdx.x, slab = blockIdx.y;
  const Pair pp(q, k, v, o, sq, sk, sv, so, pair, H);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)W * LDT;
  bf16* stage = vs + (size_t)W * LDV + warp * 16 * LDT;
  const float c2 = scale * LOG2E;
  const float NEG_INF = __int_as_float(0xff800000);
  auto load_window = [&](int w0, bool with_v) {
    __syncthreads();
    stage_rows_async_w(ks, pp.k, sk.t, w0, W, T, DT, threadIdx.x, blockDim.x);
    if (with_v)
      stage_rows_async_w(vs, pp.v + slab * DV, sv.t, w0, W, T, DV, threadIdx.x, blockDim.x);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };

  for (int t0 = 0; t0 < T; t0 += TILE) {
    const int r0 = t0 + warp * 16;
    const bool active = r0 < T;
    if (active) {
      stage_rows_warp_w(stage, pp.q, sq.t, r0, 16, T, DT);
      __syncwarp();
    }
    float mx[2] = {NEG_INF, NEG_INF}, sm[2] = {0.f, 0.f};
    for (int w0 = 0; w0 < T; w0 += W) {
      load_window(w0, false);
      if (!active) continue;
      const int wend = min(W, round_up(T - w0, KC));
      for (int c0 = 0; c0 < wend; c0 += KC) {
        float s[NC][4];
        scores_w<KC / 16>(s, stage, LDT, ks + c0 * LDT, LDT, DT);
        float cm[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[j][e] * c2;
            if (w0 + c0 + j * 8 + 2 * c4 + (e & 1) >= T) x = NEG_INF;
            s[j][e] = x;
            cm[e >> 1] = fmaxf(cm[e >> 1], x);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(mx[r], quad_max(cm[r]));
          sm[r] *= ex2(mx[r] - mn);
          mx[r] = mn;
        }
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sm[e >> 1] += ex2(s[j][e] - mx[e >> 1]);
      }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sm[r] = quad_sum(sm[r]);
      inv[r] = 1.f / sm[r];
    }
    if (active && slab == 0) store_stats(m_out, l_out, pair, T, r0, mx, sm);

    float acc[DV / 8][4];
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int w0 = 0; w0 < T; w0 += W) {
      load_window(w0, true);
      if (!active) continue;
      const int wend = min(W, round_up(T - w0, KC));
      for (int c0 = 0; c0 < wend; c0 += KC) {
        float s[NC][4];
        scores_w<KC / 16>(s, stage, LDT, ks + c0 * LDT, LDT, DT);
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool masked = w0 + c0 + j * 8 + 2 * c4 + (e & 1) >= T;
            s[j][e] = masked ? 0.f : ex2(s[j][e] * c2 - mx[e >> 1]) * inv[e >> 1];
          }
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          unsigned pa[4];
          c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
          accumulate<DV>(acc, pa, vs + (c0 + kk * 16) * LDV, LDV);
        }
      }
    }
    if (active) store_rows<DV>(acc, stage, pp.o + slab * DV, so.t, r0, T);
  }
}

// Keys a window of the wide forward holds (a multiple of KC), or 0 if not one chunk fits.
inline int wide_window(int T, int DT, int DV) {
  const size_t fixed = (size_t)WARPS * 16 * (DT + 8) * sizeof(bf16);
  const size_t row = (size_t)(DT + 8 + DV + 8) * sizeof(bf16);
  if (fixed + KC * row > WIDE_BUDGET) return 0;
  const int w = (int)((WIDE_BUDGET - fixed) / row) / KC * KC;
  const int t = round_up(T, KC);
  return t < w ? t : w;
}

// o = attention over `pairs` pairs of heads DT = NS DV columns wide, one CTA
// a (pair, slab), and the rows' statistics when m_out is not null.
template <int DV>
cudaError_t launch_fwd_wide(const bf16* q, const bf16* k, const bf16* v, bf16* o, Strides sq,
                            Strides sk, Strides sv, Strides so, int pairs, int H, int T, int DT,
                            float scale, float* m_out, float* l_out, cudaStream_t stream) {
  const int W = wide_window(T, DT, DV);
  if (W == 0 || DT % DV) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)W * (DT + 8 + DV + 8) + (size_t)WARPS * 16 * (DT + 8)) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_wide<DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attn_fwd_wide<DV><<<dim3(pairs, DT / DV), WARPS * 32, smem, stream>>>(
      q, k, v, o, sq, sk, sv, so, H, T, DT, W, scale, m_out, l_out);
  return cudaGetLastError();
}

}  // namespace attn
