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
//                  dxb = bf16(dx);  dh = bf16((dxb Wfc2^T) * gelu_tanh'(hmid));
//                  dWfc2 += hact^T dxb;  dWfc += xn2^T dh;
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
//   * every product is csrc/gemm_tile.cuh's GEMM: TMA into a ring of
//     128-byte-swizzled tiles, wgmma.mma_async from two consumer
//     warpgroups, each operand read as it lies (dX = dY W^T reads W
//     K-major, dW = A^T dY reads A and dY MN-major), tails zero-filled by
//     TMA.  Epilogues on the accumulators: bf16 round, tanh GELU, residual
//     add, fp32 store;
//   * the backward's MLP front is one kernel of two products on that
//     machinery (csrc/train_bwd_gemm.cuh's mlp_front_kernel): hmid = xn2 Wfc
//     and dhact = dxb Wfc2^T accumulate side by side over the same K from a
//     ring of four-tile stages, and the epilogue writes hact = bf16(gelu(hmid))
//     and dh = bf16(dhact gelu'(hmid)), so hmid never reaches device memory;
//   * the LayerNorm backward runs in the epilogue of its dX product
//     (ln_dx_kernel, same header): dY = dh Wfc^T (LN2) or dqkv Wqkv^T (LN1)
//     stays in registers, each row's sums of dY g and dY g xhat are taken
//     in the quad that holds the row, dx += LN_bwd(dY) in fp32, dxb =
//     bf16(dx), and each 128-row tile leaves one gain-gradient partial row;
//     the recompute's ln_kernel keeps the rows' mean and 1/std for it.  The
//     epilogue's x and dx come by TMA through the product's own ring (a
//     48 KB stage a 64-column chunk, loaded as the tile's last k-tiles free
//     their stages), dx and dxb are written over them in shared memory and
//     leave by TMA from a storer warp while the next tile's products run:
//     231,536 bytes of shared memory, 448 KB of the epilogue's traffic a
//     128 x 256 tile, x read once.  At
//     E <= 256 a CTA owns whole rows; up to E = 2048 a row's 256-column
//     tiles run as one thread-block cluster that adds the ranks' row sums
//     in rank order through distributed shared memory (tbg::ln_ranks, the
//     one place of that rule); past it the product goes to an fp32 dY and
//     ln_bwd_kernel (a warp per row) and dg_partial_kernel (column sums
//     over fixed row blocks) run after it;
//   * the weight gradients: dW = A^T dY over the group's rows, split along
//     the rows (the product's depth) into per-split partial sums in the
//     workspace, enough splits to fill the card, then reduce_add_kernel
//     adds the partials to the fp32 gradient in a fixed order.  No atomics,
//     so two runs give the same gradients bit for bit;
//   * ln_kernel (LN forward, a warp per row); the gain gradients' partials
//     reduced like the weights';
//   * the attention, routed by shape (attention_route, the one place of
//     that rule): at T <= 256 and padded head widths 16, 32, 48 and 64 (the
//     models' heads), the forward and the backward's recompute run
//     csrc/attn_wgmma.cuh's persistent wgmma kernel (TMA producer, mbarrier
//     ring, two consumer warpgroups; shared with csrc/attention.cu and
//     csrc/fused_blocks.cu), the recompute also writing each row's max and
//     sum, and the backward csrc/attn_wgmma_bwd.cuh's attn_bwd_q_wgmma
//     (delta and dq) and attn_bwd_kv_wgmma (dk and dv) on the same
//     machinery.  Other shapes run attn::launch_fwd (csrc/attn_tile.cuh),
//     one CTA a (context, head), a row's scores in mma.sync accumulators,
//     and attn_bwd_q_kernel and attn_bwd_kv_kernel below.  Both backwards
//     recompute p from the statistics, so no T x T buffer exists and
//     nothing is summed by atomics; the mma.sync ones stage the other
//     side's rows in windows of their shared memory's size, reloaded in
//     turn when T is past one.
// Heads are laid out padded: each head's q, k, v, attention and their
// gradients take DP = dh rounded up to 16 columns (the attention tiles'
// depth), so Wqkv is [E, 3 H DP] and Wproj [H DP, E], with zero columns and
// rows the wrapper adds and drops (none at the repo's models); zero columns
// change no score, product or gradient.  The scale stays 1/sqrt(dh).  A
// head past 128 columns is padded to DP = NS DV (NS slabs of DV <= 128) and
// runs attn::launch_fwd_wide and attn_bwd_q_wide / attn_bwd_kv_wide, one
// CTA a slab of the output columns, the scores summed over all DP columns
// from shared memory (they recompute the scores in every slab).
// Shapes: any T >= 1, head dims 1 to 512, any E: an E that is not a multiple
// of 8 (TMA's 16-byte row strides) is stored padded with zero columns to the
// next multiple, and 4E likewise; the wrapper pads and unpads, and
// LayerNorm and its backward take their means over the true E.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC -o libfused_train.so fused_train.cu   (ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "attn_tile.cuh"
#include "attn_wgmma.cuh"
#include "attn_wgmma_bwd.cuh"
#include "gemm_tile.cuh"
#include "train_bwd_gemm.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr float LN_EPS = 1e-5f;
constexpr int SMS = 132;                 // SMs of an H100 SXM (sizes the split of dW)
constexpr int MAX_SPLITS = 64;
constexpr int ROWS_PER_PART = 256;       // rows of one gain-gradient partial
constexpr size_t BWD_BUDGET = 180 * 1024;   // shared memory of a backward attention CTA

using tbg::gelu_tanh;   // the tanh GELU of csrc/train_bwd_gemm.cuh, shared with its MLP front

__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// GEMM epilogues (gemm_tile.cuh calls them on adjacent column pairs), C's
// rows ldc apart.  A bf16 output is staged through shared memory and stored
// by TMA (STAGED); an fp32 one is stored from registers.
// C16 = bf16(acc)
struct EpiBf16 {
  using Side = gemm::NoSide;
  static constexpr bool STAGED = true;
  bf16* c;
  int ldc;
  __device__ Side load(int, int) const { return {}; }
  __device__ float2 value(int, int, float v0, float v1, Side) const { return {v0, v1}; }
};

// C16 = bf16(gelu_tanh(acc))
struct EpiGelu {
  using Side = gemm::NoSide;
  static constexpr bool STAGED = true;
  bf16* c;
  int ldc;
  __device__ Side load(int, int) const { return {}; }
  __device__ float2 value(int, int, float v0, float v1, Side) const {
    return {gelu_tanh(v0), gelu_tanh(v1)};
  }
};

// C16 = bf16(R + bf16(acc))
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

// C32 = acc, split z's partial at C32 + z * split_stride
struct EpiF32 {
  using Side = gemm::NoSide;
  static constexpr bool STAGED = false;
  float* c;
  int ldc;
  long long split_stride;
  __device__ Side load(int, int) const { return {}; }
  __device__ void operator()(int r, int col, float v0, float v1, Side, int z) const {
    *reinterpret_cast<float2*>(c + z * split_stride + (size_t)r * ldc + col) = make_float2(v0, v1);
  }
};

// y[r] = bf16(LN(x[r]) * g) for M rows, a warp per row (rows ldx and ldy
// apart): the statistics over the first EL of the E stored columns (the rest
// are the zero padding of an n_embd that is not a multiple of 8; g is zero
// there, so y is too).  The backward's recompute also keeps each row's mean
// and 1/std in mu_out, rs_out (null in the forward) for its LN epilogue.
__global__ void __launch_bounds__(256)
ln_kernel(const bf16* __restrict__ x, long long ldx, const float* __restrict__ g,
          bf16* __restrict__ y, int ldy, int M, int E, int EL, float* __restrict__ mu_out,
          float* __restrict__ rs_out) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * ldx;
  float s = 0.f;
  for (int c = lane; c < EL; c += 32) s += __bfloat162float(xr[c]);
  const float mu = warp_sum(s) / EL;
  float q = 0.f;
  for (int c = lane; c < EL; c += 32) {
    const float d = __bfloat162float(xr[c]) - mu;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / EL + LN_EPS);
  bf16* yr = y + (size_t)row * ldy;
  for (int c = lane; c < E; c += 32)
    yr[c] = __float2bfloat16((__bfloat162float(xr[c]) - mu) * rstd * g[c]);
  if (mu_out != nullptr && lane == 0) {
    mu_out[row] = mu;
    rs_out[row] = rstd;
  }
}

// LayerNorm backward of y = LN(x) * g for M rows [E], a warp per row, at the
// widths past the LN epilogue's (tbg::ln_ranks(E) == 0), from the rows' mean
// and 1/std as the recompute's ln_kernel left them in mu, rs:
// dx += (dy*g - mean(dy*g) - xhat * mean(dy*g*xhat)) * rstd, then dxb =
// bf16(dx).  The means over the first EL columns; the padding columns past
// EL keep dx (zero) and get dxb = 0.
__global__ void __launch_bounds__(256)
ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ dy, float* __restrict__ dx, bf16* __restrict__ dxb,
              const float* __restrict__ mu_in, const float* __restrict__ rs_in, int M, int E,
              int EL) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * E;
  const float* dyr = dy + (size_t)row * E;
  const float mu = mu_in[row], rstd = rs_in[row];
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < EL; c += 32) {
    const float xhat = (__bfloat162float(xr[c]) - mu) * rstd;
    const float d = dyr[c] * g[c];
    s1 += d;
    s2 += d * xhat;
  }
  const float m1 = warp_sum(s1) / EL, m2 = warp_sum(s2) / EL;
  float* dxr = dx + (size_t)row * E;
  bf16* dxbr = dxb + (size_t)row * E;
  for (int c = lane; c < E; c += 32) {
    const float xhat = (__bfloat162float(xr[c]) - mu) * rstd;
    const float d = dyr[c] * g[c];
    const float v = c < EL ? dxr[c] + (d - m1 - xhat * m2) * rstd : dxr[c];
    dxr[c] = v;
    dxbr[c] = __float2bfloat16(v);
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
//     the head staged by cp.async in windows of W keys: pass A sums delta_i
//     = sum_j dp_ij p_ij (fp32, dp = dA V^T), the sum the JAX kernel takes;
//     pass B forms ds = bf16(((dp - delta) p) scale) and adds dq += ds K;
//   attn_bwd_kv_kernel, one CTA a (64 keys, head, context), Q and dA of the
//     head staged in windows of W queries: S^T = K Q^T and dP^T = V dA^T
//     again, p and ds from m, l and delta, then dv += bf16(p)^T dA and dk
//     += ds^T Q.
// A window holds the whole head while T fits BWD_BUDGET (at every T <= 256
// and head dim) and is then staged once; past it each pass reloads the
// windows in turn.  Every product runs on mma.sync
// from ldmatrix'ed shared-memory tiles; the outputs leave 16 bytes a lane;
// no atomics, no T x T buffer.
constexpr int BC = 32;   // keys (query side) or queries (key side) a chunk

template <int DH>
size_t bwd_q_smem(int W) {
  return ((size_t)2 * W + attn::TILE) * (DH + 8) * sizeof(bf16);
}

template <int DH>
size_t bwd_kv_smem(int W) {
  return ((size_t)2 * W + 2 * attn::TILE) * (DH + 8) * sizeof(bf16) + 3 * (size_t)W * sizeof(float);
}

// The largest window (a multiple of BC) within BWD_BUDGET, or T rounded up.
template <int DH>
int bwd_window(int T, bool key_side) {
  const size_t row = 2 * (DH + 8) * sizeof(bf16) + (key_side ? 3 * sizeof(float) : 0);
  const size_t fixed = (key_side ? 2 : 1) * attn::TILE * (DH + 8) * sizeof(bf16);
  const int w = (int)((BWD_BUDGET - fixed) / row) / BC * BC;
  const int t = attn::round_up(T, BC);
  return t < w ? t : w;
}

template <int DH>
__global__ void __launch_bounds__(attn::WARPS * 32)
attn_bwd_q_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ datt,
                  const float* __restrict__ m_in, const float* __restrict__ l_in,
                  float* __restrict__ delta_out, bf16* __restrict__ dqkv, int T, int EA, int W,
                  float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = DH + 8, NB = BC / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  const int h = blockIdx.y, ctx = blockIdx.z, H = gridDim.y, E3 = 3 * EA;
  const int r0 = blockIdx.x * attn::TILE + warp * 16;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)W * LD;
  bf16* stage = vs + (size_t)W * LD + warp * 16 * LD;
  const bf16* qp = qkv + (size_t)ctx * T * E3 + h * DH;
  const bf16* dap = datt + (size_t)ctx * T * EA + h * DH;
  const size_t srow = ((size_t)ctx * H + h) * T;
  const int nwin = (T + W - 1) / W;
  auto load_window = [&](int w0) {
    attn::stage_rows_async<DH>(ks, qp + EA, E3, w0, W, T, threadIdx.x, blockDim.x);
    attn::stage_rows_async<DH>(vs, qp + 2 * EA, E3, w0, W, T, threadIdx.x, blockDim.x);
    attn::cp_async_commit();
  };
  auto next_window = [&](int w0) {   // past one window: reload in turn
    if (nwin == 1) return;
    __syncthreads();
    load_window(w0);
    attn::cp_async_wait<0>();
    __syncthreads();
  };
  if (nwin == 1) load_window(0);
  const bool active = r0 < T;
  unsigned qa[DH / 16][4], daa[DH / 16][4];
  float mr[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  if (active) {
    attn::stage_rows_warp<DH>(stage, qp, E3, r0, 16, T);
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) attn::frag_a(qa[kk], stage + kk * 16, LD);
    __syncwarp();
    attn::stage_rows_warp<DH>(stage, dap, EA, r0, 16, T);
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
  const float c2 = scale * attn::LOG2E;

  // pass A: delta_i = sum_j dp_ij p_ij
  float dl[2] = {0.f, 0.f};
  for (int w0 = 0; w0 < T; w0 += W) {
    next_window(w0);
    if (!active) continue;
    const int wend = min(W, attn::round_up(T - w0, BC));
    for (int c0 = 0; c0 < wend; c0 += BC) {
      float s[NB][4], dp[NB][4];
      attn::scores<DH, BC / 16>(s, qa, ks + c0 * LD, LD);
      attn::scores<DH, BC / 16>(dp, daa, vs + c0 * LD, LD);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool key_ok = w0 + c0 + j * 8 + 2 * c4 + (e & 1) < T;
          const float p = key_ok ? attn::ex2(s[j][e] * c2 - mr[e >> 1]) * inv[e >> 1] : 0.f;
          dl[e >> 1] += dp[j][e] * p;
        }
    }
  }
  if (active) {
    dl[0] = attn::quad_sum(dl[0]);
    dl[1] = attn::quad_sum(dl[1]);
  }

  // pass B: ds = bf16(((dp - delta) p) scale); dq += ds K
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int w0 = 0; w0 < T; w0 += W) {
    next_window(w0);
    if (!active) continue;
    const int wend = min(W, attn::round_up(T - w0, BC));
    for (int c0 = 0; c0 < wend; c0 += BC) {
      float s[NB][4], dp[NB][4];
      attn::scores<DH, BC / 16>(s, qa, ks + c0 * LD, LD);
      attn::scores<DH, BC / 16>(dp, daa, vs + c0 * LD, LD);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool key_ok = w0 + c0 + j * 8 + 2 * c4 + (e & 1) < T;
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
  }
  if (!active) return;
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
                   const float* __restrict__ delta_in, bf16* __restrict__ dqkv, int T, int EA,
                   int W, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = DH + 8, NB = BC / 8;
  constexpr bool REG = DH <= 64;   // K and V fragments in registers (else read as needed)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c4 = lane & 3;
  const int h = blockIdx.y, ctx = blockIdx.z, H = gridDim.y, E3 = 3 * EA;
  const int k0 = blockIdx.x * attn::TILE + warp * 16;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* das = qs + (size_t)W * LD;
  bf16* kst = das + (size_t)W * LD + warp * 32 * LD;
  bf16* vst = kst + 16 * LD;
  float* ms = reinterpret_cast<float*>(das + (size_t)W * LD + attn::WARPS * 32 * LD);
  float* li = ms + W;
  float* dls = li + W;
  const bf16* qp = qkv + (size_t)ctx * T * E3 + h * DH;
  const bf16* dap = datt + (size_t)ctx * T * EA + h * DH;
  const size_t srow = ((size_t)ctx * H + h) * T;
  const int nwin = (T + W - 1) / W;
  auto load_window = [&](int w0) {
    attn::stage_rows_async<DH>(qs, qp, E3, w0, W, T, threadIdx.x, blockDim.x);
    attn::stage_rows_async<DH>(das, dap, EA, w0, W, T, threadIdx.x, blockDim.x);
    attn::cp_async_commit();
    // queries past T: m = +inf, so that p = 2^(-inf) = 0
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      const bool ok = w0 + i < T;
      ms[i] = ok ? m_in[srow + w0 + i] : __int_as_float(0x7f800000);
      li[i] = ok ? 1.f / l_in[srow + w0 + i] : 0.f;
      dls[i] = ok ? delta_in[srow + w0 + i] : 0.f;
    }
  };
  if (nwin == 1) load_window(0);
  const bool active = k0 < T;
  unsigned ka[REG ? DH / 16 : 1][4], va[REG ? DH / 16 : 1][4];
  if (active) {
    attn::stage_rows_warp<DH>(kst, qp + EA, E3, k0, 16, T);
    attn::stage_rows_warp<DH>(vst, qp + 2 * EA, E3, k0, 16, T);
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
  const float c2 = scale * attn::LOG2E;

  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  for (int w0 = 0; w0 < T; w0 += W) {
    if (nwin > 1) {
      __syncthreads();
      load_window(w0);
      attn::cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;
    const int wend = min(W, attn::round_up(T - w0, BC));
    for (int c0 = 0; c0 < wend; c0 += BC) {
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
  }
  if (!active) return;
  bf16* out = dqkv + (size_t)ctx * T * E3 + h * DH;
  attn::store_rows<DH>(dk, kst, out + EA, E3, k0, T);
  attn::store_rows<DH>(dv, vst, out + 2 * EA, E3, k0, T);
}

// Heads wider than 128 columns: the head padded to DT = NS DV columns, one
// CTA a (64 query rows or keys, head and slab of DV output columns,
// context).  The rows of both sides are staged whole and the scores and dP
// (or S^T and dP^T) summed over all DT columns with the A fragments read
// from shared memory (attn::scores_w); the slab's dq (or dk and dv) come
// from the slab's DV columns of K (or of Q and dA).  Every slab computes the
// same p and ds in the same order; slab 0 writes delta.  The windows are
// reloaded in every pass.
template <int DV>
__global__ void __launch_bounds__(attn::WARPS * 32)
attn_bwd_q_wide(const bf16* __restrict__ qkv, const bf16* __restrict__ datt,
                const float* __restrict__ m_in, const float* __restrict__ l_in,
                float* __restrict__ delta_out, bf16* __restrict__ dqkv, int T, int EA, int DT,
                int W, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NB = BC / 8;
  const int LDT = DT + 8, NS = DT / DV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c4 = lane & 3;
  const int h = blockIdx.y / NS, slab = blockIdx.y % NS, H = gridDim.y / NS, ctx = blockIdx.z;
  const int E3 = 3 * EA;
  const int r0 = blockIdx.x * attn::TILE + warp * 16;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)W * LDT;
  bf16* qst = vs + (size_t)W * LDT + warp * 32 * LDT;
  bf16* dast = qst + 16 * LDT;
  const bf16* qp = qkv + (size_t)ctx * T * E3 + h * DT;
  const bf16* dap = datt + (size_t)ctx * T * EA + h * DT;
  const size_t srow = ((size_t)ctx * H + h) * T;
  auto load_window = [&](int w0) {
    __syncthreads();
    attn::stage_rows_async_w(ks, qp + EA, E3, w0, W, T, DT, threadIdx.x, blockDim.x);
    attn::stage_rows_async_w(vs, qp + 2 * EA, E3, w0, W, T, DT, threadIdx.x, blockDim.x);
    attn::cp_async_commit();
    attn::cp_async_wait<0>();
    __syncthreads();
  };
  const bool active = r0 < T;
  float mr[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  if (active) {
    attn::stage_rows_warp_w(qst, qp, E3, r0, 16, T, DT);
    attn::stage_rows_warp_w(dast, dap, EA, r0, 16, T, DT);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r0 + g + 8 * r < T) {
        mr[r] = m_in[srow + r0 + g + 8 * r];
        inv[r] = 1.f / l_in[srow + r0 + g + 8 * r];
      }
  }
  __syncwarp();
  const float c2 = scale * attn::LOG2E;

  // pass A: delta_i = sum_j dp_ij p_ij
  float dl[2] = {0.f, 0.f};
  for (int w0 = 0; w0 < T; w0 += W) {
    load_window(w0);
    if (!active) continue;
    const int wend = min(W, attn::round_up(T - w0, BC));
    for (int c0 = 0; c0 < wend; c0 += BC) {
      float s[NB][4], dp[NB][4];
      attn::scores_w<BC / 16>(s, qst, LDT, ks + c0 * LDT, LDT, DT);
      attn::scores_w<BC / 16>(dp, dast, LDT, vs + c0 * LDT, LDT, DT);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool key_ok = w0 + c0 + j * 8 + 2 * c4 + (e & 1) < T;
          const float p = key_ok ? attn::ex2(s[j][e] * c2 - mr[e >> 1]) * inv[e >> 1] : 0.f;
          dl[e >> 1] += dp[j][e] * p;
        }
    }
  }
  if (active) {
    dl[0] = attn::quad_sum(dl[0]);
    dl[1] = attn::quad_sum(dl[1]);
  }

  // pass B: ds = bf16(((dp - delta) p) scale); dq[:, slab] += ds K[:, slab]
  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int w0 = 0; w0 < T; w0 += W) {
    load_window(w0);
    if (!active) continue;
    const int wend = min(W, attn::round_up(T - w0, BC));
    for (int c0 = 0; c0 < wend; c0 += BC) {
      float s[NB][4], dp[NB][4];
      attn::scores_w<BC / 16>(s, qst, LDT, ks + c0 * LDT, LDT, DT);
      attn::scores_w<BC / 16>(dp, dast, LDT, vs + c0 * LDT, LDT, DT);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool key_ok = w0 + c0 + j * 8 + 2 * c4 + (e & 1) < T;
          const float p = key_ok ? attn::ex2(s[j][e] * c2 - mr[e >> 1]) * inv[e >> 1] : 0.f;
          s[j][e] = ((dp[j][e] - dl[e >> 1]) * p) * scale;
        }
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
        unsigned a[4];
        attn::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
        attn::accumulate<DV>(acc, a, ks + (c0 + kk * 16) * LDT + slab * DV, LDT);
      }
    }
  }
  if (!active) return;
  attn::store_rows<DV>(acc, qst, dqkv + (size_t)ctx * T * E3 + h * DT + slab * DV, E3, r0, T);
  if (c4 == 0 && slab == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r0 + g + 8 * r < T) delta_out[srow + r0 + g + 8 * r] = dl[r];
  }
}

template <int DV>
__global__ void __launch_bounds__(attn::WARPS * 32)
attn_bwd_kv_wide(const bf16* __restrict__ qkv, const bf16* __restrict__ datt,
                 const float* __restrict__ m_in, const float* __restrict__ l_in,
                 const float* __restrict__ delta_in, bf16* __restrict__ dqkv, int T, int EA,
                 int DT, int W, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NB = BC / 8;
  const int LDT = DT + 8, NS = DT / DV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c4 = lane & 3;
  const int h = blockIdx.y / NS, slab = blockIdx.y % NS, H = gridDim.y / NS, ctx = blockIdx.z;
  const int E3 = 3 * EA;
  const int k0 = blockIdx.x * attn::TILE + warp * 16;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* das = qs + (size_t)W * LDT;
  bf16* kst = das + (size_t)W * LDT + warp * 32 * LDT;
  bf16* vst = kst + 16 * LDT;
  float* ms = reinterpret_cast<float*>(das + (size_t)W * LDT + attn::WARPS * 32 * LDT);
  float* li = ms + W;
  float* dls = li + W;
  const bf16* qp = qkv + (size_t)ctx * T * E3 + h * DT;
  const bf16* dap = datt + (size_t)ctx * T * EA + h * DT;
  const size_t srow = ((size_t)ctx * H + h) * T;
  const bool active = k0 < T;
  if (active) {
    attn::stage_rows_warp_w(kst, qp + EA, E3, k0, 16, T, DT);
    attn::stage_rows_warp_w(vst, qp + 2 * EA, E3, k0, 16, T, DT);
  }
  __syncwarp();
  const float c2 = scale * attn::LOG2E;

  float dk[DV / 8][4], dv[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  for (int w0 = 0; w0 < T; w0 += W) {
    __syncthreads();
    attn::stage_rows_async_w(qs, qp, E3, w0, W, T, DT, threadIdx.x, blockDim.x);
    attn::stage_rows_async_w(das, dap, EA, w0, W, T, DT, threadIdx.x, blockDim.x);
    attn::cp_async_commit();
    // queries past T: m = +inf, so that p = 2^(-inf) = 0
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      const bool ok = w0 + i < T;
      ms[i] = ok ? m_in[srow + w0 + i] : __int_as_float(0x7f800000);
      li[i] = ok ? 1.f / l_in[srow + w0 + i] : 0.f;
      dls[i] = ok ? delta_in[srow + w0 + i] : 0.f;
    }
    attn::cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    const int wend = min(W, attn::round_up(T - w0, BC));
    for (int c0 = 0; c0 < wend; c0 += BC) {
      float st[NB][4], dpt[NB][4];   // S^T and dP^T: rows are keys, columns queries
      attn::scores_w<BC / 16>(st, kst, LDT, qs + c0 * LDT, LDT, DT);
      attn::scores_w<BC / 16>(dpt, vst, LDT, das + c0 * LDT, LDT, DT);
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
        attn::accumulate<DV>(dv, a, das + (c0 + kk * 16) * LDT + slab * DV, LDT);
        attn::c_to_a(a, dpt[2 * kk], dpt[2 * kk + 1]);
        attn::accumulate<DV>(dk, a, qs + (c0 + kk * 16) * LDT + slab * DV, LDT);
      }
    }
  }
  if (!active) return;
  bf16* out = dqkv + (size_t)ctx * T * E3 + h * DT + slab * DV;
  attn::store_rows<DV>(dk, kst, out + EA, E3, k0, T);
  attn::store_rows<DV>(dv, vst, out + 2 * EA, E3, k0, T);
}

// Rows a window of the wide backward holds within BWD_WIDE_BUDGET (a
// multiple of BC), or 0 if not one chunk fits.
constexpr size_t BWD_WIDE_BUDGET = 220 * 1024;
size_t bwd_wide_smem(int W, int DT, bool key_side) {
  return ((size_t)2 * W + 2 * attn::TILE) * (DT + 8) * sizeof(bf16) +
         (key_side ? 3 * (size_t)W * sizeof(float) : 0);
}
int bwd_wide_window(int T, int DT, bool key_side) {
  const size_t fixed = bwd_wide_smem(0, DT, key_side);
  const size_t row = 2 * (DT + 8) * sizeof(bf16) + (key_side ? 3 * sizeof(float) : 0);
  if (fixed + BC * row > BWD_WIDE_BUDGET) return 0;
  const int w = (int)((BWD_WIDE_BUDGET - fixed) / row) / BC * BC;
  const int t = attn::round_up(T, BC);
  return t < w ? t : w;
}

#define RETURN_IF_ERROR(call)                  \
  do {                                         \
    const cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

// Row splits of dW = A^T dY ([Mw, Nw] over K rows): enough (tile, split)
// pairs to give each SM one, at most MAX_SPLITS and one BK tile a split.
int dw_splits(int Mw, int Nw, int K) {
  const int tiles = gemm::tiles(Mw, Nw);
  int s = (SMS + tiles - 1) / tiles;
  s = s < MAX_SPLITS ? s : MAX_SPLITS;
  const int kt = (K + gemm::BK - 1) / gemm::BK;
  return s < kt ? s : kt;
}

// dw[Mw, Nw] += A^T dY over K rows (A [K, Mw], dY [K, Nw] row-major).
cudaError_t weight_grad(const bf16* A, const bf16* dY, int Mw, int Nw, int K, float* partial,
                        float* dw, cudaStream_t stream) {
  const int splits = dw_splits(Mw, Nw, K);
  const long long count = (long long)Mw * Nw;
  cudaError_t err = gemm::run<true, false>(A, Mw, dY, Nw, Mw, Nw, K, EpiF32{partial, Nw, count},
                                           stream, splits);
  if (err != cudaSuccess) return err;
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

cudaError_t layer_norm(const bf16* x, long long ldx, const float* g, bf16* y, int ldy, int M,
                       int E, int EL, cudaStream_t stream, float* mu = nullptr,
                       float* rs = nullptr) {
  ln_kernel<<<(M + 7) / 8, 256, 0, stream>>>(x, ldx, g, y, ldy, M, E, EL, mu, rs);
  return cudaGetLastError();
}

// Launches of the backward's epilogue kernels (mlp_front_kernel,
// ln_dx_kernel), counted where they are launched.
long long bwd_gemm_launches[2] = {0, 0};

// hact, dh [M, F] from xn2, dxb [M, E] and the layer's Wfc, Wfc2:
// mlp_front_kernel.
cudaError_t mlp_front(const bf16* xn2, const bf16* dxb, const bf16* wfc, const bf16* wfc2,
                      bf16* hact, bf16* dh, int M, int E, int F, cudaStream_t stream) {
  const cudaError_t err = tbg::mlp_front(xn2, dxb, wfc, wfc2, hact, dh, M, E, F, stream);
  if (err == cudaSuccess) ++bwd_gemm_launches[0];
  return err;
}

// dx += LN_bwd(A W^T) for y = LN(x) * g (A [M, K], W [E, K]; the rows' mu
// and rs as ln_kernel left them), dxb = bf16(dx), dg += the gain gradient
// (partial: the row blocks' sums, reduced in order).  At the widths
// tbg::ln_ranks takes, one ln_dx_kernel (the product, the LN backward and
// the gain partials in its epilogue); past them the product into dy32
// (fp32 [M, E]), then ln_bwd_kernel and dg_partial_kernel.
cudaError_t ln_backward(const bf16* A, const bf16* W, int K, const bf16* x, const float* g,
                        const float* mu, const float* rs, float* dx, bf16* dxb, float* dy32,
                        float* partial, float* dg, int M, int E, int EL, cudaStream_t stream) {
  if (tbg::ln_ranks(E) > 0) {
    cudaError_t err =
        tbg::ln_dx(A, W, M, E, K, tbg::LnArgs{x, E, g, mu, rs, dx, dxb, partial, EL}, stream);
    if (err != cudaSuccess) return err;
    ++bwd_gemm_launches[1];
    reduce_add_kernel<<<(E + 255) / 256, 256, 0, stream>>>(partial, gemm::cdiv(M, gemm::BM), E,
                                                           dg);
    return cudaGetLastError();
  }
  cudaError_t err = gemm::run<false, true>(A, K, W, K, M, E, K, EpiF32{dy32, E, 0}, stream);
  if (err != cudaSuccess) return err;
  ln_bwd_kernel<<<(M + 7) / 8, 256, 0, stream>>>(x, g, dy32, dx, dxb, mu, rs, M, E, EL);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gain_grad(x, dy32, mu, rs, M, E, partial, dg, stream);
}

// 1/sqrt(dh) in double, rounded once to fp32, as the JAX kernels' python scale
float attn_scale(int dh) { return (float)(1.0 / std::sqrt((double)dh)); }

// The attention's shape: H heads of dh columns, each padded to DP = NS DV
// columns (NS slabs of DV; NS = 1 and DP = dh rounded up to 16 for head
// dims up to 128), EA = H DP wide.
struct Heads {
  int H, dh, NS, DV, DP, EA;
};

// f(std::integral_constant<int, DV>()) for a padded width dv (16 .. 128).
template <typename Fn>
cudaError_t with_width(int dv, Fn f) {
  switch (dv) {
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

// f(std::integral_constant<int, DV>()) for a wide head's slab width, which
// is 80 .. 128 for head dims 129 .. 512.
template <typename Fn>
cudaError_t with_slab_width(int dv, Fn f) {
  switch (dv) {
    case 80: return f(std::integral_constant<int, 80>());
    case 96: return f(std::integral_constant<int, 96>());
    case 112: return f(std::integral_constant<int, 112>());
    default: return f(std::integral_constant<int, 128>());
  }
}

// The attention's kernels for T and the heads: the wgmma kernels
// (csrc/attn_wgmma.cuh, csrc/attn_wgmma_bwd.cuh) at T <= 256 and padded head
// widths 16, 32, 48 and 64, the mma.sync tiles at the other widths up to 128
// and at T past 256, the slabs past 128 columns.
enum Route { ROUTE_WGMMA = 0, ROUTE_TILE = 1, ROUTE_WIDE = 2 };
Route attention_route(int T, Heads hd) {
  if (hd.NS > 1) return ROUTE_WIDE;
  return T <= aw::T_MAX && aw::takes(hd.DP) ? ROUTE_WGMMA : ROUTE_TILE;
}

// Launches of the wgmma route's kernels (the forward with or without
// statistics, the query side, the key side), counted where they are launched.
long long wgmma_launches[3] = {0, 0, 0};

// f(std::integral_constant<int, D>()) for a width the wgmma kernels take.
template <typename Fn>
int with_wgmma_width(int d, Fn f) {
  switch (d) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 48: return f(std::integral_constant<int, 48>());
    default: return f(std::integral_constant<int, 64>());
  }
}

// att = the attention of qkv [nc, T, 3 EA] -> [nc, T, EA] over the nc x H
// (context, head) pairs on the route of attention_route, and each row's
// statistics m, l [nc, H, T] when not null.
cudaError_t attention_fwd(const bf16* qkv, bf16* att, float* m, float* l, int nc, int T,
                          Heads hd, cudaStream_t stream) {
  const long long E3 = 3LL * hd.EA;
  const attn::Strides sqkv{T * E3, hd.DP, E3}, so{(long long)T * hd.EA, hd.DP, hd.EA};
  if (attention_route(T, hd) == ROUTE_WGMMA) {
    const int rc = with_wgmma_width(hd.DP, [&](auto dp) {
      return aw::train_attention<decltype(dp)::value>(qkv, att, m, l, nc, T, hd.H,
                                                     attn_scale(hd.dh), stream);
    });
    if (rc == 0) ++wgmma_launches[0];
    return (cudaError_t)rc;
  }
  if (hd.NS > 1)
    return with_slab_width(hd.DV, [&](auto dv) {
      return attn::launch_fwd_wide<decltype(dv)::value>(
          qkv, qkv + hd.EA, qkv + 2 * hd.EA, att, sqkv, sqkv, sqkv, so, nc * hd.H, hd.H, T, hd.DP,
          attn_scale(hd.dh), m, l, stream);
    });
  return with_width(hd.DP, [&](auto dp) {
    return attn::launch_fwd<decltype(dp)::value>(qkv, qkv + hd.EA, qkv + 2 * hd.EA, att, sqkv,
                                                 sqkv, sqkv, so, nc * hd.H, hd.H, T,
                                                 attn_scale(hd.dh), m, l, stream);
  });
}

// The wide heads' backward: attn_bwd_q_wide, then attn_bwd_kv_wide, one CTA a
// (tile, head and slab, context).
template <int DV>
cudaError_t attention_bwd_wide(const bf16* qkv, const bf16* datt, const float* m, const float* l,
                               float* delta, bf16* dqkv, int nc, int T, Heads hd,
                               cudaStream_t stream) {
  const dim3 grid((T + attn::TILE - 1) / attn::TILE, hd.H * hd.NS, nc);
  const int wq = bwd_wide_window(T, hd.DP, false), wkv = bwd_wide_window(T, hd.DP, true);
  if (wq == 0 || wkv == 0) return cudaErrorInvalidValue;
  const size_t sq = bwd_wide_smem(wq, hd.DP, false), skv = bwd_wide_smem(wkv, hd.DP, true);
  const float scale = attn_scale(hd.dh);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_q_wide<DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_kv_wide<DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)skv);
  if (err != cudaSuccess) return err;
  attn_bwd_q_wide<DV><<<grid, attn::WARPS * 32, sq, stream>>>(qkv, datt, m, l, delta, dqkv, T,
                                                              hd.EA, hd.DP, wq, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_kv_wide<DV><<<grid, attn::WARPS * 32, skv, stream>>>(qkv, datt, m, l, delta, dqkv, T,
                                                                hd.EA, hd.DP, wkv, scale);
  return cudaGetLastError();
}

// dqkv [nc, T, 3 EA] from qkv, datt [nc, T, EA] and the forward's m, l;
// delta [nc, H, T] is the query side's scratch for the key side.
template <int DH>
cudaError_t attention_bwd_tile(const bf16* qkv, const bf16* datt, const float* m, const float* l,
                               float* delta, bf16* dqkv, int nc, int T, Heads hd,
                               cudaStream_t stream) {
  const dim3 grid((T + attn::TILE - 1) / attn::TILE, hd.H, nc);
  const int wq = bwd_window<DH>(T, false), wkv = bwd_window<DH>(T, true);
  const size_t sq = bwd_q_smem<DH>(wq), skv = bwd_kv_smem<DH>(wkv);
  const float scale = attn_scale(hd.dh);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_q_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_kv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)skv);
  if (err != cudaSuccess) return err;
  attn_bwd_q_kernel<DH><<<grid, attn::WARPS * 32, sq, stream>>>(qkv, datt, m, l, delta, dqkv, T,
                                                                hd.EA, wq, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_kv_kernel<DH><<<grid, attn::WARPS * 32, skv, stream>>>(qkv, datt, m, l, delta, dqkv,
                                                                  T, hd.EA, wkv, scale);
  return cudaGetLastError();
}

// dqkv [nc, T, 3 EA] from qkv, datt and att [nc, T, EA] and the forward's m,
// l [nc, H, T], on the route of attention_route; delta is the query side's
// scratch for the key side (bwd_scratch floats).  sides (the wgmma route):
// 1 the query side alone, 2 the key side alone, 3 both.
cudaError_t attention_bwd(const bf16* qkv, const bf16* datt, const bf16* att, const float* m,
                          const float* l, float* delta, bf16* dqkv, int nc, int T, Heads hd,
                          cudaStream_t stream, int sides = 3) {
  if (attention_route(T, hd) == ROUTE_WGMMA) {
    const int rc = with_wgmma_width(hd.DP, [&](auto dp) {
      return awb::train_attention_bwd<decltype(dp)::value>(
          qkv, datt, att, m, l, delta, dqkv, nc, T, hd.H, attn_scale(hd.dh), sides, stream);
    });
    if (rc == 0) {
      wgmma_launches[1] += sides & 1;
      wgmma_launches[2] += (sides >> 1) & 1;
    }
    return (cudaError_t)rc;
  }
  if (hd.NS > 1)
    return with_slab_width(hd.DV, [&](auto dv) {
      return attention_bwd_wide<decltype(dv)::value>(qkv, datt, m, l, delta, dqkv, nc, T, hd,
                                                     stream);
    });
  return with_width(hd.DP, [&](auto dp) {
    return attention_bwd_tile<decltype(dp)::value>(qkv, datt, m, l, delta, dqkv, nc, T, hd,
                                                   stream);
  });
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

FwdBufs fwd_layout(unsigned char* base, Workspace& w, size_t rows, int E, int F, int EA) {
  FwdBufs b;
  b.xn = reinterpret_cast<bf16*>(base + w.take(rows * E * 2));
  b.qkv = reinterpret_cast<bf16*>(base + w.take(rows * 3 * EA * 2));
  b.att = reinterpret_cast<bf16*>(base + w.take(rows * EA * 2));
  b.hact = reinterpret_cast<bf16*>(base + w.take(rows * F * 2));
  return b;
}

// Floats of the attention backward's scratch for nc contexts: delta [nc, H,
// T] (the mma.sync route), or lse and delta [nc H, 2, 256] (the wgmma route).
size_t bwd_scratch(int nc, int T, Heads hd) {
  return (size_t)nc * hd.H * (attention_route(T, hd) == ROUTE_WGMMA ? 2 * aw::T_MAX : T);
}

struct BwdBufs {
  float *dx, *dy32, *mu, *rs, *partial, *m, *l, *delta;
  bf16 *dxb, *xn, *hact, *dh, *qkv, *att, *datt, *dqkv;
};

BwdBufs bwd_layout(unsigned char* base, Workspace& w, int g, int T, int E, int F, Heads hd) {
  const size_t rows = (size_t)g * T;
  const int EA = hd.EA;
  BwdBufs b;
  const bool epilogue = tbg::ln_ranks(E) > 0;
  b.dx = reinterpret_cast<float*>(base + w.take(rows * E * 4));
  // dY in fp32 only where the LN backward runs as separate kernels
  b.dy32 = epilogue ? nullptr : reinterpret_cast<float*>(base + w.take(rows * E * 4));
  b.mu = reinterpret_cast<float*>(base + w.take(rows * 4));
  b.rs = reinterpret_cast<float*>(base + w.take(rows * 4));
  // dW partials: at most the largest splits x stack slice, or the gains'
  size_t part = 0;
  const int K = (int)rows;
  const int shapes[4][2] = {{E, 3 * EA}, {EA, E}, {E, F}, {F, E}};
  for (auto& s : shapes) {
    const size_t need = (size_t)dw_splits(s[0], s[1], K) * s[0] * s[1];
    part = need > part ? need : part;
  }
  const size_t gparts =
      (epilogue ? gemm::cdiv((int)rows, gemm::BM) : (rows + ROWS_PER_PART - 1) / ROWS_PER_PART) * E;
  part = gparts > part ? gparts : part;
  b.partial = reinterpret_cast<float*>(base + w.take(part * 4));
  // the attention's row statistics [g, H, T] each, and the query side's
  // scratch for the key side
  b.m = reinterpret_cast<float*>(base + w.take((size_t)g * hd.H * T * 4));
  b.l = reinterpret_cast<float*>(base + w.take((size_t)g * hd.H * T * 4));
  b.delta = reinterpret_cast<float*>(base + w.take(bwd_scratch(g, T, hd) * 4));
  b.dxb = reinterpret_cast<bf16*>(base + w.take(rows * E * 2));
  b.xn = reinterpret_cast<bf16*>(base + w.take(rows * E * 2));
  b.hact = reinterpret_cast<bf16*>(base + w.take(rows * F * 2));
  b.dh = reinterpret_cast<bf16*>(base + w.take(rows * F * 2));
  b.qkv = reinterpret_cast<bf16*>(base + w.take(rows * 3 * EA * 2));
  b.att = reinterpret_cast<bf16*>(base + w.take(rows * EA * 2));
  b.datt = reinterpret_cast<bf16*>(base + w.take(rows * EA * 2));
  b.dqkv = reinterpret_cast<bf16*>(base + w.take(rows * 3 * EA * 2));
  return b;
}

// n_embd EL is stored in E = EL rounded up to 8 columns, the MLP's 4 EL in F
// (zero columns past EL and 4 EL, which the wrapper adds and drops).
int stored(int n) { return (n + 7) / 8 * 8; }

Heads heads_of(int E, int H) {
  const int dh = E / H;
  const int ns = (dh + 127) / 128;
  const int dv = ((dh + ns - 1) / ns + 15) / 16 * 16;
  return Heads{H, dh, ns, dv, ns * dv, H * ns * dv};
}

bool shape_ok(int T, int E, int H) {
  if (H <= 0 || E % H || T < 1 || E / H > 512) return false;
  const Heads hd = heads_of(E, H);
  return hd.NS == 1 || (attn::wide_window(T, hd.DP, hd.DV) > 0 &&
                        bwd_wide_window(T, hd.DP, false) > 0 && bwd_wide_window(T, hd.DP, true) > 0);
}

int forward_impl(const bf16* x, bf16* out, bf16* xsave, const bf16* wqkv, const bf16* wproj,
                 const bf16* wfc, const bf16* wfc2, const float* g1, const float* g2,
                 unsigned char* ws, int n, int T, int EL, Heads hd, int layers, int last_only,
                 int group, cudaStream_t stream) {
  const int E = stored(EL), EA = hd.EA, E3 = 3 * EA, F = stored(4 * EL);
  const size_t stream_elems = (size_t)n * T * E;
  RETURN_IF_ERROR(cudaMemcpyAsync(xsave, x, stream_elems * 2, cudaMemcpyDeviceToDevice, stream));
  Workspace w;
  const FwdBufs b = fwd_layout(ws, w, (size_t)group * T, E, F, EA);
  for (int c0 = 0; c0 < n; c0 += group) {
    const int nc = n - c0 < group ? n - c0 : group;
    const int M = nc * T;
    for (int l = 0; l < layers; ++l) {
      const bf16* Wqkv = wqkv + (size_t)l * E * E3;
      const bf16* Wproj = wproj + (size_t)l * EA * E;
      const bf16* Wfc = wfc + (size_t)l * E * F;
      const bf16* Wfc2 = wfc2 + (size_t)l * F * E;
      const bf16* xin = xsave + ((size_t)(2 * l) * n + c0) * T * E;
      bf16* xmid = xsave + ((size_t)(2 * l + 1) * n + c0) * T * E;
      RETURN_IF_ERROR(layer_norm(xin, E, g1 + (size_t)l * E, b.xn, E, M, E, EL, stream));
      RETURN_IF_ERROR((gemm::run<false, false>(b.xn, E, Wqkv, E3, M, E3, E, EpiBf16{b.qkv, E3},
                                               stream)));
      RETURN_IF_ERROR(attention_fwd(b.qkv, b.att, nullptr, nullptr, nc, T, hd, stream));
      RETURN_IF_ERROR((gemm::run<false, false>(b.att, EA, Wproj, E, M, E, EA,
                                               EpiResid{xmid, E, xin, E}, stream)));
      const bool last = l == layers - 1;
      if (last && last_only) {
        // only the last position leaves the chunk: its MLP alone
        const bf16* xm_last = xmid + (size_t)(T - 1) * E;
        RETURN_IF_ERROR(layer_norm(xm_last, (long long)T * E, g2 + (size_t)l * E, b.xn, E, nc, E,
                                   EL, stream));
        RETURN_IF_ERROR((gemm::run<false, false>(b.xn, E, Wfc, F, nc, F, E, EpiGelu{b.hact, F},
                                                 stream)));
        RETURN_IF_ERROR((gemm::run<false, false>(
            b.hact, F, Wfc2, E, nc, E, F, EpiResid{out + (size_t)c0 * E, E, xm_last,
                                                   (long long)T * E},
            stream)));
        continue;
      }
      bf16* xnext = last ? out + (size_t)c0 * T * E
                         : xsave + ((size_t)(2 * l + 2) * n + c0) * T * E;
      RETURN_IF_ERROR(layer_norm(xmid, E, g2 + (size_t)l * E, b.xn, E, M, E, EL, stream));
      RETURN_IF_ERROR((gemm::run<false, false>(b.xn, E, Wfc, F, M, F, E, EpiGelu{b.hact, F},
                                               stream)));
      RETURN_IF_ERROR((gemm::run<false, false>(b.hact, F, Wfc2, E, M, E, F,
                                               EpiResid{xnext, E, xmid, E}, stream)));
    }
  }
  return 0;
}

int backward_impl(const bf16* xsave, const bf16* dxin, const bf16* wqkv, const bf16* wproj,
                  const bf16* wfc, const bf16* wfc2, const float* g1, const float* g2, bf16* dx0,
                  float* dwqkv, float* dwproj, float* dwfc, float* dwfc2, float* dg1, float* dg2,
                  unsigned char* ws, int n, int T, int EL, Heads hd, int layers, int group,
                  cudaStream_t stream) {
  const int E = stored(EL), EA = hd.EA, E3 = 3 * EA, F = stored(4 * EL);
  RETURN_IF_ERROR(cudaMemsetAsync(dwqkv, 0, (size_t)layers * E * E3 * 4, stream));
  RETURN_IF_ERROR(cudaMemsetAsync(dwproj, 0, (size_t)layers * EA * E * 4, stream));
  RETURN_IF_ERROR(cudaMemsetAsync(dwfc, 0, (size_t)layers * E * F * 4, stream));
  RETURN_IF_ERROR(cudaMemsetAsync(dwfc2, 0, (size_t)layers * F * E * 4, stream));
  RETURN_IF_ERROR(cudaMemsetAsync(dg1, 0, (size_t)layers * E * 4, stream));
  RETURN_IF_ERROR(cudaMemsetAsync(dg2, 0, (size_t)layers * E * 4, stream));
  Workspace w;
  const BwdBufs b = bwd_layout(ws, w, group, T, E, F, hd);
  for (int c0 = 0; c0 < n; c0 += group) {
    const int nc = n - c0 < group ? n - c0 : group;
    const int M = nc * T;
    const long long elems = (long long)M * E;
    const bf16* dxin_g = dxin + (size_t)c0 * T * E;
    to_f32_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, stream>>>(dxin_g, b.dx, elems);
    RETURN_IF_ERROR(cudaGetLastError());
    RETURN_IF_ERROR(cudaMemcpyAsync(b.dxb, dxin_g, elems * 2, cudaMemcpyDeviceToDevice, stream));
    for (int l = layers - 1; l >= 0; --l) {
      const bf16* Wqkv = wqkv + (size_t)l * E * E3;
      const bf16* Wproj = wproj + (size_t)l * EA * E;
      const bf16* Wfc = wfc + (size_t)l * E * F;
      const bf16* Wfc2 = wfc2 + (size_t)l * F * E;
      const bf16* xin = xsave + ((size_t)(2 * l) * n + c0) * T * E;
      const bf16* xmid = xsave + ((size_t)(2 * l + 1) * n + c0) * T * E;

      // MLP backward: recompute xn2 (and the rows' mu, rstd), then hact and
      // dh in one kernel (hmid stays in its registers)
      RETURN_IF_ERROR(layer_norm(xmid, E, g2 + (size_t)l * E, b.xn, E, M, E, EL, stream, b.mu,
                                 b.rs));
      RETURN_IF_ERROR(mlp_front(b.xn, b.dxb, Wfc, Wfc2, b.hact, b.dh, M, E, F, stream));
      RETURN_IF_ERROR(weight_grad(b.hact, b.dxb, F, E, M, b.partial, dwfc2 + (size_t)l * F * E,
                                  stream));
      RETURN_IF_ERROR(weight_grad(b.xn, b.dh, E, F, M, b.partial, dwfc + (size_t)l * E * F,
                                  stream));
      RETURN_IF_ERROR(ln_backward(b.dh, Wfc, F, xmid, g2 + (size_t)l * E, b.mu, b.rs, b.dx, b.dxb,
                                  b.dy32, b.partial, dg2 + (size_t)l * E, M, E, EL, stream));

      // attention backward (recompute xn1 with mu and rstd, q|k|v, att and p)
      RETURN_IF_ERROR(layer_norm(xin, E, g1 + (size_t)l * E, b.xn, E, M, E, EL, stream, b.mu,
                                 b.rs));
      RETURN_IF_ERROR((gemm::run<false, false>(b.xn, E, Wqkv, E3, M, E3, E, EpiBf16{b.qkv, E3},
                                               stream)));
      RETURN_IF_ERROR(attention_fwd(b.qkv, b.att, b.m, b.l, nc, T, hd, stream));
      RETURN_IF_ERROR(weight_grad(b.att, b.dxb, EA, E, M, b.partial, dwproj + (size_t)l * EA * E,
                                  stream));
      RETURN_IF_ERROR((gemm::run<false, true>(b.dxb, E, Wproj, E, M, EA, E, EpiBf16{b.datt, EA},
                                              stream)));
      RETURN_IF_ERROR(attention_bwd(b.qkv, b.datt, b.att, b.m, b.l, b.delta, b.dqkv, nc, T, hd,
                                    stream));
      RETURN_IF_ERROR(weight_grad(b.xn, b.dqkv, E, E3, M, b.partial, dwqkv + (size_t)l * E * E3,
                                  stream));
      // the bottom layer's bf16(dx) is the chunk's output
      bf16* dxb_out = l == 0 ? dx0 + (size_t)c0 * T * E : b.dxb;
      RETURN_IF_ERROR(ln_backward(b.dqkv, Wqkv, E3, xin, g1 + (size_t)l * E, b.mu, b.rs, b.dx,
                                  dxb_out, b.dy32, b.partial, dg1 + (size_t)l * E, M, E, EL,
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
  const Heads hd = heads_of(E, H);
  if (kind == 0)
    fwd_layout(nullptr, w, (size_t)group * T, stored(E), stored(4 * E), hd.EA);
  else
    bwd_layout(nullptr, w, group, T, stored(E), stored(4 * E), hd);
  return (long long)w.bytes;
}

// Forward of a chunk of `layers` layers on n contexts, on `stream`, in
// groups of `group`: x [n, T, E] -> out [n, T, E] (or [n, E], the last
// position, when last_only) and xsave [2 layers, n, T, E].  Weights, heads
// padded to DP columns (EA = H DP): wqkv [layers, E, 3 EA], wproj [layers,
// EA, E], wfc [layers, E, 4E], wfc2 [layers, 4E, E] bf16; g1, g2 [layers,
// E] fp32.  Returns the first CUDA error of a launch (0 = all launched).
int fused_train_forward(const bf16* x, bf16* out, bf16* xsave, const bf16* wqkv,
                        const bf16* wproj, const bf16* wfc, const bf16* wfc2, const float* g1,
                        const float* g2, void* workspace, int n, int T, int E, int H, int layers,
                        int last_only, int group, cudaStream_t stream) {
  if (!shape_ok(T, E, H) || group <= 0 || layers <= 0) return (int)cudaErrorInvalidValue;
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  const Heads hd = heads_of(E, H);
  return forward_impl(x, out, xsave, wqkv, wproj, wfc, wfc2, g1, g2, ws, n, T, E, hd, layers,
                      last_only, group, stream);
}

// Backward of a chunk: xsave [2 layers, n, T, E] and dxin [n, T, E] (the
// gradient of the chunk's output stream) -> dx0 [n, T, E] bf16 and the fp32
// gradients of the stacks (dwqkv .. dg2, the padded stacks' shapes), summed
// over all n contexts in a fixed order.
int fused_train_backward(const bf16* xsave, const bf16* dxin, const bf16* wqkv,
                         const bf16* wproj, const bf16* wfc, const bf16* wfc2, const float* g1,
                         const float* g2, bf16* dx0, float* dwqkv, float* dwproj, float* dwfc,
                         float* dwfc2, float* dg1, float* dg2, void* workspace, int n, int T,
                         int E, int H, int layers, int group, cudaStream_t stream) {
  if (!shape_ok(T, E, H) || group <= 0 || layers <= 0) return (int)cudaErrorInvalidValue;
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  const Heads hd = heads_of(E, H);
  return backward_impl(xsave, dxin, wqkv, wproj, wfc, wfc2, g1, g2, dx0, dwqkv, dwproj, dwfc,
                       dwfc2, dg1, dg2, ws, n, T, E, hd, layers, group, stream);
}

// The GEMM alone, for its checks and its timing beside cuBLAS: C [M, N] =
// op(A) op(B) with A stored [M, K] or (a_mn) [K, M], B stored [K, N] or
// (b_k) [N, K], every row stride the stored row's length; out 0: C bf16, 1:
// fp32 as `splits` partials [splits, M, N] over the split K, 2: C =
// bf16(gelu_tanh(product)), the forward's EpiGelu.
int fused_train_gemm(const bf16* A, const bf16* B, void* C, int M, int N, int K, int a_mn,
                     int b_k, int out, int splits, cudaStream_t stream) {
  const long long lda = a_mn ? M : K, ldb = b_k ? K : N;
  cudaError_t err;
  auto run = [&](auto epi) {
    if (a_mn && b_k) return gemm::run<true, true>(A, lda, B, ldb, M, N, K, epi, stream, splits);
    if (a_mn) return gemm::run<true, false>(A, lda, B, ldb, M, N, K, epi, stream, splits);
    if (b_k) return gemm::run<false, true>(A, lda, B, ldb, M, N, K, epi, stream, splits);
    return gemm::run<false, false>(A, lda, B, ldb, M, N, K, epi, stream, splits);
  };
  if (out == 1)
    err = run(EpiF32{static_cast<float*>(C), N, (long long)M * N});
  else if (splits != 1 || (out != 0 && out != 2))
    err = cudaErrorInvalidValue;
  else if (out == 2)
    err = run(EpiGelu{static_cast<bf16*>(C), N});
  else
    err = run(EpiBf16{static_cast<bf16*>(C), N});
  return (int)err;
}

// The attention's route for T, n_embd E and H heads (0 the wgmma kernels, 1
// the mma.sync tiles, 2 the slabs), -1 for a shape the kernels do not take.
int fused_train_attention_route(int T, int E, int H) {
  return shape_ok(T, E, H) ? (int)attention_route(T, heads_of(E, H)) : -1;
}

// The training attention alone, for its checks and timing (the trainer runs
// it inside fused_train_forward and fused_train_backward): qkv [nc, T, 3 EA]
// (heads padded to DP columns, EA = H DP) -> att [nc, T, EA] and, when m is
// not null, the rows' statistics m, l [nc, H, T].
int fused_train_attention_fwd(const bf16* qkv, bf16* att, float* m, float* l, int nc, int T,
                              int E, int H, cudaStream_t stream) {
  if (!shape_ok(T, E, H) || nc < 0) return (int)cudaErrorInvalidValue;
  if (nc == 0) return 0;
  return (int)attention_fwd(qkv, att, m, l, nc, T, heads_of(E, H), stream);
}

// Floats of the scratch fused_train_attention_bwd takes for nc contexts.
long long fused_train_attention_scratch(int nc, int T, int E, int H) {
  return shape_ok(T, E, H) ? (long long)bwd_scratch(nc, T, heads_of(E, H)) : -1;
}

// dqkv [nc, T, 3 EA] from qkv, datt [nc, T, EA], the forward's att and m, l
// (fused_train_attention_fwd); sides as attention_bwd.
int fused_train_attention_bwd(const bf16* qkv, const bf16* datt, const bf16* att,
                              const float* m, const float* l, float* scratch, bf16* dqkv,
                              int nc, int T, int E, int H, int sides, cudaStream_t stream) {
  if (!shape_ok(T, E, H) || nc < 0 || sides < 1 || sides > 3) return (int)cudaErrorInvalidValue;
  if (nc == 0) return 0;
  return (int)attention_bwd(qkv, datt, att, m, l, scratch, dqkv, nc, T, heads_of(E, H), stream,
                            sides);
}

// The backward's MLP front alone, for its checks and timing: hact, dh [M, F]
// bf16 from xn2, dxb [M, E], wfc [E, F], wfc2 [F, E], every row dense.
int fused_train_mlp_front(const bf16* xn2, const bf16* dxb, const bf16* wfc, const bf16* wfc2,
                          bf16* hact, bf16* dh, int M, int E, int F, cudaStream_t stream) {
  return (int)mlp_front(xn2, dxb, wfc, wfc2, hact, dh, M, E, F, stream);
}

// Ranks of the LN epilogue's cluster for a stored n_embd E (1: a CTA owns
// whole rows), 0 where the LN backward runs as separate kernels.
int fused_train_ln_route(int E) { return E >= 1 ? tbg::ln_ranks(E) : -1; }

// The backward's LN epilogue alone, for its checks and timing, at a width
// the route takes: dx [M, E] fp32 += LN_bwd(A W^T) for y = LN(x) * g (A
// [M, K], W [E, K], x [M, E] bf16, g [E], the rows' mu and rstd [M], the
// first EL columns normalised), dxb = bf16(dx), dg [E] += the gain
// gradient; partial: scratch of ceil(M / 128) E floats.
int fused_train_ln_dx(const bf16* A, const bf16* W, const bf16* x, const float* g,
                      const float* mu, const float* rs, float* dx, bf16* dxb, float* partial,
                      float* dg, int M, int E, int K, int EL, cudaStream_t stream) {
  if (tbg::ln_ranks(E) < 1) return (int)cudaErrorInvalidValue;
  return (int)ln_backward(A, W, K, x, g, mu, rs, dx, dxb, nullptr, partial, dg, M, E, EL,
                          stream);
}

// Launches of the backward's epilogue kernels since the last reset: kind 0
// mlp_front_kernel, 1 ln_dx_kernel; kind -1 resets both to 0 and returns 0.
long long fused_train_bwd_gemm_launches(int kind) {
  if (kind == -1) {
    bwd_gemm_launches[0] = bwd_gemm_launches[1] = 0;
    return 0;
  }
  return kind >= 0 && kind < 2 ? bwd_gemm_launches[kind] : -1;
}

// Launches of the wgmma route's kernels since the last reset: kind 0 the
// forward (with or without statistics), 1 attn_bwd_q_wgmma, 2
// attn_bwd_kv_wgmma; kind -1 resets all three to 0 and returns 0.
long long fused_train_wgmma_launches(int kind) {
  if (kind == -1) {
    wgmma_launches[0] = wgmma_launches[1] = wgmma_launches[2] = 0;
    return 0;
  }
  return kind >= 0 && kind < 3 ? wgmma_launches[kind] : -1;
}

const char* fused_train_error_string(int code) {
  if (code == aw::ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled is not available (the wgmma attention's TMA)";
  if (code == aw::ERR_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused an attention tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
