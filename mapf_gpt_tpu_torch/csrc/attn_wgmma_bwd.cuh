// The training attention's backward for Hopper (sm_90a) on wgmma, TMA and
// warp specialisation: the attention part of
// mapf_gpt_tpu/ops/fused_gpt_train.py::_bwd_kernel, run by csrc/fused_train.cu
// after the recompute (csrc/attn_wgmma.cuh's forward through TrainIo, which
// leaves each row's statistics m and l), for heads padded to 16, 32, 48 or
// 64 columns at T <= 256.  Per (context, head) pair, with c2 = scale * log2(e):
//   p_ij = 2^(s_ij c2 - lse_i),  lse_i = m_i + log2(l_i)   (s = q k^T in fp32)
//   delta_i = sum_d dA_id att_id                            (fp32)
//   ds_ij = bf16(((dp_ij - delta_i) p_ij) scale),  dp = dA v^T   (fp32)
//   dq = bf16(ds k),  dk = bf16(ds^T q),  dv = bf16(bf16(p)^T dA)
// delta is rowsum(dA * att), att the forward's bf16 output, and not JAX's sum
// over the keys of dp * p (fused_gpt_train.py:223); the two are equal but for
// the roundings of p and att (PERF.md has by how much), and this one needs no
// pass over the keys.  The plain PyTorch version is
// mapf_gpt_tpu_torch/ops/fused_gpt_train.py::train_attention_backward_reference.
//
// Bound: per pair 6 T^2 D (query side) and 8 T^2 D (key side) bf16 FLOP
// against about 12 T D bytes each way and T^2 exp2s a side on the
// special-function units (16 a clock an SM): at the models' head dims the
// exp2s and the bytes come close (chip_smoke.py logs both floors).  Two
// deterministic kernels, no atomics, no T x T buffer:
//   * attn_bwd_q_wgmma, one 64-row query tile an item: delta from dA (shared
//     memory) and att (device memory); lse from m and l, both written for the
//     key side ([pair, 2, 256]); then over chunks of NQ keys: S = Q K^T and
//     dP = dA V^T by wgmma from shared memory (m64nNQ), ds on the
//     accumulators, dq += ds K with ds as the register A operand and K read
//     N-major, as the forward reads V;
//   * attn_bwd_kv_wgmma, one 64-key tile an item: over chunks of NK queries,
//     S^T = K Q^T and dP^T = V dA^T, p^T and ds^T from the chunk's lse and
//     delta (staged beside the pair's tiles), dv += bf16(p^T) dA and dk +=
//     ds^T Q with dA and Q read N-major;
//   * both persistent (one CTA an SM walks the pairs with a stride of the
//     grid), one producer thread filling a ring of SLOTS tile-sized slots by
//     TMA (a pair's Q, K, V and dA take four consecutive slots, so the next
//     pair's first tiles load while this pair runs; every box is 256 rows,
//     zero-filled past T), a "full" and an "empty" mbarrier a slot, two
//     consumer warpgroups taking the pair's 64-row tiles in turn; the
//     outputs are rounded in registers, written over the tile's own rows (Q
//     for dq, K and V for dk and dv) and stored by TMA, which clips rows
//     past T;
//   * each chunk's second products (dq, or dv and dk) are committed
//     without a wait and run under the next chunk's first (S and dP, or S^T
//     and dP^T); the A fragments they read are held in their registers
//     until the wait for both (hold);
//   * chunks sized for 168 registers a thread.  A block is the two
//     consumer warpgroups and one producer warp, 288 threads, and ptxas
//     gives its threads 168 registers: what 65536 registers give twelve
//     warps, most likely because nine warps are allocated as whole
//     warpgroups.  Chunks of 128 keys or queries (two m64n128
//     accumulators, 128 registers a thread, with dq, or dk and dv, beside
//     them) spilled 24-916 bytes there (tools/attn_probe.py --regs), and
//     also in a 384-thread build with setmaxnreg raising the consumers to
//     240, which is not explained (setmaxnreg's placement?); so a
//     query-side chunk is 64 keys (32 at D >= 48, where dq takes 24-32
//     registers) and a key-side chunk 32 queries.
// Keys (query side) and queries (key side) past T are masked; what lies past
// T in the statistics is never read unmasked.

#pragma once

#include "attn_wgmma.cuh"

namespace awb {

using aw::bf16;
using aw::Geo;
using aw::ROWS;
using aw::T_MAX;

constexpr int THREADS = 288;   // two consumer warpgroups and a producer warp

template <int D>
struct BGeo {
  static constexpr int RB = Geo<D>::RB, BOX = Geo<D>::BOX, TILE = Geo<D>::TILE;
  // slots of one tile; a pair takes four
  static constexpr int SLOTS = RB == 128 ? 6 : RB == 64 ? 12 : 16;
  static constexpr int ROWBUF = 2 * T_MAX * 4;   // a pair's lse and delta, beside each slot
  static constexpr int NQ = D >= 48 ? 32 : 64;   // keys of a query-side chunk
  static constexpr int NK = 32;                   // queries of a key-side chunk
  static constexpr int SMEM = SLOTS * (TILE + ROWBUF) + 2 * SLOTS * 8 + 1024;
};
static_assert(BGeo<64>::SMEM <= 232448 && BGeo<32>::SMEM <= 232448 &&
                  BGeo<16>::SMEM <= 232448,
              "a block's shared memory");

#define AB_ACC4(C, d, j) C(d[j][0]), C(d[j][1]), C(d[j][2]), C(d[j][3])
#define AB_ACC8(C, d) AB_ACC4(C, d, 0), AB_ACC4(C, d, 1)
#define AB_ACC16(C, d) AB_ACC8(C, d), AB_ACC4(C, d, 2), AB_ACC4(C, d, 3)
#define AB_ACC32(C, d) AB_ACC16(C, d), AB_ACC4(C, d, 4), AB_ACC4(C, d, 5), AB_ACC4(C, d, 6), \
                       AB_ACC4(C, d, 7)
#define AB_ACC64(C, d) AB_ACC32(C, d), AB_ACC4(C, d, 8), AB_ACC4(C, d, 9), AB_ACC4(C, d, 10), \
                       AB_ACC4(C, d, 11), AB_ACC4(C, d, 12), AB_ACC4(C, d, 13), \
                       AB_ACC4(C, d, 14), AB_ACC4(C, d, 15)
#define AB_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define AB_R32                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define AB_R64                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
// d (+)= A B^T, m64nNk16, bf16, A and B K-major in shared memory: C "=f" and
// ACC 0 overwrite d, C "+f" and ACC 1 add to it
#define AB_SS(N, RL, ACCL, IA, IB, IS, C, ACC)                                        \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"                        \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32.bf16.bf16 " RL          \
               ", %" IA ", %" IB ", p, 1, 1, 0, 0;\n}\n"                               \
               : ACCL(C, d)                                                           \
               : "l"(a), "l"(b), "r"(ACC))

template <int N, bool ACC>
__device__ __forceinline__ void ss(float (*d)[4], uint64_t a, uint64_t b) {
  static_assert(N == 32 || N == 64 || N == 128, "chunks of 32, 64 or 128");
  if constexpr (N == 128) {
    if constexpr (ACC)
      AB_SS("128", AB_R64, AB_ACC64, "64", "65", "66", "+f", 1);
    else
      AB_SS("128", AB_R64, AB_ACC64, "64", "65", "66", "=f", 0);
  } else if constexpr (N == 64) {
    if constexpr (ACC)
      AB_SS("64", AB_R32, AB_ACC32, "32", "33", "34", "+f", 1);
    else
      AB_SS("64", AB_R32, AB_ACC32, "32", "33", "34", "=f", 0);
  } else {
    if constexpr (ACC)
      AB_SS("32", AB_R16, AB_ACC16, "16", "17", "18", "+f", 1);
    else
      AB_SS("32", AB_R16, AB_ACC16, "16", "17", "18", "=f", 0);
  }
}

// d = A B^T over the head's D / 16 slices of 16: A rows at `a` (64 of them),
// B rows at `b` (N), both as TMA staged them
template <int D, int N>
__device__ __forceinline__ void products(float (*d)[4], const unsigned char* a,
                                         const unsigned char* b) {
  ss<N, false>(d, aw::desc<D>(a), aw::desc<D>(b));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    ss<N, true>(d, aw::desc<D>(a + 32 * kk), aw::desc<D>(b + 32 * kk));
}

// a pair's operands: q|k|v [nc, T, 3 EA] as (D, 3 H, T, nc), dA [nc, T, EA]
// as (D, H, T, nc), both in boxes of 256 rows; dq|dk|dv as q|k|v in boxes of
// 16 rows (a warp's); att read by the query side's threads.
struct BwdIo {
  CUtensorMap qkv, datt, dqkv;
  const bf16* att;
  const float *m, *l;   // the forward's statistics [pairs, T]
  float* rows;          // [pairs, 2, 256]: lse, then delta (query side -> key side)
  int H, T, EA;
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(gemm::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(gemm::smem_u32(bar))
      : "memory");
}

// s + the dot product of 8 bf16 pairs (a from device memory, b from shared)
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b, float s) {
  const unsigned x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), s);
    s = fmaf(__uint_as_float(x[i] & 0xffff0000u), __uint_as_float(y[i] & 0xffff0000u), s);
  }
  return s;
}

// Keeps A fragments that a wgmma issued earlier still reads in their
// registers up to here (after the wait for it): the compiler takes a
// register operand as read when the instruction is issued.
template <int N>
__device__ __forceinline__ void hold(const unsigned (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(a[kk][i]));
}

// acc rounded to bf16 into the warp's 16 rows of the tile at `rows` (free
// once its products are done), in TMA's swizzle
template <int D>
__device__ __forceinline__ void stage_out(unsigned char* rows, const float (*acc)[4]) {
  constexpr int RB = BGeo<D>::RB;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int n = 0; n < BGeo<D>::BOX / 8; ++n) {
    const unsigned off = (warp * 16 + g) * RB + n * 16 + c4 * 4;
    *reinterpret_cast<unsigned*>(rows + aw::swz<D>(off)) =
        aw::Elem<bf16>::pack(acc[n][0], acc[n][1]);
    *reinterpret_cast<unsigned*>(rows + aw::swz<D>(off + 8 * RB)) =
        aw::Elem<bf16>::pack(acc[n][2], acc[n][3]);
  }
}

// The query side's 64-row tile t of pair `pair`: tl = the pair's Q, K, V, dA.
template <int D>
__device__ __forceinline__ void q_tile(const BwdIo& io, int pair, int t, float scale,
                                       unsigned char* const* tl) {
  using G = BGeo<D>;
  constexpr int NC = G::NQ, NT = NC / 8;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int T = io.T, ctx = pair / io.H, h = pair % io.H;
  const float c2 = scale * aw::LOG2E;
  unsigned char* qt = tl[0] + t * ROWS * G::RB;
  const unsigned char* ks = tl[1];
  const unsigned char* vs = tl[2];
  const unsigned char* dat = tl[3] + t * ROWS * G::RB;

  // the thread's rows g and g + 8 of the warp's 16: their att (16-byte
  // chunks, the quad's lanes in turn), m and l, loaded before the first
  // products are issued and used while they run
  constexpr int CH = (D / 8 + 3) / 4;   // a lane's chunks of a row
  uint4 av[2][CH];
  float mv[2] = {0.f, 0.f}, lv[2] = {1.f, 1.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t * ROWS + warp * 16 + g + 8 * r;
    const bf16* ar = io.att + ((size_t)ctx * T + row) * io.EA + h * D;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      av[r][i] = make_uint4(0, 0, 0, 0);
      if (row < T && c4 + 4 * i < D / 8)
        av[r][i] = *reinterpret_cast<const uint4*>(ar + (c4 + 4 * i) * 8);
    }
    if (row < T) {
      mv[r] = io.m[(size_t)pair * T + row];
      lv[r] = io.l[(size_t)pair * T + row];
    }
  }
  float lse[2], dl[2];
  float dq[G::BOX / 8][4];
  unsigned da[NT / 2][4];   // ds of a chunk, the A fragments of 16 keys
#pragma unroll
  for (int n = 0; n < G::BOX / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  // a chunk's dq products run under the next chunk's S and dP products
#pragma unroll
  for (int c = 0; c < T_MAX / NC; ++c) {
    const int c0 = c * NC;
    if (c0 >= T) break;
    // S = Q K^T and dP = dA V^T over the chunk's keys
    float s[NT][4], dp[NT][4];
    wg::fence();
    products<D, NC>(s, qt, ks + c0 * G::RB);
    products<D, NC>(dp, dat, vs + c0 * G::RB);
    wg::commit();
    if (c == 0) {
      // while the first products run: delta = dA . att and lse = m + log2 l
      // of the thread's rows (0 past T, where att, m and l read as 0, 0, 1),
      // stored for the key side
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int tr = warp * 16 + g + 8 * r, row = t * ROWS + tr;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < CH; ++i)
          if (c4 + 4 * i < D / 8)
            part = dot8(av[r][i], *reinterpret_cast<const uint4*>(
                                      dat + aw::swz<D>(tr * G::RB + (c4 + 4 * i) * 16)),
                        part);
        lse[r] = mv[r] + log2f(lv[r]);
        dl[r] = aw::quad_sum(part);
        if (c4 == 0 && row < T) {
          io.rows[(size_t)pair * 2 * T_MAX + row] = lse[r];
          io.rows[(size_t)pair * 2 * T_MAX + T_MAX + row] = dl[r];
        }
      }
    }
    wg::wait<0>();   // these products and the last chunk's dq products
    if (c > 0) hold<NT / 2>(da);
    wg::fence_operands<NT>(s);
    wg::fence_operands<NT>(dp);
    wg::fence_operands<G::BOX / 8>(dq);
    // ds on the accumulators ((j, e): key c0 + 8 j + 2 c4 + (e & 1) of row
    // g + 8 (e >> 1)), keys past T masked; packed as the A fragments of 16 keys
    const bool edge = c0 + NC > T;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = aw::ex2(fmaf(s[j][e], c2, -lse[e >> 1]));
        if (edge && c0 + j * 8 + 2 * c4 + (e & 1) >= T) p = 0.f;
        s[j][e] = ((dp[j][e] - dl[e >> 1]) * p) * scale;
      }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const float* lo = s[2 * kk];
      const float* hi = s[2 * kk + 1];
      da[kk][0] = aw::Elem<bf16>::pack(lo[0], lo[1]);
      da[kk][1] = aw::Elem<bf16>::pack(lo[2], lo[3]);
      da[kk][2] = aw::Elem<bf16>::pack(hi[0], hi[1]);
      da[kk][3] = aw::Elem<bf16>::pack(hi[2], hi[3]);
    }
    // dq += ds K, K the B operand read N-major
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      aw::Elem<bf16>::template rs<G::BOX>(dq, da[kk], aw::desc<D>(ks + (c0 + kk * 16) * G::RB));
    wg::commit();
    wg::fence_operands<G::BOX / 8>(dq);
  }
  wg::wait<0>();
  hold<NT / 2>(da);
  wg::fence_operands<G::BOX / 8>(dq);

  // dq over the tile's Q rows (read by this tile alone), one bulk store a warp
  stage_out<D>(qt, dq);
  wg::fence_proxy();
  __syncwarp();
  if (lane == 0) {
    aw::tma_store_4d(&io.dqkv, qt + warp * 16 * G::RB, 0, h, t * ROWS + warp * 16, ctx);
    gemm::bulk_commit();
  }
}

// The key side's 64-key tile t of pair `pair`: tl = the pair's Q, K, V, dA;
// rows its lse and delta.
template <int D>
__device__ __forceinline__ void kv_tile(const BwdIo& io, int pair, int t, float scale,
                                        unsigned char* const* tl, const float* rows) {
  using G = BGeo<D>;
  constexpr int NC = G::NK, NT = NC / 8;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = threadIdx.x & 31;
  const int c4 = lane & 3;
  const int T = io.T, ctx = pair / io.H, h = pair % io.H;
  const float c2 = scale * aw::LOG2E;
  const unsigned char* qs = tl[0];
  unsigned char* kt = tl[1] + t * ROWS * G::RB;
  unsigned char* vt = tl[2] + t * ROWS * G::RB;
  const unsigned char* das = tl[3];

  float dk[G::BOX / 8][4], dv[G::BOX / 8][4];
  unsigned pa[NT / 2][4], sa[NT / 2][4];   // p^T and ds^T, A fragments of 16 queries
#pragma unroll
  for (int n = 0; n < G::BOX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  // a chunk's dv and dk products run under the next chunk's S^T and dP^T
#pragma unroll
  for (int c = 0; c < T_MAX / NC; ++c) {
    const int c0 = c * NC;
    if (c0 >= T) break;
    // S^T = K Q^T and dP^T = V dA^T over the chunk's queries
    float st[NT][4], dpt[NT][4];
    wg::fence();
    products<D, NC>(st, kt, qs + c0 * G::RB);
    products<D, NC>(dpt, vt, das + c0 * G::RB);
    wg::commit();
    wg::wait<0>();   // these products and the last chunk's dv and dk products
    if (c > 0) {
      hold<NT / 2>(pa);
      hold<NT / 2>(sa);
    }
    wg::fence_operands<NT>(st);
    wg::fence_operands<NT>(dpt);
    wg::fence_operands<G::BOX / 8>(dv);
    wg::fence_operands<G::BOX / 8>(dk);
    // p^T and ds^T ((j, e): query c0 + 8 j + 2 c4 + (e & 1)), queries past T
    // masked (their lse and delta are not the forward's)
    const bool edge = c0 + NC > T;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int q0 = c0 + j * 8 + 2 * c4;
      const float2 lq = *reinterpret_cast<const float2*>(rows + q0);
      const float2 dlq = *reinterpret_cast<const float2*>(rows + T_MAX + q0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = aw::ex2(fmaf(st[j][e], c2, -((e & 1) ? lq.y : lq.x)));
        float ds = ((dpt[j][e] - ((e & 1) ? dlq.y : dlq.x)) * p) * scale;
        if (edge && q0 + (e & 1) >= T) p = ds = 0.f;
        st[j][e] = p;
        dpt[j][e] = ds;
      }
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      pa[kk][0] = aw::Elem<bf16>::pack(st[2 * kk][0], st[2 * kk][1]);
      pa[kk][1] = aw::Elem<bf16>::pack(st[2 * kk][2], st[2 * kk][3]);
      pa[kk][2] = aw::Elem<bf16>::pack(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[kk][3] = aw::Elem<bf16>::pack(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      sa[kk][0] = aw::Elem<bf16>::pack(dpt[2 * kk][0], dpt[2 * kk][1]);
      sa[kk][1] = aw::Elem<bf16>::pack(dpt[2 * kk][2], dpt[2 * kk][3]);
      sa[kk][2] = aw::Elem<bf16>::pack(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      sa[kk][3] = aw::Elem<bf16>::pack(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
    }
    // dv += bf16(p^T) dA and dk += ds^T Q, dA and Q the B operands read N-major
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const int off = (c0 + kk * 16) * G::RB;
      aw::Elem<bf16>::template rs<G::BOX>(dv, pa[kk], aw::desc<D>(das + off));
      aw::Elem<bf16>::template rs<G::BOX>(dk, sa[kk], aw::desc<D>(qs + off));
    }
    wg::commit();
    wg::fence_operands<G::BOX / 8>(dv);
    wg::fence_operands<G::BOX / 8>(dk);
  }
  wg::wait<0>();
  hold<NT / 2>(pa);
  hold<NT / 2>(sa);
  wg::fence_operands<G::BOX / 8>(dv);
  wg::fence_operands<G::BOX / 8>(dk);

  // dk over the tile's K rows, dv over its V rows (read by this tile alone)
  stage_out<D>(kt, dk);
  stage_out<D>(vt, dv);
  wg::fence_proxy();
  __syncwarp();
  if (lane == 0) {
    const int row = t * ROWS + warp * 16;
    aw::tma_store_4d(&io.dqkv, kt + warp * 16 * G::RB, 0, io.H + h, row, ctx);
    aw::tma_store_4d(&io.dqkv, vt + warp * 16 * G::RB, 0, 2 * io.H + h, row, ctx);
    gemm::bulk_commit();
  }
}

// The persistent pipeline both kernels share: the producer thread loads each
// pair's Q, K, V and dA into the next four slots (the key side its lse and
// delta with Q); the consumer warpgroups take the pair's 64-row tiles in
// turn and free its slots when both are done with it.
template <int D, bool KV>
__device__ __forceinline__ void pipeline(const BwdIo& io, int pairs, float scale) {
  using G = BGeo<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* rowbuf = reinterpret_cast<float*>(smem + G::SLOTS * G::TILE);   // [SLOTS][512]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::SLOTS * (G::TILE + G::ROWBUF));
  uint64_t* empty = full + G::SLOTS;
  const int cw = threadIdx.x >> 7;
  const int nt = (io.T + ROWS - 1) / ROWS;   // 64-row tiles of a pair

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::SLOTS; ++s) {
      gemm::mbar_init(&full[s], 1);
      gemm::mbar_init(&empty[s], 2);   // each consumer warpgroup frees the slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (cw == 2) {
    // producer: one thread keeps the ring full
    if (threadIdx.x != 256) return;
    int n = 0;
    for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
      const int ctx = pair / io.H, h = pair % io.H;
      for (int i = 0; i < 4; ++i, ++n) {
        const int s = n % G::SLOTS;
        gemm::mbar_wait(&empty[s], ((n / G::SLOTS) & 1) ^ 1);
        const bool rows = KV && i == 0;
        gemm::mbar_expect_tx(&full[s], G::TILE + (rows ? G::ROWBUF : 0));
        unsigned char* dst = smem + s * G::TILE;
        if (i < 3)
          aw::tma_load_4d(dst, &io.qkv, &full[s], 0, i * io.H + h, 0, ctx);
        else
          aw::tma_load_4d(dst, &io.datt, &full[s], 0, h, 0, ctx);
        if (rows)
          bulk_load(rowbuf + s * 2 * T_MAX, io.rows + (size_t)pair * 2 * T_MAX, G::ROWBUF,
                    &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup cw takes the CTA's tiles cw, cw + 2, ...
  int item = 0, n = 0;
  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x, n += 4) {
    unsigned char* tl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = (n + i) % G::SLOTS;
      gemm::mbar_wait(&full[s], ((n + i) / G::SLOTS) & 1);
      tl[i] = smem + s * G::TILE;
    }
    for (int t = 0; t < nt; ++t, ++item)
      if ((item & 1) == cw) {
        if constexpr (KV)
          kv_tile<D>(io, pair, t, scale, tl, rowbuf + (n % G::SLOTS) * 2 * T_MAX);
        else
          q_tile<D>(io, pair, t, scale, tl);
      }
    // the pair's stores have read its slots, and its writes there come
    // before TMA's next writes; then free them
    if ((threadIdx.x & 31) == 0) gemm::bulk_wait<true>();
    wg::fence_proxy();
    gemm::wg_barrier(1 + cw);
    if ((threadIdx.x & 127) == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) gemm::mbar_arrive(&empty[(n + i) % G::SLOTS]);
  }
  if ((threadIdx.x & 31) == 0) gemm::bulk_wait<false>();   // the last stores have landed
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_q_wgmma(const __grid_constant__ BwdIo io, int pairs, float scale) {
  pipeline<D, false>(io, pairs, scale);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_kv_wgmma(const __grid_constant__ BwdIo io, int pairs, float scale) {
  pipeline<D, true>(io, pairs, scale);
}

// dqkv [nc, T, 3 EA] (dq|dk|dv, EA = H D) from qkv, datt [nc, T, EA], the
// forward's att [nc, T, EA] and statistics m, l [nc, H, T]; rows [nc H, 2,
// 256] fp32 is the query side's output for the key side.  sides: 1 the query
// side, 2 the key side (which reads what the query side wrote in rows), 3
// both.  1 <= T <= 256.  Returns 0, a CUDA error or aw::ERR_*.
template <int D>
int train_attention_bwd(const bf16* qkv, const bf16* datt, const bf16* att, const float* m,
                        const float* l, float* rows, bf16* dqkv, int nc, int T, int H,
                        float scale, int sides, cudaStream_t stream) {
  if (T < 1 || T > T_MAX) return (int)cudaErrorInvalidValue;
  BwdIo io;
  const cuuint64_t ea = (cuuint64_t)H * D;
  const cuuint64_t dq[4] = {(cuuint64_t)D, 3 * (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)nc};
  const cuuint64_t sq[3] = {D * 2, 3 * ea * 2, 3 * ea * 2 * T};
  const cuuint64_t da[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)nc};
  const cuuint64_t sa[3] = {D * 2, ea * 2, ea * 2 * T};
  int rc = aw::encode<D>(&io.qkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qkv, dq, sq, 2, T_MAX);
  if (rc == 0)
    rc = aw::encode<D>(&io.datt, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, datt, da, sa, 2, T_MAX);
  if (rc == 0) rc = aw::encode<D>(&io.dqkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dqkv, dq, sq, 2, 16);
  if (rc != 0) return rc;
  io.att = att;
  io.m = m;
  io.l = l;
  io.rows = rows;
  io.H = H;
  io.T = T;
  io.EA = (int)ea;
  const int pairs = nc * H;
  if (pairs == 0) return 0;
  const int grid = pairs < gemm::sm_count() ? pairs : gemm::sm_count();
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if (sides & 1) {
    if ((err = cudaFuncSetAttribute(attn_bwd_q_wgmma<D>, attr, BGeo<D>::SMEM)) != cudaSuccess)
      return (int)err;
    attn_bwd_q_wgmma<D><<<grid, THREADS, BGeo<D>::SMEM, stream>>>(io, pairs, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (sides & 2) {
    if ((err = cudaFuncSetAttribute(attn_bwd_kv_wgmma<D>, attr, BGeo<D>::SMEM)) != cudaSuccess)
      return (int)err;
    attn_bwd_kv_wgmma<D><<<grid, THREADS, BGeo<D>::SMEM, stream>>>(io, pairs, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

#undef AB_ACC4
#undef AB_ACC8
#undef AB_ACC16
#undef AB_ACC32
#undef AB_ACC64
#undef AB_R16
#undef AB_R32
#undef AB_R64
#undef AB_SS

}  // namespace awb
