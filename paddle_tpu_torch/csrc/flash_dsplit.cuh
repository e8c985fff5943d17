// Flash attention at head dims D > 128 for Hopper (sm_90a): the D-split
// forms of the forward (flash_attn_fwd.cu) and of the backward's dkv and dq
// kernels (flash_attn_bwd.cu), each in an f32 form (3xTF32 on mma.sync
// m16n8k8) and a bf16 form (mma.sync m16n8k16, the AMP rule's roundings).
//
// Replaces the same TPU kernels as the D <= 128 forms: the library flash
// kernels behind paddle_tpu/parallel/ring.py::_pallas_flash, which take any
// head dim. The contract is the one the rest of the two files state
// (ops/flash_attention.py's module docstring): masks, lse = +1e30 and out = 0
// on a row with no visible key, dk/dv/dq exact zeros past the lengths, and in
// the bf16 forms p rounded to bf16 before P.V and dV, dS before dK and dQ,
// out, dq, dk and dv rounded once at the end.
//
// Why a D-split: the D <= 128 kernels keep a block's whole head dim in
// shared memory and its output rows in registers. At D = 256 the f32
// forward's Q planes and K/V ring need ~400 KB of shared memory, the bf16
// forward's 128 x 128 tiles ~448 KB, and the bf16 dkv's accumulators ~256
// registers a thread. Here:
// - D is padded (by the wrapper) to a multiple of DS = 64, and the grid has
//   one more axis, over chunks of the OUTPUT's head dims: DC_FWD = 128 for
//   the forward's O, DS = 64 for the backward's dK, dV and dQ (the dkv
//   block sums two of them, as the D = 128 kernel's column groups do). A
//   block's accumulator is never wider than at D = 128.
// - Every block recomputes S = Q.K^T (the backward also dP = dO.V^T) over
//   the whole D, streaming Q and K (dO and V) in 64-wide pieces through a
//   two-stage cp.async ring of shared memory: the next piece is in flight
//   while this one's mma run. The softmax (or P and dS) is formed once a
//   walked tile's last piece is summed.
// - The backward walks its pieces so that the last one is the block's own
//   chunk: the dO and Q pieces still in the ring are dV's and dK's B
//   operands, the K piece dQ's. The forward loads its V chunk beside the
//   last piece.
// - So S (and dP) is computed once per output chunk: ceil(D / 128) times in
//   the forward and D / 64 times in the backward kernels, against once in
//   an unsplit kernel. At D = 256 the forward does 2 S products a pair
//   instead of 1 (6 D flops a pair against 4 D), dkv and dq 4 S and 4 dP
//   (34 D against 14 D). That is the price of a block whose registers and
//   shared memory fit; the pieces of Q, K, dO and V are re-read from L2 once
//   a walked tile and chunk.
// - A warp owns 16 rows of a 64-row tile; 4 warps a block. The fragments:
//   S-shaped products read A from the block's rows and B from the walked
//   tile's rows as they lie (D contiguous); the second product of each pair
//   takes A straight from the accumulator of the first (f32: the permuted
//   keys of flash_attn_fwd.cu; bf16: the accumulator's pairs ARE the A
//   fragment's) and reads B down a column of the ring's tile.
// - Rows are padded (f32 +4, bf16 +8 elements), so every fragment read of
//   both patterns is free of bank conflicts.
// - Each walked tile's contribution to O, dK, dV or dQ goes into a fresh
//   accumulator added in round-to-nearest f32, as in the D <= 128 kernels.
// - No atomics, a fixed order: bit-identical from run to run.
//
// What bounds it on one H100 SXM: the bf16 forms' tensor-core operations at
// 989 TFLOP/s (one pass), the f32 forms' three TF32 passes at 495, of the
// D-split's products above; the unsplit bound (4 D and 10 D flops a pair) is
// the one an unsplit kernel would face. A simple kernel first: no TMA, no
// wgmma, no warp specialisation.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "bf16_mma.cuh"

namespace {
namespace dsplit {

constexpr int BR = 64;             // rows of a block's tile and a walked tile
constexpr int WARPS = BR / 16;     // a warp owns 16 of the block's rows
constexpr int THREADS = 32 * WARPS;
constexpr int NT = BR / 8;         // mma n-tiles over a walked tile
constexpr int DS = 64;             // head dims of a piece of the streamed D
constexpr int DC_FWD = 128;        // output head dims a forward block sums

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 inputs, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The ROWS x COLS window at (r0, c0) of a row-major [*, gld] array into
// shared memory (row stride sld), in 16-byte copies; rows >= rlim and
// columns >= clim are zeros (COLS, c0, clim and gld multiples of 16 bytes).
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* s, int sld,
                                          const T* __restrict__ g, int gld,
                                          int r0, int rlim, int c0,
                                          int clim) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = COLS / VEC;
  constexpr int COUNT = ROWS * PER_ROW;
  static_assert(COUNT % THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int e0 = 0; e0 < COUNT; e0 += THREADS) {
    const int e = e0 + threadIdx.x;
    const int r = e / PER_ROW, c = (e % PER_ROW) * VEC;
    const bool ok = r0 + r < rlim && c0 + c < clim;
    const T* src = ok ? g + (size_t)(r0 + r) * gld + (c0 + c) : g;
    cp16(s + r * sld + c, src, ok ? 16 : 0);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[1][N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[0][n][c] = 0.f;
}

// sum += part, in round-to-nearest f32 (the tensor cores' adds truncate)
template <int N>
__device__ __forceinline__ void add_rn(float (&sum)[1][N][4],
                                       const float (&part)[1][N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      sum[0][n][c] = __fadd_rn(sum[0][n][c], part[0][n][c]);
}

// The f32 form: operands f32 in shared memory, split into TF32 hi/lo as
// their fragments are read (split_tf32_alu), hi*hi' + hi*lo' + lo*hi'.
struct F32 {
  typedef float T;
  static constexpr int PAD = 4;

  // acc (16 x 8N) += A.B^T over DS columns: A the 16 rows at `a`, B the
  // rows 8n + g of `b` as they lie
  template <int N>
  __device__ static __forceinline__ void nt(float (&acc)[1][N][4],
                                            const float* a, int lda,
                                            const float* b, int ldb) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < DS; kk += 8) {
      unsigned ahi[1][4], alo[1][4], bhi[N][2], blo[N][2];
#pragma unroll
      for (int x = 0; x < 4; ++x)   // (row g + 8 (x & 1), col t + 4 (x >> 1))
        split_tf32_alu(a[(g + 8 * (x & 1)) * lda + kk + t + 4 * (x >> 1)],
                       ahi[0][x], alo[0][x]);
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int x = 0; x < 2; ++x)   // row 8n + g, col kk + t + 4x
          split_tf32_alu(b[(8 * n + g) * ldb + kk + t + 4 * x], bhi[n][x],
                         blo[n][x]);
      mma3_step<1, N>(acc, ahi, alo, bhi, blo);
    }
  }

  // acc (16 x 8N) += P.B over the BR rows of `b` from column c0: P the
  // accumulator of an S-shaped product (rows g, g + 8; columns 2t, 2t + 1
  // of each group of 8) read as A with k = t for column 2t and k = t + 4
  // for 2t + 1, so B is read at the same permuted rows
  template <int N>
  __device__ static __forceinline__ void rn(float (&acc)[1][N][4],
                                            const float (&p)[1][NT][4],
                                            const float* b, int ldb, int c0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kg = 0; kg < NT; ++kg) {
      unsigned ahi[1][4], alo[1][4], bhi[N][2], blo[N][2];
      split_tf32_alu(p[0][kg][0], ahi[0][0], alo[0][0]);
      split_tf32_alu(p[0][kg][2], ahi[0][1], alo[0][1]);
      split_tf32_alu(p[0][kg][1], ahi[0][2], alo[0][2]);
      split_tf32_alu(p[0][kg][3], ahi[0][3], alo[0][3]);
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int x = 0; x < 2; ++x)   // row 8kg + 2t + x, col c0 + 8n + g
          split_tf32_alu(b[(8 * kg + 2 * t + x) * ldb + c0 + 8 * n + g],
                         bhi[n][x], blo[n][x]);
      mma3_step<1, N>(acc, ahi, alo, bhi, blo);
    }
  }

  __device__ static __forceinline__ void store2(float* o, float x, float y) {
    *reinterpret_cast<float2*>(o) = make_float2(x, y);
  }
};

// The bf16 form: operands bf16 in shared memory, one mma pass, P and dS
// rounded to bf16 (cvt.rn) as they become A fragments.
struct BF16 {
  typedef bf16 T;
  static constexpr int PAD = 8;

  static __device__ __forceinline__ unsigned ld32(const bf16* p) {
    return *reinterpret_cast<const unsigned*>(p);
  }
  // the bf16 pair (lo, hi) as one register, lo in the low half
  static __device__ __forceinline__ unsigned pair(const bf16* lo,
                                                  const bf16* hi) {
    return (unsigned)*reinterpret_cast<const unsigned short*>(lo) |
           ((unsigned)*reinterpret_cast<const unsigned short*>(hi) << 16);
  }

  template <int N>
  __device__ static __forceinline__ void nt(float (&acc)[1][N][4],
                                            const bf16* a, int lda,
                                            const bf16* b, int ldb) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < DS; kk += 16) {
      // A: (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)
      const unsigned af[4] = {ld32(a + g * lda + kk + 2 * t),
                              ld32(a + (g + 8) * lda + kk + 2 * t),
                              ld32(a + g * lda + kk + 2 * t + 8),
                              ld32(a + (g + 8) * lda + kk + 2 * t + 8)};
#pragma unroll
      for (int n = 0; n < N; ++n) {   // B: row 8n + g, cols 2t.., 2t + 8..
        const bf16* br = b + (8 * n + g) * ldb + kk + 2 * t;
        const unsigned bf[2] = {ld32(br), ld32(br + 8)};
        mma_bf16(acc[0][n], af, bf);
      }
    }
  }

  // as F32::rn: the accumulator's pairs (columns 2t, 2t + 1 of n-tiles 2kk
  // and 2kk + 1) are the A fragment of a 16-deep k-step as they lie,
  // rounded to bf16; B's pairs run down a column of `b`
  template <int N>
  __device__ static __forceinline__ void rn(float (&acc)[1][N][4],
                                            const float (&p)[1][NT][4],
                                            const bf16* b, int ldb, int c0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const unsigned af[4] = {pack_bf16x2(p[0][2 * kk][0], p[0][2 * kk][1]),
                              pack_bf16x2(p[0][2 * kk][2], p[0][2 * kk][3]),
                              pack_bf16x2(p[0][2 * kk + 1][0],
                                          p[0][2 * kk + 1][1]),
                              pack_bf16x2(p[0][2 * kk + 1][2],
                                          p[0][2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < N; ++n) {   // rows 16kk + 2t (+1, +8, +9), col g
        const bf16* bc = b + (16 * kk + 2 * t) * ldb + c0 + 8 * n + g;
        const unsigned bf[2] = {pair(bc, bc + ldb),
                                pair(bc + 8 * ldb, bc + 9 * ldb)};
        mma_bf16(acc[0][n], af, bf);
      }
    }
  }

  __device__ static __forceinline__ void store2(bf16* o, float x, float y) {
    *reinterpret_cast<unsigned*>(o) = pack_bf16x2(x, y);
  }
};

__device__ __forceinline__ int clamp_len(const int* len, int b, int t) {
  return len ? min(max(len[b], 0), t) : t;
}

// ---------------------------------------------------------------- forward
template <typename P>
struct FwdCfg {
  typedef typename P::T T;
  static constexpr int LD = DS + P::PAD;          // a Q or K piece's rows
  static constexpr int LDV = DC_FWD + P::PAD;     // the V chunk's rows
  static constexpr int PIECE = BR * LD;
  static constexpr int STAGE = 2 * PIECE + BR * LDV;   // Q, K pieces, V
  static constexpr size_t BYTES = sizeof(T) * 2 * STAGE;
};

// One block per (h, b, 64-query tile, 128-wide chunk of out's head dims).
template <typename P>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const typename P::T* __restrict__ q,
           const typename P::T* __restrict__ k,
           const typename P::T* __restrict__ v, typename P::T* __restrict__ out,
           float* __restrict__ lse, const int* __restrict__ kv_len,
           const int* __restrict__ q_len, int Tq, int Tk, int H, int D,
           int causal, float scale) {
  using C = FwdCfg<P>;
  using T = typename P::T;
  constexpr int CT = DC_FWD / 8;                 // the chunk's n-tiles
  extern __shared__ __align__(16) unsigned char smem_ds[];
  T* smem = reinterpret_cast<T*>(smem_ds);

  const int h = blockIdx.x, b = blockIdx.y;
  const int nc = (D + DC_FWD - 1) / DC_FWD;
  const int chunk = (int)blockIdx.z % nc;
  const int zt = (int)blockIdx.z / nc, qtiles = (int)gridDim.z / nc;
  const int tile = causal ? qtiles - 1 - zt : zt;   // the heaviest first
  const int q0 = tile * BR, c0 = chunk * DC_FWD;
  const int cn = min(DC_FWD, D - c0) / 8;        // the chunk's live n-tiles
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp * 16;
  const int qi[2] = {q0 + rw + g, q0 + rw + g + 8};

  const int klen = clamp_len(kv_len, b, Tk);
  const int qlen = clamp_len(q_len, b, Tq);
  int kend = klen;                               // keys any row may see
  if (causal) kend = min(kend, q0 + BR);
  if (q0 >= qlen) kend = 0;
  const int ntiles = (kend + BR - 1) / BR;
  const int np = D / DS;
  const int items = ntiles * np;                 // (key tile, piece)

  const int ld = H * D;
  const T* qb = q + ((size_t)b * Tq * H + h) * D;
  const T* kb = k + ((size_t)b * Tk * H + h) * D;
  const T* vb = v + ((size_t)b * Tk * H + h) * D;
  auto issue = [&](int it) {
    const int j = it / np, p = it % np;
    T* st = smem + (it % 2) * C::STAGE;
    load_tile<T, BR, DS>(st, C::LD, qb, ld, q0, Tq, p * DS, D);
    load_tile<T, BR, DS>(st + C::PIECE, C::LD, kb, ld, j * BR, klen, p * DS,
                         D);
    if (p == np - 1)   // the chunk of V beside the tile's last piece
      load_tile<T, BR, DC_FWD>(st + 2 * C::PIECE, C::LDV, vb, ld, j * BR,
                               klen, c0, D);
  };
  if (items > 0) issue(0);
  cp_async_commit();

  float o[1][CT][4];                 // the rows' unnormalised output chunk
  float s[1][NT][4];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running max, rows g, g+8
  float l[2] = {0.f, 0.f};           // the thread's part of the row sums
  zero(o);
  for (int it = 0; it < items; ++it) {
    __syncthreads();                 // every warp is done with item it - 1
    if (it + 1 < items) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                 // item it visible to all
    const int j = it / np, p = it % np;
    const T* st = smem + (it % 2) * C::STAGE;
    if (p == 0) zero(s);
    P::template nt<NT>(s, st + rw * C::LD, C::LD, st + C::PIECE, C::LD);
    if (p < np - 1) continue;

    // the online softmax on the fragment rows g (c 0, 1) and g + 8 (c 2, 3)
    const int k0 = j * BR;
    const bool masked = !(k0 + BR <= klen && q0 + BR <= qlen &&
                          (!causal || k0 + BR - 1 <= q0));
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[0][n][c] * scale;
        if (masked) {
          const int key = k0 + 8 * n + 2 * t + (c & 1);
          const int row = qi[c >> 1];
          if (!(row < qlen && key < klen && (!causal || key <= row)))
            x = -CUDART_INF_F;
        }
        s[0][n][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // 0 on the row's first visible tile; 1 while it has seen no key
      corr[r] = m_new == -CUDART_INF_F ? 1.f : expf(m[r] - m_new);
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = s[0][n][c];
        const float pr = x == -CUDART_INF_F ? 0.f : expf(x - m[c >> 1]);
        s[0][n][c] = pr;
        psum[c >> 1] += pr;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];

    // O = O * corr + P.V, 64 of the chunk's head dims a pass
#pragma unroll
    for (int d0 = 0; d0 < CT; d0 += 8) {
      if (d0 >= cn) break;
      float ot[1][8][4];
      zero(ot);
      P::template rn<8>(ot, s, st + 2 * C::PIECE, C::LDV, 8 * d0);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[0][d0 + n][c] = fmaf(o[0][d0 + n][c], corr[c >> 1], ot[0][n][c]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qi[r] >= Tq) continue;
    const bool alive = l[r] > 0.f;
    T* orow = out + ((size_t)(b * Tq + qi[r]) * H + h) * D + c0;
#pragma unroll
    for (int n = 0; n < CT; ++n) {
      if (n >= cn) break;
      P::store2(orow + 8 * n + 2 * t, alive ? o[0][n][2 * r] / l[r] : 0.f,
                alive ? o[0][n][2 * r + 1] / l[r] : 0.f);
    }
    if (t == 0 && chunk == 0)
      lse[((size_t)b * H + h) * Tq + qi[r]] =
          alive ? m[r] + logf(l[r]) : 1e30f;
  }
}

// --------------------------------------------------------------- backward
template <typename P>
struct BwdCfg {
  typedef typename P::T T;
  static constexpr int LD = DS + P::PAD;
  static constexpr int PIECE = BR * LD;
  static constexpr int STAGE = 4 * PIECE;   // the pieces of Q, dO, K and V
  static constexpr size_t BYTES = sizeof(T) * 2 * STAGE;
};

// rows r (fragment rows g, g + 8) of a warp's [16][DS] sum into out at
// `row[r]` (a [*, ld] array from its chunk's first column): skipped at or
// past `rows`, zeros at or past `live`
template <typename P>
__device__ __forceinline__ void store_rows(typename P::T* __restrict__ out,
                                           int ld, const float (&sum)[1][NT][4],
                                           const int (&row)[2], int rows,
                                           int live) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= rows) continue;
    typename P::T* o = out + (size_t)row[r] * ld;
    const bool on = row[r] < live;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      P::store2(o + 8 * n + 2 * t, on ? sum[0][n][2 * r] : 0.f,
                on ? sum[0][n][2 * r + 1] : 0.f);
  }
}

// One block per (h, b, 64-key tile, 64-wide chunk of dK's and dV's head
// dims): it walks the query tiles that can see its keys.
template <typename P>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const typename P::T* __restrict__ q,
           const typename P::T* __restrict__ k,
           const typename P::T* __restrict__ v,
           const typename P::T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           typename P::T* __restrict__ dk, typename P::T* __restrict__ dv,
           const int* __restrict__ kv_len, const int* __restrict__ q_len,
           int Tq, int Tk, int H, int D, int causal, float scale) {
  using C = BwdCfg<P>;
  using T = typename P::T;
  extern __shared__ __align__(16) unsigned char smem_ds[];
  T* smem = reinterpret_cast<T*>(smem_ds);

  const int h = blockIdx.x, b = blockIdx.y;
  const int np = D / DS;
  const int chunk = (int)blockIdx.z % np;
  const int k0 = ((int)blockIdx.z / np) * BR;    // low key tiles first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp * 16;
  const int key[2] = {k0 + rw + g, k0 + rw + g + 8};

  const int klen = clamp_len(kv_len, b, Tk);
  const int qlen = clamp_len(q_len, b, Tq);
  const int qbeg = causal ? k0 : 0;              // a tile boundary
  const int qend = k0 < klen ? qlen : 0;
  const int ntiles = qbeg < qend ? (qend - qbeg + BR - 1) / BR : 0;
  const int items = ntiles * np;                 // (query tile, piece)

  const int ld = H * D;
  const size_t kvb = ((size_t)b * Tk * H + h) * D;
  const size_t qdb = ((size_t)b * Tq * H + h) * D;
  const float* lseb = lse + ((size_t)b * H + h) * Tq;
  const float* deltab = delta + ((size_t)b * H + h) * Tq;
  // pieces from the one after the chunk round to the chunk itself, which
  // is left in the ring for dV's and dK's products
  auto issue = [&](int it) {
    const int i0 = qbeg + (it / np) * BR;
    const int p = (chunk + 1 + it % np) % np;
    T* st = smem + (it % 2) * C::STAGE;
    load_tile<T, BR, DS>(st, C::LD, q + qdb, ld, i0, Tq, p * DS, D);
    load_tile<T, BR, DS>(st + C::PIECE, C::LD, dout + qdb, ld, i0, Tq,
                         p * DS, D);
    load_tile<T, BR, DS>(st + 2 * C::PIECE, C::LD, k + kvb, ld, k0, klen,
                         p * DS, D);
    load_tile<T, BR, DS>(st + 3 * C::PIECE, C::LD, v + kvb, ld, k0, klen,
                         p * DS, D);
  };
  if (items > 0) issue(0);
  cp_async_commit();

  float dks[1][NT][4], dvs[1][NT][4];   // the warp's keys' dk, dv chunk
  float s[1][NT][4], dp[1][NT][4];
  zero(dks);
  zero(dvs);
  for (int it = 0; it < items; ++it) {
    __syncthreads();
    if (it + 1 < items) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* st = smem + (it % 2) * C::STAGE;
    const T* qt = st;
    const T* dot = st + C::PIECE;
    if (it % np == 0) {
      zero(s);
      zero(dp);
    }
    // S^T = K.Q^T and dP^T = V.dO^T: the warp's 16 keys x the tile's queries
    P::template nt<NT>(s, st + 2 * C::PIECE + rw * C::LD, C::LD, qt, C::LD);
    P::template nt<NT>(dp, st + 3 * C::PIECE + rw * C::LD, C::LD, dot, C::LD);
    if (it % np < np - 1) continue;

    const int i0 = qbeg + (it / np) * BR;
    const bool masked = !(k0 + BR <= klen && i0 + BR <= qlen &&
                          (!causal || k0 + BR - 1 <= i0));
    // P^T and dS^T in place: (key g + 8 (c >> 1), query 8n + 2t + (c & 1))
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int qi = i0 + 8 * n + 2 * t + x;
        const float ls = qi < Tq ? lseb[qi] : 1e30f;
        const float dl = qi < Tq ? deltab[qi] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int c = 2 * r + x;
          float pr = expf(s[0][n][c] * scale - ls);
          if (masked) {
            const int kj = key[r];
            if (!(kj < klen && qi < qlen && (!causal || kj <= qi))) pr = 0.f;
          }
          s[0][n][c] = pr;
          dp[0][n][c] = pr * (dp[0][n][c] - dl) * scale;
        }
      }
    // dV += P^T.dO and dK += dS^T.Q over the tile's queries, the chunk's
    // columns (this item's pieces)
    float part[1][NT][4];
    zero(part);
    P::template rn<NT>(part, s, dot, C::LD, 0);
    add_rn(dvs, part);
    zero(part);
    P::template rn<NT>(part, dp, qt, C::LD, 0);
    add_rn(dks, part);
  }
  cp_async_wait<0>();
  store_rows<P>(dk + kvb + chunk * DS, ld, dks, key, Tk, klen);
  store_rows<P>(dv + kvb + chunk * DS, ld, dvs, key, Tk, klen);
}

// One block per (h, b, 64-query tile, 64-wide chunk of dQ's head dims): it
// walks the key tiles its rows can see.
template <typename P>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const typename P::T* __restrict__ q,
          const typename P::T* __restrict__ k,
          const typename P::T* __restrict__ v,
          const typename P::T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          typename P::T* __restrict__ dq, const int* __restrict__ kv_len,
          const int* __restrict__ q_len, int Tq, int Tk, int H, int D,
          int causal, float scale) {
  using C = BwdCfg<P>;
  using T = typename P::T;
  extern __shared__ __align__(16) unsigned char smem_ds[];
  T* smem = reinterpret_cast<T*>(smem_ds);

  const int h = blockIdx.x, b = blockIdx.y;
  const int np = D / DS;
  const int chunk = (int)blockIdx.z % np;
  const int zt = (int)blockIdx.z / np, qtiles = (int)gridDim.z / np;
  const int tile = causal ? qtiles - 1 - zt : zt;   // the heaviest first
  const int q0 = tile * BR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = warp * 16;
  const int qi[2] = {q0 + rw + g, q0 + rw + g + 8};

  const int klen = clamp_len(kv_len, b, Tk);
  const int qlen = clamp_len(q_len, b, Tq);
  int kend = klen;
  if (causal) kend = min(kend, q0 + BR);
  if (q0 >= qlen) kend = 0;
  const int ntiles = (kend + BR - 1) / BR;
  const int items = ntiles * np;                 // (key tile, piece)

  const int ld = H * D;
  const size_t qdb = ((size_t)b * Tq * H + h) * D;
  const size_t kvb = ((size_t)b * Tk * H + h) * D;
  auto issue = [&](int it) {
    const int j0 = (it / np) * BR;
    const int p = (chunk + 1 + it % np) % np;
    T* st = smem + (it % 2) * C::STAGE;
    load_tile<T, BR, DS>(st, C::LD, q + qdb, ld, q0, Tq, p * DS, D);
    load_tile<T, BR, DS>(st + C::PIECE, C::LD, dout + qdb, ld, q0, Tq,
                         p * DS, D);
    load_tile<T, BR, DS>(st + 2 * C::PIECE, C::LD, k + kvb, ld, j0, klen,
                         p * DS, D);
    load_tile<T, BR, DS>(st + 3 * C::PIECE, C::LD, v + kvb, ld, j0, klen,
                         p * DS, D);
  };
  if (items > 0) issue(0);
  cp_async_commit();
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = ((size_t)b * H + h) * Tq + qi[r];
    row_lse[r] = qi[r] < Tq ? lse[at] : 1e30f;
    row_delta[r] = qi[r] < Tq ? delta[at] : 0.f;
  }

  float dqs[1][NT][4];                 // the warp's rows' dq chunk
  float s[1][NT][4], dp[1][NT][4];
  zero(dqs);
  for (int it = 0; it < items; ++it) {
    __syncthreads();
    if (it + 1 < items) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* st = smem + (it % 2) * C::STAGE;
    const T* kt = st + 2 * C::PIECE;
    if (it % np == 0) {
      zero(s);
      zero(dp);
    }
    // S = Q.K^T and dP = dO.V^T: the warp's 16 rows x the tile's 64 keys
    P::template nt<NT>(s, st + rw * C::LD, C::LD, kt, C::LD);
    P::template nt<NT>(dp, st + C::PIECE + rw * C::LD, C::LD,
                       st + 3 * C::PIECE, C::LD);
    if (it % np < np - 1) continue;

    const int k0 = (it / np) * BR;
    const bool masked = !(k0 + BR <= klen && q0 + BR <= qlen &&
                          (!causal || k0 + BR - 1 <= q0));
    // dS in place of S: (row g + 8 (c >> 1), key 8n + 2t + (c & 1))
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        float pr = expf(s[0][n][c] * scale - row_lse[r]);
        if (masked) {
          const int kj = k0 + 8 * n + 2 * t + (c & 1);
          if (!(qi[r] < qlen && kj < klen && (!causal || kj <= qi[r])))
            pr = 0.f;
        }
        s[0][n][c] = pr * (dp[0][n][c] - row_delta[r]) * scale;
      }
    // dQ += dS.K over the tile's keys, the chunk's columns (this piece of K)
    float part[1][NT][4];
    zero(part);
    P::template rn<NT>(part, s, kt, C::LD, 0);
    add_rn(dqs, part);
  }
  cp_async_wait<0>();
  store_rows<P>(dq + qdb + chunk * DS, ld, dqs, qi, Tq, qlen);
}

template <typename Kernel>
cudaError_t smem_limit(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// D a multiple of DS above 128; the grid's third axis under 65536
inline bool split_dims_ok(int D, long long z) {
  return D > 128 && D % DS == 0 && z >= 1 && z <= 65535;
}

template <typename P>
cudaError_t launch_fwd(const typename P::T* q, const typename P::T* k,
                       const typename P::T* v, typename P::T* out, float* lse,
                       const int* kv_len, const int* q_len, int B, int Tq,
                       int Tk, int H, int D, int causal, float scale,
                       cudaStream_t stream) {
  using C = FwdCfg<P>;
  static_assert(C::BYTES <= 232448, "shared memory of a block");
  const long long z =
      (long long)((Tq + BR - 1) / BR) * ((D + DC_FWD - 1) / DC_FWD);
  if (!split_dims_ok(D, z)) return cudaErrorInvalidValue;
  const cudaError_t err = smem_limit(fwd_kernel<P>, C::BYTES);
  if (err != cudaSuccess) return err;
  fwd_kernel<P><<<dim3(H, B, (unsigned)z), THREADS, C::BYTES, stream>>>(
      q, k, v, out, lse, kv_len, q_len, Tq, Tk, H, D, causal, scale);
  return cudaGetLastError();
}

template <typename P>
cudaError_t launch_dkv(const typename P::T* q, const typename P::T* k,
                       const typename P::T* v, const typename P::T* dout,
                       const float* lse, const float* delta,
                       typename P::T* dk, typename P::T* dv, const int* kv_len,
                       const int* q_len, int B, int Tq, int Tk, int H, int D,
                       int causal, float scale, cudaStream_t stream) {
  using C = BwdCfg<P>;
  static_assert(C::BYTES <= 232448, "shared memory of a block");
  const long long z = (long long)((Tk + BR - 1) / BR) * (D / DS);
  if (!split_dims_ok(D, z)) return cudaErrorInvalidValue;
  const cudaError_t err = smem_limit(dkv_kernel<P>, C::BYTES);
  if (err != cudaSuccess) return err;
  dkv_kernel<P><<<dim3(H, B, (unsigned)z), THREADS, C::BYTES, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, kv_len, q_len, Tq, Tk, H, D, causal,
      scale);
  return cudaGetLastError();
}

template <typename P>
cudaError_t launch_dq(const typename P::T* q, const typename P::T* k,
                      const typename P::T* v, const typename P::T* dout,
                      const float* lse, const float* delta, typename P::T* dq,
                      const int* kv_len, const int* q_len, int B, int Tq,
                      int Tk, int H, int D, int causal, float scale,
                      cudaStream_t stream) {
  using C = BwdCfg<P>;
  static_assert(C::BYTES <= 232448, "shared memory of a block");
  const long long z = (long long)((Tq + BR - 1) / BR) * (D / DS);
  if (!split_dims_ok(D, z)) return cudaErrorInvalidValue;
  const cudaError_t err = smem_limit(dq_kernel<P>, C::BYTES);
  if (err != cudaSuccess) return err;
  dq_kernel<P><<<dim3(H, B, (unsigned)z), THREADS, C::BYTES, stream>>>(
      q, k, v, dout, lse, delta, dq, kv_len, q_len, Tq, Tk, H, D, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace dsplit
}  // namespace
