// Flash-attention backward for Hopper (sm_90a): two kernels, dkv and dq, in
// an f32 form (f32 accuracy on the tensor cores) and a bf16 form of the AMP
// rule (its own section below, "the bf16 forms").
//
// Replaces the TPU kernels behind paddle_tpu/parallel/ring.py::_pallas_flash's
// gradient (jax.experimental.pallas.ops.tpu.flash_attention: the dkv and dq
// pallas_calls of _flash_attention_bwd). It computes what
// ring.py::_flash_blocked_bwd defines, not a block-by-block copy of the TPU
// kernels:
//
//   q, dout [B,Tq,H,D], k/v [B,Tk,H,D] contiguous f32 (the JAX layout),
//   lse and delta [B,H,Tq] (delta = sum_d dout*out, computed by the caller)
//   p_ij  = exp(scale * q_i.k_j - lse_i) over visible pairs, exactly 0 elsewhere
//   ds_ij = p_ij * (dout_i.v_j - delta_i) * scale
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i p_ij dout_i
//
// Visible pairs: j < kv_len[b], i < q_len[b], j <= i when causal — the
// forward's masks, tested explicitly (never through exp of a huge negative).
// A row with no visible key (lse = 1e30) has every p = 0, so its dq is 0 and
// it adds nothing to dk/dv. A padded query row of self-attention still sees
// the valid keys and is handled like any other row (its dout is 0). dk and dv
// of a key at or past kv_len, and dq of a row at or past q_len, are written
// as exact zeros.
//
// What bounds it on one H100 SXM: 10*D*H flops a visible (query, key) pair
// for the whole backward (S = Q.K^T and dP = dO.V^T recomputed, dV, dK, dQ),
// run as three TF32 passes on the tensor cores (495 TFLOP/s dense). At LM
// training's long shape (B=8, T=1024, H=4, D=64, causal, ragged kv_len, ~2.69
// M visible pairs a head) that is ~0.033 ms for dkv (8*D*H a pair) and ~0.025
// ms for dq (6*D*H), about twice the time of their bytes at 3.35 TB/s; at the
// short shape (B=32, T=128) the bytes bound both.
//
// Design:
// - dkv: one block per (h, b, 64-key tile), a warp owning 16 keys as the M
//   rows of its mma tiles. The tile's K and V stay in shared memory for the
//   whole walk; the block walks the 64-query tiles that can see its keys,
//   Q, dO, lse and delta arriving through a two-stage cp.async ring
//   (zero-filled past Tq). Per query tile: S^T = K.Q^T and dP^T = V.dO^T
//   with B = Q or dO as it lies (D contiguous a query); P^T and dS^T on the
//   accumulator fragments; then dV += P^T.dO and dK += dS^T.Q with A taken
//   straight from the registers that held S^T and dP^T: their accumulator
//   holds queries (2t, 2t+1) of keys g and g+8, and the A fragment wants
//   k = t and t+4, so inside each group of 8 queries k = t stands for query
//   2t and k = t+4 for query 2t+1, and dO's and Q's B fragments are read at
//   the same permuted rows (B4f's permutation). At D <= 64 four warps own
//   the 64 keys; at D = 96 and 128 a warp's dK and dV (2 x 16 x D sums)
//   would not fit its registers beside S^T and dP^T, so two groups of four
//   warps own the same keys, each summing half of dK's and dV's columns,
//   and each forms S^T and dP^T in full (1.5x the products; no spill).
// - dq: one block per (h, b, 64-query tile), a warp owning 16 query rows, Q
//   and dO in shared memory, K and V through the ring. Per key tile: S =
//   Q.K^T, dP = dO.V^T, P, dS, then dQ += dS.K with A = dS from registers,
//   permuted, and B = the same K tile at the permuted rows. The walk stops
//   at the tile's last visible key.
// - Walk groups: where a walk reaches KG_MIN_WALK tiles (and D <= 64, for
//   shared memory), two groups of warps take its tiles in turn, each with
//   its own sums, added in order at the end. With causal masks the first
//   key tile's dkv walk and the last query tile's dq walk are the grid's
//   longest chains (16 tiles at T = 1024, against ~11 tile visits a block
//   slot on average at LM training's long shape); halving them took dkv
//   20% and dq 9% off there. At T = 128 (2-tile walks) two groups were
//   6-13% slower: one block an SM instead of two.
// - Every operand stays f32 in shared memory and is split into TF32 hi/lo
//   as its fragment is read. Splitting the block's own two operands once
//   into hi/lo planes (twice their shared memory) was measured against
//   this on one H100 (flash_bwd_probe.py): at D = 64 the planes leave room
//   for one block an SM, the f32 tiles for two, and two were 22-24% faster
//   at LM training's short shape (a grid of 256 blocks), 11% faster for dq
//   and 4% slower for dkv at its long one.
// - 3xTF32 on mma.sync m16n8k8 (tf32_mma.cuh): hi*hi' + hi*lo' + lo*hi',
//   small terms first; every split by integer ops (split_tf32_alu), not cvt,
//   which runs at a quarter rate (cvt was 26-30% slower at D = 64, 2.4-3.6x
//   at D = 128). Shared rows are padded to D+4 floats, so the fragment reads
//   of both patterns are free of bank conflicts.
// - The mask is tested a pair only on tiles that cross the diagonal, kv_len
//   or q_len; elsewhere every pair is visible.
// - Each walked tile's contribution to dK, dV or dQ goes into a fresh
//   accumulator that is added to the running sum in round-to-nearest f32:
//   the tensor cores' truncating adds never chain over more than one tile (a
//   key's dK sums over 16 query tiles at T = 1024).
// - The grid puts the tile axis slowest and, when causal, dispatches the
//   heaviest tiles first: dkv's low key tiles, dq's high query tiles.
// - Why dq is not fused into dkv: a fused kernel (FlashAttention-2's) adds
//   each key tile's dS.K into dq with atomics, whose order changes from run
//   to run. Two kernels give every output one writer, so the result is
//   bit-identical from run to run, at the price of S and dP computed in both
//   (14*D*H flops a pair against the bound's 10).

#include <cuda_runtime.h>

#include "flash_dsplit.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int BLOCK = 64;               // rows of a block's and a walked tile
constexpr int WARPS = BLOCK / 16;       // a warp owns 16 of the block's rows
constexpr int THREADS = 32 * WARPS;     // 128 (dkv: a column group's)
constexpr int STAGES = 2;               // walked tiles in flight
constexpr int NT = BLOCK / 8;           // mma n-tiles over a walked tile

template <int D>
struct Cfg {
  static constexpr int LD = D + 4;        // row stride of every shared tile
  static constexpr int TILE = BLOCK * LD;
  // dkv's groups of WARPS warps owning the same keys, each summing D / CG
  // of dK's and dV's columns (registers)
  static constexpr int CG = D <= 64 ? 1 : 2;
  static constexpr int DKV_THREADS = THREADS * CG;
  // walk groups a block may take: two only where their rings fit
  static constexpr int KG_MAX = D <= 64 ? 2 : 1;
  // a stage: the two walked tiles, and for dkv the tile's lse and delta
  static constexpr int STAGE_DKV = 2 * TILE + 2 * BLOCK;
  static constexpr int STAGE_DQ = 2 * TILE;
  // the block's own two tiles, then the ring (KG tiles a stage)
  static constexpr size_t dkv_bytes(int kg) {
    return sizeof(float) * (2 * TILE + STAGES * kg * STAGE_DKV);
  }
  static constexpr size_t dq_bytes(int kg) {
    return sizeof(float) * (2 * TILE + STAGES * kg * STAGE_DQ);
  }
};

// A walk of at least this many tiles is taken by two groups of warps in
// turn (group g tiles g, g + 2, ...), each with its own sums, added in
// order at the end: with causal masks the first key tile's dkv walk (the
// last query tile's dq walk) is the longest chain of the grid, and two
// groups halve it.
constexpr int KG_MIN_WALK = 3;

// groups 1.. of a block's KG walk groups hand their N sums a thread to group
// 0 through shared memory `x` ([value][thread of a group]), and group 0 adds
// them to its own in order; returns false for the threads of groups 1..
template <int KG, int GT, int N>
__device__ __forceinline__ bool merge_groups(float (&sum)[N][4], float* x) {
  if (KG == 1) return true;
  const int grp = threadIdx.x / GT, me = threadIdx.x % GT;
  __syncthreads();                     // every group is done with x
  if (grp > 0) {
    float* c = x + (grp - 1) * 4 * N * GT;
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[(4 * n + e) * GT + me] = sum[n][e];
  }
  __syncthreads();
  if (grp > 0) return false;
#pragma unroll
  for (int k = 1; k < KG; ++k) {
    const float* c = x + (k - 1) * 4 * N * GT;
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sum[n][e] = __fadd_rn(sum[n][e], c[(4 * n + e) * GT + me]);
  }
  return true;
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[n][c] = 0.f;
}

// acc[n] (16 x 8 each, NT of them) += A.B^T over the D columns: A the warp's
// 16 rows (from row `rw`) of the block's tile `a`, B the rows 8n + g of the
// walked tile `bt` as they lie (D contiguous a row)
template <int D>
__device__ __forceinline__ void product_abt(float (&acc)[1][NT][4],
                                            const float* a, int rw,
                                            const float* bt) {
  constexpr int LD = Cfg<D>::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
    unsigned ahi[1][4], alo[1][4], bhi[NT][2], blo[NT][2];
#pragma unroll
    for (int x = 0; x < 4; ++x)   // (row g + 8 (x & 1), col t + 4 (x >> 1))
      split_tf32_alu(a[(rw + g + 8 * (x & 1)) * LD + kk + t + 4 * (x >> 1)],
                     ahi[0][x], alo[0][x]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int x = 0; x < 2; ++x)   // row 8n + g, col kk + t + 4x
        split_tf32_alu(bt[(8 * n + g) * LD + kk + t + 4 * x], bhi[n][x],
                       blo[n][x]);
    mma3_step<1, NT>(acc, ahi, alo, bhi, blo);
  }
}

// sum[n] += A.B over the 64 rows of a walked tile, for NC column tiles from
// column tile c0, DH of them a pass, each pass into a fresh accumulator
// added in round-to-nearest: A is the accumulator of an S-shaped product
// (rows g, g + 8; columns 2t, 2t + 1 of each group of 8), read as the A
// fragment with k = t for column 2t and k = t + 4 for 2t + 1, so B is read
// at the same permuted rows of `bt`
template <int D, int NC>
__device__ __forceinline__ void product_ab(float (&sum)[NC][4],
                                           const float (&a)[1][NT][4],
                                           const float* bt, int c0) {
  constexpr int LD = Cfg<D>::LD;
  constexpr int DH = NC <= 8 ? NC : NC / 2;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int d0 = 0; d0 < NC; d0 += DH) {
    float acc[1][DH][4];
    zero_acc(acc[0]);
#pragma unroll
    for (int kg = 0; kg < NT; ++kg) {
      unsigned ahi[1][4], alo[1][4], bhi[DH][2], blo[DH][2];
      split_tf32_alu(a[0][kg][0], ahi[0][0], alo[0][0]);
      split_tf32_alu(a[0][kg][2], ahi[0][1], alo[0][1]);
      split_tf32_alu(a[0][kg][1], ahi[0][2], alo[0][2]);
      split_tf32_alu(a[0][kg][3], ahi[0][3], alo[0][3]);
#pragma unroll
      for (int n = 0; n < DH; ++n)
#pragma unroll
        for (int x = 0; x < 2; ++x)   // row 8kg + 2t + x, col 8(c0+d0+n) + g
          split_tf32_alu(bt[(8 * kg + 2 * t + x) * LD + 8 * (c0 + d0 + n) + g],
                         bhi[n][x], blo[n][x]);
      mma3_step<1, DH>(acc, ahi, alo, bhi, blo);
    }
#pragma unroll
    for (int n = 0; n < DH; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sum[d0 + n][c] = __fadd_rn(sum[d0 + n][c], acc[0][n][c]);
  }
}

// rows r (fragment rows g, g + 8) of a warp's [16][8 NC] sum into out
// [*, ld] at row `row[r]` (skipped at or past `rows`, zeros at or past
// `live`)
template <int NC>
__device__ __forceinline__ void store_rows(float* __restrict__ out, int ld,
                                           const float (&sum)[NC][4],
                                           const int (&row)[2], int rows,
                                           int live) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= rows) continue;
    float* o = out + (size_t)row[r] * ld;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      float2 x = make_float2(0.f, 0.f);
      if (row[r] < live) x = make_float2(sum[n][2 * r], sum[n][2 * r + 1]);
      *reinterpret_cast<float2*>(o + 8 * n + 2 * t) = x;
    }
  }
}

__device__ __forceinline__ int clamp_len(const int* len, int b, int t) {
  return len ? min(max(len[b], 0), t) : t;
}

// One block per (h, b, 64-key tile): dk and dv of the tile's keys.
template <int D, int KG>
__global__ void __launch_bounds__(Cfg<D>::DKV_THREADS * KG)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, const int* __restrict__ kv_len,
                     const int* __restrict__ q_len, int Tq, int Tk, int H,
                     int causal, float scale) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, GT = C::DKV_THREADS, THR = GT * KG;
  constexpr int NC = D / 8 / C::CG;    // a warp's column tiles of dK and dV
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // the tile's K, V
  float* vs = smem + C::TILE;
  float* ring = smem + 2 * C::TILE;

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BLOCK;   // low key tiles, the heaviest, first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = threadIdx.x / GT;    // the warp's walk group
  const int wg = warp % (GT / 32);     // its warp within the group
  const int rw = (wg % WARPS) * 16;    // its first key of the tile
  const int c0 = (wg / WARPS) * NC;    // ... and its first column tile
  const int key[2] = {k0 + rw + g, k0 + rw + g + 8};

  const int klen = clamp_len(kv_len, b, Tk);
  const int qlen = clamp_len(q_len, b, Tq);
  // queries that may see a key of this tile: causal ones start at the
  // tile's first key (k0 is a multiple of BLOCK, so a tile boundary)
  const int qbeg = causal ? k0 : 0;
  const int qend = k0 < klen ? qlen : 0;
  const int ntiles = qbeg < qend ? (qend - qbeg + BLOCK - 1) / BLOCK : 0;
  const int nsets = (ntiles + KG - 1) / KG;   // KG query tiles a set

  const int ld = H * D;                // a token's row in q, k, v, dout
  const size_t kvb = ((size_t)b * Tk * H + h) * D;
  const float* qb = q + ((size_t)b * Tq * H + h) * D;
  const float* dob = dout + ((size_t)b * Tq * H + h) * D;
  const float* lseb = lse + ((size_t)b * H + h) * Tq;
  const float* deltab = delta + ((size_t)b * H + h) * Tq;
  auto load = [&](int j) {   // set j's query tiles: Q, dO, lse, delta
    for (int x = 0; x < KG && j * KG + x < ntiles; ++x) {
      float* st = ring + ((j % STAGES) * KG + x) * C::STAGE_DKV;
      const int i0 = qbeg + (j * KG + x) * BLOCK;
      load_window<BLOCK, D, 4, THR>(st, LD, qb, ld, i0, Tq, 0, D);
      load_window<BLOCK, D, 4, THR>(st + C::TILE, LD, dob, ld, i0, Tq, 0, D);
      load_window<1, BLOCK, 1, THR>(st + 2 * C::TILE, 0, lseb, 0, 0, 1, i0,
                                    Tq);
      load_window<1, BLOCK, 1, THR>(st + 2 * C::TILE + BLOCK, 0, deltab, 0,
                                    0, 1, i0, Tq);
    }
  };
  // the tile's K and V (keys at or past kv_len: zeros), with query set 0
  load_window<BLOCK, D, 4, THR>(ks, LD, k + kvb, ld, k0, klen, 0, D);
  load_window<BLOCK, D, 4, THR>(vs, LD, v + kvb, ld, k0, klen, 0, D);
  if (nsets > 0) load(0);
  cp_async_commit();

  float dks[NC][4], dvs[NC][4];        // the warp's part of dk, dv
  zero_acc(dks);
  zero_acc(dvs);

  for (int j = 0; j < nsets; ++j) {
    __syncthreads();                   // every warp is done with set j - 1
    if (j + 1 < nsets) load(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                   // set j (and K, V) visible to all
    const int tile_j = j * KG + grp;   // this warp's query tile of the set
    if (tile_j >= ntiles) continue;
    const float* qt = ring + ((j % STAGES) * KG + grp) * C::STAGE_DKV;
    const float* dot = qt + C::TILE;
    const float* lst = qt + 2 * C::TILE;
    const float* dlt = lst + BLOCK;
    const int i0 = qbeg + tile_j * BLOCK;
    const bool masked = !(k0 + BLOCK <= klen && i0 + BLOCK <= qlen &&
                          (!causal || k0 + BLOCK - 1 <= i0));

    // S^T = K.Q^T and dP^T = V.dO^T: the warp's 16 keys x the tile's queries
    float s[1][NT][4], dp[1][NT][4];
    zero_acc(s[0]);
    zero_acc(dp[0]);
    product_abt<D>(s, ks, rw, qt);
    product_abt<D>(dp, vs, rw, dot);

    // P^T and dS^T in place: (key g + 8 (c >> 1), query 8n + 2t + (c & 1))
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int qc = 8 * n + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lst + qc);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt + qc);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = expf(s[0][n][c] * scale - ((c & 1) ? l2.y : l2.x));
        if (masked) {
          const int qi = i0 + qc + (c & 1), kj = key[c >> 1];
          if (!(kj < klen && qi < qlen && (!causal || kj <= qi))) p = 0.f;
        }
        s[0][n][c] = p;
        dp[0][n][c] = p * (dp[0][n][c] - ((c & 1) ? d2.y : d2.x)) * scale;
      }
    }

    // dV += P^T.dO and dK += dS^T.Q over the tile's queries
    product_ab<D, NC>(dvs, s, dot, c0);
    product_ab<D, NC>(dks, dp, qt, c0);
  }
  cp_async_wait<0>();

  const bool lead = merge_groups<KG, GT>(dks, ring);
  merge_groups<KG, GT>(dvs, ring);
  if (!lead) return;
  store_rows<NC>(dk + kvb + 8 * c0, ld, dks, key, Tk, klen);
  store_rows<NC>(dv + kvb + 8 * c0, ld, dvs, key, Tk, klen);
}

// One block per (h, b, 64-query tile): dq of the tile's queries.
template <int D, int KG>
__global__ void __launch_bounds__(THREADS * KG)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    const int* __restrict__ kv_len,
                    const int* __restrict__ q_len, int Tq, int Tk, int H,
                    int causal, float scale) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, DT = D / 8, THR = THREADS * KG;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // the tile's Q, dO
  float* dos = smem + C::TILE;
  float* ring = smem + 2 * C::TILE;

  const int h = blockIdx.x, b = blockIdx.y;
  // high query tiles, the heaviest when causal, first
  const int tile = causal ? (int)gridDim.z - 1 - (int)blockIdx.z
                          : (int)blockIdx.z;
  const int q0 = tile * BLOCK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = threadIdx.x / THREADS;   // the warp's walk group
  const int rw = (warp % WARPS) * 16;  // its first row of the tile
  const int qi[2] = {q0 + rw + g, q0 + rw + g + 8};

  const int klen = clamp_len(kv_len, b, Tk);
  const int qlen = clamp_len(q_len, b, Tq);
  // keys any row of this tile may see
  int kend = klen;
  if (causal) kend = min(kend, q0 + BLOCK);
  if (q0 >= qlen) kend = 0;
  const int ntiles = (kend + BLOCK - 1) / BLOCK;
  const int nsets = (ntiles + KG - 1) / KG;   // KG key tiles a set

  const int ld = H * D;
  const size_t qdb = ((size_t)b * Tq * H + h) * D;
  const float* kb = k + ((size_t)b * Tk * H + h) * D;
  const float* vb = v + ((size_t)b * Tk * H + h) * D;
  auto load = [&](int j) {   // set j's key tiles: K, V (zeros past kv_len)
    for (int x = 0; x < KG && j * KG + x < ntiles; ++x) {
      float* st = ring + ((j % STAGES) * KG + x) * C::STAGE_DQ;
      const int k0 = (j * KG + x) * BLOCK;
      load_window<BLOCK, D, 4, THR>(st, LD, kb, ld, k0, klen, 0, D);
      load_window<BLOCK, D, 4, THR>(st + C::TILE, LD, vb, ld, k0, klen, 0,
                                    D);
    }
  };
  // the tile's Q and dO (rows past Tq: zeros), with key set 0
  load_window<BLOCK, D, 4, THR>(qs, LD, q + qdb, ld, q0, Tq, 0, D);
  load_window<BLOCK, D, 4, THR>(dos, LD, dout + qdb, ld, q0, Tq, 0, D);
  if (nsets > 0) load(0);
  cp_async_commit();
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = ((size_t)b * H + h) * Tq + qi[r];
    row_lse[r] = qi[r] < Tq ? lse[at] : 1e30f;
    row_delta[r] = qi[r] < Tq ? delta[at] : 0.f;
  }

  float dqs[DT][4];                    // the warp's rows' dq
  zero_acc(dqs);

  for (int j = 0; j < nsets; ++j) {
    __syncthreads();                   // every warp is done with set j - 1
    if (j + 1 < nsets) load(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                   // set j (and Q, dO) visible to all
    const int tile_j = j * KG + grp;   // this warp's key tile of the set
    if (tile_j >= ntiles) continue;
    const float* kt = ring + ((j % STAGES) * KG + grp) * C::STAGE_DQ;
    const float* vt = kt + C::TILE;
    const int k0 = tile_j * BLOCK;
    const bool masked = !(k0 + BLOCK <= klen && q0 + BLOCK <= qlen &&
                          (!causal || k0 + BLOCK - 1 <= q0));

    // S = Q.K^T and dP = dO.V^T: the warp's 16 rows x the tile's 64 keys
    float s[1][NT][4], dp[1][NT][4];
    zero_acc(s[0]);
    zero_acc(dp[0]);
    product_abt<D>(s, qs, rw, kt);
    product_abt<D>(dp, dos, rw, vt);

    // dS in place of S: (row g + 8 (c >> 1), key 8n + 2t + (c & 1))
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        float p = expf(s[0][n][c] * scale - row_lse[r]);
        if (masked) {
          const int kj = k0 + 8 * n + 2 * t + (c & 1);
          if (!(qi[r] < qlen && kj < klen && (!causal || kj <= qi[r])))
            p = 0.f;
        }
        s[0][n][c] = p * (dp[0][n][c] - row_delta[r]) * scale;
      }

    // dQ += dS.K over the tile's keys
    product_ab<D, DT>(dqs, s, kt, 0);
  }
  cp_async_wait<0>();

  if (!merge_groups<KG, THREADS>(dqs, ring)) return;
  store_rows<DT>(dq + qdb, ld, dqs, qi, Tq, qlen);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D, int KG>
cudaError_t launch_dkv_kg(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dk, float* dv,
                       const int* kv_len, const int* q_len, int B, int Tq,
                       int Tk, int H, int causal, float scale,
                       cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr size_t smem = C::dkv_bytes(KG);
  static_assert(smem <= 232448, "shared memory of a block");
  static_assert((KG - 1) * 8 * (D / 8 / C::CG) * C::DKV_THREADS <=
                    STAGES * KG * C::STAGE_DKV,
                "the walk groups' merge fits in the ring");
  const cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D, KG>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Tk + BLOCK - 1) / BLOCK);
  flash_bwd_dkv_kernel<D, KG><<<grid, C::DKV_THREADS * KG, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, kv_len, q_len, Tq, Tk, H, causal,
      scale);
  return cudaGetLastError();
}

template <int D, int KG>
cudaError_t launch_dq_kg(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      float* dq, const int* kv_len, const int* q_len, int B,
                      int Tq, int Tk, int H, int causal, float scale,
                      cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr size_t smem = C::dq_bytes(KG);
  static_assert(smem <= 232448, "shared memory of a block");
  static_assert((KG - 1) * 4 * D / 8 * THREADS <= STAGES * KG * C::STAGE_DQ,
                "the walk groups' merge fits in the ring");
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel<D, KG>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Tq + BLOCK - 1) / BLOCK);
  flash_bwd_dq_kernel<D, KG><<<grid, THREADS * KG, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, kv_len, q_len, Tq, Tk, H, causal, scale);
  return cudaGetLastError();
}

// two walk groups where a walk reaches KG_MIN_WALK tiles (dkv walks query
// tiles, dq key tiles) and they fit
template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dk, float* dv,
                       const int* kv_len, const int* q_len, int B, int Tq,
                       int Tk, int H, int causal, float scale,
                       cudaStream_t stream) {
  if ((Tq + BLOCK - 1) / BLOCK >= KG_MIN_WALK)
    return launch_dkv_kg<D, Cfg<D>::KG_MAX>(q, k, v, dout, lse, delta, dk,
                                            dv, kv_len, q_len, B, Tq, Tk, H,
                                            causal, scale, stream);
  return launch_dkv_kg<D, 1>(q, k, v, dout, lse, delta, dk, dv, kv_len,
                             q_len, B, Tq, Tk, H, causal, scale, stream);
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      float* dq, const int* kv_len, const int* q_len, int B,
                      int Tq, int Tk, int H, int causal, float scale,
                      cudaStream_t stream) {
  if ((Tk + BLOCK - 1) / BLOCK >= KG_MIN_WALK)
    return launch_dq_kg<D, Cfg<D>::KG_MAX>(q, k, v, dout, lse, delta, dq,
                                           kv_len, q_len, B, Tq, Tk, H,
                                           causal, scale, stream);
  return launch_dq_kg<D, 1>(q, k, v, dout, lse, delta, dq, kv_len, q_len,
                            B, Tq, Tk, H, causal, scale, stream);
}

cudaError_t prologue(int B, int Tq, int Tk, int H, int device) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || B > 65535 ||
      (Tq + BLOCK - 1) / BLOCK > 65535 || (Tk + BLOCK - 1) / BLOCK > 65535)
    return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

}  // namespace

// Plain C entry points, loaded with ctypes. D is 32, 64, 96 or 128 (the
// wrapper pads any other D <= 128 with zero columns), or a multiple of 64
// above 128 (the D-split; the wrapper pads to it); q, k, v and dout
// 16-byte aligned. kv_len and q_len may be null (no mask). Each launches one
// kernel on `stream` of `device`, does not synchronise, and returns the
// launch's cudaError_t (0 = launched). dk and dv are fully written (0 for
// keys at or past kv_len); so is dq (0 for rows at or past q_len).
extern "C" int flash_attn_bwd_dkv(const float* q, const float* k,
                                  const float* v, const float* dout,
                                  const float* lse, const float* delta,
                                  float* dk, float* dv, const int* kv_len,
                                  const int* q_len, int B, int Tq, int Tk,
                                  int H, int D, int causal, float scale,
                                  int device, void* stream) {
  cudaError_t err = prologue(B, Tq, Tk, H, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, kv_len,
                                 q_len, B, Tq, Tk, H, causal, scale, st);
    case 64:
      return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, kv_len,
                                 q_len, B, Tq, Tk, H, causal, scale, st);
    case 96:
      return (int)launch_dkv<96>(q, k, v, dout, lse, delta, dk, dv, kv_len,
                                 q_len, B, Tq, Tk, H, causal, scale, st);
    case 128:
      return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, kv_len,
                                  q_len, B, Tq, Tk, H, causal, scale, st);
    default:   // D > 128, a multiple of 64: the D-split (flash_dsplit.cuh)
      return (int)dsplit::launch_dkv<dsplit::F32>(q, k, v, dout, lse, delta,
                                                  dk, dv, kv_len, q_len, B,
                                                  Tq, Tk, H, D, causal, scale,
                                                  st);
  }
}

extern "C" int flash_attn_bwd_dq(const float* q, const float* k,
                                 const float* v, const float* dout,
                                 const float* lse, const float* delta,
                                 float* dq, const int* kv_len,
                                 const int* q_len, int B, int Tq, int Tk,
                                 int H, int D, int causal, float scale,
                                 int device, void* stream) {
  cudaError_t err = prologue(B, Tq, Tk, H, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch_dq<32>(q, k, v, dout, lse, delta, dq, kv_len, q_len,
                                B, Tq, Tk, H, causal, scale, st);
    case 64:
      return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, kv_len, q_len,
                                B, Tq, Tk, H, causal, scale, st);
    case 96:
      return (int)launch_dq<96>(q, k, v, dout, lse, delta, dq, kv_len, q_len,
                                B, Tq, Tk, H, causal, scale, st);
    case 128:
      return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, kv_len,
                                 q_len, B, Tq, Tk, H, causal, scale, st);
    default:   // D > 128, a multiple of 64: the D-split (flash_dsplit.cuh)
      return (int)dsplit::launch_dq<dsplit::F32>(q, k, v, dout, lse, delta,
                                                 dq, kv_len, q_len, B, Tq, Tk,
                                                 H, D, causal, scale, st);
  }
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ============================================================ the bf16 forms
// dkv and dq on bf16 q, k, v and dout (lse, delta f32; dq, dk, dv bf16), with
// the library kernels' roundings (jax/experimental/pallas/ops/tpu/
// flash_attention.py, run in q's dtype under the AMP rule): S and dP from
// bf16 operands in f32; p = exp(s * scale - lse) and ds = p * (dp - delta) *
// scale in f32; p rounded to bf16 before dV += P^T.dO, ds before dK +=
// dS^T.Q and dQ += dS.K; every sum in f32, each output rounded to bf16 once,
// at the end. ops/flash_attention.py::attention_bwd_plain_bf16 states it.
//
// What bounds them on one H100 SXM: 8*D*H flops a visible pair for dkv and
// 6*D*H for dq on the tensor cores' bf16 rate (989 TFLOP/s dense), one pass:
// at the long-context trainer's shape (B=4, T=4096, H=8, D=64, causal,
// 268.5 M visible pairs) ~0.139 and ~0.104 ms, well above their bytes.
//
// Design (hopper_wgmma.cuh has the pieces and the tile layouts; the
// forward's block shape and loop; the choices below were timed in turns
// on one H100 by flash_bwd_probe.py): three warpgroups a block, two
// consumers and a producer that hands them its registers (240 a consumer
// thread) and whose one warp issues TMA loads into a four-stage ring with
// full and empty mbarriers (three stages were up to 7% slower). p = 2^(s *
// c - lse * log2(e)) with c = scale * log2(e): one FFMA, one MUFU.EX2.
// Pairs are tested against the masks only on tiles that cross them, and a
// masked pair's p and ds are 0 by selection, so rows past kv_len may hold
// anything (NaN too). Within a warpgroup a walked tile's first two
// products are issued before the previous tile's last ones, and its P and
// dS are formed while those are in flight (the first and the last are
// peeled off the loop: no product under a branch).
// - dkv: one block per (h, b, 128-key tile), each warpgroup owning 64 keys'
//   dK and dV accumulators; K and V arrive once, then the block walks the
//   query tiles that can see its keys (64 queries at D <= 64, 32 at D = 128
//   for registers), Q and dO by TMA and their lse (times log2(e)) and delta
//   copied by the producer warp. S^T = K.Q^T and dP^T = V.dO^T are wgmma
//   with B (Q, dO as they lie) K-major in shared memory and A the
//   warpgroup's K and V rows, loaded once into registers by ldmatrix at D
//   <= 64 (3% faster than A from shared memory) and from shared memory at
//   D = 128. P^T and dS^T are formed in registers and packed
//   (cvt.rn.bf16x2) into register A fragments of dV += P^T.dO and dK +=
//   dS^T.Q, whose B (dO, Q) is MN-major. A warpgroup skips the causal
//   tiles that lie wholly before its keys.
// - dq: one block per (h, b, 128-query tile); Q and dO arrive once (their
//   A fragments into registers at D <= 64, as dkv's K and V), the block
//   walks 64-key tiles of K and V up to its last visible key (128-key
//   tiles were 6% slower at D = 64). S = Q.K^T and dP = dO.V^T by wgmma
//   (B K-major), dS in registers, dQ += dS.K with K MN-major as B. On the
//   tile that crosses kv_len each warpgroup zeroes K's rows from kv_len (dS
//   is 0 there, but 0 * NaN is not); causal tiles wholly past a
//   warpgroup's rows are skipped.
// - One writer an output (dq is not fused into dkv through atomics), a
//   fixed order: bit-identical from run to run. dk, dv of keys at or past
//   kv_len and dq of rows at or past q_len are written as exact zeros.
// D = 96 is not instantiated: ops/flash_attention.py pads it to 128.

#include "hopper_wgmma.cuh"

namespace {

// the first products' A operand (K, V in dkv; Q, dO in dq) from registers
// (at D = 128 they would not fit beside the sums: from shared memory)
template <int D>
constexpr bool A_REGS = D <= 64;

template <int D>
struct DkvWg {
  static constexpr int BK = 128;                   // keys a block
  static constexpr int BQ = D <= 64 ? 64 : 32;     // queries a walked tile
  static constexpr int STAGES = 4;
  static constexpr int K_BYTES = BK * D * 2;       // K or V
  static constexpr int QT_BYTES = BQ * D * 2;      // Q or dO of a stage
  static constexpr int RING = 2 * K_BYTES;         // offsets in the block
  static constexpr int ROWS = RING + STAGES * 2 * QT_BYTES;   // lse, delta
  static constexpr int BARS = ROWS + STAGES * 2 * BQ * 4;
  static constexpr size_t BYTES = wg_smem(BARS + 8 * (1 + 2 * STAGES) + 1024);
};

template <int D>
struct DqWg {
  static constexpr int BM = 128;                   // query rows a block
  static constexpr int BN = 64;                    // keys a walked tile
  static constexpr int STAGES = 4;
  static constexpr int Q_BYTES = BM * D * 2;       // Q or dO
  static constexpr int KV_BYTES = BN * D * 2;      // K or V of a stage
  static constexpr int RING = 2 * Q_BYTES;
  static constexpr int BARS = RING + STAGES * 2 * KV_BYTES;
  static constexpr size_t BYTES = wg_smem(BARS + 8 * (1 + 2 * STAGES) + 1024);
};

// rows r (accumulator entries 4n + 2r, 4n + 2r + 1) of a warpgroup's
// [64][D] sum, rounded to bf16, into out [*, ld] at row `row[r]` (skipped
// at or past `rows`, zeros at or past `live`)
template <int D>
__device__ __forceinline__ void store_rows_wg(bf16* __restrict__ out, int ld,
                                              const float (&sum)[D / 2],
                                              const int (&row)[2], int rows,
                                              int live) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= rows) continue;
    bf16* o = out + (size_t)row[r] * ld;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      unsigned x = 0u;
      if (row[r] < live)
        x = pack_bf16x2(sum[4 * n + 2 * r], sum[4 * n + 2 * r + 1]);
      *reinterpret_cast<unsigned*>(o + 8 * n + 2 * t) = x;
    }
  }
}

// One block per (h, b, 128-key tile): dk and dv of the tile's keys.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           const int* __restrict__ kv_len,
                           const int* __restrict__ q_len, int Tq, int Tk,
                           int H, int causal, float scale, float c) {
  using C = DkvWg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, STAGES = C::STAGES;
  constexpr int AC = atom_cols(D);
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* sm = align1024(smem_wg);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + C::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  float* rows = reinterpret_cast<float*>(sm + C::ROWS);

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;       // low key tiles, the heaviest, first
  const int klen = warp_uniform(clamp_len(kv_len, b, Tk));
  const int qlen = warp_uniform(clamp_len(q_len, b, Tq));
  const int qbeg = causal ? k0 : 0;
  const int qend = k0 < klen ? qlen : 0;
  const int ntiles = qbeg < qend ? (qend - qbeg + BQ - 1) / BQ : 0;
  const size_t bh = (size_t)b * H + h;

  init_ring(kv_full, STAGES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wgi = warp_uniform(threadIdx.x >> 7);   // the warpgroup

  if (wgi == 2) {      // the producer: its first warp
    producer_regs();
    if (warp != WG_CONSUMER_WARPS || ntiles == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * C::K_BYTES);
      for (int a = 0; a < D / AC; ++a) {
        tma_load(sm + a * BK * 2 * AC, &tk, kv_full, a * AC, h, k0, b);
        tma_load(sm + C::K_BYTES + a * BK * 2 * AC, &tv, kv_full, a * AC, h,
                 k0, b);
      }
    }
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % STAGES, i0 = qbeg + j * BQ;
      mbar_wait(empty + s, ((j / STAGES) & 1) ^ 1);
      float* rs = rows + s * 2 * BQ;    // lse * log2(e), then delta
      for (int x = lane; x < BQ; x += 32) {
        const bool in = i0 + x < Tq;
        rs[x] = in ? lse[bh * Tq + i0 + x] * LOG2E : 0.f;
        rs[BQ + x] = in ? delta[bh * Tq + i0 + x] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(full + s, 2 * C::QT_BYTES);
        unsigned char* qt = sm + C::RING + s * 2 * C::QT_BYTES;
        for (int a = 0; a < D / AC; ++a) {
          tma_load(qt + a * BQ * 2 * AC, &tq, full + s, a * AC, h, i0, b);
          tma_load(qt + C::QT_BYTES + a * BQ * 2 * AC, &tdo, full + s,
                   a * AC, h, i0, b);
        }
      }
    }
    return;
  }
  consumer_regs();

  // a consumer warpgroup: keys kw0.., this thread's keys key[0] (entries
  // 4n, 4n + 1) and key[1] (4n + 2, 4n + 3)
  const int wg = wgi;
  const int g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + 64 * wg;
  const int key[2] = {kw0 + 16 * (warp & 3) + g,
                      kw0 + 16 * (warp & 3) + g + 8};
  const unsigned ks = smem_u32(sm), vs = ks + C::K_BYTES;
  auto qtile = [&](int j) {             // Q of walked tile j, then dO
    return smem_u32(sm + C::RING + (j % STAGES) * 2 * C::QT_BYTES);
  };
  float dks[D / 2], dvs[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dks[i] = dvs[i] = 0.f;
  float st[BQ / 2], dpt[BQ / 2];        // S^T, dP^T: 64 keys x BQ queries
  unsigned pa[BQ / 16][4], da[BQ / 16][4];   // the previous P^T, dS^T

  auto arrived = [&](int j) {
    mbar_wait(full + j % STAGES, (j / STAGES) & 1);
  };
  auto release = [&](int j) {
    mbar_arrive_if(empty + j % STAGES, lane == 0);
  };
  // at D <= 64 the warpgroup's K and V rows stay in registers as A
  // fragments (half the shared-memory reads of S^T and dP^T)
  unsigned ka[A_REGS<D> ? D / 16 : 1][4], va[A_REGS<D> ? D / 16 : 1][4];
  auto issue_s = [&](int j) {           // S^T = K.Q^T, dP^T = V.dO^T
    const unsigned qt = qtile(j), dot = qt + C::QT_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      if constexpr (A_REGS<D>)
        wgmma_rs_k<BQ>(st, ka[kk], desc_k<D>(qt, BQ, 0, kk), kk);
      else
        wgmma_ss<BQ>(st, desc_k<D>(ks, BK, 64 * wg, kk),
                     desc_k<D>(qt, BQ, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      if constexpr (A_REGS<D>)
        wgmma_rs_k<BQ>(dpt, va[kk], desc_k<D>(dot, BQ, 0, kk), kk);
      else
        wgmma_ss<BQ>(dpt, desc_k<D>(vs, BK, 64 * wg, kk),
                     desc_k<D>(dot, BQ, 0, kk), kk);
    wgmma_commit();
  };
  auto issue_d = [&](int j) {           // dV += P^T.dO, dK += dS^T.Q
    const unsigned qt = qtile(j), dot = qt + C::QT_BYTES;
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<D>(dvs, pa[kk], desc_mn<D>(dot, BQ, kk), 1);
      wgmma_rs<D>(dks, da[kk], desc_mn<D>(qt, BQ, kk), 1);
    }
    wgmma_commit();
  };
  // P^T, dS^T of tile j in place: (key[(e >> 1) & 1], query 8n + 2t +
  // (e & 1)), then packed to bf16
  auto form = [&](int j) {
    const int i0 = qbeg + j * BQ;
    const float* rs = rows + (j % STAGES) * 2 * BQ;
    const bool masked = !(kw0 + 64 <= klen && i0 + BQ <= qlen &&
                          (!causal || kw0 + 63 <= i0));
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      const int qc = 8 * n + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(rs + qc);
      const float2 d2 = *reinterpret_cast<const float2*>(rs + BQ + qc);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int e = 4 * n + x;
        float p = ex2(fmaf(st[e], c, -((x & 1) ? l2.y : l2.x)));
        float ds = p * (dpt[e] - ((x & 1) ? d2.y : d2.x)) * scale;
        if (masked) {
          const int kj = key[x >> 1], qi = i0 + qc + (x & 1);
          if (!(kj < klen && qi < qlen && (!causal || kj <= qi)))
            p = ds = 0.f;
        }
        st[e] = p;
        dpt[e] = ds;
      }
    }
  };

  // The walk: the causal tiles wholly before the warpgroup's keys are
  // skipped; on the others tile j's S^T and dP^T are issued before tile
  // j - 1's dV and dK products, and P^T, dS^T formed while those are in
  // flight (the first and the last are peeled off the loop, so no
  // product is issued under a branch).
  const int jbeg = causal ? min(ntiles, (kw0 - qbeg) / BQ) : 0;
  if (ntiles > 0) {
    mbar_wait(kv_full, 0);
    if constexpr (A_REGS<D>) {
      load_a<D>(ka, ks, BK, 64 * wg);
      load_a<D>(va, vs, BK, 64 * wg);
    }
  }
  for (int j = 0; j < jbeg; ++j) {
    arrived(j);
    release(j);
  }
  if (jbeg < ntiles) {
    arrived(jbeg);
    wgmma_fence();
    issue_s(jbeg);
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    form(jbeg);
    pack_a<BQ>(pa, st);
    pack_a<BQ>(da, dpt);
    for (int j = jbeg + 1; j < ntiles; ++j) {
      arrived(j);
      wgmma_fence();
      issue_s(j);
      issue_d(j - 1);
      wgmma_wait<1>();
      fence_regs(st);
      fence_regs(dpt);
      form(j);
      wgmma_wait<0>();                  // tile j - 1's products are done
      fence_regs(dvs);
      fence_regs(dks);
      release(j - 1);
      pack_a<BQ>(pa, st);
      pack_a<BQ>(da, dpt);
    }
    wgmma_fence();
    issue_d(ntiles - 1);
    wgmma_wait<0>();
    fence_regs(dvs);
    fence_regs(dks);
  }

  const size_t kvb = ((size_t)b * Tk * H + h) * D;
  store_rows_wg<D>(dk + kvb, H * D, dks, key, Tk, klen);
  store_rows_wg<D>(dv + kvb, H * D, dvs, key, Tk, klen);
}

// One block per (h, b, 128-query tile): dq of the tile's queries.
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq,
                          const int* __restrict__ kv_len,
                          const int* __restrict__ q_len, int Tq, int Tk,
                          int H, int causal, float scale, float c) {
  using C = DqWg<D>;
  constexpr int BM = C::BM, BN = C::BN, STAGES = C::STAGES;
  constexpr int AC = atom_cols(D);
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* sm = align1024(smem_wg);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  // high query tiles, the heaviest when causal, first
  const int tile = causal ? (int)gridDim.z - 1 - (int)blockIdx.z
                          : (int)blockIdx.z;
  const int q0 = tile * BM;
  const int klen = warp_uniform(clamp_len(kv_len, b, Tk));
  const int qlen = warp_uniform(clamp_len(q_len, b, Tq));
  int kend = klen;                       // keys any row of the block sees
  if (causal) kend = min(kend, q0 + BM);
  if (q0 >= qlen) kend = 0;
  const int ntiles = (kend + BN - 1) / BN;

  init_ring(q_full, STAGES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wgi = warp_uniform(threadIdx.x >> 7);   // the warpgroup

  if (wgi == 2) {      // the producer
    producer_regs();
    if (warp != WG_CONSUMER_WARPS || lane != 0 || ntiles == 0) return;
    mbar_expect_tx(q_full, 2 * C::Q_BYTES);
    for (int a = 0; a < D / AC; ++a) {
      tma_load(sm + a * BM * 2 * AC, &tq, q_full, a * AC, h, q0, b);
      tma_load(sm + C::Q_BYTES + a * BM * 2 * AC, &tdo, q_full, a * AC, h,
               q0, b);
    }
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(empty + s, ((j / STAGES) & 1) ^ 1);
      mbar_expect_tx(full + s, 2 * C::KV_BYTES);
      unsigned char* kt = sm + C::RING + s * 2 * C::KV_BYTES;
      for (int a = 0; a < D / AC; ++a) {
        tma_load(kt + a * BN * 2 * AC, &tk, full + s, a * AC, h, j * BN, b);
        tma_load(kt + C::KV_BYTES + a * BN * 2 * AC, &tv, full + s, a * AC,
                 h, j * BN, b);
      }
    }
    return;
  }
  consumer_regs();

  // a consumer warpgroup: rows qw0.., this thread's rows row[0] (entries
  // 4n, 4n + 1) and row[1] (4n + 2, 4n + 3)
  const int wg = wgi, tid = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + 64 * wg;
  const int row[2] = {qw0 + 16 * (warp & 3) + g,
                      qw0 + 16 * (warp & 3) + g + 8};
  float lse2[2], dl[2];                  // lse * log2(e), delta of the rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = ((size_t)b * H + h) * Tq + row[r];
    lse2[r] = row[r] < Tq ? lse[at] * LOG2E : 1e30f;
    dl[r] = row[r] < Tq ? delta[at] : 0.f;
  }
  const unsigned qs = smem_u32(sm), dos = qs + C::Q_BYTES;
  auto ktile = [&](int j) {              // K of key tile j, then V
    return smem_u32(sm + C::RING + (j % STAGES) * 2 * C::KV_BYTES);
  };
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[BN / 2], dp[BN / 2];          // S, dP: 64 rows x BN keys
  unsigned da[BN / 16][4];               // the previous tile's dS, bf16

  // key tile j arrived; K's rows from kv_len zeroed
  auto arrived = [&](int j) {
    mbar_wait(full + j % STAGES, (j / STAGES) & 1);
    if (j * BN + BN > klen) {
      zero_rows<D, BN>(sm + C::RING + (j % STAGES) * 2 * C::KV_BYTES,
                       klen - j * BN, tid);
      named_sync(1 + wg, 128);
    }
  };
  auto release = [&](int j) {
    mbar_arrive_if(empty + j % STAGES, lane == 0);
  };
  // at D <= 64 the warpgroup's Q and dO rows stay in registers as A
  // fragments (half the shared-memory reads of S and dP)
  unsigned qa[A_REGS<D> ? D / 16 : 1][4], oa[A_REGS<D> ? D / 16 : 1][4];
  auto issue_s = [&](int j) {            // S = Q.K^T, dP = dO.V^T
    const unsigned ka = ktile(j), va = ka + C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      if constexpr (A_REGS<D>)
        wgmma_rs_k<BN>(sc, qa[kk], desc_k<D>(ka, BN, 0, kk), kk);
      else
        wgmma_ss<BN>(sc, desc_k<D>(qs, BM, 64 * wg, kk),
                     desc_k<D>(ka, BN, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      if constexpr (A_REGS<D>)
        wgmma_rs_k<BN>(dp, oa[kk], desc_k<D>(va, BN, 0, kk), kk);
      else
        wgmma_ss<BN>(dp, desc_k<D>(dos, BM, 64 * wg, kk),
                     desc_k<D>(va, BN, 0, kk), kk);
    wgmma_commit();
  };
  auto issue_dq = [&](int j) {           // dQ += dS.K of tile j
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<D>(acc, da[kk], desc_mn<D>(ktile(j), BN, kk), 1);
    wgmma_commit();
  };
  // dS of tile j in place of S: (row[(e >> 1) & 1], key 8n + 2t + (e & 1))
  auto form = [&](int j) {
    const int k0 = j * BN;
    const bool masked = !(k0 + BN <= klen && qw0 + 64 <= qlen &&
                          (!causal || k0 + BN - 1 <= qw0));
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int r = (e >> 1) & 1;
      const float p = ex2(fmaf(sc[e], c, -lse2[r]));
      float ds = p * (dp[e] - dl[r]) * scale;
      if (masked) {
        const int kj = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        if (!(row[r] < qlen && kj < klen && (!causal || kj <= row[r])))
          ds = 0.f;
      }
      sc[e] = ds;
    }
  };

  // The walk, as dkv's: tile j's S and dP are issued before tile j - 1's
  // dQ += dS.K, and dS is formed while that product is in flight; causal
  // tiles wholly past the warpgroup's rows are skipped.
  const int jend = causal ? min(ntiles, (qw0 + 63) / BN + 1) : ntiles;
  if (ntiles > 0) {
    mbar_wait(q_full, 0);
    if constexpr (A_REGS<D>) {
      load_a<D>(qa, qs, BM, 64 * wg);
      load_a<D>(oa, dos, BM, 64 * wg);
    }
  }
  if (jend > 0) {
    arrived(0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    form(0);
    pack_a<BN>(da, sc);
    for (int j = 1; j < jend; ++j) {
      arrived(j);
      wgmma_fence();
      issue_s(j);
      issue_dq(j - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      fence_regs(dp);
      form(j);
      wgmma_wait<0>();                   // tile j - 1's dQ is done
      fence_regs(acc);
      release(j - 1);
      pack_a<BN>(da, sc);
    }
    wgmma_fence();
    issue_dq(jend - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    release(jend - 1);
  }
  for (int j = jend; j < ntiles; ++j) {
    arrived(j);
    release(j);
  }

  store_rows_wg<D>(dq + ((size_t)b * Tq * H + h) * D, H * D, acc, row, Tq,
                   qlen);
}

// the four tensor maps of a backward call: q and dout with `q_rows`-row
// boxes, k and v with `k_rows`-row boxes
inline bool bwd_maps(CUtensorMap (&m)[4], const bf16* q, const bf16* k,
                     const bf16* v, const bf16* dout, int B, int Tq, int Tk,
                     int H, int D, int q_rows, int k_rows) {
  return bthd_map(&m[0], q, B, Tq, H, D, q_rows) &&
         bthd_map(&m[1], k, B, Tk, H, D, k_rows) &&
         bthd_map(&m[2], v, B, Tk, H, D, k_rows) &&
         bthd_map(&m[3], dout, B, Tq, H, D, q_rows);
}

template <int D>
cudaError_t launch_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                            const bf16* dout, const float* lse,
                            const float* delta, bf16* dk, bf16* dv,
                            const int* kv_len, const int* q_len, int B,
                            int Tq, int Tk, int H, int causal, float scale,
                            cudaStream_t stream) {
  using C = DkvWg<D>;
  static_assert(C::BYTES <= 232448, "shared memory of a block");
  CUtensorMap m[4];
  if (!bwd_maps(m, q, k, v, dout, B, Tq, Tk, H, D, C::BQ, C::BK))
    return cudaErrorInvalidValue;
  const cudaError_t err =
      allow_smem(flash_bwd_dkv_wgmma_kernel<D>, C::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Tk + C::BK - 1) / C::BK);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, WG_THREADS, C::BYTES, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, dk, dv, kv_len, q_len, Tq, Tk, H,
      causal, scale, scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                           const bf16* dout, const float* lse,
                           const float* delta, bf16* dq, const int* kv_len,
                           const int* q_len, int B, int Tq, int Tk, int H,
                           int causal, float scale, cudaStream_t stream) {
  using C = DqWg<D>;
  static_assert(C::BYTES <= 232448, "shared memory of a block");
  CUtensorMap m[4];
  if (!bwd_maps(m, q, k, v, dout, B, Tq, Tk, H, D, C::BM, C::BN))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(flash_bwd_dq_wgmma_kernel<D>, C::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Tq + C::BM - 1) / C::BM);
  flash_bwd_dq_wgmma_kernel<D><<<grid, WG_THREADS, C::BYTES, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, dq, kv_len, q_len, Tq, Tk, H,
      causal, scale, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// The bf16 forms' entry points: as flash_attn_bwd_dkv and flash_attn_bwd_dq,
// with q, k, v, dout, dq, dk and dv bf16 (lse and delta f32), D in 32, 64,
// 128 or a multiple of 64 above 128 (the D-split) and scale >= 0 (the wrapper pads D = 96 and negates q for a negative
// scale).
extern "C" int flash_attn_bwd_dkv_bf16(const bf16* q, const bf16* k,
                                       const bf16* v, const bf16* dout,
                                       const float* lse, const float* delta,
                                       bf16* dk, bf16* dv, const int* kv_len,
                                       const int* q_len, int B, int Tq,
                                       int Tk, int H, int D, int causal,
                                       float scale, int device,
                                       void* stream) {
  if (!(scale >= 0.f)) return (int)cudaErrorInvalidValue;
  cudaError_t err = prologue(B, Tq, Tk, H, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch_dkv_bf16<32>(q, k, v, dout, lse, delta, dk, dv,
                                      kv_len, q_len, B, Tq, Tk, H, causal,
                                      scale, st);
    case 64:
      return (int)launch_dkv_bf16<64>(q, k, v, dout, lse, delta, dk, dv,
                                      kv_len, q_len, B, Tq, Tk, H, causal,
                                      scale, st);
    case 128:
      return (int)launch_dkv_bf16<128>(q, k, v, dout, lse, delta, dk, dv,
                                       kv_len, q_len, B, Tq, Tk, H, causal,
                                       scale, st);
    default:   // D > 128, a multiple of 64: the D-split (flash_dsplit.cuh)
      return (int)dsplit::launch_dkv<dsplit::BF16>(q, k, v, dout, lse, delta,
                                                   dk, dv, kv_len, q_len, B,
                                                   Tq, Tk, H, D, causal,
                                                   scale, st);
  }
}

extern "C" int flash_attn_bwd_dq_bf16(const bf16* q, const bf16* k,
                                      const bf16* v, const bf16* dout,
                                      const float* lse, const float* delta,
                                      bf16* dq, const int* kv_len,
                                      const int* q_len, int B, int Tq, int Tk,
                                      int H, int D, int causal, float scale,
                                      int device, void* stream) {
  if (!(scale >= 0.f)) return (int)cudaErrorInvalidValue;
  cudaError_t err = prologue(B, Tq, Tk, H, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch_dq_bf16<32>(q, k, v, dout, lse, delta, dq, kv_len,
                                     q_len, B, Tq, Tk, H, causal, scale, st);
    case 64:
      return (int)launch_dq_bf16<64>(q, k, v, dout, lse, delta, dq, kv_len,
                                     q_len, B, Tq, Tk, H, causal, scale, st);
    case 128:
      return (int)launch_dq_bf16<128>(q, k, v, dout, lse, delta, dq, kv_len,
                                      q_len, B, Tq, Tk, H, causal, scale, st);
    default:   // D > 128, a multiple of 64: the D-split (flash_dsplit.cuh)
      return (int)dsplit::launch_dq<dsplit::BF16>(q, k, v, dout, lse, delta,
                                                  dq, kv_len, q_len, B, Tq,
                                                  Tk, H, D, causal, scale,
                                                  st);
  }
}
