// Fused BN -> ReLU -> 1x1-conv GEMM with a statistics epilogue, and its two
// backward GEMMs, for Hopper (sm_90a): the f32 forms, then the bf16 forms of
// the AMP rule (their own section below, "the bf16 forms").
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_fused.py:
//   B1 _fwd_kernel     (via _fwd_call):  y = z @ w, ssum = sum_n y, ssq = sum_n y^2
//   B2 _bwd_dx_kernel  (via _bwd_impl):  du, dres, dscale, dshift
//   B3 _bwd_dw_kernel  (via _bwd_impl):  dw = z^T @ dy_eff
// with z = act(u * scale + shift [+ res]) recomputed from u wherever it is
// needed and never written to device memory, and
// dy_eff = dy + d1 + 2 * y * d2 (the cotangents of y, ssum and ssq). Rows at
// or past N are masked by the kernels themselves (no padding to a block
// size): they reach neither y nor any sum, even where relu(shift) > 0.
//
// The TPU kernels walk row blocks in order and add the column sums (B1, B2)
// and dw (B3) into one resident output block. Hopper's blocks run in any
// order, so here every block writes its column partials (B1 and B2: one a
// block, over the row tiles it walks) to a scratch array,
// and B3 splits the rows into chunks (split-K) with partial dw [splits, Cin,
// Cout]; a second small kernel of the same launch sums the partials in a
// fixed order. No atomics: results are the same run to run.
//
// Rounding: pre = u * scale + shift [+ res] is computed as separate rounded
// multiply and adds (__fmul_rn / __fadd_rn, no FMA contraction), the order
// PyTorch's elementwise ops round in, so the ReLU gate of the kernels is the
// gate of the plain version (ops/bn_act_conv1x1.py) bit for bit.
//
// What bounds them on one H100 SXM. Each kernel is one GEMM of 2*N*Cin*Cout
// operations that reads u and y/dy once (3.35 TB/s).
// - All three run on the tensor cores at f32 accuracy (3xTF32, the PTX and
//   the split in tf32_mma.cuh): each operand
//   x is split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and
//   hi*hi' + hi*lo' + lo*hi' is accumulated in f32 by mma.sync m16n8k8 TF32
//   (495 TFLOP/s dense, so 3 passes cost 3 * 2*N*Cin*Cout / 495e12 s; the
//   mma.sync form reached ~290-320 TFLOP/s on an H100 SXM at 700 W). One
//   pass of TF32 keeps ~3 digits and is not used. At the ResNet-50 shapes
//   they are then bounded by bytes (the res2 tail at batch 64, N = 200,704,
//   Cin 64, Cout 256: 0.077 ms B1, 0.153 ms B2, 0.138 ms B3; B1's y alone is
//   205.5 of its 257 MB) or, at the res4 and res5 sites, by the three
//   passes (0.040 ms).
// - The tensor cores add each product sum into the accumulator with
//   truncation, so the error grows with the adds an accumulator takes: B3
//   flushes its accumulators into f32 sums in shared memory every DW_FLUSH
//   stages, B1 into f32 sums in registers every FWD_FLUSH stages where Cin >
//   256; B2's chain is K = Cout deep (3 * Cout / 8 adds: ~1.6e-5 of the
//   largest du at Cout 2048 on an H100, ~2e-6 at Cout 256).
// What their design does about it:
// - Loads never wait on math: a ring of STAGES shared-memory stages is
//   filled by 16-byte cp.async (4-byte where a width is not a multiple of 4),
//   STAGES - 1 stages ahead, one __syncthreads a stage.
// - The elementwise prologue (z = act(pre) for B1's and B3's A, dy_eff for
//   B2's A and B3's B) and the hi/lo split run as a fragment leaves shared
//   memory, in registers; the shared rows are padded so that these fragment
//   reads are free of bank conflicts.
// - Tiles follow the site: B3 takes 64 x 64, 64 x 256, 256 x 64 or 128 x 128
//   of Cin x Cout by the widths (no tile half zeros at Cin = 64, and the res2
//   tail's whole dw in one block, so u, y and dy are read once), and splits
//   the rows over ~132 blocks; B2 takes 256 x 64 rows x Cin (Cin <= 64, one
//   block an SM) or 64 x 128 (two blocks an SM), B1 one of four tiles by
//   (N, Cin, Cout) (fwd_plan); in both a persistent grid walks the row
//   tiles, the next tile's loads (and for B2 u) in flight during a tile's
//   epilogue.
// - A warp owns a 32 x 64 (B3 64 x 64: 32 x 16; B1 32 x 32 to 64 x 64) tile
//   of mma tiles; the three passes are issued pass by pass over all of
//   them, so no two dependent mma are adjacent.
// - B1 splits with split_tf32_alu (integer ops, no cvt) and takes 32-deep
//   stages (half the barriers of 16); both measured faster on an H100.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "hopper_wgmma.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int RED = 32;        // partial-sum reduction block: RED x RED

// ------------------------------------------------- B2 and B3: tensor cores
constexpr int TC_BK = 16;        // depth (rows of K) of one stage
constexpr int SM_COUNT = 132;    // H100 SXM: the persistent grids' target
constexpr int DW_MIN_CHUNK = 128;  // B3: fewest rows a split
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
// B3: stages between flushes of the mma accumulators into the f32 sums in
// shared memory. The tensor cores add each product into the accumulator
// with truncation, so a long chain of adds drifts (~1.6e-5 relative over
// a 1 536-row split on an H100); 8 stages (128 rows, 48 mma a fragment)
// keep each chain short, and the flushes add in round-to-nearest.
constexpr int DW_FLUSH = 8;
constexpr int FWD_BK = 32;       // B1: depth (channels) of one stage

// A block tile of BM x BN outputs, WM x WN warps of MT x NT mma tiles
// (16 x 8 each), its ring of STAGES shared-memory stages, and the blocks an
// SM is to hold.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int BLOCKS_ = 1>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_, BLOCKS = BLOCKS_;
  static constexpr int MT = BM / (16 * WM), NT = BN / (8 * WN);
  static constexpr int THREADS = 32 * WM * WN;
  static_assert(MT * 16 * WM == BM && NT * 8 * WN == BN, "tile");
};

// B1's stage: u (and res) [BM rows][FWD_BK channels], w [FWD_BK][BN] and
// scale, shift [FWD_BK]; the column partials [WM][2][BN] after the ring
template <class T>
struct FwdSmem {
  static constexpr int A = T::BM * (FWD_BK + 4);
  static constexpr int W = FWD_BK * (T::BN + 8);
  __host__ __device__ static constexpr int stage(bool has_res) {
    return (has_res ? 2 : 1) * A + W + 2 * FWD_BK;
  }
  static constexpr size_t bytes(bool has_res) {
    return sizeof(float) *
           (T::STAGES * stage(has_res) + 2 * T::WM * T::BN);
  }
};

// ------------------------------------------------------------------ B1
// y = z @ w: M = rows, N = Cout, K = Cin. Grid (P, Cout tiles): block (p, c)
// walks the row tiles p, p + P, ... of Cout tile c, one ring of stages over
// all of them, so the next tile's first stages are in flight while a tile's
// last products and its epilogue run. A fragment's z = act(pre) is formed
// from u as it leaves shared memory (row stride FWD_BK + 4: reads of rows g,
// channels t fall in 32 banks); w's fragment reads (k = t, n = g) take a
// row stride of BN + 8. The epilogue stores y in c0/c1 pairs and adds y and
// y^2 into the thread's column partials, which stay in registers over all
// the tiles the block walks and are summed at its end, in a fixed order,
// into part[p]. Rows past N compute relu(shift) @ w and are neither stored
// nor summed. FLUSH > 0: every FLUSH stages the mma accumulators are added
// into f32 sums (round to nearest), so the tensor cores' truncating adds
// never chain over more than FLUSH * FWD_BK channels.
template <class T, int VEC, int FLUSH>
__global__ void __launch_bounds__(T::THREADS, T::BLOCKS)
fwd_kernel(const float* __restrict__ u, const float* __restrict__ scale,
           const float* __restrict__ shift, const float* __restrict__ w,
           const float* __restrict__ res, float* __restrict__ y,
           float* __restrict__ part, int N, int Cin, int Cout, int relu) {
  constexpr int BM = T::BM, BN = T::BN, MT = T::MT, NT = T::NT;
  constexpr int THREADS = T::THREADS, STAGES = T::STAGES;
  constexpr int LD = FWD_BK + 4, WLD = BN + 8, AS = FwdSmem<T>::A;
  extern __shared__ __align__(16) float smem[];
  const bool has_res = res != nullptr;
  const int wa_off = has_res ? 2 * AS : AS;    // w after u (and res)
  const int stage = FwdSmem<T>::stage(has_res);
  float* red = smem + STAGES * stage;          // [WM][2][BN]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % T::WM, wn = warp / T::WM;
  const int wa = wm * MT * 16, wb = wn * NT * 8;
  const int col0 = blockIdx.y * BN;
  const int row_tiles = (N + BM - 1) / BM;
  const int mine = (row_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;
  const int KT = (Cin + FWD_BK - 1) / FWD_BK;
  const int steps = mine * KT;

  auto load = [&](int step) {
    float* st = smem + (step % STAGES) * stage;
    const int row0 = (blockIdx.x + (step / KT) * gridDim.x) * BM;
    const int k0 = (step % KT) * FWD_BK;
    load_window<BM, FWD_BK, VEC, THREADS>(st, LD, u, Cin, row0, N, k0, Cin);
    if (has_res)
      load_window<BM, FWD_BK, VEC, THREADS>(st + AS, LD, res, Cin, row0, N,
                                           k0, Cin);
    float* ws = st + wa_off;
    load_window<FWD_BK, BN, VEC, THREADS>(ws, WLD, w, Cout, k0, Cin, col0,
                                         Cout);
    float* e = ws + FwdSmem<T>::W;
    load_window<1, FWD_BK, VEC, THREADS>(e, 0, scale, 0, 0, 1, k0, Cin);
    load_window<1, FWD_BK, VEC, THREADS>(e + FWD_BK, 0, shift, 0, 0, 1, k0,
                                         Cin);
  };

  float acc[MT][NT][4], tot[FLUSH ? MT : 1][FLUSH ? NT : 1][4];
  float ps[NT][2], pq[NT][2];  // the thread's columns' sums of y, y^2
#pragma unroll
  for (int j = 0; j < NT; ++j) ps[j][0] = ps[j][1] = pq[j][0] = pq[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[i][j][c] = 0.f;
        if (FLUSH) tot[FLUSH ? i : 0][FLUSH ? j : 0][c] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    const int kt = it % KT;
    if (FLUSH && kt > 0 && kt % (FLUSH ? FLUSH : 1) == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float& x = tot[FLUSH ? i : 0][FLUSH ? j : 0][c];
            x = __fadd_rn(x, acc[i][j][c]);
            acc[i][j][c] = 0.f;
          }
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it has landed; stage it - 1 is free
    if (it + STAGES - 1 < steps) load(it + STAGES - 1);
    cp_async_commit();
    const float* us = smem + (it % STAGES) * stage;
    const float* rs = us + AS;
    const float* ws = us + wa_off;
    const float* sc = ws + FwdSmem<T>::W;
    const float* sh = sc + FWD_BK;
#pragma unroll
    for (int kk = 0; kk < FWD_BK; kk += 8) {
      unsigned ahi[MT][4], alo[MT][4], bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // fragment k = t (q 0), t + 4 (q 1)
        const int k = kk + t + 4 * q;
        const float ck = sc[k], hk = sh[k];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // fragment row g (h 0), g + 8
            const int m = wa + i * 16 + g + 8 * h;
            // pre = u * scale + shift [+ res], rounded as PyTorch rounds
            float z = __fadd_rn(__fmul_rn(us[m * LD + k], ck), hk);
            if (has_res) z = __fadd_rn(z, rs[m * LD + k]);
            if (relu) z = fmaxf(z, 0.f);
            split_tf32_alu(z, ahi[i][2 * q + h], alo[i][2 * q + h]);
          }
#pragma unroll
        for (int j = 0; j < NT; ++j)
          split_tf32_alu(ws[k * WLD + wb + j * 8 + g], bhi[j][q], blo[j][q]);
      }
      mma3_step<MT, NT>(acc, ahi, alo, bhi, blo);
    }
    if (kt != KT - 1) continue;

    // epilogue of the row tile at row0
    const int row0 = (blockIdx.x + (it / KT) * gridDim.x) * BM;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wa + i * 16 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = col0 + wb + j * 8 + 2 * t;  // and c + 1
          float v[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            v[q] = acc[i][j][2 * h + q];
            if (FLUSH) {
              float& x = tot[FLUSH ? i : 0][FLUSH ? j : 0][2 * h + q];
              v[q] = __fadd_rn(x, v[q]);
              x = 0.f;
            }
            acc[i][j][2 * h + q] = 0.f;
          }
          if (row >= N) continue;
          const size_t off = (size_t)row * Cout + c;
          // Cout % 4 == 0 on the 16-byte path: c and c + 1 both in or out
          if (VEC == 4) {
            if (c < Cout) *reinterpret_cast<float2*>(y + off) =
                make_float2(v[0], v[1]);
          } else {
            if (c < Cout) y[off] = v[0];
            if (c + 1 < Cout) y[off + 1] = v[1];
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (c + q >= Cout) continue;
            ps[j][q] = __fadd_rn(ps[j][q], v[q]);
            pq[j][q] = fmaf(v[q], v[q], pq[j][q]);
          }
        }
      }
  }
  cp_async_wait<0>();

  // the block's column partials: over the 8 lanes of one t (a fixed
  // butterfly), then over the WM warps of one column in order
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) {
        ps[j][q] += __shfl_xor_sync(0xffffffffu, ps[j][q], x);
        pq[j][q] += __shfl_xor_sync(0xffffffffu, pq[j][q], x);
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = wb + j * 8 + 2 * t + q;
        red[(wm * 2) * BN + c] = ps[j][q];
        red[(wm * 2 + 1) * BN + c] = pq[j][q];
      }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < 2 * BN; x += THREADS) {
    const int which = x / BN, c = x % BN;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < T::WM; ++r) s += red[(r * 2 + which) * BN + c];
    if (col0 + c < Cout)
      part[((size_t)which * gridDim.x + blockIdx.x) * Cout + col0 + c] = s;
  }
}

// B2's shared memory: the ring of stages (dy, y, w, d1, d2), the tile's u,
// the column partials and the tile's scale and shift
template <class T>
struct DxSmem {
  static constexpr int STAGE = (2 * T::BM + T::BN) * (TC_BK + 4) + 2 * TC_BK;
  static constexpr size_t BYTES =
      sizeof(float) * (T::STAGES * STAGE + T::BM * (T::BN + 8) +
                       2 * T::WM * T::BN + 2 * T::BN);
};

// ------------------------------------------------------------------ B2
// dz = dy_eff @ w^T: M = rows, N = Cin, K = Cout. Grid (P, Cin tiles): block
// (p, c) walks the row tiles p, p + P, ... of Cin tile c. A stage holds dy
// and y [BM rows][TC_BK outputs], w [BN channels][TC_BK outputs] (w read
// transposed in place) and d1, d2 [TC_BK]; row stride TC_BK + 4, so that a
// fragment's 32 reads (rows g, outputs t) fall in 32 banks. The tile's u
// [BM][BN] comes in by cp.async with the tile's first stage, so the
// epilogue reads it from shared memory; it gates by the recomputed
// preactivation, writes du and dres, and adds dz*u and dz into the
// thread's column partials, which the block sums at its end into part[p].
template <class T, int VEC>
__global__ void __launch_bounds__(T::THREADS, T::BLOCKS)
bwd_dx_kernel(const float* __restrict__ u, const float* __restrict__ scale,
              const float* __restrict__ shift, const float* __restrict__ w,
              const float* __restrict__ res, const float* __restrict__ y,
              const float* __restrict__ dy, const float* __restrict__ d1,
              const float* __restrict__ d2, float* __restrict__ du,
              float* __restrict__ dres, float* __restrict__ part, int N,
              int Cin, int Cout, int relu) {
  constexpr int BM = T::BM, BN = T::BN, MT = T::MT, NT = T::NT;
  constexpr int THREADS = T::THREADS, STAGES = T::STAGES;
  constexpr int LD = TC_BK + 4, ULD = BN + 8;
  constexpr int AS = BM * LD;                  // dy (then y) of a stage
  constexpr int STAGE = DxSmem<T>::STAGE;      // dy, y, w, d1, d2
  extern __shared__ __align__(16) float smem[];
  float* ut = smem + STAGES * STAGE;           // u of the tile [BM][ULD]
  float* red = ut + BM * ULD;                  // [WM][2][BN]
  float* sc = red + 2 * T::WM * BN;            // scale, shift [BN]
  float* sh = sc + BN;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % T::WM, wn = warp / T::WM;
  const int wa = wm * MT * 16, wb = wn * NT * 8;
  const int col0 = blockIdx.y * BN;
  const int row_tiles = (N + BM - 1) / BM;
  const int mine = (row_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;
  const int KT = (Cout + TC_BK - 1) / TC_BK;
  const int steps = mine * KT;

  for (int c = threadIdx.x; c < BN; c += THREADS) {
    sc[c] = col0 + c < Cin ? scale[col0 + c] : 0.f;
    sh[c] = col0 + c < Cin ? shift[col0 + c] : 0.f;
  }

  auto load = [&](int step) {
    float* st = smem + (step % STAGES) * STAGE;
    const int row0 = (blockIdx.x + (step / KT) * gridDim.x) * BM;
    const int k0 = (step % KT) * TC_BK;
    load_window<BM, TC_BK, VEC, THREADS>(st, LD, dy, Cout, row0, N, k0,
                                         Cout);
    load_window<BM, TC_BK, VEC, THREADS>(st + AS, LD, y, Cout, row0, N, k0,
                                         Cout);
    load_window<BN, TC_BK, VEC, THREADS>(st + 2 * AS, LD, w, Cout, col0,
                                         Cin, k0, Cout);
    float* e = st + 2 * AS + BN * LD;
    load_window<1, TC_BK, VEC, THREADS>(e, 0, d1, 0, 0, 1, k0, Cout);
    load_window<1, TC_BK, VEC, THREADS>(e + TC_BK, 0, d2, 0, 0, 1, k0, Cout);
  };

  float acc[MT][NT][4];
  float ps[NT][2], pt[NT][2];  // the thread's columns' sums of dz*u, dz
#pragma unroll
  for (int j = 0; j < NT; ++j) ps[j][0] = ps[j][1] = pt[j][0] = pt[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it has landed; stage it - 1 and u are free
    if (it + STAGES - 1 < steps) load(it + STAGES - 1);
    const int kt = it % KT;
    const int row0 = (blockIdx.x + (it / KT) * gridDim.x) * BM;
    // u of this tile, in the group waited for STAGES - 1 stages on: by
    // the epilogue when KT >= STAGES (else the epilogue waits for it)
    if (kt == 0)
      load_window<BM, BN, VEC, THREADS>(ut, ULD, u, Cin, row0, N, col0, Cin);
    cp_async_commit();
    const float* ds = smem + (it % STAGES) * STAGE;
    const float* ys = ds + AS;
    const float* ws = ds + 2 * AS;
    const float* e1 = ws + BN * LD;
    const float* e2 = e1 + TC_BK;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 8) {
      unsigned ahi[MT][4], alo[MT][4], bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // fragment k = t (q 0), t + 4 (q 1)
        const int k = kk + t + 4 * q;
        const float c1 = e1[k], c2 = 2.f * e2[k];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // fragment row g (h 0), g + 8
            const int m = wa + i * 16 + g + 8 * h;
            const float a = __fadd_rn(__fadd_rn(ds[m * LD + k], c1),
                                      __fmul_rn(ys[m * LD + k], c2));
            split_tf32(a, ahi[i][2 * q + h], alo[i][2 * q + h]);
          }
#pragma unroll
        for (int j = 0; j < NT; ++j)
          split_tf32(ws[(wb + j * 8 + g) * LD + k], bhi[j][q], blo[j][q]);
      }
      mma3_step<MT, NT>(acc, ahi, alo, bhi, blo);
    }
    if (kt != KT - 1) continue;

    // epilogue of the row tile at row0
    if (KT < STAGES) {
      cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wa + i * 16 + g + 8 * h;
        const int row = row0 + m;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = wb + j * 8 + 2 * t;  // and n + 1
          const int c = col0 + n;
          float gv[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
          float uu[2], rr[2] = {0.f, 0.f};
          const size_t off = (size_t)row * Cin + c;
          // zero-filled past N and Cin; such outputs are not written
          const bool in[2] = {row < N && c < Cin, row < N && c + 1 < Cin};
          if (VEC == 4) {
            const float2 u2 = *reinterpret_cast<const float2*>(ut + m * ULD + n);
            uu[0] = u2.x, uu[1] = u2.y;
            if (res != nullptr && in[0]) {
              const float2 r2 = *reinterpret_cast<const float2*>(res + off);
              rr[0] = r2.x, rr[1] = r2.y;
            }
          } else {
            uu[0] = ut[m * ULD + n], uu[1] = ut[m * ULD + n + 1];
            if (res != nullptr) {
              rr[0] = in[0] ? res[off] : 0.f;
              rr[1] = in[1] ? res[off + 1] : 0.f;
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            float p = __fadd_rn(__fmul_rn(uu[q], sc[n + q]), sh[n + q]);
            if (res != nullptr) p = __fadd_rn(p, rr[q]);
            if ((relu && !(p > 0.f)) || !in[q]) gv[q] = 0.f;
          }
          const float du0 = __fmul_rn(gv[0], sc[n]);
          const float du1 = __fmul_rn(gv[1], sc[n + 1]);
          if (VEC == 4) {  // Cin % 4 == 0: c and c + 1 both in or both out
            if (in[0]) {
              *reinterpret_cast<float2*>(du + off) = make_float2(du0, du1);
              if (dres != nullptr)
                *reinterpret_cast<float2*>(dres + off) =
                    make_float2(gv[0], gv[1]);
            }
          } else {
            if (in[0]) {
              du[off] = du0;
              if (dres != nullptr) dres[off] = gv[0];
            }
            if (in[1]) {
              du[off + 1] = du1;
              if (dres != nullptr) dres[off + 1] = gv[1];
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            ps[j][q] = fmaf(gv[q], uu[q], ps[j][q]);
            pt[j][q] = __fadd_rn(pt[j][q], gv[q]);
          }
        }
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  }
  cp_async_wait<0>();

  // the block's column partials: over the 8 lanes of one t (a fixed
  // butterfly), then over the WM warps of one column in order
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) {
        ps[j][q] += __shfl_xor_sync(0xffffffffu, ps[j][q], x);
        pt[j][q] += __shfl_xor_sync(0xffffffffu, pt[j][q], x);
      }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = wb + j * 8 + 2 * t + q;
        red[(wm * 2) * BN + c] = ps[j][q];
        red[(wm * 2 + 1) * BN + c] = pt[j][q];
      }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < 2 * BN; x += THREADS) {
    const int which = x / BN, c = x % BN;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < T::WM; ++r) s += red[(r * 2 + which) * BN + c];
    if (col0 + c < Cin)
      part[((size_t)which * gridDim.x + blockIdx.x) * Cin + col0 + c] = s;
  }
}

// ------------------------------------------------------------------ B3
// dw = z^T @ dy_eff: M = Cin, N = Cout, K = rows. Grid (Cin tiles, Cout
// tiles, row chunks): block (m, n, s) sums the rows [s * chunk, + chunk)
// into out[s]. A stage holds u (and res) [TC_BK rows][BM channels] and y,
// dy [TC_BK rows][BN outputs] as they lie in device memory; the fragments
// read them with k = the row (t) and m or n = the column (g), so the row
// stride is padded to 8 (mod 32) floats for conflict-free reads. z = act(pre)
// is formed as A's fragment is read (rows past the chunk give z = 0).
template <class T, int VEC>
__global__ void __launch_bounds__(T::THREADS, 1)
bwd_dw_kernel(const float* __restrict__ u, const float* __restrict__ scale,
              const float* __restrict__ shift, const float* __restrict__ res,
              const float* __restrict__ y, const float* __restrict__ dy,
              const float* __restrict__ d1, const float* __restrict__ d2,
              float* __restrict__ out, int N, int Cin, int Cout, int relu,
              int chunk) {
  constexpr int BM = T::BM, BN = T::BN, MT = T::MT, NT = T::NT;
  constexpr int THREADS = T::THREADS, STAGES = T::STAGES;
  constexpr int ULD = BM + 8, YLD = BN + 8;
  constexpr int US = TC_BK * ULD, YS = TC_BK * YLD;
  extern __shared__ __align__(16) float smem[];
  const bool has_res = res != nullptr;
  const int ua = has_res ? 2 * US : US;  // u (and res), then y, dy
  const int stage = ua + 2 * YS;
  // the thread's f32 sums of its accumulators, [MT * NT * 4][THREADS]
  float* total = smem + STAGES * stage;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % T::WM, wn = warp / T::WM;
  const int wa = wm * MT * 16, wb = wn * NT * 8;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int r_begin = blockIdx.z * chunk;
  const int r_end = min(r_begin + chunk, N);
  const int steps = (r_end - r_begin + TC_BK - 1) / TC_BK;

  // the affine of the thread's A rows (channels) and the cotangent
  // constants of its B columns (outputs), zeros past the widths
  float sc[MT][2], sh[MT][2], e1[NT], e2[NT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wa + i * 16 + g + 8 * h;
      sc[i][h] = m < Cin ? scale[m] : 0.f;
      sh[i][h] = m < Cin ? shift[m] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wb + j * 8 + g;
    e1[j] = n < Cout ? d1[n] : 0.f;
    e2[j] = n < Cout ? 2.f * d2[n] : 0.f;
  }

  auto load = [&](int step) {
    float* st = smem + (step % STAGES) * stage;
    const int r0 = r_begin + step * TC_BK;
    load_window<TC_BK, BM, VEC, THREADS>(st, ULD, u, Cin, r0, r_end, m0,
                                         Cin);
    if (has_res)
      load_window<TC_BK, BM, VEC, THREADS>(st + US, ULD, res, Cin, r0, r_end,
                                           m0, Cin);
    load_window<TC_BK, BN, VEC, THREADS>(st + ua, YLD, y, Cout, r0, r_end,
                                         n0, Cout);
    load_window<TC_BK, BN, VEC, THREADS>(st + ua + YS, YLD, dy, Cout, r0,
                                         r_end, n0, Cout);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  // total += acc, acc = 0 (each thread its own words: no barrier)
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* p = total + ((i * NT + j) * 4 + c) * THREADS + threadIdx.x;
          *p = __fadd_rn(*p, acc[i][j][c]);
          acc[i][j][c] = 0.f;
        }
  };
#pragma unroll
  for (int e = 0; e < MT * NT * 4; ++e) total[e * THREADS + threadIdx.x] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    if (it % DW_FLUSH == 0 && it > 0) flush();
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it has landed; stage it - 1 is free
    if (it + STAGES - 1 < steps) load(it + STAGES - 1);
    cp_async_commit();
    const float* us = smem + (it % STAGES) * stage;
    const float* rs = us + US;
    const float* ys = us + ua;
    const float* ds = ys + YS;
    const int r0 = r_begin + it * TC_BK;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 8) {
      unsigned ahi[MT][4], alo[MT][4], bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // fragment k = t (q 0), t + 4 (q 1)
        const int k = kk + t + 4 * q;
        const bool live = r0 + k < r_end;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // fragment row g (h 0), g + 8
            const int m = wa + i * 16 + g + 8 * h;
            float z = __fadd_rn(__fmul_rn(us[k * ULD + m], sc[i][h]),
                                sh[i][h]);
            if (has_res) z = __fadd_rn(z, rs[k * ULD + m]);
            if (relu) z = fmaxf(z, 0.f);
            split_tf32(live ? z : 0.f, ahi[i][2 * q + h], alo[i][2 * q + h]);
          }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = wb + j * 8 + g;
          const float b = __fadd_rn(__fadd_rn(ds[k * YLD + n], e1[j]),
                                    __fmul_rn(ys[k * YLD + n], e2[j]));
          split_tf32(b, bhi[j][q], blo[j][q]);
        }
      }
      mma3_step<MT, NT>(acc, ahi, alo, bhi, blo);
    }
  }
  cp_async_wait<0>();
  flush();

  float* dst = out + (size_t)blockIdx.z * Cin * Cout;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wa + i * 16 + g + 8 * h;
      if (m >= Cin) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + wb + j * 8 + 2 * t + c;
          if (n < Cout)
            dst[(size_t)m * Cout + n] =
                total[((i * NT + j) * 4 + 2 * h + c) * THREADS + threadIdx.x];
        }
    }
}

// ------------------------------------------------------------ reductions
// out_a[c] = sum_t part_a[t, c] (and b), t in [0, tiles): each of RED row
// threads sums a fixed stride of tiles, then one thread sums the RED
// partials in order. Block (RED, RED), grid ceil(C / RED).
__global__ void __launch_bounds__(RED * RED)
col_reduce_kernel(const float* __restrict__ part_a,
                  const float* __restrict__ part_b, float* __restrict__ out_a,
                  float* __restrict__ out_b, int tiles, int C) {
  __shared__ float sa[RED][RED + 1];
  __shared__ float sb[RED][RED + 1];
  const int c = blockIdx.x * RED + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int t = threadIdx.y; t < tiles; t += RED) {
      a += part_a[(size_t)t * C + c];
      b += part_b[(size_t)t * C + c];
    }
  }
  sa[threadIdx.y][threadIdx.x] = a;
  sb[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float ra = 0.f, rb = 0.f;
    for (int r = 0; r < RED; ++r) {
      ra += sa[r][threadIdx.x];
      rb += sb[r][threadIdx.x];
    }
    out_a[c] = ra;
    out_b[c] = rb;
  }
}

// out[i] = sum_s part[s, i] over the split-K chunks, in order
__global__ void split_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int splits,
                                    size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * count + i];
  out[i] = s;
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 4 (16-byte copies) where both widths are multiples of 4 and every array
// the copies and float2 accesses touch is 16-byte aligned, else 1
inline int vec_for(int Cin, int Cout, const void* const* ptrs, int n) {
  if (Cin % 4 != 0 || Cout % 4 != 0) return 1;
  for (int i = 0; i < n; ++i)
    if (ptrs[i] != nullptr && !aligned16(ptrs[i])) return 1;
  return 4;
}

// B2's tiles: 256 rows x 64 channels where Cin <= 64 (8 warps, one block an
// SM), else 64 x 128 (4 warps, two blocks an SM: one block's epilogue runs
// beside the other's products, and small N still fills the SMs)
using DxNarrow = Tile<256, 64, 8, 1, 3>;
using DxWide = Tile<64, 128, 2, 2, 3, 2>;
// B3's tiles of Cin x Cout
using Dw64x64 = Tile<64, 64, 2, 4, 3>;
using Dw64x256 = Tile<64, 256, 2, 4, 3>;
using Dw256x64 = Tile<256, 64, 8, 1, 3>;
using Dw128x128 = Tile<128, 128, 4, 2, 3>;

template <class T>
constexpr size_t dw_smem_bytes(bool has_res) {
  return sizeof(float) *
         (T::STAGES * ((has_res ? 2 : 1) * TC_BK * (T::BM + 8) +
                       2 * TC_BK * (T::BN + 8)) +
          T::MT * T::NT * 4 * T::THREADS);
}
static_assert(dw_smem_bytes<Dw64x256>(true) <= SMEM_LIMIT &&
                  dw_smem_bytes<Dw256x64>(true) <= SMEM_LIMIT &&
                  dw_smem_bytes<Dw128x128>(true) <= SMEM_LIMIT,
              "B3's shared memory");

// B2's persistent grid: P blocks a Cin tile, ~SM_COUNT in all, each
// walking row tiles p, p + P, ...
int dx_blocks(int N, int Cin) {
  const bool narrow = Cin <= 64;
  const int row_tiles = cdiv(N, narrow ? DxNarrow::BM : DxWide::BM);
  const int col_tiles = cdiv(Cin, narrow ? DxNarrow::BN : DxWide::BN);
  int p = SM_COUNT * (narrow ? DxNarrow::BLOCKS : DxWide::BLOCKS) / col_tiles;
  if (p < 1) p = 1;
  return p < row_tiles ? p : row_tiles;
}

// B3's tile (by the widths) and split of the N rows: chunks of a multiple
// of TC_BK rows, ~SM_COUNT blocks in all, none shorter than DW_MIN_CHUNK
struct DwPlan {
  int bm, bn, splits, chunk;
};
DwPlan dw_plan(int N, int Cin, int Cout) {
  DwPlan p;
  if (Cin <= 64) {
    p.bm = 64;
    p.bn = Cout <= 64 ? 64 : 256;
  } else {
    p.bm = Cout <= 64 ? 256 : 128;
    p.bn = Cout <= 64 ? 64 : 128;
  }
  const int tiles = cdiv(Cin, p.bm) * cdiv(Cout, p.bn);
  int splits = SM_COUNT / tiles;
  const int most = N / DW_MIN_CHUNK > 1 ? N / DW_MIN_CHUNK : 1;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  p.chunk = cdiv(cdiv(N, splits), TC_BK) * TC_BK;
  p.splits = cdiv(N, p.chunk);
  return p;
}

// B1's tiles of rows x Cout, chosen by the site (each measured against the
// others at the nine ResNet-50 sites on an H100, fwd_kernels_probe.py):
// - narrow, Cout <= 64: 128 x 64, 8 warps of 32 x 32, two blocks an SM (two
//   stages, so that two fit with a residual);
// - wide, N > FWD_LONG_N: 128 x 128, 8 warps of 32 x 64;
// - deep, smaller N: 128 x 128, 4 warps of 64 x 64 (more mma a fragment
//   read), two blocks an SM;
// - short, where 128 x 128 tiles would not give every SM one: 64 x 64, 4
//   warps of 32 x 32, four blocks an SM.
// Where Cin > FWD_FLUSH_CIN the wide and short tiles flush their
// accumulators every FWD_FLUSH stages (128 channels, 48 adds a chain): a
// 2048-deep chain of truncating adds drifts ~2e-5. The deep tile has no
// registers for it (1.3e-5 at Cin 1024).
using FwdNarrow = Tile<128, 64, 4, 2, 2, 2>;
using FwdWide = Tile<128, 128, 4, 2, 3>;
using FwdDeep = Tile<128, 128, 2, 2, 3, 2>;
using FwdShort = Tile<64, 64, 2, 2, 3, 4>;
enum FwdTile { FWD_NARROW, FWD_WIDE, FWD_DEEP, FWD_SHORT };
constexpr int FWD_LONG_N = 16384;
constexpr int FWD_FLUSH = 4;
constexpr int FWD_FLUSH_CIN = 256;

// B1's tile and persistent grid: P blocks a Cout tile, each walking the same
// number of row tiles (within one), the fewest that keep ~SM_COUNT * BLOCKS
// blocks busy
struct FwdPlan {
  int tile, bm, bn, blocks, flush;
};
FwdPlan fwd_plan(int N, int Cin, int Cout) {
  FwdPlan p;
  int per_sm;
  if (Cout <= 64) {
    p.tile = FWD_NARROW, p.bm = FwdNarrow::BM, p.bn = FwdNarrow::BN;
    per_sm = FwdNarrow::BLOCKS;
  } else if ((long long)cdiv(N, FwdWide::BM) * cdiv(Cout, FwdWide::BN) <
             SM_COUNT) {
    p.tile = FWD_SHORT, p.bm = FwdShort::BM, p.bn = FwdShort::BN;
    per_sm = FwdShort::BLOCKS;
  } else if (N > FWD_LONG_N) {
    p.tile = FWD_WIDE, p.bm = FwdWide::BM, p.bn = FwdWide::BN;
    per_sm = FwdWide::BLOCKS;
  } else {
    p.tile = FWD_DEEP, p.bm = FwdDeep::BM, p.bn = FwdDeep::BN;
    per_sm = FwdDeep::BLOCKS;
  }
  const int row_tiles = cdiv(N, p.bm), col_tiles = cdiv(Cout, p.bn);
  const long long tiles = (long long)row_tiles * col_tiles;
  const int each = cdiv(tiles, (long long)SM_COUNT * per_sm);
  p.blocks = cdiv(row_tiles, each);
  p.flush = (p.tile == FWD_WIDE || p.tile == FWD_SHORT) && Cin > FWD_FLUSH_CIN
                ? FWD_FLUSH
                : 0;
  return p;
}

template <class T, int VEC, int FLUSH>
cudaError_t launch_fwd(const float* u, const float* scale, const float* shift,
                       const float* w, const float* res, float* y,
                       float* part, int N, int Cin, int Cout, int relu,
                       int blocks, cudaStream_t st) {
  const size_t bytes = FwdSmem<T>::bytes(res != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, VEC, FLUSH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, cdiv(Cout, T::BN));
  fwd_kernel<T, VEC, FLUSH><<<grid, T::THREADS, bytes, st>>>(
      u, scale, shift, w, res, y, part, N, Cin, Cout, relu);
  return cudaGetLastError();
}

template <class T, int FLUSH>
cudaError_t launch_fwd_vec(int vec, const float* u, const float* scale,
                           const float* shift, const float* w,
                           const float* res, float* y, float* part, int N,
                           int Cin, int Cout, int relu, int blocks,
                           cudaStream_t st) {
  if (vec == 4)
    return launch_fwd<T, 4, FLUSH>(u, scale, shift, w, res, y, part, N, Cin,
                                   Cout, relu, blocks, st);
  return launch_fwd<T, 1, FLUSH>(u, scale, shift, w, res, y, part, N, Cin,
                                 Cout, relu, blocks, st);
}

template <class T, int VEC>
cudaError_t launch_bwd_dx(const float* u, const float* scale,
                          const float* shift, const float* w,
                          const float* res, const float* y, const float* dy,
                          const float* d1, const float* d2, float* du,
                          float* dres, float* part, int N, int Cin, int Cout,
                          int relu, int blocks, cudaStream_t st) {
  constexpr size_t bytes = DxSmem<T>::BYTES;
  static_assert(bytes <= SMEM_LIMIT, "B2's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dx_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, cdiv(Cin, T::BN));
  bwd_dx_kernel<T, VEC><<<grid, T::THREADS, bytes, st>>>(
      u, scale, shift, w, res, y, dy, d1, d2, du, dres, part, N, Cin, Cout,
      relu);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_bwd_dx_vec(int vec, const float* u, const float* scale,
                              const float* shift, const float* w,
                              const float* res, const float* y,
                              const float* dy, const float* d1,
                              const float* d2, float* du, float* dres,
                              float* part, int N, int Cin, int Cout, int relu,
                              int blocks, cudaStream_t st) {
  if (vec == 4)
    return launch_bwd_dx<T, 4>(u, scale, shift, w, res, y, dy, d1, d2, du,
                               dres, part, N, Cin, Cout, relu, blocks, st);
  return launch_bwd_dx<T, 1>(u, scale, shift, w, res, y, dy, d1, d2, du,
                             dres, part, N, Cin, Cout, relu, blocks, st);
}

template <class T, int VEC>
cudaError_t launch_bwd_dw(const float* u, const float* scale,
                          const float* shift, const float* res,
                          const float* y, const float* dy, const float* d1,
                          const float* d2, float* out, int N, int Cin,
                          int Cout, int relu, const DwPlan& plan,
                          cudaStream_t st) {
  const size_t bytes = dw_smem_bytes<T>(res != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dw_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(Cin, T::BM), cdiv(Cout, T::BN), plan.splits);
  bwd_dw_kernel<T, VEC><<<grid, T::THREADS, bytes, st>>>(
      u, scale, shift, res, y, dy, d1, d2, out, N, Cin, Cout, relu,
      plan.chunk);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_bwd_dw_vec(int vec, const float* u, const float* scale,
                              const float* shift, const float* res,
                              const float* y, const float* dy,
                              const float* d1, const float* d2, float* out,
                              int N, int Cin, int Cout, int relu,
                              const DwPlan& plan, cudaStream_t st) {
  if (vec == 4)
    return launch_bwd_dw<T, 4>(u, scale, shift, res, y, dy, d1, d2, out, N,
                               Cin, Cout, relu, plan, st);
  return launch_bwd_dw<T, 1>(u, scale, shift, res, y, dy, d1, d2, out, N,
                             Cin, Cout, relu, plan, st);
}

cudaError_t col_reduce(const float* part, float* out_a, float* out_b,
                       int tiles, int C, cudaStream_t st) {
  col_reduce_kernel<<<cdiv(C, RED), dim3(RED, RED), 0, st>>>(
      part, part + (size_t)tiles * C, out_a, out_b, tiles, C);
  return cudaGetLastError();
}

// ============================================================ the bf16 forms
// B1, B2 and B3 on bf16 u, w, res, y and dy (the AMP rule), with the JAX
// kernels' dtypes: z and dy_eff formed in f32 from the bf16 inputs (rounded
// as PyTorch rounds, as above) and rounded to bf16 (cvt.rn.bf16x2) for the
// products, which accumulate in f32, one pass; B1's statistics from the f32
// accumulators before y is rounded to bf16; B2's du and dres rounded to
// bf16 on the way out, dscale and dshift f32; B3's dw in f32 (split-K
// partials f32, summed by split_reduce_kernel in a fixed order).
//
// All three are Hopper GEMMs (wgmma, TMA, an mbarrier ring, warp
// specialisation; their own section below): the formed operand (z in B1
// and B3, dy_eff in B2) is built in registers as wgmma's A fragments, B1
// and B2 walk row tiles in a persistent grid and B3 splits the rows over
// ~one block an SM.
//
// What bounds them: bytes at the wide ResNet-50 sites (bf16 halves the f32
// forms' bytes) and the tensor cores' bf16 rate (989 TFLOP/s dense on an
// H100 SXM at 700 W) at the deep ones. The tensor cores add each product sum
// into the accumulator with truncation: B1's and B2's chains are K / 16 adds
// (128 at Cin or Cout 2048); B3 flushes its accumulators into f32 sums
// every 256 rows, as the f32 form does.

// 8 bf16 (one 16-byte word) to f32 and back
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) f[2 * i] = bf16_lo(w[i]), f[2 * i + 1] = bf16_hi(w[i]);
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                    pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

// -------------------------------------------- B1, B2 and B3, bf16: wgmma + TMA
// Hopper kernels over hopper_wgmma.cuh (the tensor maps, the mbarrier ring,
// the wgmma wrappers and the tile layouts it describes). A block holds two
// consumer warpgroups and a producer warpgroup whose one working thread
// keeps a ring of stages filled by TMA through 2-D tensor maps over the
// row-major bf16 arrays (64-column atoms, 128B swizzle; rows and columns
// past the arrays' ends arrive as zeros); the producer hands its registers
// to the consumers (setmaxnreg). A stage is 64 rows of K (WG_BK); an output
// tile is 128 x 128 (B1 at Cout <= 64: 128 x 64), 64 rows of it a consumer
// warpgroup (m64n128k16, 64 f32 accumulators a thread). One block an SM
// (the shared memory asks for it).
//
// The formed operands (z in B1 and B3, dy_eff in B2) are built in registers
// as wgmma's A fragments, by ldmatrix through the swizzle, the f32 formula
// and cvt.rn.bf16x2: no pass over shared memory, and never while a product
// is in flight (a non-wgmma write to a wgmma's input registers during a
// product makes ptxas serialise every wgmma of the kernel). Only B3's B,
// dy_eff, must lie in shared memory: a fourth warpgroup forms it there in
// place, once a stage, then makes it visible to wgmma by fence.proxy.async.
//
// Consumer code holds no branch around a wgmma and no divergent one
// anywhere: roles are tested on warp_uniform values, spins and arrivals are
// in the asm (hopper_wgmma.cuh), bounds are predicates of the loads and
// stores below, and B1's and B2's walks peel their last stage (ptxas
// serialises every wgmma of a kernel that has one on a path it cannot
// prove uniform).
//
// Measured on an H100 (fused_bwd_probe.py, in turns against the mma.sync
// kernels these replace, at ResNet-50's nine sites at batch 256; variants
// that take one piece out): B2's wide sites stream at ~90% of HBM's rate,
// B1's at 72-83% (the stores of y hold them); at the deep ones the loads
// from L2 (~6 TB/s in all; B2 ~1 us a 48 KB stage an SM) are the floor, to
// which forming z adds ~20% in B1. B1's 128 x 256 tile (Cout >= 256) reads
// u once for twice the columns and forms each z for twice the products:
// 8-20% faster than 128 x 128 at the sites that take it.
constexpr int WG_BK = 64;      // rows of K a stage: one 128-byte atom
constexpr int WG_TILE = 128;   // an output tile: 128 x 128
constexpr int WG_FLUSH = 4;    // B3: stages between flushes (256 rows)
constexpr int DW_WG_MIN_CHUNK = 256;  // B3: fewest rows a split
constexpr int ATOM_BYTES = WG_BK * 128;  // [64 rows][64 columns] bf16

// p[0], p[1] where pred, else 0
__device__ __forceinline__ float2 ld_f2_if(const float* p, bool pred) {
  float2 v;
  asm("{\n.reg .pred q;\nsetp.ne.u32 q, %3, 0;\nmov.b32 %0, 0;\n"
      "mov.b32 %1, 0;\n@q ld.global.nc.v2.f32 {%0, %1}, [%2];\n}\n"
      : "=f"(v.x), "=f"(v.y)
      : "l"(p), "r"((unsigned)pred));
  return v;
}
// *p = (a, b) / a where pred
__device__ __forceinline__ void st_f2_if(float* p, float a, float b,
                                         bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %3, 0;\n"
      "@q st.global.v2.f32 [%0], {%1, %2};\n}\n" ::"l"(p),
      "f"(a), "f"(b), "r"((unsigned)pred)
      : "memory");
}
__device__ __forceinline__ void st_f32_if(float* p, float a, bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\n"
      "@q st.global.f32 [%0], %1;\n}\n" ::"l"(p),
      "f"(a), "r"((unsigned)pred)
      : "memory");
}

// B2's block: the ring's stages (dy and y [128 rows][64], w [128 Cin][64]),
// the epilogue's buffers of u (and res) [128 rows][128 Cin] (two without a
// residual, one with: du and dres are written over them and leave by TMA),
// then the tile's scale and shift [128] and the column partials [8 warps]
// [2][128] (f32), then the mbarriers
template <bool RES>
struct DxWg {
  static constexpr int STAGES = 3;
  static constexpr int A_BYTES = WG_TILE * WG_BK * 2;   // dy or y
  static constexpr int STAGE = 3 * A_BYTES;             // + w
  static constexpr int U_ATOM = WG_TILE * 128;          // [128 rows][64]
  static constexpr int U_BYTES = 2 * U_ATOM;            // u or res
  static constexpr int UBUFS = RES ? 1 : 2;
  static constexpr int UBUF = (RES ? 2 : 1) * U_BYTES;  // u (then res)
  static constexpr int UOFF = STAGES * STAGE;
  static constexpr int EPI = UOFF + UBUFS * UBUF;
  static constexpr int BARS = EPI + 4 * (2 * WG_TILE + 16 * WG_TILE);
  static constexpr size_t BYTES =
      BARS + 8 * (1 + 2 * STAGES + 2 * UBUFS) + 1024;
};

// the [64 rows][64] box at smem src to (column c, row r) of a 2-D tensor
// map, by the thread where pred; then its bulk group committed and waited
// for until the box has been read (the buffer may be refilled)
__device__ __forceinline__ void tma_store_2d_if(const CUtensorMap* map,
                                                const void* src, int c, int r,
                                                bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %4, 0;\n"
      "@q cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%2, %3}], [%1];\n}\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c), "r"(r), "r"((unsigned)pred)
      : "memory");
}
__device__ __forceinline__ void tma_store_wait_if(bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %0, 0;\n"
      "@q cp.async.bulk.commit_group;\n"
      "@q cp.async.bulk.wait_group.read 0;\n}\n" ::"r"((unsigned)pred)
      : "memory");
}
// the thread's TMA stores complete (written, not only read)
__device__ __forceinline__ void tma_store_drain_if(bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %0, 0;\n"
      "@q cp.async.bulk.wait_group 0;\n}\n" ::"r"((unsigned)pred)
      : "memory");
}

// the thread's TMA stores since the last commit made one bulk group
__device__ __forceinline__ void tma_store_commit_if(bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %0, 0;\n"
      "@q cp.async.bulk.commit_group;\n}\n" ::"r"((unsigned)pred)
      : "memory");
}
// wait until at most N of the thread's bulk groups are still reading
// shared memory
template <int N>
__device__ __forceinline__ void tma_store_read_wait_if(bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %0, 0;\n"
      "@q cp.async.bulk.wait_group.read %1;\n}\n" ::"r"((unsigned)pred),
      "n"(N)
      : "memory");
}

// one halving exchange of a warp's column sums a and b (16 each) between
// the lanes whose g differ in one bit (lane ^ m; `bit` is the lane's): a
// lane keeps entries i + H * bit (i < H) of each, plus its partner's same
// entries, in x[i]
template <int H>
__device__ __forceinline__ void halve(float (&a)[16], float (&b)[16],
                                      int bit, int m) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float sa = bit ? a[i] : a[i + H], sb = bit ? b[i] : b[i + H];
    a[i] = __fadd_rn(bit ? a[i + H] : a[i],
                     __shfl_xor_sync(0xffffffffu, sa, m));
    b[i] = __fadd_rn(bit ? b[i + H] : b[i],
                     __shfl_xor_sync(0xffffffffu, sb, m));
  }
}

// B1's block: the ring's stages (u, and res, [128 rows][64 Cin]; w [64
// Cin][BN] as BN / 64 atoms), as many as fit beside the rest (at most 6);
// the staging of y, YBUFS buffers [64 rows][BN] a consumer warpgroup (one
// at BN = 256); the column partials [8 warps][2][BN] (f32); then the
// mbarriers
template <bool RES, int BN>
struct FwdWg {
  static constexpr int U_BYTES = WG_TILE * 128;          // [128 rows][64]
  static constexpr int W_OFF = (RES ? 2 : 1) * U_BYTES;  // w after u (res)
  static constexpr int STAGE = W_OFF + BN / 64 * ATOM_BYTES;
  static constexpr int YBUFS = BN == 256 ? 1 : 2;
  static constexpr int Y_BYTES = BN / 64 * ATOM_BYTES;   // [64 rows][BN]
  static constexpr int RED_BYTES = 4 * 2 * WG_CONSUMER_WARPS * BN;
  static constexpr int FIT =
      (SMEM_LIMIT - 2048 - 2 * YBUFS * Y_BYTES - RED_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int YOFF = STAGES * STAGE;
  static constexpr int RED_OFF = YOFF + 2 * YBUFS * Y_BYTES;
  static constexpr int BARS = RED_OFF + RED_BYTES;
  static constexpr size_t BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

// ------------------------------------------------------------- B1, bf16
// y = z @ w: M = rows, N = Cout, K = Cin. A persistent grid: block (p, c)
// walks row tiles p, p + P, ... of Cout tile c (the blocks of a row tile's
// Cout tiles run together, so that they read its u from L2). The
// producer's loads run across tile boundaries, so the next tile's first
// stages land during a tile's epilogue. A consumer warpgroup's A fragments
// are z = act(u * scale + shift [+ res]) of its 64 rows, from the landed u
// (and res) tile (rounded as PyTorch rounds; scale and shift past Cin read
// as 0, so z is 0 there); w [Cin][Cout] is B stored [k][n] (MN-major). The
// epilogue packs y into bf16 pairs in the warpgroup's staging buffer
// (128B-swizzled [64 rows][64] atoms; two buffers up to BN = 128, since at
// Cin <= 64 a tile is one stage and the kernel a stream of stores), which
// leaves by TMA (rows past N and columns past Cout clipped), and adds y
// and y^2 of the rows before N from the f32 accumulators into the column
// sums (w's columns past Cout arrive as zeros, so they add 0), which the
// block reduces at its end in a fixed order into part[which][p][Cout].
template <bool RES, int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tu,
                 const __grid_constant__ CUtensorMap tres,
                 const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap ty,
                 const float* __restrict__ scale,
                 const float* __restrict__ shift, float* __restrict__ part,
                 int N, int Cin, int Cout, int relu) {
  using C = FwdWg<RES, BN>;
  constexpr int STAGES = C::STAGES, YBUFS = C::YBUFS, NJ = BN / 8;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* sm = align1024(smem_wg);
  float* red = reinterpret_cast<float*>(sm + C::RED_OFF);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::BARS);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + STAGES;

  const int P = gridDim.x, p = blockIdx.x;
  const int c0 = blockIdx.y * BN;
  const int row_tiles = (N + WG_TILE - 1) / WG_TILE;
  const int KT = (Cin + WG_BK - 1) / WG_BK;

  init_ring(bars, STAGES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wgi = warp_uniform(threadIdx.x >> 7);   // the warpgroup

  if (wgi == 2) {       // the producer
    producer_regs();
    if (warp != WG_CONSUMER_WARPS || lane != 0) return;
    int it = 0;
    for (int rt = p; rt < row_tiles; rt += P)
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, C::STAGE);
        unsigned char* st = sm + s * C::STAGE;
        tma_load_2d(st, &tu, full + s, kt * WG_BK, rt * WG_TILE);
        if constexpr (RES)
          tma_load_2d(st + C::U_BYTES, &tres, full + s, kt * WG_BK,
                      rt * WG_TILE);
#pragma unroll
        for (int a = 0; a < BN / 64; ++a)
          tma_load_2d(st + C::W_OFF + a * ATOM_BYTES, &tw, full + s,
                      c0 + 64 * a, kt * WG_BK);
      }
    return;
  }
  consumer_regs();

  const int wg = wgi, g = lane >> 2, t = lane & 3;
  const int ry = 16 * (warp & 3) + g;   // the thread's rows of the
                                        // warpgroup's 64: ry, ry + 8
  const bool storer = (threadIdx.x & 127) == 0;     // a warpgroup's TMA
  float acc[BN / 2];
  // the thread's columns' sums of y, y^2 over the block's tiles: in
  // registers up to BN = 128; at 256 (beside 128 accumulators) the warp's
  // sums of a tile are added into its own slots of red, in a fixed order
  constexpr int NS = BN <= 128 ? NJ : 1;
  float ps[NS][2], pq[NS][2];
#pragma unroll
  for (int j = 0; j < NS; ++j)
    ps[j][0] = ps[j][1] = pq[j][0] = pq[j][1] = 0.f;
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  float2* slots = reinterpret_cast<float2*>(red) + warp * 2 * (BN / 2);
  if constexpr (BN == 256)
#pragma unroll
    for (int i = 0; i < BN / 32; ++i)   // [which][64-column chunk][lane]
      slots[32 * i + lane] = make_float2(0.f, 0.f);

  // stage s's A fragments of k16 steps 0..3: z of the warpgroup's rows,
  // channels k0..k0 + 63, from the landed u (and res) by ldmatrix through
  // the swizzle, rewritten in place
  auto build = [&](unsigned (&a)[4][4], int s, int k0) {
    const unsigned st = smem_u32(sm + s * C::STAGE);
    unsigned ra[4][4];
    load_a<WG_BK>(a, st, WG_TILE, 64 * wg);
    if constexpr (RES) load_a<WG_BK>(ra, st + C::U_BYTES, WG_TILE, 64 * wg);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // channels 2t, 2t + 1 (+ 8 h)
        const int col = k0 + 16 * kk + 2 * t + 8 * h;
        const bool ok = col < Cin;
        const float2 sc = ld_f2_if(scale + col, ok);
        const float2 sh = ld_f2_if(shift + col, ok);
#pragma unroll
        for (int r = 0; r < 2; ++r) {   // rows g, g + 8
          unsigned& x = a[kk][2 * h + r];
          float z0 = __fadd_rn(__fmul_rn(bf16_lo(x), sc.x), sh.x);
          float z1 = __fadd_rn(__fmul_rn(bf16_hi(x), sc.y), sh.y);
          if constexpr (RES) {
            z0 = __fadd_rn(z0, bf16_lo(ra[kk][2 * h + r]));
            z1 = __fadd_rn(z1, bf16_hi(ra[kk][2 * h + r]));
          }
          if (relu) z0 = fmaxf(z0, 0.f), z1 = fmaxf(z1, 0.f);
          x = pack_bf16x2(z0, z1);
        }
      }
  };
  auto issue = [&](const unsigned (&a)[4][4], int s, int kt) {
    const unsigned wt = smem_u32(sm + s * C::STAGE + C::W_OFF);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<BN>(acc, a[kk], desc_mn<BN>(wt, WG_BK, kk),
                   kt | kk);   // the tile's first product: acc = 0
    wgmma_commit();
  };

  // a warpgroup's z, then its products, in turn: the other warpgroup's
  // products run while it forms z. Measured on an H100 and not kept:
  // forming the next stage's z under the warpgroup's own products (in f32,
  // packed after their wait; 13% slower over the 29 sites), and the two
  // warpgroups taking strict turns on the tensor cores (named barriers;
  // no change). Writing a wgmma's input registers while a product is in
  // flight makes ptxas serialise every wgmma.
  int it = 0, tile = 0;
  for (int rt = p; rt < row_tiles; rt += P, ++tile) {
    const int row0 = rt * WG_TILE + 64 * wg;   // the warpgroup's rows
    unsigned a[4][4];
    mbar_wait(full + it % STAGES, (it / STAGES) & 1);
    build(a, it % STAGES, 0);
    for (int kt = 0; kt < KT - 1; ++kt, ++it) {
      wgmma_fence();
      issue(a, it % STAGES, kt);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive_if(empty + it % STAGES, lane == 0);
      mbar_wait(full + (it + 1) % STAGES, ((it + 1) / STAGES) & 1);
      build(a, (it + 1) % STAGES, (kt + 1) * WG_BK);
    }
    wgmma_fence();
    issue(a, it % STAGES, KT - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive_if(empty + it % STAGES, lane == 0);
    ++it;

    // y's bf16 pairs into the staging buffer once its last store has read
    // it; the column sums of the rows before N
    unsigned char* yb =
        sm + C::YOFF + (wg * YBUFS + tile % YBUFS) * C::Y_BYTES;
    tma_store_read_wait_if<YBUFS - 1>(storer);
    named_sync(2 + wg, 128);
    auto stage_y = [&](int j, int rl, float v0, float v1) {
      *reinterpret_cast<unsigned*>(yb + (j >> 3) * ATOM_BYTES + rl * 128 +
                                   16 * ((j & 7) ^ (rl & 7)) + 4 * t) =
          pack_bf16x2(v0, v1);
    };
    if constexpr (BN <= 128) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rl = ry + 8 * r;
          const bool ok = row0 + rl < N;
          const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
          stage_y(j, rl, v0, v1);
          const float s0 = ok ? v0 : 0.f, s1 = ok ? v1 : 0.f;
          ps[j][0] = __fadd_rn(ps[j][0], s0);
          ps[j][1] = __fadd_rn(ps[j][1], s1);
          pq[j][0] = fmaf(s0, s0, pq[j][0]);
          pq[j][1] = fmaf(s1, s1, pq[j][1]);
        }
    } else {
      // 64 columns at a time: the sums of the thread's two rows, then
      // over the warp's 8 lanes of one t by halving exchanges (each lane
      // keeps 2 of the 16 columns: 8 (8 c + jl) + 2 t + q, jl the bits
      // of g reversed), added into the lane's slots
#pragma unroll
      for (int c = 0; c < NJ / 8; ++c) {
        float sy[16], sq[16];   // [2 jl + q]
#pragma unroll
        for (int jl = 0; jl < 8; ++jl)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = 8 * c + jl, rl = ry + 8 * r;
            const bool ok = row0 + rl < N;
            const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
            stage_y(j, rl, v0, v1);
            const float s0 = ok ? v0 : 0.f, s1 = ok ? v1 : 0.f;
            if (r == 0) {
              sy[2 * jl] = s0, sy[2 * jl + 1] = s1;
              sq[2 * jl] = __fmul_rn(s0, s0);
              sq[2 * jl + 1] = __fmul_rn(s1, s1);
            } else {
              sy[2 * jl] = __fadd_rn(sy[2 * jl], s0);
              sy[2 * jl + 1] = __fadd_rn(sy[2 * jl + 1], s1);
              sq[2 * jl] = fmaf(s0, s0, sq[2 * jl]);
              sq[2 * jl + 1] = fmaf(s1, s1, sq[2 * jl + 1]);
            }
          }
        halve<8>(sy, sq, (lane >> 2) & 1, 4);
        halve<4>(sy, sq, (lane >> 3) & 1, 8);
        halve<2>(sy, sq, (lane >> 4) & 1, 16);
        float2& o = slots[32 * c + lane];
        float2& oq = slots[32 * (NJ / 8 + c) + lane];
        o = make_float2(__fadd_rn(o.x, sy[0]), __fadd_rn(o.y, sy[1]));
        oq = make_float2(__fadd_rn(oq.x, sq[0]), __fadd_rn(oq.y, sq[1]));
      }
    }
    fence_async_shared();
    named_sync(2 + wg, 128);
#pragma unroll
    for (int a = 0; a < BN / 64; ++a)
      tma_store_2d_if(&ty, yb + a * ATOM_BYTES, c0 + 64 * a, row0, storer);
    tma_store_commit_if(storer);
  }
  tma_store_drain_if(storer);

  // the block's column partials in a fixed order: over the 8 lanes of one
  // t (up to BN = 128 a butterfly: every lane gets the same sums), then
  // over the 8 warps
  if constexpr (BN <= 128)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int x = 4; x < 32; x <<= 1) {
          ps[j][q] += __shfl_xor_sync(0xffffffffu, ps[j][q], x);
          pq[j][q] += __shfl_xor_sync(0xffffffffu, pq[j][q], x);
        }
        red[(warp * 2) * BN + 8 * j + 2 * t + q] = ps[j][q];
        red[(warp * 2 + 1) * BN + 8 * j + 2 * t + q] = pq[j][q];
      }
  named_sync(1, 2 * 128);
#pragma unroll
  for (int i = 0; i < (2 * BN + 255) / 256; ++i) {
    const int x = threadIdx.x + 256 * i;
    const int which = (x / BN) & 1, c = x % BN;
    int at = c;   // c's slot: at BN = 256 in [chunk][lane][q]
    if constexpr (BN == 256) {
      const int jl = (c >> 3) & 7;
      const int gl = ((jl >> 2) & 1) | (jl & 2) | ((jl & 1) << 2);
      at = 2 * (32 * (c >> 6) + 4 * gl + ((c >> 1) & 3)) + (c & 1);
    }
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WG_CONSUMER_WARPS; ++w)
      s += red[(w * 2 + which) * BN + at];
    st_f32_if(part + ((size_t)which * P + p) * Cout + c0 + c, s,
              x < 2 * BN && c0 + c < Cout);
  }
}

// ------------------------------------------------------------- B2, bf16
// dz = dy_eff @ w^T: M = rows, N = Cin, K = Cout. A persistent grid: block
// (p, c) walks row tiles p, p + P, ... of Cin tile c (the blocks of a row
// tile's Cin tiles run together, so that they read its dy and y from L2).
// The producer's loads run across tile boundaries: a tile's K stages, then
// its u (and res) tile into an epilogue buffer. A consumer warpgroup's A
// fragments are dy_eff = dy + d1 + 2 y d2 from the landed dy and y tiles
// (rounded as PyTorch rounds); w [Cin][Cout] is B stored [n][k]
// (K-major). The epilogue gates by the preactivation from the landed u
// (and res), writes du (and dres) over them in bf16 pairs, stores them by
// TMA (rows past N and columns past Cin clipped) and adds dz*u and dz into
// the thread's column sums, which the block reduces at its end in a fixed
// order into part[which][p][Cin].
template <bool RES>
__global__ void __launch_bounds__(WG_THREADS, 1)
bwd_dx_wgmma_kernel(const __grid_constant__ CUtensorMap tdy,
                    const __grid_constant__ CUtensorMap ty,
                    const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap tu,
                    const __grid_constant__ CUtensorMap tres,
                    const __grid_constant__ CUtensorMap tdu,
                    const __grid_constant__ CUtensorMap tdres,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift,
                    const float* __restrict__ d1, const float* __restrict__ d2,
                    float* __restrict__ part, int N, int Cin, int Cout,
                    int relu, int store_dres) {
  using C = DxWg<RES>;
  constexpr int STAGES = C::STAGES, UBUFS = C::UBUFS;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* sm = align1024(smem_wg);
  float* sc = reinterpret_cast<float*>(sm + C::EPI);
  float* sh = sc + WG_TILE;
  float* red = sh + WG_TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::BARS);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* ufull = empty + STAGES;
  uint64_t* uempty = ufull + UBUFS;

  const int P = gridDim.x, p = blockIdx.x;
  const int c0 = blockIdx.y * WG_TILE;
  const int row_tiles = (N + WG_TILE - 1) / WG_TILE;
  const int KT = (Cout + WG_BK - 1) / WG_BK;

  init_ring(bars, STAGES);
  if (threadIdx.x == 0) {
    for (int b = 0; b < UBUFS; ++b) {
      mbar_init(ufull + b, 1);
      mbar_init(uempty + b, 2);   // a storing thread a consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wgi = warp_uniform(threadIdx.x >> 7);   // the warpgroup

  if (wgi == 2) {       // the producer
    producer_regs();
    if (warp != WG_CONSUMER_WARPS || lane != 0) return;
    int it = 0, tile = 0;
    for (int rt = p; rt < row_tiles; rt += P, ++tile) {
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, C::STAGE);
        unsigned char* st = sm + s * C::STAGE;
        tma_load_2d(st, &tdy, full + s, kt * WG_BK, rt * WG_TILE);
        tma_load_2d(st + C::A_BYTES, &ty, full + s, kt * WG_BK,
                    rt * WG_TILE);
        tma_load_2d(st + 2 * C::A_BYTES, &tw, full + s, kt * WG_BK, c0);
      }
      const int b = tile % UBUFS;
      mbar_wait(uempty + b, ((tile / UBUFS) & 1) ^ 1);
      mbar_expect_tx(ufull + b, C::UBUF);
      unsigned char* ub = sm + C::UOFF + b * C::UBUF;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        tma_load_2d(ub + a * C::U_ATOM, &tu, ufull + b, c0 + 64 * a,
                    rt * WG_TILE);
        if constexpr (RES)
          tma_load_2d(ub + C::U_BYTES + a * C::U_ATOM, &tres, ufull + b,
                      c0 + 64 * a, rt * WG_TILE);
      }
    }
    return;
  }
  consumer_regs();

  // the tile's scale and shift (both warpgroups write the same values)
  {
    const int c = threadIdx.x & (WG_TILE - 1);
    const bool ok = c0 + c < Cin;
    sc[c] = ok ? scale[c0 + c] : 0.f;
    sh[c] = ok ? shift[c0 + c] : 0.f;
  }
  named_sync(1, 2 * 128);

  const int wg = wgi, g = lane >> 2, t = lane & 3;
  const int r_in = 64 * wg + 16 * (warp & 3) + g;   // and r_in + 8
  const bool storer = (threadIdx.x & 127) == 0;     // a warpgroup's TMA
  float acc[64];
  float ps[16][2], pt[16][2];   // the thread's columns' sums of dz*u, dz
#pragma unroll
  for (int j = 0; j < 16; ++j)
    ps[j][0] = ps[j][1] = pt[j][0] = pt[j][1] = 0.f;
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;

  // stage s's A fragments of k16 steps 0..3: dy_eff of the warpgroup's
  // rows, columns k0..k0 + 63
  auto build = [&](unsigned (&a)[4][4], int s, int k0) {
    const unsigned st = smem_u32(sm + s * C::STAGE);
    unsigned ya[4][4];
    load_a<WG_BK>(a, st, WG_TILE, 64 * wg);
    load_a<WG_BK>(ya, st + C::A_BYTES, WG_TILE, 64 * wg);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // columns 2t, 2t + 1 (+ 8 h)
        const int col = k0 + 16 * kk + 2 * t + 8 * h;
        const bool ok = col < Cout;
        const float2 e1 = ld_f2_if(d1 + col, ok);
        float2 e2 = ld_f2_if(d2 + col, ok);
        e2.x *= 2.f;
        e2.y *= 2.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {   // rows g, g + 8
          unsigned& x = a[kk][2 * h + r];
          const unsigned yv = ya[kk][2 * h + r];
          x = pack_bf16x2(
              __fadd_rn(__fadd_rn(bf16_lo(x), e1.x),
                        __fmul_rn(bf16_lo(yv), e2.x)),
              __fadd_rn(__fadd_rn(bf16_hi(x), e1.y),
                        __fmul_rn(bf16_hi(yv), e2.y)));
        }
      }
  };
  auto issue = [&](const unsigned (&a)[4][4], int s, int kt) {
    const unsigned wt = smem_u32(sm + s * C::STAGE + 2 * C::A_BYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_k<WG_TILE>(acc, a[kk], desc_k<WG_BK>(wt, WG_TILE, 0, kk),
                          kt | kk);   // the tile's first product: acc = 0
    wgmma_commit();
  };

  int it = 0, tile = 0;
  for (int rt = p; rt < row_tiles; rt += P, ++tile) {
    const int row0 = rt * WG_TILE;
    unsigned a[4][4];
    mbar_wait(full + it % STAGES, (it / STAGES) & 1);
    build(a, it % STAGES, 0);
    for (int kt = 0; kt < KT - 1; ++kt, ++it) {
      wgmma_fence();
      issue(a, it % STAGES, kt);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive_if(empty + it % STAGES, lane == 0);
      mbar_wait(full + (it + 1) % STAGES, ((it + 1) / STAGES) & 1);
      build(a, (it + 1) % STAGES, (kt + 1) * WG_BK);
    }
    wgmma_fence();
    issue(a, it % STAGES, KT - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive_if(empty + it % STAGES, lane == 0);
    ++it;

    // gate from the landed u (and res); du (and dres) over them; the
    // column sums (rows past N and columns past Cin give 0)
    const int b = tile % UBUFS;
    mbar_wait(ufull + b, (tile / UBUFS) & 1);
    unsigned char* ub = sm + C::UOFF + b * C::UBUF;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rl = r_in + 8 * r, n = 8 * j + 2 * t;
        const bool ok = row0 + rl < N && c0 + n < Cin;
        unsigned* up = reinterpret_cast<unsigned*>(
            ub + (j >> 3) * C::U_ATOM + rl * 128 +
            16 * ((j & 7) ^ (rl & 7)) + 4 * t);
        const unsigned uw = *up;
        const float uu[2] = {bf16_lo(uw), bf16_hi(uw)};
        unsigned rw = 0u;
        if constexpr (RES) rw = up[C::U_BYTES / 4];
        float gv[2] = {acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float pre = __fadd_rn(__fmul_rn(uu[q], sc[n + q]), sh[n + q]);
          if constexpr (RES)
            pre = __fadd_rn(pre, q ? bf16_hi(rw) : bf16_lo(rw));
          gv[q] = (relu && !(pre > 0.f)) || !ok ? 0.f : gv[q];
          ps[j][q] = fmaf(gv[q], uu[q], ps[j][q]);
          pt[j][q] = __fadd_rn(pt[j][q], gv[q]);
        }
        *up = pack_bf16x2(__fmul_rn(gv[0], sc[n]), __fmul_rn(gv[1], sc[n + 1]));
        if constexpr (RES) up[C::U_BYTES / 4] = pack_bf16x2(gv[0], gv[1]);
      }
    // the warpgroup's 64 rows of du (and dres) out by TMA, then the
    // buffer released to the producer
    fence_async_shared();
    named_sync(2 + wg, 128);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const unsigned char* src = ub + a * C::U_ATOM + 64 * wg * 128;
      tma_store_2d_if(&tdu, src, c0 + 64 * a, row0 + 64 * wg, storer);
      if constexpr (RES)
        tma_store_2d_if(&tdres, src + C::U_BYTES, c0 + 64 * a,
                        row0 + 64 * wg, storer && store_dres);
    }
    tma_store_wait_if(storer);
    mbar_arrive_if(uempty + b, storer);
  }
  tma_store_drain_if(storer);

  // the block's column partials in a fixed order: over the 8 lanes of one
  // t (a butterfly: every lane gets the same sums), then over the 8 warps
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) {
        ps[j][q] += __shfl_xor_sync(0xffffffffu, ps[j][q], x);
        pt[j][q] += __shfl_xor_sync(0xffffffffu, pt[j][q], x);
      }
      red[(warp * 2) * WG_TILE + 8 * j + 2 * t + q] = ps[j][q];
      red[(warp * 2 + 1) * WG_TILE + 8 * j + 2 * t + q] = pt[j][q];
    }
  named_sync(1, 2 * 128);
  {
    const int which = threadIdx.x >> 7, c = threadIdx.x & (WG_TILE - 1);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WG_CONSUMER_WARPS; ++w)
      s += red[(w * 2 + which) * WG_TILE + c];
    st_f32_if(part + ((size_t)which * P + p) * Cin + c0 + c, s,
              c0 + c < Cin);
  }
}

// B3's block: the ring's stages (u, and res, [64 rows][128 channels]; y, dy
// [64 rows][128 outputs]), then d1 and 2 * d2 of the tile's outputs [128]
// (f32), then the mbarriers (the ring's, and a "formed" one a stage)
template <bool RES>
struct DwWg {
  static constexpr int STAGES = RES ? 3 : 4;
  static constexpr int U_BYTES = 2 * ATOM_BYTES;          // u or res
  static constexpr int Y_OFF = (RES ? 2 : 1) * U_BYTES;   // y, then dy
  static constexpr int STAGE = Y_OFF + 2 * U_BYTES;
  static constexpr int EPI = STAGES * STAGE;
  static constexpr int BARS = EPI + 4 * 2 * WG_TILE;
  static constexpr size_t BYTES = BARS + 8 * (1 + 3 * STAGES) + 1024;
};
// B3's block is four warpgroups: two consumers, the producer (warp 8 issues
// the loads) and the formers of dy_eff (two chunks at a time), each share of
// registers handed on by setmaxnreg: 2 * 128 * 200 + 128 * 24 + 128 * 88 =
// 65 536
constexpr int DW_THREADS = 512;
constexpr int DW_FORMERS = 128;
constexpr int DW_FORMER_REGS = 88, DW_CONSUMER_REGS = 200;

// ------------------------------------------------------------- B3, bf16
// dw = z^T @ dy_eff: M = Cin, N = Cout, K = rows. Block (m, n, s) sums the
// rows [s * chunk, + chunk) into out[s] (split-K: the blocks of one chunk
// are neighbours in launch order, so they read its u, y and dy from L2).
// Consumer warpgroup wg takes channels 64 wg.. of the tile: its A
// fragments (z^T: m = channel, k = row) come from the landed u (and res)
// tile by ldmatrix.trans, with the affine, the activation and the row
// mask (rows at or past the chunk's end, or N, give z = 0) applied in
// registers. dy_eff = dy + d1 + 2 y d2 is B, MN-major: a fourth
// warpgroup, the formers, forms it in place in the landed dy tile and
// arrives on the stage's "formed" barrier (fence.proxy.async first), so
// that the consumers never wait on each other: one consumer's products run
// while the other forms z. Every WG_FLUSH stages the accumulators are
// added into f32 sums in registers (the tensor cores add with truncation;
// a long chain drifts).
template <bool RES>
__global__ void __launch_bounds__(DW_THREADS, 1)
bwd_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tu,
                    const __grid_constant__ CUtensorMap tres,
                    const __grid_constant__ CUtensorMap ty,
                    const __grid_constant__ CUtensorMap tdy,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift,
                    const float* __restrict__ d1, const float* __restrict__ d2,
                    float* __restrict__ out, int N, int Cin, int Cout,
                    int relu, int chunk) {
  using C = DwWg<RES>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* sm = align1024(smem_wg);
  float* e1 = reinterpret_cast<float*>(sm + C::EPI);
  float* e2 = e1 + WG_TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + C::BARS);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* formed = empty + STAGES;

  const int m0 = blockIdx.x * WG_TILE, n0 = blockIdx.y * WG_TILE;
  const int r_begin = blockIdx.z * chunk;
  const int r_end = min(r_begin + chunk, N);
  const int steps = (r_end - r_begin + WG_BK - 1) / WG_BK;

  init_ring(bars, STAGES);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(formed + s, DW_FORMERS / 32);
    mbar_init_fence();
  }
  __syncthreads();
  const int warp = warp_uniform(threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int wgi = warp_uniform(threadIdx.x >> 7);

  if (wgi == 2) {       // the producer
    producer_regs();
    if (warp != WG_CONSUMER_WARPS || lane != 0) return;
    for (int i = 0; i < steps; ++i) {
      const int s = i % STAGES, r0 = r_begin + i * WG_BK;
      mbar_wait(empty + s, ((i / STAGES) & 1) ^ 1);
      mbar_expect_tx(full + s, C::STAGE);
      unsigned char* st = sm + s * C::STAGE;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        tma_load_2d(st + a * ATOM_BYTES, &tu, full + s, m0 + 64 * a, r0);
        if constexpr (RES)
          tma_load_2d(st + C::U_BYTES + a * ATOM_BYTES, &tres, full + s,
                      m0 + 64 * a, r0);
        tma_load_2d(st + C::Y_OFF + a * ATOM_BYTES, &ty, full + s,
                    n0 + 64 * a, r0);
        tma_load_2d(st + C::Y_OFF + C::U_BYTES + a * ATOM_BYTES, &tdy,
                    full + s, n0 + 64 * a, r0);
      }
    }
    return;
  }
  if (wgi == 3) {       // the formers
    regs_dec<DW_FORMER_REGS>();
    // d1 and 2 * d2 of the tile's outputs, then dy_eff = dy + d1 + 2 y d2
    // in place, a stage's 1024 16-byte chunks over 128 threads
    const int f = threadIdx.x - 128 * 3;
    for (int c = f; c < WG_TILE; c += DW_FORMERS) {
      const bool ok = n0 + c < Cout;
      e1[c] = ok ? d1[n0 + c] : 0.f;
      e2[c] = ok ? 2.f * d2[n0 + c] : 0.f;
    }
    named_sync(1, DW_FORMERS);
    for (int i = 0; i < steps; ++i) {
      const int s = i % STAGES;
      mbar_wait(full + s, (i / STAGES) & 1);
      unsigned char* yt = sm + s * C::STAGE + C::Y_OFF;
#pragma unroll 2
      for (int q = f; q < 2 * 512; q += DW_FORMERS) {
        const int atom = q >> 9, row = (q >> 3) & 63, pc = q & 7;
        const int n = 64 * atom + 8 * (pc ^ (row & 7));
        const int off = atom * ATOM_BYTES + row * 128 + pc * 16;
        uint4* dp = reinterpret_cast<uint4*>(yt + C::U_BYTES + off);
        float v[8], yv[8], a1[8], a2[8];
        unpack8(*dp, v);
        unpack8(*reinterpret_cast<const uint4*>(yt + off), yv);
        *reinterpret_cast<float4*>(a1) = *reinterpret_cast<const float4*>(e1 + n);
        *reinterpret_cast<float4*>(a1 + 4) =
            *reinterpret_cast<const float4*>(e1 + n + 4);
        *reinterpret_cast<float4*>(a2) = *reinterpret_cast<const float4*>(e2 + n);
        *reinterpret_cast<float4*>(a2 + 4) =
            *reinterpret_cast<const float4*>(e2 + n + 4);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __fadd_rn(__fadd_rn(v[e], a1[e]), __fmul_rn(yv[e], a2[e]));
        *dp = pack8(v);
      }
      fence_async_shared();
      __syncwarp();
      mbar_arrive_if(formed + s, lane == 0);
    }
    return;
  }

  regs_inc<DW_CONSUMER_REGS>();
  const int wg = wgi, wq = warp & 3, g = lane >> 2, t = lane & 3;
  // the thread's channels m0 + 64 wg + 16 wq + g (+ 8): scale and shift
  float csc[2], csh[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 64 * wg + 16 * wq + g + 8 * h;
    const bool ok = m < Cin;
    csc[h] = ok ? scale[m] : 0.f;
    csh[h] = ok ? shift[m] : 0.f;
  }
  // ldmatrix.trans addresses: lane l gives row (l & 7) + 8 (l >> 4) of the
  // k16 step, channels 16 wq + 8 ((l >> 3) & 1).. of the warpgroup's atom
  const int lrow = (lane & 7) + 8 * (lane >> 4);
  const int lchunk = 2 * wq + ((lane >> 3) & 1);

  // stage i (rows r0.. of the chunk, `live` of them real): the
  // warpgroup's z fragments (wgmma's input registers, written while no
  // product is in flight: else ptxas serialises every wgmma)
  auto prep = [&](unsigned (&a)[4][4], int i) {
    const int s = i % STAGES;
    mbar_wait(full + s, (i / STAGES) & 1);
    const unsigned char* ut = sm + s * C::STAGE + wg * ATOM_BYTES;
    const int live = r_end - (r_begin + i * WG_BK);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 16 * kk + lrow;
      const unsigned char* at = ut + k * 128 + 16 * (lchunk ^ (k & 7));
      unsigned uu[4], rr[4];
      ldmatrix_x4_trans(uu, reinterpret_cast<const bf16*>(at));
      if constexpr (RES)
        ldmatrix_x4_trans(rr, reinterpret_cast<const bf16*>(at + C::U_BYTES));
      // uu[e]: channel g + 8 (e & 1), rows 2t, 2t + 1 (+ 8 (e >> 1))
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * kk + 2 * t + 8 * (e >> 1);
        float z[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          z[q] = q ? bf16_hi(uu[e]) : bf16_lo(uu[e]);
          z[q] = __fadd_rn(__fmul_rn(z[q], csc[e & 1]), csh[e & 1]);
          if constexpr (RES)
            z[q] = __fadd_rn(z[q], q ? bf16_hi(rr[e]) : bf16_lo(rr[e]));
          if (relu) z[q] = fmaxf(z[q], 0.f);
          z[q] = row + q < live ? z[q] : 0.f;
        }
        a[kk][e] = pack_bf16x2(z[0], z[1]);
      }
    }
  };
  float acc[64], sums[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = sums[e] = 0.f;
  // the products of stage i, once its dy_eff is formed; the first of a
  // flush period starts from 0
  auto issue = [&](const unsigned (&a)[4][4], int i) {
    mbar_wait(formed + i % STAGES, (i / STAGES) & 1);
    const unsigned dt =
        smem_u32(sm + (i % STAGES) * C::STAGE + C::Y_OFF + C::U_BYTES);
    const int keep = i % WG_FLUSH != 0;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<WG_TILE>(acc, a[kk], desc_mn<WG_TILE>(dt, WG_BK, kk),
                        keep | kk);
    wgmma_commit();
  };
  auto flush = [&]() {
#pragma unroll
    for (int e = 0; e < 64; ++e) sums[e] = __fadd_rn(sums[e], acc[e]);
  };

  // a warpgroup's z and products in turn: the other warpgroup's products
  // run while it forms z
  unsigned a[4][4];
  for (int i = 0; i < steps; ++i) {
    prep(a, i);
    issue(a, i);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive_if(empty + i % STAGES, lane == 0);
    if ((i + 1) % WG_FLUSH == 0) flush();
  }
  if (steps % WG_FLUSH != 0) flush();

  // the accumulator's layout: channel m0 + 64 wg + 16 wq + g (+ 8), output
  // n0 + 8 j + 2 t (+ 1)
  float* dst = out + (size_t)blockIdx.z * Cin * Cout;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * wg + 16 * wq + g + 8 * h;
      const int n = n0 + 8 * j + 2 * t;
      st_f2_if(dst + (size_t)m * Cout + n, sums[4 * j + 2 * h],
               sums[4 * j + 2 * h + 1], m < Cin && n < Cout);
    }
}

static_assert(FwdWg<true, 256>::BYTES <= SMEM_LIMIT &&
                  FwdWg<false, 256>::BYTES <= SMEM_LIMIT &&
                  FwdWg<true, 256>::BYTES > SMEM_LIMIT / 2 &&
                  FwdWg<true, 128>::BYTES <= SMEM_LIMIT &&
                  FwdWg<false, 128>::BYTES <= SMEM_LIMIT &&
                  FwdWg<true, 64>::BYTES <= SMEM_LIMIT &&
                  FwdWg<false, 64>::BYTES <= SMEM_LIMIT &&
                  FwdWg<true, 128>::BYTES > SMEM_LIMIT / 2 &&
                  FwdWg<true, 64>::BYTES > SMEM_LIMIT / 2 &&
                  DxWg<true>::BYTES <= SMEM_LIMIT &&
                  DxWg<false>::BYTES <= SMEM_LIMIT &&
                  DwWg<true>::BYTES <= SMEM_LIMIT &&
                  DwWg<false>::BYTES <= SMEM_LIMIT,
              "the bf16 forms' shared memory");

// B1's columns a tile: 64 where Cout <= 64, 256 where Cout >= 256, else 128
inline int fwd_wgmma_cols(int Cout) {
  return Cout <= 64 ? 64 : Cout >= 256 ? 256 : WG_TILE;
}

// B1's and B2's persistent grids: P blocks a column tile (of `cols` of the
// C output columns), ~SM_COUNT (one an SM) in all
int wgmma_walk_blocks(int N, int C, int cols) {
  int p = SM_COUNT / cdiv(C, cols);
  if (p < 1) p = 1;
  const int row_tiles = cdiv(N, WG_TILE);
  return p < row_tiles ? p : row_tiles;
}

// B3's split of the N rows: chunks of a multiple of 16 rows (one k16
// step; a chunk's end may fall inside a stage, which the row mask
// handles), ~SM_COUNT blocks (one an SM) in all, none shorter than
// DW_WG_MIN_CHUNK
DwPlan dw_plan_wgmma(int N, int Cin, int Cout) {
  DwPlan p;
  const int tiles = cdiv(Cin, WG_TILE) * cdiv(Cout, WG_TILE);
  int splits = SM_COUNT / tiles;
  const int most = N / DW_WG_MIN_CHUNK > 1 ? N / DW_WG_MIN_CHUNK : 1;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  p.chunk = cdiv(cdiv(N, splits), 16) * 16;
  p.splits = cdiv(N, p.chunk);
  return p;
}

template <bool RES, int BN>
cudaError_t launch_fwd_wgmma(const bf16* u, const float* scale,
                             const float* shift, const bf16* w,
                             const bf16* res, bf16* y, float* part, int N,
                             int Cin, int Cout, int relu, int blocks,
                             cudaStream_t st) {
  // without a residual, its map is u's (never loaded through)
  CUtensorMap tu, tres, tw, ty;
  if (!rc_map(&tu, u, N, Cin, WG_TILE) ||
      !(RES ? rc_map(&tres, res, N, Cin, WG_TILE) : (tres = tu, true)) ||
      !rc_map(&tw, w, Cin, Cout, WG_BK) || !rc_map(&ty, y, N, Cout, 64))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = FwdWg<RES, BN>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      fwd_wgmma_kernel<RES, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, cdiv(Cout, BN));
  fwd_wgmma_kernel<RES, BN><<<grid, WG_THREADS, bytes, st>>>(
      tu, tres, tw, ty, scale, shift, part, N, Cin, Cout, relu);
  return cudaGetLastError();
}

template <bool RES>
cudaError_t launch_bwd_dx_wgmma(const bf16* u, const float* scale,
                                const float* shift, const bf16* w,
                                const bf16* res, const bf16* y,
                                const bf16* dy, const float* d1,
                                const float* d2, bf16* du, bf16* dres,
                                float* part, int N, int Cin, int Cout,
                                int relu, int blocks, cudaStream_t st) {
  // without a dres to write, its map points at du (never stored through:
  // store_dres is 0)
  CUtensorMap tdy, ty, tw, tu, tres, tdu, tdres;
  if (!rc_map(&tdy, dy, N, Cout, WG_TILE) ||
      !rc_map(&ty, y, N, Cout, WG_TILE) ||
      !rc_map(&tw, w, Cin, Cout, WG_TILE) ||
      !rc_map(&tu, u, N, Cin, WG_TILE) ||
      !rc_map(&tres, RES ? res : u, N, Cin, WG_TILE) ||
      !rc_map(&tdu, du, N, Cin, 64) ||
      !rc_map(&tdres, RES ? dres : du, N, Cin, 64))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = DxWg<RES>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_dx_wgmma_kernel<RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, cdiv(Cin, WG_TILE));
  bwd_dx_wgmma_kernel<RES><<<grid, WG_THREADS, bytes, st>>>(
      tdy, ty, tw, tu, tres, tdu, tdres, scale, shift, d1, d2, part, N, Cin,
      Cout, relu, RES && dres != nullptr);
  return cudaGetLastError();
}

template <bool RES>
cudaError_t launch_bwd_dw_wgmma(const bf16* u, const float* scale,
                                const float* shift, const bf16* res,
                                const bf16* y, const bf16* dy,
                                const float* d1, const float* d2, float* out,
                                int N, int Cin, int Cout, int relu,
                                const DwPlan& plan, cudaStream_t st) {
  CUtensorMap tu, tres, ty, tdy;
  if (!rc_map(&tu, u, N, Cin, WG_BK) ||
      !rc_map(&tres, RES ? res : u, N, Cin, WG_BK) ||
      !rc_map(&ty, y, N, Cout, WG_BK) || !rc_map(&tdy, dy, N, Cout, WG_BK))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = DwWg<RES>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_dw_wgmma_kernel<RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(Cin, WG_TILE), cdiv(Cout, WG_TILE), plan.splits);
  bwd_dw_wgmma_kernel<RES><<<grid, DW_THREADS, bytes, st>>>(
      tu, tres, ty, tdy, scale, shift, d1, d2, out, N, Cin, Cout, relu,
      plan.chunk);
  return cudaGetLastError();
}

// what the bf16 kernels take: widths multiples of 8, every array 16-byte
// aligned (the copies move 8 bf16, the pair loads and stores 4 bytes)
inline bool bf16_ok(int Cin, int Cout, const void* const* ptrs, int n) {
  if (Cin % 8 != 0 || Cout % 8 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (ptrs[i] != nullptr && !aligned16(ptrs[i])) return false;
  return true;
}

}  // namespace

// Floats of scratch a call needs: kind 0 = B1 ([2, blocks, Cout]),
// 1 = B2 ([2, blocks, Cin]), 2 = B3 ([splits, Cin, Cout], 0 when one chunk
// covers N and the kernel writes dw itself).
extern "C" long long bn_act_conv1x1_scratch_floats(int kind, int N, int Cin,
                                                   int Cout) {
  if (kind == 0) return 2LL * fwd_plan(N, Cin, Cout).blocks * Cout;
  if (kind == 1) return 2LL * dx_blocks(N, Cin) * Cin;
  const DwPlan plan = dw_plan(N, Cin, Cout);
  return plan.splits > 1 ? (long long)plan.splits * Cin * Cout : 0;
}

// The launch a call makes, for reports: kind 0 = B1, 1 = B2, 2 = B3; writes
// the tile (rows or Cin, columns), the grid's blocks and the dynamic shared
// memory in bytes into out[0..3], and into out[4] for B1 the stages between
// flushes of its accumulators (0: none), for B3 the rows of a split.
extern "C" void bn_act_conv1x1_plan(int kind, int N, int Cin, int Cout,
                                    int has_res, long long* out) {
  if (kind == 0) {
    const FwdPlan plan = fwd_plan(N, Cin, Cout);
    const bool r = has_res != 0;
    out[0] = plan.bm;
    out[1] = plan.bn;
    out[2] = (long long)plan.blocks * cdiv(Cout, plan.bn);
    out[3] = plan.tile == FWD_NARROW ? FwdSmem<FwdNarrow>::bytes(r)
             : plan.tile == FWD_WIDE ? FwdSmem<FwdWide>::bytes(r)
             : plan.tile == FWD_DEEP ? FwdSmem<FwdDeep>::bytes(r)
                                     : FwdSmem<FwdShort>::bytes(r);
    out[4] = plan.flush;
    return;
  }
  if (kind == 1) {
    const bool narrow = Cin <= 64;
    out[0] = narrow ? DxNarrow::BM : DxWide::BM;
    out[1] = narrow ? DxNarrow::BN : DxWide::BN;
    out[2] = (long long)dx_blocks(N, Cin) * cdiv(Cin, out[1]);
    out[3] = narrow ? DxSmem<DxNarrow>::BYTES : DxSmem<DxWide>::BYTES;
    return;
  }
  const DwPlan plan = dw_plan(N, Cin, Cout);
  out[0] = plan.bm;
  out[1] = plan.bn;
  out[2] = (long long)cdiv(Cin, plan.bm) * cdiv(Cout, plan.bn) * plan.splits;
  out[4] = plan.chunk;
  const bool r = has_res != 0;
  out[3] = plan.bm == 64 && plan.bn == 64 ? dw_smem_bytes<Dw64x64>(r)
           : plan.bm == 64                ? dw_smem_bytes<Dw64x256>(r)
           : plan.bm == 256               ? dw_smem_bytes<Dw256x64>(r)
                                          : dw_smem_bytes<Dw128x128>(r);
}

// B1. u, res [N, Cin]; scale, shift [Cin]; w [Cin, Cout]; y [N, Cout]; ssum,
// ssq [Cout]; res may be null. Launches on `stream` of `device`; returns the
// launch's cudaError_t (0 = launched).
extern "C" int bn_act_conv1x1_fwd(const float* u, const float* scale,
                                  const float* shift, const float* w,
                                  const float* res, float* y, float* ssum,
                                  float* ssq, float* scratch, int N, int Cin,
                                  int Cout, int relu, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const void* ptrs[] = {u, scale, shift, w, res, y};
  const int vec = vec_for(Cin, Cout, ptrs, 6);
  const FwdPlan plan = fwd_plan(N, Cin, Cout);
  switch (plan.tile * 2 + (plan.flush != 0)) {
    case FWD_NARROW * 2:
      err = launch_fwd_vec<FwdNarrow, 0>(vec, u, scale, shift, w, res, y,
                                         scratch, N, Cin, Cout, relu,
                                         plan.blocks, st);
      break;
    case FWD_WIDE * 2:
      err = launch_fwd_vec<FwdWide, 0>(vec, u, scale, shift, w, res, y,
                                       scratch, N, Cin, Cout, relu,
                                       plan.blocks, st);
      break;
    case FWD_WIDE * 2 + 1:
      err = launch_fwd_vec<FwdWide, FWD_FLUSH>(vec, u, scale, shift, w, res,
                                               y, scratch, N, Cin, Cout,
                                               relu, plan.blocks, st);
      break;
    case FWD_DEEP * 2:
      err = launch_fwd_vec<FwdDeep, 0>(vec, u, scale, shift, w, res, y,
                                       scratch, N, Cin, Cout, relu,
                                       plan.blocks, st);
      break;
    case FWD_SHORT * 2:
      err = launch_fwd_vec<FwdShort, 0>(vec, u, scale, shift, w, res, y,
                                        scratch, N, Cin, Cout, relu,
                                        plan.blocks, st);
      break;
    default:
      err = launch_fwd_vec<FwdShort, FWD_FLUSH>(vec, u, scale, shift, w, res,
                                                y, scratch, N, Cin, Cout,
                                                relu, plan.blocks, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)col_reduce(scratch, ssum, ssq, plan.blocks, Cout, st);
}

// B2. Inputs as B1's plus y, dy [N, Cout] and d1, d2 [Cout]; writes du
// [N, Cin], dres [N, Cin] (skipped when null), dscale and dshift [Cin].
extern "C" int bn_act_conv1x1_bwd_dx(const float* u, const float* scale,
                                     const float* shift, const float* w,
                                     const float* res, const float* y,
                                     const float* dy, const float* d1,
                                     const float* d2, float* du, float* dres,
                                     float* dscale, float* dshift,
                                     float* scratch, int N, int Cin, int Cout,
                                     int relu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const void* ptrs[] = {u, scale, shift, w, res, y, dy, d1, d2, du, dres};
  const int vec = vec_for(Cin, Cout, ptrs, 11);
  const int blocks = dx_blocks(N, Cin);
  if (Cin <= 64)
    err = launch_bwd_dx_vec<DxNarrow>(vec, u, scale, shift, w, res, y, dy,
                                      d1, d2, du, dres, scratch, N, Cin,
                                      Cout, relu, blocks, st);
  else
    err = launch_bwd_dx_vec<DxWide>(vec, u, scale, shift, w, res, y, dy, d1,
                                    d2, du, dres, scratch, N, Cin, Cout, relu,
                                    blocks, st);
  if (err != cudaSuccess) return (int)err;
  return (int)col_reduce(scratch, dscale, dshift, blocks, Cin, st);
}

// B3. Inputs as B2's without w; writes dw [Cin, Cout].
extern "C" int bn_act_conv1x1_bwd_dw(const float* u, const float* scale,
                                     const float* shift, const float* res,
                                     const float* y, const float* dy,
                                     const float* d1, const float* d2,
                                     float* dw, float* scratch, int N,
                                     int Cin, int Cout, int relu, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const void* ptrs[] = {u, res, y, dy};
  const int vec = vec_for(Cin, Cout, ptrs, 4);
  const DwPlan plan = dw_plan(N, Cin, Cout);
  float* out = plan.splits > 1 ? scratch : dw;
  if (plan.bm == 64 && plan.bn == 64)
    err = launch_bwd_dw_vec<Dw64x64>(vec, u, scale, shift, res, y, dy, d1,
                                     d2, out, N, Cin, Cout, relu, plan, st);
  else if (plan.bm == 64)
    err = launch_bwd_dw_vec<Dw64x256>(vec, u, scale, shift, res, y, dy, d1,
                                      d2, out, N, Cin, Cout, relu, plan, st);
  else if (plan.bm == 256)
    err = launch_bwd_dw_vec<Dw256x64>(vec, u, scale, shift, res, y, dy, d1,
                                      d2, out, N, Cin, Cout, relu, plan, st);
  else
    err = launch_bwd_dw_vec<Dw128x128>(vec, u, scale, shift, res, y, dy, d1,
                                       d2, out, N, Cin, Cout, relu, plan, st);
  if (err != cudaSuccess || plan.splits == 1) return (int)err;
  const size_t count = (size_t)Cin * Cout;
  split_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      scratch, dw, plan.splits, count);
  return (int)cudaGetLastError();
}

extern "C" const char* bn_act_conv1x1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ------------------------------------------------------ the bf16 entry points
// As the f32 ones, with u, w, res, y, dy, du and dres bf16 (the pointers
// are void* for C) and scale, shift, d1, d2, ssum, ssq, dscale, dshift and
// dw f32. Widths not multiples of 8, or an array not 16-byte aligned,
// return cudaErrorInvalidValue and launch nothing.
extern "C" long long bn_act_conv1x1_scratch_floats_bf16(int kind, int N,
                                                        int Cin, int Cout) {
  if (kind == 0)
    return 2LL * wgmma_walk_blocks(N, Cout, fwd_wgmma_cols(Cout)) * Cout;
  if (kind == 1) return 2LL * wgmma_walk_blocks(N, Cin, WG_TILE) * Cin;
  const DwPlan plan = dw_plan_wgmma(N, Cin, Cout);
  return plan.splits > 1 ? (long long)plan.splits * Cin * Cout : 0;
}

extern "C" void bn_act_conv1x1_plan_bf16(int kind, int N, int Cin, int Cout,
                                         int has_res, long long* out) {
  const bool r = has_res != 0;
  out[4] = 0;
  if (kind == 0) {
    const int cols = fwd_wgmma_cols(Cout);
    out[0] = WG_TILE;
    out[1] = cols;
    out[2] = (long long)wgmma_walk_blocks(N, Cout, cols) * cdiv(Cout, cols);
    out[3] = cols == 64    ? (r ? FwdWg<true, 64>::BYTES
                                : FwdWg<false, 64>::BYTES)
             : cols == 128 ? (r ? FwdWg<true, 128>::BYTES
                                : FwdWg<false, 128>::BYTES)
                           : (r ? FwdWg<true, 256>::BYTES
                                : FwdWg<false, 256>::BYTES);
    return;
  }
  out[0] = out[1] = WG_TILE;
  if (kind == 1) {
    out[2] = (long long)wgmma_walk_blocks(N, Cin, WG_TILE) *
             cdiv(Cin, WG_TILE);
    out[3] = r ? DxWg<true>::BYTES : DxWg<false>::BYTES;
    return;
  }
  const DwPlan plan = dw_plan_wgmma(N, Cin, Cout);
  out[2] = (long long)cdiv(Cin, WG_TILE) * cdiv(Cout, WG_TILE) * plan.splits;
  out[3] = r ? DwWg<true>::BYTES : DwWg<false>::BYTES;
  out[4] = plan.chunk;
}

extern "C" int bn_act_conv1x1_fwd_bf16(const void* u, const float* scale,
                                       const float* shift, const void* w,
                                       const void* res, void* y, float* ssum,
                                       float* ssq, float* scratch, int N,
                                       int Cin, int Cout, int relu, int device,
                                       void* stream) {
  const void* ptrs[] = {u, scale, shift, w, res, y};
  if (!bf16_ok(Cin, Cout, ptrs, 6)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16 *ub = static_cast<const bf16*>(u), *wb = static_cast<const bf16*>(w),
             *rb = static_cast<const bf16*>(res);
  bf16* yb = static_cast<bf16*>(y);
  const int cols = fwd_wgmma_cols(Cout);
  const int blocks = wgmma_walk_blocks(N, Cout, cols);
  if (cols == 64)
    err = rb != nullptr
              ? launch_fwd_wgmma<true, 64>(ub, scale, shift, wb, rb, yb,
                                           scratch, N, Cin, Cout, relu,
                                           blocks, st)
              : launch_fwd_wgmma<false, 64>(ub, scale, shift, wb, rb, yb,
                                            scratch, N, Cin, Cout, relu,
                                            blocks, st);
  else if (cols == 128)
    err = rb != nullptr
              ? launch_fwd_wgmma<true, 128>(ub, scale, shift, wb, rb, yb,
                                            scratch, N, Cin, Cout, relu,
                                            blocks, st)
              : launch_fwd_wgmma<false, 128>(ub, scale, shift, wb, rb, yb,
                                             scratch, N, Cin, Cout, relu,
                                             blocks, st);
  else
    err = rb != nullptr
              ? launch_fwd_wgmma<true, 256>(ub, scale, shift, wb, rb, yb,
                                            scratch, N, Cin, Cout, relu,
                                            blocks, st)
              : launch_fwd_wgmma<false, 256>(ub, scale, shift, wb, rb, yb,
                                             scratch, N, Cin, Cout, relu,
                                             blocks, st);
  if (err != cudaSuccess) return (int)err;
  return (int)col_reduce(scratch, ssum, ssq, blocks, Cout, st);
}

extern "C" int bn_act_conv1x1_bwd_dx_bf16(
    const void* u, const float* scale, const float* shift, const void* w,
    const void* res, const void* y, const void* dy, const float* d1,
    const float* d2, void* du, void* dres, float* dscale, float* dshift,
    float* scratch, int N, int Cin, int Cout, int relu, int device,
    void* stream) {
  const void* ptrs[] = {u, scale, shift, w, res, y, dy, d1, d2, du, dres};
  if (!bf16_ok(Cin, Cout, ptrs, 11)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16 *ub = static_cast<const bf16*>(u), *wb = static_cast<const bf16*>(w),
             *rb = static_cast<const bf16*>(res),
             *yb = static_cast<const bf16*>(y),
             *dyb = static_cast<const bf16*>(dy);
  bf16 *dub = static_cast<bf16*>(du), *drb = static_cast<bf16*>(dres);
  const int blocks = wgmma_walk_blocks(N, Cin, WG_TILE);
  if (rb != nullptr)
    err = launch_bwd_dx_wgmma<true>(ub, scale, shift, wb, rb, yb, dyb, d1, d2,
                                    dub, drb, scratch, N, Cin, Cout, relu,
                                    blocks, st);
  else
    err = launch_bwd_dx_wgmma<false>(ub, scale, shift, wb, rb, yb, dyb, d1,
                                     d2, dub, drb, scratch, N, Cin, Cout,
                                     relu, blocks, st);
  if (err != cudaSuccess) return (int)err;
  return (int)col_reduce(scratch, dscale, dshift, blocks, Cin, st);
}

extern "C" int bn_act_conv1x1_bwd_dw_bf16(const void* u, const float* scale,
                                          const float* shift, const void* res,
                                          const void* y, const void* dy,
                                          const float* d1, const float* d2,
                                          float* dw, float* scratch, int N,
                                          int Cin, int Cout, int relu,
                                          int device, void* stream) {
  const void* ptrs[] = {u, res, y, dy, dw};
  if (!bf16_ok(Cin, Cout, ptrs, 5)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16 *ub = static_cast<const bf16*>(u), *rb = static_cast<const bf16*>(res),
             *yb = static_cast<const bf16*>(y),
             *dyb = static_cast<const bf16*>(dy);
  const DwPlan plan = dw_plan_wgmma(N, Cin, Cout);
  float* out = plan.splits > 1 ? scratch : dw;
  if (rb != nullptr)
    err = launch_bwd_dw_wgmma<true>(ub, scale, shift, rb, yb, dyb, d1, d2,
                                    out, N, Cin, Cout, relu, plan, st);
  else
    err = launch_bwd_dw_wgmma<false>(ub, scale, shift, rb, yb, dyb, d1, d2,
                                     out, N, Cin, Cout, relu, plan, st);
  if (err != cudaSuccess || plan.splits == 1) return (int)err;
  const size_t count = (size_t)Cin * Cout;
  split_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      scratch, dw, plan.splits, count);
  return (int)cudaGetLastError();
}
