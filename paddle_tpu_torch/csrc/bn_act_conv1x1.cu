// Fused BN -> ReLU -> 1x1-conv GEMM with a statistics epilogue, and its two
// backward GEMMs, for Hopper (sm_90a), f32.
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
// memory in bytes into out[0..3], and for B1 the stages between flushes of
// its accumulators (0: none) into out[4].
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
