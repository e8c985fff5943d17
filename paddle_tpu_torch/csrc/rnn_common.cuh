// Shared pieces of the LSTM and GRU sequence kernels (lstm_seq.cu,
// gru_seq.cu), for Hopper (sm_90a), f32.
//
// - the activations, with expf/tanhf (never the fast intrinsics: the error of
//   one step feeds the next, over the whole sequence);
// - the weight-gradient GEMM dW = sum_n A(n, :)^T B(n, :) over the B*T rows
//   on the tensor cores, split over the rows (split-K) into partials that a
//   second kernel sums in a fixed order, so dW is bit-identical from run to
//   run (no atomics);
// - tc_kernel, a 3xTF32 mma.sync GEMM over the B*T rows of a sequence whose
//   A may be the output sequence y shifted by one step (h_{t-1}): the
//   backward's hoisted gate pre-activations x + h_{t-1} @ w, and dW;
// - the fixed-order sum of the per-block bias partials;
// - the cluster routes' pieces: the per-step product on the tensor cores
//   (tile_product), the forward's push of a block's rows into its peers'
//   shared memory, the split cluster barrier, and the plan: how many
//   clusters of CL blocks the card holds at once, how many batch rows each
//   takes, and which route takes a width (make_plan, over a file's Walks);
// - the grid route's pieces: a persistent grid of one block an SM whose
//   blocks own slices of the hidden units and meet at grid barriers
//   (grid_sync, a generation counter), the per-step product of a block on
//   the tensor cores with one operand streamed from L2 (grid_product), the
//   plan (grid_plan: resident or streamed weights, chunks of rows), and
//   the cooperative launches, a chunk of rows at a time (grid_launches).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <utility>

#include "tf32_mma.cuh"

namespace rnn {

// dynamic shared memory a block may use on an H100 (227 KB)
constexpr size_t SMEM_LIMIT = 232448;

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

// out[i] = sum_s part[s * count + i] over s < parts, in order
__global__ void ordered_sum_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int parts,
                                   size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[(size_t)p * count + i];
  out[i] = s;
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// out[i] = sum over the recurrence blocks of their partials part[blk, i]
inline cudaError_t block_sum(const float* part, float* out, int blocks,
                             int width, cudaStream_t st) {
  ordered_sum_kernel<<<cdiv(width, 256), 256, 0, st>>>(part, out, blocks,
                                                       (size_t)width);
  return cudaGetLastError();
}

// ------------------------------------------- 3xTF32 tensor-core GEMM (tc_*)
// C [M, N] = sum_k A(m, k) Bm(k, n) on the tensor cores at f32 accuracy
// (3xTF32, tf32_mma.cuh): block tile TM x TN, TK deep a stage, a ring of
// TSTAGES stages filled by cp.async, 4 warps of 32 x 32. The rows of a
// sequence array `a` [B*T, lda] are read through seq_row: with shift_t = T
// row n is row n - 1 (h_{t-1} from the output sequence y), zero where
// n % T == 0. A_T false: A(m, k) = row m of a, column k (the hoisted
// pre-activations, M = B*T, K = h); A_T true: A(m, k) = row k of a, column
// m (dW, M = h, K = B*T, split over blockIdx.z in chunks of `chunk` rows).
// Every TFLUSH stages the accumulators are added into f32 sums (round to
// nearest): the tensor cores' truncating adds never chain over more than
// TFLUSH * TK rows.
constexpr int TM = 64, TN = 64, TK = 16, TSTAGES = 3, TTHREADS = 128;
constexpr int TFLUSH = 8;
constexpr int TA = TM * (TK + 4);  // A stage floats (>= TK * (TM + 8))
constexpr int TB = TK * (TN + 8);  // Bm stage floats
constexpr int DW_TARGET_BLOCKS = 528;  // dW's blocks to aim for: four an SM
constexpr int DW_MIN_CHUNK = 256;      // fewest rows a split of dW

enum Epi {
  EPI_STORE,   // out[z][m][n] = C (dW and its split-K partials)
  EPI_PRE,     // out[m][n] = (x[m][n] (+ bias[n])) + C
  EPI_PRE_RH,  // EPI_PRE, and for n >= h: rh[m][n - h] = sig(out) * A(m, n - h)
               // where row m's step m % T < lens[m / T], else 0
};

struct Gemm {
  const float* a;
  int lda, shift_t;
  const float* bm;
  int ldb;
  float* out;
  int ldo;
  const float* x;      // EPI_PRE*
  int ldx;
  const float* bias;   // EPI_PRE*, may be null
  float* rh;           // EPI_PRE_RH: [B*T, h]
  const int* lens;
  int h;
  int M, N, K, chunk;
};

// row n of a sequence array (see tc_kernel), or null for a zero row
__device__ __forceinline__ const float* seq_row(const float* a, int lda,
                                                int shift_t, int n) {
  if (shift_t <= 0) return a + (size_t)n * lda;
  return n % shift_t != 0 ? a + (size_t)(n - 1) * lda : nullptr;
}

// cp.async of the ROWS x COLS window at (r0, c0) of a sequence array into
// shared memory (row stride sld); rows >= rlim, zero rows and columns >=
// clim are filled with zeros
template <int ROWS, int COLS, int VEC>
__device__ __forceinline__ void load_seq_window(float* s, int sld,
                                                const float* g, int gld,
                                                int shift_t, int r0, int rlim,
                                                int c0, int clim) {
  constexpr int PER_ROW = COLS / VEC, COUNT = ROWS * PER_ROW;
  static_assert(COUNT % TTHREADS == 0, "window");
#pragma unroll
  for (int e0 = 0; e0 < COUNT; e0 += TTHREADS) {
    const int e = e0 + threadIdx.x;
    const int r = e / PER_ROW, c = (e % PER_ROW) * VEC;
    const float* row =
        r0 + r < rlim ? seq_row(g, gld, shift_t, r0 + r) : nullptr;
    const bool ok = row != nullptr && c0 + c < clim;
    const float* src = ok ? row + c0 + c : g;
    if (VEC == 4)
      cp_async16(s + r * sld + c, src, ok ? 16 : 0);
    else
      cp_async4(s + r * sld + c, src, ok ? 4 : 0);
  }
}

// Fragment reads: A (A_T false) [TM][TK + 4], rows g and columns t fall in
// 32 banks; A (A_T true) and Bm [TK][TM or TN + 8], rows t and columns g.
template <bool A_T, int VEC, int EPI>
__global__ void __launch_bounds__(TTHREADS) tc_kernel(const Gemm p) {
  __shared__ __align__(16) float sm[TSTAGES][TA + TB];
  constexpr int ALD = A_T ? TM + 8 : TK + 4, BLD = TN + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wa = (warp & 1) * 32, wb = (warp >> 1) * 32;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const int k_begin = blockIdx.z * p.chunk;
  const int k_end = min(k_begin + p.chunk, p.K);
  const int steps = (k_end - k_begin + TK - 1) / TK;

  auto load = [&](int step) {
    float* st = sm[step % TSTAGES];
    const int k0 = k_begin + step * TK;
    if (A_T)
      load_seq_window<TK, TM, VEC>(st, ALD, p.a, p.lda, p.shift_t, k0, k_end,
                                   m0, p.M);
    else
      load_seq_window<TM, TK, VEC>(st, ALD, p.a, p.lda, p.shift_t, m0, p.M,
                                   k0, k_end);
    load_seq_window<TK, TN, VEC>(st + TA, BLD, p.bm, p.ldb, 0, k0, k_end, n0,
                                 p.N);
  };

  float acc[2][4][4], tot[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = tot[i][j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    if (it % TFLUSH == 0 && it > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            tot[i][j][c] = __fadd_rn(tot[i][j][c], acc[i][j][c]);
            acc[i][j][c] = 0.f;
          }
    }
    cp_async_wait<TSTAGES - 2>();
    __syncthreads();  // stage it has landed; stage it - 1 is free
    if (it + TSTAGES - 1 < steps) load(it + TSTAGES - 1);
    cp_async_commit();
    const float* as = sm[it % TSTAGES];
    const float* bs = as + TA;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 8) {
      unsigned ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // fragment k = t (q 0), t + 4 (q 1)
        const int k = kk + t + 4 * q;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {  // fragment row g, g + 8
            const int m = wa + i * 16 + g + 8 * hh;
            split_tf32_alu(A_T ? as[k * ALD + m] : as[m * ALD + k],
                           ahi[i][2 * q + hh], alo[i][2 * q + hh]);
          }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split_tf32_alu(bs[k * BLD + wb + j * 8 + g], bhi[j][q], blo[j][q]);
      }
      mma3_step<2, 4>(acc, ahi, alo, bhi, blo);
    }
  }
  cp_async_wait<0>();

  float* out = p.out + (size_t)blockIdx.z * p.M * p.ldo;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wa + i * 16 + g + 8 * hh;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + wb + j * 8 + 2 * t + q;
          if (n >= p.N) continue;
          float v = __fadd_rn(tot[i][j][2 * hh + q], acc[i][j][2 * hh + q]);
          if (EPI != EPI_STORE) {
            float xv = p.x[(size_t)m * p.ldx + n];
            if (p.bias != nullptr) xv = __fadd_rn(xv, p.bias[n]);
            v = __fadd_rn(xv, v);
          }
          out[(size_t)m * p.ldo + n] = v;
          if (EPI == EPI_PRE_RH && n >= p.h) {
            const int jj = n - p.h, step = m % p.shift_t;
            const float hp =
                step > 0 ? p.a[(size_t)(m - 1) * p.lda + jj] : 0.f;
            p.rh[(size_t)m * p.h + jj] =
                step < p.lens[m / p.shift_t] ? sigm(v) * hp : 0.f;
          }
        }
    }
}

// 16-byte copies where every width and base allows them
inline bool tc_vec4(const Gemm& p) {
  const bool widths = p.lda % 4 == 0 && p.ldb % 4 == 0 && p.M % 4 == 0 &&
                      p.N % 4 == 0 && p.K % 4 == 0;
  return widths && reinterpret_cast<size_t>(p.a) % 16 == 0 &&
         reinterpret_cast<size_t>(p.bm) % 16 == 0;
}

template <bool A_T, int EPI>
inline cudaError_t tc_gemm(const Gemm& p, int splits, cudaStream_t st) {
  const dim3 grid(cdiv(p.M, TM), cdiv(p.N, TN), splits);
  if (tc_vec4(p))
    tc_kernel<A_T, 4, EPI><<<grid, TTHREADS, 0, st>>>(p);
  else
    tc_kernel<A_T, 1, EPI><<<grid, TTHREADS, 0, st>>>(p);
  return cudaGetLastError();
}

// out [B*T, N] = (x (+ bias)) + A @ w, A the rows of `a` (shifted by one
// step when shift_t = T), w [K, N]; EPI_PRE_RH also writes rh (see Epi)
template <int EPI>
inline cudaError_t pre_gemm(const float* a, int lda, int shift_t,
                            const float* w, int ldw, const float* x, int ldx,
                            const float* bias, float* out, int ldo, int M,
                            int N, int K, float* rh, const int* lens, int h,
                            cudaStream_t st) {
  Gemm p{};
  p.a = a; p.lda = lda; p.shift_t = shift_t;
  p.bm = w; p.ldb = ldw;
  p.out = out; p.ldo = ldo;
  p.x = x; p.ldx = ldx; p.bias = bias;
  p.rh = rh; p.lens = lens; p.h = h;
  p.M = M; p.N = N; p.K = K; p.chunk = K;
  return tc_gemm<false, EPI>(p, 1, st);
}

// The split of the N rows of a K x C weight gradient: chunks of a multiple
// of TK rows, enough of them for ~DW_TARGET_BLOCKS blocks, none shorter
// than DW_MIN_CHUNK rows. Returns the number of chunks.
inline int dw_splits(long long N, int K, int C, int* chunk) {
  const int tiles = cdiv(K, TM) * cdiv(C, TN);
  long long splits = cdiv(DW_TARGET_BLOCKS, tiles);
  const long long most = N / DW_MIN_CHUNK > 1 ? N / DW_MIN_CHUNK : 1;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  *chunk = cdiv(cdiv(N, splits), TK) * TK;
  return cdiv(N, *chunk);
}

// Floats of scratch weight_grad needs for a K x C gradient over N rows.
inline long long dw_scratch_floats(long long N, int K, int C) {
  int chunk;
  const int splits = dw_splits(N, K, C, &chunk);
  return splits > 1 ? (long long)splits * K * C : 0;
}

// dw [K, C] = sum_n A(n, :)^T Bm(n, :) over the N rows of two sequence
// arrays (A shifted by one step where shift_t = T: h_{t-1}) on the tensor
// cores, split over the rows into partials in `scratch` (of
// dw_scratch_floats(N, K, C) floats) that ordered_sum_kernel adds in a
// fixed order: bit-identical run to run, no atomics
inline cudaError_t weight_grad(const float* a, int lda, int shift_t,
                               const float* bm, int ldb, float* dw,
                               float* scratch, int N, int K, int C,
                               cudaStream_t st) {
  int chunk;
  const int splits = dw_splits(N, K, C, &chunk);
  Gemm p{};
  p.a = a; p.lda = lda; p.shift_t = shift_t;
  p.bm = bm; p.ldb = ldb;
  p.out = splits > 1 ? scratch : dw; p.ldo = C;
  p.M = K; p.N = C; p.K = N; p.chunk = chunk;
  cudaError_t err = tc_gemm<true, EPI_STORE>(p, splits, st);
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = (size_t)K * C;
  ordered_sum_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      scratch, dw, splits, count);
  return cudaGetLastError();
}

// --------------------------------------------------- the cluster route
// The backward's reverse walk runs as clusters of CL blocks (portable size)
// over a group of batch rows each (a number of WALK_ROWS); block s of a
// cluster owns the hidden units [s U, (s + 1) U), U = ceil(h / CL).
constexpr int CL = 8;
// the rows a cluster may take (one instantiation each): dense enough that
// ceil(B / clusters the card holds) wastes few rows at the path batches
// (an H100 SXM holds 15 clusters of 8 at one block an SM: B = 64 takes 5,
// B = 256 takes 18), few enough to build quickly
#define RNN_WALK_ROWS(X) X(1) X(2) X(3) X(5) X(8) X(12) X(18) X(32)
constexpr int WALK_ROWS[] = {1, 2, 3, 5, 8, 12, 18, 32};

// f(std::integral_constant<int, R>) for a runtime R of WALK_ROWS
template <class F>
inline auto with_rows(int R, F&& f) {
  switch (R) {
#define RNN_ROWS_CASE(r) \
  case r:                \
    return f(std::integral_constant<int, r>{});
    RNN_WALK_ROWS(RNN_ROWS_CASE)
#undef RNN_ROWS_CASE
    default:
      return f(std::integral_constant<int, 1>{});
  }
}
constexpr int NTC = 512;   // threads of a cluster walk's block

// The cluster barrier in two halves, so that work that no peer waits for
// (dx's stores) runs while the barrier completes: arrive releases this
// thread's writes (the partial products in shared memory) to the cluster,
// wait acquires every block's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

inline __host__ __device__ int round8(int n) { return (n + 7) & ~7; }
inline __host__ __device__ int round16(int n) { return (n + 15) & ~15; }
// the columns of a weight slice (or rows of the step's gradients) of n
// own columns: zeros past n up to a multiple of 32 (four k-steps of 8)
inline __host__ __device__ int slice_cols(int n) { return (n + 31) & ~31; }
// the row stride of a weight slice: its columns + 4, so that a fragment's
// rows g and columns t fall in 32 banks
inline __host__ __device__ int slice_stride(int n) {
  return slice_cols(n) + 4;
}
// the row stride of the step's gradients [columns][rows R], R padded to 8
// (zeros) and = 8 or 24 (mod 32): a fragment's rows t and columns g fall
// in 32 banks
inline __host__ __device__ int grad_stride(int R) {
  const int rp = round8(R);
  return rp % 32 == 0 || rp % 32 == 16 ? rp + 8 : rp;
}

// The k-steps a product loads and splits before it issues their mma: the
// fragments of SETS steps fit the registers at R batch rows
__host__ __device__ constexpr int product_sets(int R) {
  return (R + 7) / 8 <= 2 ? 4 : 2;
}

// The shares of the depth K a product of M rows is split into: where M has
// fewer 16-row tiles than a block has warps, enough shares to give every
// warp a job, but no share without a group of SETS k-steps
__host__ __device__ inline int k_shares(int M, int K, int R) {
  const int tiles = (M + 15) / 16, groups = K / (8 * product_sets(R));
  int s = (NTC / 32) / tiles;
  if (s > groups) s = groups;
  return s < 1 ? 1 : s;
}

// C_s[r][m] = sum over the s-th share of the depth of A(m, k) B(k, r), for
// r < R, m < M and s < shares, on the tensor cores (3xTF32, tf32_mma.cuh):
// A(m, k) = a[m ast + k] over round16(M) rows, B(k, r) = b[k bs + r] (the
// batch rows as n, padded to 8), both zero past the real depth, K a
// multiple of 8 SETS; C_s[r][m] into out[(s R + r) os + m]. The walks'
// per-step products: B6/B8's partial dh (A the own-column weight slice
// read as [k][c], the depth its own columns, shares 1) and B5/B7's gate
// pre-activations (A the own columns of w read as [c][k], the depth h).
// The 16-row tiles and the shares of the depth (the k-groups s, s +
// shares, ... of SETS k-steps each) make the jobs; warp w takes the jobs
// w, w + NTC / 32, ... A job loads and splits the fragments of SETS
// k-steps first, then issues their mma pass by pass, each into its own
// accumulator set (no two dependent mma adjacent); the sets are added in a
// fixed order at the end, and the caller adds the shares in order.
template <int R>
__device__ __forceinline__ void tile_product(const float* a, int ast,
                                             const float* b, int bs, int K,
                                             int M, float* out, int os,
                                             int shares) {
  constexpr int NTL = (R + 7) / 8;
  constexpr int SETS = product_sets(R);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (M + 15) / 16;
  for (int job = warp; job < tiles * shares; job += NTC / 32) {
    const int m0 = (job % tiles) * 16, share = job / tiles;
    float acc[SETS][NTL][4];
#pragma unroll
    for (int s = 0; s < SETS; ++s)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;
    const float* arow = a + (m0 + g) * ast + t;
    for (int c0 = 8 * SETS * share; c0 < K; c0 += 8 * SETS * shares) {
      unsigned ahi[SETS][4], alo[SETS][4], bhi[SETS][NTL][2],
          blo[SETS][NTL][2];
#pragma unroll
      for (int s = 0; s < SETS; ++s) {
        const float* ap = arow + c0 + 8 * s;
        split_tf32_alu(ap[0], ahi[s][0], alo[s][0]);             // (g, t)
        split_tf32_alu(ap[8 * ast], ahi[s][1], alo[s][1]);       // (g + 8, t)
        split_tf32_alu(ap[4], ahi[s][2], alo[s][2]);             // (g, t + 4)
        split_tf32_alu(ap[8 * ast + 4], ahi[s][3], alo[s][3]);   // (g + 8, t+4)
#pragma unroll
        for (int j = 0; j < NTL; ++j) {
          const float* bp = b + (c0 + 8 * s + t) * bs + j * 8 + g;
          split_tf32_alu(bp[0], bhi[s][j][0], blo[s][j][0]);       // (k t, n g)
          split_tf32_alu(bp[4 * bs], bhi[s][j][1], blo[s][j][1]);  // (k t + 4)
        }
      }
#pragma unroll
      for (int s = 0; s < SETS; ++s)
#pragma unroll
        for (int j = 0; j < NTL; ++j) mma_tf32(acc[s][j], alo[s], bhi[s][j]);
#pragma unroll
      for (int s = 0; s < SETS; ++s)
#pragma unroll
        for (int j = 0; j < NTL; ++j) mma_tf32(acc[s][j], ahi[s], blo[s][j]);
#pragma unroll
      for (int s = 0; s < SETS; ++s)
#pragma unroll
        for (int j = 0; j < NTL; ++j) mma_tf32(acc[s][j], ahi[s], bhi[s][j]);
    }
    float* o = out + share * R * os;
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = j * 8 + 2 * t + (e & 1), m = m0 + g + 8 * (e >> 1);
        float v = acc[0][j][e] + acc[1][j][e];
        if (SETS == 4) v += acc[2][j][e] + acc[3][j][e];
        if (r < R && m < M) o[r * os + m] = v;
      }
  }
}

// The forward's exchange: floats [off, off + n) of the block's buffer
// `buf` (off and n multiples of 4, buf 16-byte aligned) stored into the
// same place of every other block of the cluster through distributed
// shared memory, 16 bytes a store, coalesced along the floats; each block
// starts at the rank after its own
template <class Cluster>
__device__ __forceinline__ void push_to_peers(Cluster& cluster, float* buf,
                                              int off, int n) {
  const int n4 = n / 4, me = (int)cluster.block_rank();
  const float4* src = reinterpret_cast<const float4*>(buf + off);
  for (int e = threadIdx.x; e < (CL - 1) * n4; e += NTC) {
    const int rk = (me + 1 + e / n4) % CL, i = e % n4;
    reinterpret_cast<float4*>(cluster.map_shared_rank(buf + off, rk))[i] =
        src[i];
  }
}

// The most clusters of CL blocks of NTC threads of `kernel`, at `smem`
// bytes of dynamic shared memory each, the device holds at once (0: none);
// a negative cudaError_t on failure. Cached per device, kernel and size.
template <class Kern>
inline int max_active_clusters(Kern* kernel, size_t smem, int device) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t>, int> cache;
  const auto key = std::make_tuple(device, (const void*)kernel, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) return hit->second;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(NTC);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  cache[key] = n;
  return n;
}

// Launch `kernel` as `clusters` clusters of CL blocks of NTC threads
template <class Kern, class... Args>
inline cudaError_t launch_clusters(Kern* kernel, int clusters, size_t smem,
                                   cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(CL * clusters);
  cfg.blockDim = dim3(NTC);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The plan of a walk: route 1 (cluster: `rows` batch rows a cluster,
// `blocks` clusters, of which the card holds `active` at once) or 2 (grid:
// `blocks` blocks of `units` hidden units each walk `rows` batch rows a
// launch, the card holds `active` blocks at once, `streamed` 1 where the
// blocks' slices of the weights do not fit shared memory and are read
// from L2 each step);
// route -1: no route asked for takes h.
struct Plan {
  int route, rows, blocks, active, units, streamed;
};

constexpr int GRID_HEAD = 32;     // scratch floats before a grid launch's
                                  // buffers: its barrier counter
constexpr int BIAS_PARTS = 64;    // row chunks of the grid route's bias
                                  // gradient

// The cluster route's rows a cluster: the fewest of WALK_ROWS whose shared
// memory fits a block and whose clusters all fit the card at once, else
// the most that fit (clusters then run in waves). `smem(R)` gives the
// bytes, `active(R)` the clusters the card holds at R (negative: an
// error). Returns 0 when not even R = 1 fits, or -err.
template <class Smem, class Active>
inline int cluster_rows(int B, Smem smem, Active active) {
  int best = 0;
  for (const int R : WALK_ROWS) {
    if (smem(R) > SMEM_LIMIT) break;
    const int n = active(R);
    if (n < 0) return n;
    if (n == 0) break;
    best = R;
    if (cdiv(B, R) <= n) break;
  }
  return best;
}

// A walk's plan at B batch rows (see Plan): `request` -1 takes the rule
// (the cluster route wherever its shared memory holds the width, else the
// grid route), 1 the cluster route, 2 the grid route; `smem`, `active` as
// for cluster_rows,
// `grid(p)` the grid route's plan. Route -1 when the route asked for does
// not take the width. Returns a cudaError_t.
template <class Smem, class Active, class Grid>
inline int make_plan(int B, int request, Smem smem, Active active, Grid grid,
                     Plan* p) {
  *p = {-1, 0, 0, 0, 0, 0};
  if (request == -1 || request == 1) {
    const int R = cluster_rows(B, smem, active);
    if (R < 0) return -R;
    if (R > 0) {
      *p = {1, R, cdiv(B, R), active(R), 0, 0};
      return 0;
    }
    if (request == 1) return 0;
  }
  if (request == -1 || request == 2) return grid(p);
  return 0;
}

// The route rule and the cluster launches of a file's two walks, over its
// `Walks`: Walks::kernel<KIND, R>() is the cluster kernel of the forward
// (KIND 0) or the backward (KIND 1) at R rows a cluster, Walks::smem(kind,
// h, R) its dynamic shared memory in bytes; Walks::grid_smem(kind, h, U,
// Bp, resident) a grid block's dynamic shared memory in bytes at U units
// and Bp rows (a multiple of 16), the weights' slices resident or not, and
// Walks::grid_active(kind, U, resident, bytes, device) the grid blocks the
// card holds at once (negative: -cudaError_t).

// The clusters of R rows the card holds at once of the kind's cluster walk
// (negative: -cudaError_t)
template <class Walks>
inline int walk_active(int kind, int R, int h, int device) {
  return with_rows(R, [&](auto rows) {
    constexpr int r = decltype(rows)::value;
    return kind == 0 ? max_active_clusters(Walks::template kernel<0, r>(),
                                           Walks::smem(0, h, r), device)
                     : max_active_clusters(Walks::template kernel<1, r>(),
                                           Walks::smem(1, h, r), device);
  });
}

// The grid route's plan (route 2) of the kind at (B, h) on `device`: U =
// ceil(h / SMs) units a block, ceil(h / U) blocks; all B rows in one
// launch with the weights' slices resident where a block's shared memory
// holds them, else streamed, in launches of the most rows (a multiple of
// 16) that fit. *p is left as it is where not even 16 rows fit. Returns a
// cudaError_t.
template <class Walks>
inline int grid_plan(int kind, int B, int h, int device, Plan* p) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int U = cdiv(h, sms), G = cdiv(h, U);
  auto smem = [&](int rows, bool res) {
    return Walks::grid_smem(kind, h, U, round16(rows), res);
  };
  const bool res = smem(B, true) <= SMEM_LIMIT;
  int rows = B;
  if (!res && smem(B, false) > SMEM_LIMIT) {
    rows = round16(B) - 16;
    while (rows >= 16 && smem(rows, false) > SMEM_LIMIT) rows -= 16;
    if (rows < 16) return 0;
  }
  const int active =
      Walks::grid_active(kind, U, res, smem(rows, res), device);
  if (active < 0) return -active;
  *p = {2, rows, G, active, U, res ? 0 : 1};
  return 0;
}

// The forward's (kind 0) or the backward's (kind 1) plan at (B, h) on
// `device`, for make_plan's `request`. Returns a cudaError_t.
template <class Walks>
inline int walk_plan(int kind, int B, int h, int device, int request,
                     Plan* p) {
  return make_plan(
      B, request, [&](int r) { return Walks::smem(kind, h, r); },
      [&](int r) { return walk_active<Walks>(kind, r, h, device); },
      [&](Plan* q) { return grid_plan<Walks>(kind, B, h, device, q); }, p);
}

// The C entry points *_fwd_plan (kind 0) and *_bwd_plan (kind 1): the plan
// at (B, h) on `device` into out = {route (1 cluster, 2 grid, -1 none),
// rows a cluster or grid launch, clusters or blocks, the
// clusters (grid: blocks) the card holds at once, hidden units a grid
// block, 1 where the grid route streams the weights}. Returns a
// cudaError_t.
template <class Walks>
inline int plan_entry(int kind, int B, int h, int device, int request,
                      int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  const int rc = walk_plan<Walks>(kind, B, h, device, request, &p);
  out[0] = p.route;
  out[1] = p.rows;
  out[2] = p.blocks;
  out[3] = p.active;
  out[4] = p.units;
  out[5] = p.streamed;
  return rc;
}

// The start of the C launch entry points: `device` set, and the plan at
// (B, h) for `request` into p, its route written into *taken (1 cluster,
// 2 grid; -1: the route asked for does not take h, nothing is launched).
// Returns a cudaError_t.
template <class Walks>
inline int launch_plan(int kind, int B, int h, int device, int request,
                       int* taken, Plan* p) {
  *taken = -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int rc = walk_plan<Walks>(kind, B, h, device, request, p);
  if (rc == 0) *taken = p->route;
  return rc;
}

// Launch the KIND cluster walk of plan p (route 1) at width h, with the
// kernel's arguments `args`
template <class Walks, int KIND, class... Args>
inline cudaError_t launch_walk(const Plan& p, int h, cudaStream_t st,
                               Args... args) {
  return with_rows(p.rows, [&](auto rows) {
    constexpr int r = decltype(rows)::value;
    return launch_clusters(Walks::template kernel<KIND, r>(), p.blocks,
                           Walks::smem(KIND, h, r), st, args...);
  });
}

// --------------------------------------------------- the grid route
// One persistent block an SM (cooperative launch: the card holds the whole
// grid at once, or the launch fails); block s owns the hidden units [s U,
// (s + 1) U) and every batch row of the launch. A step ends at one grid
// barrier, where a block's slice of the step's exchange (h_t, or the
// backward's gate gradients dg) becomes visible to every other block.
constexpr int GT = 256;        // threads of a grid block
constexpr int GW = GT / 32;    // its warps
constexpr int GPF = 4;         // k-groups of the A operand in flight
// a barrier that waits longer than this (ns) traps: a fault, never a hang
constexpr unsigned long long GRID_SYNC_TIMEOUT_NS = 20000000000ull;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The grid barrier: every block adds 1 to the counter *bar (zeroed before
// the launch, in stream order) and waits until it reaches `target` (the
// number of blocks times the barriers passed so far, this one included).
// The __syncthreads and the fences around thread 0's release add and
// acquire spin make every write of every block before the barrier visible
// to every block after it (a reader of another block's data still loads
// it with .cg: L1 is not coherent across SMs).
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar)
                 : "memory");
    const unsigned long long t0 = global_ns();
    unsigned v;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(bar)
                   : "memory");
      if ((int)(v - target) >= 0) break;
      if (global_ns() - t0 > GRID_SYNC_TIMEOUT_NS) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Operand loader of grid_product: float2 {X(r, k), X(r, k + 1)} of a
// row-major array (k even, rows and depth padded with zeros): rows other
// blocks wrote this step, read through L2 (.cg).
struct GlobalRows {
  const float* p;
  int ld;
  __device__ __forceinline__ float2 operator()(int r, int k) const {
    return __ldcg(reinterpret_cast<const float2*>(p + (size_t)r * ld + k));
  }
};

// The grid route's per-step product of one warp's job: acc[i][j] = the
// m16n8 tile (rows m0 + 16 i .., columns n0 + 8 j ..) of sum over k in
// [k0, k1) of A(m, k) Bt(n, k), i < mm <= MG, j < nn <= NG, on the tensor
// cores at f32 accuracy (3xTF32 mma.sync m16n8k8, split_tf32_alu);
// la(r, k) and lb(n, k) give float2 {X(k), X(k + 1)}. A group of 8
// depths is one mma k-step with its k permuted: fragment column t holds
// depth 2t and t + 4 depth 2t + 1, so a thread's A and B elements are
// adjacent (one 8-byte load each); in shared memory a row stride of 8 or
// 24 (mod 32) floats (grad_stride) keeps a warp's loads in 32 banks. The
// job's tiles share its fragments: a group's B is loaded and split once
// for all its m-tiles, A once for all its n-tiles. A's loads (the operand
// streamed from L2) run GPF groups ahead. Each pass runs over all the
// job's tiles (no two dependent mma adjacent); the truncating tensor-core
// sums chain over the job's depth only (the callers split the depth over
// the warps). FLOOR keeps the loads of A and drops the rest (the serial
// floor of a walk). acc[i][j][e] is C(m0 + 16 i + g + 8 (e >> 1), n0 +
// 8 j + 2 t + (e & 1)).
template <bool FLOOR, int MG, int NG, class LA, class LB>
__device__ __forceinline__ void grid_product(float (&acc)[MG][NG][4],
                                             const LA& la, const LB& lb,
                                             int m0, int mm, int n0, int nn,
                                             int k0, int k1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MG; ++i)
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int groups = (k1 - k0) / 8;
  float2 pa[GPF][MG][2];
  auto load = [&](float2 (&a)[MG][2], int k) {
#pragma unroll
    for (int i = 0; i < MG; ++i)
      if (i < mm) {
        a[i][0] = la(m0 + 16 * i + g, k);
        a[i][1] = la(m0 + 16 * i + g + 8, k);
      }
  };
#pragma unroll
  for (int q = 0; q < GPF; ++q)
    if (q < groups) load(pa[q], k0 + 8 * q + 2 * t);
  for (int i0 = 0; i0 < groups; i0 += GPF) {
#pragma unroll
    for (int q = 0; q < GPF; ++q) {
      const int it = i0 + q;
      if (it >= groups) break;
      float2 a[MG][2];
#pragma unroll
      for (int i = 0; i < MG; ++i) {
        a[i][0] = pa[q][i][0];
        a[i][1] = pa[q][i][1];
      }
      if (it + GPF < groups) load(pa[q], k0 + 8 * (it + GPF) + 2 * t);
      if (FLOOR) {
#pragma unroll
        for (int i = 0; i < MG; ++i)
          if (i < mm)
            acc[0][0][0] += (a[i][0].x + a[i][0].y) + (a[i][1].x + a[i][1].y);
        continue;
      }
      const int kb = k0 + 8 * it + 2 * t;
      unsigned bhi[NG][2], blo[NG][2];
#pragma unroll
      for (int j = 0; j < NG; ++j)
        if (j < nn) {
          const float2 b = lb(n0 + 8 * j + g, kb);
          split_tf32_alu(b.x, bhi[j][0], blo[j][0]);   // (k t, n g)
          split_tf32_alu(b.y, bhi[j][1], blo[j][1]);   // (k t + 4, n g)
        }
#pragma unroll
      for (int i = 0; i < MG; ++i)
        if (i < mm) {
          unsigned ahi[4], alo[4];
          split_tf32_alu(a[i][0].x, ahi[0], alo[0]);   // (g, t)
          split_tf32_alu(a[i][1].x, ahi[1], alo[1]);   // (g + 8, t)
          split_tf32_alu(a[i][0].y, ahi[2], alo[2]);   // (g, t + 4)
          split_tf32_alu(a[i][1].y, ahi[3], alo[3]);   // (g + 8, t + 4)
#pragma unroll
          for (int j = 0; j < NG; ++j)
            if (j < nn) mma_tf32(acc[i][j], alo, bhi[j]);
#pragma unroll
          for (int j = 0; j < NG; ++j)
            if (j < nn) mma_tf32(acc[i][j], ahi, blo[j]);
#pragma unroll
          for (int j = 0; j < NG; ++j)
            if (j < nn) mma_tf32(acc[i][j], ahi, bhi[j]);
        }
    }
  }
}

// The jobs of a grid product of M rows (a multiple of 16) by N columns
// over depth K (a multiple of 8): groups of MG m-tiles x groups of NG
// n-tiles, and the depth split in `shares` where there are fewer of those
// than warps (a warp a job then); shares == 1: each warp takes tiles w,
// w + GW, ...
struct GridJobs {
  int mt, ntl, mgr, tiles, shares, per, mg, ng;   // per: k-groups a share
  __device__ GridJobs(int M, int N, int K, int MG, int NG) : mg(MG), ng(NG) {
    mt = M / 16;
    ntl = (N + 7) / 8;
    mgr = (mt + MG - 1) / MG;
    tiles = mgr * ((ntl + NG - 1) / NG);
    const int groups = K / 8;
    shares = tiles >= GW ? 1 : GW / tiles;
    if (shares > groups) shares = groups;
    if (shares < 1) shares = 1;
    per = (groups + shares - 1) / shares;
  }
  __device__ int m0(int tile) const { return (tile % mgr) * mg * 16; }
  __device__ int mm(int tile) const {
    const int m = mt - (tile % mgr) * mg;
    return m < mg ? m : mg;
  }
  __device__ int n0(int tile) const { return (tile / mgr) * ng * 8; }
  __device__ int nn(int tile) const {
    const int n = ntl - (tile / mgr) * ng;
    return n < ng ? n : ng;
  }
};

// out [rows][ld] (shared memory) += the grid product of A (la) and B (lb)
// over depth K, the shares added in order (bit-identical run to run); the
// product's N columns must fit ld. Ends with a __syncthreads.
template <bool FLOOR, int MG, int NG, class LA, class LB>
__device__ __forceinline__ void grid_product_add(float* out, int ld, int M,
                                                 int N, int K, const LA& la,
                                                 const LB& lb) {
  const GridJobs J(M, N, K, MG, NG);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[MG][NG][4];
  auto add = [&](int tile) {
    const int m0 = J.m0(tile), mm = J.mm(tile), n0 = J.n0(tile),
              nn = J.nn(tile);
#pragma unroll
    for (int i = 0; i < MG; ++i)
      if (i < mm)
#pragma unroll
        for (int j = 0; j < NG; ++j)
          if (j < nn)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              out[(m0 + 16 * i + g + 8 * (e >> 1)) * ld + n0 + 8 * j +
                  2 * t + (e & 1)] += acc[i][j][e];
  };
  if (J.shares == 1) {
    for (int tile = warp; tile < J.tiles; tile += GW) {
      grid_product<FLOOR, MG, NG>(acc, la, lb, J.m0(tile), J.mm(tile),
                              J.n0(tile), J.nn(tile), 0, K);
      add(tile);
    }
    __syncthreads();
    return;
  }
  const int tile = warp % J.tiles, share = warp / J.tiles;
  const bool mine = share < J.shares;
  if (mine) {
    const int k0 = share * J.per * 8;
    const int k1 = min(K, k0 + J.per * 8);
    grid_product<FLOOR, MG, NG>(acc, la, lb, J.m0(tile), J.mm(tile), J.n0(tile),
                            J.nn(tile), k0, k1);
  }
  for (int q = 0; q < J.shares; ++q) {
    if (mine && share == q) add(tile);
    __syncthreads();
  }
}

// The blocks of `threads` threads of `kernel`, at `smem` bytes of dynamic
// shared memory each, the device holds at once (0: none); a negative
// cudaError_t on failure. Cached per device, kernel and size.
template <class Kern>
inline int max_active_blocks(Kern* kernel, int threads, size_t smem,
                             int device) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t>, int> cache;
  const auto key = std::make_tuple(device, (const void*)kernel, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) return hit->second;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  cache[key] = per_sm * sms;
  return per_sm * sms;
}

// Launch `kernel` as a cooperative grid of `blocks` blocks of GT threads:
// the launch fails (and nothing runs) where the card cannot hold them all
template <class Kern, class... Args>
inline cudaError_t launch_grid(Kern* kernel, int blocks, size_t smem,
                               cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* ptrs[] = {reinterpret_cast<void*>(&args)...};
  err = cudaLaunchCooperativeKernel((const void*)kernel,
                                    dim3(blocks), dim3(GT), ptrs, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The scratch floats of plan p's grid launches: the barrier and the
// exchange of `exchange(Bp, h)` floats at Bp = round16(p.rows) rows (0 off
// the grid route)
inline long long grid_floats(const Plan& p, int h,
                             long long (*exchange)(int, int)) {
  return p.route == 2 ? GRID_HEAD + exchange(round16(p.rows), h) : 0;
}

// The grid route's launches of plan p over B rows, p.rows at a time:
// before each, the barrier at `head` and the exchange after it zeroed in
// stream order (grid_floats of the launch's rows), then launch(r0, rows)
// for the rows from r0. Returns a cudaError_t.
template <class Launch>
inline cudaError_t grid_launches(const Plan& p, int B, int h, float* head,
                                 long long (*exchange)(int, int),
                                 cudaStream_t st, Launch launch) {
  for (int r0 = 0; r0 < B; r0 += p.rows) {
    Plan q = p;
    q.rows = B - r0 < p.rows ? B - r0 : p.rows;
    cudaError_t err = cudaMemsetAsync(
        head, 0, grid_floats(q, h, exchange) * sizeof(float), st);
    if (err != cudaSuccess) return err;
    err = launch(r0, q.rows);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace rnn
