// Shared pieces of the LSTM and GRU sequence kernels (lstm_seq.cu,
// gru_seq.cu), for Hopper (sm_90a), f32.
//
// - the activations, with expf/tanhf (never the fast intrinsics: the error of
//   one step feeds the next, over the whole sequence);
// - a block's rows of h_{t-1} loaded as a vector from shared memory;
// - warp sums;
// - the weight-gradient GEMM dW = sum_n A(n, :)^T B(n, :) over the B*T rows
//   on the tensor cores, split over the rows (split-K) into partials that a
//   second kernel sums in a fixed order, so dW is bit-identical from run to
//   run (no atomics);
// - tc_kernel, a 3xTF32 mma.sync GEMM over the B*T rows of a sequence whose
//   A may be the output sequence y shifted by one step (h_{t-1}): the
//   backward's hoisted gate pre-activations x + h_{t-1} @ w, and dW;
// - the fixed-order sum of the per-block bias partials;
// - the plan of the cluster route: how many clusters of CL blocks the card
//   holds at once, and how many batch rows each takes.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "tf32_mma.cuh"

namespace rnn {

constexpr int NT = 256;            // threads of a recurrence block
constexpr int NW = NT / 32;        // its warps
// dynamic shared memory a block may use on an H100 (227 KB)
constexpr size_t SMEM_LIMIT = 232448;

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

// v[r] = s[r] for r < BB, from 16-byte (BB 4, 8) or 8-byte (BB 2) aligned s
template <int BB>
__device__ __forceinline__ void load_rows(const float* s, float (&v)[BB]) {
  if constexpr (BB % 4 == 0) {
#pragma unroll
    for (int q = 0; q < BB / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(s)[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else if constexpr (BB == 2) {
    const float2 f = *reinterpret_cast<const float2*>(s);
    v[0] = f.x;
    v[1] = f.y;
  } else {
#pragma unroll
    for (int r = 0; r < BB; ++r) v[r] = s[r];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// P[r][k] = sum over c < n of d[c][r] * wsl[k][c] for r < R, k < h, on the
// tensor cores (3xTF32, tf32_mma.cuh): the walk's product of the step's
// gradients d [slice_cols(n)][ds] (columns past R and rows past n zero)
// with an own-column weight slice wsl [round16(h)][wst] (columns past n and
// rows past h zero), into P [R][h]. M = the rows k of the slice, N = the
// batch rows r, K = its columns c. A warp takes the 16-row tiles warp, warp
// + NTC / 32, ..., all N tiles of each. SETS k-steps at a time: their
// fragments are loaded and split first, then their mma issued pass by pass,
// each into its own accumulator set (no two dependent mma adjacent); the
// sets are added in a fixed order at the end.
template <int R>
__device__ __forceinline__ void slice_product(const float* wsl, int wst,
                                              const float* d, int ds, int n,
                                              float* P, int h) {
  constexpr int NTL = (R + 7) / 8;
  constexpr int SETS = NTL <= 2 ? 4 : 2;  // registers: fragments of SETS
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int K = slice_cols(n);
  for (int m0 = warp * 16; m0 < h; m0 += NTC / 2) {
    float acc[SETS][NTL][4];
#pragma unroll
    for (int s = 0; s < SETS; ++s)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;
    const float* arow = wsl + (m0 + g) * wst + t;
    for (int c0 = 0; c0 < K; c0 += 8 * SETS) {
      unsigned ahi[SETS][4], alo[SETS][4], bhi[SETS][NTL][2],
          blo[SETS][NTL][2];
#pragma unroll
      for (int s = 0; s < SETS; ++s) {
        const float* a = arow + c0 + 8 * s;
        split_tf32_alu(a[0], ahi[s][0], alo[s][0]);             // (g, t)
        split_tf32_alu(a[8 * wst], ahi[s][1], alo[s][1]);       // (g + 8, t)
        split_tf32_alu(a[4], ahi[s][2], alo[s][2]);             // (g, t + 4)
        split_tf32_alu(a[8 * wst + 4], ahi[s][3], alo[s][3]);   // (g + 8, t+4)
#pragma unroll
        for (int j = 0; j < NTL; ++j) {
          const float* b = d + (c0 + 8 * s + t) * ds + j * 8 + g;
          split_tf32_alu(b[0], bhi[s][j][0], blo[s][j][0]);       // (k t, n g)
          split_tf32_alu(b[4 * ds], bhi[s][j][1], blo[s][j][1]);  // (k t + 4)
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
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = j * 8 + 2 * t + (e & 1), k = m0 + g + 8 * (e >> 1);
        float v = acc[0][j][e] + acc[1][j][e];
        if (SETS == 4) v += acc[2][j][e] + acc[3][j][e];
        if (r < R && k < h) P[r * h + k] = v;
      }
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

// The plan of a backward: route 1 (cluster: `rows` batch rows a cluster,
// `blocks` clusters, of which the card holds `active` at once) or 0 (the
// walk: `rows` rows a block, `blocks` blocks); route -1: neither takes h.
struct BwdPlan {
  int route, rows, blocks, active;
};

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

}  // namespace rnn
