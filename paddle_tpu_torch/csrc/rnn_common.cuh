// Shared pieces of the LSTM and GRU sequence kernels (lstm_seq.cu,
// gru_seq.cu), for Hopper (sm_90a), f32.
//
// - the activations, with expf/tanhf (never the fast intrinsics: the error of
//   one step feeds the next, over the whole sequence);
// - a block's rows of h_{t-1} loaded as a vector from shared memory;
// - warp sums;
// - the weight-gradient GEMM dW = sum_n A(n, :)^T B(n, :) over the B*T rows,
//   split over the rows (split-K) into partials that a second kernel sums in
//   a fixed order, so dW is bit-identical from run to run (no atomics);
// - the fixed-order sum of the per-block bias partials.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

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

// out[k, c] += sum over this block's rows n of A(n, k) * Bm(n, c), for
// k < K, c < C. The rows are [chunk * blockIdx.z, + chunk) of N. A(n, k) is
// a[n * lda + k], or with shift_t > 0 the row before: a[(n - 1) * lda + k]
// when n % shift_t > 0 and 0 when n % shift_t == 0 (h_{t-1} read from the
// output sequence y [B, T, h], zero at t = 0). Bm(n, c) = bm[n * ldb + c].
// Block tile 64 x 64, depth 16, 4 x 4 a thread; partial out[blockIdx.z].
constexpr int GM = 64, GN = 64, GK = 16, GPAD = 4;
constexpr int DW_TARGET_BLOCKS = 264;  // two blocks per SM of 132
constexpr int DW_MIN_CHUNK = 256;

__global__ void __launch_bounds__(256)
at_b_kernel(const float* __restrict__ a, int lda, int shift_t,
            const float* __restrict__ bm, int ldb, float* __restrict__ out,
            int N, int K, int C, int chunk) {
  __shared__ __align__(16) float As[GK][GM + GPAD];
  __shared__ __align__(16) float Bs[GK][GN + GPAD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * GM, c0 = blockIdx.y * GN;
  const int r_begin = blockIdx.z * chunk;
  const int r_end = min(r_begin + chunk, N);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = r_begin; n0 < r_end; n0 += GK) {
#pragma unroll
    for (int it = 0; it < GK * GM / 256; ++it) {
      const int e = tid + it * 256;
      const int m = e % GM, kk = e / GM;
      const int n = n0 + kk, k = m0 + m;
      float v = 0.f;
      if (n < r_end && k < K) {
        if (shift_t <= 0)
          v = a[(size_t)n * lda + k];
        else if (n % shift_t != 0)
          v = a[(size_t)(n - 1) * lda + k];
      }
      As[kk][m] = v;
    }
#pragma unroll
    for (int it = 0; it < GK * GN / 256; ++it) {
      const int e = tid + it * 256;
      const int cc = e % GN, kk = e / GN;
      const int n = n0 + kk, c = c0 + cc;
      Bs[kk][cc] = (n < r_end && c < C) ? bm[(size_t)n * ldb + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dst = out + (size_t)blockIdx.z * K * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = m0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < C) dst[(size_t)k * C + c] = acc[i][j];
    }
  }
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

// The split of the N rows of a K x C weight gradient: chunks of a multiple
// of GK rows, enough of them for ~DW_TARGET_BLOCKS blocks, none shorter than
// DW_MIN_CHUNK rows. Returns the number of chunks.
inline int dw_splits(long long N, int K, int C, int* chunk) {
  const int tiles = cdiv(K, GM) * cdiv(C, GN);
  long long splits = cdiv(DW_TARGET_BLOCKS, tiles);
  const long long most = N / DW_MIN_CHUNK > 1 ? N / DW_MIN_CHUNK : 1;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  *chunk = cdiv(cdiv(N, splits), GK) * GK;
  return cdiv(N, *chunk);
}

// Floats of scratch weight_grad needs for a K x C gradient over N rows.
inline long long dw_scratch_floats(long long N, int K, int C) {
  int chunk;
  const int splits = dw_splits(N, K, C, &chunk);
  return splits > 1 ? (long long)splits * K * C : 0;
}

// dw [K, C] = sum_n A(n, :)^T Bm(n, :) (see at_b_kernel), with `scratch`
// of dw_scratch_floats(N, K, C) floats.
inline cudaError_t weight_grad(const float* a, int lda, int shift_t,
                               const float* bm, int ldb, float* dw,
                               float* scratch, int N, int K, int C,
                               cudaStream_t st) {
  int chunk;
  const int splits = dw_splits(N, K, C, &chunk);
  float* out = splits > 1 ? scratch : dw;
  const dim3 grid(cdiv(K, GM), cdiv(C, GN), splits);
  at_b_kernel<<<grid, 256, 0, st>>>(a, lda, shift_t, bm, ldb, out, N, K, C,
                                    chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = (size_t)K * C;
  ordered_sum_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      scratch, dw, splits, count);
  return cudaGetLastError();
}

// out[i] = sum over the recurrence blocks of their partials part[blk, i]
inline cudaError_t block_sum(const float* part, float* out, int blocks,
                             int width, cudaStream_t st) {
  ordered_sum_kernel<<<cdiv(width, 256), 256, 0, st>>>(part, out, blocks,
                                                       (size_t)width);
  return cudaGetLastError();
}

}  // namespace rnn
