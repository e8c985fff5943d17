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
// order, so here every row tile writes its column partials to a scratch
// [tiles, C] array and B3 splits the rows into chunks (split-K) with partial
// dw [splits, Cin, Cout]; a second small kernel of the same launch sums the
// partials in a fixed order. No atomics: results are the same run to run.
//
// Rounding: pre = u * scale + shift [+ res] is computed as separate rounded
// multiply and adds (__fmul_rn / __fadd_rn, no FMA contraction), the order
// PyTorch's elementwise ops round in, so the ReLU gate of the kernels is the
// gate of the plain version (ops/bn_act_conv1x1.py) bit for bit.
//
// What bounds it on one H100 SXM: each kernel is one GEMM of 2*N*Cin*Cout
// f32 operations on the CUDA cores (67 TFLOP/s) and reads u and y/dy once
// (3.35 TB/s). At the ResNet-50 shapes the two bounds meet: the res2 tail at
// batch 64 (N = 200,704, Cin 64, Cout 256) is bounded at 0.098 ms by
// operations and 0.077 ms by bytes. The design therefore does both kinds of
// work once: u is read once per column tile and the prologue runs as the tile
// is staged in shared memory, y's statistics come from the registers that
// hold y, and the GEMM is a register-tiled SIMT product (block tile 128 x 128
// or 128 x 64, depth 16, an 8 x 8 micro-tile a thread in two 4-wide halves so
// that shared-memory reads are conflict-free float4s). It is right and simple
// first: TF32 or bf16 mma/wgmma (TF32 would also break f32 parity), TMA,
// double buffering and a persistent schedule are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 128;        // rows (the GEMM's M) of a block tile
constexpr int BK = 16;         // depth of one shared-memory stage
constexpr int PAD = 4;         // floats of padding per shared row
constexpr int TM = 8;          // a thread's micro-tile: TM rows ...
constexpr int TN = 8;          // ... by TN columns
constexpr int TY = BM / TM;    // 16 threads along the rows
constexpr int RED = 32;        // partial-sum reduction block: RED x RED
// B3's split-K: aim for two blocks per SM of 132, never below this many rows
// a chunk
constexpr int DW_TARGET_BLOCKS = 264;
constexpr int DW_MIN_CHUNK = 256;

template <int BN>
struct Cfg {
  static constexpr int TX = BN / TN;           // threads along the columns
  static constexpr int THREADS = TX * TY;      // 256 (BN 128) or 128 (BN 64)
};
// resident blocks an SM the register budget must allow: at 256 threads,
// <= 128 registers a thread
constexpr int MIN_BLOCKS = 2;

// Rows and columns of a thread's micro-tile: two 4-wide halves, so that the
// float4 reads of a warp from shared memory are contiguous.
__device__ __forceinline__ int row_of(int ty, int i) {
  return i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4);
}
template <int BN>
__device__ __forceinline__ int col_of(int tx, int j) {
  return j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4);
}

// pre = u * scale + shift [+ res], rounded as PyTorch's elementwise ops
__device__ __forceinline__ float preact(float u, float s, float t,
                                       const float* res, size_t off) {
  float p = __fadd_rn(__fmul_rn(u, s), t);
  if (res != nullptr) p = __fadd_rn(p, res[off]);
  return p;
}

// dy_eff = dy + d1 + 2 * y * d2, rounded as PyTorch's elementwise ops
__device__ __forceinline__ float dy_eff(float dy, float y, float d1,
                                       float d2) {
  return __fadd_rn(__fadd_rn(dy, d1), __fmul_rn(__fmul_rn(2.f, y), d2));
}

__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_k As[k][row_of(i)] * Bs[k][col_of(j)] over one stage
template <int BN>
__device__ __forceinline__ void mma_stage(float (*As)[BM + PAD],
                                          float (*Bs)[BN + PAD],
                                          float (&acc)[TM][TN], int tx,
                                          int ty) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 a1 =
        *reinterpret_cast<const float4*>(&As[k][BM / 2 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float4 b1 =
        *reinterpret_cast<const float4*>(&Bs[k][BN / 2 + tx * 4]);
    const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The block's column sums of two per-thread partials (pa, pb: a thread's
// sums over its rows, one per micro-tile column), summed over the TY row
// threads in a fixed order and written as row `tile` of the [tiles, C]
// scratch arrays part_a and part_b.
template <int BN>
__device__ __forceinline__ void block_col_sums(float (*red)[BN],
                                               const float (&pa)[TN],
                                               const float (&pb)[TN], int tx,
                                               int ty, float* part_a,
                                               float* part_b, int tile,
                                               int col0, int C) {
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    red[ty][col_of<BN>(tx, j)] = pa[j];
    red[TY + ty][col_of<BN>(tx, j)] = pb[j];
  }
  __syncthreads();
  // THREADS == 2 * BN: one thread per (array, column)
  const int tid = threadIdx.x;
  const int which = tid / BN, c = tid % BN;
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < TY; ++r) s += red[which * TY + r][c];
  const int col = col0 + c;
  if (col < C) (which ? part_b : part_a)[(size_t)tile * C + col] = s;
}

// ------------------------------------------------------------------ B1
// Grid (row tiles, column tiles of Cout). z is staged as the A tile, w as B.
template <int BN>
__global__ void __launch_bounds__(Cfg<BN>::THREADS, MIN_BLOCKS)
fwd_kernel(const float* __restrict__ u, const float* __restrict__ scale,
           const float* __restrict__ shift, const float* __restrict__ w,
           const float* __restrict__ res, float* __restrict__ y,
           float* __restrict__ part, int N, int Cin, int Cout, int relu) {
  constexpr int THREADS = Cfg<BN>::THREADS;
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  __shared__ float red[2 * TY][BN];
  const int tid = threadIdx.x, tx = tid % Cfg<BN>::TX, ty = tid / Cfg<BN>::TX;
  const int tile = blockIdx.x;
  const int row0 = tile * BM, col0 = blockIdx.y * BN;
  float acc[TM][TN];
  zero(acc);

  for (int k0 = 0; k0 < Cin; k0 += BK) {
    // A = z [BM rows, BK channels]: neighbouring threads read neighbouring
    // channels of one row of u
#pragma unroll
    for (int it = 0; it < BM * BK / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int k = e % BK, m = e / BK;
      const int row = row0 + m, c = k0 + k;
      float z = 0.f;
      if (row < N && c < Cin) {
        const size_t off = (size_t)row * Cin + c;
        z = preact(u[off], scale[c], shift[c], res, off);
        if (relu) z = fmaxf(z, 0.f);
      }
      As[k][m] = z;
    }
    // B = w [BK channels, BN outputs]
#pragma unroll
    for (int it = 0; it < BK * BN / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int n = e % BN, k = e / BN;
      const int c = k0 + k, col = col0 + n;
      Bs[k][n] = (c < Cin && col < Cout) ? w[(size_t)c * Cout + col] : 0.f;
    }
    __syncthreads();
    mma_stage<BN>(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  // y, and the tile's column partials of y and y^2 (masked rows hold z = 0,
  // so y = 0 there; they are skipped all the same)
  float ps[TN], pq[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) ps[j] = pq[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + row_of(ty, i);
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + col_of<BN>(tx, j);
      if (col >= Cout) continue;
      const float v = acc[i][j];
      y[(size_t)row * Cout + col] = v;
      ps[j] += v;
      pq[j] = fmaf(v, v, pq[j]);
    }
  }
  block_col_sums<BN>(red, ps, pq, tx, ty, part,
                     part + (size_t)gridDim.x * Cout, tile, col0, Cout);
}

// ------------------------------------------------------------------ B2
// Grid (row tiles, column tiles of Cin). dz = dy_eff @ w^T: dy_eff is staged
// as the A tile, w read transposed in place as B (no transposed copy).
template <int BN>
__global__ void __launch_bounds__(Cfg<BN>::THREADS, MIN_BLOCKS)
bwd_dx_kernel(const float* __restrict__ u, const float* __restrict__ scale,
              const float* __restrict__ shift, const float* __restrict__ w,
              const float* __restrict__ res, const float* __restrict__ y,
              const float* __restrict__ dy, const float* __restrict__ d1,
              const float* __restrict__ d2, float* __restrict__ du,
              float* __restrict__ dres, float* __restrict__ part, int N,
              int Cin, int Cout, int relu) {
  constexpr int THREADS = Cfg<BN>::THREADS;
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  __shared__ float red[2 * TY][BN];
  const int tid = threadIdx.x, tx = tid % Cfg<BN>::TX, ty = tid / Cfg<BN>::TX;
  const int tile = blockIdx.x;
  const int row0 = tile * BM, col0 = blockIdx.y * BN;
  float acc[TM][TN];
  zero(acc);

  for (int k0 = 0; k0 < Cout; k0 += BK) {
    // A = dy_eff [BM rows, BK outputs]
#pragma unroll
    for (int it = 0; it < BM * BK / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int k = e % BK, m = e / BK;
      const int row = row0 + m, o = k0 + k;
      float g = 0.f;
      if (row < N && o < Cout) {
        const size_t off = (size_t)row * Cout + o;
        g = dy_eff(dy[off], y[off], d1[o], d2[o]);
      }
      As[k][m] = g;
    }
    // B = w^T [BK outputs, BN channels]: neighbouring threads read
    // neighbouring outputs of one row of w
#pragma unroll
    for (int it = 0; it < BK * BN / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int k = e % BK, n = e / BK;
      const int o = k0 + k, c = col0 + n;
      Bs[k][n] = (o < Cout && c < Cin) ? w[(size_t)c * Cout + o] : 0.f;
    }
    __syncthreads();
    mma_stage<BN>(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  // gate by the recomputed preactivation; du, dres; partials of dz*u, dz
  float ps[TN], pt[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) ps[j] = pt[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + row_of(ty, i);
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + col_of<BN>(tx, j);
      if (c >= Cin) continue;
      const size_t off = (size_t)row * Cin + c;
      const float uu = u[off], s = scale[c];
      float g = acc[i][j];
      if (relu && !(preact(uu, s, shift[c], res, off) > 0.f)) g = 0.f;
      du[off] = g * s;
      if (dres != nullptr) dres[off] = g;
      ps[j] = fmaf(g, uu, ps[j]);
      pt[j] += g;
    }
  }
  block_col_sums<BN>(red, ps, pt, tx, ty, part,
                     part + (size_t)gridDim.x * Cin, tile, col0, Cin);
}

// ------------------------------------------------------------------ B3
// Grid (tiles of Cin, tiles of Cout, row chunks). dw = z^T @ dy_eff over
// the rows [chunk * blockIdx.z, + chunk), into out[blockIdx.z].
template <int BN>
__global__ void __launch_bounds__(Cfg<BN>::THREADS, MIN_BLOCKS)
bwd_dw_kernel(const float* __restrict__ u, const float* __restrict__ scale,
              const float* __restrict__ shift, const float* __restrict__ res,
              const float* __restrict__ y, const float* __restrict__ dy,
              const float* __restrict__ d1, const float* __restrict__ d2,
              float* __restrict__ out, int N, int Cin, int Cout, int relu,
              int chunk) {
  constexpr int THREADS = Cfg<BN>::THREADS;
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  const int tid = threadIdx.x, tx = tid % Cfg<BN>::TX, ty = tid / Cfg<BN>::TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int r_begin = blockIdx.z * chunk;
  const int r_end = min(r_begin + chunk, N);
  float acc[TM][TN];
  zero(acc);

  for (int k0 = r_begin; k0 < r_end; k0 += BK) {
    // A = z^T [BK rows, BM channels]: neighbouring threads read
    // neighbouring channels of one row of u
#pragma unroll
    for (int it = 0; it < BM * BK / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int m = e % BM, k = e / BM;
      const int row = k0 + k, c = m0 + m;
      float z = 0.f;
      if (row < r_end && c < Cin) {
        const size_t off = (size_t)row * Cin + c;
        z = preact(u[off], scale[c], shift[c], res, off);
        if (relu) z = fmaxf(z, 0.f);
      }
      As[k][m] = z;
    }
    // B = dy_eff [BK rows, BN outputs]
#pragma unroll
    for (int it = 0; it < BK * BN / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int n = e % BN, k = e / BN;
      const int row = k0 + k, o = n0 + n;
      float g = 0.f;
      if (row < r_end && o < Cout) {
        const size_t off = (size_t)row * Cout + o;
        g = dy_eff(dy[off], y[off], d1[o], d2[o]);
      }
      Bs[k][n] = g;
    }
    __syncthreads();
    mma_stage<BN>(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  float* dst = out + (size_t)blockIdx.z * Cin * Cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = m0 + row_of(ty, i);
    if (c >= Cin) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = n0 + col_of<BN>(tx, j);
      if (o < Cout) dst[(size_t)c * Cout + o] = acc[i][j];
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

// B3's split of the N rows: chunks of a multiple of BK rows, enough of them
// to give ~DW_TARGET_BLOCKS blocks, none shorter than DW_MIN_CHUNK rows
int dw_splits(int N, int Cin, int Cout, int* chunk) {
  const int bn = Cout <= 64 ? 64 : 128;
  const int tiles = cdiv(Cin, BM) * cdiv(Cout, bn);
  int splits = cdiv(DW_TARGET_BLOCKS, tiles);
  const int most = N / DW_MIN_CHUNK > 1 ? N / DW_MIN_CHUNK : 1;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  *chunk = cdiv(cdiv(N, splits), BK) * BK;
  return cdiv(N, *chunk);
}

template <int BN>
void launch_fwd(const float* u, const float* scale, const float* shift,
                const float* w, const float* res, float* y, float* part,
                int N, int Cin, int Cout, int relu, cudaStream_t st) {
  const dim3 grid(cdiv(N, BM), cdiv(Cout, BN));
  fwd_kernel<BN><<<grid, Cfg<BN>::THREADS, 0, st>>>(
      u, scale, shift, w, res, y, part, N, Cin, Cout, relu);
}

template <int BN>
void launch_bwd_dx(const float* u, const float* scale, const float* shift,
                   const float* w, const float* res, const float* y,
                   const float* dy, const float* d1, const float* d2,
                   float* du, float* dres, float* part, int N, int Cin,
                   int Cout, int relu, cudaStream_t st) {
  const dim3 grid(cdiv(N, BM), cdiv(Cin, BN));
  bwd_dx_kernel<BN><<<grid, Cfg<BN>::THREADS, 0, st>>>(
      u, scale, shift, w, res, y, dy, d1, d2, du, dres, part, N, Cin, Cout,
      relu);
}

template <int BN>
void launch_bwd_dw(const float* u, const float* scale, const float* shift,
                   const float* res, const float* y, const float* dy,
                   const float* d1, const float* d2, float* out, int N,
                   int Cin, int Cout, int relu, int chunk, int splits,
                   cudaStream_t st) {
  const dim3 grid(cdiv(Cin, BM), cdiv(Cout, BN), splits);
  bwd_dw_kernel<BN><<<grid, Cfg<BN>::THREADS, 0, st>>>(
      u, scale, shift, res, y, dy, d1, d2, out, N, Cin, Cout, relu, chunk);
}

cudaError_t col_reduce(const float* part, float* out_a, float* out_b,
                       int tiles, int C, cudaStream_t st) {
  col_reduce_kernel<<<cdiv(C, RED), dim3(RED, RED), 0, st>>>(
      part, part + (size_t)tiles * C, out_a, out_b, tiles, C);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch a call needs: kind 0 = B1 ([2, row tiles, Cout]),
// 1 = B2 ([2, row tiles, Cin]), 2 = B3 ([splits, Cin, Cout], 0 when one
// chunk covers N and the kernel writes dw itself).
extern "C" long long bn_act_conv1x1_scratch_floats(int kind, int N, int Cin,
                                                   int Cout) {
  const long long tiles = cdiv(N, BM);
  if (kind == 0) return 2 * tiles * Cout;
  if (kind == 1) return 2 * tiles * Cin;
  int chunk;
  const int splits = dw_splits(N, Cin, Cout, &chunk);
  return splits > 1 ? (long long)splits * Cin * Cout : 0;
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
  if (Cout <= 64)
    launch_fwd<64>(u, scale, shift, w, res, y, scratch, N, Cin, Cout, relu,
                   st);
  else
    launch_fwd<128>(u, scale, shift, w, res, y, scratch, N, Cin, Cout, relu,
                    st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)col_reduce(scratch, ssum, ssq, cdiv(N, BM), Cout, st);
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
  if (Cin <= 64)
    launch_bwd_dx<64>(u, scale, shift, w, res, y, dy, d1, d2, du, dres,
                      scratch, N, Cin, Cout, relu, st);
  else
    launch_bwd_dx<128>(u, scale, shift, w, res, y, dy, d1, d2, du, dres,
                       scratch, N, Cin, Cout, relu, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)col_reduce(scratch, dscale, dshift, cdiv(N, BM), Cin, st);
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
  int chunk;
  const int splits = dw_splits(N, Cin, Cout, &chunk);
  float* out = splits > 1 ? scratch : dw;
  if (Cout <= 64)
    launch_bwd_dw<64>(u, scale, shift, res, y, dy, d1, d2, out, N, Cin,
                      Cout, relu, chunk, splits, st);
  else
    launch_bwd_dw<128>(u, scale, shift, res, y, dy, d1, d2, out, N, Cin,
                       Cout, relu, chunk, splits, st);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)Cin * Cout;
  split_reduce_kernel<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      scratch, dw, splits, count);
  return (int)cudaGetLastError();
}

extern "C" const char* bn_act_conv1x1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
