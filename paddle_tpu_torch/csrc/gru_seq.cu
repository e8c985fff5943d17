// GRU over a whole sequence with masked carry, and its backward, for Hopper
// (sm_90a), f32.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_rnn.py:
//   B7 _gru_fwd_kernel (kernel _gru_kernel):         y
//   B8 _gru_bwd_pallas (kernel _gru_bwd_kernel):     dx, dw_g, dw_c, db
// Contract (gate order [u, r | c], the reset applied before the candidate
// product):
//   xb = x_t + b,  gur = h_{t-1} @ w_g
//   u  = sig(xb_u + gur_u),  r = sig(xb_r + gur_r)
//   c  = tanh(xb_c + (r * h_{t-1}) @ w_c),  out = u * h_{t-1} + (1 - u) * c
// At t >= len the state carries through and y = 0; a row of length 0 gives
// zeros and gradients of 0. x [B, T, 3h] is pre-projected.
//
// Design, as lstm_seq.cu: one block owns BB batch rows and walks the whole
// sequence, h_{t-1} in shared memory, w_g and w_c read from device memory
// (L2) every step, a thread per hidden unit for the pointwise math. The
// forward has two products a step, the second on r * h_{t-1}, so two
// __syncthreads: one publishes r * h_{t-1}, the other the new h.
//
// The backward walks time in reverse, recomputing u, r and c from x and the
// saved y (h_{t-1} = y[t-1], zero at t = 0). Per step: phase 1 (thread per
// unit) u, r and r * h_{t-1}, which also goes to a scratch sequence for
// dW_c; phase 2 (thread per unit) c, dg_c and dg_u; phase 3 (a warp per unit
// k, w_c's row k read coalesced) d(r h) = dg_c @ w_c^T, then dg_r; phase 4
// (a warp per unit) dh_{t-1} += dg_ur @ w_g^T. Each block writes its partial
// db [3h]; then, in the same entry point, dW_g = sum h_{t-1}^T dg_ur and
// dW_c = sum (r h_{t-1})^T dg_c are split-K GEMMs over the B*T rows, all
// summed in a fixed order (bit-identical from run to run).
//
// What bounds it on one H100 SXM: as lstm_seq.cu, the serial walk, each step
// reading the 3h^2 floats of w_g and w_c from L2 (twice in the backward).
#include <cuda_runtime.h>
#include <stddef.h>

#include "rnn_common.cuh"

using rnn::NT;
using rnn::NW;

namespace {

size_t fwd_smem(int h, int bb) { return (size_t)3 * h * bb * sizeof(float); }
size_t bwd_smem(int h, int bb) { return (size_t)9 * h * bb * sizeof(float); }

int block_rows(int kind, int h) {
  for (int bb = 8; bb >= 1; bb /= 2)
    if ((kind == 0 ? fwd_smem(h, bb) : bwd_smem(h, bb)) <= rnn::SMEM_LIMIT)
      return bb;
  return 0;
}

// acc[r][q] = sum_k hp[k][r] * w_g[k][q * h + j] for q < 2 (u and r)
template <int BB>
__device__ __forceinline__ void ur_product(const float* __restrict__ w_g,
                                           const float* hp, int h, int j,
                                           float (&acc)[BB][2]) {
#pragma unroll
  for (int r = 0; r < BB; ++r) acc[r][0] = acc[r][1] = 0.f;
  const size_t h2 = 2 * (size_t)h;
  const float* wj = w_g + j;
#pragma unroll 4
  for (int k = 0; k < h; ++k) {
    const float w0 = wj[k * h2], w1 = wj[k * h2 + h];
    float hv[BB];
    rnn::load_rows<BB>(hp + (size_t)k * BB, hv);
#pragma unroll
    for (int r = 0; r < BB; ++r) {
      acc[r][0] = fmaf(hv[r], w0, acc[r][0]);
      acc[r][1] = fmaf(hv[r], w1, acc[r][1]);
    }
  }
}

// acc[r] = sum_k rh[k][r] * w_c[k][j]
template <int BB>
__device__ __forceinline__ void c_product(const float* __restrict__ w_c,
                                          const float* rh, int h, int j,
                                          float (&acc)[BB]) {
#pragma unroll
  for (int r = 0; r < BB; ++r) acc[r] = 0.f;
  const float* wj = w_c + j;
#pragma unroll 4
  for (int k = 0; k < h; ++k) {
    const float wv = wj[(size_t)k * h];
    float v[BB];
    rnn::load_rows<BB>(rh + (size_t)k * BB, v);
#pragma unroll
    for (int r = 0; r < BB; ++r) acc[r] = fmaf(v[r], wv, acc[r]);
  }
}

// a[r] = sum_c g[r][c] * w[k][c] over c < width, summed across the warp
// (every lane gets the sums); g is [BB][width] in shared memory
template <int BB>
__device__ __forceinline__ void row_dot(const float* g,
                                        const float* __restrict__ wk,
                                        int width, int lane, float (&a)[BB]) {
#pragma unroll
  for (int r = 0; r < BB; ++r) a[r] = 0.f;
  for (int c = lane; c < width; c += 32) {
    const float wv = wk[c];
#pragma unroll
    for (int r = 0; r < BB; ++r) a[r] = fmaf(g[r * width + c], wv, a[r]);
  }
#pragma unroll
  for (int r = 0; r < BB; ++r) a[r] = rnn::warp_sum(a[r]);
}

template <int BB>
__global__ void __launch_bounds__(NT)
gru_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w_g,
               const float* __restrict__ w_c, const float* __restrict__ b,
               const int* __restrict__ lens, float* __restrict__ y, int B,
               int T, int h) {
  extern __shared__ __align__(16) float smem[];
  float* hp = smem;                     // [h][BB] h_{t-1}
  float* rh = hp + h * BB;              // [h][BB] r * h_{t-1}
  float* us = rh + h * BB;              // [BB][h] u, a unit's own thread
  const int row0 = blockIdx.x * BB;
  const size_t h3 = 3 * (size_t)h;
  int len[BB];
#pragma unroll
  for (int r = 0; r < BB; ++r) len[r] = row0 + r < B ? lens[row0 + r] : 0;
  for (int i = threadIdx.x; i < 3 * h * BB; i += NT) smem[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int j = threadIdx.x; j < h; j += NT) {
      float acc[BB][2];
      ur_product<BB>(w_g, hp, h, j, acc);
      const float bu = b[j], br = b[h + j];
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        float rhv = 0.f;
        if (t < len[r]) {
          const float* xr = x + ((size_t)(row0 + r) * T + t) * h3;
          const float u = rnn::sigm((xr[j] + bu) + acc[r][0]);
          const float rg = rnn::sigm((xr[h + j] + br) + acc[r][1]);
          rhv = rg * hp[j * BB + r];
          us[r * h + j] = u;
        }
        rh[j * BB + r] = rhv;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < h; j += NT) {
      float acc[BB];
      c_product<BB>(w_c, rh, h, j, acc);
      const float bc = b[2 * h + j];
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const int row = row0 + r;
        const size_t o = ((size_t)row * T + t) * h + j;
        if (t < len[r]) {
          const float* xr = x + ((size_t)row * T + t) * h3;
          const float c = tanhf((xr[2 * h + j] + bc) + acc[r]);
          const float u = us[r * h + j];
          const float out = u * hp[j * BB + r] + (1.f - u) * c;
          hp[j * BB + r] = out;         // only unit j's thread reads it now
          y[o] = out;
        } else if (row < B) {
          y[o] = 0.f;
        }
      }
    }
    __syncthreads();
  }
}

template <int BB>
__global__ void __launch_bounds__(NT)
gru_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w_g,
               const float* __restrict__ w_c, const float* __restrict__ b,
               const int* __restrict__ lens, const float* __restrict__ y,
               const float* __restrict__ dy, float* __restrict__ dx,
               float* __restrict__ rh_seq, float* __restrict__ part_db, int B,
               int T, int h) {
  extern __shared__ __align__(16) float smem[];
  float* hp = smem;                     // [h][BB] h_{t-1} = y[t-1]
  float* rh = hp + h * BB;              // [h][BB] r * h_{t-1}
  float* us = rh + h * BB;              // [BB][h] u
  float* rs = us + h * BB;              // [BB][h] r
  float* dgc = rs + h * BB;             // [BB][h] dg_c
  float* dgur = dgc + h * BB;           // [BB][2h] dg_u | dg_r
  float* dh = dgur + 2 * h * BB;        // [BB][h] dL/dh carried back
  const int row0 = blockIdx.x * BB;
  const size_t h3 = 3 * (size_t)h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* part = part_db + (size_t)blockIdx.x * 3 * h;
  int len[BB];
#pragma unroll
  for (int r = 0; r < BB; ++r) len[r] = row0 + r < B ? lens[row0 + r] : 0;
  for (int i = threadIdx.x; i < 9 * h * BB; i += NT) smem[i] = 0.f;
  for (int i = threadIdx.x; i < 3 * h; i += NT) part[i] = 0.f;
  auto load_hp = [&](int t) {
    for (int i = threadIdx.x; i < h * BB; i += NT) {
      const int r = i / h, k = i % h, row = row0 + r;
      hp[k * BB + r] = (t > 0 && row < B)
                           ? y[((size_t)row * T + t - 1) * h + k] : 0.f;
    }
  };
  load_hp(T - 1);
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    // phase 1: u, r and r * h_{t-1} of unit j
    for (int j = threadIdx.x; j < h; j += NT) {
      float acc[BB][2];
      ur_product<BB>(w_g, hp, h, j, acc);
      const float bu = b[j], br = b[h + j];
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const int row = row0 + r;
        float rhv = 0.f;
        if (t < len[r]) {
          const float* xr = x + ((size_t)row * T + t) * h3;
          const float u = rnn::sigm((xr[j] + bu) + acc[r][0]);
          const float rg = rnn::sigm((xr[h + j] + br) + acc[r][1]);
          rhv = rg * hp[j * BB + r];
          us[r * h + j] = u;
          rs[r * h + j] = rg;
        }
        rh[j * BB + r] = rhv;
        if (row < B) rh_seq[((size_t)row * T + t) * h + j] = rhv;
      }
    }
    __syncthreads();
    // phase 2: c of unit j; dg_c and dg_u
    for (int j = threadIdx.x; j < h; j += NT) {
      float acc[BB];
      c_product<BB>(w_c, rh, h, j, acc);
      const float bc = b[2 * h + j];
      float su = 0.f, sc = 0.f;
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const int row = row0 + r;
        const size_t base = (size_t)row * T + t;
        if (t < len[r]) {
          const float c = tanhf((x[base * h3 + 2 * h + j] + bc) + acc[r]);
          const float u = us[r * h + j];
          const float hpv = hp[j * BB + r];
          const float dout = dh[r * h + j] + dy[base * h + j];
          const float dgc_v = dout * (1.f - u) * (1.f - c * c);
          const float dgu_v = dout * (hpv - c) * u * (1.f - u);
          dx[base * h3 + j] = dgu_v;
          dx[base * h3 + 2 * h + j] = dgc_v;
          dgc[r * h + j] = dgc_v;
          dgur[r * 2 * h + j] = dgu_v;
          dh[r * h + j] = dout * u;
          su += dgu_v;
          sc += dgc_v;
        } else {
          dgc[r * h + j] = 0.f;
          dgur[r * 2 * h + j] = 0.f;
          if (row < B) {
            dx[base * h3 + j] = 0.f;
            dx[base * h3 + 2 * h + j] = 0.f;
          }
        }
      }
      part[j] += su;
      part[2 * h + j] += sc;
    }
    __syncthreads();
    // phase 3: d(r h)[r][k] = sum_c dg_c[r][c] * w_c[k][c]; dg_r of unit k
    for (int k = warp; k < h; k += NW) {
      float a[BB];
      row_dot<BB>(dgc, w_c + (size_t)k * h, h, lane, a);
      if (lane == 0) {
        float sr = 0.f;
#pragma unroll
        for (int r = 0; r < BB; ++r) {
          const int row = row0 + r;
          const size_t base = (size_t)row * T + t;
          if (t < len[r]) {
            const float rg = rs[r * h + k];
            const float dgr = a[r] * hp[k * BB + r] * rg * (1.f - rg);
            dx[base * h3 + h + k] = dgr;
            dgur[r * 2 * h + h + k] = dgr;
            dh[r * h + k] += a[r] * rg;
            sr += dgr;
          } else {
            dgur[r * 2 * h + h + k] = 0.f;
            if (row < B) dx[base * h3 + h + k] = 0.f;
          }
        }
        part[h + k] += sr;
      }
    }
    __syncthreads();
    // phase 4: dh_{t-1}[r][k] += sum_c dg_ur[r][c] * w_g[k][c]
    for (int k = warp; k < h; k += NW) {
      float a[BB];
      row_dot<BB>(dgur, w_g + (size_t)k * 2 * h, 2 * h, lane, a);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < BB; ++r) dh[r * h + k] += a[r];
      }
    }
    if (t > 0) load_hp(t - 1);
    __syncthreads();
  }
}

template <int BB>
cudaError_t launch_fwd(const float* x, const float* w_g, const float* w_c,
                       const float* b, const int* lens, float* y, int B,
                       int T, int h, cudaStream_t st) {
  const size_t smem = fwd_smem(h, BB);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel<BB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  gru_fwd_kernel<BB><<<rnn::cdiv(B, BB), NT, smem, st>>>(x, w_g, w_c, b,
                                                         lens, y, B, T, h);
  return cudaGetLastError();
}

template <int BB>
cudaError_t launch_bwd(const float* x, const float* w_g, const float* w_c,
                       const float* b, const int* lens, const float* y,
                       const float* dy, float* dx, float* rh_seq, float* part,
                       int B, int T, int h, cudaStream_t st) {
  const size_t smem = bwd_smem(h, BB);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel<BB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  gru_bwd_kernel<BB><<<rnn::cdiv(B, BB), NT, smem, st>>>(
      x, w_g, w_c, b, lens, y, dy, dx, rh_seq, part, B, T, h);
  return cudaGetLastError();
}

// scratch layout of gru_seq_bwd: [blocks, 3h] db partials | rh [B, T, h] |
// dW split-K partials (the larger of dW_g's and dW_c's; they run in turn)
long long dw_floats(int B, int T, int h) {
  const long long n = (long long)B * T;
  const long long g = rnn::dw_scratch_floats(n, h, 2 * h);
  const long long c = rnn::dw_scratch_floats(n, h, h);
  return g > c ? g : c;
}

}  // namespace

extern "C" int gru_seq_block_rows(int kind, int h) {
  return block_rows(kind, h);
}

extern "C" long long gru_seq_bwd_scratch_floats(int B, int T, int h) {
  const int bb = block_rows(1, h);
  if (bb == 0) return 0;
  return (long long)rnn::cdiv(B, bb) * 3 * h + (long long)B * T * h +
         dw_floats(B, T, h);
}

// B7. x [B, T, 3h], w_g [h, 2h], w_c [h, h], b [3h], lens [B] int32 ->
// y [B, T, h]. Launches on `stream` of `device`; returns the launch's
// cudaError_t (0 = launched).
extern "C" int gru_seq_fwd(const float* x, const float* w_g, const float* w_c,
                           const float* b, const int* lens, float* y, int B,
                           int T, int h, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (block_rows(0, h)) {
    case 8: return (int)launch_fwd<8>(x, w_g, w_c, b, lens, y, B, T, h, st);
    case 4: return (int)launch_fwd<4>(x, w_g, w_c, b, lens, y, B, T, h, st);
    case 2: return (int)launch_fwd<2>(x, w_g, w_c, b, lens, y, B, T, h, st);
    case 1: return (int)launch_fwd<1>(x, w_g, w_c, b, lens, y, B, T, h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// B8. Inputs as B7's plus y and dy [B, T, h]; writes dx [B, T, 3h],
// dw_g [h, 2h], dw_c [h, h] and db [3h].
extern "C" int gru_seq_bwd(const float* x, const float* w_g, const float* w_c,
                           const float* b, const int* lens, const float* y,
                           const float* dy, float* dx, float* dw_g,
                           float* dw_c, float* db, float* scratch, int B,
                           int T, int h, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int bb = block_rows(1, h);
  if (bb == 0) return (int)cudaErrorInvalidValue;
  const int blocks = rnn::cdiv(B, bb);
  float* part = scratch;
  float* rh_seq = part + (size_t)blocks * 3 * h;
  float* dw_part = rh_seq + (size_t)B * T * h;
  switch (bb) {
    case 8: err = launch_bwd<8>(x, w_g, w_c, b, lens, y, dy, dx, rh_seq, part, B, T, h, st); break;
    case 4: err = launch_bwd<4>(x, w_g, w_c, b, lens, y, dy, dx, rh_seq, part, B, T, h, st); break;
    case 2: err = launch_bwd<2>(x, w_g, w_c, b, lens, y, dy, dx, rh_seq, part, B, T, h, st); break;
    default: err = launch_bwd<1>(x, w_g, w_c, b, lens, y, dy, dx, rh_seq, part, B, T, h, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  err = rnn::block_sum(part, db, blocks, 3 * h, st);
  if (err != cudaSuccess) return (int)err;
  // dW_g = sum h_{t-1}^T dg_ur (h_{t-1} = y shifted by one);
  // dW_c = sum (r h_{t-1})^T dg_c
  err = rnn::weight_grad(y, h, T, dx, 3 * h, dw_g, dw_part, B * T, h, 2 * h,
                         st);
  if (err != cudaSuccess) return (int)err;
  return (int)rnn::weight_grad(rh_seq, h, 0, dx + 2 * h, 3 * h, dw_c,
                               dw_part, B * T, h, h, st);
}

extern "C" const char* gru_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
