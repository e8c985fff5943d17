// Peephole LSTM over a whole sequence with masked carry, and its backward,
// for Hopper (sm_90a), f32.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_rnn.py:
//   B5 _lstm_fwd_pallas (kernel _make_lstm_fwd_kernel): y, and c when training
//   B6 _lstm_bwd_pallas (kernel _lstm_bwd_kernel):      dx, dw, db7
// Contract (gate order [i, f, g, o], b7 = [gate bias 4h | wci | wcf | wco]):
//   g   = x_t + h_{t-1} @ w + gb
//   i   = sig(g_i + wci * c_{t-1}),  f = sig(g_f + wcf * c_{t-1}),  cand = tanh(g_g)
//   c_t = f * c_{t-1} + i * cand,    o = sig(g_o + wco * c_t),     out = o * tanh(c_t)
// At t >= len the state carries through and y = 0 (c carries too); a row of
// length 0 gives zeros and gradients of 0. x [B, T, 4h] is pre-projected.
//
// Design. The TPU kernel's grid is (batch blocks, time blocks) with the h/c
// carry in VMEM across the sequential time blocks. Here one block owns BB
// batch rows and walks the whole sequence itself: h_{t-1} (double-buffered)
// and c_{t-1} of its rows live in shared memory, and each step computes the
// rows' [BB, h] @ [h, 4h] product with w read from device memory (L2 holds it:
// 1 MB at h = 256, 26 MB at h = 1280). A thread owns hidden units j, j + 256,
// ...: it accumulates the four gate columns of unit j for all BB rows in
// registers, so the gate math needs no exchange, and one __syncthreads a step
// publishes the new h. No grid-wide sync, no atomics.
//
// The backward walks time in reverse, recomputing the gates from x and the
// saved y (h_{t-1} = y[t-1], zero at t = 0) and c. Per step: phase A (thread
// per unit) recomputes the cell, writes dx = dg (the input is pre-projected)
// and keeps dg [BB, 4h] in shared memory; phase B (a warp per unit k, lanes
// along the 4h columns of w's row k, so w is read coalesced) forms
// dh_{t-1} = dg @ w^T. dc stays in shared memory. Each block writes its
// partial db7 [7h]; then, in the same entry point, dW = sum_n h_{t-1}^T dg is
// a split-K GEMM over the B*T rows and both are summed in a fixed order.
//
// What bounds it on one H100 SXM: the recurrence is serial in t, and each
// step of a block reads all of w from L2 (per SM ~64 B/clock, ~10 us for the
// 1 MB of h = 256) for 2*BB*h*4h operations. The bound the smoke reports is
// the card-wide one (operations over 67 TFLOP/s, bytes over 3.35 TB/s), far
// below what a serial walk can reach; keeping w in shared memory across a
// grid-synchronised persistent kernel is later work.
#include <cuda_runtime.h>
#include <stddef.h>

#include "rnn_common.cuh"

using rnn::NT;
using rnn::NW;

namespace {

size_t fwd_smem(int h, int bb) { return (size_t)3 * h * bb * sizeof(float); }
size_t bwd_smem(int h, int bb) { return (size_t)7 * h * bb * sizeof(float); }

// The most batch rows a block of `kind` (0 forward, 1 backward) can hold in
// shared memory at width h: 8, 4, 2 or 1; 0 when not even one row fits.
int block_rows(int kind, int h) {
  for (int bb = 8; bb >= 1; bb /= 2)
    if ((kind == 0 ? fwd_smem(h, bb) : bwd_smem(h, bb)) <= rnn::SMEM_LIMIT)
      return bb;
  return 0;
}

// acc[r][q] = sum_k hp[k][r] * w[k][q * h + j] (hp transposed [h][BB])
template <int BB>
__device__ __forceinline__ void gate_product(const float* __restrict__ w,
                                             const float* hp, int h, int j,
                                             float (&acc)[BB][4]) {
#pragma unroll
  for (int r = 0; r < BB; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  const size_t h4 = 4 * (size_t)h;
  const float* wj = w + j;
#pragma unroll 4
  for (int k = 0; k < h; ++k) {
    const float* wk = wj + k * h4;
    const float w0 = wk[0], w1 = wk[h], w2 = wk[2 * h], w3 = wk[3 * h];
    float hv[BB];
    rnn::load_rows<BB>(hp + (size_t)k * BB, hv);
#pragma unroll
    for (int r = 0; r < BB; ++r) {
      acc[r][0] = fmaf(hv[r], w0, acc[r][0]);
      acc[r][1] = fmaf(hv[r], w1, acc[r][1]);
      acc[r][2] = fmaf(hv[r], w2, acc[r][2]);
      acc[r][3] = fmaf(hv[r], w3, acc[r][3]);
    }
  }
}

template <int BB>
__global__ void __launch_bounds__(NT)
lstm_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b7, const int* __restrict__ lens,
                float* __restrict__ y, float* __restrict__ c_out, int B, int T,
                int h) {
  extern __shared__ __align__(16) float smem[];
  float* hbuf = smem;                   // [2][h][BB] h_{t-1}, double-buffered
  float* cst = smem + 2 * h * BB;       // [h][BB] c_{t-1}, a unit's own thread
  const int row0 = blockIdx.x * BB;
  const size_t h4 = 4 * (size_t)h;
  int len[BB];
#pragma unroll
  for (int r = 0; r < BB; ++r) len[r] = row0 + r < B ? lens[row0 + r] : 0;
  for (int i = threadIdx.x; i < 3 * h * BB; i += NT) smem[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hp = hbuf + (t & 1) * h * BB;
    float* hn = hbuf + ((t + 1) & 1) * h * BB;
    for (int j = threadIdx.x; j < h; j += NT) {
      float acc[BB][4];
      gate_product<BB>(w, hp, h, j, acc);
      const float gbi = b7[j], gbf = b7[h + j], gbg = b7[2 * h + j],
                  gbo = b7[3 * h + j];
      const float wci = b7[4 * h + j], wcf = b7[5 * h + j],
                  wco = b7[6 * h + j];
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const int row = row0 + r;
        const float cp = cst[j * BB + r];
        const float hpv = hp[j * BB + r];
        const size_t o = ((size_t)row * T + t) * h + j;
        if (t < len[r]) {
          const float* xr = x + ((size_t)row * T + t) * h4;
          const float ig = rnn::sigm((xr[j] + acc[r][0]) + gbi + wci * cp);
          const float fg =
              rnn::sigm((xr[h + j] + acc[r][1]) + gbf + wcf * cp);
          const float cand = tanhf((xr[2 * h + j] + acc[r][2]) + gbg);
          const float c = fg * cp + ig * cand;
          const float og =
              rnn::sigm((xr[3 * h + j] + acc[r][3]) + gbo + wco * c);
          const float out = og * tanhf(c);
          hn[j * BB + r] = out;
          cst[j * BB + r] = c;
          y[o] = out;
          if (c_out != nullptr) c_out[o] = c;
        } else {
          hn[j * BB + r] = hpv;
          if (row < B) {
            y[o] = 0.f;
            if (c_out != nullptr) c_out[o] = cp;
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int BB>
__global__ void __launch_bounds__(NT)
lstm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b7, const int* __restrict__ lens,
                const float* __restrict__ y, const float* __restrict__ c_seq,
                const float* __restrict__ dy, float* __restrict__ dx,
                float* __restrict__ part_db, int B, int T, int h) {
  extern __shared__ __align__(16) float smem[];
  float* hp = smem;                     // [h][BB] h_{t-1} = y[t-1]
  float* dg = hp + h * BB;              // [BB][4h] this step's gate grads
  float* dh = dg + 4 * h * BB;          // [BB][h] dL/dh_t carried back
  float* dc = dh + h * BB;              // [BB][h] dL/dc_t, a unit's own thread
  const int row0 = blockIdx.x * BB;
  const int h4 = 4 * h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* part = part_db + (size_t)blockIdx.x * 7 * h;
  int len[BB];
#pragma unroll
  for (int r = 0; r < BB; ++r) len[r] = row0 + r < B ? lens[row0 + r] : 0;
  for (int i = threadIdx.x; i < 6 * h * BB; i += NT) dg[i] = 0.f;
  for (int i = threadIdx.x; i < 7 * h; i += NT) part[i] = 0.f;
  // h_{t-1} of step t into hp: y[t-1] by rows (coalesced), 0 at t = 0
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
    // phase A: recompute the cell of unit j, backward through the step
    for (int j = threadIdx.x; j < h; j += NT) {
      float acc[BB][4];
      gate_product<BB>(w, hp, h, j, acc);
      const float gbi = b7[j], gbf = b7[h + j], gbg = b7[2 * h + j],
                  gbo = b7[3 * h + j];
      const float wci = b7[4 * h + j], wcf = b7[5 * h + j],
                  wco = b7[6 * h + j];
      float s[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        const int row = row0 + r;
        const size_t base = (size_t)row * T + t;
        float* dgr = dg + (size_t)r * h4;
        if (t < len[r]) {
          const float cp = t > 0 ? c_seq[(base - 1) * h + j] : 0.f;
          const float* xr = x + base * h4;
          const float ig = rnn::sigm((xr[j] + acc[r][0]) + gbi + wci * cp);
          const float fg =
              rnn::sigm((xr[h + j] + acc[r][1]) + gbf + wcf * cp);
          const float cand = tanhf((xr[2 * h + j] + acc[r][2]) + gbg);
          const float ct = fg * cp + ig * cand;
          const float og =
              rnn::sigm((xr[3 * h + j] + acc[r][3]) + gbo + wco * ct);
          const float tc = tanhf(ct);
          const float dout = dh[r * h + j] + dy[base * h + j];
          const float dgo = dout * tc * og * (1.f - og);
          const float dct =
              dc[r * h + j] + dout * og * (1.f - tc * tc) + dgo * wco;
          const float dgi = dct * cand * ig * (1.f - ig);
          const float dgf = dct * cp * fg * (1.f - fg);
          const float dgg = dct * ig * (1.f - cand * cand);
          float* dxr = dx + base * h4;
          dxr[j] = dgi;
          dxr[h + j] = dgf;
          dxr[2 * h + j] = dgg;
          dxr[3 * h + j] = dgo;
          dgr[j] = dgi;
          dgr[h + j] = dgf;
          dgr[2 * h + j] = dgg;
          dgr[3 * h + j] = dgo;
          dc[r * h + j] = dct * fg + dgi * wci + dgf * wcf;
          s[0] += dgi;
          s[1] += dgf;
          s[2] += dgg;
          s[3] += dgo;
          s[4] += dgi * cp;
          s[5] += dgf * cp;
          s[6] += dgo * ct;
        } else {
          // masked step: dg = 0, dh and dc carry through
          dgr[j] = dgr[h + j] = dgr[2 * h + j] = dgr[3 * h + j] = 0.f;
          if (row < B) {
            float* dxr = dx + base * h4;
            dxr[j] = dxr[h + j] = dxr[2 * h + j] = dxr[3 * h + j] = 0.f;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 7; ++q) part[q * h + j] += s[q];
    }
    __syncthreads();
    // phase B: dh_{t-1}[r][k] = sum_c dg[r][c] * w[k][c] (+ dh_t where masked)
    for (int k = warp; k < h; k += NW) {
      float a[BB];
#pragma unroll
      for (int r = 0; r < BB; ++r) a[r] = 0.f;
      const float* wk = w + (size_t)k * h4;
      for (int c = lane; c < h4; c += 32) {
        const float wv = wk[c];
#pragma unroll
        for (int r = 0; r < BB; ++r) a[r] = fmaf(dg[r * h4 + c], wv, a[r]);
      }
#pragma unroll
      for (int r = 0; r < BB; ++r) a[r] = rnn::warp_sum(a[r]);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < BB; ++r)
          dh[r * h + k] = t < len[r] ? a[r] : dh[r * h + k] + a[r];
      }
    }
    if (t > 0) load_hp(t - 1);
    __syncthreads();
  }
}

template <int BB>
cudaError_t launch_fwd(const float* x, const float* w, const float* b7,
                       const int* lens, float* y, float* c, int B, int T,
                       int h, cudaStream_t st) {
  const size_t smem = fwd_smem(h, BB);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel<BB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  lstm_fwd_kernel<BB><<<rnn::cdiv(B, BB), NT, smem, st>>>(x, w, b7, lens, y,
                                                          c, B, T, h);
  return cudaGetLastError();
}

template <int BB>
cudaError_t launch_bwd(const float* x, const float* w, const float* b7,
                       const int* lens, const float* y, const float* c,
                       const float* dy, float* dx, float* part, int B, int T,
                       int h, cudaStream_t st) {
  const size_t smem = bwd_smem(h, BB);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_kernel<BB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  lstm_bwd_kernel<BB><<<rnn::cdiv(B, BB), NT, smem, st>>>(
      x, w, b7, lens, y, c, dy, dx, part, B, T, h);
  return cudaGetLastError();
}

}  // namespace

// Batch rows a block takes (kind 0 forward, 1 backward) at width h; 0 means
// the kernel does not take this h.
extern "C" int lstm_seq_block_rows(int kind, int h) {
  return block_rows(kind, h);
}

// Floats of scratch lstm_seq_bwd needs: the blocks' db7 partials, then the
// split-K partials of dw.
extern "C" long long lstm_seq_bwd_scratch_floats(int B, int T, int h) {
  const int bb = block_rows(1, h);
  if (bb == 0) return 0;
  return (long long)rnn::cdiv(B, bb) * 7 * h +
         rnn::dw_scratch_floats((long long)B * T, h, 4 * h);
}

// B5. x [B, T, 4h], w [h, 4h], b7 [7h], lens [B] int32 -> y [B, T, h] and,
// when c is not null, the carried cell sequence c [B, T, h]. Launches on
// `stream` of `device`; returns the launch's cudaError_t (0 = launched).
extern "C" int lstm_seq_fwd(const float* x, const float* w, const float* b7,
                            const int* lens, float* y, float* c, int B, int T,
                            int h, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (block_rows(0, h)) {
    case 8: return (int)launch_fwd<8>(x, w, b7, lens, y, c, B, T, h, st);
    case 4: return (int)launch_fwd<4>(x, w, b7, lens, y, c, B, T, h, st);
    case 2: return (int)launch_fwd<2>(x, w, b7, lens, y, c, B, T, h, st);
    case 1: return (int)launch_fwd<1>(x, w, b7, lens, y, c, B, T, h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// B6. Inputs as B5's plus y, c and dy [B, T, h]; writes dx [B, T, 4h],
// dw [h, 4h] and db7 [7h].
extern "C" int lstm_seq_bwd(const float* x, const float* w, const float* b7,
                            const int* lens, const float* y, const float* c,
                            const float* dy, float* dx, float* dw, float* db7,
                            float* scratch, int B, int T, int h, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int bb = block_rows(1, h);
  float* part = scratch;
  switch (bb) {
    case 8: err = launch_bwd<8>(x, w, b7, lens, y, c, dy, dx, part, B, T, h, st); break;
    case 4: err = launch_bwd<4>(x, w, b7, lens, y, c, dy, dx, part, B, T, h, st); break;
    case 2: err = launch_bwd<2>(x, w, b7, lens, y, c, dy, dx, part, B, T, h, st); break;
    case 1: err = launch_bwd<1>(x, w, b7, lens, y, c, dy, dx, part, B, T, h, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int blocks = rnn::cdiv(B, bb);
  err = rnn::block_sum(part, db7, blocks, 7 * h, st);
  if (err != cudaSuccess) return (int)err;
  // dW = sum over the B*T rows of h_{t-1}^T dg, h_{t-1} = y shifted by one
  float* dw_part = scratch + (size_t)blocks * 7 * h;
  return (int)rnn::weight_grad(y, h, T, dx, 4 * h, dw, dw_part, B * T, h,
                               4 * h, st);
}

extern "C" const char* lstm_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
