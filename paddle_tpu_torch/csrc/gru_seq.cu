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
// B7, and B8's walk route (h past the cluster route's reach), as
// lstm_seq.cu's: one block owns BB batch rows and walks the whole sequence,
// h_{t-1} in shared memory, w_g and w_c read from device memory (L2) every
// step, a thread per hidden unit for the pointwise math. The forward has two
// products a step, the second on r * h_{t-1}, so two __syncthreads: one
// publishes r * h_{t-1}, the other the new h. The walk backward recomputes
// u, r and c in the walk (phases 1-2), then forms d(r h) = dg_c @ w_c^T and
// dg_r (phase 3) and dh_{t-1} += dg_ur @ w_g^T (phase 4), reading w_g and
// w_c from L2 twice a step.
//
// B8's cluster route (every h whose weight slices fit a block's shared
// memory: h <= 320), as lstm_seq.cu's:
// 1. Hoisted onto the tensor cores (rnn_common.cuh tc_kernel, 3xTF32) before
//    the walk: dx[:, :, :2h] = (x + b) + h_{t-1} @ w_g over all B*T rows,
//    whose epilogue also writes rh = sig(pre_r) * h_{t-1} (0 on a masked
//    step) into the rh_seq scratch that dW_c reads; then dx[:, :, 2h:] =
//    (x_c + b_c) + rh @ w_c. The walk overwrites each pre-activation with
//    its gate gradient (0 on a masked step).
// 2. The walk: a cluster of CL = 8 blocks of 512 threads owns R batch rows
//    (B = 256 takes 18 on an H100 SXM's 15 clusters); block s owns the
//    units J_s and keeps w_g's u and r columns and w_c's columns of them in
//    shared memory (h x 3U floats, 100 KB at h = 256). A step: the cell
//    backward of the own units (dg_u, dg_c); P_s = dg_c[:, own] @
//    w_c[:, own]^T on the tensor cores (rnn::slice_product); a cluster
//    barrier (dg_c's and dg_u's stores between its arrive and its wait);
//    d(r h) summed in rank order from the peers' P, then dg_r and the
//    r-term of dh; P'_s = dg_ur[:, own] @ w_g[:, own]^T; a second barrier
//    (dg_r's stores); dh_{t-1} summed in rank order. The two barriers
//    alternate, so one buffer each for P and P' is safe.
// 3. dW_g = sum h_{t-1}^T dg_ur and dW_c = sum rh^T dg_c on the tensor
//    cores (split over the rows, fixed-order sums), db from the clusters'
//    partials: bit-identical run to run.
// What bounds it on one H100 SXM: the serial chain of T steps, each two
// products, two cluster barriers and two exchanges, not the card-wide
// bound the smoke reports. -DRNN_SERIAL_FLOOR keeps only the barriers and
// exchanges (rnn_bwd_probe.py).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "rnn_common.cuh"

namespace cg = cooperative_groups;
using rnn::CL;
using rnn::NT;
using rnn::NW;

#ifdef RNN_SERIAL_FLOOR
constexpr bool kSerialFloor = true;   // the walk without cells or products
#else
constexpr bool kSerialFloor = false;
#endif

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
  __syncthreads();  // the zeros land before load_hp writes h_{t-1}
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

// The cluster walk's shared memory, in floats from the base, at width h and
// R rows a cluster
struct WalkSmem {
  int U, gst, cst, ds, wc, dgc, dgur, pa, pb, st, dh, dho, db, len, total;
  __host__ __device__ WalkSmem(int h, int R) {
    U = (h + CL - 1) / CL;
    const int h16 = (h + 15) & ~15;
    gst = rnn::slice_stride(2 * U);
    cst = rnn::slice_stride(U);
    ds = rnn::grad_stride(R);
    wc = h16 * gst;                       // after wg [h16][gst]: [h16][cst]
    dgc = wc + h16 * cst;                 // [slice_cols(U)][ds] the dg_c
    dgur = dgc + rnn::slice_cols(U) * ds;     // [slice_cols(2U)][ds] dg_ur
    pa = dgur + rnn::slice_cols(2 * U) * ds;  // [R][h] partials of d(r h)
    pb = pa + R * h;                      // [R][h] partials of dh
    st = pb + R * h;                      // [2][5][R U] staged inputs
    dh = st + 10 * R * U;                 // [R U] dL/dh_t of the own units
    dho = dh + R * U;                     // [R U] dh_{t-1}'s own terms
    db = dho + R * U;                     // [3][R U] db partials
    len = db + 3 * R * U;                 // [R] int lengths
    total = len + R;
  }
};

size_t walk_smem(int h, int R) {
  return (size_t)WalkSmem(h, R).total * sizeof(float);
}

// B8's cluster route (see the head of this file). dx holds the hoisted
// pre-activations on entry and the gate gradients on exit; part_db
// [clusters][3h].
template <int R>
__global__ void __launch_bounds__(rnn::NTC, 1)
gru_bwd_cluster_kernel(const float* __restrict__ w_g,
                       const float* __restrict__ w_c,
                       const int* __restrict__ lens,
                       const float* __restrict__ y,
                       const float* __restrict__ dy, float* __restrict__ dx,
                       float* __restrict__ part_db, int B, int T, int h) {
  constexpr int NTC = rnn::NTC;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const WalkSmem L(h, R);
  const int U = L.U, gst = L.gst, cst = L.cst, ds = L.ds, RU = R * U;
  const int h3 = 3 * h;
  const int s = (int)cluster.block_rank();
  const int cid = blockIdx.x / CL, row0 = cid * R;
  const int j0 = s * U, nu = max(0, min(U, h - j0));
  // w_g[k][j0 + u] and w_g[k][h + j0 + u] at wg[k][u] and wg[k][U + u];
  // w_c[k][j0 + u] at wc[k][u]
  float* wg = smem;
  float* wc = smem + L.wc;
  float* dgcs = smem + L.dgc;
  float* dgurs = smem + L.dgur;
  float* pa = smem + L.pa;
  float* pbb = smem + L.pb;
  float* stg = smem + L.st;
  float* dhs = smem + L.dh;
  float* dho = smem + L.dho;
  float* dbs = smem + L.db;
  int* slen = reinterpret_cast<int*>(smem + L.len);

  int maxlen = 0;
#pragma unroll
  for (int r = 0; r < R; ++r)
    maxlen = max(maxlen, row0 + r < B ? lens[row0 + r] : 0);
  // the slices and the gradients, zero past their widths
  for (int i = threadIdx.x; i < L.pa; i += NTC) smem[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < h * 2 * U; i += NTC) {
    const int k = i / (2 * U), c = i % (2 * U), q = c / U, u = c % U;
    if (u < nu) wg[k * gst + c] = w_g[(size_t)k * 2 * h + q * h + j0 + u];
  }
  for (int i = threadIdx.x; i < h * U; i += NTC) {
    const int k = i / U, u = i % U;
    if (u < nu) wc[k * cst + u] = w_c[(size_t)k * h + j0 + u];
  }
  for (int i = threadIdx.x; i < 5 * RU; i += NTC) dhs[i] = 0.f;  // dh dho db
  for (int r = threadIdx.x; r < R; r += NTC)
    slen[r] = row0 + r < B ? lens[row0 + r] : 0;
  // the inputs of step t into slot t & 1: [5][R U] the pre-activations u, r,
  // c, h_{t-1} and dy, of the live (row, unit) pairs
  auto stage = [&](int t) {
    float* sg = stg + (t & 1) * 5 * RU;
    for (int e = threadIdx.x; e < 5 * RU && !kSerialFloor; e += NTC) {
      const int f = e / RU, pr = e % RU, r = pr / U, u = pr % U;
      const int row = row0 + r;
      const float* src = nullptr;
      if (u < nu && row < B && t < lens[row]) {
        const size_t base = (size_t)row * T + t;
        if (f < 3)
          src = dx + base * h3 + f * h + j0 + u;
        else if (f == 4)
          src = dy + base * h + j0 + u;
        else if (t > 0)
          src = y + (base - 1) * h + j0 + u;
      }
      cp_async4(sg + e, src != nullptr ? src : dy, src != nullptr ? 4 : 0);
    }
  };
  // dx's columns [g0, g1) of step t (gate 0 u, 1 r, 2 c; 0 on a masked
  // step) from the shared gradients, coalesced along the units
  auto store_dx = [&](int t, int g0, int g1) {
    for (int e = g0 * RU + threadIdx.x; e < g1 * RU && !kSerialFloor;
         e += NTC) {
      const int q = e / RU, pr = e % RU, r = pr / U, u = pr % U;
      const int row = row0 + r;
      if (u < nu && row < B)
        dx[((size_t)row * T + t) * h3 + q * h + j0 + u] =
            q < 2 ? dgurs[(q * U + u) * ds + r] : dgcs[u * ds + r];
    }
  };
  cluster.sync();  // every block runs and is set before any peer read
  stage(T - 1);
  cp_async_commit();

  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) stage(t - 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // step t's inputs have landed
    const float* sg = stg + (t & 1) * 5 * RU;
    const bool any = kSerialFloor || t < maxlen;
    // the cell backward of the own units: dg_u, dg_c, dh's u-term
    for (int pr = threadIdx.x; pr < RU && !kSerialFloor; pr += NTC) {
      const int r = pr / U, u = pr % U, row = row0 + r;
      if (u >= nu || row >= B) continue;
      if (t >= slen[r]) {  // masked step: dg = 0, dh carries through
        dgcs[u * ds + r] = dgurs[u * ds + r] = dgurs[(U + u) * ds + r] = 0.f;
        continue;
      }
      const float ug = rnn::sigm(sg[pr]);
      const float c = tanhf(sg[2 * RU + pr]);
      const float hpv = sg[3 * RU + pr];
      const float dout = dhs[pr] + sg[4 * RU + pr];
      const float dgc_v = dout * (1.f - ug) * (1.f - c * c);
      const float dgu_v = dout * (hpv - c) * ug * (1.f - ug);
      dgcs[u * ds + r] = dgc_v;
      dgurs[u * ds + r] = dgu_v;
      dho[pr] = dout * ug;
      dbs[pr] += dgu_v;
      dbs[2 * RU + pr] += dgc_v;
    }
    __syncthreads();  // dg_c and dg_u complete
    if (!any) {       // every row past its length: dx = 0, dh carries
      store_dx(t, 0, 3);
      continue;
    }
    // P_s[r][k] = sum over the own units c of dg_c[r][c] * w_c[k][c]
    if (!kSerialFloor) rnn::slice_product<R>(wc, cst, dgcs, ds, U, pa, h);
    rnn::cluster_arrive();
    store_dx(t, 2, 3);  // dg_c; dg_u below
    store_dx(t, 0, 1);
    rnn::cluster_wait();
    // d(r h) of the own units in rank order, then dg_r and dh's r-term
    for (int pr = threadIdx.x; pr < RU; pr += NTC) {
      const int r = pr / U, u = pr % U, row = row0 + r;
      if (u >= nu || row >= B || t >= slen[r]) continue;
      const int off = r * h + j0 + u;
      float drh = 0.f;
#pragma unroll
      for (int rk = 0; rk < CL; ++rk)
        drh += cluster.map_shared_rank(pa, rk)[off];
      if (kSerialFloor) continue;
      const float rg = rnn::sigm(sg[RU + pr]);
      const float dgr = drh * sg[3 * RU + pr] * rg * (1.f - rg);
      dgurs[(U + u) * ds + r] = dgr;
      dho[pr] += drh * rg;
      dbs[RU + pr] += dgr;
    }
    __syncthreads();  // dg_ur complete
    // P'_s[r][k] = sum over the own columns c of dg_ur[r][c] * w_g[k][c]
    if (!kSerialFloor)
      rnn::slice_product<R>(wg, gst, dgurs, ds, 2 * U, pbb, h);
    rnn::cluster_arrive();
    store_dx(t, 1, 2);  // dg_r
    rnn::cluster_wait();
    // dh_{t-1} of the own units: the own terms, then the peers' P' in order
    for (int pr = threadIdx.x; pr < RU; pr += NTC) {
      const int r = pr / U, u = pr % U;
      if (u >= nu || row0 + r >= B || t >= slen[r]) continue;
      const int off = r * h + j0 + u;
      float sum = 0.f;
#pragma unroll
      for (int rk = 0; rk < CL; ++rk)
        sum += cluster.map_shared_rank(pbb, rk)[off];
      dhs[pr] = dho[pr] + sum;
    }
  }
  cp_async_wait<0>();
  cluster.sync();  // no block leaves while a peer may read its P or P'
  for (int i = threadIdx.x; i < 3 * nu; i += NTC) {
    const int q = i / nu, u = i % nu;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) sum += dbs[q * RU + r * U + u];
    part_db[(size_t)cid * 3 * h + q * h + j0 + u] = sum;
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

// scratch layout of gru_seq_bwd: [B, 3h] db partials (of at most B blocks
// or clusters) | rh [B, T, h] |
// dW split-K partials (the larger of dW_g's and dW_c's; they run in turn)
long long dw_floats(int B, int T, int h) {
  const long long n = (long long)B * T;
  const long long g = rnn::dw_scratch_floats(n, h, 2 * h);
  const long long c = rnn::dw_scratch_floats(n, h, h);
  return g > c ? g : c;
}

// The clusters of R rows the card holds at once (negative: -cudaError_t)
int active_clusters(int R, int h, int device) {
  return rnn::with_rows(R, [&](auto rows) {
    return rnn::max_active_clusters(
        gru_bwd_cluster_kernel<decltype(rows)::value>, walk_smem(h, R),
        device);
  });
}

// B8's route at (B, h): `request` -1 takes the rule (the cluster route
// wherever its shared memory holds h, else the walk), 0 the walk, 1 the
// cluster route. Returns a cudaError_t; route -1 when no route takes h.
int bwd_plan(int B, int h, int device, int request, rnn::BwdPlan* p) {
  *p = {-1, 0, 0, 0};
  if (request != 0) {
    const int R = rnn::cluster_rows(
        B, [&](int r) { return walk_smem(h, r); },
        [&](int r) { return active_clusters(r, h, device); });
    if (R < 0) return -R;
    if (R > 0) {
      *p = {1, R, rnn::cdiv(B, R), active_clusters(R, h, device)};
      return 0;
    }
    if (request == 1) return (int)cudaErrorInvalidValue;
  }
  const int bb = block_rows(1, h);
  if (bb > 0) *p = {0, bb, rnn::cdiv(B, bb), 0};
  return 0;
}

cudaError_t launch_cluster_bwd(int R, int clusters, const float* w_g,
                               const float* w_c, const int* lens,
                               const float* y, const float* dy, float* dx,
                               float* part, int B, int T, int h,
                               cudaStream_t st) {
  return rnn::with_rows(R, [&](auto rows) {
    return rnn::launch_clusters(
        gru_bwd_cluster_kernel<decltype(rows)::value>, clusters,
        walk_smem(h, R), st, w_g, w_c, lens, y, dy, dx, part, B, T, h);
  });
}

}  // namespace

extern "C" int gru_seq_block_rows(int kind, int h) {
  return block_rows(kind, h);
}

// B8's route at (B, h) on `device` (see bwd_plan): out = {route (1
// cluster, 0 walk, -1 none), rows a cluster or block, clusters or blocks,
// the clusters the card holds at once}. Returns a cudaError_t.
extern "C" int gru_seq_bwd_plan(int B, int h, int device, int request,
                                int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  rnn::BwdPlan p;
  const int rc = bwd_plan(B, h, device, request, &p);
  out[0] = p.route;
  out[1] = p.rows;
  out[2] = p.blocks;
  out[3] = p.active;
  return rc;
}

extern "C" long long gru_seq_bwd_scratch_floats(int B, int T, int h) {
  return (long long)B * 3 * h + (long long)B * T * h + dw_floats(B, T, h);
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
// dw_g [h, 2h], dw_c [h, h] and db [3h], on the route `route` asks for
// (see bwd_plan).
extern "C" int gru_seq_bwd(const float* x, const float* w_g, const float* w_c,
                           const float* b, const int* lens, const float* y,
                           const float* dy, float* dx, float* dw_g,
                           float* dw_c, float* db, float* scratch, int B,
                           int T, int h, int route, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  rnn::BwdPlan plan;
  const int rc = bwd_plan(B, h, device, route, &plan);
  if (rc != 0) return rc;
  float* part = scratch;
  float* rh_seq = part + (size_t)B * 3 * h;
  float* dw_part = rh_seq + (size_t)B * T * h;
  const int h3 = 3 * h;
  if (plan.route == 1) {
    // u, r: (x + b) + h_{t-1} @ w_g, and rh = r * h_{t-1}; then c:
    // (x_c + b_c) + rh @ w_c, all into dx
    err = rnn::pre_gemm<rnn::EPI_PRE_RH>(y, h, T, w_g, 2 * h, x, h3, b, dx,
                                         h3, B * T, 2 * h, h, rh_seq, lens,
                                         h, st);
    if (err != cudaSuccess) return (int)err;
    err = rnn::pre_gemm<rnn::EPI_PRE>(rh_seq, h, 0, w_c, h, x + 2 * h, h3,
                                      b + 2 * h, dx + 2 * h, h3, B * T, h, h,
                                      nullptr, nullptr, h, st);
    if (err != cudaSuccess) return (int)err;
    err = launch_cluster_bwd(plan.rows, plan.blocks, w_g, w_c, lens, y, dy,
                             dx, part, B, T, h, st);
  } else {
    switch (plan.rows) {
      case 8: err = launch_bwd<8>(x, w_g, w_c, b, lens, y, dy, dx, rh_seq, part, B, T, h, st); break;
      case 4: err = launch_bwd<4>(x, w_g, w_c, b, lens, y, dy, dx, rh_seq, part, B, T, h, st); break;
      case 2: err = launch_bwd<2>(x, w_g, w_c, b, lens, y, dy, dx, rh_seq, part, B, T, h, st); break;
      case 1: err = launch_bwd<1>(x, w_g, w_c, b, lens, y, dy, dx, rh_seq, part, B, T, h, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return (int)err;
  err = rnn::block_sum(part, db, plan.blocks, h3, st);
  if (err != cudaSuccess) return (int)err;
  // dW_g = sum h_{t-1}^T dg_ur (h_{t-1} = y shifted by one);
  // dW_c = sum (r h_{t-1})^T dg_c
  err = rnn::weight_grad(y, h, T, dx, h3, dw_g, dw_part, B * T, h, 2 * h,
                         st);
  if (err != cudaSuccess) return (int)err;
  return (int)rnn::weight_grad(rh_seq, h, 0, dx + 2 * h, h3, dw_c, dw_part,
                               B * T, h, h, st);
}

extern "C" const char* gru_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
