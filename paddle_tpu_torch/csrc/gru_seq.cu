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
// Each kernel takes the cluster route wherever a block's shared memory holds
// its slices of the weights (B7: h <= 352, B8: h <= 320), else the grid
// route; there is no other route.
//
// The grid route of B7 and B8, as lstm_seq.cu's grid route of B5 and B6:
// one persistent block an SM (cooperative launch, G = ceil(h / U) blocks,
// U = ceil(h / SMs): 125 blocks of 8 units at h = 1000, 128 of 10 at
// h = 1280 on an H100 SXM's 132 SMs) owns the hidden units J_s = [s U,
// s U + U) and every batch row; the blocks meet at grid barriers
// (rnn::grid_sync) and exchange through L2 (stores, then .cg loads).
// B7: block s keeps in shared memory the columns of w_g (u and r) and of
// w_c of its units, transposed ([3U][h], 154 KB at h = 1280; wider slices
// are read from L2 each step: the streamed form). A step has two serial
// products, so two barriers:
// 1. G_ur = h_{t-1} [B, h] @ w_g[:, own u, r] [h, 2U] on the tensor cores
//    (rnn::grid_product: 3xTF32 mma.sync, the batch rows as m, h_{t-1}
//    read from L2 GPF k-groups ahead, the depth split in shares where the
//    jobs are fewer than the warps, added in order) onto x_t + b (x staged
//    by cp.async during the previous barrier, b added before the product:
//    B7's order (x + b) + product); u, r and r * h_{t-1} of the own (row,
//    unit) pairs; r * h_{t-1} of the own units into the global exchange rh
//    [B][h]; barrier 1.
// 2. C = (r h_{t-1}) [B, h] (from L2) @ w_c[:, own] [h, U] onto x_t + b;
//    c and h_t of the own pairs; h_t of the own units into the global h
//    [B][h] and y; barrier 2.
// One buffer each for h and rh is enough, because the two barriers
// alternate: a block writes rh in step t + 1 only after barrier 2 of step
// t, at which every block has finished its c product of step t (rh's last
// read); it writes h in step t after barrier 1 of step t, at which every
// block has finished its u/r product of step t (h_{t-1}'s last read; the
// own units' h_{t-1} a block reads from its own shared copy). Once every
// row is past its length, the remaining steps store y = 0 with no product
// and no barrier.
// B8: the gate recompute is hoisted as on the cluster route (below), dW_g,
// dW_c and db follow the walk; only the dh recurrence stays serial. Block s
// keeps w_c's and w_g's rows of its units ([U][h] and [U][2h], 154 KB at
// h = 1280). A step:
// 1. the cell backward of the own pairs (a thread loads the inputs of
//    CELL_PAIRS pairs at once: the hoisted pre-activations in dx, h_{t-1}
//    = y[t-1], dy): dg_c and dg_u into dx and into the global exchange,
//    dh's u-term kept; barrier 1;
// 2. d(r h)[:, own] = dg_c [B, h] (from L2) @ w_c[own, :]^T, then dg_r of
//    the own units into dx and into the exchange, dh's r-term; barrier 2;
// 3. dh_{t-1}[:, own] = the own terms + dg_ur [B, 2h] (from L2) @
//    w_g[own, :]^T (a masked row's dh carries).
// dg_c needs one buffer: it is written in step t - 1 after barrier 2 of
// step t, at which every block has read it (step 2). dg_ur is read after
// barrier 2 (step 3) with no barrier before the next step's dg_u stores,
// so it alternates between two buffers by the step's parity: a block
// writes buffer t & 1 again in step t - 2, after barrier 1 of step t - 1,
// at which every block has finished step 3 of step t. Steps past every
// row's length: dx = 0, written by each block for its own units, without
// barriers. Every sum runs in a fixed order: a repeat is bit-identical.
// What bounds the grid route: the serial chain of T steps, each two (B7)
// or three (B8) products whose A operand every block reads whole from L2
// (B h floats, or 2 B h, per block and product: 1.3 MB at h = 1280, B =
// 256), and two grid barriers; -DRNN_SERIAL_FLOOR keeps only the exchanges
// and the barriers (rnn_fwd_probe.py, rnn_bwd_probe.py measure that floor).
//
// B8's cluster route (every h whose weight slices fit a block's shared
// memory: h <= 320), as lstm_seq.cu's:
// 1. Hoisted onto the tensor cores (rnn_common.cuh tc_kernel, 3xTF32) before
//    the walk: dx[:, :, :2h] = (x + b) + h_{t-1} @ w_g over all B*T rows,
//    whose epilogue also writes rh = sig(pre_r) * h_{t-1} (0 on a masked
//    step) into the rh_seq scratch that dW_c reads; then dx[:, :, 2h:] =
//    (x_c + b_c) + rh @ w_c. The walk overwrites each pre-activation with
//    its gate gradient (0 on a masked step). The grid route hoists the
//    same products.
// 2. The walk: a cluster of CL = 8 blocks of 512 threads owns R batch rows
//    (B = 256 takes 18 on an H100 SXM's 15 clusters); block s owns the
//    units J_s and keeps w_g's u and r columns and w_c's columns of them in
//    shared memory (h x 3U floats, 100 KB at h = 256). A step: the cell
//    backward of the own units (dg_u, dg_c); P_s = dg_c[:, own] @
//    w_c[:, own]^T on the tensor cores (rnn::tile_product); a cluster
//    barrier (dg_c's and dg_u's stores between its arrive and its wait);
//    d(r h) summed in rank order from the peers' P, then dg_r and the
//    r-term of dh; P'_s = dg_ur[:, own] @ w_g[:, own]^T; a second barrier
//    (dg_r's stores); dh_{t-1} summed in rank order. The two barriers
//    alternate, so one buffer each for P and P' is safe.
// 3. dW_g = sum h_{t-1}^T dg_ur and dW_c = sum rh^T dg_c on the tensor
//    cores (split over the rows, fixed-order sums), db from the clusters'
//    partials (the grid route's: from dx's row chunks, in order):
//    bit-identical run to run.
// What bounds it on one H100 SXM: the serial chain of T steps, each two
// products, two cluster barriers and two exchanges, not the card-wide
// bound the smoke reports. -DRNN_SERIAL_FLOOR keeps only the barriers and
// exchanges (rnn_bwd_probe.py).
//
// B7's cluster route (every h whose slices of w_g and w_c and buffers fit a
// block's shared memory), as lstm_seq.cu's B5: a cluster of CL = 8 blocks
// owns R batch rows, block s the units J_s and, transposed, w_g's u and r
// columns and w_c's columns of them ([3U][h], 98 KB at h = 256). A step
// has two products and two exchanges, each product local to the block
// (3xTF32 mma.sync, rnn::tile_product, the depth h in shares where the
// columns make few tiles, the shares added in order):
// 1. the u and r pre-activations h_{t-1} @ w_g[:, own], then u, r and
//    r * h_{t-1} of the own (row, unit) pairs in B7's order ((x + b) +
//    product); r * h_{t-1} of the own units pushed into every peer's rh
//    buffer (rnn::push_to_peers); cluster barrier 1;
// 2. the c pre-activation (r h_{t-1}) @ w_c[:, own], then c and h_t, h_t
//    pushed into every peer's h buffer; barrier 2's arrive, y's stores,
//    its wait.
// One buffer each for h and rh is enough, for the grid route's reason
// above (the pushes take the place of the stores). Once every row of a
// cluster is past its length, the remaining steps store y = 0 with no
// product and no barrier.
// What bounds it: the serial chain of T steps of two products, two cells,
// two pushes and two cluster barriers; -DRNN_SERIAL_FLOOR keeps only the
// pushes and the barriers (rnn_fwd_probe.py).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "rnn_common.cuh"

namespace cg = cooperative_groups;
using rnn::CL;

#ifdef RNN_SERIAL_FLOOR
constexpr bool kSerialFloor = true;   // the walk without cells or products
#else
constexpr bool kSerialFloor = false;
#endif

namespace {

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
    if (!kSerialFloor)
      rnn::tile_product<R>(wc, cst, dgcs, ds, rnn::slice_cols(U), h, pa, h, 1);
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
      rnn::tile_product<R>(wg, gst, dgurs, ds, rnn::slice_cols(2 * U), h, pbb,
                           h, 1);
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

// B7's cluster walk's shared memory, in floats from the base, at width h
// and R rows a cluster
struct FwdSmem {
  int U, K, wst, ds, sg, sc, gs, wc, hb, rh, gp, st, us, b, len, total;
  __host__ __device__ FwdSmem(int h, int R) {
    U = (h + CL - 1) / CL;
    const int Mg = (2 * U + 15) & ~15;  // the own u and r columns, tiles
    const int Mc = (U + 15) & ~15;      // the own c columns
    K = rnn::slice_cols(h);             // the products' depth, zeros past h
    wst = K + 4;                        // a fragment's rows g, columns t
    ds = rnn::grad_stride(R);           // fall in 32 banks
    sg = rnn::k_shares(2 * U, K, R);
    sc = rnn::k_shares(U, K, R);
    gs = Mg + 4;
    wc = Mg * wst;                      // wg [Mg][wst]; then wc [Mc][wst]
    hb = wc + Mc * wst;                 // [K][ds] h_{t-1}
    rh = hb + K * ds;                   // [K][ds] r * h_{t-1}
    gp = rh + K * ds;                   // [shares][R][gs] either product
    st = gp + (sg > sc ? sg : sc) * R * gs;  // [2][3][R U] staged x
    us = st + 6 * R * U;                // [R U] u
    b = us + R * U;                     // [3][U] the own units' b
    len = b + 3 * U;                    // [R] int lengths
    total = len + R;
  }
};

size_t fwd_cluster_smem(int h, int R) {
  return (size_t)FwdSmem(h, R).total * sizeof(float);
}

// B7's cluster route (see the head of this file)
template <int R>
__global__ void __launch_bounds__(rnn::NTC, 1)
gru_fwd_cluster_kernel(const float* __restrict__ x,
                       const float* __restrict__ w_g,
                       const float* __restrict__ w_c,
                       const float* __restrict__ b,
                       const int* __restrict__ lens, float* __restrict__ y,
                       int B, int T, int h) {
  constexpr int NTC = rnn::NTC;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const FwdSmem L(h, R);
  const int U = L.U, ds = L.ds, gs = L.gs, RU = R * U, h3 = 3 * h;
  const int s = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / CL) * R;
  const int j0 = s * U, nu = max(0, min(U, h - j0));
  // wg[q U + u][k] = w_g[k][q h + j0 + u] (q 0: u, 1: r); wc[u][k] =
  // w_c[k][j0 + u]
  float* wg = smem;
  float* wc = smem + L.wc;
  float* hb = smem + L.hb;
  float* rh = smem + L.rh;
  float* gp = smem + L.gp;
  float* stg = smem + L.st;
  float* us = smem + L.us;
  float* sb = smem + L.b;
  int* slen = reinterpret_cast<int*>(smem + L.len);

  int live = 0;  // the steps until every row of the cluster is past its length
#pragma unroll
  for (int r = 0; r < R; ++r)
    live = max(live, row0 + r < B ? min(lens[row0 + r], T) : 0);
  // h_{-1} = 0, and every pad zero
  for (int i = threadIdx.x; i < L.total; i += NTC) smem[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < h * 2 * U; i += NTC) {
    const int k = i / (2 * U), c = i % (2 * U), q = c / U, u = c % U;
    if (u < nu) wg[c * L.wst + k] = w_g[(size_t)k * 2 * h + q * h + j0 + u];
  }
  for (int i = threadIdx.x; i < h * U; i += NTC) {
    const int k = i / U, u = i % U;
    if (u < nu) wc[u * L.wst + k] = w_c[(size_t)k * h + j0 + u];
  }
  for (int i = threadIdx.x; i < 3 * U; i += NTC) {
    const int q = i / U, u = i % U;
    sb[i] = u < nu ? b[q * h + j0 + u] : 0.f;
  }
  for (int r = threadIdx.x; r < R; r += NTC)
    slen[r] = row0 + r < B ? lens[row0 + r] : 0;
  // x of step t into slot t & 1: [3][R U] the gates u, r, c of the live
  // (row, unit) pairs
  auto stage = [&](int t) {
    float* sx = stg + (t & 1) * 3 * RU;
    for (int e = threadIdx.x; e < 3 * RU && !kSerialFloor; e += NTC) {
      const int q = e / RU, pr = e % RU, r = pr / U, u = pr % U;
      const int row = row0 + r;
      const bool ok = u < nu && row < B && t < lens[row];
      cp_async4(sx + e, ok ? x + ((size_t)row * T + t) * h3 + q * h + j0 + u
                           : x, ok ? 4 : 0);
    }
  };
  // y of step t (0 past len) from h_t, coalesced along the units
  auto store = [&](int t) {
    for (int e = threadIdx.x; e < RU && !kSerialFloor; e += NTC) {
      const int r = e / U, u = e % U, row = row0 + r;
      if (u >= nu || row >= B) continue;
      y[((size_t)row * T + t) * h + j0 + u] =
          t < slen[r] ? hb[(j0 + u) * ds + r] : 0.f;
    }
  };
  // the sum of a product's shares for (row r, column m), in order
  auto shares = [&](int r, int m, int n) {
    float v = gp[r * gs + m];
    for (int sh = 1; sh < n; ++sh) v += gp[(sh * R + r) * gs + m];
    return v;
  };
  // every block of the cluster runs and is set before any peer pushes into
  // its shared memory
  cluster.sync();
  if (live > 0) stage(0);
  cp_async_commit();

  for (int t = 0; t < live; ++t) {
    if (t + 1 < live) stage(t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // step t's inputs (this thread's copies)
    // G_s[r][q U + u] = sum_k h_{t-1}[r][k] w_g[k][q h + j0 + u], in shares
    if (!kSerialFloor)
      rnn::tile_product<R>(wg, L.wst, hb, ds, L.K, 2 * U, gp, gs, L.sg);
    __syncthreads();  // the product and step t's inputs are complete
    const float* sx = stg + (t & 1) * 3 * RU;
    // u, r and r * h_{t-1} of the own (row, unit) pairs (0 past len)
    for (int pr = threadIdx.x; pr < RU && !kSerialFloor; pr += NTC) {
      const int r = pr / U, u = pr % U, k = (j0 + u) * ds + r;
      if (u >= nu) continue;
      float rhv = 0.f;
      if (t < slen[r]) {
        const float ug = rnn::sigm((sx[pr] + sb[u]) + shares(r, u, L.sg));
        const float rg =
            rnn::sigm((sx[RU + pr] + sb[U + u]) + shares(r, U + u, L.sg));
        us[pr] = ug;
        rhv = rg * hb[k];
      }
      rh[k] = rhv;
    }
    __syncthreads();  // r * h_{t-1} of the own units is in rh
    rnn::push_to_peers(cluster, rh, j0 * ds, U * ds);
    rnn::cluster_arrive();  // barrier 1: r * h_{t-1} is in every block
    rnn::cluster_wait();
    // C_s[r][u] = sum_k (r h_{t-1})[r][k] w_c[k][j0 + u], in shares
    if (!kSerialFloor)
      rnn::tile_product<R>(wc, L.wst, rh, ds, L.K, U, gp, gs, L.sc);
    __syncthreads();
    // c and h_t of the own pairs; past len h carries
    for (int pr = threadIdx.x; pr < RU && !kSerialFloor; pr += NTC) {
      const int r = pr / U, u = pr % U, k = (j0 + u) * ds + r;
      if (u >= nu || t >= slen[r]) continue;
      const float c =
          tanhf((sx[2 * RU + pr] + sb[2 * U + u]) + shares(r, u, L.sc));
      const float ug = us[pr];
      hb[k] = ug * hb[k] + (1.f - ug) * c;
    }
    __syncthreads();  // h_t of the own units is in hb
    rnn::push_to_peers(cluster, hb, j0 * ds, U * ds);
    rnn::cluster_arrive();  // barrier 2: h_t is in every block
    store(t);               // while the peers arrive
    rnn::cluster_wait();
  }
  cp_async_wait<0>();
  // past every row's length: y = 0
  for (int e = threadIdx.x; e < (T - live) * RU && !kSerialFloor; e += NTC) {
    const int t = live + e / RU, pr = e % RU, r = pr / U, u = pr % U;
    const int row = row0 + r;
    if (u < nu && row < B) y[((size_t)row * T + t) * h + j0 + u] = 0.f;
  }
}

// ------------------------------------------------------------ grid route
// B7's grid block's shared memory, in floats from the base, at width h, U
// units a block and Bp rows (a multiple of 16); the slices of w_g and w_c
// only where they are resident
struct FwdGrid {
  int K, kst, gs, cs, wc, gur, gc, us, hs, sb, total;
  __host__ __device__ FwdGrid(int h, int U, int Bp, bool resident) {
    K = rnn::round8(h);              // the products' depth, zeros past h
    kst = rnn::grad_stride(K);
    gs = rnn::round8(2 * U);         // the own u and r columns q U + u
    cs = rnn::round8(U);             // the own c columns
    wc = resident ? 2 * U * kst : 0;   // wg [2U][kst]: w_g[k][q h + j0 + u]
    gur = wc + (resident ? U * kst : 0);  // wc [U][kst]: w_c[k][j0 + u]
    gc = gur + Bp * gs;              // gur [Bp][gs]: x_t + b + the product
    us = gc + Bp * cs;               // gc [Bp][cs]: x_t + b + the product
    hs = us + Bp * U;                // us [Bp][U]: u of the step
    sb = hs + Bp * U;                // hs [Bp][U]: h_{t-1} of the own units
    total = sb + 3 * U;              // sb [3][U]: the own units' b
  }
};

// B8's grid block's shared memory, as FwdGrid's
struct BwdGrid {
  int kc, kg, wg, ps, pg, dh, dho, rr, rf, total;
  __host__ __device__ BwdGrid(int h, int U, int Bp, bool resident) {
    kc = rnn::grad_stride(rnn::round8(h));      // wc [U][kc]: w_c[j0 + u]
    kg = rnn::grad_stride(rnn::round8(2 * h));  // wg [U][kg]: w_g[j0 + u]
    wg = resident ? U * kc : 0;
    pg = wg + (resident ? U * kg : 0);
    ps = rnn::round8(U);             // pg [Bp][ps]: d(r h) or dh's product
    dh = pg + Bp * ps;               // dh [Bp][U]: dL/dh_t, own units
    dho = dh + Bp * U;               // dho [Bp][U]: dh_{t-1}'s own terms
    rr = dho + Bp * U;               // rr [Bp][U]: r
    rf = rr + Bp * U;                // rf [Bp][U]: h_{t-1} r (1 - r)
    total = rf + Bp * U;
  }
};

size_t fwd_grid_smem(int h, int U, int Bp, bool resident) {
  return (size_t)FwdGrid(h, U, Bp, resident).total * sizeof(float);
}

size_t bwd_grid_smem(int h, int U, int Bp, bool resident) {
  return (size_t)BwdGrid(h, U, Bp, resident).total * sizeof(float);
}

// The floats of B7's grid exchange buffers: h and r * h, [Bp][round8(h)]
// each
long long fwd_exchange_floats(int Bp, int h) {
  return 2LL * Bp * rnn::round8(h);
}

// The floats of B8's grid exchange buffers: dg_c [Bp][round8(h)], then
// dg_ur [2][Bp][round8(2h)] (both parities)
long long bwd_exchange_floats(int Bp, int h) {
  return (long long)Bp * rnn::round8(h) + 2LL * Bp * rnn::round8(2 * h);
}

// The m-tiles (of 16 rows) a job of B7's per-step products holds (the
// n-tiles of its u/r product follow the gate columns, 2 or 4, and its c
// product's are FWD_NG_C; more columns make more jobs), and the m- and
// n-tiles of B8's, over the own units
constexpr int FWD_MG = 2;
constexpr int FWD_NG_C = 2;
constexpr int BWD_MG = 4;
constexpr int BWD_NG = 2;
constexpr int CELL_PAIRS = 4;   // (row, unit) pairs B8's cell loads at once

// B7's grid route (see the head of this file). hbuf and rhbuf
// [Bp][round8(h)] and *bar are zero on entry. RES: the slices of w_g and
// w_c in shared memory, else read from L2 each step; NG: the n-tiles of a
// u/r product job (fwd_grid_kernel's choice).
template <bool RES, int NG>
__global__ void __launch_bounds__(rnn::GT, 1)
gru_fwd_grid_kernel(const float* __restrict__ x,
                    const float* __restrict__ w_g,
                    const float* __restrict__ w_c,
                    const float* __restrict__ b, const int* __restrict__ lens,
                    float* __restrict__ y, float* hbuf, float* rhbuf,
                    unsigned* bar, int B, int T, int h, int U) {
  constexpr int GT = rnn::GT;
  extern __shared__ __align__(16) float smem[];
  const int Bp = rnn::round16(B);
  const FwdGrid L(h, U, Bp, RES);
  const int s = blockIdx.x, G = gridDim.x;
  const int j0 = s * U, nu = min(U, h - j0), K = L.K, U3 = 3 * U;
  const int h3 = 3 * h;
  float* wg = smem;
  float* wc = smem + L.wc;
  float* gur = smem + L.gur;
  float* gc = smem + L.gc;
  float* us = smem + L.us;
  float* hs = smem + L.hs;
  float* sb = smem + L.sb;

  int live = 0;  // the steps until every row is past its length
  for (int r = 0; r < B; ++r) live = max(live, min(__ldg(lens + r), T));
  // h_{-1} = 0, and every pad zero
  for (int i = threadIdx.x; i < L.total; i += GT) smem[i] = 0.f;
  __syncthreads();
  if constexpr (RES) {
    for (int i = threadIdx.x; i < h * 2 * U; i += GT) {
      const int k = i / (2 * U), c = i % (2 * U), q = c / U, u = c % U;
      if (u < nu) wg[c * L.kst + k] = w_g[(size_t)k * 2 * h + q * h + j0 + u];
    }
    for (int i = threadIdx.x; i < h * U; i += GT) {
      const int k = i / U, u = i % U;
      if (u < nu) wc[u * L.kst + k] = w_c[(size_t)k * h + j0 + u];
    }
  }
  for (int i = threadIdx.x; i < 3 * nu; i += GT) {
    const int q = i / nu, u = i % nu;
    sb[q * U + u] = b[q * h + j0 + u];
  }
  // the gate column c = q U + u of row r: gur for u and r, gc for c
  auto gate = [&](int r, int c) {
    return c < 2 * U ? gur + r * L.gs + c : gc + r * L.cs + (c - 2 * U);
  };
  // x_t of the own gate columns into gur and gc (0 past len)
  auto stage = [&](int t) {
    for (int e = threadIdx.x; e < B * U3 && !kSerialFloor; e += GT) {
      const int r = e / U3, c = e % U3, q = c / U, u = c % U;
      const bool ok = u < nu && t < __ldg(lens + r);
      cp_async4(gate(r, c),
                ok ? x + ((size_t)r * T + t) * h3 + q * h + j0 + u : x,
                ok ? 4 : 0);
    }
  };
  // Bt(n, k) = w_g[k][q h + j0 + u] for the own u/r column n = q U + u,
  // and w_c[k][j0 + n] for the own unit n
  auto wgcol = [&](int n, int k) -> float2 {
    if (n >= 2 * U) return make_float2(0.f, 0.f);
    if constexpr (RES) {
      return *reinterpret_cast<const float2*>(wg + n * L.kst + k);
    } else {
      const int q = n / U, u = n % U;
      if (u >= nu) return make_float2(0.f, 0.f);
      const float* col = w_g + q * h + j0 + u;
      const size_t ld = 2 * (size_t)h;
      return make_float2(k < h ? __ldg(col + k * ld) : 0.f,
                         k + 1 < h ? __ldg(col + (k + 1) * ld) : 0.f);
    }
  };
  auto wccol = [&](int n, int k) -> float2 {
    if (n >= nu) return make_float2(0.f, 0.f);
    if constexpr (RES) {
      return *reinterpret_cast<const float2*>(wc + n * L.kst + k);
    } else {
      const float* col = w_c + j0 + n;
      return make_float2(k < h ? __ldg(col + (size_t)k * h) : 0.f,
                         k + 1 < h ? __ldg(col + (size_t)(k + 1) * h) : 0.f);
    }
  };
  __syncthreads();
  if (live > 0) stage(0);
  cp_async_commit();

  unsigned passed = 0;
  for (int t = 0; t < live; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // x_t has landed in gur and gc
    for (int e = threadIdx.x; e < B * U3 && !kSerialFloor; e += GT)
      *gate(e / U3, e % U3) += sb[e % U3];   // x + b, B7's order
    __syncthreads();
    // gur += h_{t-1} [Bp, K] @ w_g[:, own u, r] [K, 2U], h_{t-1} from L2
    rnn::grid_product_add<kSerialFloor, FWD_MG, NG>(
        gur, L.gs, Bp, 2 * U, K, rnn::GlobalRows{hbuf, K}, wgcol);
    // u, r and r * h_{t-1} of the own (row, unit) pairs (0 past len)
    for (int pr = threadIdx.x; pr < B * U; pr += GT) {
      const int r = pr / U, u = pr % U;
      if (u >= nu) continue;
      float rhv = 0.f;
      if (!kSerialFloor && t < __ldg(lens + r)) {
        const float* g = gur + r * L.gs;
        const float ug = rnn::sigm(g[u]);
        const float rg = rnn::sigm(g[U + u]);
        us[pr] = ug;
        rhv = rg * hs[pr];
      }
      rhbuf[(size_t)r * K + j0 + u] = rhv;
    }
    rnn::grid_sync(bar, passed += G);  // r * h_{t-1} of every block is in rh
    // gc += (r h_{t-1}) [Bp, K] @ w_c[:, own] [K, U], r h_{t-1} from L2
    rnn::grid_product_add<kSerialFloor, FWD_MG, FWD_NG_C>(
        gc, L.cs, Bp, U, K, rnn::GlobalRows{rhbuf, K}, wccol);
    // c and h_t of the own pairs; past len h carries and y = 0
    for (int pr = threadIdx.x; pr < B * U; pr += GT) {
      const int r = pr / U, u = pr % U, j = j0 + u;
      if (u >= nu) continue;
      if (kSerialFloor) {
        hbuf[(size_t)r * K + j] = 0.f;
        continue;
      }
      const size_t o = ((size_t)r * T + t) * h + j;
      if (t < __ldg(lens + r)) {
        const float c = tanhf(gc[r * L.cs + u]);
        const float ug = us[pr];
        const float out = ug * hs[pr] + (1.f - ug) * c;
        hs[pr] = out;
        hbuf[(size_t)r * K + j] = out;
        y[o] = out;
      } else {
        y[o] = 0.f;
      }
    }
    if (t + 1 == live) break;
    __syncthreads();  // gur and gc are read: x_{t+1} may land in them
    stage(t + 1);
    cp_async_commit();
    rnn::grid_sync(bar, passed += G);  // h_t of every block is in h
  }
  cp_async_wait<0>();
  // past every row's length: y = 0
  for (int e = threadIdx.x; e < (T - live) * B * U && !kSerialFloor;
       e += GT) {
    const int t = live + e / (B * U), pr = e % (B * U), r = pr / U,
              u = pr % U;
    if (u < nu) y[((size_t)r * T + t) * h + j0 + u] = 0.f;
  }
}

// B8's grid walk (see the head of this file). dx holds the hoisted
// pre-activations on entry and the gate gradients on exit; xbuf holds the
// exchange (bwd_exchange_floats); it and *bar are zero on entry. RES as
// B7's.
template <bool RES>
__global__ void __launch_bounds__(rnn::GT, 1)
gru_bwd_grid_kernel(const float* __restrict__ w_g,
                    const float* __restrict__ w_c,
                    const int* __restrict__ lens,
                    const float* __restrict__ y,
                    const float* __restrict__ dy, float* __restrict__ dx,
                    float* xbuf, unsigned* bar, int B, int T, int h, int U) {
  constexpr int GT = rnn::GT;
  extern __shared__ __align__(16) float smem[];
  const int Bp = rnn::round16(B);
  const BwdGrid L(h, U, Bp, RES);
  const int s = blockIdx.x, G = gridDim.x;
  const int j0 = s * U, nu = min(U, h - j0), U3 = 3 * U;
  const int h2 = 2 * h, h3 = 3 * h;
  const int hc = rnn::round8(h), hg = rnn::round8(h2);
  float* wc = smem;
  float* wg = smem + L.wg;
  float* pg = smem + L.pg;
  float* dhs = smem + L.dh;
  float* dho = smem + L.dho;
  float* rr = smem + L.rr;
  float* rf = smem + L.rf;
  float* dgc = xbuf;                       // [Bp][hc]
  float* dgur_base = xbuf + (size_t)Bp * hc;   // [2][Bp][hg]

  int live = 0;
  for (int r = 0; r < B; ++r) live = max(live, min(__ldg(lens + r), T));
  for (int i = threadIdx.x; i < L.total; i += GT) smem[i] = 0.f;
  __syncthreads();
  if constexpr (RES) {
    for (int i = threadIdx.x; i < nu * h; i += GT) {
      const int u = i / h, k = i % h;
      wc[u * L.kc + k] = w_c[(size_t)(j0 + u) * h + k];
    }
    for (int i = threadIdx.x; i < nu * h2; i += GT) {
      const int u = i / h2, k = i % h2;
      wg[u * L.kg + k] = w_g[(size_t)(j0 + u) * h2 + k];
    }
  }
  // past every row's length: dx = 0, no barrier
  for (int e = threadIdx.x; e < (T - live) * B * U3 && !kSerialFloor;
       e += GT) {
    const int t = live + e / (B * U3), rc = e % (B * U3), r = rc / U3,
              c = rc % U3, q = c / U, u = c % U;
    if (u < nu) dx[((size_t)r * T + t) * h3 + q * h + j0 + u] = 0.f;
  }
  // Bt(n, k) = w_c[j0 + n][k], and w_g[j0 + n][k], for the own unit n
  auto wcrow = [&](int n, int k) -> float2 {
    if (n >= nu) return make_float2(0.f, 0.f);
    if constexpr (RES) {
      return *reinterpret_cast<const float2*>(wc + n * L.kc + k);
    } else {
      const float* row = w_c + (size_t)(j0 + n) * h;
      return make_float2(k < h ? __ldg(row + k) : 0.f,
                         k + 1 < h ? __ldg(row + k + 1) : 0.f);
    }
  };
  auto wgrow = [&](int n, int k) -> float2 {
    if (n >= nu) return make_float2(0.f, 0.f);
    if constexpr (RES) {
      return *reinterpret_cast<const float2*>(wg + n * L.kg + k);
    } else {
      const float* row = w_g + (size_t)(j0 + n) * h2;
      return make_float2(k < h2 ? __ldg(row + k) : 0.f,
                         k + 1 < h2 ? __ldg(row + k + 1) : 0.f);
    }
  };
  __syncthreads();

  unsigned passed = 0;
  for (int t = live - 1; t >= 0; --t) {
    float* dgur = dgur_base + (size_t)(t & 1) * Bp * hg;
    // 1. the cell backward of the own (row, unit) pairs: dg_c and dg_u
    // into dx and into the exchange; past len dg = 0 and dh carries. A
    // thread loads the inputs of CELL_PAIRS pairs before it computes any:
    // one round trip to memory, not one a pair.
    for (int p0 = threadIdx.x; p0 < B * U; p0 += CELL_PAIRS * GT) {
      float in[CELL_PAIRS][5];
#pragma unroll
      for (int q = 0; q < CELL_PAIRS; ++q) {
        const int pr = p0 + q * GT, r = pr / U, u = pr % U, j = j0 + u;
        if (kSerialFloor || pr >= B * U || u >= nu || t >= __ldg(lens + r))
          continue;
        const size_t base = (size_t)r * T + t;
        const float* pre = dx + base * h3 + j;
        in[q][0] = pre[0];
        in[q][1] = pre[h];
        in[q][2] = pre[2 * h];
        in[q][3] = dy[base * h + j];
        in[q][4] = t > 0 ? y[(base - 1) * h + j] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < CELL_PAIRS; ++q) {
        const int pr = p0 + q * GT, r = pr / U, u = pr % U, j = j0 + u;
        if (pr >= B * U || u >= nu) continue;
        const size_t base = (size_t)r * T + t;
        float dgu = 0.f, dgcv = 0.f;
        if (!kSerialFloor && t < __ldg(lens + r)) {
          const float ug = rnn::sigm(in[q][0]);
          const float rg = rnn::sigm(in[q][1]);
          const float c = tanhf(in[q][2]);
          const float hp = in[q][4];
          const float dout = dhs[pr] + in[q][3];
          dgcv = dout * (1.f - ug) * (1.f - c * c);
          dgu = dout * (hp - c) * ug * (1.f - ug);
          dho[pr] = dout * ug;
          rr[pr] = rg;
          rf[pr] = hp * rg * (1.f - rg);
        }
        if (!kSerialFloor) {
          dx[base * h3 + j] = dgu;
          dx[base * h3 + 2 * h + j] = dgcv;
        }
        dgur[(size_t)r * hg + j] = dgu;
        dgc[(size_t)r * hc + j] = dgcv;
      }
    }
    rnn::grid_sync(bar, passed += G);  // every block's dg_c and dg_u
    // 2. d(r h)[:, own] = dg_c [Bp, hc] (from L2) @ w_c[own, :]^T, then
    // dg_r of the own units and dh's r-term
    for (int i = threadIdx.x; i < Bp * L.ps; i += GT) pg[i] = 0.f;
    __syncthreads();
    rnn::grid_product_add<kSerialFloor, BWD_MG, BWD_NG>(
        pg, L.ps, Bp, U, hc, rnn::GlobalRows{dgc, hc}, wcrow);
    for (int pr = threadIdx.x; pr < B * U; pr += GT) {
      const int r = pr / U, u = pr % U, j = j0 + u;
      if (u >= nu) continue;
      float dgr = 0.f;
      if (!kSerialFloor && t < __ldg(lens + r)) {
        const float drh = pg[r * L.ps + u];
        dgr = drh * rf[pr];
        dho[pr] += drh * rr[pr];
      }
      if (!kSerialFloor) dx[((size_t)r * T + t) * h3 + h + j] = dgr;
      dgur[(size_t)r * hg + h + j] = dgr;
    }
    if (t == 0) break;  // dh_{-1} is not needed
    rnn::grid_sync(bar, passed += G);  // every block's dg_r
    // 3. dh_{t-1}[:, own] = the own terms + dg_ur [Bp, hg] (from L2) @
    // w_g[own, :]^T; a masked row's dh carries
    for (int i = threadIdx.x; i < Bp * L.ps; i += GT) pg[i] = 0.f;
    __syncthreads();
    rnn::grid_product_add<kSerialFloor, BWD_MG, BWD_NG>(
        pg, L.ps, Bp, U, hg, rnn::GlobalRows{dgur, hg}, wgrow);
    for (int pr = threadIdx.x; pr < B * U; pr += GT) {
      const int r = pr / U, u = pr % U;
      if (u < nu && t < __ldg(lens + r))
        dhs[pr] = dho[pr] + pg[r * L.ps + u];
    }
  }
}

// db's row-chunk partials: part[chunk][j] sums dx[n][j] over the chunk's
// rows of the N = B*T (dx is 0 on masked steps)
__global__ void gru_bias_grad_kernel(const float* __restrict__ dx,
                                     float* __restrict__ part, int N,
                                     int width, int rows) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  const int n0 = blockIdx.y * rows, n1 = min(N, n0 + rows);
  float s = 0.f;
  for (int n = n0; n < n1; ++n) s += dx[(size_t)n * width + j];
  part[(size_t)blockIdx.y * width + j] = s;
}

// db [3h] from dx over the N = B*T rows, through BIAS_PARTS row-chunk
// partials in part (fixed order)
cudaError_t bias_grad(const float* dx, float* part, float* db, int N, int h,
                      cudaStream_t st) {
  const int rows = rnn::cdiv(N, rnn::BIAS_PARTS < N ? rnn::BIAS_PARTS : N);
  const int parts = rnn::cdiv(N, rows);
  gru_bias_grad_kernel<<<dim3(rnn::cdiv(3 * h, 128), parts), 128, 0, st>>>(
      dx, part, N, 3 * h, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return rnn::block_sum(part, db, parts, 3 * h, st);
}

// B7's grid kernel for the slices resident or not and U units a block: a
// u/r product job of 2 n-tiles where the 2U columns take at most 2 (U <= 8,
// h <= 1056 on 132 SMs), else of 4, several jobs past 4 (h > 2112)
using FwdKern = void (*)(const float*, const float*, const float*,
                         const float*, const int*, float*, float*, float*,
                         unsigned*, int, int, int, int);

FwdKern fwd_grid_kernel(bool resident, int U) {
  if ((2 * U + 7) / 8 <= 2)
    return resident ? &gru_fwd_grid_kernel<true, 2>
                    : &gru_fwd_grid_kernel<false, 2>;
  return resident ? &gru_fwd_grid_kernel<true, 4>
                  : &gru_fwd_grid_kernel<false, 4>;
}

using BwdKern = void (*)(const float*, const float*, const int*,
                         const float*, const float*, float*, float*,
                         unsigned*, int, int, int, int);

BwdKern bwd_grid_kernel(bool resident) {
  return resident ? &gru_bwd_grid_kernel<true> : &gru_bwd_grid_kernel<false>;
}

// dW's split-K partials at (B, T, h): the larger of dW_g's and dW_c's
// (they run in turn)
long long dw_floats(int B, int T, int h) {
  const long long n = (long long)B * T;
  const long long g = rnn::dw_scratch_floats(n, h, 2 * h);
  const long long c = rnn::dw_scratch_floats(n, h, h);
  return g > c ? g : c;
}

// Scratch floats of B8's launch: the db partials of either route (the
// clusters', or the grid route's row chunks), rh [B, T, h], dW's split-K
// partials, then the grid route's barrier and exchange (B7's grid route:
// those alone). The offsets of the pieces, in floats (16-byte aligned).
struct BwdScratch {
  long long part, rh, dw, grid, total;
  BwdScratch(const rnn::Plan& p, int B, int T, int h) {
    part = 0;
    const long long parts = B > rnn::BIAS_PARTS ? B : rnn::BIAS_PARTS;
    rh = (parts * 3 * h + 31) & ~31LL;
    dw = (rh + (long long)B * T * h + 31) & ~31LL;
    grid = (dw + dw_floats(B, T, h) + 31) & ~31LL;
    total = grid + rnn::grid_floats(p, h, bwd_exchange_floats);
  }
};

// The two cluster walks and the grid route of this file, for
// rnn_common.cuh's route rule and launches: the grid route takes every h
// the cluster route does not
struct Walks {
  template <int KIND, int R>
  static auto kernel() {
    if constexpr (KIND == 0)
      return &gru_fwd_cluster_kernel<R>;
    else
      return &gru_bwd_cluster_kernel<R>;
  }
  static size_t smem(int kind, int h, int R) {
    return kind == 0 ? fwd_cluster_smem(h, R) : walk_smem(h, R);
  }
  static size_t grid_smem(int kind, int h, int U, int Bp, bool res) {
    return kind == 0 ? fwd_grid_smem(h, U, Bp, res)
                     : bwd_grid_smem(h, U, Bp, res);
  }
  static int grid_active(int kind, int U, bool res, size_t bytes,
                         int device) {
    return kind == 0 ? rnn::max_active_blocks(fwd_grid_kernel(res, U),
                                              rnn::GT, bytes, device)
                     : rnn::max_active_blocks(bwd_grid_kernel(res), rnn::GT,
                                              bytes, device);
  }
};

}  // namespace

// B7's (gru_seq_fwd_plan) or B8's (gru_seq_bwd_plan) route at (B, h) on
// `device` (rnn::plan_entry). Returns a cudaError_t.
extern "C" int gru_seq_fwd_plan(int B, int h, int device, int request,
                                int* out) {
  return rnn::plan_entry<Walks>(0, B, h, device, request, out);
}

extern "C" int gru_seq_bwd_plan(int B, int h, int device, int request,
                                int* out) {
  return rnn::plan_entry<Walks>(1, B, h, device, request, out);
}

// Floats of scratch gru_seq_fwd (kind 0) or gru_seq_bwd needs at (B, T, h)
// on the route `route` asks for on `device` (-1: none takes h).
extern "C" long long gru_seq_scratch_floats(int kind, int B, int T, int h,
                                            int device, int route) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  rnn::Plan p;
  if (rnn::walk_plan<Walks>(kind, B, h, device, route, &p) != 0 ||
      p.route < 0)
    return -1;
  return kind == 0 ? rnn::grid_floats(p, h, fwd_exchange_floats)
                   : BwdScratch(p, B, T, h).total;
}

// B7. x [B, T, 3h], w_g [h, 2h], w_c [h, h], b [3h], lens [B] int32 ->
// y [B, T, h], on the route `route` asks for (rnn::make_plan), which it
// writes into *taken (-1: that route does not take h, and nothing is
// launched); scratch of gru_seq_scratch_floats(0, ...) floats. Launches on
// `stream` of `device`; returns the launch's cudaError_t (0 = launched or
// refused).
extern "C" int gru_seq_fwd(const float* x, const float* w_g, const float* w_c,
                           const float* b, const int* lens, float* y,
                           float* scratch, int B, int T, int h, int route,
                           int* taken, int device, void* stream) {
  rnn::Plan p;
  const int rc = rnn::launch_plan<Walks>(0, B, h, device, route, taken, &p);
  if (rc != 0 || p.route < 0) return rc;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (p.route == 1)
    return (int)rnn::launch_walk<Walks, 0>(p, h, st, x, w_g, w_c, b, lens, y,
                                           B, T, h);
  // the grid route, a launch for every p.rows rows
  unsigned* bar = reinterpret_cast<unsigned*>(scratch);
  float* hbuf = scratch + rnn::GRID_HEAD;
  const size_t h3 = 3 * (size_t)h;
  return (int)rnn::grid_launches(
      p, B, h, scratch, fwd_exchange_floats, st, [&](int r0, int rows) {
        float* rhbuf = hbuf + (size_t)rnn::round16(rows) * rnn::round8(h);
        const size_t off = (size_t)r0 * T;
        return rnn::launch_grid(
            fwd_grid_kernel(!p.streamed, p.units), p.blocks,
            fwd_grid_smem(h, p.units, rnn::round16(rows), !p.streamed), st,
            x + off * h3, w_g, w_c, b, lens + r0, y + off * h, hbuf, rhbuf,
            bar, rows, T, h, p.units);
      });
}

// B8. Inputs as B7's plus y and dy [B, T, h]; writes dx [B, T, 3h],
// dw_g [h, 2h], dw_c [h, h] and db [3h], on the route `route` asks for,
// written into *taken as B7's is; scratch of gru_seq_scratch_floats(1,
// ...) floats.
extern "C" int gru_seq_bwd(const float* x, const float* w_g, const float* w_c,
                           const float* b, const int* lens, const float* y,
                           const float* dy, float* dx, float* dw_g,
                           float* dw_c, float* db, float* scratch, int B,
                           int T, int h, int route, int* taken, int device,
                           void* stream) {
  rnn::Plan p;
  const int rc = rnn::launch_plan<Walks>(1, B, h, device, route, taken, &p);
  if (rc != 0 || p.route < 0) return rc;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const BwdScratch S(p, B, T, h);
  float* part = scratch + S.part;
  float* rh_seq = scratch + S.rh;
  float* dw_part = scratch + S.dw;
  const int h3 = 3 * h;
  // u, r: (x + b) + h_{t-1} @ w_g, and rh = r * h_{t-1}; then c:
  // (x_c + b_c) + rh @ w_c, all into dx
  cudaError_t err = rnn::pre_gemm<rnn::EPI_PRE_RH>(
      y, h, T, w_g, 2 * h, x, h3, b, dx, h3, B * T, 2 * h, h, rh_seq, lens,
      h, st);
  if (err != cudaSuccess) return (int)err;
  err = rnn::pre_gemm<rnn::EPI_PRE>(rh_seq, h, 0, w_c, h, x + 2 * h, h3,
                                    b + 2 * h, dx + 2 * h, h3, B * T, h, h,
                                    nullptr, nullptr, h, st);
  if (err != cudaSuccess) return (int)err;
  if (p.route == 1) {
    err = rnn::launch_walk<Walks, 1>(p, h, st, w_g, w_c, lens, y, dy, dx, part,
                                     B, T, h);
    if (err != cudaSuccess) return (int)err;
    err = rnn::block_sum(part, db, p.blocks, h3, st);
  } else {
    unsigned* bar = reinterpret_cast<unsigned*>(scratch + S.grid);
    float* xbuf = scratch + S.grid + rnn::GRID_HEAD;
    err = rnn::grid_launches(
        p, B, h, scratch + S.grid, bwd_exchange_floats, st,
        [&](int r0, int rows) {
          const size_t off = (size_t)r0 * T;
          return rnn::launch_grid(
              bwd_grid_kernel(!p.streamed), p.blocks,
              bwd_grid_smem(h, p.units, rnn::round16(rows), !p.streamed), st,
              w_g, w_c, lens + r0, y + off * h, dy + off * h, dx + off * h3,
              xbuf, bar, rows, T, h, p.units);
        });
    if (err != cudaSuccess) return (int)err;
    err = bias_grad(dx, part, db, B * T, h, st);
  }
  if (err != cudaSuccess) return (int)err;
  // dW_g = sum h_{t-1}^T dg_ur (h_{t-1} = y shifted by one);
  // dW_c = sum (r h_{t-1})^T dg_c
  err = rnn::weight_grad(y, h, T, dx, h3, dw_g, dw_part, B * T, h, 2 * h, st);
  if (err != cudaSuccess) return (int)err;
  return (int)rnn::weight_grad(rh_seq, h, 0, dx + 2 * h, h3, dw_c, dw_part,
                               B * T, h, h, st);
}

extern "C" const char* gru_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
