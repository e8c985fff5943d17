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
// The grid route of B5 and B6 (every h past the cluster routes' reach,
// h > 320). The TPU kernel's grid is (batch blocks, time blocks) with the
// h/c carry in VMEM across the sequential time blocks; here each step is
// spread over the whole card. One persistent block an SM (cooperative
// launch, G = ceil(h / U) blocks, U = ceil(h / SMs): 128 blocks of 10 units
// at h = 1280 on an H100 SXM's 132 SMs) owns the hidden units J_s = [s U,
// s U + U) and every batch row; the blocks meet at one grid barrier a step
// (rnn::grid_sync).
// B5: block s keeps in shared memory the columns of w of its units' four
// gates, gate-interleaved ([4U][h], 206 KB at h = 1280; wider slices are
// read from L2 each step: the streamed form). A step: the block's gate
// pre-activations G_s = h_{t-1} [B, h] @ w[:, own] [h, 4U] on the tensor
// cores (rnn::grid_product: 3xTF32 mma.sync, the batch rows as m, the 4U
// gate columns as n; a warp's job holds FWD_MG m-tiles and all the n-tiles,
// so a k-group's weights are split once for its rows; h_{t-1} read from L2
// GPF k-groups ahead, the depth split in shares over the warps, added in
// order) onto x_t (staged by cp.async during the previous barrier); the
// cell of the own (row, unit) pairs, c in shared memory; h_t of the own
// units into the global double buffer [2][B][h] (step t reads t & 1,
// writes the other), y and c; the grid barrier. One barrier a step is
// enough: a block writes buffer t & 1 again only in step t + 1, after every
// block passed barrier t, that is, finished its product of step t.
// B6: the gate recompute is hoisted as on the cluster route (one GEMM into
// dx before the walk), dW and db7 follow the walk; only dh_{t-1} = dg @ w^T
// stays serial. A step: the cell backward of the own pairs (a thread loads
// the inputs of CELL_PAIRS pairs at once: dx's pre-activations, dy, c;
// dg into dx and into the exchange), then the exchange: the block stores
// dg[:, own] into a global [2][B][4h]; after the barrier it reads all of dg
// (from L2: 1.3 MB at h = 1280, B = 64) and forms dh[:, own] = dg @
// w[own, :]^T with w's own rows resident ([U][4h]), BWD_MG m-tiles a job:
// 4 B h floats read a block a step. (The other exchange measured, each
// block's partial dg[:, own] @ w[:, own]^T [B, h] reduced by the units'
// owners, moves 2 B h floats a block a step but needs 84 MB of slabs at
// h = 1280, more than L2 holds; it ran 1.2-1.7x slower and was dropped.)
// Steps past every row's length take no barrier: their zeros (y, dx) and
// carried c are written by each block for its own units, without barriers.
// Every sum runs in a fixed order: a repeat is bit-identical. What bounds
// it: the serial chain of T steps, each a product (at h = 1280, B = 64:
// 3 x 3200 mma.sync a block and the split of its operands), the read of
// h_{t-1} (or of dg) from L2 by every block, and the barrier;
// -DRNN_SERIAL_FLOOR keeps only the exchanges and the barriers
// (rnn_fwd_probe.py, rnn_bwd_probe.py measure that floor).
//
// B6's cluster route (every h whose weight slice fits a block's shared
// memory: h <= 320). Two facts shape it: the gate recompute needs only
// h_{t-1} = y[t-1], which the forward saved, so it is not serial at all;
// and only dh_{t-1} = dg @ w^T has to stay inside the reverse walk.
// 1. Before the walk, one 3xTF32 tensor-core GEMM (rnn_common.cuh tc_kernel)
//    over all B*T rows writes every step's pre-activation x + h_{t-1} @ w
//    into dx itself (it has the gates' shape); the walk adds the bias and
//    the peepholes as B5 does ((x + product) + bias + peephole) and
//    overwrites each element with the gate gradient (0 on a masked step).
// 2. The walk: a cluster of CL = 8 blocks of 512 threads owns R batch rows
//    (R from rnn_common.cuh's WALK_ROWS, the fewest whose clusters the card
//    holds at once: an H100 SXM holds 15, so B = 64 takes 5); block s owns
//    the units J_s = [s U, (s + 1) U), U = h / 8, and loads once the columns
//    of w of its units' four gates (h x 4U floats, 132 KB at h = 256),
//    which serve every step. A step: the cell backward of the own units
//    (inputs staged by cp.async a step ahead) into shared memory; the
//    partial P_s = dg[:, own] @ w[:, own]^T [R, h] on the tensor cores
//    (3xTF32 mma.sync, the batch rows as n: rnn::tile_product) into a
//    double-buffered slot; the cluster barrier's arrive, dx's stores, its
//    wait; then each block sums, in rank order (deterministic), its units'
//    columns of every peer's P through distributed shared memory: dh_{t-1}.
//    Steps where every row of the cluster is past its length skip the
//    product and the barrier. No grid-wide sync: clusters are independent.
// 3. dW = sum_n h_{t-1}^T dg on the tensor cores (tc_kernel, A^T B, split
//    over the rows, f32 flushes, fixed-order sum), db7 from the clusters'
//    partials in a fixed order: bit-identical run to run.
// What bounds it on one H100 SXM: not the card-wide bound the smoke reports
// (operations over 67 TFLOP/s, bytes over 3.35 TB/s), but the serial chain
// of T steps, each a cell, a product (768 mma.sync and the split of the
// 32 768 weights of the slice a block), a cluster barrier and an exchange.
// Compiled with -DRNN_SERIAL_FLOOR the walk keeps only the barriers and the
// exchanges (rnn_bwd_probe.py measures that floor).
//
// B5's cluster route (every h whose slice of w and buffers fit a block's
// shared memory: h <= 320). The forward cannot hoist its product: step t's
// h_{t-1} @ w needs the h just made. So the walk itself is spread over a
// cluster, as B6's:
// 1. A cluster of CL = 8 blocks of 512 threads owns R batch rows (the rows
//    and clusters chosen as B6's, from the forward's shared memory); block
//    s owns the units J_s and loads once the columns of w of its units'
//    four gates, transposed ([4U][h], 130 KB at h = 256), which serve every
//    step. Its product is local to the block: G_s = h_{t-1} [R, h] @ w[:,
//    own] [h, 4U] on the tensor cores (3xTF32 mma.sync, the own gate
//    columns as m and the batch rows as n: rnn::tile_product), h split in
//    shares over warps where the 4U columns make fewer 16-row tiles than
//    the block has warps (2 shares at h = 256), the shares added in order.
//    No partial sum crosses blocks, so a repeat is bit-identical.
// 2. A step: the product, from h_{t-1} [h][R] (every block holds all of
//    it); the cell of the own (row, unit) pairs in B5's order ((x +
//    product) + bias + peephole), x staged a step ahead by cp.async, c in
//    shared memory; h_t of the own units into the block's next h buffer
//    and pushed into every peer's (rnn::push_to_peers: 16-byte stores
//    through distributed shared memory, an all-gather); the split cluster
//    barrier's arrive, y's and c's stores, its wait.
// 3. One barrier a step is enough, because h is double-buffered: step t
//    reads buffer t & 1 and writes buffer (t + 1) & 1, its own units' rows
//    and the peers'. A block writes buffer t & 1 again (for step t + 2)
//    only in step t + 1, after barrier t, and every peer arrived at barrier
//    t after its product of step t, that buffer's last read. c and the
//    staged x are double-buffered too, so y and c of step t are stored
//    from slots that step t + 1 does not write.
// 4. Once every row of a cluster is past its length, the remaining steps
//    store y = 0 and the carried c, with no product and no barrier.
// What bounds it: the serial chain of T steps, each a product (768
// mma.sync a block at h = 256 and R <= 8, and the split of its 32 768
// weights), the cell, the push and a cluster barrier; -DRNN_SERIAL_FLOOR
// keeps only the pushes and the barriers (rnn_fwd_probe.py).
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
  int U, wst, ds, dg, pb, st, dh, dc, db, b7, len, total;
  __host__ __device__ WalkSmem(int h, int R) {
    U = (h + CL - 1) / CL;
    wst = rnn::slice_stride(4 * U);       // ws [round16(h)][wst]
    ds = rnn::grad_stride(R);
    dg = ((h + 15) & ~15) * wst;          // [slice_cols(4U)][ds] the dg
    pb = dg + rnn::slice_cols(4 * U) * ds;  // [2][R][h] partial products
    st = pb + 2 * R * h;                  // [2][6][R U] staged inputs
    dh = st + 12 * R * U;                 // [R U] dL/dh_t of the own units
    dc = dh + R * U;                      // [R U] dL/dc_t
    db = dc + R * U;                      // [7][R U] db7 partials
    b7 = db + 7 * R * U;                  // [7][U] the own units' b7
    len = b7 + 7 * U;                     // [R] int lengths
    total = len + R;
  }
};

size_t walk_smem(int h, int R) {
  return (size_t)WalkSmem(h, R).total * sizeof(float);
}

// B6's cluster route (see the head of this file). dx holds the hoisted
// pre-activations x + h_{t-1} @ w on entry and the gate gradients on exit;
// part_db [clusters][7h].
template <int R>
__global__ void __launch_bounds__(rnn::NTC, 1)
lstm_bwd_cluster_kernel(const float* __restrict__ w,
                        const float* __restrict__ b7,
                        const int* __restrict__ lens,
                        const float* __restrict__ c_seq,
                        const float* __restrict__ dy, float* __restrict__ dx,
                        float* __restrict__ part_db, int B, int T, int h) {
  constexpr int NTC = rnn::NTC;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const WalkSmem L(h, R);
  const int U = L.U, wst = L.wst, ds = L.ds, RU = R * U, h4 = 4 * h;
  const int s = (int)cluster.block_rank();
  const int cid = blockIdx.x / CL, row0 = cid * R;
  const int j0 = s * U, nu = max(0, min(U, h - j0));
  float* ws = smem;                  // w[k][q h + j0 + u] at [k][q U + u]
  float* dgs = smem + L.dg;
  float* pb = smem + L.pb;
  float* stg = smem + L.st;
  float* dhs = smem + L.dh;
  float* dcs = smem + L.dc;
  float* dbs = smem + L.db;
  float* sb = smem + L.b7;
  int* slen = reinterpret_cast<int*>(smem + L.len);

  int maxlen = 0;
#pragma unroll
  for (int r = 0; r < R; ++r)
    maxlen = max(maxlen, row0 + r < B ? lens[row0 + r] : 0);
  // the slice and the gradients, zero past their widths
  for (int i = threadIdx.x; i < L.pb; i += NTC) smem[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < h * 4 * U; i += NTC) {
    const int k = i / (4 * U), c = i % (4 * U), q = c / U, u = c % U;
    if (u < nu) ws[k * wst + c] = w[(size_t)k * h4 + q * h + j0 + u];
  }
  for (int i = threadIdx.x; i < 9 * RU; i += NTC) dhs[i] = 0.f;  // dh dc db
  for (int i = threadIdx.x; i < 7 * U; i += NTC) {
    const int q = i / U, u = i % U;
    sb[i] = u < nu ? b7[q * h + j0 + u] : 0.f;
  }
  for (int r = threadIdx.x; r < R; r += NTC)
    slen[r] = row0 + r < B ? lens[row0 + r] : 0;
  // the inputs of step t into slot t & 1: [6][R U] the pre-activations i, f,
  // g, o, dy and c_{t-1}, of the live (row, unit) pairs
  auto stage = [&](int t) {
    float* sg = stg + (t & 1) * 6 * RU;
    for (int e = threadIdx.x; e < 6 * RU && !kSerialFloor; e += NTC) {
      const int f = e / RU, pr = e % RU, r = pr / U, u = pr % U;
      const int row = row0 + r;
      const float* src = nullptr;
      if (u < nu && row < B && t < lens[row]) {
        const size_t base = (size_t)row * T + t;
        if (f < 4)
          src = dx + base * h4 + f * h + j0 + u;
        else if (f == 4)
          src = dy + base * h + j0 + u;
        else if (t > 0)
          src = c_seq + (base - 1) * h + j0 + u;
      }
      cp_async4(sg + e, src != nullptr ? src : dy, src != nullptr ? 4 : 0);
    }
  };
  // dx of step t (0 on a masked step) from dgs, coalesced along the units
  auto store_dx = [&](int t) {
    for (int e = threadIdx.x; e < 4 * RU && !kSerialFloor; e += NTC) {
      const int q = e / RU, pr = e % RU, r = pr / U, u = pr % U;
      const int row = row0 + r;
      if (u < nu && row < B)
        dx[((size_t)row * T + t) * h4 + q * h + j0 + u] =
            dgs[(q * U + u) * ds + r];
    }
  };
  // every block of the cluster runs and has its shared memory set before
  // any block reads a peer's
  cluster.sync();
  stage(T - 1);
  cp_async_commit();

  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) stage(t - 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // step t's inputs have landed
    const float* sg = stg + (t & 1) * 6 * RU;
    const bool any = kSerialFloor || t < maxlen;
    // the cell backward of the own units into dgs (dx follows from it)
    for (int pr = threadIdx.x; pr < RU && !kSerialFloor; pr += NTC) {
      const int r = pr / U, u = pr % U, row = row0 + r;
      if (u >= nu || row >= B) continue;
      if (t >= slen[r]) {  // masked step: dg = 0, dh and dc carry through
#pragma unroll
        for (int q = 0; q < 4; ++q) dgs[(q * U + u) * ds + r] = 0.f;
        continue;
      }
      const float cp = sg[5 * RU + pr];
      const float wci = sb[4 * U + u], wcf = sb[5 * U + u],
                  wco = sb[6 * U + u];
      const float ig = rnn::sigm(sg[pr] + sb[u] + wci * cp);
      const float fg = rnn::sigm(sg[RU + pr] + sb[U + u] + wcf * cp);
      const float cand = tanhf(sg[2 * RU + pr] + sb[2 * U + u]);
      const float ct = fg * cp + ig * cand;
      const float og = rnn::sigm(sg[3 * RU + pr] + sb[3 * U + u] + wco * ct);
      const float tc = tanhf(ct);
      const float dout = dhs[pr] + sg[4 * RU + pr];
      const float dgo = dout * tc * og * (1.f - og);
      const float dct = dcs[pr] + dout * og * (1.f - tc * tc) + dgo * wco;
      const float dgi = dct * cand * ig * (1.f - ig);
      const float dgf = dct * cp * fg * (1.f - fg);
      const float dgg = dct * ig * (1.f - cand * cand);
      dgs[u * ds + r] = dgi;
      dgs[(U + u) * ds + r] = dgf;
      dgs[(2 * U + u) * ds + r] = dgg;
      dgs[(3 * U + u) * ds + r] = dgo;
      dcs[pr] = dct * fg + dgi * wci + dgf * wcf;
      dbs[pr] += dgi;
      dbs[RU + pr] += dgf;
      dbs[2 * RU + pr] += dgg;
      dbs[3 * RU + pr] += dgo;
      dbs[4 * RU + pr] += dgi * cp;
      dbs[5 * RU + pr] += dgf * cp;
      dbs[6 * RU + pr] += dgo * ct;
    }
    __syncthreads();  // dgs complete
    if (!any) {       // every row past its length: dx = 0, dh carries
      store_dx(t);
      continue;
    }
    // P_s[r][k] = sum over the own columns c of dg[r][c] * w[k][c]
    float* pbt = pb + (t & 1) * R * h;
    if (!kSerialFloor)
      rnn::tile_product<R>(ws, wst, dgs, ds, rnn::slice_cols(4 * U), h, pbt,
                           h, 1);
    rnn::cluster_arrive();  // this block's P of step t is written
    store_dx(t);            // while the peers arrive
    rnn::cluster_wait();
    // dh_{t-1} of the own units: the peers' P summed in rank order
    for (int pr = threadIdx.x; pr < RU; pr += NTC) {
      const int r = pr / U, u = pr % U;
      if (u >= nu || row0 + r >= B || t >= slen[r]) continue;
      const int off = r * h + j0 + u;
      float sum = 0.f;
#pragma unroll
      for (int rk = 0; rk < CL; ++rk)
        sum += cluster.map_shared_rank(pbt, rk)[off];
      dhs[pr] = sum;
    }
  }
  cp_async_wait<0>();
  cluster.sync();  // no block leaves while a peer may read its P
  // db7 partials of the own units, over the rows in order
  for (int i = threadIdx.x; i < 7 * nu; i += NTC) {
    const int q = i / nu, u = i % nu;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) sum += dbs[q * RU + r * U + u];
    part_db[(size_t)cid * 7 * h + q * h + j0 + u] = sum;
  }
}

// B5's cluster walk's shared memory, in floats from the base, at width h
// and R rows a cluster
struct FwdSmem {
  int U, K, wst, ds, shares, gs, hb, gp, st, cs, b7, len, total;
  __host__ __device__ FwdSmem(int h, int R) {
    U = (h + CL - 1) / CL;
    const int M = (4 * U + 15) & ~15;  // the own gate columns, whole tiles
    K = rnn::slice_cols(h);            // the product's depth, zeros past h
    wst = K + 4;                       // a fragment's rows g, columns t
    ds = rnn::grad_stride(R);          // fall in 32 banks
    shares = rnn::k_shares(4 * U, K, R);
    gs = M + 4;
    hb = M * wst;                      // wt [M][wst]; then [2][K][ds] h
    gp = hb + 2 * K * ds;              // [shares][R][gs] the product
    st = gp + shares * R * gs;         // [2][4][R U] staged x
    cs = st + 8 * R * U;               // [2][R U] c
    b7 = cs + 2 * R * U;               // [7][U] the own units' b7
    len = b7 + 7 * U;                  // [R] int lengths
    total = len + R;
  }
};

size_t fwd_cluster_smem(int h, int R) {
  return (size_t)FwdSmem(h, R).total * sizeof(float);
}

// B5's cluster route (see the head of this file); c_out may be null
template <int R>
__global__ void __launch_bounds__(rnn::NTC, 1)
lstm_fwd_cluster_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ b7,
                        const int* __restrict__ lens, float* __restrict__ y,
                        float* __restrict__ c_out, int B, int T, int h) {
  constexpr int NTC = rnn::NTC;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const FwdSmem L(h, R);
  const int U = L.U, ds = L.ds, gs = L.gs, RU = R * U, h4 = 4 * h;
  const int hsize = L.K * ds;
  const int s = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / CL) * R;
  const int j0 = s * U, nu = max(0, min(U, h - j0));
  float* wt = smem;                  // wt[q U + u][k] = w[k][q h + j0 + u]
  float* hb = smem + L.hb;
  float* gp = smem + L.gp;
  float* stg = smem + L.st;
  float* cs = smem + L.cs;
  float* sb = smem + L.b7;
  int* slen = reinterpret_cast<int*>(smem + L.len);

  int live = 0;  // the steps until every row of the cluster is past its length
#pragma unroll
  for (int r = 0; r < R; ++r)
    live = max(live, row0 + r < B ? min(lens[row0 + r], T) : 0);
  // h_{-1} = 0, c_{-1} = 0, and every pad zero
  for (int i = threadIdx.x; i < L.total; i += NTC) smem[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < h * 4 * U; i += NTC) {
    const int k = i / (4 * U), c = i % (4 * U), q = c / U, u = c % U;
    if (u < nu) wt[c * L.wst + k] = w[(size_t)k * h4 + q * h + j0 + u];
  }
  for (int i = threadIdx.x; i < 7 * U; i += NTC) {
    const int q = i / U, u = i % U;
    sb[i] = u < nu ? b7[q * h + j0 + u] : 0.f;
  }
  for (int r = threadIdx.x; r < R; r += NTC)
    slen[r] = row0 + r < B ? lens[row0 + r] : 0;
  // x of step t into slot t & 1: [4][R U] the gates i, f, g, o of the live
  // (row, unit) pairs
  auto stage = [&](int t) {
    float* sg = stg + (t & 1) * 4 * RU;
    for (int e = threadIdx.x; e < 4 * RU && !kSerialFloor; e += NTC) {
      const int q = e / RU, pr = e % RU, r = pr / U, u = pr % U;
      const int row = row0 + r;
      const bool ok = u < nu && row < B && t < lens[row];
      cp_async4(sg + e, ok ? x + ((size_t)row * T + t) * h4 + q * h + j0 + u
                           : x, ok ? 4 : 0);
    }
  };
  // y (0 past len) and c of step t from the slots step t wrote, coalesced
  // along the units
  auto store = [&](int t) {
    const float* hn = hb + ((t + 1) & 1) * hsize;
    const float* cn = cs + ((t + 1) & 1) * RU;
    for (int e = threadIdx.x; e < RU && !kSerialFloor; e += NTC) {
      const int r = e / U, u = e % U, row = row0 + r;
      if (u >= nu || row >= B) continue;
      const size_t o = ((size_t)row * T + t) * h + j0 + u;
      y[o] = t < slen[r] ? hn[(j0 + u) * ds + r] : 0.f;
      if (c_out != nullptr) c_out[o] = cn[e];
    }
  };
  // every block of the cluster runs and is set before any peer pushes into
  // its shared memory
  cluster.sync();
  if (live > 0) stage(0);
  cp_async_commit();

  for (int t = 0; t < live; ++t) {
    const float* hp = hb + (t & 1) * hsize;
    float* hn = hb + ((t + 1) & 1) * hsize;
    if (t + 1 < live) stage(t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // step t's inputs (this thread's copies)
    // G_s[r][q U + u] = sum_k h_{t-1}[r][k] w[k][q h + j0 + u], in shares
    if (!kSerialFloor)
      rnn::tile_product<R>(wt, L.wst, hp, ds, L.K, 4 * U, gp, gs, L.shares);
    __syncthreads();  // the product and step t's inputs are complete
    const float* sg = stg + (t & 1) * 4 * RU;
    const float* cp = cs + (t & 1) * RU;
    float* cn = cs + ((t + 1) & 1) * RU;
    // the cell of the own (row, unit) pairs; past len h and c carry
    for (int pr = threadIdx.x; pr < RU && !kSerialFloor; pr += NTC) {
      const int r = pr / U, u = pr % U, k = (j0 + u) * ds + r;
      if (u >= nu) continue;
      float hv = hp[k], cv = cp[pr];
      if (t < slen[r]) {
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          g[q] = gp[r * gs + q * U + u];
          for (int sh = 1; sh < L.shares; ++sh)
            g[q] += gp[(sh * R + r) * gs + q * U + u];
        }
        const float wci = sb[4 * U + u], wcf = sb[5 * U + u],
                    wco = sb[6 * U + u];
        const float ig = rnn::sigm((sg[pr] + g[0]) + sb[u] + wci * cv);
        const float fg =
            rnn::sigm((sg[RU + pr] + g[1]) + sb[U + u] + wcf * cv);
        const float cand = tanhf((sg[2 * RU + pr] + g[2]) + sb[2 * U + u]);
        const float c = fg * cv + ig * cand;
        const float og =
            rnn::sigm((sg[3 * RU + pr] + g[3]) + sb[3 * U + u] + wco * c);
        hv = og * tanhf(c);
        cv = c;
      }
      hn[k] = hv;
      cn[pr] = cv;
    }
    __syncthreads();  // h_t of the own units is in hn
    rnn::push_to_peers(cluster, hn, j0 * ds, U * ds);
    rnn::cluster_arrive();  // h_t is in every block
    store(t);               // while the peers arrive
    rnn::cluster_wait();
  }
  cp_async_wait<0>();
  // past every row's length: y = 0, c carries (c of the last live step)
  const float* cl = cs + (live & 1) * RU;
  for (int e = threadIdx.x; e < (T - live) * RU && !kSerialFloor; e += NTC) {
    const int t = live + e / RU, pr = e % RU, r = pr / U, u = pr % U;
    const int row = row0 + r;
    if (u >= nu || row >= B) continue;
    const size_t o = ((size_t)row * T + t) * h + j0 + u;
    y[o] = 0.f;
    if (c_out != nullptr) c_out[o] = cl[pr];
  }
}

// ------------------------------------------------------------ grid route
// B5's grid block's shared memory, in floats from the base, at width h, U
// units a block and Bp rows (a multiple of 16); the slice of w only where
// it is resident
struct FwdGrid {
  int K, kst, nc, gps, gp, cs, sb, total;
  __host__ __device__ FwdGrid(int h, int U, int Bp, bool resident) {
    K = rnn::round8(h);              // the product's depth, zeros past h
    kst = rnn::grad_stride(K);
    nc = 4 * U;                      // the own gate columns q U + u
    gps = rnn::round8(nc);
    gp = resident ? nc * kst : 0;    // ws [nc][kst]: w[k][q h + j0 + u]
    cs = gp + Bp * gps;              // gp [Bp][gps]: x_t + the product
    sb = cs + Bp * U;                // cs [Bp][U]: c_{t-1}
    total = sb + 7 * U;              // sb [7][U]: the own units' b7
  }
};

// B6's grid block's shared memory, as FwdGrid's
struct BwdGrid {
  int nc, kst, pg, ps, dh, dc, sb, total;
  __host__ __device__ BwdGrid(int h, int U, int Bp, bool resident) {
    nc = 4 * U;
    kst = rnn::grad_stride(rnn::round8(4 * h));  // ws [U][kst]: w[j0 + u]
    ps = rnn::round8(U);             // pg [Bp][ps]: dg @ w[own, :]^T
    pg = resident ? U * kst : 0;
    dh = pg + Bp * ps;               // dh [Bp][U]: dL/dh_t, own units
    dc = dh + Bp * U;                // dc [Bp][U]: dL/dc_t
    sb = dc + Bp * U;                // sb [7][U]
    total = sb + 7 * U;
  }
};

size_t fwd_grid_smem(int h, int U, int Bp, bool resident) {
  return (size_t)FwdGrid(h, U, Bp, resident).total * sizeof(float);
}

size_t bwd_grid_smem(int h, int U, int Bp, bool resident) {
  return (size_t)BwdGrid(h, U, Bp, resident).total * sizeof(float);
}

// The floats of B5's grid exchange buffers: h, twice [Bp][round8(h)]
long long fwd_exchange_floats(int Bp, int h) {
  return 2LL * Bp * rnn::round8(h);
}

// The floats of B6's grid exchange buffers (both parities): dg [2][Bp][4h]
long long bwd_exchange_floats(int Bp, int h) {
  return 2LL * Bp * rnn::round8(4 * h);
}

// The m-tiles (of 16 rows) a job of B5's per-step product holds (the
// n-tiles follow the gate columns: fwd_grid_kernel), and the m- and
// n-tiles of B6's, over the own units
constexpr int FWD_MG = 2;
constexpr int BWD_MG = 4;
constexpr int BWD_NG = 2;
constexpr int CELL_PAIRS = 4;   // (row, unit) pairs B6's cell loads at once

// B5's grid route (see the head of this file). hbuf [2][Bp][round8(h)] and
// *bar are zero on entry; c_out may be null. RES: w's slice in shared
// memory, else read from L2 each step; NG: the n-tiles of a product job
// (fwd_grid_kernel's choice for the own gate columns' n-tiles).
template <bool RES, int NG>
__global__ void __launch_bounds__(rnn::GT, 1)
lstm_fwd_grid_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b7,
                     const int* __restrict__ lens, float* __restrict__ y,
                     float* __restrict__ c_out, float* hbuf, unsigned* bar,
                     int B, int T, int h, int U) {
  constexpr int GT = rnn::GT;
  extern __shared__ __align__(16) float smem[];
  const int Bp = rnn::round16(B);
  const FwdGrid L(h, U, Bp, RES);
  const int s = blockIdx.x, G = gridDim.x;
  const int j0 = s * U, nu = min(U, h - j0), nc = L.nc, K = L.K;
  const int h4 = 4 * h;
  float* ws = smem;
  float* gp = smem + L.gp;
  float* cs = smem + L.cs;
  float* sb = smem + L.sb;

  int live = 0;  // the steps until every row is past its length
  for (int r = 0; r < B; ++r) live = max(live, min(__ldg(lens + r), T));
  for (int i = threadIdx.x; i < L.total; i += GT) smem[i] = 0.f;
  __syncthreads();
  if constexpr (RES)
    for (int i = threadIdx.x; i < h * nc; i += GT) {
      const int k = i / nc, c = i % nc, q = c / U, u = c % U;
      if (u < nu) ws[c * L.kst + k] = w[(size_t)k * h4 + q * h + j0 + u];
    }
  for (int i = threadIdx.x; i < 7 * nu; i += GT) {
    const int q = i / nu, u = i % nu;
    sb[q * U + u] = b7[q * h + j0 + u];
  }
  // x_t of the own gate columns into gp (0 past len)
  auto stage = [&](int t) {
    for (int e = threadIdx.x; e < B * nc && !kSerialFloor; e += GT) {
      const int r = e / nc, c = e % nc, q = c / U, u = c % U;
      const bool ok = u < nu && t < __ldg(lens + r);
      cp_async4(gp + r * L.gps + c,
                ok ? x + ((size_t)r * T + t) * h4 + q * h + j0 + u : x,
                ok ? 4 : 0);
    }
  };
  // Bt(n, k) = w[k][q h + j0 + u] for the own gate column n = q U + u
  auto wcol = [&](int n, int k) -> float2 {
    if (n >= nc) return make_float2(0.f, 0.f);
    if constexpr (RES) {
      return *reinterpret_cast<const float2*>(ws + n * L.kst + k);
    } else {
      const int q = n / U, u = n % U;
      if (u >= nu) return make_float2(0.f, 0.f);
      const float* col = w + q * h + j0 + u;
      return make_float2(k < h ? __ldg(col + (size_t)k * h4) : 0.f,
                         k + 1 < h ? __ldg(col + (size_t)(k + 1) * h4) : 0.f);
    }
  };
  __syncthreads();
  if (live > 0) stage(0);
  cp_async_commit();

  unsigned passed = 0;
  for (int t = 0; t < live; ++t) {
    const float* hp = hbuf + (size_t)(t & 1) * Bp * K;
    float* hn = hbuf + (size_t)((t + 1) & 1) * Bp * K;
    cp_async_wait<0>();
    __syncthreads();  // x_t has landed in gp
    // gp += h_{t-1} [Bp, K] @ w[:, own] [K, nc], h_{t-1} from L2
    rnn::grid_product_add<kSerialFloor, FWD_MG, NG>(
        gp, L.gps, Bp, nc, K, rnn::GlobalRows{hp, K}, wcol);
    // the cell of the own (row, unit) pairs; past len h and c carry
    for (int pr = threadIdx.x; pr < B * U; pr += GT) {
      const int r = pr / U, u = pr % U, j = j0 + u;
      if (u >= nu) continue;
      if (kSerialFloor) {
        hn[r * K + j] = 0.f;
        continue;
      }
      const size_t o = ((size_t)r * T + t) * h + j;
      const float cv = cs[pr];
      if (t < __ldg(lens + r)) {
        const float* g = gp + r * L.gps;
        const float wci = sb[4 * U + u], wcf = sb[5 * U + u],
                    wco = sb[6 * U + u];
        const float ig = rnn::sigm(g[u] + sb[u] + wci * cv);
        const float fg = rnn::sigm(g[U + u] + sb[U + u] + wcf * cv);
        const float cand = tanhf(g[2 * U + u] + sb[2 * U + u]);
        const float c = fg * cv + ig * cand;
        const float og = rnn::sigm(g[3 * U + u] + sb[3 * U + u] + wco * c);
        const float out = og * tanhf(c);
        cs[pr] = c;
        hn[r * K + j] = out;
        y[o] = out;
        if (c_out != nullptr) c_out[o] = c;
      } else {
        hn[r * K + j] = __ldcg(hp + r * K + j);
        y[o] = 0.f;
        if (c_out != nullptr) c_out[o] = cv;
      }
    }
    if (t + 1 == live) break;
    __syncthreads();  // gp is read: x_{t+1} may land in it
    stage(t + 1);
    cp_async_commit();
    rnn::grid_sync(bar, passed += G);  // h_t of every block is in hn
  }
  cp_async_wait<0>();
  __syncthreads();
  // past every row's length: y = 0, c carries
  for (int e = threadIdx.x; e < (T - live) * B * U && !kSerialFloor;
       e += GT) {
    const int t = live + e / (B * U), pr = e % (B * U), r = pr / U,
              u = pr % U;
    if (u >= nu) continue;
    const size_t o = ((size_t)r * T + t) * h + j0 + u;
    y[o] = 0.f;
    if (c_out != nullptr) c_out[o] = cs[pr];
  }
}

// B6's grid walk (see the head of this file). dx holds the hoisted
// pre-activations x + h_{t-1} @ w on entry and the gate gradients on exit;
// xbuf holds the exchange (bwd_exchange_floats); it and *bar are zero on
// entry. RES as B5's.
template <bool RES>
__global__ void __launch_bounds__(rnn::GT, 1)
lstm_bwd_grid_kernel(const float* __restrict__ w,
                     const float* __restrict__ b7,
                     const int* __restrict__ lens,
                     const float* __restrict__ c_seq,
                     const float* __restrict__ dy, float* __restrict__ dx,
                     float* xbuf, unsigned* bar, int B, int T, int h, int U) {
  constexpr int GT = rnn::GT;
  extern __shared__ __align__(16) float smem[];
  const int Bp = rnn::round16(B);
  const BwdGrid L(h, U, Bp, RES);
  const int s = blockIdx.x, G = gridDim.x;
  const int j0 = s * U, nu = min(U, h - j0), nc = L.nc;
  const int h4 = 4 * h, h4p = rnn::round8(h4);
  float* ws = smem;
  float* pg = smem + L.pg;
  float* dhs = smem + L.dh;
  float* dcs = smem + L.dc;
  float* sb = smem + L.sb;
  const size_t parity = (size_t)Bp * h4p;

  int live = 0;
  for (int r = 0; r < B; ++r) live = max(live, min(__ldg(lens + r), T));
  for (int i = threadIdx.x; i < L.total; i += GT) smem[i] = 0.f;
  __syncthreads();
  if constexpr (RES)
    for (int i = threadIdx.x; i < nu * h4; i += GT) {
      const int u = i / h4, c = i % h4;
      ws[u * L.kst + c] = w[(size_t)(j0 + u) * h4 + c];
    }
  for (int i = threadIdx.x; i < 7 * nu; i += GT) {
    const int q = i / nu, u = i % nu;
    sb[q * U + u] = b7[q * h + j0 + u];
  }
  // past every row's length: dx = 0, no barrier
  for (int e = threadIdx.x; e < (T - live) * B * nc && !kSerialFloor;
       e += GT) {
    const int t = live + e / (B * nc), rc = e % (B * nc), r = rc / nc,
              c = rc % nc, q = c / U, u = c % U;
    if (u < nu) dx[((size_t)r * T + t) * h4 + q * h + j0 + u] = 0.f;
  }
  // Bt(n, k) = w[j0 + n][k] for the own unit n
  auto wslice = [&](int n, int k) -> float2 {
    if (n >= nu) return make_float2(0.f, 0.f);
    if constexpr (RES) {
      return *reinterpret_cast<const float2*>(ws + n * L.kst + k);
    } else {
      const float* row = w + (size_t)(j0 + n) * h4;
      return make_float2(k < h4 ? __ldg(row + k) : 0.f,
                         k + 1 < h4 ? __ldg(row + k + 1) : 0.f);
    }
  };
  __syncthreads();

  unsigned passed = 0;
  for (int t = live - 1; t >= 0; --t) {
    float* xb = xbuf + (t & 1) * parity;
    for (int i = threadIdx.x; i < Bp * L.ps; i += GT) pg[i] = 0.f;
    // the cell backward of the own (row, unit) pairs: dg into dx and into
    // the exchange; past len dg = 0, dh and dc carry.
    // A thread loads the inputs of CELL_PAIRS pairs before it computes
    // any: one round trip to memory, not one a pair.
    for (int p0 = threadIdx.x; p0 < B * U; p0 += CELL_PAIRS * GT) {
      float in[CELL_PAIRS][6];
#pragma unroll
      for (int q = 0; q < CELL_PAIRS; ++q) {
        const int pr = p0 + q * GT, r = pr / U, u = pr % U, j = j0 + u;
        if (kSerialFloor || pr >= B * U || u >= nu || t >= __ldg(lens + r))
          continue;
        const size_t base = (size_t)r * T + t;
        const float* pre = dx + base * h4 + j;
        in[q][0] = pre[0];
        in[q][1] = pre[h];
        in[q][2] = pre[2 * h];
        in[q][3] = pre[3 * h];
        in[q][4] = dy[base * h + j];
        in[q][5] = t > 0 ? c_seq[(base - 1) * h + j] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < CELL_PAIRS; ++q) {
        const int pr = p0 + q * GT, r = pr / U, u = pr % U, j = j0 + u;
        if (pr >= B * U || u >= nu) continue;
        const size_t base = (size_t)r * T + t;
        float dg[4] = {0.f, 0.f, 0.f, 0.f};
        if (!kSerialFloor && t < __ldg(lens + r)) {
          const float cp = in[q][5];
          const float wci = sb[4 * U + u], wcf = sb[5 * U + u],
                      wco = sb[6 * U + u];
          const float ig = rnn::sigm(in[q][0] + sb[u] + wci * cp);
          const float fg = rnn::sigm(in[q][1] + sb[U + u] + wcf * cp);
          const float cand = tanhf(in[q][2] + sb[2 * U + u]);
          const float ct = fg * cp + ig * cand;
          const float og = rnn::sigm(in[q][3] + sb[3 * U + u] + wco * ct);
          const float tc = tanhf(ct);
          const float dout = dhs[pr] + in[q][4];
          const float dgo = dout * tc * og * (1.f - og);
          const float dct =
              dcs[pr] + dout * og * (1.f - tc * tc) + dgo * wco;
          const float dgi = dct * cand * ig * (1.f - ig);
          const float dgf = dct * cp * fg * (1.f - fg);
          const float dgg = dct * ig * (1.f - cand * cand);
          dcs[pr] = dct * fg + dgi * wci + dgf * wcf;
          dg[0] = dgi;
          dg[1] = dgf;
          dg[2] = dgg;
          dg[3] = dgo;
        }
#pragma unroll
        for (int g4 = 0; g4 < 4; ++g4) {
          if (!kSerialFloor) dx[base * h4 + g4 * h + j] = dg[g4];
          xb[r * h4p + g4 * h + j] = dg[g4];
        }
      }
    }
    if (t == 0) break;  // dh_{-1} is not needed
    __syncthreads();    // the own dg is complete
    rnn::grid_sync(bar, passed += G);  // the step's exchange is complete
    // dh_{t-1} of the own units = dg [Bp, 4h] (from L2) @ w[own, :]^T
    rnn::grid_product_add<kSerialFloor, BWD_MG, BWD_NG>(
        pg, L.ps, Bp, U, h4p, rnn::GlobalRows{xb, h4p}, wslice);
    for (int pr = threadIdx.x; pr < B * U; pr += GT) {
      const int r = pr / U, u = pr % U;
      if (u < nu && t < __ldg(lens + r)) dhs[pr] = pg[r * L.ps + u];
    }
    __syncthreads();  // dh is complete
  }
}

// db7's row-chunk partials from the gate gradients: part[chunk][q h + j]
// sums over the chunk's rows of the B*T of dx's gates (q < 4), dg_i
// c_{t-1}, dg_f c_{t-1} and dg_o c_t (dx is 0 on masked steps)
__global__ void lstm_bias_grad_kernel(const float* __restrict__ dx,
                                      const float* __restrict__ c_seq,
                                      float* __restrict__ part, int N, int T,
                                      int h, int rows) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= h) return;
  const int n0 = blockIdx.y * rows, n1 = min(N, n0 + rows);
  const size_t h4 = 4 * (size_t)h;
  float s[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n = n0; n < n1; ++n) {
    const float* d = dx + n * h4 + j;
    const float gi = d[0], gf = d[h], gg = d[2 * h], go = d[3 * h];
    const float cp = n % T != 0 ? c_seq[(size_t)(n - 1) * h + j] : 0.f;
    const float ct = c_seq[(size_t)n * h + j];
    s[0] += gi;
    s[1] += gf;
    s[2] += gg;
    s[3] += go;
    s[4] += gi * cp;
    s[5] += gf * cp;
    s[6] += go * ct;
  }
  float* o = part + (size_t)blockIdx.y * 7 * h + j;
#pragma unroll
  for (int q = 0; q < 7; ++q) o[q * h] = s[q];
}

// db7 [7h] from dx and c over the N = B*T rows, through BIAS_PARTS
// row-chunk partials in part (fixed order)
cudaError_t bias_grad(const float* dx, const float* c, float* part,
                      float* db7, int N, int T, int h, cudaStream_t st) {
  const int rows = rnn::cdiv(N, rnn::BIAS_PARTS < N ? rnn::BIAS_PARTS : N);
  const int parts = rnn::cdiv(N, rows);
  lstm_bias_grad_kernel<<<dim3(rnn::cdiv(h, 128), parts), 128, 0, st>>>(
      dx, c, part, N, T, h, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return rnn::block_sum(part, db7, parts, 7 * h, st);
}

// B5's grid kernel for w's slice resident or not and U units a block
using FwdKern = void (*)(const float*, const float*, const float*,
                         const int*, float*, float*, float*, unsigned*, int,
                         int, int, int);

template <bool RES>
FwdKern fwd_kernel_ng(int ng) {
  switch (ng) {
    case 2: return &lstm_fwd_grid_kernel<RES, 2>;
    case 4: return &lstm_fwd_grid_kernel<RES, 4>;
    case 5: return &lstm_fwd_grid_kernel<RES, 5>;
    default: return &lstm_fwd_grid_kernel<RES, 8>;
  }
}

// a product job of 2, 4, 5 or 8 n-tiles for the 4U gate columns' n-tiles
// (wider: several jobs)
FwdKern fwd_grid_kernel(bool resident, int U) {
  const int ntl = (4 * U + 7) / 8;
  const int ng = ntl <= 2 ? 2 : ntl <= 4 ? 4 : ntl <= 5 ? 5 : 8;
  return resident ? fwd_kernel_ng<true>(ng) : fwd_kernel_ng<false>(ng);
}

using BwdKern = void (*)(const float*, const float*, const int*,
                         const float*, const float*, float*, float*,
                         unsigned*, int, int, int, int);

BwdKern bwd_grid_kernel(bool resident) {
  return resident ? &lstm_bwd_grid_kernel<true> : &lstm_bwd_grid_kernel<false>;
}

// Scratch floats of B6's launch: the db7 partials of either route, dW's
// split-K partials, then the grid route's barrier and exchange (B5's grid
// route: those alone). The offsets of the pieces, in floats.
struct BwdScratch {
  long long part, dw, grid, total;
  BwdScratch(const rnn::Plan& p, int B, int T, int h) {
    part = 0;
    dw = (long long)(B > rnn::BIAS_PARTS ? B : rnn::BIAS_PARTS) * 7 * h;
    grid = (dw + rnn::dw_scratch_floats((long long)B * T, h, 4 * h) + 31) &
           ~31LL;
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
      return &lstm_fwd_cluster_kernel<R>;
    else
      return &lstm_bwd_cluster_kernel<R>;
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

// B5's (lstm_seq_fwd_plan) or B6's (lstm_seq_bwd_plan) route at (B, h) on
// `device` (rnn::plan_entry). Returns a cudaError_t.
extern "C" int lstm_seq_fwd_plan(int B, int h, int device, int request,
                                 int* out) {
  return rnn::plan_entry<Walks>(0, B, h, device, request, out);
}

extern "C" int lstm_seq_bwd_plan(int B, int h, int device, int request,
                                 int* out) {
  return rnn::plan_entry<Walks>(1, B, h, device, request, out);
}

// Floats of scratch lstm_seq_fwd (kind 0) or lstm_seq_bwd needs at (B, T,
// h) on the route `route` asks for on `device` (-1: none takes h).
extern "C" long long lstm_seq_scratch_floats(int kind, int B, int T, int h,
                                             int device, int route) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  rnn::Plan p;
  if (rnn::walk_plan<Walks>(kind, B, h, device, route, &p) != 0 ||
      p.route < 0)
    return -1;
  return kind == 0 ? rnn::grid_floats(p, h, fwd_exchange_floats)
                   : BwdScratch(p, B, T, h).total;
}

// B5. x [B, T, 4h], w [h, 4h], b7 [7h], lens [B] int32 -> y [B, T, h] and,
// when c is not null, the carried cell sequence c [B, T, h], on the route
// `route` asks for (rnn::make_plan), which it writes into *taken (-1: that
// route does not take h, and nothing is launched); scratch of
// lstm_seq_scratch_floats(0, ...) floats. Launches on `stream` of
// `device`; returns the launch's cudaError_t (0 = launched or refused).
extern "C" int lstm_seq_fwd(const float* x, const float* w, const float* b7,
                            const int* lens, float* y, float* c,
                            float* scratch, int B, int T, int h, int route,
                            int* taken, int device, void* stream) {
  rnn::Plan p;
  const int rc = rnn::launch_plan<Walks>(0, B, h, device, route, taken, &p);
  if (rc != 0 || p.route < 0) return rc;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (p.route == 1)
    return (int)rnn::launch_walk<Walks, 0>(p, h, st, x, w, b7, lens, y, c, B,
                                           T, h);
  // the grid route, a launch for every p.rows rows
  unsigned* bar = reinterpret_cast<unsigned*>(scratch);
  float* hbuf = scratch + rnn::GRID_HEAD;
  const size_t h4 = 4 * (size_t)h;
  return (int)rnn::grid_launches(
      p, B, h, scratch, fwd_exchange_floats, st, [&](int r0, int rows) {
        const size_t off = (size_t)r0 * T;
        float* cr = c != nullptr ? c + off * h : nullptr;
        return rnn::launch_grid(
            fwd_grid_kernel(!p.streamed, p.units), p.blocks,
            fwd_grid_smem(h, p.units, rnn::round16(rows), !p.streamed), st,
            x + off * h4, w, b7, lens + r0, y + off * h, cr, hbuf, bar, rows,
            T, h, p.units);
      });
}

// B6. Inputs as B5's plus y, c and dy [B, T, h]; writes dx [B, T, 4h],
// dw [h, 4h] and db7 [7h], on the route `route` asks for, written into
// *taken as B5's is; scratch of lstm_seq_scratch_floats(1, ...) floats.
extern "C" int lstm_seq_bwd(const float* x, const float* w, const float* b7,
                            const int* lens, const float* y, const float* c,
                            const float* dy, float* dx, float* dw, float* db7,
                            float* scratch, int B, int T, int h, int route,
                            int* taken, int device, void* stream) {
  rnn::Plan p;
  const int rc = rnn::launch_plan<Walks>(1, B, h, device, route, taken, &p);
  if (rc != 0 || p.route < 0) return rc;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const BwdScratch S(p, B, T, h);
  float* part = scratch + S.part;
  float* dw_part = scratch + S.dw;
  // every step's x + h_{t-1} @ w (h_{t-1} = y shifted by one) into dx
  cudaError_t err = rnn::pre_gemm<rnn::EPI_PRE>(
      y, h, T, w, 4 * h, x, 4 * h, nullptr, dx, 4 * h, B * T, 4 * h, h,
      nullptr, nullptr, h, st);
  if (err != cudaSuccess) return (int)err;
  if (p.route == 1) {
    err = rnn::launch_walk<Walks, 1>(p, h, st, w, b7, lens, c, dy, dx, part,
                                     B, T, h);
    if (err != cudaSuccess) return (int)err;
    err = rnn::block_sum(part, db7, p.blocks, 7 * h, st);
  } else {
    unsigned* bar = reinterpret_cast<unsigned*>(scratch + S.grid);
    float* xbuf = scratch + S.grid + rnn::GRID_HEAD;
    const size_t h4 = 4 * (size_t)h;
    err = rnn::grid_launches(
        p, B, h, scratch + S.grid, bwd_exchange_floats, st,
        [&](int r0, int rows) {
          const size_t off = (size_t)r0 * T;
          return rnn::launch_grid(
              bwd_grid_kernel(!p.streamed), p.blocks,
              bwd_grid_smem(h, p.units, rnn::round16(rows), !p.streamed), st,
              w, b7, lens + r0, c + off * h, dy + off * h, dx + off * h4,
              xbuf, bar, rows, T, h, p.units);
        });
    if (err != cudaSuccess) return (int)err;
    err = bias_grad(dx, c, part, db7, B * T, T, h, st);
  }
  if (err != cudaSuccess) return (int)err;
  // dW = sum over the B*T rows of h_{t-1}^T dg, h_{t-1} = y shifted by one
  return (int)rnn::weight_grad(y, h, T, dx, 4 * h, dw, dw_part, B * T, h,
                               4 * h, st);
}

extern "C" const char* lstm_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
