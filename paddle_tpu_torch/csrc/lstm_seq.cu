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
// The walk route of B5 and B6 (h past the cluster routes' reach). The TPU
// kernel's grid is (batch blocks, time blocks) with the h/c carry in VMEM
// across the sequential time blocks. Here one block owns BB batch rows and
// walks the whole sequence itself: h_{t-1} (double-buffered) and c_{t-1} of
// its rows live in shared memory, and each step computes the rows' [BB, h] @
// [h, 4h] product with w read from device memory (L2 holds it: 1 MB at h =
// 256, 26 MB at h = 1280). A thread owns hidden units j, j + 256, ...: it
// accumulates the four gate columns of unit j for all BB rows in registers,
// so the gate math needs no exchange, and one __syncthreads a step
// publishes the new h. The walk backward recomputes the gates in the walk
// (phase A, thread per unit) and forms dh_{t-1} = dg @ w^T (phase B, a warp
// per unit k, w's row k read coalesced); dc stays in shared memory. Each
// step of a block reads all of w from L2 twice (per SM ~64 B/clock).
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
using rnn::NT;
using rnn::NW;

#ifdef RNN_SERIAL_FLOOR
constexpr bool kSerialFloor = true;   // the walk without cells or products
#else
constexpr bool kSerialFloor = false;
#endif

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

// The two cluster walks of this file, for rnn_common.cuh's route rule and
// launches
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
  static int walk_rows(int kind, int h) { return block_rows(kind, h); }
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

// Floats of scratch lstm_seq_bwd needs on either route: the db7 partials
// of at most B blocks or clusters, then the split-K partials of dw.
extern "C" long long lstm_seq_bwd_scratch_floats(int B, int T, int h) {
  return (long long)B * 7 * h +
         rnn::dw_scratch_floats((long long)B * T, h, 4 * h);
}

// B5. x [B, T, 4h], w [h, 4h], b7 [7h], lens [B] int32 -> y [B, T, h] and,
// when c is not null, the carried cell sequence c [B, T, h], on the route
// `route` asks for (rnn::make_plan), which it writes into *taken (-1: that
// route does not take h, and nothing is launched). Launches on `stream` of
// `device`; returns the launch's cudaError_t (0 = launched or refused).
extern "C" int lstm_seq_fwd(const float* x, const float* w, const float* b7,
                            const int* lens, float* y, float* c, int B, int T,
                            int h, int route, int* taken, int device,
                            void* stream) {
  rnn::Plan p;
  const int rc = rnn::launch_plan<Walks>(0, B, h, device, route, taken, &p);
  if (rc != 0 || p.route < 0) return rc;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (p.route == 1)
    return (int)rnn::launch_walk<Walks, 0>(p, h, st, x, w, b7, lens, y, c, B,
                                           T, h);
  switch (p.rows) {
    case 8: return (int)launch_fwd<8>(x, w, b7, lens, y, c, B, T, h, st);
    case 4: return (int)launch_fwd<4>(x, w, b7, lens, y, c, B, T, h, st);
    case 2: return (int)launch_fwd<2>(x, w, b7, lens, y, c, B, T, h, st);
    case 1: return (int)launch_fwd<1>(x, w, b7, lens, y, c, B, T, h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// B6. Inputs as B5's plus y, c and dy [B, T, h]; writes dx [B, T, 4h],
// dw [h, 4h] and db7 [7h], on the route `route` asks for, written into
// *taken as B5's is.
extern "C" int lstm_seq_bwd(const float* x, const float* w, const float* b7,
                            const int* lens, const float* y, const float* c,
                            const float* dy, float* dx, float* dw, float* db7,
                            float* scratch, int B, int T, int h, int route,
                            int* taken, int device, void* stream) {
  rnn::Plan p;
  const int rc = rnn::launch_plan<Walks>(1, B, h, device, route, taken, &p);
  if (rc != 0 || p.route < 0) return rc;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  float* part = scratch;
  float* dw_part = scratch + (size_t)B * 7 * h;
  if (p.route == 1) {
    // every step's x + h_{t-1} @ w (h_{t-1} = y shifted by one) into dx
    err = rnn::pre_gemm<rnn::EPI_PRE>(y, h, T, w, 4 * h, x, 4 * h, nullptr,
                                      dx, 4 * h, B * T, 4 * h, h, nullptr,
                                      nullptr, h, st);
    if (err != cudaSuccess) return (int)err;
    err = rnn::launch_walk<Walks, 1>(p, h, st, w, b7, lens, c, dy, dx, part,
                                     B, T, h);
  } else {
    switch (p.rows) {
      case 8: err = launch_bwd<8>(x, w, b7, lens, y, c, dy, dx, part, B, T, h, st); break;
      case 4: err = launch_bwd<4>(x, w, b7, lens, y, c, dy, dx, part, B, T, h, st); break;
      case 2: err = launch_bwd<2>(x, w, b7, lens, y, c, dy, dx, part, B, T, h, st); break;
      case 1: err = launch_bwd<1>(x, w, b7, lens, y, c, dy, dx, part, B, T, h, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return (int)err;
  err = rnn::block_sum(part, db7, p.blocks, 7 * h, st);
  if (err != cudaSuccess) return (int)err;
  // dW = sum over the B*T rows of h_{t-1}^T dg, h_{t-1} = y shifted by one
  return (int)rnn::weight_grad(y, h, T, dx, 4 * h, dw, dw_part, B * T, h,
                               4 * h, st);
}

extern "C" const char* lstm_seq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
