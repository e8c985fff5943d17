// Flash-attention forward for Hopper (sm_90a): the f32 form, f32 accuracy
// on the tensor cores, then the bf16 form of the AMP rule (its own section
// below, "the bf16 form").
//
// Replaces the TPU kernel behind paddle_tpu/parallel/ring.py::_pallas_flash
// (jax.experimental.pallas.ops.tpu.flash_attention, forward). It computes
// what ring.py::_blocked_fwd defines, not a block-by-block copy of the TPU
// kernel:
//
//   q [B,Tq,H,D], k/v [B,Tk,H,D] contiguous f32 (the JAX package's layout)
//   out[b,i,h,:] = softmax_j(scale * q[b,i,h,:] . k[b,j,h,:]) @ v[b,:,h,:]
//   lse[b,h,i]   = m + log(sum_j exp(s_ij - m))
//
// over the keys row i may see: j < kv_len[b], j <= i when causal, and no
// key at all for a row i >= q_len[b]. Masked positions are excluded
// explicitly (p = 0), never through exp(NEG_INF - m). A row with no visible
// key gets out = 0 and lse = +1e30, the rule of ring.py:155-158.
//
// What bounds it on one H100 SXM: 4*D*H flops a visible (query, key) pair
// (Q.K^T and P.V), done as three TF32 passes on the tensor cores (495
// TFLOP/s dense): at the served prefill shape (B=1, H=4, T=1024, D=64,
// causal) ~3.3 us, against ~1.25 us for q, k, v, out and lse at 3.35 TB/s.
// That shape has only 16 query tiles x 4 heads, so it is bound by the
// latency of its longest tile (16 key tiles in a row) well before either.
//
// Design:
// - One block per (h, b, 64-query tile). A warp owns 16 query rows of one key
//   group. Where the grid would not put two blocks on every SM and D <= 64
//   (shared memory), two groups of 4 warps take the key tiles in turn, each
//   with its own running max, sum and output, merged in order at the end:
//   that halves the longest chain of tiles a warp walks, which bounds the
//   served shape. Otherwise one group. The grid puts the
//   query tile on its slowest axis and, when causal, reverses it, so the
//   heaviest tiles (the most keys) are dispatched first.
// - 3xTF32 on mma.sync m16n8k8 (tf32_mma.cuh): each operand x is split into
//   hi = tf32(x) and lo = tf32(x - hi), and hi*hi' + hi*lo' + lo*hi' is
//   accumulated in f32. Q is split once a block into hi/lo arrays in shared
//   memory; K, V and P are split as their fragments are read, by integer
//   ops (split_tf32_alu) rather than cvt, which runs at a quarter rate.
// - S = Q.K^T: A = Q (k = D contiguous), B = K as it lies (D contiguous a
//   key). P.V without a trip through shared memory: the f32 accumulator of S
//   holds keys (2t, 2t+1) of rows g and g+8, and the A fragment of P.V wants
//   k = t and t+4. P.V sums over keys, so inside each group of 8 keys A's
//   k = t stands for key 2t and k = t+4 for key 2t+1, and V's B fragment is
//   read at the same permuted rows: P goes from the softmax into the mma
//   with no shuffle. Shared rows are padded to D+4 floats, so the Q, K (row
//   g, column t) and V (row 2t or 2t+1, column g) fragment reads are free of
//   bank conflicts.
// - The online softmax runs on fragment rows: a row's max takes two quad
//   shuffles a key tile; its sum is kept a thread and reduced once at the
//   end. Only tiles that cross a mask (the diagonal tile, kv_len, q_len)
//   test each (row, key) pair; a causal tile stops at its last visible key.
// - Each key tile's P.V goes into a fresh accumulator that is added, in
//   round-to-nearest f32, to the output scaled by the max's correction: the
//   tensor cores' truncating adds then never chain over more than one tile.
// - K and V arrive through a two-stage cp.async ring of tile sets (a tile a
//   key group; 16-byte copies); rows at or past kv_len are zero-filled
//   (source size 0). The next set's copies are in flight while this set's
//   mma run.
// - No atomics, a fixed order: bit-identical from run to run.
//
// wgmma would take Q.K^T (both operands K-major) but not P.V: TF32 wgmma
// needs V K-major, i.e. transposed in shared memory. Later work.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "flash_dsplit.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int BLOCK_M = 64;              // query rows a block
constexpr int BLOCK_N = 64;              // keys a shared-memory tile
constexpr int WARPS = BLOCK_M / 16;      // a warp owns 16 query rows ...
constexpr int STAGES = 2;                // K/V tile sets in flight
constexpr int NT = BLOCK_N / 8;          // S's mma tiles a warp (keys)

// ... of one key group: KG groups of WARPS warps take the key tiles in turn
// (group g tiles g, g + KG, ...), each with its own running max, sum and
// output, merged at the end. Two groups halve the longest chain of tiles a
// warp walks, where the grid is too small to fill the card and D <= 64
// (shared memory).
constexpr int SM_COUNT = 132;            // H100 SXM
template <int D, int KG_>
struct Cfg {
  static constexpr int KG = KG_;
  static constexpr int THREADS = 32 * WARPS * KG;
  static constexpr int LD = D + 4;            // row stride of Q, K, V
  static constexpr int Q = BLOCK_M * LD;      // Q hi (then lo), as TF32 bits
  static constexpr int KV = KG * BLOCK_N * LD;  // K (then V) of a stage
  static constexpr size_t BYTES = sizeof(float) * (2 * Q + STAGES * 2 * KV);
};

template <int D, int KG_>
__global__ void __launch_bounds__(Cfg<D, KG_>::THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ kv_len,
                 const int* __restrict__ q_len, int Tq, int Tk, int H,
                 int causal, float scale) {
  using C = Cfg<D, KG_>;
  constexpr int LD = C::LD, KG = C::KG, THREADS = C::THREADS;
  constexpr int DT = D / 8;          // P.V's mma tiles a warp (head dims)
  constexpr int DH = DT <= 8 ? DT : DT / 2;   // ... of one pass over P
  extern __shared__ __align__(16) float smem[];
  unsigned* qhi = reinterpret_cast<unsigned*>(smem);
  unsigned* qlo = qhi + C::Q;
  float* ring = smem + 2 * C::Q;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tile = causal ? (int)gridDim.z - 1 - (int)blockIdx.z
                          : (int)blockIdx.z;
  const int q0 = tile * BLOCK_M;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp / WARPS;                  // the warp's key group
  const int rw = (warp % WARPS) * 16;            // the warp's first row
  const int qi[2] = {q0 + rw + g, q0 + rw + g + 8};

  const int klen = kv_len ? min(max(kv_len[b], 0), Tk) : Tk;
  const int qlen = q_len ? min(max(q_len[b], 0), Tq) : Tq;
  // keys any row of this tile may see
  int kend = klen;
  if (causal) kend = min(kend, q0 + BLOCK_M);
  if (q0 >= qlen) kend = 0;
  const int ntiles = (kend + BLOCK_N - 1) / BLOCK_N;
  const int nsets = (ntiles + KG - 1) / KG;      // KG tiles a set

  const int ld = H * D;                          // a token's row in q, k, v
  const float* kb = k + ((size_t)b * Tk * H + h) * D;
  const float* vb = v + ((size_t)b * Tk * H + h) * D;
  auto load = [&](int j) {          // the set of tiles j * KG, ...
    float* st = ring + (j % STAGES) * 2 * C::KV;
    load_window<KG * BLOCK_N, D, 4, THREADS>(st, LD, kb, ld,
                                             j * KG * BLOCK_N, klen, 0, D);
    load_window<KG * BLOCK_N, D, 4, THREADS>(st + C::KV, LD, vb, ld,
                                             j * KG * BLOCK_N, klen, 0, D);
  };
  if (nsets > 0) load(0);
  cp_async_commit();

  // Q of the tile, split once into TF32 hi and lo (rows past Tq: zeros)
  const float* qb = q + ((size_t)b * Tq * H + h) * D;
  for (int e = threadIdx.x; e < BLOCK_M * D / 4; e += THREADS) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Tq)
      x = *reinterpret_cast<const float4*>(qb + (size_t)(q0 + r) * ld + c);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_tf32_alu(xs[i], qhi[r * LD + c + i], qlo[r * LD + c + i]);
  }

  float o[1][DT][4];                 // the rows' unnormalised output
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running max, rows g, g+8
  float l[2] = {0.f, 0.f};           // the thread's part of the row sums
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[0][n][c] = 0.f;

  for (int j = 0; j < nsets; ++j) {
    __syncthreads();                 // every warp is done with set j - 1
    if (j + 1 < nsets) load(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                 // set j (and Q) visible to all
    const int tile_j = j * KG + grp;   // this warp's tile of the set
    if (tile_j >= ntiles) continue;
    const float* ks =
        ring + (j % STAGES) * 2 * C::KV + grp * BLOCK_N * LD;
    const float* vs = ks + C::KV;
    const int k0 = tile_j * BLOCK_N;

    // S = Q.K^T for the warp's 16 rows and the tile's 64 keys
    float s[1][NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[0][n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      unsigned ahi[1][4], alo[1][4], bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int x = 0; x < 4; ++x) {   // (row g + 8 (x & 1), col t + 4 (x >> 1))
        const int at = (rw + g + 8 * (x & 1)) * LD + kk + t + 4 * (x >> 1);
        ahi[0][x] = qhi[at];
        alo[0][x] = qlo[at];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int x = 0; x < 2; ++x)   // key 8n + g, dim kk + t + 4x
          split_tf32_alu(ks[(8 * n + g) * LD + kk + t + 4 * x], bhi[n][x],
                     blo[n][x]);
      mma3_step<1, NT>(s, ahi, alo, bhi, blo);
    }

    // the online softmax on the fragment rows g (c 0, 1) and g + 8 (c 2, 3)
    const bool masked = !(k0 + BLOCK_N <= klen && q0 + BLOCK_M <= qlen &&
                          (!causal || k0 + BLOCK_N - 1 <= q0));
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[0][n][c] * scale;
        if (masked) {
          const int key = k0 + 8 * n + 2 * t + (c & 1);
          const int row = qi[c >> 1];
          if (!(row < qlen && key < klen && (!causal || key <= row)))
            x = -CUDART_INF_F;
        }
        s[0][n][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // 0 on the row's first visible tile; 1 while it has seen no key
      corr[r] = m_new == -CUDART_INF_F ? 1.f : expf(m[r] - m_new);
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = s[0][n][c];
        const float p = x == -CUDART_INF_F ? 0.f : expf(x - m[c >> 1]);
        s[0][n][c] = p;
        psum[c >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];

    // this tile's P.V in a fresh accumulator, keys permuted in groups of 8,
    // DH of the head dims' mma tiles at a time (registers)
#pragma unroll
    for (int d0 = 0; d0 < DT; d0 += DH) {
      float ot[1][DH][4];
#pragma unroll
      for (int n = 0; n < DH; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) ot[0][n][c] = 0.f;
#pragma unroll
      for (int kg = 0; kg < NT; ++kg) {
        unsigned ahi[1][4], alo[1][4], bhi[DH][2], blo[DH][2];
        // A (row, k): k = t is key 2t (c0 / c2), k = t + 4 is key 2t + 1
        split_tf32_alu(s[0][kg][0], ahi[0][0], alo[0][0]);
        split_tf32_alu(s[0][kg][2], ahi[0][1], alo[0][1]);
        split_tf32_alu(s[0][kg][1], ahi[0][2], alo[0][2]);
        split_tf32_alu(s[0][kg][3], ahi[0][3], alo[0][3]);
#pragma unroll
        for (int n = 0; n < DH; ++n)
#pragma unroll
          for (int x = 0; x < 2; ++x)   // key 8kg + 2t + x, dim 8(d0+n) + g
            split_tf32_alu(vs[(8 * kg + 2 * t + x) * LD + 8 * (d0 + n) + g],
                       bhi[n][x], blo[n][x]);
        mma3_step<1, DH>(ot, ahi, alo, bhi, blo);
      }
#pragma unroll
      for (int n = 0; n < DH; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[0][d0 + n][c] = fmaf(o[0][d0 + n][c], corr[c >> 1], ot[0][n][c]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (KG > 1) {
    // groups 1.. hand their max, sum and output to group 0 through the
    // ring, [value][thread of the group], and group 0 merges them in order
    constexpr int GT = 32 * WARPS;
    const int me = threadIdx.x % GT;
    __syncthreads();                 // the ring is free
    if (grp > 0) {
      float* c = ring + (grp - 1) * (DT * 4 + 4) * GT;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        c[r * GT + me] = m[r];
        c[(2 + r) * GT + me] = l[r];
      }
#pragma unroll
      for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[(4 + n * 4 + e) * GT + me] = o[0][n][e];
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int k = 1; k < KG; ++k) {
      const float* c = ring + (k - 1) * (DT * 4 + 4) * GT;
      float ca[2], cb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mb = c[r * GT + me];
        const float m_new = fmaxf(m[r], mb);
        // a group that saw no key of the row adds nothing (its l, o are 0)
        ca[r] = m[r] == -CUDART_INF_F ? 0.f : expf(m[r] - m_new);
        cb[r] = mb == -CUDART_INF_F ? 0.f : expf(mb - m_new);
        l[r] = l[r] * ca[r] + c[(2 + r) * GT + me] * cb[r];
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[0][n][e] = fmaf(o[0][n][e], ca[e >> 1],
                            c[(4 + n * 4 + e) * GT + me] * cb[e >> 1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= Tq) continue;
    const bool alive = l[r] > 0.f;
    float* orow = out + ((size_t)(b * Tq + qi[r]) * H + h) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      float2 x = make_float2(0.f, 0.f);
      if (alive) {
        x.x = o[0][n][2 * r] / l[r];
        x.y = o[0][n][2 * r + 1] / l[r];
      }
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t) = x;
    }
    if (t == 0)
      lse[((size_t)b * H + h) * Tq + qi[r]] =
          alive ? m[r] + logf(l[r]) : 1e30f;
  }
}

template <int D, int KG>
cudaError_t launch_kg(const float* q, const float* k, const float* v,
                      float* out, float* lse, const int* kv_len,
                      const int* q_len, int B, int Tq, int Tk, int H,
                      int causal, float scale, cudaStream_t stream) {
  using C = Cfg<D, KG>;
  constexpr size_t smem = C::BYTES;
  static_assert(smem <= 232448, "shared memory of a block");
  static_assert((KG - 1) * (D / 2 + 4) * 32 * WARPS <= STAGES * 2 * C::KV,
                "the key groups' merge fits in the ring");
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, KG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Tq + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_kernel<D, KG><<<grid, C::THREADS, smem, stream>>>(
      q, k, v, out, lse, kv_len, q_len, Tq, Tk, H, causal, scale);
  return cudaGetLastError();
}

// two key groups where D <= 64 and one-group blocks would not put two
// blocks on every SM
template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, float* lse, const int* kv_len,
                   const int* q_len, int B, int Tq, int Tk, int H,
                   int causal, float scale, cudaStream_t stream) {
  const long long blocks = (long long)B * H * ((Tq + BLOCK_M - 1) / BLOCK_M);
  if (D <= 64 && blocks < 2 * SM_COUNT)
    return launch_kg<D, D <= 64 ? 2 : 1>(q, k, v, out, lse, kv_len, q_len,
                                         B, Tq, Tk, H, causal, scale, stream);
  return launch_kg<D, 1>(q, k, v, out, lse, kv_len, q_len, B, Tq, Tk, H,
                         causal, scale, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. D is 32, 64, 96 or 128 (the
// wrapper pads any other D <= 128 with zero columns), or a multiple of 64
// above 128 (the D-split; the wrapper pads to it); q, k, v 16-byte
// aligned. kv_len and q_len may be null (no mask). Launches on `stream` of
// `device`, does not synchronise, and returns the launch's cudaError_t
// (0 = launched).
extern "C" int flash_attn_fwd(const float* q, const float* k, const float* v,
                              float* out, float* lse, const int* kv_len,
                              const int* q_len, int B, int Tq, int Tk, int H,
                              int D, int causal, float scale, int device,
                              void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || B > 65535 ||
      (Tq + BLOCK_M - 1) / BLOCK_M > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      err = launch<32>(q, k, v, out, lse, kv_len, q_len, B, Tq, Tk, H,
                       causal, scale, st);
      break;
    case 64:
      err = launch<64>(q, k, v, out, lse, kv_len, q_len, B, Tq, Tk, H,
                       causal, scale, st);
      break;
    case 96:
      err = launch<96>(q, k, v, out, lse, kv_len, q_len, B, Tq, Tk, H,
                       causal, scale, st);
      break;
    case 128:
      err = launch<128>(q, k, v, out, lse, kv_len, q_len, B, Tq, Tk, H,
                        causal, scale, st);
      break;
    default:   // D > 128, a multiple of 64: the D-split (flash_dsplit.cuh)
      err = dsplit::launch_fwd<dsplit::F32>(q, k, v, out, lse, kv_len, q_len,
                                            B, Tq, Tk, H, D, causal, scale,
                                            st);
  }
  return (int)err;
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ============================================================ the bf16 form
// The same function on bf16 q, k, v and out (lse f32), with the library
// kernel's roundings (jax/experimental/pallas/ops/tpu/flash_attention.py,
// which the JAX package runs in q's dtype under the AMP rule): S = Q.K^T
// from bf16 operands in f32; p = exp(s - m_running) in f32, its row sum in
// f32, p rounded to bf16 before P.V; out summed in f32, divided by the sum
// and rounded to bf16 once. ops/flash_attention.py::attention_plain_bf16
// states it; it rounds p against the row's final max, so the two agree to
// about a bf16 ulp of out, not bit for bit.
//
// What bounds it on one H100 SXM: 4*D*H flops a visible pair on the
// tensor cores' bf16 rate (989 TFLOP/s dense), one pass: at the
// long-context trainer's shape (B=4, T=4096, H=8, D=64, causal) 68.7
// GFLOP, ~0.069 ms, against ~0.020 ms for q, k, v, out and lse at 3.35
// TB/s.
//
// Design (hopper_wgmma.cuh has the pieces and the tile layouts; the
// choices below were timed in turns on one H100 by fwd_kernels_probe.py):
// - One block per (h, b, 128-query tile), three warpgroups: two consumers
//   of 64 query rows each and a producer, which hands its registers to
//   them (setmaxnreg: 240 a consumer thread); one block an SM. The
//   heaviest causal tiles (the most keys) are dispatched first.
// - One producer thread issues TMA loads through tensor maps over
//   [B, T, H, D] (row stride H * D, swizzled as wgmma reads them): Q
//   once, then the key tiles' K and V (128 keys at every D: 64 were
//   slower, and 192 too) into a ring of four stages at D <= 64 (three at
//   128, for shared memory; three were 5% slower at D = 64), with a full
//   and an empty mbarrier a stage. A tile past the diagonal or past
//   kv_len is never loaded.
// - S = Q.K^T: wgmma m64n128k16 with B (K as it lies) K-major in shared
//   memory and A the warpgroup's Q rows, loaded once into registers by
//   ldmatrix at D <= 64 (6% faster than A from shared memory), from
//   shared memory at D = 128 (registers).
// - The online softmax runs on the accumulator's rows in f32: the running
//   max m is kept of s * scale * log2(e), and p = 2^(s * c - m) is one FFMA
//   and one MUFU.EX2 (c = scale * log2(e)); lse = (m + log2 l) * ln 2. A
//   row's max and sum are taken as four partials. Only tiles that cross a
//   mask (the diagonal, kv_len, q_len) test each pair, which gives p = 0 by
//   selection, never through exp of -inf.
// - O += P.V: P is packed by cvt.rn.bf16x2 straight from S's accumulators
//   into wgmma's register A fragment (the library's rounding of p); V as it
//   lies is B, MN-major: wgmma m64nDk16 with A from registers.
// - Within a warpgroup, tile j's S is issued before tile j - 1's P.V, and
//   tile j's softmax runs while that product is in flight; the first S and
//   the last P.V are peeled off the loop, so that no product is issued
//   under a branch (ptxas serialises wgmma on a divergent path, and the
//   waits and arrivals keep their loops and predicates inside the asm for
//   that reason). The two warpgroups run in step: making them take turns
//   to issue their products (FlashAttention-3's ping-pong) was 33% slower.
// - TMA fills rows past T with zeros but not rows past kv_len, which may
//   hold anything (NaN too): on the tile that crosses kv_len each
//   warpgroup zeroes V's rows from kv_len before P.V (K's give s that the
//   mask replaces).
// - No atomics, a fixed order: bit-identical from run to run.
// D = 96 is not instantiated: ops/flash_attention.py pads it to 128. D > 128
// runs the D-split of flash_dsplit.cuh.

#include "hopper_wgmma.cuh"

namespace {

// S's A operand (the warpgroup's Q rows) from registers (at D = 128 they
// would not fit beside O: from shared memory)
template <int D>
constexpr bool Q_REGS = D <= 64;

template <int D>
struct FwdWg {
  static constexpr int BM = 128;                   // query rows a block
  static constexpr int BN = 128;                   // keys a tile
  static constexpr int STAGES = D <= 64 ? 4 : 3;   // shared memory
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;      // K or V of a stage
  static constexpr int RING = Q_BYTES;             // offsets in the block
  static constexpr int BARS = RING + STAGES * 2 * KV_BYTES;
  static constexpr size_t BYTES = wg_smem(BARS + 8 * (1 + 2 * STAGES) + 1024);
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ out, float* __restrict__ lse,
                       const int* __restrict__ kv_len,
                       const int* __restrict__ q_len, int Tq, int Tk, int H,
                       int causal, float c) {
  using C = FwdWg<D>;
  constexpr int BM = C::BM, BN = C::BN, STAGES = C::STAGES;
  constexpr int AC = atom_cols(D);
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* sm = align1024(smem_wg);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tile = causal ? (int)gridDim.z - 1 - (int)blockIdx.z
                          : (int)blockIdx.z;
  const int q0 = tile * BM;
  const int klen = warp_uniform(kv_len ? min(max(kv_len[b], 0), Tk) : Tk);
  const int qlen = warp_uniform(q_len ? min(max(q_len[b], 0), Tq) : Tq);
  int kend = klen;                       // keys any row of the block sees
  if (causal) kend = min(kend, q0 + BM);
  if (q0 >= qlen) kend = 0;
  const int ntiles = (kend + BN - 1) / BN;

  init_ring(q_full, STAGES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wgi = warp_uniform(threadIdx.x >> 7);   // the warpgroup

  if (wgi == 2) {       // the producer
    producer_regs();
    if (warp != WG_CONSUMER_WARPS || lane != 0 || ntiles == 0) return;
    mbar_expect_tx(q_full, C::Q_BYTES);
    for (int a = 0; a < D / AC; ++a)
      tma_load(sm + a * BM * 2 * AC, &tq, q_full, a * AC, h, q0, b);
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(empty + s, ((j / STAGES) & 1) ^ 1);
      mbar_expect_tx(full + s, 2 * C::KV_BYTES);
      unsigned char* ks = sm + C::RING + s * 2 * C::KV_BYTES;
      for (int a = 0; a < D / AC; ++a) {
        tma_load(ks + a * BN * 2 * AC, &tk, full + s, a * AC, h, j * BN, b);
        tma_load(ks + C::KV_BYTES + a * BN * 2 * AC, &tv, full + s, a * AC,
                 h, j * BN, b);
      }
    }
    return;
  }
  consumer_regs();

  // a consumer warpgroup: rows qw0.. of the block, this thread's rows
  // row[0] (accumulator entries 4n, 4n + 1) and row[1] (4n + 2, 4n + 3)
  const int wg = wgi, tid = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + 64 * wg;
  const int row[2] = {qw0 + 16 * (warp & 3) + g,
                      qw0 + 16 * (warp & 3) + g + 8};
  const unsigned qs = smem_u32(sm);
  auto vtile = [&](int j) {              // V of key tile j
    return smem_u32(sm + C::RING + (j % STAGES) * 2 * C::KV_BYTES +
                    C::KV_BYTES);
  };
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running max of s * c
  float l[2] = {0.f, 0.f};               // the thread's part of the sums
  float sc[BN / 2];                      // S, then P: 64 rows x BN keys
  unsigned pa[BN / 16][4];               // P of the previous tile, bf16

  // key tile j arrived; V's rows from kv_len zeroed
  auto arrived = [&](int j) {
    mbar_wait(full + j % STAGES, (j / STAGES) & 1);
    if (j * BN + BN > klen) {
      zero_rows<D, BN>(sm + C::RING + (j % STAGES) * 2 * C::KV_BYTES +
                           C::KV_BYTES,
                       klen - j * BN, tid);
      named_sync(1 + wg, 128);
    }
  };
  // at D <= 64 the warpgroup's Q rows stay in registers as A fragments
  // (a third fewer shared-memory reads of S)
  unsigned qa[Q_REGS<D> ? D / 16 : 1][4];
  auto issue_s = [&](int j) {            // S = Q.K^T, committed
    const unsigned ks = smem_u32(sm + C::RING + (j % STAGES) * 2 * C::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      if constexpr (Q_REGS<D>)
        wgmma_rs_k<BN>(sc, qa[kk], desc_k<D>(ks, BN, 0, kk), kk);
      else
        wgmma_ss<BN>(sc, desc_k<D>(qs, BM, 64 * wg, kk),
                     desc_k<D>(ks, BN, 0, kk), kk);
    wgmma_commit();
  };
  auto issue_pv = [&](int j) {           // O += P.V of tile j, committed
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], desc_mn<D>(vtile(j), BN, kk), 1);
    wgmma_commit();
  };
  // the online softmax of tile j on rows row[0] (e & 2 == 0) and row[1]:
  // P in place of S, l and m updated; returns O's correction in corr
  auto softmax = [&](int j, float (&corr)[2]) {
    const int k0 = j * BN;
    const bool masked = !(k0 + BN <= klen && qw0 + 64 <= qlen &&
                          (!causal || k0 + BN - 1 <= qw0));
    float mx[2][4];                      // four partial maxima a row
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) mx[r][q] = -CUDART_INF_F;
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      float x = sc[e];
      if (masked) {
        const int key = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        const int r = row[(e >> 1) & 1];
        if (!(r < qlen && key < klen && (!causal || key <= r)))
          x = -CUDART_INF_F;
        sc[e] = x;
      }
      float& y = mx[(e >> 1) & 1][(e >> 2) & 3];
      y = fmaxf(y, x);
    }
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mr = fmaxf(fmaxf(mx[r][0], mx[r][1]),
                             fmaxf(mx[r][2], mx[r][3]));
      const float m_new = fmaxf(m[r], quad_max(mr) * c);
      // 0 on the row's first visible tile; 1 while it has seen no key
      corr[r] = m_new == -CUDART_INF_F ? 1.f : ex2(m[r] - m_new);
      m[r] = m_new;
      mc[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
    }
    float ps[2][4] = {};                 // four partial sums a row
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      const int r = (e >> 1) & 1;
      const float x = sc[e];
      const float p =
          masked && x == -CUDART_INF_F ? 0.f : ex2(fmaf(x, c, -mc[r]));
      sc[e] = p;
      ps[r][(e >> 2) & 3] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = l[r] * corr[r] + ((ps[r][0] + ps[r][1]) + (ps[r][2] + ps[r][3]));
  };

  // Tile j's S is issued before tile j - 1's O += P.V, and its softmax
  // runs while that product is in flight; the first S and the last P.V
  // are peeled off the loop, so no product is issued under a branch.
  if (ntiles > 0) {
    mbar_wait(q_full, 0);
    if constexpr (Q_REGS<D>) load_a<D>(qa, qs, BM, 64 * wg);
    arrived(0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_regs(sc);
    float corr[2];
    softmax(0, corr);
    pack_a<BN>(pa, sc);                  // P rounded to bf16
    for (int j = 1; j < ntiles; ++j) {
      arrived(j);
      wgmma_fence();
      issue_s(j);
      issue_pv(j - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(j, corr);
      wgmma_wait<0>();                   // tile j - 1's P.V is done
      fence_regs(o);
      mbar_arrive_if(empty + (j - 1) % STAGES, lane == 0);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      pack_a<BN>(pa, sc);
    }
    wgmma_fence();
    issue_pv(ntiles - 1);
    wgmma_wait<0>();
    fence_regs(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if (row[r] >= Tq) continue;
    const bool alive = l[r] > 0.f;
    bf16* orow = out + ((size_t)(b * Tq + row[r]) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      unsigned x = 0u;
      if (alive)
        x = pack_bf16x2(o[4 * n + 2 * r] / l[r], o[4 * n + 2 * r + 1] / l[r]);
      *reinterpret_cast<unsigned*>(orow + 8 * n + 2 * t) = x;
    }
    if (t == 0)
      lse[((size_t)b * H + h) * Tq + row[r]] =
          alive ? (m[r] + log2f(l[r])) * LN2 : 1e30f;
  }
}

template <int D>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                        bf16* out, float* lse, const int* kv_len,
                        const int* q_len, int B, int Tq, int Tk, int H,
                        int causal, float scale, cudaStream_t stream) {
  using C = FwdWg<D>;
  static_assert(C::BYTES <= 232448, "shared memory of a block");
  CUtensorMap tq, tk, tv;
  if (!bthd_map(&tq, q, B, Tq, H, D, C::BM) ||
      !bthd_map(&tk, k, B, Tk, H, D, C::BN) ||
      !bthd_map(&tv, v, B, Tk, H, D, C::BN))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Tq + C::BM - 1) / C::BM);
  flash_fwd_wgmma_kernel<D><<<grid, WG_THREADS, C::BYTES, stream>>>(
      tq, tk, tv, out, lse, kv_len, q_len, Tq, Tk, H, causal,
      scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// The bf16 form's entry point: as flash_attn_fwd, with q, k, v and out bf16
// (lse f32), D in 32, 64, 128 or a multiple of 64 above 128 (the D-split)
// and scale >= 0 (the wrapper pads D = 96 and negates q for a negative
// scale).
extern "C" int flash_attn_fwd_bf16(const bf16* q, const bf16* k,
                                   const bf16* v, bf16* out, float* lse,
                                   const int* kv_len, const int* q_len, int B,
                                   int Tq, int Tk, int H, int D, int causal,
                                   float scale, int device, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || B > 65535 ||
      (Tq + 127) / 128 > 65535 || !(scale >= 0.f))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch_bf16<32>(q, k, v, out, lse, kv_len, q_len, B, Tq,
                                  Tk, H, causal, scale, st);
    case 64:
      return (int)launch_bf16<64>(q, k, v, out, lse, kv_len, q_len, B, Tq,
                                  Tk, H, causal, scale, st);
    case 128:
      return (int)launch_bf16<128>(q, k, v, out, lse, kv_len, q_len, B, Tq,
                                   Tk, H, causal, scale, st);
    default:   // D > 128, a multiple of 64: the D-split (flash_dsplit.cuh)
      return (int)dsplit::launch_fwd<dsplit::BF16>(q, k, v, out, lse, kv_len,
                                                   q_len, B, Tq, Tk, H, D,
                                                   causal, scale, st);
  }
}
