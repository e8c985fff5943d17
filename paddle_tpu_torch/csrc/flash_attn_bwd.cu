// Flash-attention backward for Hopper (sm_90a), f32: two kernels, dkv and dq.
//
// Replaces the TPU kernels behind paddle_tpu/parallel/ring.py::_pallas_flash's
// gradient (jax.experimental.pallas.ops.tpu.flash_attention: the dkv and dq
// pallas_calls of _flash_attention_bwd). It computes what
// ring.py::_flash_blocked_bwd defines, not a block-by-block copy of the TPU
// kernels:
//
//   q, dout [B,Tq,H,D], k/v [B,Tk,H,D] contiguous f32 (the JAX layout),
//   lse and delta [B,H,Tq] (delta = sum_d dout*out, computed by the caller)
//   p_ij  = exp(scale * q_i.k_j - lse_i) over visible pairs, exactly 0 elsewhere
//   ds_ij = p_ij * (dout_i.v_j - delta_i) * scale
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i p_ij dout_i
//
// Visible pairs: j < kv_len[b], i < q_len[b], j <= i when causal — the
// forward's masks, tested explicitly (never through exp of a huge negative).
// A row with no visible key (lse = 1e30) has every p = 0, so its dq is 0 and
// it adds nothing to dk/dv. A padded query row of self-attention still sees
// the valid keys and is handled like any other row (its dout is 0).
//
// Design (right and simple first). The split mirrors the library's: the dkv
// kernel owns a 64-key tile and walks the query tiles that can see it; the dq
// kernel owns a 64-query tile and walks the key tiles it can see. Each output
// has exactly one writer, so there are no atomics and the result is
// deterministic. Both use the forward's thread layout: 256 threads, four per
// row, each holding a quarter of the row as interleaved float4 chunks so the
// four read consecutive shared-memory words; dot products are quad reductions
// (two xor shuffles). The walked tiles are staged in shared memory; the
// accumulators (dk and dv, or dq) stay in registers. f32 FMA on the CUDA
// cores. Tensor cores, TMA and a persistent schedule are later work.
//
// Bound at the training shape (B=32, H=4, T=128, D=64, causal) on one H100
// SXM: 10*D*H flops per visible pair (the recomputed QK^T, dP, dV, dQ, dK),
// ~0.68 GFLOP, ~10.1 us at the 67 TFLOP/s f32 CUDA-core rate; q, k, v, out,
// dout, dq, dk, dv and lse ~33.6 MB, ~10.0 us at 3.35 TB/s — the two bounds
// meet there; at T=1024 operations bound it. Each pair's score and dP are
// recomputed in both kernels, so this design does 14*D*H flops per pair,
// 1.4x the bound's operations.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 64;              // rows per tile, queries and keys
constexpr int QUAD = 4;                // threads per row
constexpr int THREADS = BLOCK * QUAD;  // 256

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ int clamp_len(const int* len, int b, int t) {
  return len ? min(max(len[b], 0), t) : t;
}

// One block per (b, h, 64-key tile): dk and dv of the tile's keys.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, const int* __restrict__ kv_len,
                     const int* __restrict__ q_len, int Tq, int Tk, int H,
                     int causal, float scale) {
  constexpr int D4 = D / 4;      // float4 per row
  constexpr int C = D4 / QUAD;   // float4 chunks per thread
  extern __shared__ float4 smem[];
  float4* qs = smem;                  // [BLOCK][D4]
  float4* dos = smem + BLOCK * D4;    // [BLOCK][D4]
  __shared__ float lse_s[BLOCK];
  __shared__ float delta_s[BLOCK];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * BLOCK;
  const int tid = threadIdx.x;
  const int row = tid / QUAD;
  const int lane = tid % QUAD;   // owns chunks lane + QUAD * i
  const int kj = k0 + row;

  const int klen = clamp_len(kv_len, b, Tk);
  const int qlen = clamp_len(q_len, b, Tq);
  const bool key_live = kj < klen;
  // queries that may see a key of this tile: causal ones start at the
  // tile's first key (k0 is a multiple of BLOCK, so a tile boundary)
  const int qbeg = causal ? k0 : 0;
  const int qend = k0 < klen ? qlen : 0;

  float4 kr[C], vr[C], dk_acc[C], dv_acc[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    kr[i] = zero4();
    vr[i] = zero4();
    dk_acc[i] = zero4();
    dv_acc[i] = zero4();
    if (kj < Tk) {
      const size_t off = ((size_t)(b * Tk + kj) * H + h) * D;
      kr[i] = reinterpret_cast<const float4*>(k + off)[lane + QUAD * i];
      vr[i] = reinterpret_cast<const float4*>(v + off)[lane + QUAD * i];
    }
  }

  for (int i0 = qbeg; i0 < qend; i0 += BLOCK) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < BLOCK * D4; idx += THREADS) {
      const int r = idx / D4;
      const int c = idx % D4;
      const int t = i0 + r;
      float4 qq = zero4(), dd = zero4();
      if (t < Tq) {
        const size_t off = ((size_t)(b * Tq + t) * H + h) * D;
        qq = reinterpret_cast<const float4*>(q + off)[c];
        dd = reinterpret_cast<const float4*>(dout + off)[c];
      }
      qs[idx] = qq;
      dos[idx] = dd;
    }
    if (tid < BLOCK) {
      const int t = i0 + tid;
      const size_t off = ((size_t)b * H + h) * Tq + t;
      lse_s[tid] = t < Tq ? lse[off] : 1e30f;
      delta_s[tid] = t < Tq ? delta[off] : 0.f;
    }
    __syncthreads();

    const int rend = min(BLOCK, qend - i0);
    for (int r = 0; r < rend; ++r) {
      const int qi = i0 + r;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        s = dot4(kr[i], qs[r * D4 + lane + QUAD * i], s);
        dp = dot4(vr[i], dos[r * D4 + lane + QUAD * i], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const bool ok = key_live && (!causal || kj <= qi);
      const float p = ok ? expf(s * scale - lse_s[r]) : 0.f;
      const float ds = p * (dp - delta_s[r]) * scale;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        axpy4(p, dos[r * D4 + lane + QUAD * i], dv_acc[i]);
        axpy4(ds, qs[r * D4 + lane + QUAD * i], dk_acc[i]);
      }
    }
  }

  if (kj < Tk) {
    const size_t off = ((size_t)(b * Tk + kj) * H + h) * D;
    float4* dko = reinterpret_cast<float4*>(dk + off);
    float4* dvo = reinterpret_cast<float4*>(dv + off);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      dko[lane + QUAD * i] = dk_acc[i];
      dvo[lane + QUAD * i] = dv_acc[i];
    }
  }
}

// One block per (b, h, 64-query tile): dq of the tile's queries.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    const int* __restrict__ kv_len,
                    const int* __restrict__ q_len, int Tq, int Tk, int H,
                    int causal, float scale) {
  constexpr int D4 = D / 4;
  constexpr int C = D4 / QUAD;
  extern __shared__ float4 smem[];
  float4* ks = smem;                  // [BLOCK][D4]
  float4* vs = smem + BLOCK * D4;     // [BLOCK][D4]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BLOCK;
  const int tid = threadIdx.x;
  const int row = tid / QUAD;
  const int lane = tid % QUAD;
  const int qi = q0 + row;

  const int klen = clamp_len(kv_len, b, Tk);
  const int qlen = clamp_len(q_len, b, Tq);
  const bool row_live = qi < qlen;
  // keys any row of this tile may see
  int kend = klen;
  if (causal) kend = min(kend, q0 + BLOCK);
  if (q0 >= qlen) kend = 0;

  float4 qr[C], dor[C], acc[C];
  float row_lse = 1e30f, row_delta = 0.f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    qr[i] = zero4();
    dor[i] = zero4();
    acc[i] = zero4();
    if (qi < Tq) {
      const size_t off = ((size_t)(b * Tq + qi) * H + h) * D;
      qr[i] = reinterpret_cast<const float4*>(q + off)[lane + QUAD * i];
      dor[i] = reinterpret_cast<const float4*>(dout + off)[lane + QUAD * i];
    }
  }
  if (qi < Tq) {
    const size_t off = ((size_t)b * H + h) * Tq + qi;
    row_lse = lse[off];
    row_delta = delta[off];
  }

  for (int k0 = 0; k0 < kend; k0 += BLOCK) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < BLOCK * D4; idx += THREADS) {
      const int j = idx / D4;
      const int c = idx % D4;
      const int t = k0 + j;
      float4 kk = zero4(), vv = zero4();
      if (t < klen) {
        const size_t off = ((size_t)(b * Tk + t) * H + h) * D;
        kk = reinterpret_cast<const float4*>(k + off)[c];
        vv = reinterpret_cast<const float4*>(v + off)[c];
      }
      ks[idx] = kk;
      vs[idx] = vv;
    }
    __syncthreads();

    const int jend = min(BLOCK, kend - k0);
    for (int j = 0; j < jend; ++j) {
      const int t = k0 + j;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        s = dot4(qr[i], ks[j * D4 + lane + QUAD * i], s);
        dp = dot4(dor[i], vs[j * D4 + lane + QUAD * i], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const bool ok = row_live && (!causal || t <= qi);
      const float p = ok ? expf(s * scale - row_lse) : 0.f;
      const float ds = p * (dp - row_delta) * scale;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        axpy4(ds, ks[j * D4 + lane + QUAD * i], acc[i]);
      }
    }
  }

  if (qi < Tq) {
    const size_t off = ((size_t)(b * Tq + qi) * H + h) * D;
    float4* o = reinterpret_cast<float4*>(dq + off);
#pragma unroll
    for (int i = 0; i < C; ++i) o[lane + QUAD * i] = acc[i];
  }
}

// the dynamic shared memory a launch asks for, allowed beside the kernel's
// static arrays (D = 96 asks for exactly 48 KB)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dk, float* dv,
                       const int* kv_len, const int* q_len, int B, int Tq,
                       int Tk, int H, int causal, float scale,
                       cudaStream_t stream) {
  const size_t smem = 2 * BLOCK * D * sizeof(float);
  const cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + BLOCK - 1) / BLOCK, H, B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, kv_len, q_len, Tq, Tk, H, causal,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      float* dq, const int* kv_len, const int* q_len, int B,
                      int Tq, int Tk, int H, int causal, float scale,
                      cudaStream_t stream) {
  const size_t smem = 2 * BLOCK * D * sizeof(float);
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BLOCK - 1) / BLOCK, H, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, kv_len, q_len, Tq, Tk, H, causal, scale);
  return cudaGetLastError();
}

cudaError_t prologue(int B, int Tq, int Tk, int H, int device) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  return cudaSetDevice(device);
}

}  // namespace

// Plain C entry points, loaded with ctypes. D is 32, 64, 96 or 128 (the
// wrapper pads any other D <= 128 with zero columns); q, k, v and dout
// 16-byte aligned. kv_len and q_len may be null (no mask). Each launches one kernel on `stream` of `device`, does not
// synchronise, and returns the launch's cudaError_t (0 = launched). dk and dv
// are fully written (0 for masked keys); so is dq.
extern "C" int flash_attn_bwd_dkv(const float* q, const float* k,
                                  const float* v, const float* dout,
                                  const float* lse, const float* delta,
                                  float* dk, float* dv, const int* kv_len,
                                  const int* q_len, int B, int Tq, int Tk,
                                  int H, int D, int causal, float scale,
                                  int device, void* stream) {
  cudaError_t err = prologue(B, Tq, Tk, H, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, kv_len,
                                 q_len, B, Tq, Tk, H, causal, scale, st);
    case 64:
      return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, kv_len,
                                 q_len, B, Tq, Tk, H, causal, scale, st);
    case 96:
      return (int)launch_dkv<96>(q, k, v, dout, lse, delta, dk, dv, kv_len,
                                 q_len, B, Tq, Tk, H, causal, scale, st);
    case 128:
      return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, kv_len,
                                  q_len, B, Tq, Tk, H, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attn_bwd_dq(const float* q, const float* k,
                                 const float* v, const float* dout,
                                 const float* lse, const float* delta,
                                 float* dq, const int* kv_len,
                                 const int* q_len, int B, int Tq, int Tk,
                                 int H, int D, int causal, float scale,
                                 int device, void* stream) {
  cudaError_t err = prologue(B, Tq, Tk, H, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch_dq<32>(q, k, v, dout, lse, delta, dq, kv_len, q_len,
                                B, Tq, Tk, H, causal, scale, st);
    case 64:
      return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, kv_len, q_len,
                                B, Tq, Tk, H, causal, scale, st);
    case 96:
      return (int)launch_dq<96>(q, k, v, dout, lse, delta, dq, kv_len, q_len,
                                B, Tq, Tk, H, causal, scale, st);
    case 128:
      return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, kv_len,
                                 q_len, B, Tq, Tk, H, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
