// Flash-attention forward for Hopper (sm_90a), f32.
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
// Design (right and simple first): one block of 256 threads per (b, h,
// 64-query tile). Four threads share a query row; each holds a quarter of
// the row's q and of its accumulator, as interleaved float4 chunks so the
// four read consecutive shared-memory words. K/V tiles of 64 rows are staged
// in shared memory; each score is a quad reduction (two xor shuffles). The
// online softmax runs in f32 registers with f32 FMA on the CUDA cores. A
// causal tile stops at its last query row, and every tile stops at kv_len.
// Tensor cores (TF32/bf16 mma or wgmma), TMA and a persistent schedule are
// later work.
//
// Bound at the served prefill shape (B=1, H=4, T=1024, D=64, causal) on one
// H100 SXM: ~0.54 GFLOP of QK^T and PV at the 67 TFLOP/s f32 CUDA-core rate
// is ~8 us; q, k, v and out in f32 are ~4.2 MB, ~1.3 us at 3.35 TB/s. So it
// is bound by operations. That shape launches only 16 x 4 = 64 blocks on 132
// SMs, so this first version is bound by latency well before either.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BLOCK_M = 64;               // query rows per block
constexpr int BLOCK_N = 64;               // key rows per shared-memory tile
constexpr int QUAD = 4;                   // threads per query row
constexpr int THREADS = BLOCK_M * QUAD;   // 256

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ kv_len,
                 const int* __restrict__ q_len, int Tq, int Tk, int H,
                 int causal, float scale) {
  constexpr int D4 = D / 4;        // float4 per row
  constexpr int C = D4 / QUAD;     // float4 chunks per thread
  extern __shared__ float4 smem[];
  float4* ks = smem;                   // [BLOCK_N][D4]
  float4* vs = smem + BLOCK_N * D4;    // [BLOCK_N][D4]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BLOCK_M;
  const int tid = threadIdx.x;
  const int row = tid / QUAD;
  const int lane = tid % QUAD;   // owns chunks lane + QUAD * i
  const int qi = q0 + row;

  const int klen = kv_len ? min(max(kv_len[b], 0), Tk) : Tk;
  const int qlen = q_len ? min(max(q_len[b], 0), Tq) : Tq;
  const bool row_live = qi < qlen;
  // keys any row of this tile may see
  int kend = klen;
  if (causal) kend = min(kend, q0 + BLOCK_M);
  if (q0 >= qlen) kend = 0;

  float4 qr[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    qr[i] = zero4();
    if (qi < Tq) {
      const size_t off = ((size_t)(b * Tq + qi) * H + h) * D;
      qr[i] = reinterpret_cast<const float4*>(q + off)[lane + QUAD * i];
    }
  }

  float m = -CUDART_INF_F;   // running max over visible keys
  float l = 0.f;             // running denominator
  float4 acc[C];
#pragma unroll
  for (int i = 0; i < C; ++i) acc[i] = zero4();

  for (int k0 = 0; k0 < kend; k0 += BLOCK_N) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < BLOCK_N * D4; idx += THREADS) {
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

    float s[BLOCK_N];
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BLOCK_N; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float4 kk = ks[j * D4 + lane + QUAD * i];
        part = fmaf(qr[i].x, kk.x, part);
        part = fmaf(qr[i].y, kk.y, part);
        part = fmaf(qr[i].z, kk.z, part);
        part = fmaf(qr[i].w, kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int t = k0 + j;
      const bool ok = row_live && t < klen && (!causal || t <= qi);
      s[j] = ok ? part * scale : -CUDART_INF_F;
      tmax = fmaxf(tmax, s[j]);
    }

    if (tmax > -CUDART_INF_F) {   // this row sees a key in this tile
      const float m_new = fmaxf(m, tmax);
      const float corr = expf(m - m_new);   // 0 on the first visible tile
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        acc[i].x *= corr;
        acc[i].y *= corr;
        acc[i].z *= corr;
        acc[i].w *= corr;
      }
#pragma unroll
      for (int j = 0; j < BLOCK_N; ++j) {
        const float p = s[j] > -CUDART_INF_F ? expf(s[j] - m_new) : 0.f;
        psum += p;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const float4 vv = vs[j * D4 + lane + QUAD * i];
          acc[i].x = fmaf(p, vv.x, acc[i].x);
          acc[i].y = fmaf(p, vv.y, acc[i].y);
          acc[i].z = fmaf(p, vv.z, acc[i].z);
          acc[i].w = fmaf(p, vv.w, acc[i].w);
        }
      }
      l = l * corr + psum;
      m = m_new;
    }
  }

  if (qi < Tq) {
    const size_t off = ((size_t)(b * Tq + qi) * H + h) * D;
    float4* o = reinterpret_cast<float4*>(out + off);
    const bool alive = l > 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      float4 r = zero4();
      if (alive) {
        r.x = acc[i].x / l;
        r.y = acc[i].y / l;
        r.z = acc[i].z / l;
        r.w = acc[i].w / l;
      }
      o[lane + QUAD * i] = r;
    }
    if (lane == 0) {
      lse[((size_t)b * H + h) * Tq + qi] = alive ? m + logf(l) : 1e30f;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, float* lse, const int* kv_len,
                   const int* q_len, int B, int Tq, int Tk, int H,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem = 2 * BLOCK_N * D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Tq + BLOCK_M - 1) / BLOCK_M, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, lse, kv_len, q_len, Tq, Tk, H, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. kv_len and q_len may be null
// (no mask). Launches on `stream` of `device`, does not synchronise, and
// returns the launch's cudaError_t (0 = launched).
extern "C" int flash_attn_fwd(const float* q, const float* k, const float* v,
                              float* out, float* lse, const int* kv_len,
                              const int* q_len, int B, int Tq, int Tk, int H,
                              int D, int causal, float scale, int device,
                              void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || B > 65535 || H > 65535)
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
    case 128:
      err = launch<128>(q, k, v, out, lse, kv_len, q_len, B, Tq, Tk, H,
                        causal, scale, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
