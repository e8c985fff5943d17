// In-place sparse-row update of an embedding table and its optimizer-slot
// tables, for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel of paddle_tpu/parallel/sparse.py:
//   B9 SparseUpdater._make_call (kernel :330, pallas_call :363), together
//   with the segment sum of _unique_segment_grads (:109) that _one_step
//   (:371) runs before it.
// Contract. The wrapper (ops/sparse_rows.py) sorts the N occurrence ids
// stably on the device and hands over:
//   perm [N]   the occurrence at each sorted position;
//   uids [k]   the slots' unique ids, ascending (the k smallest), -1 fills
//              at the end;
//   off  [k+1] slot i owns the sorted positions off[i] .. off[i+1]; the
//              occurrences of ids dropped by the truncation to k lie past
//              off[k] and contribute nothing.
// For each slot whose id lies in [0, V), in place:
//   g = grads[perm[off[i]]] + ... + grads[perm[off[i+1] - 1]], in that order
//   (p, s...) = rule(p, g, s...) on the table row and its slot rows.
// Fills, negative ids (they sort first) and ids >= V are skipped, slot by
// slot: every row not touched stays bit-identical.
//
// Rules, each product and sum rounded on its own (no contraction into an
// FMA, no fast math) as the plain PyTorch version computes them:
//   sgd       p' = p - lr*g
//   momentum  m' = mu*m + g;  p' = p - lr*m'
//   adagrad   a' = a + g*g;   p' = p - lr*g / sqrt(a' + eps)
// Any other update_fn takes the generic route: sparse_row_gather_kernel
// writes gsum [k, D] and each table's rows [k, D] (zero rows for a skipped
// slot), the caller's function runs on them in PyTorch, and
// sparse_row_scatter_kernel writes the valid slots back in place.
//
// Design: one warp per slot, a grid-stride loop over the slots. A lane owns
// VEC = 4 neighbouring columns (16-byte loads where D % 4 == 0 and every
// base is 16-byte aligned, else VEC = 1) and walks the row in steps of
// 32 * VEC columns. The table and slot rows are loaded before the gradient
// loop so that their loads are in flight beside it. The ids are unique, so
// each warp's writes are its own; the sum runs in the sorted order, so the
// result is bit-identical from run to run (no atomics).
//
// What bounds it on one H100 SXM: bytes. A step reads the N gradient rows
// once and reads and writes the touched rows of each table once:
// (N + 2 * tables * k_valid) * D * 4 bytes (plus the int32 indices) over
// 3.35 TB/s. There is no work of size V.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;            // warps of a block: 256 threads
constexpr int MAX_TABLES = 8;       // the table and up to 7 slot tables
constexpr int MAX_BLOCKS = 16384;   // the grid-stride loop covers the rest

struct Tables {
  float* t[MAX_TABLES];
};

template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// g[v] = sum of grads[perm[j]][c + v] over j in [j0, j1), in order
template <int VEC>
__device__ __forceinline__ void segment_sum(const float* __restrict__ grads,
                                            const int* __restrict__ perm,
                                            int j0, int j1, int D, int c,
                                            float (&g)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) g[v] = 0.f;
  for (int j = j0; j < j1; ++j) {
    float x[VEC];
    load<VEC>(grads + (size_t)perm[j] * D + c, x);
#pragma unroll
    for (int v = 0; v < VEC; ++v) g[v] = __fadd_rn(g[v], x[v]);
  }
}

struct Sgd {
  static constexpr int kState = 0;
  float lr, unused;
  __device__ __forceinline__ void operator()(float& p, float g,
                                             float* /*s*/) const {
    p = __fsub_rn(p, __fmul_rn(lr, g));
  }
};

struct Momentum {
  static constexpr int kState = 1;
  float lr, mu;
  __device__ __forceinline__ void operator()(float& p, float g,
                                             float* s) const {
    const float m = __fadd_rn(__fmul_rn(mu, s[0]), g);
    s[0] = m;
    p = __fsub_rn(p, __fmul_rn(lr, m));
  }
};

struct Adagrad {
  static constexpr int kState = 1;
  float lr, eps;
  __device__ __forceinline__ void operator()(float& p, float g,
                                             float* s) const {
    const float a = __fadd_rn(s[0], __fmul_rn(g, g));
    s[0] = a;
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, g), __fsqrt_rn(__fadd_rn(a, eps))));
  }
};

template <class Rule, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
sparse_row_update_kernel(Tables tabs, const float* __restrict__ grads,
                         const int* __restrict__ perm,
                         const int* __restrict__ uids,
                         const int* __restrict__ off, int k, int V, int D,
                         Rule rule) {
  constexpr int NS = Rule::kState > 0 ? Rule::kState : 1;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  for (int i = blockIdx.x * WARPS + (threadIdx.x >> 5); i < k; i += stride) {
    const int id = uids[i];
    // a fill or a negative id (which sorts first), or past the table:
    // skipped, and the warp walks on to its next slot
    if (id < 0 || id >= V) continue;
    const int j0 = off[i], j1 = off[i + 1];
    const size_t row = (size_t)id * D;
    for (int c = lane * VEC; c < D; c += 32 * VEC) {
      float p[VEC], s[NS][VEC], g[VEC];
      load<VEC>(tabs.t[0] + row + c, p);
#pragma unroll
      for (int t = 0; t < Rule::kState; ++t) load<VEC>(tabs.t[1 + t] + row + c, s[t]);
      segment_sum<VEC>(grads, perm, j0, j1, D, c, g);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float sv[NS];
#pragma unroll
        for (int t = 0; t < Rule::kState; ++t) sv[t] = s[t][v];
        rule(p[v], g[v], sv);
#pragma unroll
        for (int t = 0; t < Rule::kState; ++t) s[t][v] = sv[t];
      }
      store<VEC>(tabs.t[0] + row + c, p);
#pragma unroll
      for (int t = 0; t < Rule::kState; ++t) store<VEC>(tabs.t[1 + t] + row + c, s[t]);
    }
  }
}

// The generic route's first half: gsum [k, D] of every slot, and rows_t [k, D]
// = table_t[uids] of each valid slot (zero rows for the others).
template <int VEC>
__global__ void __launch_bounds__(WARPS * 32)
sparse_row_gather_kernel(Tables tabs, Tables rows, int n_tables,
                         float* __restrict__ gsum,
                         const float* __restrict__ grads,
                         const int* __restrict__ perm,
                         const int* __restrict__ uids,
                         const int* __restrict__ off, int k, int V, int D) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  for (int i = blockIdx.x * WARPS + (threadIdx.x >> 5); i < k; i += stride) {
    const int id = uids[i];
    const bool valid = id >= 0 && id < V;
    const int j0 = off[i], j1 = off[i + 1];
    const size_t out = (size_t)i * D;
    for (int c = lane * VEC; c < D; c += 32 * VEC) {
      float g[VEC];
      segment_sum<VEC>(grads, perm, j0, j1, D, c, g);
      store<VEC>(gsum + out + c, g);
      // t is a constant after unrolling: the pointers stay in the
      // parameter bank instead of a local copy of the struct
#pragma unroll
      for (int t = 0; t < MAX_TABLES; ++t) {
        if (t >= n_tables) break;
        float x[VEC];
        if (valid) {
          load<VEC>(tabs.t[t] + (size_t)id * D + c, x);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) x[v] = 0.f;
        }
        store<VEC>(rows.t[t] + out + c, x);
      }
    }
  }
}

// The generic route's second half: table_t[uids[i]] = rows_t[i] for each
// valid slot, in place.
template <int VEC>
__global__ void __launch_bounds__(WARPS * 32)
sparse_row_scatter_kernel(Tables tabs, Tables rows, int n_tables,
                          const int* __restrict__ uids, int k, int V, int D) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * WARPS;
  for (int i = blockIdx.x * WARPS + (threadIdx.x >> 5); i < k; i += stride) {
    const int id = uids[i];
    if (id < 0 || id >= V) continue;
    for (int c = lane * VEC; c < D; c += 32 * VEC) {
#pragma unroll
      for (int t = 0; t < MAX_TABLES; ++t) {
        if (t >= n_tables) break;
        float x[VEC];
        load<VEC>(rows.t[t] + (size_t)i * D + c, x);
        store<VEC>(tabs.t[t] + (size_t)id * D + c, x);
      }
    }
  }
}

int blocks_for(int k) {
  const int b = (k + WARPS - 1) / WARPS;
  return b < MAX_BLOCKS ? b : MAX_BLOCKS;
}

bool pack(const void* const* ptrs, int n, Tables* out) {
  if (n < 1 || n > MAX_TABLES) return false;
  for (int t = 0; t < MAX_TABLES; ++t)
    out->t[t] = t < n ? static_cast<float*>(const_cast<void*>(ptrs[t])) : nullptr;
  return true;
}

template <class Rule>
cudaError_t launch_update(const Tables& tabs, const float* grads,
                          const int* perm, const int* uids, const int* off,
                          int k, int V, int D, int vec, Rule rule,
                          cudaStream_t st) {
  const dim3 grid(blocks_for(k)), block(WARPS * 32);
  if (vec == 4)
    sparse_row_update_kernel<Rule, 4><<<grid, block, 0, st>>>(
        tabs, grads, perm, uids, off, k, V, D, rule);
  else
    sparse_row_update_kernel<Rule, 1><<<grid, block, 0, st>>>(
        tabs, grads, perm, uids, off, k, V, D, rule);
  return cudaGetLastError();
}

}  // namespace

// Rule codes of sparse_rows_update, and the number of slot tables each reads.
// 0 sgd (lr), 1 momentum (lr, mu), 2 adagrad (lr, eps).
extern "C" int sparse_rows_rule_slots(int rule) {
  switch (rule) {
    case 0: return Sgd::kState;
    case 1: return Momentum::kState;
    case 2: return Adagrad::kState;
    default: return -1;
  }
}

// B9, a known rule. tables: n_tables device pointers, each [>= V, D] f32
// (the table, then its slot tables); grads [N, D]; perm [N], uids [k],
// off [k+1] int32. vec is 4 or 1. Launches on `stream` of `device`; returns
// the launch's cudaError_t (0 = launched).
extern "C" int sparse_rows_update(int rule, float a, float b,
                                  const void* const* tables, int n_tables,
                                  const float* grads, const int* perm,
                                  const int* uids, const int* off, int k,
                                  int V, int D, int vec, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Tables tabs;
  if (k < 1 || D < 1 || sparse_rows_rule_slots(rule) != n_tables - 1 ||
      !pack(tables, n_tables, &tabs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (rule) {
    case 0: return (int)launch_update(tabs, grads, perm, uids, off, k, V, D, vec, Sgd{a, b}, st);
    case 1: return (int)launch_update(tabs, grads, perm, uids, off, k, V, D, vec, Momentum{a, b}, st);
    default: return (int)launch_update(tabs, grads, perm, uids, off, k, V, D, vec, Adagrad{a, b}, st);
  }
}

// The generic route's gather: rows holds n_tables device pointers, each
// [k, D] f32; gsum [k, D].
extern "C" int sparse_rows_gather(const void* const* tables,
                                  const void* const* rows, int n_tables,
                                  float* gsum, const float* grads,
                                  const int* perm, const int* uids,
                                  const int* off, int k, int V, int D,
                                  int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Tables tabs, outs;
  if (k < 1 || D < 1 || !pack(tables, n_tables, &tabs) ||
      !pack(rows, n_tables, &outs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(k)), block(WARPS * 32);
  if (vec == 4)
    sparse_row_gather_kernel<4><<<grid, block, 0, st>>>(
        tabs, outs, n_tables, gsum, grads, perm, uids, off, k, V, D);
  else
    sparse_row_gather_kernel<1><<<grid, block, 0, st>>>(
        tabs, outs, n_tables, gsum, grads, perm, uids, off, k, V, D);
  return (int)cudaGetLastError();
}

// The generic route's scatter: the valid slots of rows (n_tables pointers,
// each [k, D]) written into the tables in place.
extern "C" int sparse_rows_scatter(const void* const* tables,
                                   const void* const* rows, int n_tables,
                                   const int* uids, int k, int V, int D,
                                   int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Tables tabs, news;
  if (k < 1 || D < 1 || !pack(tables, n_tables, &tabs) ||
      !pack(rows, n_tables, &news))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(k)), block(WARPS * 32);
  if (vec == 4)
    sparse_row_scatter_kernel<4><<<grid, block, 0, st>>>(tabs, news, n_tables,
                                                          uids, k, V, D);
  else
    sparse_row_scatter_kernel<1><<<grid, block, 0, st>>>(tabs, news, n_tables,
                                                          uids, k, V, D);
  return (int)cudaGetLastError();
}

extern "C" const char* sparse_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
