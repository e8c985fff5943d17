// Tensor-core pieces of the bf16 forms of the fused BN->ReLU->1x1-conv
// kernels (bn_act_conv1x1.cu), for Hopper (sm_90a): bf16 operands, f32
// accumulation, one pass.
//
// - PTX wrappers: ldmatrix (x4, plain and .trans), mma.sync m16n8k16 bf16
//   with f32 accumulators, and cvt.rn.bf16x2.f32 (two f32 to one packed
//   pair, round to nearest even, as PyTorch's .to(torch.bfloat16));
// - unpacking a bf16 pair to two f32 (exact);
// - load_window_bf16: the 16-byte cp.async (8 bf16) of a rectangle of a
//   row-major bf16 array into shared memory, zero-filled past its row and
//   column limits (column limits are multiples of 8).
//
// Fragments of mma.m16n8k16 (g = lane / 4, t = lane % 4; a register holds
// the pair of columns 2t, 2t + 1, the lower one in its low half):
//   A (16 x 16, row): a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..),
//                     a3 (g + 8, 2t + 8..)
//   B (16 x 8, col):  b0 (k 2t.., n g), b1 (k 2t + 8.., n g)
//   C (16 x 8):       c0, c1 (g, 2t..), c2, c3 (g + 8, 2t..)
// ldmatrix.x4 reads four 8 x 8 bf16 matrices, lanes 8i..8i+7 giving the
// row addresses of matrix i; without .trans a lane gets (row g, columns
// 2t, 2t + 1) of each, with .trans (rows 2t, 2t + 1, column g). Two lane
// to address maps cover the four operand layouts of the kernels:
//   ROWS_LO (row (lane & 7) + 8 * ((lane >> 3) & 1), column 8 * (lane >> 4)):
//     A stored [m][k] (plain) and B stored [k][n] (.trans, two n-tiles);
//   ROWS_HI (row (lane & 7) + 8 * (lane >> 4), column 8 * ((lane >> 3) & 1)):
//     B stored [n][k] (plain, two n-tiles) and A stored [k][m] (.trans).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "tf32_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ int rows_lo_row(int lane) {
  return (lane & 7) + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ int rows_lo_col(int lane) { return 8 * (lane >> 4); }
__device__ __forceinline__ int rows_hi_row(int lane) {
  return (lane & 7) + 8 * (lane >> 4);
}
__device__ __forceinline__ int rows_hi_col(int lane) {
  return 8 * ((lane >> 3) & 1);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 inputs, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// (lo, hi) -> one register, lo in the low half, each rounded to nearest even
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// end of PTX wrappers

__device__ __forceinline__ float bf16_lo(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}

// 16-byte copy global -> shared (8 bf16); src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16_bf16(bf16* dst, const bf16* src,
                                                int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// cp.async of the ROWS x COLS window at (r0, c0) of a row-major bf16
// [*, gld] array into shared memory (row stride sld); rows >= rlim and
// columns >= clim are filled with zeros. gld, c0 and clim are multiples of
// 8 and the base is 16-byte aligned.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_window_bf16(bf16* s, int sld,
                                                 const bf16* __restrict__ g,
                                                 int gld, int r0, int rlim,
                                                 int c0, int clim) {
  constexpr int PER_ROW = COLS / 8;
  constexpr int COUNT = ROWS * PER_ROW;
#pragma unroll
  for (int e0 = 0; e0 < COUNT; e0 += THREADS) {
    const int e = e0 + threadIdx.x;
    if (COUNT % THREADS != 0 && e >= COUNT) break;
    const int r = e / PER_ROW, c = (e % PER_ROW) * 8;
    const bool ok = r0 + r < rlim && c0 + c < clim;
    const bf16* src = ok ? g + (size_t)(r0 + r) * gld + (c0 + c) : g;
    cp_async16_bf16(s + r * sld + c, src, ok ? 16 : 0);
  }
}

}  // namespace
