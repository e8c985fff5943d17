// Tensor-core pieces shared by the fused BN->ReLU->1x1-conv kernels
// (bn_act_conv1x1.cu) and the flash-attention forward (flash_attn_fwd.cu),
// for Hopper (sm_90a), f32 accuracy on TF32 units.
//
// - PTX wrappers: cp.async (16- and 4-byte, with a source size of 0 for
//   zero fill), its commit/wait, cvt.rna.tf32 and mma.sync m16n8k8 TF32;
// - the 3xTF32 split: x = hi + lo with hi = tf32(x), lo = tf32(x - hi) (by
//   cvt.rna, or by integer ops in split_tf32_alu), and
//   the product hi*hi' + hi*lo' + lo*hi' of one 8-deep k-step, issued pass
//   by pass over a warp's mma tiles so that no two dependent mma are adjacent
//   (one TF32 pass keeps ~3 digits; the three keep ~21 bits);
// - load_window: the cp.async of a rectangle of a row-major array into
//   shared memory, zero-filled past its row and column limits.
//
// Fragments of mma.m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte copy global -> shared; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4-byte copy (a width that is not a multiple of 4)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// round to TF32 (10 mantissa bits), to nearest, ties away from zero
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// c += a (16 x 8, row) * b (8 x 8, col), TF32 inputs, f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// end of PTX wrappers

// x = hi + lo: hi = tf32(x), lo = tf32(x - hi) (the difference is exact)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// The same split without the conversion unit (cvt runs at a quarter of the
// ALU rate): hi is rounded as cvt.rna rounds, by integer ops on the bits,
// and lo = x - hi (exact) is truncated to TF32 by clearing its low 13 bits.
// |hi + lo - x| <= 2^-21 |x|, as with two cvt.rna.
__device__ __forceinline__ void split_tf32_alu(float x, unsigned& hi,
                                               unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xffffe000u;
}

// The 3xTF32 product of one k-step (8 deep) for a warp's MT x NT mma tiles,
// pass by pass: the small terms first, then hi*hi.
template <int MT, int NT>
__device__ __forceinline__ void mma3_step(float (&acc)[MT][NT][4],
                                          const unsigned (&ahi)[MT][4],
                                          const unsigned (&alo)[MT][4],
                                          const unsigned (&bhi)[NT][2],
                                          const unsigned (&blo)[NT][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], alo[i], bhi[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ahi[i], blo[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ahi[i], bhi[j]);
}

// cp.async of the ROWS x COLS window at (r0, c0) of a row-major [*, gld]
// array into shared memory (row stride sld); rows >= rlim and columns >=
// clim are filled with zeros. VEC 4: 16-byte copies (gld, c0 and clim
// multiples of 4, the base 16-byte aligned); VEC 1: 4-byte copies.
template <int ROWS, int COLS, int VEC, int THREADS>
__device__ __forceinline__ void load_window(float* s, int sld,
                                            const float* __restrict__ g,
                                            int gld, int r0, int rlim,
                                            int c0, int clim) {
  constexpr int PER_ROW = COLS / VEC;
  constexpr int COUNT = ROWS * PER_ROW;
#pragma unroll
  for (int e0 = 0; e0 < COUNT; e0 += THREADS) {
    const int e = e0 + threadIdx.x;
    if (COUNT % THREADS != 0 && e >= COUNT) break;
    const int r = e / PER_ROW, c = (e % PER_ROW) * VEC;
    const bool ok = r0 + r < rlim && c0 + c < clim;
    const float* src = ok ? g + (size_t)(r0 + r) * gld + (c0 + c) : g;
    if (VEC == 4)
      cp_async16(s + r * sld + c, src, ok ? 16 : 0);
    else
      cp_async4(s + r * sld + c, src, ok ? 4 : 0);
  }
}

}  // namespace
