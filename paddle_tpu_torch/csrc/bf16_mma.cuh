// bf16 pieces of the Hopper (sm_90a) kernels over hopper_wgmma.cuh (the
// bf16 forms of the fused BN->ReLU->1x1-conv in bn_act_conv1x1.cu and the
// bf16 flash-attention kernels):
//
// - ldmatrix.x4.trans: four 8 x 8 bf16 matrices, lanes 8i..8i+7 giving the
//   row addresses of matrix i; a lane gets (rows 2t, 2t + 1, column g) of
//   each (g = lane / 4, t = lane % 4);
// - cvt.rn.bf16x2.f32: two f32 to one packed pair, round to nearest even,
//   as PyTorch's .to(torch.bfloat16), the lower column in the low half;
// - unpacking a bf16 pair to two f32 (exact).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "tf32_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
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

}  // namespace
