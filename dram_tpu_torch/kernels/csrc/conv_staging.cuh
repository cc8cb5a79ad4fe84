// Input staging shared by the 3x3x3 conv (conv3x3x3.cu) and its weight
// gradient (conv3x3x3_dw.cu): 16 consecutive channels of one voxel of a
// two-part NDHWC bf16 input ([x1 | x2], C1 + C2 channels), optionally
// through the BatchNorm affine + ReLU prologue.
//
// Zero padding: a voxel outside the volume (inb false) stages zeros, and
// stays zero after the prologue, since relu(0 * s + t) is not 0; channels
// past C1 + C2 stage zeros too. The prologue computes in f32 and rounds
// once to bf16, as dram_tpu/core/pallas/fused_stack.py:_dw_kernel_pro does
// (:249-258).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

static __device__ __forceinline__ __nv_bfloat16 input_elem(
    const __nv_bfloat16* __restrict__ x1, int C1,
    const __nv_bfloat16* __restrict__ x2, int C2, int64_t vox, int c) {
  if (c < C1) return x1[vox * C1 + c];
  if (c < C1 + C2) return x2[vox * C2 + (c - C1)];
  return __float2bfloat16(0.f);
}

static __device__ __forceinline__ void stage16_input(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ x1, int C1,
    const __nv_bfloat16* __restrict__ x2, int C2, int64_t vox, int c0,
    bool inb, const float* __restrict__ pro_s,
    const float* __restrict__ pro_t) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (!inb) {
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[j] = zero;
    return;
  }
  if (c0 + 16 <= C1 && (C1 & 7) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(x1 + vox * C1 + c0);
    reinterpret_cast<uint4*>(dst)[0] = s[0];
    reinterpret_cast<uint4*>(dst)[1] = s[1];
  } else if (c0 >= C1 && c0 + 16 <= C1 + C2 && (C2 & 7) == 0 &&
             ((c0 - C1) & 7) == 0) {
    const uint4* s =
        reinterpret_cast<const uint4*>(x2 + vox * C2 + (c0 - C1));
    reinterpret_cast<uint4*>(dst)[0] = s[0];
    reinterpret_cast<uint4*>(dst)[1] = s[1];
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[j] = input_elem(x1, C1, x2, C2, vox, c0 + j);
  }
  if (pro_s != nullptr) {
    const int Ci = C1 + C2;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + j;
      if (c < Ci)
        dst[j] = __float2bfloat16(
            fmaxf(__bfloat162float(dst[j]) * pro_s[c] + pro_t[c], 0.f));
    }
  }
}
