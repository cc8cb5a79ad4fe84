// 3x3x3 zero-padded stride-1 convolution over NDHWC bf16 volumes with the
// eval-mode BatchNorm affine and ReLU applied in the epilogue.
//
// Replaces: dram_tpu/core/pallas/fused_stack.py:conv_cm (kernel
// _cbr_kernel), driven by fused_cbr2 / _fused_fwd, plus the separate
// stack-exit affine+ReLU pass of _fused_fwd (fused_stack.py:580-582).
//
// Bound on the H100: operations. The flagship stacks do ~0.92 TFLOP per
// 80^3 chunk against a few hundred MB of activations, far above the
// card's ~295 flop/byte balance point, so the floor is FLOPs / 989
// TFLOP/s (bf16 tensor cores).
//
// Design: implicit GEMM on the tensor cores through WMMA bf16 16x16x16
// fragments (f32 accumulation). One block owns a tile of 64 consecutive
// output voxels x 64 output channels; K = 27 taps x Ci runs as 27 tap
// steps x ceil(Ci/32) channel chunks. Per step the block stages the
// shifted input rows (64 x 32, zero outside the volume, which is the
// conv's zero padding) and the weight slice (32 x 64) in shared memory,
// then 4 warps each multiply a 32x32 sub-tile. The epilogue stages the
// f32 accumulator in shared memory and writes relu(acc * scale + shift)
// as bf16, so BN and ReLU are applied to the f32 sum. The TPU path
// instead rounds the raw conv output to bf16 before the next stack's
// prologue affine; the two differ by bf16 rounding of the pre-affine
// value (~2^-8 relative).
//
// The input arrives in two parts (x1: C1 channels, x2: C2 channels) that
// act as one [x1, x2] channel concat, the decoder's [upsample, skip], so
// the concat is never written to memory (the TPU kernel's "virtual
// concat"). Ci = C1 + C2 may be any size (Ci = 1 at the network entry):
// channels past Ci are zero in the staged tile, so no padded copy exists.
// 16-channel runs that lie inside one part load as two 128-bit loads;
// anything else loads per element.
//
// Shared memory is 5 KB + 4.5 KB + 17 KB, under the 48 KB static limit.
// Every __syncthreads() sits in loops whose trip counts are uniform over
// the block. Voxel indices are int64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;   // output voxels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // input channels per K step
constexpr int APAD = 8;  // row pads keep WMMA pointers 32-byte aligned
constexpr int BPAD = 8;
constexpr int CPAD = 4;

__device__ __forceinline__ void load16_input(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ x1, int C1,
    const __nv_bfloat16* __restrict__ x2, int C2, int64_t vox, int c0,
    bool inb) {
  if (inb && c0 + 16 <= C1 && (C1 & 7) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(x1 + vox * C1 + c0);
    reinterpret_cast<uint4*>(dst)[0] = s[0];
    reinterpret_cast<uint4*>(dst)[1] = s[1];
    return;
  }
  if (inb && c0 >= C1 && c0 + 16 <= C1 + C2 && (C2 & 7) == 0 &&
      ((c0 - C1) & 7) == 0) {
    const uint4* s =
        reinterpret_cast<const uint4*>(x2 + vox * C2 + (c0 - C1));
    reinterpret_cast<uint4*>(dst)[0] = s[0];
    reinterpret_cast<uint4*>(dst)[1] = s[1];
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = c0 + j;
    __nv_bfloat16 v = zero;
    if (inb) {
      if (c < C1)
        v = x1[vox * C1 + c];
      else if (c < C1 + C2)
        v = x2[vox * C2 + (c - C1)];
    }
    dst[j] = v;
  }
}

__device__ __forceinline__ void load16_weight(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ w, int tap, int c,
    int Ci, int n, int Co) {
  const int64_t base = ((int64_t)tap * Ci + c) * Co + n;
  if (c < Ci && n + 16 <= Co && (Co & 7) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(w + base);
    reinterpret_cast<uint4*>(dst)[0] = s[0];
    reinterpret_cast<uint4*>(dst)[1] = s[1];
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    dst[j] = (c < Ci && n + j < Co) ? w[base + j] : zero;
}

__global__ void __launch_bounds__(128)
    conv3x3x3_kernel(const __nv_bfloat16* __restrict__ x1, int C1,
                     const __nv_bfloat16* __restrict__ x2, int C2,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     __nv_bfloat16* __restrict__ y, int B, int D, int H, int W,
                     int Co) {
  __shared__ __align__(128) __nv_bfloat16 As[BM][BK + APAD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK][BN + BPAD];
  __shared__ __align__(128) float Cs[BM][BN + CPAD];

  const int64_t V = (int64_t)B * D * H * W;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int Ci = C1 + C2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  // A staging: thread -> (row, 16-channel half) of the 64 x 32 tile
  const int arow = tid >> 1, akof = (tid & 1) * 16;
  const int64_t v = m0 + arow;
  const bool rowok = v < V;
  int vx = 0, vy = 0, vz = 0;
  int64_t vb = 0;
  if (rowok) {
    int64_t r = v;
    vx = (int)(r % W);
    r /= W;
    vy = (int)(r % H);
    r /= H;
    vz = (int)(r % D);
    vb = r / D;
  }
  // B staging: thread -> (row, 16-column quarter) of the 32 x 64 tile
  const int brow = tid >> 2, bcol = (tid & 3) * 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nkc = (Ci + BK - 1) / BK;
  for (int tap = 0; tap < 27; ++tap) {
    const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
    const int zz = vz + dz, yy = vy + dy, xx = vx + dx;
    const bool inb = rowok && zz >= 0 && zz < D && yy >= 0 && yy < H &&
                     xx >= 0 && xx < W;
    const int64_t nvox = inb ? ((vb * D + zz) * H + yy) * W + xx : 0;
    for (int kc = 0; kc < nkc; ++kc) {
      load16_input(&As[arow][akof], x1, C1, x2, C2, nvox, kc * BK + akof,
                   inb);
      load16_weight(&Bs[brow][bcol], w, tap, kc * BK + brow, Ci, n0 + bcol,
                    Co);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &As[wm + i * 16][kk], BK + APAD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bf[j], &Bs[kk][wn + j * 16], BN + BPAD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + i * 16][wn + j * 16], acc[i][j],
                              BN + CPAD, wmma::mem_row_major);
  __syncthreads();

  // epilogue: thread -> (row, 32-column half)
  const int orow = tid >> 1, ocol = (tid & 1) * 32;
  const int64_t ov = m0 + orow;
  if (ov < V) {
    __nv_bfloat16* yrow = y + ov * Co;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const int n = n0 + ocol + j;
      if (n < Co) {
        yrow[n] = __float2bfloat16(
            fmaxf(Cs[orow][ocol + j] * scale[n] + shift[n], 0.f));
      }
    }
  }
}

}  // namespace

extern "C" int conv3x3x3_bf16(const void* x1, int C1, const void* x2, int C2,
                              const void* w, const void* scale,
                              const void* shift, void* y, int B, int D, int H,
                              int W, int Co, void* stream) {
  const int64_t V = (int64_t)B * D * H * W;
  if (V == 0 || Co == 0) return 0;
  const dim3 grid((unsigned)((V + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN));
  conv3x3x3_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x1, C1, (const __nv_bfloat16*)x2, C2,
      (const __nv_bfloat16*)w, (const float*)scale, (const float*)shift,
      (__nv_bfloat16*)y, B, D, H, W, Co);
  return (int)cudaGetLastError();
}
