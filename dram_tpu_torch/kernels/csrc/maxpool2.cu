// 2x2x2 stride-2 max-pool over NDHWC bf16 volumes, and its gradient.
//
// Replaces: dram_tpu/core/pallas/pool.py:maxpool2_flat (forward kernel in
// _fwd_call), reached through dram_tpu/core/pallas/cm.py:maxpool2_cm, and
// its backward pool.py:_mp_vjp_bwd (kernel _bwd_kernel :145); in its
// first-maximum mode, the VJP of flax's nn.max_pool on the unfused stack
// (dram_tpu/models/blocks.py:384).
//
// Bound on the H100: bytes. Each output element reads 8 inputs once and
// the op does one compare per input, far below the card's compute/byte
// ratio, so the floor is (|x| + |y|) / 3.35 TB/s.
//
// Design: one thread per (output voxel, 8-channel group). In NDHWC the 8
// channels of a voxel are 16 contiguous bytes, so every load and store is
// one 128-bit transaction and neighbouring threads touch neighbouring
// addresses. The TPU kernel's block-sparse lane-selection matrices exist
// only to compact windows inside its 128-lane (C, H*W) layout; with
// channels innermost no compaction is needed. The max is taken in f32 on
// exact bf16 values, so the result is bit-identical to F.max_pool3d.
// A 1-D grid-stride loop keeps every index in int64.
//
// Backward (maxpool2_bwd_bf16): dx = g / (number of tied maxima) at every
// window position that equals the window's maximum, 0 elsewhere -- the
// cotangent is split evenly across ties, as jnp reduce-max and the TPU
// kernel do (pool.py:24-26); F.max_pool3d routes it to one position. The
// pool's input is a post-ReLU activation, so windows of exact zeros tie
// often. Bound: bytes, (|x| + |g| + |dx|) / 3.35 TB/s. Same thread layout
// as the forward: one thread per (pooled voxel, 8-channel group) reads
// its 8 window rows and g with 128-bit loads, recomputes the maximum and
// the tie count in f32 on exact bf16 values, and writes the 8 dx rows;
// g / count is formed in f32 and the product rounded once, as the TPU
// kernel does (pool.py:176-180).
//
// First-maximum mode (first != 0): all of g goes to the FIRST window
// position, in row-major (dz, dy, dx) order, that equals the maximum, and
// 0 to the others. That is the VJP of XLA's reduce-window max
// (select-and-scatter with a >= select), which flax's nn.max_pool takes on
// the JAX package's unfused conv stack. g is copied, not divided, so the
// result is exact. Same thread layout and bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void maxpool2_kernel(const __nv_bfloat16* __restrict__ x,
                                __nv_bfloat16* __restrict__ y, int64_t B,
                                int64_t D, int64_t H, int64_t W, int64_t C) {
  const int64_t Do = D / 2, Ho = H / 2, Wo = W / 2, Cg = C / 8;
  const int64_t total = B * Do * Ho * Wo * Cg;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t g = i % Cg;
    int64_t v = i / Cg;
    const int64_t xo = v % Wo;
    v /= Wo;
    const int64_t yo = v % Ho;
    v /= Ho;
    const int64_t zo = v % Do;
    const int64_t b = v / Do;
    float m[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) m[k] = -INFINITY;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int64_t z = 2 * zo + (t >> 2), yy = 2 * yo + ((t >> 1) & 1),
                    xx = 2 * xo + (t & 1);
      const int64_t src = (((b * D + z) * H + yy) * W + xx) * C + g * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(x + src);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int k = 0; k < 8; ++k) m[k] = fmaxf(m[k], __bfloat162float(e[k]));
    }
    uint4 out;
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16(m[k]);
    *reinterpret_cast<uint4*>(y + i * 8) = out;
  }
}

__global__ void maxpool2_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                                    const __nv_bfloat16* __restrict__ g,
                                    __nv_bfloat16* __restrict__ dx, int64_t B,
                                    int64_t D, int64_t H, int64_t W,
                                    int64_t C, int first) {
  const int64_t Do = D / 2, Ho = H / 2, Wo = W / 2, Cg = C / 8;
  const int64_t total = B * Do * Ho * Wo * Cg;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t grp = i % Cg;
    int64_t v = i / Cg;
    const int64_t xo = v % Wo;
    v /= Wo;
    const int64_t yo = v % Ho;
    v /= Ho;
    const int64_t zo = v % Do;
    const int64_t b = v / Do;
    float e[8][8], m[8], cnt[8];
    int pick[8];  // first window position at the maximum
#pragma unroll
    for (int k = 0; k < 8; ++k) m[k] = -INFINITY;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int64_t z = 2 * zo + (t >> 2), yy = 2 * yo + ((t >> 1) & 1),
                    xx = 2 * xo + (t & 1);
      const int64_t src = (((b * D + z) * H + yy) * W + xx) * C + grp * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(x + src);
      const __nv_bfloat16* r = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        e[t][k] = __bfloat162float(r[k]);
        m[k] = fmaxf(m[k], e[t][k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      cnt[k] = 0.f;
      pick[k] = 8;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool tie = e[t][k] == m[k];
        cnt[k] += tie ? 1.f : 0.f;
        if (tie && pick[k] == 8) pick[k] = t;
      }
    const uint4 graw = *reinterpret_cast<const uint4*>(g + i * 8);
    const __nv_bfloat16* gv = reinterpret_cast<const __nv_bfloat16*>(&graw);
    float share[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      share[k] = first ? __bfloat162float(gv[k])
                       : __bfloat162float(gv[k]) / fmaxf(cnt[k], 1.f);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int64_t z = 2 * zo + (t >> 2), yy = 2 * yo + ((t >> 1) & 1),
                    xx = 2 * xo + (t & 1);
      const int64_t dst = (((b * D + z) * H + yy) * W + xx) * C + grp * 8;
      uint4 out;
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool sel = first ? t == pick[k] : e[t][k] == m[k];
        o[k] = __float2bfloat16(sel ? share[k] : 0.f);
      }
      *reinterpret_cast<uint4*>(dx + dst) = out;
    }
  }
}

int grid_blocks(int64_t total, int threads) {
  int64_t blocks = (total + threads - 1) / threads;
  return (int)(blocks > 132 * 64 ? 132 * 64 : blocks);
}

}  // namespace

// dx (B, D, H, W, C) from x (same shape) and the pooled cotangent g;
// first = 0 splits g evenly over tied maxima, first = 1 gives it to the
// first maximum in (dz, dy, dx) order
extern "C" int maxpool2_bwd_bf16(const void* x, const void* g, void* dx,
                                 int64_t B, int64_t D, int64_t H, int64_t W,
                                 int64_t C, int first, void* stream) {
  const int64_t total = B * (D / 2) * (H / 2) * (W / 2) * (C / 8);
  if (total == 0) return 0;
  maxpool2_bwd_kernel<<<grid_blocks(total, 256), 256, 0,
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (__nv_bfloat16*)dx,
      B, D, H, W, C, first);
  return (int)cudaGetLastError();
}

extern "C" int maxpool2_bf16(const void* x, void* y, int64_t B, int64_t D,
                             int64_t H, int64_t W, int64_t C, void* stream) {
  const int64_t total = B * (D / 2) * (H / 2) * (W / 2) * (C / 8);
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  maxpool2_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)y, B, D, H, W, C);
  return (int)cudaGetLastError();
}
