// Align-corners 2x trilinear upsample over NDHWC bf16 volumes, and its
// adjoint.
//
// Replaces: dram_tpu/core/pallas/upsample.py:up2_depth_flat (forward,
// _fwd_call) together with the two XLA einsum passes around it in
// dram_tpu/core/pallas/cm.py:upsample2x_cm, i.e. the whole decoder
// upsample. Source coordinate per axis: t = o * (n - 1) / (2n - 1)
// (cm.py:46-55, torch align_corners=True).
//
// Bound on the H100: bytes. The output is 8x the input and each output
// element costs 7 lerps, so the floor is (|x| + |y|) / 3.35 TB/s, almost
// all of it the output write.
//
// Design: one pass over all three axes, one thread per (output voxel,
// 8-channel group). The 8 corner reads are 128-bit loads of channel
// groups that neighbouring output voxels share, so they hit L1/L2 and the
// input leaves device memory about once. The lerp runs in f32 and the
// result is rounded to bf16 once; the TPU path rounds to the activation
// dtype between its three separable passes (cm.py:253-259), so the two
// differ by up to ~0.4% relative in bf16. A 1-D grid-stride loop keeps
// every index in int64.
//
// Backward (upsample2x_bwd_bf16): replaces dram_tpu/core/pallas/
// upsample.py:_bwd_call (the depth adjoint through the fixed-K gather
// tables of cm.py:_up2_adjoint_tables) together with the in-plane einsum
// adjoints XLA derives from cm.py:upsample2x_cm (:235-272). It is the
// exact adjoint of the forward kernel above: every output voxel o spreads
// its cotangent over its 8 corners with the forward's own weights, so
// along each axis input i gathers (1 - f_o) * dy[o] over the outputs with
// lo_o = i and f_o * dy[o] over those with hi_o = i, where (lo_o, hi_o,
// f_o) come from axis_src exactly as in the forward. Along an axis only
// outputs 2i-3 .. 2i+3 can reach input i (t_o = o (n-1)/(2n-1) < o/2).
// Bound: bytes, (|dy| + |dx|) / 3.35 TB/s, dominated by reading dy, 8x
// the size of dx. Design: one gather pass, one thread per (input voxel,
// 8-channel group), no atomics: the thread builds each axis's <= 7
// (output, weight) taps, then sums the weighted 128-bit dy rows over
// their product in f32 and rounds once to bf16. Neighbouring threads
// read overlapping dy rows, which L1/L2 serve. The TPU path rounds to
// the activation dtype between its three separable passes; the two
// differ by bf16 rounding (~2^-8 relative).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void axis_src(int64_t o, int64_t n, int64_t* lo,
                                         int64_t* hi, float* f) {
  // torch align_corners: scale = (n-1)/(out-1) in f32, src = scale * o
  const float scale = n > 1 ? (float)(n - 1) / (float)(2 * n - 1) : 0.f;
  const float t = scale * (float)o;
  int64_t l = (int64_t)floorf(t);
  if (l > n - 1) l = n - 1;
  *lo = l;
  *hi = l + 1 < n ? l + 1 : n - 1;
  *f = t - (float)l;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(e[k]);
}

__global__ void upsample2x_kernel(const __nv_bfloat16* __restrict__ x,
                                  __nv_bfloat16* __restrict__ y, int64_t B,
                                  int64_t D, int64_t H, int64_t W,
                                  int64_t C) {
  const int64_t Do = 2 * D, Ho = 2 * H, Wo = 2 * W, Cg = C / 8;
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
    int64_t z0, z1, y0, y1, x0, x1;
    float fz, fy, fx;
    axis_src(zo, D, &z0, &z1, &fz);
    axis_src(yo, H, &y0, &y1, &fy);
    axis_src(xo, W, &x0, &x1, &fx);
    const int64_t zs[2] = {z0, z1}, ys[2] = {y0, y1}, xs[2] = {x0, x1};
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float wz = a ? fz : 1.f - fz;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float wy = c ? fy : 1.f - fy;
        float lo[8], hi[8];
        const int64_t row = ((b * D + zs[a]) * H + ys[c]) * W;
        load8(x + (row + xs[0]) * C + g * 8, lo);
        load8(x + (row + xs[1]) * C + g * 8, hi);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc[k] += wz * wy * (lo[k] + fx * (hi[k] - lo[k]));
      }
    }
    uint4 out;
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16(acc[k]);
    *reinterpret_cast<uint4*>(y + i * 8) = out;
  }
}

// the outputs of a 2n axis that reach input i, with their weights
__device__ __forceinline__ int axis_taps(int64_t i, int64_t n, int64_t* o_out,
                                         float* w_out) {
  int k = 0;
  for (int64_t o = 2 * i - 3; o <= 2 * i + 3; ++o) {
    if (o < 0 || o >= 2 * n) continue;
    int64_t lo, hi;
    float f;
    axis_src(o, n, &lo, &hi, &f);
    const float wt = (lo == i ? 1.f - f : 0.f) + (hi == i ? f : 0.f);
    if (wt != 0.f) {
      o_out[k] = o;
      w_out[k] = wt;
      ++k;
    }
  }
  return k;
}

__global__ void upsample2x_bwd_kernel(const __nv_bfloat16* __restrict__ dy,
                                      __nv_bfloat16* __restrict__ dx,
                                      int64_t B, int64_t D, int64_t H,
                                      int64_t W, int64_t C) {
  const int64_t Do = 2 * D, Ho = 2 * H, Wo = 2 * W, Cg = C / 8;
  const int64_t total = B * D * H * W * Cg;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t g = i % Cg;
    int64_t v = i / Cg;
    const int64_t xi = v % W;
    v /= W;
    const int64_t yi = v % H;
    v /= H;
    const int64_t zi = v % D;
    const int64_t b = v / D;
    int64_t oz[7], oy[7], ox[7];
    float wz[7], wy[7], wx[7];
    const int nz = axis_taps(zi, D, oz, wz);
    const int ny = axis_taps(yi, H, oy, wy);
    const int nx = axis_taps(xi, W, ox, wx);
    float acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
    for (int a = 0; a < nz; ++a) {
      for (int c = 0; c < ny; ++c) {
        const float wzy = wz[a] * wy[c];
        const int64_t row = ((b * Do + oz[a]) * Ho + oy[c]) * Wo;
        for (int e = 0; e < nx; ++e) {
          float val[8];
          load8(dy + (row + ox[e]) * C + g * 8, val);
          const float wt = wzy * wx[e];
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] += wt * val[k];
        }
      }
    }
    uint4 out;
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = __float2bfloat16(acc[k]);
    *reinterpret_cast<uint4*>(dx + i * 8) = out;
  }
}

}  // namespace

// dx (B, D, H, W, C) from the cotangent dy (B, 2D, 2H, 2W, C)
extern "C" int upsample2x_bwd_bf16(const void* dy, void* dx, int64_t B,
                                   int64_t D, int64_t H, int64_t W,
                                   int64_t C, void* stream) {
  const int64_t total = B * D * H * W * (C / 8);
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  upsample2x_bwd_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)dy, (__nv_bfloat16*)dx, B, D, H, W, C);
  return (int)cudaGetLastError();
}

extern "C" int upsample2x_bf16(const void* x, void* y, int64_t B, int64_t D,
                               int64_t H, int64_t W, int64_t C,
                               void* stream) {
  const int64_t total = B * 8 * D * H * W * (C / 8);
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  upsample2x_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)y, B, D, H, W, C);
  return (int)cudaGetLastError();
}
