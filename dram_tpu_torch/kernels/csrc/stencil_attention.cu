// Stencil attention of the PCM refinement (merge type
// 'scaled_dot_product_relu', k = 3, connectivity 2, no self loop).
//
// Replaces: dram_tpu/core/pallas/window_attention.py:stencil_attention
// forward (_fwd_impl -> _fwd_kernel), called from
// dram_tpu/models/pcm.py's use_pallas branch.
//
// For each voxel i of a (B, D, H, W) grid, over the valid neighbours j of
// the 18 offsets with |dz| + |dy| + |dx| <= 2, centre excluded (the order
// of dram_tpu/models/pcm.py:stencil_offsets(3, 2, False)):
//   s_ij  = relu(theta_i . phi_j) / sqrt(deg_i)
//   out_i = sum_j softmax_j(s_ij) * g_j
// deg_i is the count of valid neighbours.
//
// Bound on the H100: bytes. Per voxel the work is 18 x (8 + 8) FMAs
// against 4 x 32 bytes of theta/phi/g/out, so the floor is
// (|theta| + |phi| + |g| + |out|) / 3.35 TB/s.
//
// Design: one thread per voxel, F = G = 8 channels as two float4 each.
// The neighbour reads of phi and g are 18 gathers that neighbouring
// threads share, so they come from L1/L2 and the tensors leave device
// memory about once. Validity and degree come from the voxel's
// coordinates. Like the TPU kernel, the softmax is streamed: a running
// max (starting at 0, which the relu allows) and a running sum rescale
// the accumulator, so no K-deep logit map is stored. All arithmetic is
// f32. A 1-D grid-stride loop keeps every index in int64.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int F = 8;
constexpr int G = 8;

__device__ __forceinline__ bool offset_of(int k, int* dz, int* dy, int* dx) {
  // k in [0, 27): lexicographic (z, y, x) over {-1, 0, 1}^3
  *dz = k / 9 - 1;
  *dy = (k / 3) % 3 - 1;
  *dx = k % 3 - 1;
  const int l1 = abs(*dz) + abs(*dy) + abs(*dx);
  return l1 > 0 && l1 <= 2;
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__global__ void stencil_attention_kernel(const float* __restrict__ theta,
                                         const float* __restrict__ phi,
                                         const float* __restrict__ g,
                                         float* __restrict__ out, int64_t B,
                                         int64_t D, int64_t H, int64_t W) {
  const int64_t total = B * D * H * W;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    int64_t r = i;
    const int64_t x = r % W;
    r /= W;
    const int64_t y = r % H;
    r /= H;
    const int64_t z = r % D;

    int deg = 0;
#pragma unroll
    for (int k = 0; k < 27; ++k) {
      int dz, dy, dx;
      if (!offset_of(k, &dz, &dy, &dx)) continue;
      deg += (z + dz >= 0 && z + dz < D && y + dy >= 0 && y + dy < H &&
              x + dx >= 0 && x + dx < W);
    }
    const float rs = rsqrtf(fmaxf((float)deg, 1.f));

    float th[F];
    load8(theta + i * F, th);
    float m = 0.f, denom = 0.f, acc[G];
#pragma unroll
    for (int c = 0; c < G; ++c) acc[c] = 0.f;
#pragma unroll
    for (int k = 0; k < 27; ++k) {
      int dz, dy, dx;
      if (!offset_of(k, &dz, &dy, &dx)) continue;
      if (!(z + dz >= 0 && z + dz < D && y + dy >= 0 && y + dy < H &&
            x + dx >= 0 && x + dx < W))
        continue;
      const int64_t j = i + (dz * H + dy) * W + dx;
      float ph[F], gj[G];
      load8(phi + j * F, ph);
      load8(g + j * G, gj);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < F; ++c) dot += th[c] * ph[c];
      const float s = fmaxf(dot, 0.f) * rs;
      if (s > m) {
        const float sc = expf(m - s);
        denom *= sc;
#pragma unroll
        for (int c = 0; c < G; ++c) acc[c] *= sc;
        m = s;
      }
      const float e = expf(s - m);
      denom += e;
#pragma unroll
      for (int c = 0; c < G; ++c) acc[c] += e * gj[c];
    }
    const float inv = 1.f / fmaxf(denom, 1e-12f);
    float4* o = reinterpret_cast<float4*>(out + i * G);
    o[0] = make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv, acc[3] * inv);
    o[1] = make_float4(acc[4] * inv, acc[5] * inv, acc[6] * inv, acc[7] * inv);
  }
}

}  // namespace

extern "C" int stencil_attention_f32(const void* theta, const void* phi,
                                     const void* g, void* out, int64_t B,
                                     int64_t D, int64_t H, int64_t W,
                                     void* stream) {
  const int64_t total = B * D * H * W;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  stencil_attention_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)phi, (const float*)g, (float*)out, B,
      D, H, W);
  return (int)cudaGetLastError();
}
