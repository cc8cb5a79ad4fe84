// Stencil attention of the PCM refinement (merge type
// 'scaled_dot_product_relu', k = 3, connectivity 2, no self loop): the
// forward and the two passes of its gradient.
//
// Replaces: dram_tpu/core/pallas/window_attention.py:stencil_attention
// forward (_fwd_impl -> _fwd_kernel), called from
// dram_tpu/models/pcm.py's use_pallas branch, and its custom VJP
// _vjp_bwd: the statistics pass (_scal_kernel) and the gradient pass
// (_bwd_kernel).
//
// For each voxel i of a (B, D, H, W) grid, over the valid neighbours j of
// the 18 offsets with |dz| + |dy| + |dx| <= 2, centre excluded (the order
// of dram_tpu/models/pcm.py:stencil_offsets(3, 2, False)):
//   s_ij  = relu(theta_i . phi_j) / sqrt(deg_i)
//   out_i = sum_j softmax_j(s_ij) * g_j
// deg_i is the count of valid neighbours.
//
// Backward, with cotangent ybar of out, a_ij the softmax weights and
// u_ij = ybar_i . g_j:
//   scal pass, per voxel i: r = 1/sqrt(max(deg, 1)), m = max(0, max_j
//     s_ij), denom = sum_j exp(s_ij - m), c = sum_j a_ij u_ij;
//   gradient pass, per voxel j, as gathers (no atomics, so the gradients
//     are the same from run to run), with ds_o(i) = a (u - c) r [dot > 0]
//     for the neighbour i + o of i:
//       dtheta_j = sum_o ds_o(j) phi_{j+o}             (+o side, at j)
//       dphi_j   = sum_o ds_o(j-o) theta_{j-o}         (-o side, i = j-o)
//       dg_j     = sum_o a_o(j-o) ybar_{j-o}
//     The -o side reads r, m, denom and c of i from the scal map, which is
//     why the statistics are their own pass: every voxel's must exist
//     before the gradient pass reads its neighbours'.
//
// Bound on the H100: bytes. Per voxel the forward does 18 x (8 + 8) FMAs
// against 4 x 32 bytes of theta/phi/g/out; the scal pass moves 144 bytes
// (theta, phi, g, ybar in, 4 statistics out) and the gradient pass 240
// (those four and the statistics in, three gradients out) for about 700
// and 2,000 flops: all three sit below the card's ~20 flop/byte f32 line.
//
// Design: one thread per voxel, F = G = 8 channels as two float4 each.
// The neighbour reads are 18 gathers that neighbouring threads share, so
// they come from L1/L2 and the tensors leave device memory about once.
// Validity and degree come from the voxel's coordinates. Like the TPU
// kernel, the forward and the scal pass stream the softmax: a running max
// (starting at 0, which the relu allows) and a running sum rescale the
// accumulators, so no K-deep logit map is stored. All arithmetic is f32.
// A 1-D grid-stride loop keeps every index in int64.

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

__device__ __forceinline__ void store8(float* p, const float* v) {
  float4* o = reinterpret_cast<float4*>(p);
  o[0] = make_float4(v[0], v[1], v[2], v[3]);
  o[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float dot8(const float* a, const float* b) {
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) d += a[c] * b[c];
  return d;
}

// neighbour (z + dz, y + dy, x + dx) lies inside the volume
__device__ __forceinline__ bool inside(int64_t z, int64_t y, int64_t x,
                                       int dz, int dy, int dx, int64_t D,
                                       int64_t H, int64_t W) {
  return z + dz >= 0 && z + dz < D && y + dy >= 0 && y + dy < H &&
         x + dx >= 0 && x + dx < W;
}

__device__ __forceinline__ int degree(int64_t z, int64_t y, int64_t x,
                                      int64_t D, int64_t H, int64_t W) {
  int deg = 0;
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    int dz, dy, dx;
    if (!offset_of(k, &dz, &dy, &dx)) continue;
    deg += inside(z, y, x, dz, dy, dx, D, H, W);
  }
  return deg;
}

// coordinates (z, y, x) of flat voxel i of a (B, D, H, W) grid
__device__ __forceinline__ void coords(int64_t i, int64_t D, int64_t H,
                                       int64_t W, int64_t* z, int64_t* y,
                                       int64_t* x) {
  *x = i % W;
  i /= W;
  *y = i % H;
  i /= H;
  *z = i % D;
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
    int64_t z, y, x;
    coords(i, D, H, W, &z, &y, &x);
    const float rs = rsqrtf(fmaxf((float)degree(z, y, x, D, H, W), 1.f));

    float th[F];
    load8(theta + i * F, th);
    float m = 0.f, denom = 0.f, acc[G];
#pragma unroll
    for (int c = 0; c < G; ++c) acc[c] = 0.f;
#pragma unroll
    for (int k = 0; k < 27; ++k) {
      int dz, dy, dx;
      if (!offset_of(k, &dz, &dy, &dx)) continue;
      if (!inside(z, y, x, dz, dy, dx, D, H, W)) continue;
      const int64_t j = i + (dz * H + dy) * W + dx;
      float ph[F], gj[G];
      load8(phi + j * F, ph);
      load8(g + j * G, gj);
      const float s = fmaxf(dot8(th, ph), 0.f) * rs;
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
#pragma unroll
    for (int c = 0; c < G; ++c) acc[c] *= inv;
    store8(out + i * G, acc);
  }
}

// Backward pass 1: scal[i] = (r, m, denom, c), streamed like the forward.
__global__ void stencil_attention_scal_kernel(
    const float* __restrict__ theta, const float* __restrict__ phi,
    const float* __restrict__ g, const float* __restrict__ ybar,
    float* __restrict__ scal, int64_t B, int64_t D, int64_t H, int64_t W) {
  const int64_t total = B * D * H * W;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    int64_t z, y, x;
    coords(i, D, H, W, &z, &y, &x);
    const float rs = rsqrtf(fmaxf((float)degree(z, y, x, D, H, W), 1.f));

    float th[F], yb[G];
    load8(theta + i * F, th);
    load8(ybar + i * G, yb);
    float m = 0.f, denom = 0.f, num = 0.f;  // num = sum_j e_j u_j
#pragma unroll
    for (int k = 0; k < 27; ++k) {
      int dz, dy, dx;
      if (!offset_of(k, &dz, &dy, &dx)) continue;
      if (!inside(z, y, x, dz, dy, dx, D, H, W)) continue;
      const int64_t j = i + (dz * H + dy) * W + dx;
      float ph[F], gj[G];
      load8(phi + j * F, ph);
      load8(g + j * G, gj);
      const float s = fmaxf(dot8(th, ph), 0.f) * rs;
      const float u = dot8(yb, gj);
      if (s > m) {
        const float sc = expf(m - s);
        denom *= sc;
        num *= sc;
        m = s;
      }
      const float e = expf(s - m);
      denom += e;
      num += e * u;
    }
    const float c = num / fmaxf(denom, 1e-12f);
    reinterpret_cast<float4*>(scal)[i] = make_float4(rs, m, denom, c);
  }
}

// Backward pass 2: dtheta, dphi, dg at voxel v as gathers over the +o
// side (v's own softmax) and the -o side (the softmax of i = v - o, read
// from the scal map).
__global__ void stencil_attention_bwd_kernel(
    const float* __restrict__ theta, const float* __restrict__ phi,
    const float* __restrict__ g, const float* __restrict__ ybar,
    const float* __restrict__ scal, float* __restrict__ dtheta,
    float* __restrict__ dphi, float* __restrict__ dg, int64_t B, int64_t D,
    int64_t H, int64_t W) {
  const int64_t total = B * D * H * W;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < total;
       v += stride) {
    int64_t z, y, x;
    coords(v, D, H, W, &z, &y, &x);
    float th[F], ph[F], gv[G], yb[G];
    load8(theta + v * F, th);
    load8(phi + v * F, ph);
    load8(g + v * G, gv);
    load8(ybar + v * G, yb);
    const float4 sv = reinterpret_cast<const float4*>(scal)[v];
    const float rv = sv.x, mv = sv.y, dv = fmaxf(sv.z, 1e-12f), cv = sv.w;
    float dth[F], dph[F], dgv[G];
#pragma unroll
    for (int c = 0; c < F; ++c) dth[c] = dph[c] = dgv[c] = 0.f;
#pragma unroll
    for (int k = 0; k < 27; ++k) {
      int dz, dy, dx;
      if (!offset_of(k, &dz, &dy, &dx)) continue;
      const int64_t off = (dz * H + dy) * W + dx;
      // +o side: v's softmax over its neighbour n = v + o
      if (inside(z, y, x, dz, dy, dx, D, H, W)) {
        float pn[F], gn[G];
        load8(phi + (v + off) * F, pn);
        load8(g + (v + off) * G, gn);
        const float s = dot8(th, pn);
        const float a = expf(fmaxf(s, 0.f) * rv - mv) / dv;
        const float ds = s > 0.f ? a * (dot8(yb, gn) - cv) * rv : 0.f;
#pragma unroll
        for (int c = 0; c < F; ++c) dth[c] += ds * pn[c];
      }
      // -o side: the softmax of i = v - o, whose neighbour v is; edge
      // validity is i's own
      if (inside(z, y, x, -dz, -dy, -dx, D, H, W)) {
        float ti[F], yi[G];
        load8(theta + (v - off) * F, ti);
        load8(ybar + (v - off) * G, yi);
        const float4 si = reinterpret_cast<const float4*>(scal)[v - off];
        const float s2 = dot8(ti, ph);
        const float a2 = expf(fmaxf(s2, 0.f) * si.x - si.y) /
                         fmaxf(si.z, 1e-12f);
        const float ds2 = s2 > 0.f ? a2 * (dot8(yi, gv) - si.w) * si.x : 0.f;
#pragma unroll
        for (int c = 0; c < F; ++c) dph[c] += ds2 * ti[c];
#pragma unroll
        for (int c = 0; c < G; ++c) dgv[c] += a2 * yi[c];
      }
    }
    store8(dtheta + v * F, dth);
    store8(dphi + v * F, dph);
    store8(dg + v * G, dgv);
  }
}

int64_t grid_blocks(int64_t total, int threads) {
  const int64_t blocks = (total + threads - 1) / threads;
  return blocks < 132 * 64 ? blocks : 132 * 64;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int stencil_attention_f32(const void* theta, const void* phi,
                                     const void* g, void* out, int64_t B,
                                     int64_t D, int64_t H, int64_t W,
                                     void* stream) {
  const int64_t total = B * D * H * W;
  if (total == 0) return 0;
  stencil_attention_kernel<<<(unsigned)grid_blocks(total, kThreads), kThreads,
                             0, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)phi, (const float*)g, (float*)out, B,
      D, H, W);
  return (int)cudaGetLastError();
}

extern "C" int stencil_attention_scal_f32(const void* theta, const void* phi,
                                          const void* g, const void* ybar,
                                          void* scal, int64_t B, int64_t D,
                                          int64_t H, int64_t W,
                                          void* stream) {
  const int64_t total = B * D * H * W;
  if (total == 0) return 0;
  stencil_attention_scal_kernel<<<(unsigned)grid_blocks(total, kThreads),
                                  kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)phi, (const float*)g,
      (const float*)ybar, (float*)scal, B, D, H, W);
  return (int)cudaGetLastError();
}

extern "C" int stencil_attention_bwd_f32(const void* theta, const void* phi,
                                         const void* g, const void* ybar,
                                         const void* scal, void* dtheta,
                                         void* dphi, void* dg, int64_t B,
                                         int64_t D, int64_t H, int64_t W,
                                         void* stream) {
  const int64_t total = B * D * H * W;
  if (total == 0) return 0;
  stencil_attention_bwd_kernel<<<(unsigned)grid_blocks(total, kThreads),
                                 kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)phi, (const float*)g,
      (const float*)ybar, (const float*)scal, (float*)dtheta, (float*)dphi,
      (float*)dg, B, D, H, W);
  return (int)cudaGetLastError();
}
