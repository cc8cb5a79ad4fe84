// Stencil attention of the PCM refinement (merge type
// 'scaled_dot_product_relu') on any stencil and any widths: the forward
// and the two passes of its gradient, for every offset list and every F
// (theta, phi) and G (g) that dram_tpu's fused kernel takes.
//
// Replaces: dram_tpu/core/pallas/window_attention.py:stencil_attention
// forward (_fwd_impl -> _fwd_kernel) and its custom VJP _vjp_bwd (the
// statistics pass _scal_kernel, the gradient pass _bwd_kernel) where the
// PCM's stencil or widths are not the shipped 18-offset, F = G = 8 ones,
// which csrc/stencil_attention.cu's plane-ring kernels keep.
//
// The arithmetic is that of csrc/stencil_attention.cu's header, over the
// K offsets o of the stencil (any subset of [-3, 3]^3, the centre
// included or not, in the order kernels/window_attention.py:
// stencil_offsets gives them):
//   s_io  = relu(theta_i . phi_{i+o}) / sqrt(deg_i) over valid i + o
//   out_i = sum_o softmax_o(s_io) g_{i+o}
//   scal_i = (r, m, denom, c): r = 1/sqrt(max(deg, 1)), m = max(0,
//     max_o s_io), denom = sum_o exp(s_io - m), c = sum_o a_io u_io with
//     u_io = ybar_i . g_{i+o}
//   dtheta_j = sum_o ds_o(j) phi_{j+o}          (+o side, at j)
//   dphi_j   = sum_o ds_o(j-o) theta_{j-o}      (-o side, i = j - o)
//   dg_j     = sum_o a_o(j-o) ybar_{j-o}
// with ds_o(i) = a_io (u_io - c_i) r_i [theta_i . phi_{i+o} > 0]. The -o
// side gathers over i = j - o for the o of the stencil, as the TPU
// kernel's rolls by -o do: a stencil need not hold -o with o (k = 5 at
// connectivity 1 and 2 does not, scipy's order-0 zoom rounding half-way
// coordinates up), so gathering over +o would sum other edges.
//
// Design: one thread per voxel, a 1-D grid-stride loop in int64; the
// offsets travel in the kernel's parameters (__grid_constant__, so they
// stay in the constant bank and every thread of a warp reads the same
// entry at once); neighbours are read straight from device memory through
// L1 / L2, 16 bytes at a time where a width is a multiple of 4 (the
// forward comes in two instantiations, BY_F, the statistics and gradient
// passes in four, BY_WIDTHS). A voxel's operands are
// F- and G-wide rows of any width 1..64, so a thread keeps no row in
// registers: it streams the rows, and builds
// its outputs CH channels at a time, sweeping the offsets once per group
// of CH output channels and recomputing the logits on each sweep. Two
// passes over the offsets give the softmax (the maximum, then the sums).
// Validity (and the degree) comes from the voxel's coordinates: a
// neighbour outside the volume is never read. The offsets run in a fixed
// order, so two launches give equal bits. All arithmetic is f32.
//
// Bound on the H100: bytes, as for the plane-ring kernels (each operand
// read once, each result written once). This design reads each neighbour
// row once per offset and sweep from L1 / L2: simple, right, and slow.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the stencils and widths these kernels take
constexpr int MAX_K = 343;
constexpr int MAX_HALO = 3;
constexpr int MAX_WIDTH = 64;
// output channels accumulated per sweep over the offsets
constexpr int CH = 8;
constexpr int THREADS = 256;

// the offsets as (dz, dy, dx, 0), in the plain version's order
struct Stencil {
  int k;
  char4 o[MAX_K];
};

struct Grid {
  int64_t B, D, H, W;
  int F, G;
};

__device__ __forceinline__ bool inside(int z, int y, int x, const Grid& g) {
  return z >= 0 && z < g.D && y >= 0 && y < g.H && x >= 0 && x < g.W;
}

// the linear distance from voxel i to voxel i + (dz, dy, dx)
__device__ __forceinline__ int64_t step_of(int dz, int dy, int dx,
                                           const Grid& g) {
  return ((int64_t)dz * g.H + dy) * g.W + dx;
}

// a . b over n floats in index order; with V4 (n % 4 == 0, rows 16-byte
// aligned) through 16-byte loads, the same sums in the same order
template <bool V4>
__device__ __forceinline__ float dot(const float* __restrict__ a,
                                     const float* __restrict__ b, int n) {
  float s = 0.f;
  if (V4) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (int q = 0; q < n / 4; ++q) {
      const float4 x = __ldg(a4 + q), y = __ldg(b4 + q);
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
      s = fmaf(x.z, y.z, s);
      s = fmaf(x.w, y.w, s);
    }
  } else {
    for (int e = 0; e < n; ++e) s = fmaf(__ldg(a + e), __ldg(b + e), s);
  }
  return s;
}

__device__ __forceinline__ void coords(int64_t v, const Grid& g, int* z,
                                       int* y, int* x) {
  *x = (int)(v % g.W);
  *y = (int)((v / g.W) % g.H);
  *z = (int)((v / (g.W * g.H)) % g.D);
}

template <bool VF>
__global__ void __launch_bounds__(THREADS) stencil_attention_generic_kernel(
    const float* __restrict__ theta, const float* __restrict__ phi,
    const float* __restrict__ gv, float* __restrict__ out, const Grid gd,
    const __grid_constant__ Stencil st) {
  const int64_t n = gd.B * gd.D * gd.H * gd.W;
  const int F = gd.F, G = gd.G;
  const int K = st.k;  // the forward's offsets
  for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; v < n;
       v += (int64_t)gridDim.x * blockDim.x) {
    int z, y, x;
    coords(v, gd, &z, &y, &x);
    const float* ti = theta + v * F;
    int deg = 0;
    for (int k = 0; k < K; ++k) {
      const char4 o = st.o[k];
      deg += inside(z + o.x, y + o.y, x + o.z, gd);
    }
    const float r = rsqrtf(fmaxf((float)deg, 1.f));
    float m = 0.f;
    for (int k = 0; k < K; ++k) {
      const char4 o = st.o[k];
      if (!inside(z + o.x, y + o.y, x + o.z, gd)) continue;
      const int64_t j = v + step_of(o.x, o.y, o.z, gd);
      m = fmaxf(m, fmaxf(dot<VF>(ti, phi + j * F, F), 0.f) * r);
    }
    for (int c0 = 0; c0 < G; c0 += CH) {
      float acc[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[c] = 0.f;
      float den = 0.f;
      for (int k = 0; k < K; ++k) {
        const char4 o = st.o[k];
        if (!inside(z + o.x, y + o.y, x + o.z, gd)) continue;
        const int64_t j = v + step_of(o.x, o.y, o.z, gd);
        const float e = expf(fmaxf(dot<VF>(ti, phi + j * F, F), 0.f) * r - m);
        den += e;
        const float* gj = gv + j * G + c0;
#pragma unroll
        for (int c = 0; c < CH; ++c)
          if (c0 + c < G) acc[c] = fmaf(e, __ldg(gj + c), acc[c]);
      }
      const float inv = 1.f / fmaxf(den, 1e-12f);
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (c0 + c < G) out[v * G + c0 + c] = acc[c] * inv;
    }
  }
}

// Backward pass 1: scal[i] = (r, m, denom, c).
template <bool VF, bool VG>
__global__ void __launch_bounds__(THREADS)
    stencil_attention_scal_generic_kernel(
        const float* __restrict__ theta, const float* __restrict__ phi,
        const float* __restrict__ gv, const float* __restrict__ ybar,
        float* __restrict__ scal, const Grid gd,
        const __grid_constant__ Stencil st) {
  const int64_t n = gd.B * gd.D * gd.H * gd.W;
  const int F = gd.F, G = gd.G;
  const int K = st.k;
  for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; v < n;
       v += (int64_t)gridDim.x * blockDim.x) {
    int z, y, x;
    coords(v, gd, &z, &y, &x);
    const float* ti = theta + v * F;
    const float* yi = ybar + v * G;
    int deg = 0;
    for (int k = 0; k < K; ++k) {
      const char4 o = st.o[k];
      deg += inside(z + o.x, y + o.y, x + o.z, gd);
    }
    const float r = rsqrtf(fmaxf((float)deg, 1.f));
    float m = 0.f;
    for (int k = 0; k < K; ++k) {
      const char4 o = st.o[k];
      if (!inside(z + o.x, y + o.y, x + o.z, gd)) continue;
      const int64_t j = v + step_of(o.x, o.y, o.z, gd);
      m = fmaxf(m, fmaxf(dot<VF>(ti, phi + j * F, F), 0.f) * r);
    }
    float den = 0.f, num = 0.f;
    for (int k = 0; k < K; ++k) {
      const char4 o = st.o[k];
      if (!inside(z + o.x, y + o.y, x + o.z, gd)) continue;
      const int64_t j = v + step_of(o.x, o.y, o.z, gd);
      const float e = expf(fmaxf(dot<VF>(ti, phi + j * F, F), 0.f) * r - m);
      den += e;
      num = fmaf(e, dot<VG>(yi, gv + j * G, G), num);
    }
    reinterpret_cast<float4*>(scal)[v] =
        make_float4(r, m, den, num / fmaxf(den, 1e-12f));
  }
}

// Backward pass 2: dtheta, dphi, dg at each voxel j, as gathers (no
// atomics): the +o side (dtheta) over the neighbours j + o, then the -o
// side (dphi, dg) over the voxels i = j - o whose edge o ends at j.
template <bool VF, bool VG>
__global__ void __launch_bounds__(THREADS)
    stencil_attention_bwd_generic_kernel(
        const float* __restrict__ theta, const float* __restrict__ phi,
        const float* __restrict__ gv, const float* __restrict__ ybar,
        const float* __restrict__ scal, float* __restrict__ dtheta,
        float* __restrict__ dphi, float* __restrict__ dg, const Grid gd,
        const __grid_constant__ Stencil st) {
  const int64_t n = gd.B * gd.D * gd.H * gd.W;
  const int F = gd.F, G = gd.G;
  const int K = st.k;
  const int sweeps = (max(F, G) + CH - 1) / CH;
  for (int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; v < n;
       v += (int64_t)gridDim.x * blockDim.x) {
    int z, y, x;
    coords(v, gd, &z, &y, &x);
    const float* tj = theta + v * F;
    const float* pj = phi + v * F;
    const float* gj = gv + v * G;
    const float* yj = ybar + v * G;
    const float4 sj = __ldg(reinterpret_cast<const float4*>(scal) + v);
    const float dj = fmaxf(sj.z, 1e-12f);
    // +o side: dtheta_j
    for (int c0 = 0; c0 < F; c0 += CH) {
      float acc[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[c] = 0.f;
      for (int k = 0; k < K; ++k) {
        const char4 o = st.o[k];
        if (!inside(z + o.x, y + o.y, x + o.z, gd)) continue;
        const int64_t j = v + step_of(o.x, o.y, o.z, gd);
        const float* pn = phi + j * F;
        const float s = dot<VF>(tj, pn, F);
        if (!(s > 0.f)) continue;
        const float a = expf(s * sj.x - sj.y) / dj;
        const float ds = a * (dot<VG>(yj, gv + j * G, G) - sj.w) * sj.x;
#pragma unroll
        for (int c = 0; c < CH; ++c)
          if (c0 + c < F) acc[c] = fmaf(ds, __ldg(pn + c0 + c), acc[c]);
      }
#pragma unroll
      for (int c = 0; c < CH; ++c)
        if (c0 + c < F) dtheta[v * F + c0 + c] = acc[c];
    }
    // -o side: dphi_j and dg_j, CH channels of each per sweep
    for (int q = 0; q < sweeps; ++q) {
      const int c0 = q * CH;
      float ap[CH], ag[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) ap[c] = ag[c] = 0.f;
      for (int k = 0; k < K; ++k) {
        const char4 o = st.o[k];
        const int sz = -o.x, sy = -o.y, sx = -o.z;  // i = j - o
        if (!inside(z + sz, y + sy, x + sx, gd)) continue;
        const int64_t i = v + step_of(sz, sy, sx, gd);
        const float4 si = __ldg(reinterpret_cast<const float4*>(scal) + i);
        const float* ti = theta + i * F;
        const float* yi = ybar + i * G;
        const float s2 = dot<VF>(ti, pj, F);
        const float a2 =
            expf(fmaxf(s2, 0.f) * si.x - si.y) / fmaxf(si.z, 1e-12f);
        if (c0 < F && s2 > 0.f) {
          const float ds2 = a2 * (dot<VG>(yi, gj, G) - si.w) * si.x;
#pragma unroll
          for (int c = 0; c < CH; ++c)
            if (c0 + c < F) ap[c] = fmaf(ds2, __ldg(ti + c0 + c), ap[c]);
        }
        if (c0 < G) {
#pragma unroll
          for (int c = 0; c < CH; ++c)
            if (c0 + c < G) ag[c] = fmaf(a2, __ldg(yi + c0 + c), ag[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (c0 + c < F) dphi[v * F + c0 + c] = ap[c];
        if (c0 + c < G) dg[v * G + c0 + c] = ag[c];
      }
    }
  }
}

// the instantiation of kernel K for the widths: 16-byte row loads where a
// width is a multiple of 4 (the forward reads g by scalar loads: F only)
#define BY_F(K, F) ((F) % 4 == 0 ? K<true> : K<false>)
#define BY_WIDTHS(K, F, G)                                   \
  ((F) % 4 == 0 ? ((G) % 4 == 0 ? K<true, true> : K<true, false>) \
                : ((G) % 4 == 0 ? K<false, true> : K<false, false>))

int64_t grid_blocks(int64_t total) {
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  return blocks < 132 * 32 ? blocks : 132 * 32;
}

// the stencil of `offs` (K triples dz, dy, dx) and the widths, or false
// when these kernels do not take them
bool stencil_of(const int32_t* offs, int64_t K, int64_t F, int64_t G,
                Stencil* st) {
  if (K < 1 || K > MAX_K || F < 1 || F > MAX_WIDTH || G < 1 ||
      G > MAX_WIDTH)
    return false;
  st->k = (int)K;
  for (int64_t k = 0; k < K; ++k) {
    for (int a = 0; a < 3; ++a)
      if (offs[3 * k + a] < -MAX_HALO || offs[3 * k + a] > MAX_HALO)
        return false;
    st->o[k] = make_char4((signed char)offs[3 * k],
                          (signed char)offs[3 * k + 1],
                          (signed char)offs[3 * k + 2], 0);
  }
  return true;
}

}  // namespace

// out (B, D, H, W, G) from theta, phi (B, D, H, W, F) and g (B, D, H, W,
// G); offs: K (dz, dy, dx) int32 triples in host memory
extern "C" int stencil_attention_generic_f32(
    const void* theta, const void* phi, const void* g, void* out, int64_t B,
    int64_t D, int64_t H, int64_t W, int64_t F, int64_t G,
    const int32_t* offs, int64_t K, void* stream) {
  Stencil st;
  if (!stencil_of(offs, K, F, G, &st)) return -1;
  const int64_t total = B * D * H * W;
  if (total == 0) return 0;
  const Grid gd{B, D, H, W, (int)F, (int)G};
  BY_F(stencil_attention_generic_kernel, F)<<<
      (unsigned)grid_blocks(total), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)phi, (const float*)g, (float*)out,
      gd, st);
  return (int)cudaGetLastError();
}

// scal (B, D, H, W, 4) from theta, phi, g and the cotangent ybar (B, D,
// H, W, G)
extern "C" int stencil_attention_scal_generic_f32(
    const void* theta, const void* phi, const void* g, const void* ybar,
    void* scal, int64_t B, int64_t D, int64_t H, int64_t W, int64_t F,
    int64_t G, const int32_t* offs, int64_t K, void* stream) {
  Stencil st;
  if (!stencil_of(offs, K, F, G, &st)) return -1;
  const int64_t total = B * D * H * W;
  if (total == 0) return 0;
  const Grid gd{B, D, H, W, (int)F, (int)G};
  BY_WIDTHS(stencil_attention_scal_generic_kernel, F, G)<<<
      (unsigned)grid_blocks(total), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)phi, (const float*)g,
      (const float*)ybar, (float*)scal, gd, st);
  return (int)cudaGetLastError();
}

// dtheta, dphi (B, D, H, W, F) and dg (B, D, H, W, G) from the operands,
// ybar and the statistics scal (B, D, H, W, 4)
extern "C" int stencil_attention_bwd_generic_f32(
    const void* theta, const void* phi, const void* g, const void* ybar,
    const void* scal, void* dtheta, void* dphi, void* dg, int64_t B,
    int64_t D, int64_t H, int64_t W, int64_t F, int64_t G,
    const int32_t* offs, int64_t K, void* stream) {
  Stencil st;
  if (!stencil_of(offs, K, F, G, &st)) return -1;
  const int64_t total = B * D * H * W;
  if (total == 0) return 0;
  const Grid gd{B, D, H, W, (int)F, (int)G};
  BY_WIDTHS(stencil_attention_bwd_generic_kernel, F, G)<<<
      (unsigned)grid_blocks(total), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)phi, (const float*)g,
      (const float*)ybar, (const float*)scal, (float*)dtheta, (float*)dphi,
      (float*)dg, gd, st);
  return (int)cudaGetLastError();
}
