// Stencil attention of the PCM refinement (merge type
// 'scaled_dot_product_relu') on any stencil and any widths: the forward
// and the statistics pass of its gradient, for every offset list and
// every F (theta, phi) and G (g) that dram_tpu's fused kernel takes (the
// gradient pass: csrc/stencil_attention_generic_bwd.cu).
//
// Replaces: dram_tpu/core/pallas/window_attention.py:stencil_attention
// forward (_fwd_impl :274 -> pallas_call :288, _fwd_kernel :53) and the
// statistics pass of its custom VJP (_vjp_bwd :317 -> :335,
// _scal_kernel) where the PCM's stencil or widths are not the shipped
// 18-offset, F = G = 8 ones, which csrc/stencil_attention.cu's
// plane-ring kernels keep.
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
//
// The forward (stencil_attention_generic_kernel): a plane ring
// (csrc/stencil_generic_ring.cuh). A block stages phi and g of its tile
// with a +-h halo plane by plane; a thread keeps its voxel's theta row
// in registers and streams the offsets of its plane in their order, dz
// group by dz group from the staged planes, with one online softmax: a
// running maximum from 0 (the relu allows it) that rescales the
// denominator and the G accumulators when it grows, so each edge's
// logit is computed once. The edge loop has no branch (an edge outside
// the volume reads the voxel's own slot and adds nothing), so that the
// compiler can overlap an edge's shared-memory reads and dot with the
// previous edge's exponentials. The degree comes from
// coordinates (K where the voxel is h or more from every face). Bound on
// the H100: operations, the edges' 2F + 2G flops of dots and sums
// against each row read once (chip_smoke.py:generic_pass_work).
//
// The statistics pass (stencil_attention_scal_generic_kernel) is still
// one thread per voxel with a 1-D grid-stride loop in int64; the offsets
// travel in the kernel's parameters (__grid_constant__, so they stay in
// the constant bank and every thread of a warp reads the same entry at
// once); neighbours are read straight from device memory through L1 /
// L2, 16 bytes at a time where a width is a multiple of 4 (four
// instantiations, BY_WIDTHS). Two passes over the offsets give the
// softmax (the maximum, then the sums). Validity (and the degree) comes
// from the voxel's coordinates: a neighbour outside the volume is never
// read.
//
// The offsets run in a fixed order, so two launches give equal bits. All
// arithmetic is f32 on the CUDA cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stencil_generic_ring.cuh"

namespace {

// the stencils and widths these kernels take
constexpr int MAX_K = 343;
constexpr int MAX_HALO = 3;
constexpr int MAX_WIDTH = 64;
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

// the instantiation of kernel K for the widths: 16-byte row loads where a
// width is a multiple of 4
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


// The forward on the plane ring. The buffer of a plane holds phi, then g
// of the staged box.
template <int L, int CF, int CG>
__global__ void __launch_bounds__(sg::MAX_THREADS, sg::MIN_BLOCKS)
    stencil_attention_generic_kernel(const float* __restrict__ theta,
                                     const float* __restrict__ phi,
                                     const float* __restrict__ gv,
                                     float* __restrict__ out, int D, int H,
                                     int W, int F, int G, const sg::Plan p,
                                     const __grid_constant__ sg::Stencil st) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + sg::MAX_NBUF;
  float* bufs = reinterpret_cast<float*>(smem + sg::BAR_BYTES);
  const int nqf = F / 4, nqg = G / 4;
  const int seg = p.rows * p.cols;  // voxels of one operand's plane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cwarps = p.sets * sg::voxel_warps(p);
  const sg::Tile t = sg::tile_of(p, blockIdx.x, D, H, W);
  const int ncols = t.cx1 - t.cx0 + 1, h = p.h;
  if (t.ry1 - t.ry0 + 1 > p.rows || ncols > p.cols) __trap();
  sg::ring_init(full, empty, p.nbuf, cwarps);

  if (warp == cwarps) {
    sg::Ops<2> ops{{phi, gv}, {F, G}};
    sg::produce(p, t, st, 1, D, empty, [&](int s, int pl) {
      sg::stage_plane(bufs + (size_t)s * seg * (F + G), ops, p, t, ncols,
                      D, H, W, pl, &full[s], lane);
    });
    return;
  }

  const sg::Thread th = sg::thread_of<L>(p, t, warp, lane);
  const int pf = L == 1 ? sg::rot_of(lane, nqf) : 0;
  const int pg = L == 1 ? sg::rot_of(lane, nqg) : 0;
  // the voxel's staged slot; in a warp whose voxels are all h or more
  // from the y and x faces every in-plane neighbour lies inside
  const int at = (th.y - t.ry0) * ncols + (th.x - t.cx0);
  const bool inner = __all_sync(0xffffffffu, !th.active || (th.y >= h &&
                                th.y + h < H && th.x >= h && th.x + h < W));
  sg::Ring ring{full, empty, bufs, seg * (F + G), p.nbuf, t.pz0, t.pz1,
                p.reload, 0, t.pz0};
  for (int z = t.za + th.set; z < t.zb; z += p.sets) {
    if (!p.reload) ring.enter(z, h, lane);
    const int64_t v = (((int64_t)t.b * D + z) * H + th.y) * W + th.x;
    float4 tc[CF], acc[CG];
    float rs = 0.f;
    if (th.active) {
      sg::load_g<L, CF>(theta + v * F, nqf, pf, th.sub, tc);
      int deg = st.k;
      if (z < h || z + h >= D || th.y < h || th.y + h >= H || th.x < h ||
          th.x + h >= W) {
        deg = 0;
        for (int k = 0; k < st.k; ++k) {
          const char4 o = st.o[k];
          deg += z + o.x >= 0 && z + o.x < D && th.y + o.y >= 0 &&
                 th.y + o.y < H && th.x + o.z >= 0 && th.x + o.z < W;
        }
      }
      rs = rsqrtf(fmaxf((float)deg, 1.f));
    }
    sg::zero(acc);
    float m = 0.f, den = 0.f;
    for (int d = -h; d <= h; ++d) {
      if (!sg::step_reads(st, z, d, 1, D)) continue;
      const float* buf = p.reload ? ring.next() : ring.plane(z + d);
      // the offsets with dz = d, edge by edge
      auto edges = [&](auto checked) {
        const float* pb = buf;
        const float* gb = buf + seg * F;
#pragma unroll sg::FWD_UNROLL
        for (int k = st.start[d + sg::MAX_HALO];
             k < st.start[d + sg::MAX_HALO + 1]; ++k) {
          // an edge outside the volume reads the voxel's own slot and
          // adds nothing: no branch, so unrolled edges overlap
          const char4 o = st.o[k];
          const bool ok = !decltype(checked)::value ||
                          (th.y + o.y >= 0 && th.y + o.y < H &&
                           th.x + o.z >= 0 && th.x + o.z < W);
          const int idx = ok ? at + o.y * ncols + o.z : at;
          float4 pn[CF], gn[CG];
          sg::load_s<L, CF>(pb + idx * F, nqf, pf, th.sub, pn);
          sg::load_s<L, CG>(gb + idx * G, nqg, pg, th.sub, gn);
          const float l =
              ok ? fmaxf(sg::dot<L, CF>(tc, pn, lane), 0.f) * rs : 0.f;
          // the online softmax: a larger logit rescales (sc = 1 else)
          const float mn = fmaxf(m, l);
          const float sc = __expf(m - mn);
          const float e = ok ? __expf(l - mn) : 0.f;
          den = fmaf(den, sc, e);
#pragma unroll
          for (int q = 0; q < CG; ++q) {
            acc[q].x = fmaf(e, gn[q].x, acc[q].x * sc);
            acc[q].y = fmaf(e, gn[q].y, acc[q].y * sc);
            acc[q].z = fmaf(e, gn[q].z, acc[q].z * sc);
            acc[q].w = fmaf(e, gn[q].w, acc[q].w * sc);
          }
          m = mn;
        }
      };
      if (th.active) {
        if (inner)
          edges(sg::Checked<false>());
        else
          edges(sg::Checked<true>());
      }
      if (p.reload) ring.done_step(lane);
    }
    if (th.active)
      sg::store_g<L, CG>(out + v * G, nqg, pg, th.sub, acc,
                         1.f / fmaxf(den, 1e-12f));
  }
}

// out (B, D, H, W, G) from theta, phi (B, D, H, W, F) and g (B, D, H, W,
// G), F and G multiples of 4; offs: K (dz, dy, dx) int32 triples in host
// memory; args: the plan (kernels/window_attention.py:generic_fwd_plan)
extern "C" int stencil_attention_generic_f32(
    const void* theta, const void* phi, const void* g, void* out, int64_t B,
    int64_t D, int64_t H, int64_t W, int64_t F, int64_t G,
    const int32_t* offs, int64_t K, const int64_t* args, void* stream) {
  sg::Stencil st;
  if (!sg::stencil_of(offs, K, F, G, &st)) return -1;
  if (B * D * H * W == 0) return 0;
  const sg::Plan p = sg::plan_of(args);
  const int cls = sg::class_of(F, G);
  const int vox = (int)(F + G);
  if (!sg::plan_ok(p, B, D, H, W, st.h, sg::lanes_of(cls), vox)) return -1;
  auto kernel = SG_BY_CLASS(stencil_attention_generic_kernel, cls);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       p.smem);
  const int64_t blocks = B * p.tiles_x * p.tiles_y * p.tiles_z;
  kernel<<<(unsigned)blocks, p.threads, p.smem, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)phi, (const float*)g, (float*)out,
      (int)D, (int)H, (int)W, (int)F, (int)G, p, st);
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


// blocks of the forward of width class `cls` (sg::class_of) an SM holds
// at `threads` threads and `smem` bytes of dynamic shared memory
extern "C" int stencil_attention_generic_occupancy(int cls, int threads,
                                                   int smem) {
  return sg::occupancy(SG_BY_CLASS(stencil_attention_generic_kernel, cls),
                       threads, smem);
}
