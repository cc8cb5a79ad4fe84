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
// Both kernels are plane rings (csrc/stencil_generic_ring.cuh) that
// stage the same operands. A block stages phi and g of its tile with a
// +-h halo plane by plane; a thread keeps its voxel's centre rows in
// registers and streams the offsets of its plane in their order, dz group
// by dz group from the staged planes, with one online softmax: a running
// maximum from 0 (the relu allows it) that rescales the running sums when
// it grows, so each edge's logit is computed once. The edge loops have no
// branch (an edge outside the volume reads the voxel's own slot and adds
// nothing), so that the compiler can overlap an edge's shared-memory
// reads and dots with the previous edge's exponentials. The degree comes
// from coordinates (K where the voxel is h or more from every face).
//
// The forward (stencil_attention_generic_kernel) keeps theta_i and a
// G-wide accumulator of e g_j, rescaled with the denominator. The
// statistics pass (stencil_attention_scal_generic_kernel) keeps theta_i
// and ybar_i and, in place of the accumulator, the running numerator
// sum_o e_io u_io: one G-wide dot an edge and two scalars, rescaled
// together with the denominator; it writes (r, m, denom, num / denom),
// the record csrc/stencil_attention_generic_bwd.cu reads. m is the exact
// maximum (the online maximum does not depend on the order); denom and c
// change from a two-pass softmax only in rounding.
//
// Bound on the H100: operations, the edges' 2F + 2G flops of dots and
// sums against each row read once (chip_smoke.py:generic_pass_work). The
// offsets run in a fixed order, so two launches give equal bits. All
// arithmetic is f32 on the CUDA cores, exponentials by __expf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stencil_generic_ring.cuh"

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
      rs = sg::rsqrt_degree(st, z, th.y, th.x, D, H, W, h);
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

// The statistics pass on the plane ring: the forward's staging (phi,
// then g of the staged box a plane), theta_i and ybar_i of the voxel in
// registers; scal[i] = (r, m, denom, c).
template <int L, int CF, int CG>
__global__ void __launch_bounds__(sg::MAX_THREADS, sg::MIN_BLOCKS)
    stencil_attention_scal_generic_kernel(
        const float* __restrict__ theta, const float* __restrict__ phi,
        const float* __restrict__ gv, const float* __restrict__ ybar,
        float* __restrict__ scal, int D, int H, int W, int F, int G,
        const sg::Plan p, const __grid_constant__ sg::Stencil st) {
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
    float4 tc[CF], yc[CG];
    float r = 0.f;
    if (th.active) {
      sg::load_g<L, CF>(theta + v * F, nqf, pf, th.sub, tc);
      sg::load_g<L, CG>(ybar + v * G, nqg, pg, th.sub, yc);
      r = sg::rsqrt_degree(st, z, th.y, th.x, D, H, W, h);
    }
    float m = 0.f, den = 0.f, num = 0.f;
    for (int d = -h; d <= h; ++d) {
      if (!sg::step_reads(st, z, d, 1, D)) continue;
      const float* buf = p.reload ? ring.next() : ring.plane(z + d);
      // the offsets with dz = d, edge by edge
      auto edges = [&](auto checked) {
        const float* pb = buf;
        const float* gb = buf + seg * F;
#pragma unroll sg::SCAL_UNROLL
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
              ok ? fmaxf(sg::dot<L, CF>(tc, pn, lane), 0.f) * r : 0.f;
          const float u = sg::dot<L, CG>(yc, gn, lane);
          // the online softmax: a larger logit rescales the denominator
          // and the numerator alike (sc = 1 else)
          const float mn = fmaxf(m, l);
          const float sc = __expf(m - mn);
          const float e = ok ? __expf(l - mn) : 0.f;
          den = fmaf(den, sc, e);
          num = fmaf(e, u, num * sc);
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
    // the voxel's lanes hold the same sums: its first lane writes
    if (th.active && th.sub == 0)
      __stcs(reinterpret_cast<float4*>(scal) + v,
             make_float4(r, m, den, num / fmaxf(den, 1e-12f)));
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
// H, W, G), F and G multiples of 4; offs and args as the forward's (args:
// kernels/window_attention.py:generic_scal_plan)
extern "C" int stencil_attention_scal_generic_f32(
    const void* theta, const void* phi, const void* g, const void* ybar,
    void* scal, int64_t B, int64_t D, int64_t H, int64_t W, int64_t F,
    int64_t G, const int32_t* offs, int64_t K, const int64_t* args,
    void* stream) {
  sg::Stencil st;
  if (!sg::stencil_of(offs, K, F, G, &st)) return -1;
  if (B * D * H * W == 0) return 0;
  const sg::Plan p = sg::plan_of(args);
  const int cls = sg::class_of(F, G);
  const int vox = (int)(F + G);
  if (!sg::plan_ok(p, B, D, H, W, st.h, sg::lanes_of(cls), vox)) return -1;
  auto kernel = SG_BY_CLASS(stencil_attention_scal_generic_kernel, cls);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       p.smem);
  const int64_t blocks = B * p.tiles_x * p.tiles_y * p.tiles_z;
  kernel<<<(unsigned)blocks, p.threads, p.smem, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)phi, (const float*)g,
      (const float*)ybar, (float*)scal, (int)D, (int)H, (int)W, (int)F,
      (int)G, p, st);
  return (int)cudaGetLastError();
}

// blocks of the forward of width class `cls` (sg::class_of) an SM holds
// at `threads` threads and `smem` bytes of dynamic shared memory
extern "C" int stencil_attention_generic_occupancy(int cls, int threads,
                                                   int smem) {
  return sg::occupancy(SG_BY_CLASS(stencil_attention_generic_kernel, cls),
                       threads, smem);
}

// blocks of the statistics pass of width class `cls` an SM holds at
// `threads` threads and `smem` bytes of dynamic shared memory
extern "C" int stencil_attention_scal_generic_occupancy(int cls, int threads,
                                                        int smem) {
  return sg::occupancy(
      SG_BY_CLASS(stencil_attention_scal_generic_kernel, cls), threads, smem);
}
