// The gradient pass of the stencil attention (merge type
// 'scaled_dot_product_relu') on any stencil and any widths: dtheta, dphi
// and dg from the operands, the output cotangent ybar and the statistics
// scal = (r, m, denom, c) of csrc/stencil_attention_generic.cu's
// statistics pass.
//
// Replaces: dram_tpu/core/pallas/window_attention.py:_vjp_bwd :317 ->
// pallas_call :366 (_bwd_kernel :157-237) where the PCM's stencil or
// widths are not the shipped 18-offset, F = G = 8 ones, which
// csrc/stencil_attention.cu's plane-ring gradient pass keeps. With
// ds_o(i) = a_io (u_io - c_i) r_i [theta_i . phi_{i+o} > 0], a_io the
// softmax weight exp(relu(theta_i . phi_{i+o}) r_i - m_i) / denom_i and
// u_io = ybar_i . g_{i+o}:
//   dtheta_j = sum_o ds_o(j) phi_{j+o}          (+o side, at j)
//   dphi_j   = sum_o ds_o(j-o) theta_{j-o}      (-o side, i = j - o)
//   dg_j     = sum_o a_o(j-o) ybar_{j-o}
// The -o side gathers over i = j - o for the o of the stencil, as the TPU
// kernel's rolls by -o do: a stencil need not hold -o with o (k = 5 at
// connectivity 1 and 2 does not, scipy's order-0 zoom rounding half-way
// coordinates up), so gathering over +o would sum other edges. Gathers,
// no atomics: two launches give equal bits.
//
// Design: two plane rings (csrc/stencil_generic_ring.cuh), launched one
// after the other by the same launcher, one a side, each staging only
// what its side gathers: the +o side (stencil_attention_bwd_plus_kernel)
// stages phi and g and keeps theta_j, ybar_j and the statistics of j in
// registers; the -o side (stencil_attention_bwd_minus_kernel) stages
// theta, ybar and the statistics and keeps phi_j and g_j. A staged voxel
// of both sides together is 4 (2F + 2G + 4) bytes (176 at F = 16, G = 4;
// 1,040 at F = G = 64): split, each side's ring fits twice or more in an
// SM's shared memory where one ring of both would fit once. A thread
// keeps its F- and G-wide accumulators in registers, so each edge's dots
// are computed once on each side. The edge loops have no branch (an edge
// outside the volume, or whose logit's dot is not positive, adds zero),
// so that the compiler can overlap successive edges. Bound on the H100:
// operations, the edges' 6F + 4G flops of dots and sums
// (chip_smoke.py:generic_pass_work) against each row read once; this
// design computes the logit's F-wide dot and u's G-wide dot on both
// sides (4F + 3G multiply-adds an edge, where the bound counts 3F + 2G).

#include "stencil_generic_ring.cuh"

// The +o side: dtheta. The buffer of a plane holds phi, then g.
template <int L, int CF, int CG>
__global__ void __launch_bounds__(sg::MAX_THREADS, sg::MIN_BLOCKS)
    stencil_attention_bwd_plus_kernel(const float* __restrict__ theta,
                                      const float* __restrict__ phi,
                                      const float* __restrict__ gv,
                                      const float* __restrict__ ybar,
                                      const float* __restrict__ scal,
                                      float* __restrict__ dtheta, int D,
                                      int H, int W, int F, int G,
                                      const sg::Plan p,
                                      const __grid_constant__ sg::Stencil st) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + sg::MAX_NBUF;
  float* bufs = reinterpret_cast<float*>(smem + sg::BAR_BYTES);
  const int nqf = F / 4, nqg = G / 4;
  const int seg = p.rows * p.cols;
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
    float4 tc[CF], yc[CG], acc[CF];
    float4 sv = make_float4(0.f, 0.f, 1.f, 0.f);
    if (th.active) {
      sg::load_g<L, CF>(theta + v * F, nqf, pf, th.sub, tc);
      sg::load_g<L, CG>(ybar + v * G, nqg, pg, th.sub, yc);
      sv = __ldg(reinterpret_cast<const float4*>(scal) + v);
    }
    const float rv = sv.x, mv = sv.y, cv = sv.w;
    const float inv = 1.f / fmaxf(sv.z, 1e-12f);
    sg::zero(acc);
    for (int d = -h; d <= h; ++d) {
      if (!sg::step_reads(st, z, d, 1, D)) continue;
      const float* buf = p.reload ? ring.next() : ring.plane(z + d);
      // the offsets with dz = d, edge by edge
      auto edges = [&](auto checked) {
        const float* pb = buf;
        const float* gb = buf + seg * F;
#pragma unroll sg::BWD_UNROLL
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
          const float s = sg::dot<L, CF>(tc, pn, lane);
          const float u = sg::dot<L, CG>(yc, gn, lane);
          const float ds =
              ok && s > 0.f ? __expf(s * rv - mv) * inv * (u - cv) * rv
                            : 0.f;
          sg::axpy(acc, ds, pn);
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
      sg::store_g<L, CF>(dtheta + v * F, nqf, pf, th.sub, acc, 1.f);
  }
}

// The -o side: dphi and dg at j over the i = j - o whose edge o ends at
// j, with i's statistics. The buffer of a plane holds theta, ybar, then
// the statistics.
template <int L, int CF, int CG>
__global__ void __launch_bounds__(sg::MAX_THREADS, sg::MIN_BLOCKS)
    stencil_attention_bwd_minus_kernel(const float* __restrict__ theta,
                                       const float* __restrict__ phi,
                                       const float* __restrict__ gv,
                                       const float* __restrict__ ybar,
                                       const float* __restrict__ scal,
                                       float* __restrict__ dphi,
                                       float* __restrict__ dg, int D, int H,
                                       int W, int F, int G, const sg::Plan p,
                                       const __grid_constant__ sg::Stencil st) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + sg::MAX_NBUF;
  float* bufs = reinterpret_cast<float*>(smem + sg::BAR_BYTES);
  const int nqf = F / 4, nqg = G / 4;
  const int seg = p.rows * p.cols;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cwarps = p.sets * sg::voxel_warps(p);
  const sg::Tile t = sg::tile_of(p, blockIdx.x, D, H, W);
  const int ncols = t.cx1 - t.cx0 + 1, h = p.h;
  if (t.ry1 - t.ry0 + 1 > p.rows || ncols > p.cols) __trap();
  sg::ring_init(full, empty, p.nbuf, cwarps);
  // the neighbour of this side: i = j + sgn * o
  const int sgn = -1;

  if (warp == cwarps) {
    sg::Ops<3> ops{{theta, ybar, scal}, {F, G, 4}};
    sg::produce(p, t, st, sgn, D, empty, [&](int s, int pl) {
      sg::stage_plane(bufs + (size_t)s * seg * (F + G + 4), ops, p, t,
                      ncols, D, H, W, pl, &full[s], lane);
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
  sg::Ring ring{full, empty, bufs, seg * (F + G + 4), p.nbuf, t.pz0,
                t.pz1, p.reload, 0, t.pz0};
  for (int z = t.za + th.set; z < t.zb; z += p.sets) {
    if (!p.reload) ring.enter(z, h, lane);
    const int64_t v = (((int64_t)t.b * D + z) * H + th.y) * W + th.x;
    float4 pc[CF], gc[CG], aph[CF], ag[CG];
    if (th.active) {
      sg::load_g<L, CF>(phi + v * F, nqf, pf, th.sub, pc);
      sg::load_g<L, CG>(gv + v * G, nqg, pg, th.sub, gc);
    }
    sg::zero(aph);
    sg::zero(ag);
    for (int d = -h; d <= h; ++d) {
      if (!sg::step_reads(st, z, d, sgn, D)) continue;
      const float* buf = p.reload ? ring.next() : ring.plane(z + sgn * d);
      // the offsets with dz = d, edge by edge
      auto edges = [&](auto checked) {
        const float* tb = buf;
        const float* yb = buf + seg * F;
        const float* sb = buf + seg * (F + G);
#pragma unroll sg::BWD_UNROLL
        for (int k = st.start[d + sg::MAX_HALO];
             k < st.start[d + sg::MAX_HALO + 1]; ++k) {
          const char4 o = st.o[k];
          const int dy = sgn * o.y, dx = sgn * o.z;
          const bool ok = !decltype(checked)::value ||
                          (th.y + dy >= 0 && th.y + dy < H &&
                           th.x + dx >= 0 && th.x + dx < W);
          const int idx = ok ? at + dy * ncols + dx : at;
          float4 ti[CF], yi[CG];
          sg::load_s<L, CF>(tb + idx * F, nqf, pf, th.sub, ti);
          sg::load_s<L, CG>(yb + idx * G, nqg, pg, th.sub, yi);
          const float4 si = *reinterpret_cast<const float4*>(sb + idx * 4);
          const float s2 = sg::dot<L, CF>(ti, pc, lane);
          const float a2 =
              ok ? __fdividef(__expf(fmaxf(s2, 0.f) * si.x - si.y),
                              fmaxf(si.z, 1e-12f))
                 : 0.f;
          const float ds2 =
              s2 > 0.f ? a2 * (sg::dot<L, CG>(yi, gc, lane) - si.w) * si.x
                       : 0.f;
          sg::axpy(ag, a2, yi);
          sg::axpy(aph, ds2, ti);
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
    if (th.active) {
      sg::store_g<L, CF>(dphi + v * F, nqf, pf, th.sub, aph, 1.f);
      sg::store_g<L, CG>(dg + v * G, nqg, pg, th.sub, ag, 1.f);
    }
  }
}

// dtheta, dphi (B, D, H, W, F) and dg (B, D, H, W, G) from the operands,
// ybar and the statistics scal (B, D, H, W, 4), F and G multiples of 4;
// offs: K (dz, dy, dx) int32 triples in host memory; args: the +o side's
// plan, then the -o side's (kernels/window_attention.py:generic_bwd_plan)
extern "C" int stencil_attention_bwd_generic_f32(
    const void* theta, const void* phi, const void* g, const void* ybar,
    const void* scal, void* dtheta, void* dphi, void* dg, int64_t B,
    int64_t D, int64_t H, int64_t W, int64_t F, int64_t G,
    const int32_t* offs, int64_t K, const int64_t* args, void* stream) {
  sg::Stencil st;
  if (!sg::stencil_of(offs, K, F, G, &st)) return -1;
  if (B * D * H * W == 0) return 0;
  const sg::Plan pp = sg::plan_of(args), pm = sg::plan_of(args + sg::PLAN_INTS);
  const int cls = sg::class_of(F, G), lanes = sg::lanes_of(cls);
  const int vox = (int)(F + G);
  if (!sg::plan_ok(pp, B, D, H, W, st.h, lanes, vox) ||
      !sg::plan_ok(pm, B, D, H, W, st.h, lanes, vox + 4))
    return -1;
  const cudaStream_t s = (cudaStream_t)stream;
  auto plus = SG_BY_CLASS(stencil_attention_bwd_plus_kernel, cls);
  cudaFuncSetAttribute(plus, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       pp.smem);
  plus<<<(unsigned)(B * pp.tiles_x * pp.tiles_y * pp.tiles_z), pp.threads,
         pp.smem, s>>>((const float*)theta, (const float*)phi,
                       (const float*)g, (const float*)ybar,
                       (const float*)scal, (float*)dtheta, (int)D, (int)H,
                       (int)W, (int)F, (int)G, pp, st);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  auto minus = SG_BY_CLASS(stencil_attention_bwd_minus_kernel, cls);
  cudaFuncSetAttribute(minus, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       pm.smem);
  minus<<<(unsigned)(B * pm.tiles_x * pm.tiles_y * pm.tiles_z), pm.threads,
          pm.smem, s>>>((const float*)theta, (const float*)phi,
                        (const float*)g, (const float*)ybar,
                        (const float*)scal, (float*)dphi, (float*)dg, (int)D,
                        (int)H, (int)W, (int)F, (int)G, pm, st);
  return (int)cudaGetLastError();
}

// blocks of the gradient pass's +o side (minus = 0) or -o side (minus =
// 1) of width class `cls` an SM holds at `threads` threads and `smem`
// bytes of dynamic shared memory
extern "C" int stencil_attention_bwd_generic_occupancy(int minus, int cls,
                                                       int threads,
                                                       int smem) {
  return minus ? sg::occupancy(
                     SG_BY_CLASS(stencil_attention_bwd_minus_kernel, cls),
                     threads, smem)
               : sg::occupancy(
                     SG_BY_CLASS(stencil_attention_bwd_plus_kernel, cls),
                     threads, smem);
}
