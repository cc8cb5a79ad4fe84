// The plane ring of the generic stencil-attention forward, statistics
// pass and gradient pass (csrc/stencil_attention_generic.cu,
// csrc/stencil_attention_generic_bwd.cu):
// the stencil and the launch plan as the kernels take them, a block's
// tile, the producer warp's staging and the compute warps' view of the
// ring, and the width-class vector helpers.
//
// A block owns a tile (batch element, run of z-planes, run of rows, run of
// columns; kernels/window_attention.py:generic_fwd_plan /
// generic_scal_plan / generic_bwd_plan decide the geometry and the launchers refuse a plan whose buffers or
// coverage differ from this build's). It streams the tile along z through
// a ring of shared-memory plane buffers, each holding the operands its
// neighbours are gathered from over the tile's rows and columns with a
// +-h halo clipped to the volume (h: the stencil's largest offset
// component, <= 3). The offsets of the stencil are grouped by their dz
// (Stencil::start), so a voxel of plane z reads the offsets with dz = d
// from one staged plane, z + d (the +o side) or z - d (the -o side).
//
// Two ways to feed the ring, by the plan:
// - whole ring (reload = 0): every staged plane of the tile is copied
//   once, in order, into buffer (plane - pz0) % nbuf; the compute warps
//   form `sets` groups that take the tile's planes in turn (set s the
//   planes za + s, za + s + sets, ...), each warp waits for planes z - h
//   .. z + h, then releases the planes no plane it has left to compute
//   reads. nbuf >= 2h + sets + 1 keeps every release in its buffer's
//   phase and the ring free of deadlock
//   (tests/test_torch_port_generic_plan.py runs the protocol);
// - reload (reload = 1, where no whole ring fits in shared memory): one
//   set; for each plane z and each d with offsets, the plane that d reads
//   is copied again into the next buffer and released after that step.
// Both give the same sums in the same order.
//
// A producer warp fills a buffer with one cp.async.bulk per staged row
// and operand (one per operand when a row spans the volume), completing
// on the buffer's full mbarrier. Every width is a multiple of 4 (the
// wrappers zero-pad the channels of other widths), so a voxel's row is
// 16-byte aligned in device and shared memory. The full mbarriers count
// the producer's 32 lanes (lane 0 also announces the copies' bytes), the
// empty ones the compute warps.
// A staged slot outside the volume is never copied and never read:
// validity comes from coordinates.
//
// Width classes (template <L, CF, CG>): L lanes take a voxel, each
// holding CF float4 chunks of every F-wide row and CG of every G-wide
// one: <1, 4, 1> (F <= 16, G <= 4), <1, 4, 4> (F, G <= 16), <4, 4, 4>
// (F, G <= 64; lane l holds chunks l, l + 4, ..., and the dots add the
// four lanes' partial sums by shuffles). With L = 1 a lane reads its
// rows' chunks rotated by a lane-dependent amount (rot_of), so that the
// eight lanes of a shared-memory phase hit eight distinct 16-byte bank
// groups; every row of the thread uses the same rotation, so register
// slots stay static and the dots pair the same chunks.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv_wgmma.cuh"

namespace sg {

constexpr int MAX_K = 343;
constexpr int MAX_HALO = 3;
constexpr int MAX_WIDTH = 64;
constexpr int MAX_NBUF = 16;
// the full, then the empty mbarriers, at the start of dynamic shared memory
constexpr int BAR_BYTES = 2 * MAX_NBUF * 8;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int MAX_THREADS = 512;
// blocks of MAX_THREADS threads an SM must hold: caps a thread's registers
constexpr int MIN_BLOCKS = 1;
// offsets of an edge loop unrolled together: the forward's, the gradient
// pass's, the statistics pass's (tools/generic_attention_variants.py: 2
// cost the forward ~5% and the statistics pass ~30% and gained the
// gradient pass ~6% at variant A's step shape)
constexpr int FWD_UNROLL = 1, BWD_UNROLL = 2, SCAL_UNROLL = 1;

// the offsets as (dz, dy, dx, 0), grouped by dz in their given order
// within a group; the offsets with dz = d are o[start[d + MAX_HALO]] ..
// o[start[d + MAX_HALO + 1] - 1]; h = the largest |component|
struct Stencil {
  int k, h;
  int start[2 * MAX_HALO + 2];
  char4 o[MAX_K];
};

// one launch's plan (kernels/window_attention.py: the plan's `args`)
struct Plan {
  int zr, yr, xr, tiles_x, tiles_y, tiles_z, rows, cols, nbuf, sets, reload,
      threads, smem, h, lanes;
};
constexpr int PLAN_INTS = 15;

// the width class of (F, G), multiples of 4: 0 = <1, 4, 1>, 1 = <1, 4, 4>,
// 2 = <4, 4, 4>
inline int class_of(int64_t F, int64_t G) {
  const int64_t qf = F / 4, qg = G / 4;
  if (qf <= 4 && qg <= 1) return 0;
  if (qf <= 4 && qg <= 4) return 1;
  return 2;
}
inline int lanes_of(int cls) { return cls == 2 ? 4 : 1; }

// the stencil of `offs` (K triples dz, dy, dx) for widths F and G
// (multiples of 4), or false when these kernels do not take them
inline bool stencil_of(const int32_t* offs, int64_t K, int64_t F, int64_t G,
                       Stencil* st) {
  if (K < 1 || K > MAX_K || F < 4 || F > MAX_WIDTH || F % 4 || G < 4 ||
      G > MAX_WIDTH || G % 4)
    return false;
  st->k = (int)K;
  st->h = 0;
  int n = 0;
  for (int d = -MAX_HALO; d <= MAX_HALO; ++d) {
    st->start[d + MAX_HALO] = n;
    for (int64_t k = 0; k < K; ++k) {
      if (offs[3 * k] != d) continue;
      for (int a = 0; a < 3; ++a) {
        const int v = offs[3 * k + a];
        if (v < -MAX_HALO || v > MAX_HALO) return false;
        st->h = v > st->h ? v : -v > st->h ? -v : st->h;
      }
      st->o[n++] = make_char4((signed char)offs[3 * k],
                              (signed char)offs[3 * k + 1],
                              (signed char)offs[3 * k + 2], 0);
    }
  }
  st->start[2 * MAX_HALO + 1] = n;
  return n == K;  // a dz outside [-3, 3] is in no group
}

inline Plan plan_of(const int64_t* a) {
  return Plan{(int)a[0],  (int)a[1],  (int)a[2],  (int)a[3],  (int)a[4],
              (int)a[5],  (int)a[6],  (int)a[7],  (int)a[8],  (int)a[9],
              (int)a[10], (int)a[11], (int)a[12], (int)a[13], (int)a[14]};
}

inline int min_i(int64_t a, int64_t b) { return (int)(a < b ? a : b); }

// compute warps of a plan: `sets` groups of the warps that hold the
// tile's plane (32 / lanes voxels a warp)
__host__ __device__ inline int voxel_warps(const Plan& p) {
  return (p.yr * p.xr * p.lanes + 31) / 32;
}

// the plan covers the grid once, its buffers hold the tile's rows and
// columns with their halo (`vox` floats a staged voxel), its ring is one
// of the two kinds above and its threads are the compute warps and the
// producer warp
inline bool plan_ok(const Plan& p, int64_t B, int64_t D, int64_t H,
                    int64_t W, int h, int lanes, int vox) {
  if (p.zr < 1 || p.yr < 1 || p.xr < 1 || p.h != h || p.lanes != lanes)
    return false;
  if ((int64_t)p.tiles_x * p.xr < W || (int64_t)p.tiles_y * p.yr < H ||
      (int64_t)p.tiles_z * p.zr < D || (int64_t)(p.tiles_x - 1) * p.xr >= W ||
      (int64_t)(p.tiles_y - 1) * p.yr >= H ||
      (int64_t)(p.tiles_z - 1) * p.zr >= D ||
      B * p.tiles_x * p.tiles_y * p.tiles_z >= (int64_t)1 << 31)
    return false;
  if (p.rows != min_i(p.yr + 2 * h, H) || p.cols != min_i(p.xr + 2 * h, W))
    return false;
  if (p.reload == 1) {
    if (p.sets != 1 || p.nbuf < 2 || p.nbuf > MAX_NBUF) return false;
  } else if (p.reload != 0 || p.sets < 1 || p.nbuf < 2 * h + p.sets + 1 ||
             p.nbuf > MAX_NBUF) {
    return false;
  }
  const int64_t smem =
      BAR_BYTES + (int64_t)p.nbuf * p.rows * p.cols * vox * 4;
  return p.threads == 32 * (p.sets * voxel_warps(p) + 1) &&
         p.threads <= MAX_THREADS && p.smem == smem && smem <= SMEM_MAX;
}

// blocks of `kernel` an SM holds at `threads` threads and `smem` bytes of
// dynamic shared memory
template <typename K>
inline int occupancy(K kernel, int threads, int smem) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return n;
}

// The tile of block `blk` and the spans it stages: planes [za, zb), rows
// [ya, yb), columns [xa, xb) of batch element b; staged planes pz0 .. pz1,
// rows ry0 .. ry1 and columns cx0 .. cx1 (the +-h halo, clipped).
struct Tile {
  int b, za, zb, ya, yb, xa, xb, pz0, pz1, ry0, ry1, cx0, cx1;
};

__device__ __forceinline__ Tile tile_of(const Plan& p, int blk, int D, int H,
                                        int W) {
  Tile t;
  const int h = p.h;
  const int tx = blk % p.tiles_x;
  blk /= p.tiles_x;
  const int ty = blk % p.tiles_y;
  blk /= p.tiles_y;
  const int tz = blk % p.tiles_z;
  t.b = blk / p.tiles_z;
  t.za = tz * p.zr;
  t.zb = min(t.za + p.zr, D);
  t.ya = ty * p.yr;
  t.yb = min(t.ya + p.yr, H);
  t.xa = tx * p.xr;
  t.xb = min(t.xa + p.xr, W);
  t.pz0 = max(t.za - h, 0);
  t.pz1 = min(t.zb - 1 + h, D - 1);
  t.ry0 = max(t.ya - h, 0);
  t.ry1 = min(t.yb - 1 + h, H - 1);
  t.cx0 = max(t.xa - h, 0);
  t.cx1 = min(t.xb - 1 + h, W - 1);
  return t;
}

// 1-D bulk copy global -> shared (size and both addresses 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(wg::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(wg::smem_u32(bar))
      : "memory");
}

// the operands a role stages: N volumes of vw[o] floats a voxel
template <int N>
struct Ops {
  const float* vol[N];
  int vw[N];
};

// The producer warp's copies of plane `plane` (of batch element t.b) into
// buffer `buf`: each operand's rows ry0 .. ry1, columns cx0 .. cx1, at
// operand o's part of the buffer (rows x cols voxels of vw[o] floats,
// rows of ncols voxels).
template <int N>
__device__ __forceinline__ void stage_plane(float* buf, const Ops<N>& ops,
                                            const Plan& p, const Tile& t,
                                            int ncols, int D, int H, int W,
                                            int plane, uint64_t* full,
                                            int lane) {
  const int nrows = t.ry1 - t.ry0 + 1;
  const int64_t pl = (int64_t)t.b * D + plane;
  uint32_t bytes = 0;
#pragma unroll
  for (int o = 0; o < N; ++o) bytes += nrows * ncols * ops.vw[o] * 4;
  if (lane == 0) wg::mbar_expect_tx(full, bytes);
  __syncwarp();
  const bool whole = ncols == W;
  const int ncopy = whole ? 1 : nrows;
  int off = 0;
#pragma unroll
  for (int o = 0; o < N; ++o) {
    const int v = ops.vw[o];
    for (int j = lane; j < ncopy; j += 32) {
      const int r = t.ry0 + j;
      const int nr = whole ? nrows : 1;
      bulk_load(buf + off + (size_t)j * ncols * v,
                ops.vol[o] + ((pl * H + r) * W + t.cx0) * v,
                (uint32_t)(nr * ncols * v * 4), full);
    }
    off += p.rows * p.cols * v;
  }
  if (lane != 0) wg::mbar_arrive(full);
}

// the offsets with dz = d exist and plane z + sgn * d lies in the volume:
// step (z, d) reads a staged plane
__device__ __forceinline__ bool step_reads(const Stencil& st, int z, int d,
                                           int sgn, int D) {
  const int pl = z + sgn * d;
  return st.start[d + MAX_HALO + 1] > st.start[d + MAX_HALO] && pl >= 0 &&
         pl < D;
}

// The full and empty mbarriers of a ring, set up by thread 0: the
// producer's 32 lanes fill a buffer, `warps` compute warps release it.
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty,
                                          int nbuf, int warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < nbuf; ++s) {
      wg::mbar_init(&full[s], 32);
      wg::mbar_init(&empty[s], warps);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
}

// The producer warp: the tile's staged planes in order (whole ring), or
// for each plane z of the tile the plane of each step (z, d) (reload),
// each into its buffer once the buffer's previous plane is released.
// stage(buffer, plane) copies one plane.
template <typename Stage>
__device__ __forceinline__ void produce(const Plan& p, const Tile& t,
                                        const Stencil& st, int sgn, int D,
                                        uint64_t* empty, Stage stage) {
  int k = 0;
  auto next = [&](int plane) {
    const int s = k % p.nbuf;
    if (k >= p.nbuf) wg::mbar_wait(&empty[s], (k / p.nbuf - 1) & 1);
    stage(s, plane);
    ++k;
  };
  if (!p.reload) {
    for (int pl = t.pz0; pl <= t.pz1; ++pl) next(pl);
    return;
  }
  for (int z = t.za; z < t.zb; ++z)
    for (int d = -p.h; d <= p.h; ++d)
      if (step_reads(st, z, d, sgn, D)) next(z + sgn * d);
}

// A compute warp's view of the ring.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  float* bufs;
  int buf_floats, nbuf, pz0, pz1;
  int reload, step, rel;

  // whole ring: plane pl, after waiting for it (every lane waits)
  __device__ __forceinline__ const float* plane(int pl) const {
    const int k = pl - pz0, s = k % nbuf;
    wg::mbar_wait(&full[s], (k / nbuf) & 1);
    return bufs + (size_t)s * buf_floats;
  }
  // reload: the buffer of the next step, after waiting for it
  __device__ __forceinline__ const float* next() const {
    const int s = step % nbuf;
    wg::mbar_wait(&full[s], (step / nbuf) & 1);
    return bufs + (size_t)s * buf_floats;
  }
  // reload: this warp is done with the step's buffer
  __device__ __forceinline__ void done_step(int lane) {
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[step % nbuf]);
    ++step;
  }
  // whole ring, before computing plane z: wait for z - h .. z + h, then
  // release the planes below z - h (no plane left to this warp reads
  // them). Waiting first keeps a release in its buffer's phase for any
  // number of sets: the plane it releases is at most z + h.
  __device__ __forceinline__ void enter(int z, int h, int lane) {
    for (int pl = max(z - h, pz0); pl <= min(z + h, pz1); ++pl) plane(pl);
    __syncwarp();
    const int upto = min(z - h, pz1 + 1);
    if (lane == 0)
      for (int pl = rel; pl < upto; ++pl)
        wg::mbar_arrive(&empty[(pl - pz0) % nbuf]);
    rel = max(rel, upto);
  }
};

// --- width-class vectors ------------------------------------------------------

// the rotation of a lane (L = 1) for rows of nq chunks: lanes l and l' of
// one 8-lane phase read consecutive staged voxels, so their chunks land
// in distinct 16-byte bank groups when the rotation takes gcd(nq, 8)
// values over the phase
__device__ __forceinline__ int rot_of(int lane, int nq) {
  int g = 1;
  while (g < 8 && nq % (2 * g) == 0) g *= 2;  // gcd(nq, 8)
  const int shift = g == 8 ? 0 : g == 4 ? 1 : g == 2 ? 2 : 3;
  return ((lane & 7) >> shift) % nq;
}

// the chunk held in slot k by lane `sub` (L = 4) or with rotation p (L =
// 1), or -1 when slot k holds none (nq chunks in the row)
template <int L>
__device__ __forceinline__ int chunk_of(int k, int nq, int p, int sub) {
  if (L == 1) {
    if (k >= nq) return -1;
    const int c = k + p;
    return c >= nq ? c - nq : c;
  }
  const int c = sub + L * k;
  return c < nq ? c : -1;
}

// a staged row (16-byte aligned, nq chunks) into the slots
template <int L, int C>
__device__ __forceinline__ void load_s(const float* row, int nq, int p,
                                       int sub, float4 (&v)[C]) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = chunk_of<L>(k, nq, p, sub);
    v[k] = c >= 0 ? *reinterpret_cast<const float4*>(row + 4 * c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// a row of device memory (16-byte aligned, nq chunks) into the slots
template <int L, int C>
__device__ __forceinline__ void load_g(const float* row, int nq, int p,
                                       int sub, float4 (&v)[C]) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = chunk_of<L>(k, nq, p, sub);
    v[k] = c >= 0 ? __ldg(reinterpret_cast<const float4*>(row) + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// the slots times `s` to a row of device memory (16-byte aligned, nq
// chunks)
template <int L, int C>
__device__ __forceinline__ void store_g(float* row, int nq, int p, int sub,
                                        const float4 (&v)[C], float s) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = chunk_of<L>(k, nq, p, sub);
    if (c >= 0)
      __stcs(reinterpret_cast<float4*>(row) + c,
             make_float4(v[k].x * s, v[k].y * s, v[k].z * s, v[k].w * s));
  }
}

// a . b over the slots, the four components in four sums, added (x + y) +
// (z + w); with L = 4 the partial sums of the voxel's four lanes added by
// shuffles within the lane group (every lane gets the same bits)
template <int L, int C>
__device__ __forceinline__ float dot(const float4 (&a)[C],
                                     const float4 (&b)[C], int lane) {
  float sx = 0.f, sy = 0.f, sz = 0.f, sw = 0.f;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    sx = fmaf(a[k].x, b[k].x, sx);
    sy = fmaf(a[k].y, b[k].y, sy);
    sz = fmaf(a[k].z, b[k].z, sz);
    sw = fmaf(a[k].w, b[k].w, sw);
  }
  float s = (sx + sy) + (sz + sw);
  if (L == 4) {
    const unsigned grp = 0xFu << (lane & ~3);
    s += __shfl_xor_sync(grp, s, 1);
    s += __shfl_xor_sync(grp, s, 2);
  }
  return s;
}

// acc += s * v over the slots
template <int C>
__device__ __forceinline__ void axpy(float4 (&acc)[C], float s,
                                     const float4 (&v)[C]) {
#pragma unroll
  for (int k = 0; k < C; ++k) {
    acc[k].x = fmaf(s, v[k].x, acc[k].x);
    acc[k].y = fmaf(s, v[k].y, acc[k].y);
    acc[k].z = fmaf(s, v[k].z, acc[k].z);
    acc[k].w = fmaf(s, v[k].w, acc[k].w);
  }
}

template <int C>
__device__ __forceinline__ void zero(float4 (&v)[C]) {
#pragma unroll
  for (int k = 0; k < C; ++k) v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// whether an edge loop checks its neighbours' coordinates: a warp whose
// voxels are all h or more from the y and x faces runs it with Checked<false>
template <bool C>
struct Checked {
  static constexpr bool value = C;
};

// 1 / sqrt(max(deg, 1)) of voxel (z, y, x): deg, its offsets whose
// neighbour lies inside the volume, is K where the voxel is h or more from
// every face, else counted
__device__ __forceinline__ float rsqrt_degree(const Stencil& st, int z,
                                              int y, int x, int D, int H,
                                              int W, int h) {
  int deg = st.k;
  if (z < h || z + h >= D || y < h || y + h >= H || x < h || x + h >= W) {
    deg = 0;
    for (int k = 0; k < st.k; ++k) {
      const char4 o = st.o[k];
      deg += z + o.x >= 0 && z + o.x < D && y + o.y >= 0 && y + o.y < H &&
             x + o.z >= 0 && x + o.z < W;
    }
  }
  return rsqrtf(fmaxf((float)deg, 1.f));
}

// the block's thread: its voxel (r, c) of the tile plane, its lane within
// the voxel's lanes, its warp's set
struct Thread {
  int set, sub, y, x;
  bool active;
};

template <int L>
__device__ __forceinline__ Thread thread_of(const Plan& p, const Tile& t,
                                            int warp, int lane) {
  Thread th;
  const int vw = voxel_warps(p);
  th.set = warp / vw;
  const int vi = (warp % vw) * (32 / L) + lane / L;
  th.sub = lane % L;
  const int r = vi / p.xr, c = vi % p.xr;
  th.y = t.ya + r;
  th.x = t.xa + c;
  th.active = vi < p.yr * p.xr && th.y < t.yb && th.x < t.xb;
  return th;
}

}  // namespace sg

// the class instantiation of kernel K for class `cls` (sg::class_of)
#define SG_BY_CLASS(K, cls) \
  ((cls) == 0 ? K<1, 4, 1> : (cls) == 1 ? K<1, 4, 4> : K<4, 4, 4>)
