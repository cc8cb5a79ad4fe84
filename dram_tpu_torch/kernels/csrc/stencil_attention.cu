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
// Forward and gradient pass: a plane ring. A block owns a tile (one batch
// element, a run of z-planes, a run of rows, a run of columns; the launch
// geometry is decided in Python, kernels/window_attention.py:fwd_plan and
// bwd_plan, and the launchers refuse a plan whose buffers or coverage
// differ from the kernel's). It streams its tile along z: the operands it
// gathers from neighbours are staged, plane by plane, into a ring of
// shared-memory buffers, the tile's rows and columns with a +-1 halo
// clipped to the volume, one cp.async.bulk per row (one per plane when
// the tile spans the whole width). A producer warp issues the copies of a
// plane once its buffer is free and they complete on the buffer's "full"
// mbarrier; each compute warp works on plane z from the buffers of z - 1,
// z and z + 1 and, done with z, releases z - 1 on that buffer's "empty"
// mbarrier. No barrier holds the block together between planes, so warps
// drift within the ring. A neighbour a plane away was, in the
// one-thread-per-voxel kernel this replaces, a gather that blocks on other
// SMs held and L2 served (10 of the 18 offsets; 640 and 1,440 bytes of L2
// traffic a voxel against bounds of 128 and 240): here every staged byte
// leaves device memory about once per tile, and the halo rows and planes
// are all that neighbouring tiles read again. The forward stages phi and
// g (and theta, the centre, so that no step waits on device memory) and
// writes out straight; the gradient pass stages phi and g (+o side),
// theta, ybar and the statistics (-o side) and writes the three gradients
// straight.
//
// A staged slot outside the volume is never copied and never read:
// validity (and the degree) comes from the thread's coordinates, as a
// stale or zero slot would still enter the softmax (a zero with logit 0).
// Coordinates come from the tile and the thread; only global offsets are
// int64. Two threads per voxel of the plane, so that a tile plane keeps
// enough warps in flight: in the forward the lanes l and l + 16 of a warp
// take the nine offsets before the centre and their mirror images and
// combine their sums by shuffles; in the gradient pass even warps take
// the +o side (dtheta), odd warps the -o side (dphi, dg) of the same 32
// voxels. A voxel's 32-byte rows are read as two 16-byte halves, lanes
// 4-7 of every 8 the upper half first, so that the eight lanes of a
// shared-memory phase hit eight distinct bank groups; a thread keeps its
// vectors in that lane order (dot products are order-free up to f32
// rounding) and stores them back to the same halves. The forward's
// softmax takes two passes over its staged neighbours (logits and their
// maximum, then the exponentials); the scal pass streams it as the TPU
// kernel does: a running max (starting at 0, which the relu allows) and a
// running sum rescale the accumulators. The offsets run in a fixed order,
// so two launches give equal bits. All arithmetic is f32.
//
// On the card the old kernels' plane-away gathers turned out to be a
// third of their time at most; both kernels are held back by the latency
// of their shared-memory reads and exponentials, so the blocks are small
// (a tile plane of 128 voxels, 288 threads) and three forward blocks or
// two gradient blocks share an SM; the gradient pass's neighbour loops
// stay rolled (BWD_UNROLL) to fit two blocks' registers
// (tools/attention_variants.py; NVIDIA H100 80GB HBM3, 700 W).
//
// The scal pass keeps the one-thread-per-voxel design with gathers
// through L1/L2 and a 1-D grid-stride loop in int64.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int F = 8;
constexpr int G = 8;
// threads a block may have: two a voxel of the tile's plane (at most 128
// voxels) and the producer warp
constexpr int FWD_THREADS = 288, BWD_THREADS = 288;
// neighbours of the gradient pass's loops unrolled together: a rolled loop
// keeps a thread's registers low enough for two blocks an SM
constexpr int BWD_UNROLL = 2;
// plane buffers a ring may have; its full and empty mbarriers fill the
// first 128 bytes
constexpr int MAX_NBUF = 8;
constexpr int BAR_BYTES = 128;
// bytes of one staged voxel: phi, g, theta (forward); phi, g, theta, ybar
// and the four statistics (gradient pass)
constexpr int FWD_VOXEL = 3 * 32, BWD_VOXEL = 4 * 32 + 16;

// one launch's tile plan (kernels/window_attention.py: the plan's `args`)
struct Plan {
  int zr, yr, xr, tiles_x, tiles_y, tiles_z, rows, cols, nbuf, threads,
      smem;
};

// dynamic shared memory: mbarriers, then nbuf plane buffers of rows x
// cols staged voxels (kernels/window_attention.py:_smem)
__host__ __device__ inline int smem_bytes(const Plan& p, int voxel) {
  return BAR_BYTES + p.nbuf * p.rows * p.cols * voxel;
}

__device__ __forceinline__ bool offset_of(int k, int* dz, int* dy, int* dx) {
  // k in [0, 27): lexicographic (z, y, x) over {-1, 0, 1}^3
  *dz = k / 9 - 1;
  *dy = (k / 3) % 3 - 1;
  *dx = k % 3 - 1;
  const int l1 = abs(*dz) + abs(*dy) + abs(*dx);
  return l1 > 0 && l1 <= 2;
}

// the 18 offsets as k = 9 (dz + 1) + 3 (dy + 1) + (dx + 1), in the order
// of offset_of (the plain version's)
__constant__ int kStencil[18] = {1,  3,  4,  5,  7,  9,  10, 11, 12,
                                 14, 15, 16, 17, 19, 21, 22, 23, 25};

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// the 8 floats at p in lane order: the half at p + h first (h = 0 or 4)
__device__ __forceinline__ void load8h(const float* p, int h, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p + h);
  const float4 b = *reinterpret_cast<const float4*>(p + (h ^ 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// store v, in lane order, to the 8 floats at p (streaming)
__device__ __forceinline__ void store8h(float* p, int h, const float* v) {
  __stcs(reinterpret_cast<float4*>(p + h),
         make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p + (h ^ 4)),
         make_float4(v[4], v[5], v[6], v[7]));
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive and announce `bytes` of bulk-copy transactions for the phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// 1-D bulk copy global -> shared (size and both addresses 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The tile of block `blk` and the spans it stages: planes [za, zb), rows
// [ya, yb), columns [xa, xb) of batch element b; staged planes pz0 .. pz1,
// rows ry0 .. ry1 and columns cx0 .. cx1 (the +-1 halo, clipped).
struct Tile {
  int b, za, zb, ya, yb, xa, xb, pz0, pz1, ry0, ry1, cx0, cx1;
};

__device__ __forceinline__ Tile tile_of(const Plan& p, int blk, int D, int H,
                                        int W) {
  Tile t;
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
  t.pz0 = max(t.za - 1, 0);
  t.pz1 = min(t.zb, D - 1);
  t.ry0 = max(t.ya - 1, 0);
  t.ry1 = min(t.yb, H - 1);
  t.cx0 = max(t.xa - 1, 0);
  t.cx1 = min(t.xb, W - 1);
  return t;
}

// The copies of one staged plane, issued by the 32 lanes of the producer
// warp after lane 0 has announced their bytes on the buffer's full
// mbarrier: rows r0 .. r1 (columns cx0 .. cx0 + ncols - 1) of plane
// `plane` of each of the nops (planes, H, W, vf) f32 volumes vol[o], with
// vf = 8 but for the last operand when `last4` (4 floats a voxel), row r
// of operand o to dst + o x pf + (r - ry0) x ncols x vf: one bulk copy per
// row, or one per operand when a row is whole.
__device__ __forceinline__ void stage_plane(
    float* dst, const float* v0, const float* v1, const float* v2,
    const float* v3, const float* v4, int nops, bool last4, int pf,
    int64_t plane, int H, int W, int ry0, int r0, int r1, int cx0, int ncols,
    uint64_t* bar, int lane) {
  const uint32_t row8 = (uint32_t)ncols * 32;
  const uint32_t bytes =
      (last4 ? (nops - 1) * row8 + row8 / 2 : nops * row8) * (r1 - r0 + 1);
  if (lane == 0) mbar_expect_tx(bar, bytes);
  __syncwarp();
  const bool whole = ncols == W;
  const int ncopy = whole ? 1 : r1 - r0 + 1;
  for (int j = lane; j < nops * ncopy; j += 32) {
    const int o = j / ncopy, r = r0 + j % ncopy;
    const int nr = whole ? r1 - r0 + 1 : 1;
    const int vf = last4 && o == nops - 1 ? 4 : 8;
    const float* vol = o == 0 ? v0 : o == 1 ? v1 : o == 2 ? v2 : o == 3 ? v3
                                                                      : v4;
    bulk_load(dst + o * pf + (size_t)(r - ry0) * ncols * vf,
              vol + ((plane * H + r) * W + cx0) * vf,
              (uint32_t)nr * ncols * vf * 4, bar);
  }
}

// A compute warp's view of the ring: the buffers of planes z - 1, z and
// z + 1 and the phase parity of plane z + 1 in its buffer (plane pl sits
// in buffer (pl - pz0) % nbuf, in that buffer's ((pl - pz0) / nbuf)-th
// phase), kept step by step without a division.
struct Window {
  int b[3];
  uint32_t par;
  int nbuf;

  // at the tile's first plane za, after waiting for planes pz0 .. za
  __device__ __forceinline__ Window(const Tile& t, int nbuf_,
                                    uint64_t* full)
      : par(0), nbuf(nbuf_) {
    const int k = t.za - t.pz0;  // 0 or 1, below nbuf
    for (int j = 0; j <= k; ++j) mbar_wait(&full[j], 0);
    b[0] = k > 0 ? k - 1 : 0;
    b[1] = k;
    b[2] = k + 1;
  }
  // wait for plane z + 1 where it exists
  __device__ __forceinline__ void wait_next(uint64_t* full, const Tile& t,
                                            int z) const {
    if (z + 1 <= t.pz1) mbar_wait(&full[b[2]], par);
  }
  // done with plane z: release z - 1 (its last reader), then step to z + 1
  __device__ __forceinline__ void advance(uint64_t* empty, const Tile& t,
                                          int z, int lane) {
    __syncwarp();
    if (lane == 0 && z - 1 >= t.pz0) mbar_arrive(&empty[b[0]]);
    b[0] = b[1];
    b[1] = b[2];
    if (++b[2] == nbuf) {
      b[2] = 0;
      par ^= 1;
    }
  }
};

// The full and empty mbarriers of a ring, set up by thread 0; `warps`
// compute warps release each plane.
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty,
                                          int nbuf, int warps) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < nbuf; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warp: every staged plane of the tile in order, each once
// its buffer's previous plane is released. stage(k, s) issues plane
// pz0 + k into buffer s.
template <typename Stage>
__device__ __forceinline__ void produce(uint64_t* empty, const Tile& t,
                                        int nbuf, Stage stage) {
  for (int k = 0; k <= t.pz1 - t.pz0; ++k) {
    const int s = k % nbuf;
    if (k >= nbuf) mbar_wait(&empty[s], (k / nbuf - 1) & 1);
    stage(k, s);
  }
}

// The forward. Two threads per voxel, lanes l and l + 16 of a warp (16
// voxels a warp): lane half 0 takes the nine offsets that come before the
// centre in (dz, dy, dx) order, half 1 their mirror images. Each computes
// its logits, the pair exchanges its maxima, each sums its exponentials
// and weighted g from the shared maximum, and the pair adds its sums: a
// softmax in two passes over the staged phi, then g, with no running
// rescale.
__global__ void __launch_bounds__(FWD_THREADS, 3)
    stencil_attention_kernel(const float* __restrict__ theta,
                             const float* __restrict__ phi,
                             const float* __restrict__ g,
                             float* __restrict__ out, int D, int H, int W,
                             Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_NBUF;
  float* bufs = reinterpret_cast<float*>(smem + BAR_BYTES);
  // one operand's plane: rows x cols voxels of 8 floats; a buffer holds
  // phi, g, then theta
  const int pf = p.rows * p.cols * 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = p.threads / 32 - 1;  // compute warps; then the producer
  const Tile t = tile_of(p, blockIdx.x, D, H, W);
  const int ncols = t.cx1 - t.cx0 + 1;
  if (t.ry1 - t.ry0 + 1 > p.rows || ncols > p.cols) __trap();
  ring_init(full, empty, p.nbuf, warps);

  if (warp == warps) {
    // rows staged per plane: the tile's and its halo
    const int sr0 = t.ry0, sr1 = t.ry1;
    produce(empty, t, p.nbuf, [&](int k, int s) {
      stage_plane(bufs + (size_t)s * 3 * pf, phi, g, theta, nullptr,
                  nullptr, 3, false, pf, (int64_t)t.b * D + t.pz0 + k, H, W,
                  t.ry0, sr0, sr1, t.cx0, ncols, &full[s], lane);
    });
    return;
  }

  // this thread: voxel (y, x) of each plane, offsets o (half 0) or -o
  // (half 1) for the nine o before the centre
  const int half = lane >> 4;
  const int vi = warp * 16 + (lane & 15);
  const int r = vi / p.xr, c = vi % p.xr;
  const int y = t.ya + r, x = t.xa + c;
  const bool active = vi < p.yr * p.xr && y < t.yb && x < t.xb;
  const int h = ((c >> 2) & 1) * 4;  // the half of a row it reads first
  const bool vy[3] = {y > 0, true, y + 1 < H};
  const bool vx[3] = {x > 0, true, x + 1 < W};
  const int at = ((y - t.ry0) * ncols + (x - t.cx0)) * 8;
  const int row = ncols * 8;
  // valid in-plane neighbours of (y, x): of the 4 edges and the centre
  // (the offsets with dz != 0), and of the 8 around the centre (dz = 0)
  const int c5 = 1 + vy[0] + vy[2] + vx[0] + vx[2];
  const int c8 = (1 + vy[0] + vy[2]) * (1 + vx[0] + vx[2]) - 1;

  Window w(t, p.nbuf, full);
  for (int z = t.za; z < t.zb; ++z) {
    w.wait_next(full, t, z);
    const bool vz[3] = {z > 0, true, z + 1 < D};
    int slot[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) slot[d] = w.b[d] * 3 * pf + at;
    const int deg = c8 + c5 * (vz[0] + vz[2]);
    const float rs = rsqrtf(fmaxf((float)deg, 1.f));
    float th[F];
    if (active) load8h(bufs + slot[1] + 2 * pf, h, th);
    // this lane's nine neighbours: staged offset and validity
    int q[9];
    bool ok[9];
    int n = 0;
#pragma unroll
    for (int k = 0; k < 13; ++k) {
      int dz, dy, dx;
      if (!offset_of(k, &dz, &dy, &dx)) continue;
      const int d = dy * row + dx * 8;
      const bool ok0 = vz[dz + 1] && vy[dy + 1] && vx[dx + 1];
      const bool ok1 = vz[1 - dz] && vy[1 - dy] && vx[1 - dx];
      ok[n] = active && (half ? ok1 : ok0);
      q[n] = half ? slot[1 - dz] - d : slot[dz + 1] + d;
      ++n;
    }
    float sl[9], m = 0.f;
#pragma unroll
    for (n = 0; n < 9; ++n) {
      sl[n] = 0.f;
      if (ok[n]) {
        float ph[F];
        load8h(bufs + q[n], h, ph);
        sl[n] = fmaxf(dot8(th, ph), 0.f) * rs;
        m = fmaxf(m, sl[n]);
      }
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
    float denom = 0.f, acc[G];
#pragma unroll
    for (int e = 0; e < G; ++e) acc[e] = 0.f;
#pragma unroll
    for (n = 0; n < 9; ++n) {
      if (ok[n]) {
        float gj[G];
        load8h(bufs + q[n] + pf, h, gj);
        const float ex = expf(sl[n] - m);
        denom += ex;
#pragma unroll
        for (int e = 0; e < G; ++e) acc[e] += ex * gj[e];
      }
    }
    w.advance(empty, t, z, lane);
    // the pair's sums (a + b == b + a: both lanes hold the same bits)
    denom += __shfl_xor_sync(0xffffffffu, denom, 16);
#pragma unroll
    for (int e = 0; e < G; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 16);
    if (active) {
      const float inv = 1.f / fmaxf(denom, 1e-12f);
      // lane half 0 stores the first four of its lane order, half 1 the
      // other four
      const int64_t v = (((int64_t)t.b * D + z) * H + y) * W + x;
      __stcs(reinterpret_cast<float4*>(out + v * G + (h ^ (half * 4))),
             make_float4((half ? acc[4] : acc[0]) * inv,
                         (half ? acc[5] : acc[1]) * inv,
                         (half ? acc[6] : acc[2]) * inv,
                         (half ? acc[7] : acc[3]) * inv));
    }
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
// from the staged statistics). A buffer holds phi, g, theta, ybar (8
// floats a voxel each), then the statistics (4 floats a voxel). Two
// threads per voxel in warps of one side each (warp pairs share 32
// voxels): even warps take the +o side and write dtheta, odd warps the
// -o side and write dphi and dg.
__global__ void __launch_bounds__(BWD_THREADS, 2)
    stencil_attention_bwd_kernel(const float* __restrict__ theta,
                                 const float* __restrict__ phi,
                                 const float* __restrict__ g,
                                 const float* __restrict__ ybar,
                                 const float* __restrict__ scal,
                                 float* __restrict__ dtheta,
                                 float* __restrict__ dphi,
                                 float* __restrict__ dg, int D, int H, int W,
                                 Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_NBUF;
  float* bufs = reinterpret_cast<float*>(smem + BAR_BYTES);
  const int pf = p.rows * p.cols * 8;
  const int slot_floats = 4 * pf + pf / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = p.threads / 32 - 1;  // compute warps; then the producer
  const Tile t = tile_of(p, blockIdx.x, D, H, W);
  const int ncols = t.cx1 - t.cx0 + 1;
  if (t.ry1 - t.ry0 + 1 > p.rows || ncols > p.cols) __trap();
  ring_init(full, empty, p.nbuf, warps);

  if (warp == warps) {
    produce(empty, t, p.nbuf, [&](int k, int s) {
      stage_plane(bufs + (size_t)s * slot_floats, phi, g, theta, ybar, scal,
                  5, true, pf, (int64_t)t.b * D + t.pz0 + k, H, W, t.ry0,
                  t.ry0, t.ry1, t.cx0, ncols, &full[s], lane);
    });
    return;
  }

  const bool minus = warp & 1;  // this warp's side: -o (else +o)
  const int vi = (warp >> 1) * 32 + lane;
  const int r = vi / p.xr, c = vi % p.xr;
  const int y = t.ya + r, x = t.xa + c;
  const bool active = vi < p.yr * p.xr && y < t.yb && x < t.xb;
  const int h = ((c >> 2) & 1) * 4;  // the half of a row it reads first
  const bool vy[3] = {y > 0, true, y + 1 < H};
  const bool vx[3] = {x > 0, true, x + 1 < W};
  const int at = (y - t.ry0) * ncols + (x - t.cx0);  // voxel in the plane
  const int row = ncols;

  Window w(t, p.nbuf, full);
  for (int z = t.za; z < t.zb; ++z) {
    w.wait_next(full, t, z);
    if (active) {
      const bool vz[3] = {z > 0, true, z + 1 < D};
      const float* slot[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) slot[d] = bufs + w.b[d] * slot_floats;
      const float* cen = slot[1] + at * 8;
      const int64_t v = (((int64_t)t.b * D + z) * H + y) * W + x;
      // bit n: the n-th offset's edge is valid for this side (+o: v + o
      // inside; -o: i = v - o inside)
      uint32_t valid = 0;
      int n = 0;
#pragma unroll
      for (int k = 0; k < 27; ++k) {
        int dz, dy, dx;
        if (!offset_of(k, &dz, &dy, &dx)) continue;
        const bool ok = minus ? vz[1 - dz] && vy[1 - dy] && vx[1 - dx]
                              : vz[dz + 1] && vy[dy + 1] && vx[dx + 1];
        valid |= (uint32_t)ok << n++;
      }
      if (!minus) {
        // +o side: v's softmax over its neighbour n = v + o
        float th[F], yb[G], dth[F];
        load8h(cen + 2 * pf, h, th);
        load8h(cen + 3 * pf, h, yb);
        const float4 sv =
            *reinterpret_cast<const float4*>(slot[1] + 4 * pf + at * 4);
        const float rv = sv.x, mv = sv.y, cv = sv.w;
        const float inv = 1.f / fmaxf(sv.z, 1e-12f);
#pragma unroll
        for (int e = 0; e < F; ++e) dth[e] = 0.f;
#pragma unroll BWD_UNROLL
        for (n = 0; n < 18; ++n) {
          if (!(valid >> n & 1)) continue;
          const int k = kStencil[n];
          const int dz = k / 9 - 1, dy = k / 3 % 3 - 1, dx = k % 3 - 1;
          const float* q = (dz < 0 ? slot[0] : dz > 0 ? slot[2] : slot[1]) +
                           (at + dy * row + dx) * 8;
          float pn[F], gn[G];
          load8h(q, h, pn);
          load8h(q + pf, h, gn);
          const float s = dot8(th, pn);
          const float a = expf(fmaxf(s, 0.f) * rv - mv) * inv;
          const float ds = s > 0.f ? a * (dot8(yb, gn) - cv) * rv : 0.f;
#pragma unroll
          for (int e = 0; e < F; ++e) dth[e] += ds * pn[e];
        }
        store8h(dtheta + v * F, h, dth);
      } else {
        // -o side: the softmax of i = v - o, whose neighbour v is; edge
        // validity is i's own
        float ph[F], gv[G], dph[F], dgv[G];
        load8h(cen, h, ph);
        load8h(cen + pf, h, gv);
#pragma unroll
        for (int e = 0; e < F; ++e) dph[e] = dgv[e] = 0.f;
#pragma unroll BWD_UNROLL
        for (n = 0; n < 18; ++n) {
          if (!(valid >> n & 1)) continue;
          const int k = kStencil[n];
          const int dz = k / 9 - 1, dy = k / 3 % 3 - 1, dx = k % 3 - 1;
          const int i = at - dy * row - dx;
          // the plane of i, z - dz
          const float* sp = dz > 0 ? slot[0] : dz < 0 ? slot[2] : slot[1];
          const float* q = sp + i * 8;
          float ti[F], yi[G];
          load8h(q + 2 * pf, h, ti);
          load8h(q + 3 * pf, h, yi);
          // the statistics of i, in the plane of i
          const float* ss = sp;
          const float4 si =
              *reinterpret_cast<const float4*>(ss + 4 * pf + i * 4);
          const float s2 = dot8(ti, ph);
          const float a2 = __fdividef(expf(fmaxf(s2, 0.f) * si.x - si.y),
                                      fmaxf(si.z, 1e-12f));
          const float ds2 = s2 > 0.f ? a2 * (dot8(yi, gv) - si.w) * si.x : 0.f;
#pragma unroll
          for (int e = 0; e < F; ++e) dph[e] = fmaf(ds2, ti[e], dph[e]);
#pragma unroll
          for (int e = 0; e < G; ++e) dgv[e] += a2 * yi[e];
        }
        store8h(dphi + v * F, h, dph);
        store8h(dg + v * G, h, dgv);
      }
    }
    w.advance(empty, t, z, lane);
  }
}

int64_t grid_blocks(int64_t total, int threads) {
  const int64_t blocks = (total + threads - 1) / threads;
  return blocks < 132 * 64 ? blocks : 132 * 64;
}

constexpr int kThreads = 256;

Plan plan_of(const int64_t* a) {
  return Plan{(int)a[0], (int)a[1], (int)a[2], (int)a[3], (int)a[4],
              (int)a[5], (int)a[6], (int)a[7], (int)a[8], (int)a[9],
              (int)a[10]};
}

// the plan covers the grid with its tiles, its threads are the tile's
// rows x columns, its buffers hold the tile's rows and columns with their
// halo, its ring holds three planes and a fourth (or more) loading, and
// its shared memory is this build's layout
bool plan_ok(const Plan& p, int64_t D, int64_t H, int64_t W, int voxel,
             int max_threads) {
  return p.zr > 0 && p.yr > 0 && p.xr > 0 &&
         (int64_t)p.tiles_x * p.xr >= W && (int64_t)p.tiles_y * p.yr >= H &&
         (int64_t)p.tiles_z * p.zr >= D &&
         p.threads == 64 * ((p.yr * p.xr + 31) / 32) + 32 &&
         p.threads <= max_threads && p.rows == (p.yr + 2 < H ? p.yr + 2 : H) &&
         p.cols == (p.xr + 2 < W ? p.xr + 2 : W) && p.nbuf >= 3 &&
         p.nbuf <= MAX_NBUF && p.smem == smem_bytes(p, voxel) &&
         p.smem <= 227 * 1024;
}

}  // namespace

// out (B, D, H, W, 8) from theta, phi, g (B, D, H, W, 8); args: the plan
extern "C" int stencil_attention_f32(const void* theta, const void* phi,
                                     const void* g, void* out, int64_t B,
                                     int64_t D, int64_t H, int64_t W,
                                     const int64_t* args, void* stream) {
  if (B * D * H * W == 0) return 0;
  const Plan p = plan_of(args);
  if (!plan_ok(p, D, H, W, FWD_VOXEL, FWD_THREADS)) return -1;
  cudaFuncSetAttribute(stencil_attention_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  const int64_t blocks = B * p.tiles_x * p.tiles_y * p.tiles_z;
  stencil_attention_kernel<<<(unsigned)blocks, p.threads, p.smem,
                             (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)phi, (const float*)g, (float*)out,
      (int)D, (int)H, (int)W, p);
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

// dtheta, dphi, dg (B, D, H, W, 8) from theta, phi, g, ybar (B, D, H, W,
// 8) and the statistics scal (B, D, H, W, 4); args: the plan
extern "C" int stencil_attention_bwd_f32(const void* theta, const void* phi,
                                         const void* g, const void* ybar,
                                         const void* scal, void* dtheta,
                                         void* dphi, void* dg, int64_t B,
                                         int64_t D, int64_t H, int64_t W,
                                         const int64_t* args, void* stream) {
  if (B * D * H * W == 0) return 0;
  const Plan p = plan_of(args);
  if (!plan_ok(p, D, H, W, BWD_VOXEL, BWD_THREADS)) return -1;
  cudaFuncSetAttribute(stencil_attention_bwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  const int64_t blocks = B * p.tiles_x * p.tiles_y * p.tiles_z;
  stencil_attention_bwd_kernel<<<(unsigned)blocks, p.threads, p.smem,
                                 (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)phi, (const float*)g,
      (const float*)ybar, (const float*)scal, (float*)dtheta, (float*)dphi,
      (float*)dg, (int)D, (int)H, (int)W, p);
  return (int)cudaGetLastError();
}
