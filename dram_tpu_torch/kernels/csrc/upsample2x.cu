// Align-corners 2x trilinear upsample over NDHWC bf16 volumes, and its
// adjoint, for Hopper.
//
// Replaces: dram_tpu/core/pallas/upsample.py:up2_depth_flat (forward,
// _fwd_call) together with the two XLA einsum passes around it in
// dram_tpu/core/pallas/cm.py:upsample2x_cm, i.e. the whole decoder
// upsample; and upsample.py:_bwd_call (the depth adjoint through the
// gather tables of cm.py:_up2_adjoint_tables) with the in-plane einsum
// adjoints XLA derives from cm.py:upsample2x_cm (:235-272). Source
// coordinate per axis: t = o * (n - 1) / (2n - 1) (cm.py:46-55, torch
// align_corners=True), in the f32 arithmetic of axis_tap.
//
// Bound on the H100: bytes, (|x| + |y|) / 3.35 TB/s either way; the
// high-resolution side is 8x the other and is most of it (the forward's
// write, the adjoint's read of dy). Both kernels move each of those
// bytes through device memory once.
//
// Design (both directions). A block owns a tile: one batch element, a
// run of z-planes, a run of rows, a run of columns and all channels (the
// launch geometry is decided in Python, kernels/upsample.py:fwd_plan and
// bwd_plan; the launchers refuse a plan that does not cover the output).
// It streams its tile along z: every plane it reads is staged into
// shared memory by one thread, one cp.async.bulk per row (a row's
// columns x channels are contiguous in NDHWC, and a multiple of 16
// bytes), completing on the plane buffer's mbarrier, while the block
// works on the planes before it. Neighbouring tiles re-read only their
// halo of rows and columns. The tap tables (lo, f per output; the
// adjoint's four weights per input) are built once per block in shared
// memory with the plain version's f32 arithmetic, so no element runs a
// floorf or an int64 division. A thread owns one row, a run of SX
// columns and one 8-channel group: consecutive threads hold consecutive
// channel groups, so every 16-byte load and store of a warp is part of
// whole 128-byte lines. f32 arithmetic, rounded to bf16 once.
//
// Forward: per output plane, a thread lerps the two staged input planes
// and two rows of its output row (4 shared loads per input column), keeps
// three such columns in registers and emits two outputs per column it
// adds: output o reads inputs lo(o), hi(o) from the window that starts
// at (o >> 1) - 1 (kernels/upsample.py:_check_axis holds this for every
// axis it plans). Three plane buffers: two read, one loading. Stores
// are streaming (st.global.cs).
//
// Adjoint (the exact adjoint of the forward, no atomics): input i gathers
// from outputs 2i - 1 .. 2i + 2 along each axis with weights (1 - f) where
// lo = i and f where hi = i. Per staged dy plane, a thread reduces over
// x (a sliding window of four dy columns, two new loads per input) and
// over its row's four y taps, then spreads the result with the plane's
// (1 - f, f) into f32 register accumulators of the <= 2 input planes it
// reaches; dy planes arrive in order, so an input plane is finished
// when lo passes it, and is rounded to bf16 and stored then. Two plane
// buffers: one read, one loading. The TPU path rounds to the activation
// dtype between its three separable passes in both directions; these
// kernels round once, which differs by bf16 rounding (~2^-8 relative).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FWD_SX = 8, BWD_SX = 4;      // x outputs / inputs a thread
constexpr int FWD_NBUF = 3, BWD_NBUF = 2;  // plane buffers
constexpr int FWD_THREADS = 256, BWD_THREADS = 256;

// one launch's tile plan (kernels/upsample.py: the plan's `args`)
struct Plan {
  int zr, yr, xr, nseg, tiles_x, tiles_y, tiles_z, rows, cols, planes,
      threads, smem;
};

__host__ __device__ inline int bar_bytes(int nbuf) {
  return 16 * ((8 * nbuf + 15) / 16);
}
__host__ __device__ inline int table_bytes(int entries) {
  return 16 * ((4 * entries + 15) / 16);
}
// dynamic shared memory: mbarriers, tap tables, plane buffers
// (kernels/upsample.py:_smem)
__host__ __device__ inline int smem_bytes(const Plan& p, int nbuf,
                                          int entries, int C) {
  return bar_bytes(nbuf) + table_bytes(entries) +
         nbuf * p.rows * p.cols * C * 2;
}
__host__ __device__ inline int fwd_entries(const Plan& p) {
  return 2 * (p.zr + p.yr + p.xr);
}
__host__ __device__ inline int bwd_entries(const Plan& p) {
  return 2 * p.planes + 4 * (p.yr + p.xr);
}

// torch align_corners: scale = (n-1)/(out-1) in f32, t = scale * o
__device__ __forceinline__ void axis_tap(int o, int n, int* lo, float* f) {
  const float scale = n > 1 ? (float)(n - 1) / (float)(2 * n - 1) : 0.f;
  const float t = scale * (float)o;
  int l = (int)floorf(t);
  if (l > n - 1) l = n - 1;
  *lo = l;
  *f = t - (float)l;
}

// weight of input i on output 2i - 1 + k of an axis of n inputs
__device__ __forceinline__ float adjoint_weight(int i, int k, int n) {
  const int o = 2 * i - 1 + k;
  if (i >= n || o < 0 || o >= 2 * n) return 0.f;
  int lo;
  float f;
  axis_tap(o, n, &lo, &f);
  const int hi = lo + 1 < n ? lo + 1 : n - 1;
  return (lo == i ? 1.f - f : 0.f) + (hi == i ? f : 0.f);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
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

__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(e[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  return out;
}

__device__ __forceinline__ int clampi(int v, int a, int b) {
  return v < a ? a : (v > b ? b : v);
}

// Stage `nrows` rows of `ncols` voxels of plane `plane`, starting at row
// `row0`, column `col0`, of a (planes, rows_total, cols_total, C) volume.
__device__ __forceinline__ void stage_plane(
    __nv_bfloat16* dst, const __nv_bfloat16* vol, int64_t plane,
    int rows_total, int cols_total, int C, int row0, int col0, int nrows,
    int ncols, uint64_t* bar) {
  const uint32_t row_bytes = (uint32_t)ncols * C * 2;
  mbar_expect_tx(bar, row_bytes * nrows);
  const __nv_bfloat16* src =
      vol + ((plane * rows_total + row0) * cols_total + col0) * C;
  for (int r = 0; r < nrows; ++r)
    bulk_load(dst + (size_t)r * ncols * C,
              src + (int64_t)r * cols_total * C, row_bytes, bar);
}

__global__ void __launch_bounds__(FWD_THREADS, 2)
    upsample2x_kernel(const __nv_bfloat16* __restrict__ x,
                      __nv_bfloat16* __restrict__ y, int D, int H, int W,
                      int C, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* lo_z = reinterpret_cast<int*>(smem + bar_bytes(FWD_NBUF));
  float* f_z = reinterpret_cast<float*>(lo_z + p.zr);
  int* lo_y = reinterpret_cast<int*>(f_z + p.zr);
  float* f_y = reinterpret_cast<float*>(lo_y + p.yr);
  int* lo_x = reinterpret_cast<int*>(f_y + p.yr);
  float* f_x = reinterpret_cast<float*>(lo_x + p.xr);
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(
      smem + bar_bytes(FWD_NBUF) + table_bytes(fwd_entries(p)));
  const int buf_elems = p.rows * p.cols * C;
  const int tid = threadIdx.x, G = C >> 3;

  // the tile: output planes [za, zb), rows [ya, yb), columns [xa, xb)
  int t = blockIdx.x;
  const int tx = t % p.tiles_x;
  t /= p.tiles_x;
  const int ty = t % p.tiles_y;
  t /= p.tiles_y;
  const int tz = t % p.tiles_z;
  const int b = t / p.tiles_z;
  const int za = tz * p.zr, zb = min(za + p.zr, 2 * D);
  const int ya = ty * p.yr, yb = min(ya + p.yr, 2 * H);
  const int xa = tx * p.xr, xb = min(xa + p.xr, 2 * W);
  for (int i = tid; i < zb - za; i += blockDim.x)
    axis_tap(za + i, D, &lo_z[i], &f_z[i]);
  for (int i = tid; i < yb - ya; i += blockDim.x)
    axis_tap(ya + i, H, &lo_y[i], &f_y[i]);
  for (int i = tid; i < xb - xa; i += blockDim.x)
    axis_tap(xa + i, W, &lo_x[i], &f_x[i]);
  // the input span the tile reads along each axis: lo(first) .. hi(last)
  int pz0, pz1, ry0, ry1, cx0, cx1;
  float f;
  axis_tap(za, D, &pz0, &f);
  axis_tap(zb - 1, D, &pz1, &f);
  axis_tap(ya, H, &ry0, &f);
  axis_tap(yb - 1, H, &ry1, &f);
  axis_tap(xa, W, &cx0, &f);
  axis_tap(xb - 1, W, &cx1, &f);
  pz1 = min(pz1 + 1, D - 1);
  ry1 = min(ry1 + 1, H - 1);
  cx1 = min(cx1 + 1, W - 1);
  const int nrows = ry1 - ry0 + 1, ncols = cx1 - cx0 + 1;
  if (nrows > p.rows || ncols > p.cols) __trap();  // not this plan's tile
  if (tid == 0) {
    for (int s = 0; s < FWD_NBUF; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_plane = [&](int plane) {  // thread 0 only
    const int k = plane - pz0, s = k % FWD_NBUF;
    stage_plane(bufs + (size_t)s * buf_elems, x, (int64_t)b * D + plane, H,
                W, C, ry0, cx0, nrows, ncols, &bars[s]);
  };
  int loaded = min(pz0 + FWD_NBUF - 1, pz1);
  if (tid == 0)
    for (int pl = pz0; pl <= loaded; ++pl) load_plane(pl);

  // this thread: output row yo, columns xo0 .. xo0 + FWD_SX - 1, group g
  const int g = tid % G, seg = (tid / G) % p.nseg, r = tid / (G * p.nseg);
  const int yo = ya + r, xo0 = xa + seg * FWD_SX;
  const bool active = yo < yb && xo0 < xb;
  int rl0 = 0, rl1 = 0;
  float fy = 0.f;
  if (active) {
    const int ly = lo_y[r], hy = min(ly + 1, H - 1);
    fy = f_y[r];
    rl0 = (ly - ry0) * ncols * C + g * 8;
    rl1 = (hy - ry0) * ncols * C + g * 8;
  }
  const float wy0 = 1.f - fy, wy1 = fy;

  for (int zo = za; zo < zb; ++zo) {
    const int lz = lo_z[zo - za], hz = min(lz + 1, D - 1);
    const float fz = f_z[zo - za];
    // load ahead up to hz + 1; its buffer held plane hz - 2 < lz, which
    // every thread finished with before the last __syncthreads
    const int want = min(hz + 1, pz1);
    if (tid == 0)
      for (int pl = loaded + 1; pl <= want; ++pl) load_plane(pl);
    loaded = max(loaded, want);
    const int kl = lz - pz0, kh = hz - pz0;
    mbar_wait(&bars[kl % FWD_NBUF], (kl / FWD_NBUF) & 1);
    mbar_wait(&bars[kh % FWD_NBUF], (kh / FWD_NBUF) & 1);
    if (active) {
      const __nv_bfloat16* A = bufs + (size_t)(kl % FWD_NBUF) * buf_elems;
      const __nv_bfloat16* Bz = bufs + (size_t)(kh % FWD_NBUF) * buf_elems;
      const float wz0 = 1.f - fz, wz1 = fz;
      // the z- and y-lerp of input column xin (clamped to the staged span)
      const float w00 = wz0 * wy0, w01 = wz0 * wy1, w10 = wz1 * wy0,
                  w11 = wz1 * wy1;
      auto column = [&](int xin, float* v) {
        const int c = (clampi(xin, cx0, cx1) - cx0) * C;
        float a[8];
        lds8(A + rl0 + c, a);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = w00 * a[k];
        lds8(A + rl1 + c, a);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] += w01 * a[k];
        lds8(Bz + rl0 + c, a);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] += w10 * a[k];
        lds8(Bz + rl1 + c, a);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] += w11 * a[k];
      };
      // output o from the window (w0, w1, w2) = columns base .. base + 2
      auto emit = [&](int o, const float* w0, const float* w1,
                      const float* w2, __nv_bfloat16* yrow) {
        const int d = lo_x[o - xa] - ((o >> 1) - 1);
        const float fo = f_x[o - xa];
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float a = d ? w1[k] : w0[k], c = d ? w2[k] : w1[k];
          v[k] = a + fo * (c - a);
        }
        __stcs(reinterpret_cast<uint4*>(yrow + o * C), pack8(v));
      };
      float w0[8], w1[8], w2[8];
      const int k0 = (xo0 >> 1) - 1;
      column(k0, w0);
      column(k0 + 1, w1);
      column(k0 + 2, w2);
      __nv_bfloat16* yrow =
          y + (((int64_t)b * 2 * D + zo) * 2 * H + yo) * 2 * W * C + g * 8;
#pragma unroll
      for (int j = 0; j < FWD_SX; j += 2) {
        const int o = xo0 + j;  // even; o + 1 < xb when o < xb
        if (o < xb) {
          emit(o, w0, w1, w2, yrow);
          emit(o + 1, w0, w1, w2, yrow);
        }
        if (j + 2 < FWD_SX) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            w0[k] = w1[k];
            w1[k] = w2[k];
          }
          column(k0 + j / 2 + 3, w2);
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(BWD_THREADS, 2)
    upsample2x_bwd_kernel(const __nv_bfloat16* __restrict__ dy,
                          __nv_bfloat16* __restrict__ dx, int D, int H,
                          int W, int C, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* wy = reinterpret_cast<float*>(smem + bar_bytes(BWD_NBUF));
  float* wx = wy + 4 * p.yr;
  int* lo_z = reinterpret_cast<int*>(wx + 4 * p.xr);
  float* f_z = reinterpret_cast<float*>(lo_z + p.planes);
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(
      smem + bar_bytes(BWD_NBUF) + table_bytes(bwd_entries(p)));
  const int buf_elems = p.rows * p.cols * C;
  const int tid = threadIdx.x, G = C >> 3;

  // the tile: input planes [za, zb), rows [ya, yb), columns [xa, xb)
  int t = blockIdx.x;
  const int tx = t % p.tiles_x;
  t /= p.tiles_x;
  const int ty = t % p.tiles_y;
  t /= p.tiles_y;
  const int tz = t % p.tiles_z;
  const int b = t / p.tiles_z;
  const int za = tz * p.zr, zb = min(za + p.zr, D);
  const int ya = ty * p.yr, yb = min(ya + p.yr, H);
  const int xa = tx * p.xr, xb = min(xa + p.xr, W);
  // the dy span that reaches the tile: outputs 2a - 1 .. 2(b - 1) + 2
  const int pz0 = max(2 * za - 1, 0), pz1 = min(2 * zb, 2 * D - 1);
  const int ry0 = max(2 * ya - 1, 0), ry1 = min(2 * yb, 2 * H - 1);
  const int cx0 = max(2 * xa - 1, 0), cx1 = min(2 * xb, 2 * W - 1);
  const int nrows = ry1 - ry0 + 1, ncols = cx1 - cx0 + 1;
  if (nrows > p.rows || ncols > p.cols || pz1 - pz0 + 1 > p.planes)
    __trap();  // not this plan's tile
  for (int i = tid; i <= pz1 - pz0; i += blockDim.x)
    axis_tap(pz0 + i, D, &lo_z[i], &f_z[i]);
  for (int i = tid; i < 4 * p.yr; i += blockDim.x)
    wy[i] = adjoint_weight(ya + i / 4, i % 4, H);
  for (int i = tid; i < 4 * p.xr; i += blockDim.x)
    wx[i] = adjoint_weight(xa + i / 4, i % 4, W);
  if (tid == 0) {
    for (int s = 0; s < BWD_NBUF; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_plane = [&](int plane) {  // thread 0 only
    const int s = (plane - pz0) % BWD_NBUF;
    stage_plane(bufs + (size_t)s * buf_elems, dy,
                (int64_t)b * 2 * D + plane, 2 * H, 2 * W, C, ry0, cx0, nrows,
                ncols, &bars[s]);
  };
  if (tid == 0)
    for (int pl = pz0; pl <= min(pz0 + BWD_NBUF - 1, pz1); ++pl)
      load_plane(pl);

  // this thread: input row yi, columns xi0 .. xi0 + BWD_SX - 1, group g
  const int g = tid % G, seg = (tid / G) % p.nseg, r = tid / (G * p.nseg);
  const int yi = ya + r, xi0 = xa + seg * BWD_SX;
  const bool active = yi < yb && xi0 < xb;
  int roff[4];
  float wyk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    roff[k] = (clampi(2 * yi - 1 + k, ry0, ry1) - ry0) * ncols * C + g * 8;
    wyk[k] = active ? wy[4 * r + k] : 0.f;
  }
  float cur_acc[BWD_SX][8], nxt_acc[BWD_SX][8];
#pragma unroll
  for (int j = 0; j < BWD_SX; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) cur_acc[j][k] = nxt_acc[j][k] = 0.f;
  int cur = za - 1;  // the input plane cur_acc holds; nxt_acc holds cur + 1

  auto store = [&](int plane, float (&acc)[BWD_SX][8]) {
    if (!active || plane < za || plane >= zb) return;
    __nv_bfloat16* row =
        dx + (((int64_t)b * D + plane) * H + yi) * W * C + g * 8;
#pragma unroll
    for (int j = 0; j < BWD_SX; ++j)
      if (xi0 + j < xb)
        *reinterpret_cast<uint4*>(row + (xi0 + j) * C) = pack8(acc[j]);
  };

  for (int pl = pz0; pl <= pz1; ++pl) {
    const int k = pl - pz0;
    const int lz = lo_z[k], hz = min(lz + 1, D - 1);
    const float fz = f_z[k];
    if (lz > cur) {  // input plane cur has all its contributions
      store(cur, cur_acc);
#pragma unroll
      for (int j = 0; j < BWD_SX; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          cur_acc[j][e] = nxt_acc[j][e];
          nxt_acc[j][e] = 0.f;
        }
      ++cur;
    }
    // lz == cur here (lo steps by 0 or 1: kernels/upsample.py:_check_axis)
    const float wc = (1.f - fz) + (hz == cur ? fz : 0.f);
    const float wn = hz == cur + 1 ? fz : 0.f;
    mbar_wait(&bars[k % BWD_NBUF], (k / BWD_NBUF) & 1);
    if (active) {
      const __nv_bfloat16* buf = bufs + (size_t)(k % BWD_NBUF) * buf_elems;
      const int c0 = 2 * xi0 - 1;
#pragma unroll
      for (int ky = 0; ky < 4; ++ky) {
        if (wyk[ky] == 0.f) continue;
        const float ac = wc * wyk[ky], an = wn * wyk[ky];
        const __nv_bfloat16* row = buf + roff[ky];
        auto col = [&](int c) { return (clampi(c, cx0, cx1) - cx0) * C; };
        float v0[8], v1[8], v2[8], v3[8];
        lds8(row + col(c0), v0);
        lds8(row + col(c0 + 1), v1);
        lds8(row + col(c0 + 2), v2);
        lds8(row + col(c0 + 3), v3);
#pragma unroll
        for (int j = 0; j < BWD_SX; ++j) {
          const float4 w = *reinterpret_cast<const float4*>(
              wx + 4 * min(xi0 - xa + j, p.xr - 1));
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float q =
                w.x * v0[e] + w.y * v1[e] + w.z * v2[e] + w.w * v3[e];
            cur_acc[j][e] += ac * q;
            nxt_acc[j][e] += an * q;
          }
          if (j + 1 < BWD_SX) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              v0[e] = v2[e];
              v1[e] = v3[e];
            }
            lds8(row + col(c0 + 2 * j + 4), v2);
            lds8(row + col(c0 + 2 * j + 5), v3);
          }
        }
      }
    }
    __syncthreads();
    if (tid == 0 && pl + BWD_NBUF <= pz1) load_plane(pl + BWD_NBUF);
  }
  store(cur, cur_acc);
  store(cur + 1, nxt_acc);  // only where lo of the axis' last output < n-1
}

Plan plan_of(const int64_t* a) {
  return Plan{(int)a[0], (int)a[1], (int)a[2], (int)a[3], (int)a[4],
              (int)a[5], (int)a[6], (int)a[7], (int)a[8], (int)a[9],
              (int)a[10], (int)a[11]};
}

// the plan covers the extents (ez, ey, ex) with its tiles, its threads
// are a row x segment x channel-group grid, its shared memory is this
// build's layout
bool plan_ok(const Plan& p, int ez, int ey, int ex, int C, int sx, int nbuf,
             int entries, int max_threads) {
  return p.zr > 0 && p.yr > 0 && p.xr > 0 && p.nseg * sx >= p.xr &&
         (int64_t)p.tiles_x * p.xr >= ex && (int64_t)p.tiles_y * p.yr >= ey &&
         (int64_t)p.tiles_z * p.zr >= ez &&
         p.threads == p.yr * p.nseg * (C / 8) && p.threads <= max_threads &&
         p.smem == smem_bytes(p, nbuf, entries, C) && p.smem <= 227 * 1024;
}

}  // namespace

// y (B, 2D, 2H, 2W, C) from x (B, D, H, W, C); args: the plan
extern "C" int upsample2x_bf16(const void* x, void* y, int64_t B, int64_t D,
                               int64_t H, int64_t W, int64_t C,
                               const int64_t* args, void* stream) {
  if (B * D * H * W * C == 0) return 0;
  const Plan p = plan_of(args);
  if (C % 8 || p.xr % 2 ||
      !plan_ok(p, 2 * D, 2 * H, 2 * W, C, FWD_SX, FWD_NBUF, fwd_entries(p),
               FWD_THREADS))
    return -1;
  cudaFuncSetAttribute(upsample2x_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  const int64_t blocks = B * p.tiles_x * p.tiles_y * p.tiles_z;
  upsample2x_kernel<<<(unsigned)blocks, p.threads, p.smem,
                      (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)y, (int)D, (int)H, (int)W,
      (int)C, p);
  return (int)cudaGetLastError();
}

// dx (B, D, H, W, C) from the cotangent dy (B, 2D, 2H, 2W, C); args: the
// plan
extern "C" int upsample2x_bwd_bf16(const void* dy, void* dx, int64_t B,
                                   int64_t D, int64_t H, int64_t W,
                                   int64_t C, const int64_t* args,
                                   void* stream) {
  if (B * D * H * W * C == 0) return 0;
  const Plan p = plan_of(args);
  if (C % 8 || !plan_ok(p, D, H, W, C, BWD_SX, BWD_NBUF, bwd_entries(p),
                        BWD_THREADS) ||
      p.planes < 1)
    return -1;
  cudaFuncSetAttribute(upsample2x_bwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  const int64_t blocks = B * p.tiles_x * p.tiles_y * p.tiles_z;
  upsample2x_bwd_kernel<<<(unsigned)blocks, p.threads, p.smem,
                          (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)dy, (__nv_bfloat16*)dx, (int)D, (int)H, (int)W,
      (int)C, p);
  return (int)cudaGetLastError();
}
