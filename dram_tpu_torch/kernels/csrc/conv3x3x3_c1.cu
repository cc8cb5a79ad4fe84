// The network-entry 3x3x3 zero-padded stride-1 convolution, one input
// channel (the CT chunk) to Co output channels over NDHWC bf16 volumes,
// and its weight gradient.
//
// Replaces, at Ci = 1: dram_tpu/core/pallas/fused_stack.py:conv_cm (kernel
// _cbr_kernel; entry :305 -> pallas_call :364) in the entry stack's eval
// and training-forward uses, and conv_dw_cm (kernel _dw_kernel_pro; :388
// -> :417) in its backward, both reached on the input that
// dram_tpu/models/blocks.py:235-242 zero-pads to 8 channels; and the
// unfused stack's dram_tpu/core/pallas/conv3d.py:_fwd_impl (:168 -> :186)
// and _vjp_bwd's dW (:230 -> :250) at Ci = 1. The 8-channel pad is the
// TPU's sublane floor; here the one channel is read as it is.
//
// Bound on the H100: bytes. The forward reads 2 bytes a voxel and writes
// 2 Co (64 at the flagship's Co = 32): 0.101 ms at 10 x 80^3 against
// 8.85 GFLOP of useful products (0.009 ms at 989 TFLOP/s). The weight
// gradient reads the same dy and x: 0.101 ms as well.
//
// Forward (conv3x3x3_c1_kernel): a block of 8 warps owns a run of output
// tiles of 16 x 8 x 8 voxels (x, y, z) of one batch element. It loads
// the tile's halo (18 x 10 x 10 bf16, zero outside the volume: the conv's
// padding) into shared memory, the next tile's halo into registers while
// it computes the current one, and keeps the weights in shared memory,
// rounded to bf16 from the f32 parameter and laid out as mma fragments.
// The 27 taps, padded to K = 32, run on the tensor cores (mma.sync
// m16n8k16 bf16 -> f32): M is 16 consecutive x voxels of one (y, z) row,
// N 32 output channels (a loop over 32-channel chunks for Co > 32). The
// columns of each n8 tile are permuted so that a thread's accumulators
// hold 8 consecutive channels of its voxel: the epilogue writes them as
// one 16-byte store, and a warp's store covers 8 whole voxels (512
// contiguous bytes at Co = 32). Modes, as the wgmma kernel keeps them
// (conv3x3x3.cu):
// - eval (ep_s, ep_t): relu(acc * ep_s + ep_t), rounded once to bf16;
// - raw: bf16(acc);
// - raw + statistics (partials): each block sums the f32 accumulators of
//   its voxels inside the volume, and their squares, per channel (warp
//   shuffles, then the 8 warps in a fixed order) and writes one row
//   partials[block][0|1][Co]; colsum_f32 adds the rows. No atomics: two
//   launches agree bitwise.
//
// Weight gradient (conv3x3x3_c1_dw_kernel): dW[tap, co] = sum over the
// batch's voxels v of x[v + off(tap)] * dy[v, co], a GEMM with M = 27
// taps (padded to 32), N = 32 output channels per block and K = the
// voxels, on mma.sync. K is split over blocks in runs of boxes of 16 x 8
// x 2 voxels that cover each voxel once. dy streams through a 3-stage
// cp.async ring (zero fill outside the volume: those voxels add nothing);
// the x halo (18 x 10 x 4) goes through registers one box ahead and is
// kept twice in shared memory, the second copy shifted by one element,
// so that every pair of x-adjacent voxels is one aligned 32-bit load. dy
// fragments come by ldmatrix.trans from rows padded to 80 bytes (no bank
// conflicts). Each block writes its 27 x 32 f32 partial tile to
// part[split]; colsum_f32 adds the splits in a fixed order.
//
// The launch geometry is decided in kernels/conv_stack.py (c1_plan,
// c1_dw_plan); the launchers refuse a plan that does not cover the
// output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_wgmma.cuh"

namespace {

constexpr int C1_THREADS = 256;   // 8 warps
constexpr int C1_MIN_BLOCKS = 2;  // resident per SM (conv_stack.C1_BLOCKS)
constexpr int C1_NC = 32;         // output channels per chunk: 4 n8 tiles

// --- forward ------------------------------------------------------------

constexpr int C1_BX = 16, C1_BY = 8, C1_BZ = 8;  // output tile
constexpr int C1_HX = C1_BX + 2, C1_HY = C1_BY + 2, C1_HZ = C1_BZ + 2;
constexpr int C1_HALO = C1_HX * C1_HY * C1_HZ;
constexpr int C1_PRE = (C1_HALO + C1_THREADS - 1) / C1_THREADS;

enum { C1_RAW = 0, C1_EVAL = 1, C1_STATS = 2 };

struct C1Params {
  const uint16_t* x;  // (B, D, H, W) bf16
  const float* w;     // (Co, 27) f32, tap = kd 9 + kh 3 + kw
  const float* ep_s;
  const float* ep_t;
  uint8_t* y;  // (B, D, H, W, Co) bf16
  float* partials;
  int Co, nchunks;
  int D, H, W;
  int nbx, nby, nbz;  // tiles per batch element along x, y, z
  int ntiles, per;    // tiles in all; a block's run
};

// dynamic shared memory: weight fragments, epilogue coefficients,
// statistics rows of the 8 warps, the halo tile
__host__ __device__ constexpr int c1_smem(int nchunks) {
  return nchunks * 256 * 8 + 2 * nchunks * C1_NC * 4 +
         8 * 2 * nchunks * C1_NC * 4 + C1_HALO * 2;
}

__device__ __forceinline__ void c1_tile(const C1Params& p, int t, int& b,
                                        int& z0, int& y0, int& x0) {
  x0 = (t % p.nbx) * C1_BX;
  t /= p.nbx;
  y0 = (t % p.nby) * C1_BY;
  t /= p.nby;
  z0 = (t % p.nbz) * C1_BZ;
  b = t / p.nbz;
}

// this thread's elements e = tid + 256 i of tile t's halo, zero outside
// the volume
__device__ __forceinline__ void c1_load_halo(const C1Params& p, int t,
                                             uint16_t (&v)[C1_PRE]) {
  int b, z0, y0, x0;
  c1_tile(p, t, b, z0, y0, x0);
#pragma unroll
  for (int i = 0; i < C1_PRE; ++i) {
    const int e = threadIdx.x + i * C1_THREADS;
    const int gx = x0 - 1 + e % C1_HX, gy = y0 - 1 + (e / C1_HX) % C1_HY,
              gz = z0 - 1 + e / (C1_HX * C1_HY);
    v[i] = 0;
    if (e < C1_HALO && gx >= 0 && gx < p.W && gy >= 0 && gy < p.H &&
        gz >= 0 && gz < p.D)
      v[i] = __ldg(p.x + ((static_cast<int64_t>(b) * p.D + gz) * p.H + gy) *
                             p.W + gx);
  }
}

// weight (n, tap k) rounded to bf16 (as the plain version rounds it)
__device__ __forceinline__ uint16_t c1_w(const C1Params& p, int k, int n) {
  if (k >= 27 || n >= p.Co) return 0;
  const __nv_bfloat16 h = __float2bfloat16_rn(p.w[n * 27 + k]);
  return *reinterpret_cast<const uint16_t*>(&h);
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// D(16 x 8, f32) += A(16 x 16, bf16, row) * B(16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int MODE>
__global__ void __launch_bounds__(C1_THREADS, C1_MIN_BLOCKS)
    conv3x3x3_c1_kernel(const C1Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ncp = p.nchunks * C1_NC;
  uint2* wfrag = reinterpret_cast<uint2*>(smem);
  float* ep = reinterpret_cast<float*>(wfrag + p.nchunks * 256);
  float* red = ep + 2 * ncp;
  uint16_t* halo = reinterpret_cast<uint16_t*>(red + 16 * ncp);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // weight fragments [chunk][k step][n tile j][lane]: B(k, col gL) of
  // n tile j is output channel (gL / 2) 8 + 2 j + gL % 2 of the chunk, so
  // that accumulator columns 2t, 2t + 1 of tile j are channels 8t + 2j,
  // 8t + 2j + 1; zero past tap 26 and past Co
  for (int i = threadIdx.x; i < p.nchunks * 256; i += C1_THREADS) {
    const int L = i & 31, j = (i >> 5) & 3, ks = (i >> 7) & 1, nc = i >> 8;
    const int gl = L >> 2, k = ks * 16 + 2 * (L & 3);
    const int n = nc * C1_NC + (gl >> 1) * 8 + 2 * j + (gl & 1);
    wfrag[i] = make_uint2(pack2(c1_w(p, k, n), c1_w(p, k + 1, n)),
                          pack2(c1_w(p, k + 8, n), c1_w(p, k + 9, n)));
  }
  for (int i = threadIdx.x; i < ncp; i += C1_THREADS) {
    if (MODE == C1_EVAL) {
      ep[i] = i < p.Co ? p.ep_s[i] : 0.f;
      ep[ncp + i] = i < p.Co ? p.ep_t[i] : 0.f;
    }
  }
  if (MODE == C1_STATS)
    for (int i = threadIdx.x; i < 16 * ncp; i += C1_THREADS) red[i] = 0.f;

  // halo offsets of this thread's A columns k = 16 ks + 8 c + 2t + e
  // (tap (kd, kh, kw) of k reads the halo at (kd, kh, kw) from the voxel);
  // columns past tap 26 read zero
  int off[2][2][2];
  uint32_t kvalid = 0;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = ks * 16 + c * 8 + 2 * t + e;
        off[ks][c][e] =
            k < 27 ? ((k / 9) * C1_HY + (k / 3) % 3) * C1_HX + k % 3 : 0;
        if (k < 27) kvalid |= 1u << (ks * 4 + c * 2 + e);
      }

  const int t0 = blockIdx.x * p.per;
  const int t1 = min(t0 + p.per, p.ntiles);
  const bool vec = p.Co % 8 == 0;
  uint16_t pre[C1_PRE];
  if (t0 < t1) c1_load_halo(p, t0, pre);
  for (int tile = t0; tile < t1; ++tile) {
    __syncthreads();  // the previous tile's halo reads are done
#pragma unroll
    for (int i = 0; i < C1_PRE; ++i) {
      const int e = threadIdx.x + i * C1_THREADS;
      if (e < C1_HALO) halo[e] = pre[i];
    }
    __syncthreads();
    if (tile + 1 < t1) c1_load_halo(p, tile + 1, pre);  // lands meanwhile
    int b, z0, y0, x0;
    c1_tile(p, tile, b, z0, y0, x0);
    const int y = y0 + warp;  // this warp's row of the tile
    for (int nc = 0; nc < p.nchunks; ++nc) {
      uint2 bfr[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bfr[ks][j] = wfrag[((nc * 2 + ks) * 4 + j) * 32 + lane];
      const int c0 = nc * C1_NC + 8 * t;  // this thread's 8 channels
      float es[8], et[8];
      if (MODE == C1_EVAL)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          es[i] = ep[c0 + i];
          et[i] = ep[ncp + c0 + i];
        }
      float su[8], sq[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) su[i] = sq[i] = 0.f;
#pragma unroll 2
      for (int zz = 0; zz < C1_BZ; ++zz) {
        const int base = (zz * C1_HY + warp) * C1_HX + g;
        uint32_t a[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int c = r >> 1, row = base + (r & 1) * 8;
            const int bit = ks * 4 + c * 2;
            const uint16_t lo = (kvalid >> bit) & 1
                                    ? halo[row + off[ks][c][0]] : uint16_t(0);
            const uint16_t hi = (kvalid >> (bit + 1)) & 1
                                    ? halo[row + off[ks][c][1]] : uint16_t(0);
            a[ks][r] = pack2(lo, hi);
          }
        // one mma chain a column tile: K step 1 (taps 16-26 and the zero
        // pad), then K step 0 (taps 0-15). Of the orders that
        // tools/entry_conv_orders.py reads, this one lands nearest the
        // exactly rounded conv.
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma16816(acc[j], a[1], bfr[1][j].x, bfr[1][j].y);
          mma16816(acc[j], a[0], bfr[0][j].x, bfr[0][j].y);
        }

        const int z = z0 + zz;
        const bool rok = y < p.H && z < p.D;
        const bool ok[2] = {rok && x0 + g < p.W, rok && x0 + g + 8 < p.W};
        if (MODE == C1_STATS)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float v = ok[h] ? acc[j][2 * h + e] : 0.f;
                su[2 * j + e] += v;
                sq[2 * j + e] += v * v;
              }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!ok[h]) continue;
          uint32_t q[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
            if (MODE == C1_EVAL) {
              v0 = fmaxf(v0 * es[2 * j] + et[2 * j], 0.f);
              v1 = fmaxf(v1 * es[2 * j + 1] + et[2 * j + 1], 0.f);
            }
            q[j] = bf2(v0, v1);
          }
          const int64_t vox =
              ((static_cast<int64_t>(b) * p.D + z) * p.H + y) * p.W + x0 + g +
              8 * h;
          uint8_t* dst = p.y + (vox * p.Co + c0) * 2;
          if (vec && c0 + 8 <= p.Co) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c0 + 2 * j < p.Co)
                *reinterpret_cast<uint32_t*>(dst + 4 * j) = q[j];
          }
        }
      }
      if (MODE == C1_STATS) {
        // over the 8 rows g of the warp (lanes of one t), fixed order
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int k = 4; k < 32; k <<= 1) {
            su[i] += __shfl_xor_sync(0xffffffffu, su[i], k);
            sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], k);
          }
        if (g == 0)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            red[warp * 2 * ncp + c0 + i] += su[i];
            red[(warp * 2 + 1) * ncp + c0 + i] += sq[i];
          }
      }
    }
  }
  if (MODE == C1_STATS) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * p.Co; i += C1_THREADS) {
      const int k = i / p.Co, c = i % p.Co;
      float tot = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) tot += red[(w * 2 + k) * ncp + c];
      p.partials[static_cast<int64_t>(blockIdx.x) * 2 * p.Co + i] = tot;
    }
  }
}

// --- weight gradient -------------------------------------------------------

constexpr int DW1_BX = 16, DW1_BY = 8, DW1_BZ = 2;  // K box
constexpr int DW1_VOX = DW1_BX * DW1_BY * DW1_BZ;
constexpr int DW1_HX = DW1_BX + 2, DW1_HY = DW1_BY + 2, DW1_HZ = DW1_BZ + 2;
constexpr int DW1_HALO = DW1_HX * DW1_HY * DW1_HZ;
constexpr int DW1_PRE = (DW1_HALO + C1_THREADS - 1) / C1_THREADS;
constexpr int DW1_ROW = 40;  // bf16 a staged dy row: 32 channels + 8 pad
constexpr int DW1_STAGES = 3;
constexpr int DW1_STAGE_BYTES = DW1_VOX * DW1_ROW * 2;
constexpr int DW1_SMEM = DW1_STAGES * DW1_STAGE_BYTES + 2 * 2 * DW1_HALO * 2;
static_assert(8 * 32 * 32 * 4 <= DW1_STAGES * DW1_STAGE_BYTES,
              "the final reduction reuses the dy ring");

struct C1DwParams {
  const uint16_t* x;   // (B, D, H, W) bf16
  const uint16_t* dy;  // (B, D, H, W, Co) bf16
  float* part;         // (nsplit, 27, Co) f32
  int Co;
  int D, H, W;
  int nbx, nby, nbz;
  int nboxes, kboxes;  // K boxes in all; a split's run
};

__device__ __forceinline__ void dw1_box(const C1DwParams& p, int kb, int& b,
                                        int& z0, int& y0, int& x0) {
  x0 = (kb % p.nbx) * DW1_BX;
  kb /= p.nbx;
  y0 = (kb % p.nby) * DW1_BY;
  kb /= p.nby;
  z0 = (kb % p.nbz) * DW1_BZ;
  b = kb / p.nbz;
}

__device__ __forceinline__ void dw1_load_halo(const C1DwParams& p, int kb,
                                              uint16_t (&v)[DW1_PRE]) {
  int b, z0, y0, x0;
  dw1_box(p, kb, b, z0, y0, x0);
#pragma unroll
  for (int i = 0; i < DW1_PRE; ++i) {
    const int e = threadIdx.x + i * C1_THREADS;
    const int gx = x0 - 1 + e % DW1_HX, gy = y0 - 1 + (e / DW1_HX) % DW1_HY,
              gz = z0 - 1 + e / (DW1_HX * DW1_HY);
    v[i] = 0;
    if (e < DW1_HALO && gx >= 0 && gx < p.W && gy >= 0 && gy < p.H &&
        gz >= 0 && gz < p.D)
      v[i] = __ldg(p.x + ((static_cast<int64_t>(b) * p.D + gz) * p.H + gy) *
                             p.W + gx);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   wg::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   wg::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// box kb's dy, channels co0 .. co0 + 31, into a stage ([voxel][DW1_ROW]);
// zeros for voxels outside the volume and channels past Co
__device__ __forceinline__ void dw1_load_dy(const C1DwParams& p, int kb,
                                            int co0, uint16_t* dst) {
  int b, z0, y0, x0;
  dw1_box(p, kb, b, z0, y0, x0);
  const bool vec = p.Co % 8 == 0;
  const int words = vec ? 4 : 16;  // copies per voxel row
  for (int i = threadIdx.x; i < DW1_VOX * words; i += C1_THREADS) {
    const int v = i / words, q = i % words;
    const int gx = x0 + v % DW1_BX, gy = y0 + (v / DW1_BX) % DW1_BY,
              gz = z0 + v / (DW1_BX * DW1_BY);
    const int c = co0 + q * (vec ? 8 : 2);
    const bool ok = gx < p.W && gy < p.H && gz < p.D && c < p.Co;
    const uint16_t* src =
        ok ? p.dy + (((static_cast<int64_t>(b) * p.D + gz) * p.H + gy) * p.W +
                     gx) * p.Co + c
           : p.dy;
    uint16_t* d = dst + v * DW1_ROW + (c - co0);
    if (vec)
      cp_async16(d, src, ok ? 16 : 0);
    else
      cp_async4(d, src, ok ? 4 : 0);
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(wg::smem_u32(p)));
}

// grid (output-channel chunk of 32, split of K)
__global__ void __launch_bounds__(C1_THREADS, C1_MIN_BLOCKS)
    conv3x3x3_c1_dw_kernel(const C1DwParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  uint16_t* halo =
      reinterpret_cast<uint16_t*>(smem + DW1_STAGES * DW1_STAGE_BYTES);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int co0 = blockIdx.x * C1_NC, split = blockIdx.y;
  const int kb0 = split * p.kboxes;
  const int nb = min(p.kboxes, p.nboxes - kb0);

  // this thread's A rows: taps 16 mt + 8 hh + g; tap (kd, kh, kw) of a
  // voxel pair at x = 2t (+ 8) is the aligned word of halo copy kw % 2
  // at ((kd ..) HY + kh ..) HX / 2 + kw / 2 + t
  int tword[2][2], tcopy[2][2];
  bool tok[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = mt * 16 + hh * 8 + g;
      const int kd = k / 9, kh = (k / 3) % 3, kw = k % 3;
      tok[mt][hh] = k < 27;
      tword[mt][hh] = k < 27 ? (kd * DW1_HY + kh) * (DW1_HX / 2) + kw / 2 : 0;
      tcopy[mt][hh] = k < 27 ? kw & 1 : 0;
    }

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;

  uint16_t pre[DW1_PRE];
  if (nb > 0) dw1_load_halo(p, kb0, pre);
#pragma unroll
  for (int s = 0; s < DW1_STAGES - 1; ++s) {
    if (s < nb)
      dw1_load_dy(p, kb0 + s, co0, ring + s * DW1_VOX * DW1_ROW);
    cp_async_commit();
  }
  for (int i = 0; i < nb; ++i) {
    // halo buffer i % 2: copy 0 as loaded, copy 1 shifted by one element
    uint16_t* hb = halo + (i & 1) * 2 * DW1_HALO;
#pragma unroll
    for (int k = 0; k < DW1_PRE; ++k) {
      const int e = threadIdx.x + k * C1_THREADS;
      if (e < DW1_HALO) {
        hb[e] = pre[k];
        if (e > 0) hb[DW1_HALO + e - 1] = pre[k];
      }
    }
    if (i + 1 < nb) dw1_load_halo(p, kb0 + i + 1, pre);
    cp_async_wait<DW1_STAGES - 2>();  // box i's dy has landed
    __syncthreads();
    if (i + DW1_STAGES - 1 < nb)
      dw1_load_dy(p, kb0 + i + DW1_STAGES - 1, co0,
                  ring + ((i + DW1_STAGES - 1) % DW1_STAGES) * DW1_VOX *
                             DW1_ROW);
    cp_async_commit();

    const uint16_t* st = ring + (i % DW1_STAGES) * DW1_VOX * DW1_ROW;
    const uint32_t* hw = reinterpret_cast<const uint32_t*>(hb);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      // K step: the 16 voxels of box row r = (z 8 + y), x = 0 .. 15
      const int r = warp + 8 * rr;
      const int rw = ((r >> 3) * DW1_HY + (r & 7)) * (DW1_HX / 2) + t;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // q: rows g / g + 8 (hh = q & 1), voxels 2t / 2t + 8 (q >> 1)
          const int hh = q & 1;
          const int wi = tcopy[mt][hh] * (DW1_HALO / 2) + rw +
                         tword[mt][hh] + (q >> 1) * 4;
          a[mt][q] = tok[mt][hh] ? hw[wi] : 0u;
        }
      uint32_t bm[2][4];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int mi = lane >> 3;
        const int v = r * 16 + (mi & 1) * 8 + (lane & 7);
        ldmatrix_x4_trans(bm[jp], st + v * DW1_ROW + (jp * 2 + (mi >> 1)) * 8);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma16816(acc[mt][j], a[mt], bm[j >> 1][(j & 1) * 2],
                   bm[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // the 8 warps' tiles, added in a fixed order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tap = mt * 16 + (i >> 1) * 8 + g, c = j * 8 + 2 * t + (i & 1);
        red[(warp * 32 + tap) * 32 + c] = acc[mt][j][i];
      }
  __syncthreads();
  for (int i = threadIdx.x; i < 27 * C1_NC; i += C1_THREADS) {
    const int tap = i / C1_NC, c = i % C1_NC;
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) tot += red[(w * 32 + tap) * 32 + c];
    if (co0 + c < p.Co)
      p.part[(static_cast<int64_t>(split) * 27 + tap) * p.Co + co0 + c] = tot;
  }
}

template <int MODE>
int launch_c1(const C1Params& p, int grid, cudaStream_t stream) {
  auto kern = conv3x3x3_c1_kernel<MODE>;
  const int smem = c1_smem(p.nchunks);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, C1_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of the forward: x (B, D, H, W, 1) bf16 and w (Co, 27) f32 ->
// y (B, D, H, W, Co) bf16; with ep_s / ep_t the eval epilogue, with
// partials one statistics row per block (not both). plan = {tiles x, y,
// z, tiles, a block's run, blocks}: conv_stack.c1_plan.
extern "C" int conv3x3x3_c1_bf16(const void* x, const void* w,
                                 const void* ep_s, const void* ep_t, void* y,
                                 int Co, void* partials, int B, int D, int H,
                                 int W, const int64_t* plan, void* stream) {
  if ((int64_t)B * D * H * W == 0) return 0;
  const int64_t nbx = plan[0], nby = plan[1], nbz = plan[2];
  const int64_t ntiles = plan[3], per = plan[4], nblocks = plan[5];
  if (Co < 2 || Co % 2 || Co > 8 * C1_NC || nbx * C1_BX < W ||
      nby * C1_BY < H || nbz * C1_BZ < D || ntiles != B * nbx * nby * nbz ||
      ntiles > INT32_MAX || per < 1 || nblocks < 1 ||
      nblocks * per < ntiles || (nblocks - 1) * per >= ntiles ||
      (ep_s != nullptr && partials != nullptr))
    return WG_ERR_PLAN;
  C1Params p;
  p.x = (const uint16_t*)x;
  p.w = (const float*)w;
  p.ep_s = (const float*)ep_s;
  p.ep_t = (const float*)ep_t;
  p.y = (uint8_t*)y;
  p.partials = (float*)partials;
  p.Co = Co;
  p.nchunks = (Co + C1_NC - 1) / C1_NC;
  p.D = D;
  p.H = H;
  p.W = W;
  p.nbx = (int)nbx;
  p.nby = (int)nby;
  p.nbz = (int)nbz;
  p.ntiles = (int)ntiles;
  p.per = (int)per;
  cudaStream_t st = (cudaStream_t)stream;
  if (ep_s != nullptr) return launch_c1<C1_EVAL>(p, (int)nblocks, st);
  if (partials != nullptr) return launch_c1<C1_STATS>(p, (int)nblocks, st);
  return launch_c1<C1_RAW>(p, (int)nblocks, st);
}

// One launch of the weight gradient: x (B, D, H, W, 1), dy (B, D, H, W,
// Co) bf16 -> part (nsplit, 27, Co) f32 partial sums, one row per split
// of K. plan = {boxes x, y, z, boxes, a split's run, splits}:
// conv_stack.c1_dw_plan.
extern "C" int conv3x3x3_c1_dw_bf16(const void* x, const void* dy, int Co,
                                    int B, int D, int H, int W,
                                    const int64_t* plan, void* part,
                                    void* stream) {
  if ((int64_t)B * D * H * W == 0) return 0;
  const int64_t nbx = plan[0], nby = plan[1], nbz = plan[2];
  const int64_t nboxes = plan[3], kboxes = plan[4], nsplit = plan[5];
  if (Co < 2 || Co % 2 || nbx * DW1_BX < W || nby * DW1_BY < H ||
      nbz * DW1_BZ < D || nboxes != B * nbx * nby * nbz ||
      nboxes > INT32_MAX || kboxes < 1 || nsplit < 1 || nsplit > 65535 ||
      nsplit * kboxes < nboxes || (nsplit - 1) * kboxes >= nboxes)
    return WG_ERR_PLAN;
  C1DwParams p;
  p.x = (const uint16_t*)x;
  p.dy = (const uint16_t*)dy;
  p.part = (float*)part;
  p.Co = Co;
  p.D = D;
  p.H = H;
  p.W = W;
  p.nbx = (int)nbx;
  p.nby = (int)nby;
  p.nbz = (int)nbz;
  p.nboxes = (int)nboxes;
  p.kboxes = (int)kboxes;
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3x3_c1_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DW1_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Co + C1_NC - 1) / C1_NC), (unsigned)nsplit);
  conv3x3x3_c1_dw_kernel<<<grid, C1_THREADS, DW1_SMEM, (cudaStream_t)stream>>>(
      p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the forward at Co output channels and of the
// weight gradient (kernel = 3), for chip_smoke.py's report.
extern "C" int conv3x3x3_c1_smem(int kernel, int Co) {
  return kernel == 3 ? DW1_SMEM : c1_smem((Co + C1_NC - 1) / C1_NC);
}

// Blocks of C1_THREADS resident on one SM: the forward in mode `kernel`
// (0 raw, 1 eval, 2 statistics) at Co output channels, or the weight
// gradient (kernel = 3); -1 on an error.
extern "C" int conv3x3x3_c1_occupancy(int kernel, int Co) {
  int n = -1;
  cudaError_t e;
  if (kernel == 3) {
    e = cudaFuncSetAttribute(conv3x3x3_c1_dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DW1_SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, conv3x3x3_c1_dw_kernel, C1_THREADS, DW1_SMEM);
  } else {
    const int smem = c1_smem((Co + C1_NC - 1) / C1_NC);
    e = kernel == 0   ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &n, conv3x3x3_c1_kernel<C1_RAW>, C1_THREADS, smem)
        : kernel == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &n, conv3x3x3_c1_kernel<C1_EVAL>, C1_THREADS, smem)
                      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &n, conv3x3x3_c1_kernel<C1_STATS>, C1_THREADS, smem);
  }
  return e == cudaSuccess ? n : -1;
}
