// 3x3x3 zero-padded stride-1 convolution over NDHWC bf16 volumes, in the
// modes the DC3D conv stack needs at eval and in training.
//
// Replaces: dram_tpu/core/pallas/fused_stack.py:conv_cm (kernel
// _cbr_kernel) in all of its uses: the eval chain of fused_cbr2 /
// _fused_fwd with the stack-exit affine+ReLU pass (fused_stack.py:580-582)
// folded in; the training forward (_fused_fwd :541-589: raw output with
// per-channel sum / sum-of-squares, and the BN affine+ReLU of the previous
// conv as a prologue on the staged input); and the input gradient of the
// backward (_vjp_bwd :637-689: the same conv on transposed, flipped
// weights, the output split into the two parts of a virtual concat).
//
// Bound on the H100: operations. The flagship stacks do ~0.92 TFLOP per
// 80^3 chunk against a few hundred MB of activations, far above the
// card's ~295 flop/byte balance point, so the floor is FLOPs / 989
// TFLOP/s (bf16 tensor cores).
//
// Design: implicit GEMM on the tensor cores through WMMA bf16 16x16x16
// fragments (f32 accumulation). One block owns a tile of 64 consecutive
// output voxels x 64 output channels; K = 27 taps x Ci runs as 27 tap
// steps x ceil(Ci/32) channel chunks. Per step the block stages the
// shifted input rows (64 x 32, zero outside the volume, which is the
// conv's zero padding) and the weight slice (32 x 64) in shared memory,
// then 4 warps each multiply a 32x32 sub-tile. The epilogue stages the
// f32 accumulator in shared memory.
//
// Modes, chosen by which optional pointers are non-null:
// - eval epilogue (ep_s, ep_t): y = relu(acc * ep_s + ep_t), rounded to
//   bf16 once. The TPU path instead rounds the raw conv output to bf16
//   before the next stack's prologue affine; the two differ by bf16
//   rounding of the pre-affine value (~2^-8 relative).
// - raw output (no ep_s): y = bf16(acc), the training forward and dx.
// - prologue (pro_s, pro_t): each staged input element inside the volume
//   becomes bf16(relu(x * pro_s[c] + pro_t[c])) in f32, as
//   _dw_kernel_pro :249-254 does; elements outside the volume stay zero
//   AFTER the prologue (relu(0 * s + t) is not 0; JAX masks after the
//   affine, :255-258), and so do channels past Ci.
// - stats (partials): each block reduces its 64 rows of the f32
//   accumulator per channel (sum and sum of squares, before any bf16
//   rounding, as the TPU epilogue does) and writes one partial row
//   partials[blockIdx.x][0|1][Co]; colsum_f32 reduces the rows in a
//   second pass. No atomics: the order of the sums is fixed, so the
//   statistics are the same from run to run.
// - split output (y2): output channels [0, Co1) go to y1 (Co1 channels a
//   voxel) and [Co1, Co1 + Co2) to y2, the transpose of a virtual concat,
//   so the two parts of dx are written where they belong with no
//   narrow/cat copy.
//
// The input arrives in two parts (x1: C1 channels, x2: C2 channels) that
// act as one [x1, x2] channel concat, the decoder's [upsample, skip], so
// the concat is never written to memory (the TPU kernel's "virtual
// concat"). Ci = C1 + C2 may be any size (Ci = 1 at the network entry):
// channels past Ci are zero in the staged tile, so no padded copy exists.
// 16-channel runs that lie inside one part load as two 128-bit loads;
// anything else loads per element.
//
// Shared memory is 5 KB + 4.5 KB + 17 KB + 1 KB, under the 48 KB static
// limit. Every __syncthreads() sits in loops whose trip counts are uniform
// over the block. Voxel indices are int64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "conv_staging.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;   // output voxels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // input channels per K step
constexpr int APAD = 8;  // row pads keep WMMA pointers 32-byte aligned
constexpr int BPAD = 8;
constexpr int CPAD = 4;

__device__ __forceinline__ void load16_weight(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ w, int tap, int c,
    int Ci, int n, int Co) {
  const int64_t base = ((int64_t)tap * Ci + c) * Co + n;
  if (c < Ci && n + 16 <= Co && (Co & 7) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(w + base);
    reinterpret_cast<uint4*>(dst)[0] = s[0];
    reinterpret_cast<uint4*>(dst)[1] = s[1];
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    dst[j] = (c < Ci && n + j < Co) ? w[base + j] : zero;
}

__global__ void __launch_bounds__(128)
    conv3x3x3_kernel(const __nv_bfloat16* __restrict__ x1, int C1,
                     const __nv_bfloat16* __restrict__ x2, int C2,
                     const float* __restrict__ pro_s,
                     const float* __restrict__ pro_t,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ ep_s,
                     const float* __restrict__ ep_t,
                     __nv_bfloat16* __restrict__ y1, int Co1,
                     __nv_bfloat16* __restrict__ y2, int Co2,
                     float* __restrict__ partials, int B, int D, int H,
                     int W) {
  __shared__ __align__(128) __nv_bfloat16 As[BM][BK + APAD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK][BN + BPAD];
  __shared__ __align__(128) float Cs[BM][BN + CPAD];
  __shared__ float red[2][2][BN];

  const int64_t V = (int64_t)B * D * H * W;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int Ci = C1 + C2;
  const int Co = Co1 + Co2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  // A staging: thread -> (row, 16-channel half) of the 64 x 32 tile
  const int arow = tid >> 1, akof = (tid & 1) * 16;
  const int64_t v = m0 + arow;
  const bool rowok = v < V;
  int vx = 0, vy = 0, vz = 0;
  int64_t vb = 0;
  if (rowok) {
    int64_t r = v;
    vx = (int)(r % W);
    r /= W;
    vy = (int)(r % H);
    r /= H;
    vz = (int)(r % D);
    vb = r / D;
  }
  // B staging: thread -> (row, 16-column quarter) of the 32 x 64 tile
  const int brow = tid >> 2, bcol = (tid & 3) * 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nkc = (Ci + BK - 1) / BK;
  for (int tap = 0; tap < 27; ++tap) {
    const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
    const int zz = vz + dz, yy = vy + dy, xx = vx + dx;
    const bool inb = rowok && zz >= 0 && zz < D && yy >= 0 && yy < H &&
                     xx >= 0 && xx < W;
    const int64_t nvox = inb ? ((vb * D + zz) * H + yy) * W + xx : 0;
    for (int kc = 0; kc < nkc; ++kc) {
      stage16_input(&As[arow][akof], x1, C1, x2, C2, nvox, kc * BK + akof,
                    inb, pro_s, pro_t);
      load16_weight(&Bs[brow][bcol], w, tap, kc * BK + brow, Ci, n0 + bcol,
                    Co);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &As[wm + i * 16][kk], BK + APAD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bf[j], &Bs[kk][wn + j * 16], BN + BPAD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + i * 16][wn + j * 16], acc[i][j],
                              BN + CPAD, wmma::mem_row_major);
  __syncthreads();

  if (partials != nullptr) {
    // per-channel sum / sum of squares of this block's valid rows:
    // thread -> (column, half of the rows); rows past V hold zeros
    const int col = tid & (BN - 1), half = tid >> 6;
    float s = 0.f, q = 0.f;
    for (int r = half * (BM / 2); r < (half + 1) * (BM / 2); ++r) {
      if (m0 + r < V) {
        const float a = Cs[r][col];
        s += a;
        q += a * a;
      }
    }
    red[half][0][col] = s;
    red[half][1][col] = q;
    __syncthreads();
    if (half == 0 && n0 + col < Co) {
      float* prow = partials + (int64_t)blockIdx.x * 2 * Co;
      prow[n0 + col] = red[0][0][col] + red[1][0][col];
      prow[Co + n0 + col] = red[0][1][col] + red[1][1][col];
    }
  }

  // epilogue: thread -> (row, 32-column half)
  const int orow = tid >> 1, ocol = (tid & 1) * 32;
  const int64_t ov = m0 + orow;
  if (ov < V) {
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const int n = n0 + ocol + j;
      if (n < Co) {
        float a = Cs[orow][ocol + j];
        if (ep_s != nullptr) a = fmaxf(a * ep_s[n] + ep_t[n], 0.f);
        if (n < Co1)
          y1[ov * Co1 + n] = __float2bfloat16(a);
        else
          y2[ov * Co2 + (n - Co1)] = __float2bfloat16(a);
      }
    }
  }
}

// dst[split][c] = sum of src[r][c] over the rows r of chunk `split`
// (rows split evenly over gridDim.y chunks). Block: 32 columns x 8 row
// phases; each thread sums its rows in order, then the 8 phases are added
// in a fixed order, so the result does not vary from run to run.
__global__ void __launch_bounds__(256)
    colsum_kernel(const float* __restrict__ src, int64_t nrows,
                  int64_t ncols, float* __restrict__ dst) {
  __shared__ float part[8][33];
  const int64_t c = (int64_t)blockIdx.x * 32 + threadIdx.x;
  const int64_t chunk = (nrows + gridDim.y - 1) / gridDim.y;
  const int64_t r0 = (int64_t)blockIdx.y * chunk;
  const int64_t r1 = r0 + chunk < nrows ? r0 + chunk : nrows;
  float s = 0.f;
  if (c < ncols)
    for (int64_t r = r0 + threadIdx.y; r < r1; r += 8) s += src[r * ncols + c];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < ncols) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += part[k][threadIdx.x];
    dst[(int64_t)blockIdx.y * ncols + c] = t;
  }
}

int launch_conv(const void* x1, int C1, const void* x2, int C2,
                const void* pro_s, const void* pro_t, const void* w,
                const void* ep_s, const void* ep_t, void* y1, int Co1,
                void* y2, int Co2, void* partials, int B, int D, int H, int W,
                void* stream) {
  const int64_t V = (int64_t)B * D * H * W;
  const int Co = Co1 + Co2;
  if (V == 0 || Co == 0) return 0;
  const dim3 grid((unsigned)((V + BM - 1) / BM),
                  (unsigned)((Co + BN - 1) / BN));
  conv3x3x3_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x1, C1, (const __nv_bfloat16*)x2, C2,
      (const float*)pro_s, (const float*)pro_t, (const __nv_bfloat16*)w,
      (const float*)ep_s, (const float*)ep_t, (__nv_bfloat16*)y1, Co1,
      (__nv_bfloat16*)y2, Co2, (float*)partials, B, D, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// eval mode: y = relu(conv([x1, x2], w) * scale + shift)
extern "C" int conv3x3x3_bf16(const void* x1, int C1, const void* x2, int C2,
                              const void* w, const void* scale,
                              const void* shift, void* y, int B, int D, int H,
                              int W, int Co, void* stream) {
  return launch_conv(x1, C1, x2, C2, nullptr, nullptr, w, scale, shift, y,
                     Co, nullptr, 0, nullptr, B, D, H, W, stream);
}

// training modes: raw output [y1 | y2] = conv(prologue([x1, x2]), w), with
// optional prologue (pro_s, pro_t), optional split output (y2, Co2) and
// optional per-block statistics rows (partials: ceil(V/64) x 2 x Co f32)
extern "C" int conv3x3x3_train_bf16(const void* x1, int C1, const void* x2,
                                    int C2, const void* w, const void* pro_s,
                                    const void* pro_t, void* y1, int Co1,
                                    void* y2, int Co2, void* partials, int B,
                                    int D, int H, int W, void* stream) {
  return launch_conv(x1, C1, x2, C2, pro_s, pro_t, w, nullptr, nullptr, y1,
                     Co1, y2, Co2, partials, B, D, H, W, stream);
}

// dst (nsplit x ncols) = per-chunk column sums of src (nrows x ncols)
extern "C" int colsum_f32(const void* src, int64_t nrows, int64_t ncols,
                          int nsplit, void* dst, void* stream) {
  if (ncols == 0 || nsplit == 0) return 0;
  const dim3 grid((unsigned)((ncols + 31) / 32), (unsigned)nsplit);
  colsum_kernel<<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(
      (const float*)src, nrows, ncols, (float*)dst);
  return (int)cudaGetLastError();
}
