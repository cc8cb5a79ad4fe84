// Weight gradient of the 3x3x3 zero-padded stride-1 convolution over
// NDHWC bf16 volumes: dW[tap, ci, co] = sum over every voxel v of the batch
// of xp[v + off(tap), ci] * dy[v, co], where xp is the (two-part) input,
// optionally through the BatchNorm affine + ReLU prologue, and zero
// outside the volume.
//
// Replaces: dram_tpu/core/pallas/fused_stack.py:conv_dw_cm (kernel
// _dw_kernel_pro), which the fused stack's backward (_vjp_bwd :637-689)
// calls for both convs: for conv_1 with the prologue recomputing the
// normalized activation from the raw conv_0 output, for conv_0 on the
// stack input (two parts for the decoder's [upsample, skip]).
//
// Bound on the H100: operations. dW is a GEMM of (27 Ci) x Co with a
// reduction depth K = B*D*H*W (5.12 M voxels at 10 x 80^3): 2 * 27 * Ci *
// Co * K flops over (Ci + Co) * K bf16 bytes, e.g. 3.4 TFLOP over 2 GB
// for [128 | 64] -> 64, far above the ~295 flop/byte balance point, so
// the floor is FLOPs / 989 TFLOP/s.
//
// Design: the GEMM's M = 27 Ci rows (tap-major, channel-minor) are cut
// into 64-row tiles and N = Co into 64-column tiles; with few tiles and a
// deep K, a block per tile that loops over all of K would leave most of
// the 132 SMs idle, so K is split into gridDim.z chunks. Each block
// streams its chunk 32 voxels at a time: it stages xp (32 voxels x 64 M
// rows, k-major) and dy (32 voxels x 64 channels) in shared memory and
// 4 warps multiply with WMMA bf16 16x16x16 fragments into f32
// accumulators (A is read column-major from the k-major tile). Each block
// writes its f32 partial tile to part[chunk]; colsum_f32 (conv3x3x3.cu)
// adds the chunks in a second launch, in a fixed order, with no atomics,
// so the result does not vary from run to run. A 16-row group of M that
// lies inside one tap (Ci % 16 == 0) stages as 128-bit loads of 16
// channels of one shifted voxel; otherwise (Ci = 1 at the network entry)
// each element is staged alone, so no padded copy of the input exists.
//
// Shared memory is 4.5 KB + 4.5 KB + 17 KB, under the 48 KB static limit.
// Every __syncthreads() sits in loops whose trip counts are uniform over
// the block. Voxel indices are int64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "conv_staging.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;  // M rows (tap, ci) per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 32;  // voxels per K step
constexpr int PAD = 8;  // row pad keeps WMMA pointers 32-byte aligned
constexpr int CPAD = 4;

__global__ void __launch_bounds__(128)
    conv3x3x3_dw_kernel(const __nv_bfloat16* __restrict__ x1, int C1,
                        const __nv_bfloat16* __restrict__ x2, int C2,
                        const float* __restrict__ pro_s,
                        const float* __restrict__ pro_t,
                        const __nv_bfloat16* __restrict__ dy, int Co, int B,
                        int D, int H, int W, int64_t kchunk,
                        float* __restrict__ part) {
  __shared__ __align__(128) __nv_bfloat16 As[BK][BM + PAD];  // [k][m]
  __shared__ __align__(128) __nv_bfloat16 Bs[BK][BN + PAD];  // [k][n]
  __shared__ __align__(128) float Cs[BM][BN + CPAD];

  const int64_t V = (int64_t)B * D * H * W;
  const int Ci = C1 + C2;
  const int M = 27 * Ci;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int64_t kbeg = (int64_t)blockIdx.z * kchunk;
  const int64_t kend = kbeg + kchunk < V ? kbeg + kchunk : V;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  // staging: thread -> (voxel row of the step, 16-wide group of M / N)
  const int krow = tid >> 2, grp = (tid & 3) * 16;
  // a 16-row group inside one tap: its tap and first channel
  const bool vec = (Ci & 15) == 0;
  const int gm = m0 + grp;
  const int gtap = gm / Ci, gci = gm % Ci;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int64_t k0 = kbeg; k0 < kend; k0 += BK) {
    const int64_t v = k0 + krow;
    const bool vok = v < kend;
    int vx = 0, vy = 0, vz = 0;
    int64_t vb = 0;
    if (vok) {
      int64_t r = v;
      vx = (int)(r % W);
      r /= W;
      vy = (int)(r % H);
      r /= H;
      vz = (int)(r % D);
      vb = r / D;
    }
    // A: xp[v + off(tap), ci] for the 16 M rows of this thread's group
    if (vec) {
      const int zz = vz + gtap / 9 - 1, yy = vy + (gtap / 3) % 3 - 1,
                xx = vx + gtap % 3 - 1;
      const bool inb = vok && gm < M && zz >= 0 && zz < D && yy >= 0 &&
                       yy < H && xx >= 0 && xx < W;
      const int64_t nvox = inb ? ((vb * D + zz) * H + yy) * W + xx : 0;
      stage16_input(&As[krow][grp], x1, C1, x2, C2, nvox, gci, inb, pro_s,
                    pro_t);
    } else {
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const int m = gm + j;
        __nv_bfloat16 val = zero;
        if (vok && m < M) {
          const int tap = m / Ci, c = m % Ci;
          const int zz = vz + tap / 9 - 1, yy = vy + (tap / 3) % 3 - 1,
                    xx = vx + tap % 3 - 1;
          if (zz >= 0 && zz < D && yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const int64_t nvox = ((vb * D + zz) * H + yy) * W + xx;
            val = input_elem(x1, C1, x2, C2, nvox, c);
            if (pro_s != nullptr)
              val = __float2bfloat16(
                  fmaxf(__bfloat162float(val) * pro_s[c] + pro_t[c], 0.f));
          }
        }
        As[krow][grp + j] = val;
      }
    }
    // B: dy[v, n0 + grp .. + 16]
    {
      const int n = n0 + grp;
      __nv_bfloat16* dst = &Bs[krow][grp];
      if (vok && n + 16 <= Co && (Co & 7) == 0) {
        const uint4* s = reinterpret_cast<const uint4*>(dy + v * Co + n);
        reinterpret_cast<uint4*>(dst)[0] = s[0];
        reinterpret_cast<uint4*>(dst)[1] = s[1];
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = (vok && n + j < Co) ? dy[v * Co + n + j] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[kk][wm + i * 16], BM + PAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[kk][wn + j * 16], BN + PAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + i * 16][wn + j * 16], acc[i][j],
                              BN + CPAD, wmma::mem_row_major);
  __syncthreads();

  // partial tile -> part[chunk][m][n]: thread -> (row, 32-column half)
  const int orow = tid >> 1, ocol = (tid & 1) * 32;
  const int m = m0 + orow;
  if (m < M) {
    float* prow = part + ((int64_t)blockIdx.z * M + m) * Co;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const int n = n0 + ocol + j;
      if (n < Co) prow[n] = Cs[orow][ocol + j];
    }
  }
}

}  // namespace

// part: nsplit x (27 * (C1 + C2)) x Co f32 partial sums, one slab per
// K chunk of kchunk voxels (nsplit = ceil(B*D*H*W / kchunk)); kchunk is a
// multiple of 32
extern "C" int conv3x3x3_dw_bf16(const void* x1, int C1, const void* x2,
                                 int C2, const void* pro_s, const void* pro_t,
                                 const void* dy, int Co, int B, int D, int H,
                                 int W, int64_t kchunk, int nsplit,
                                 void* part, void* stream) {
  const int M = 27 * (C1 + C2);
  if (M == 0 || Co == 0 || nsplit == 0) return 0;
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  (unsigned)((Co + BN - 1) / BN), (unsigned)nsplit);
  conv3x3x3_dw_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x1, C1, (const __nv_bfloat16*)x2, C2,
      (const float*)pro_s, (const float*)pro_t, (const __nv_bfloat16*)dy, Co,
      B, D, H, W, kchunk, (float*)part);
  return (int)cudaGetLastError();
}
