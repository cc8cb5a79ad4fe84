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
// stack input (two parts for the decoder's [upsample, skip]); and the dW
// of the unfused stack's raw conv (dram_tpu/core/pallas/conv3d.py
// :_vjp_bwd, kernel _dw_kernel), with no prologue.
//
// Bound on the H100: operations. dW is a GEMM of (27 Ci) x Co with a
// reduction depth K = B*D*H*W (5.12 M voxels at 10 x 80^3): 2 * 27 * Ci *
// Co * K flops over (Ci + Co) * K bf16 bytes, e.g. 3.4 TFLOP over 2 GB
// for [128 | 64] -> 64, far above the ~295 flop/byte balance point, so
// the floor is FLOPs / 989 TFLOP/s.
//
// Design (conv3x3x3_dw_wgmma_kernel): a GEMM with the voxels as K on
// wgmma, f32 accumulators in registers, fed by TMA through an mbarrier
// ring (conv_wgmma.cuh). A block owns one x-shift dx of the taps, one
// 64-channel chunk of Ci, 64 output channels and a contiguous run of K
// boxes (8 x 8 x 2 voxels of one batch element); K is split over blocks
// to fill the 132 SMs. Per box one TMA load brings dy (128 voxels x 64
// channels) and one the halo of xp shifted by dx (8 x 10 x 4 voxels x 64
// channels); the 9 taps (dz, dy) of the block read 128-voxel sub-boxes of
// the halo, whole swizzle atoms, so both operands are MN-major (channels
// contiguous, voxels along K). dy is zero outside the volume (TMA's zero
// fill), so those voxels add nothing; xp's zero fill is the padding.
// Warp roles: warpgroups 0-2 consume, one per dz (3 taps x 64 x 64
// accumulators each); in warpgroup 3 one thread issues the loads (a ring
// of 3 stages) and three warps apply the prologue to each halo as it
// lands. Each block writes its f32 partial tile (9 taps x 64 x 64) to
// part[split]; colsum_f32 (conv3x3x3.cu) adds the splits in a second
// launch, in a fixed order, with no atomics, so the result does not vary
// from run to run.
//
// Every channel count must be a multiple of 8 (TMA strides are multiples
// of 16 bytes); conv_stack.py zero-pads an input that is not (the
// network-entry conv's one CT channel) to 8 channels and drops their rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_wgmma.cuh"

namespace {

// --- wgmma kernel ------------------------------------------------------------

constexpr int DW_THREADS = 512;  // 3 consumer warpgroups + 1 producer
constexpr int DW_NS = 3;         // stages
constexpr int DW_TRANSFORM = 96; // prologue threads (warps 13-15)
constexpr int DW_BZ = 2;         // z extent of a K box
constexpr int DW_A_ROWS = (DW_BZ + 2) * wg::HALO_Y * wg::BOX_X;
constexpr int DW_A_BYTES = DW_A_ROWS * wg::ROW_BYTES;
constexpr int DW_D_ROWS = DW_BZ * wg::BOX_Y * wg::BOX_X;
constexpr int DW_STAGE = DW_A_BYTES + DW_D_ROWS * wg::ROW_BYTES;
constexpr int DW_SMEM = 1024 + DW_NS * DW_STAGE + 8 * 3 * DW_NS;

struct DwParams {
  int C1, C2, nch1, Co;
  int D, H, W;
  int nbx, nby, nbz;
  int64_t nboxes, kboxes;  // K boxes in all, per split
  const float* pro_s;
  const float* pro_t;
  float* part;
};

__global__ void __launch_bounds__(DW_THREADS, 1)
    conv3x3x3_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_x1,
                              const __grid_constant__ CUtensorMap map_x2,
                              const __grid_constant__ CUtensorMap map_dy,
                              const DwParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + DW_NS * DW_STAGE);
  uint64_t* full = bars;
  uint64_t* ready = bars + DW_NS;
  uint64_t* empty = bars + 2 * DW_NS;

  const int kc = blockIdx.x / 3, dxi = blockIdx.x % 3;
  const bool second = kc >= p.nch1;
  const int cl = (second ? kc - p.nch1 : kc) * wg::CHUNK;
  const int cg = (second ? p.C1 : 0) + cl;  // first channel in Ci
  const int cvalid = (second ? p.C2 : p.C1) - cl;
  const int n0 = blockIdx.y * 64;
  const int64_t kb0 = blockIdx.z * p.kboxes;
  const int64_t kb1 = kb0 + p.kboxes < p.nboxes ? kb0 + p.kboxes : p.nboxes;
  const bool pro = p.pro_s != nullptr;
  const int warpgroup = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int i = 0; i < DW_NS; ++i) {
      wg::mbar_init(&full[i], 1);
      wg::mbar_init(&ready[i], DW_TRANSFORM);
      wg::mbar_init(&empty[i], 12);  // one arrival per consumer warp
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warpgroup == 3) {
    wg::regs_dec<72>();
    if (threadIdx.x == 384) {
      const CUtensorMap* mx = second ? &map_x2 : &map_x1;
      int s = 0;
      uint32_t ph = 0;
      for (int64_t kb = kb0; kb < kb1; ++kb) {
        int64_t r = kb;
        const int tx = (int)(r % p.nbx);
        r /= p.nbx;
        const int ty = (int)(r % p.nby);
        r /= p.nby;
        const int tz = (int)(r % p.nbz);
        const int b = (int)(r / p.nbz);
        const int x0 = tx * wg::BOX_X, y0 = ty * wg::BOX_Y, z0 = tz * DW_BZ;
        uint8_t* st = smem + s * DW_STAGE;
        wg::mbar_wait(&empty[s], ph ^ 1);
        wg::mbar_expect_tx(&full[s], DW_STAGE);
        wg::tma_load_5d(st, mx, &full[s], cl, x0 + dxi - 1, y0 - 1, z0 - 1,
                        b);
        wg::tma_load_5d(st + DW_A_BYTES, &map_dy, &full[s], n0, x0, y0, z0,
                        b);
        if (++s == DW_NS) {
          s = 0;
          ph ^= 1;
        }
      }
    } else if (threadIdx.x >= 416 && pro) {
      const int tid = threadIdx.x - 416;
      float sc[8], sh[8];
      wg::prologue_coeffs(sc, sh, tid & 7, cvalid, p.pro_s + cg,
                          p.pro_t + cg);
      int s = 0;
      uint32_t ph = 0;
      for (int64_t kb = kb0; kb < kb1; ++kb) {
        int64_t r = kb;
        const int tx = (int)(r % p.nbx);
        r /= p.nbx;
        const int ty = (int)(r % p.nby);
        r /= p.nby;
        const int tz = (int)(r % p.nbz);
        wg::mbar_wait(&full[s], ph);
        wg::prologue_halo(smem + s * DW_STAGE, DW_A_ROWS, tid, DW_TRANSFORM,
                          tx * wg::BOX_X + dxi - 1, ty * wg::BOX_Y - 1,
                          tz * DW_BZ - 1, p.D, p.H, p.W, cvalid, sc, sh);
        wg::fence_async_smem();
        wg::mbar_arrive(&ready[s]);
        if (++s == DW_NS) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    wg::regs_inc<144>();
    const int dzi = warpgroup;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    float acc[3][32];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[d][i] = 0.f;
    uint64_t* wait_on = pro ? ready : full;
    const uint32_t base = wg::smem_u32(smem);
    int s = 0, prev = -1;
    uint32_t ph = 0;
    for (int64_t kb = kb0; kb < kb1; ++kb) {
      wg::mbar_wait(&wait_on[s], ph);
      wg::wgmma_fence();
      const uint32_t a_st = base + s * DW_STAGE;
      const uint32_t d_st = a_st + DW_A_BYTES;
#pragma unroll
      for (int dyi = 0; dyi < 3; ++dyi)
#pragma unroll
        for (int ks = 0; ks < DW_D_ROWS / 16; ++ks) {
          // K step ks: voxel rows 2 (ks % 4) .. + 1 of z-plane ks / 4;
          // the tap (dz, dy) reads the halo rows shifted by (dz+1, dy+1)
          const int zl = ks >> 2, yp = (ks & 3) * 2;
          const int arow = ((zl + dzi) * wg::HALO_Y + yp + dyi) * wg::BOX_X;
          wg::wgmma<64, 1, 1>(
              acc[dyi], wg::sw128_desc(a_st + arow * wg::ROW_BYTES),
              wg::sw128_desc(d_st + ks * 16 * wg::ROW_BYTES));
        }
      wg::wgmma_commit();
      wg::wgmma_wait<1>();
      if (prev >= 0 && lane == 0) wg::mbar_arrive(&empty[prev]);
      __syncwarp();
      prev = s;
      if (++s == DW_NS) {
        s = 0;
        ph ^= 1;
      }
    }
    wg::wgmma_wait<0>();
#pragma unroll
    for (int d = 0; d < 3; ++d) wg::fence_regs(acc[d]);

    // rows: channel warp 16 + lane / 4 + 8 h of the chunk; columns
    // n0 + q 8 + 2 (lane % 4) + {0, 1}
    const int Ci = p.C1 + p.C2;
    const int64_t M = 27LL * Ci;
#pragma unroll
    for (int dyi = 0; dyi < 3; ++dyi) {
      const int tap = dzi * 9 + dyi * 3 + dxi;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = warp * 16 + (lane >> 2) + 8 * h;
        if (ci >= cvalid) continue;
        float* row = p.part +
                     (static_cast<int64_t>(blockIdx.z) * M + tap * Ci + cg +
                      ci) * p.Co;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int n = n0 + q * 8 + 2 * (lane & 3);
          if (n < p.Co)
            *reinterpret_cast<float2*>(row + n) =
                make_float2(acc[dyi][q * 4 + h * 2], acc[dyi][q * 4 + h * 2 + 1]);
        }
      }
    }
  }
}

}  // namespace

// One launch of the wgmma kernel: part (nsplit x 27 (C1 + C2) x Co f32)
// gets one partial dW per split of K. plan = {tiles x, y, z, K boxes,
// boxes per split, splits}: conv_stack.dw_plan decides the geometry and
// the kernel runs it; the launcher refuses a plan that does not cover the
// batch's voxels once (a box past the batch would read outside dy, a
// split past the plan's would write outside part). Every channel count
// must be a multiple of 8.
extern "C" int conv3x3x3_dw_wgmma_bf16(const void* x1, int C1, const void* x2,
                                       int C2, const void* pro_s,
                                       const void* pro_t, const void* dy,
                                       int Co, int B, int D, int H, int W,
                                       const int64_t* plan, void* part,
                                       void* stream) {
  if ((int64_t)B * D * H * W == 0 || C1 + C2 == 0 || Co == 0) return 0;
  const int nbx = (int)plan[0], nby = (int)plan[1], nbz = (int)plan[2];
  const int64_t nboxes = plan[3], kboxes = plan[4], nsplit = plan[5];
  const int nch1 = (C1 + wg::CHUNK - 1) / wg::CHUNK;
  const int nch = nch1 + (C2 + wg::CHUNK - 1) / wg::CHUNK;
  if ((int64_t)nbx * wg::BOX_X < W || (int64_t)nby * wg::BOX_Y < H ||
      (int64_t)nbz * DW_BZ < D || nboxes != (int64_t)B * nbx * nby * nbz ||
      kboxes < 1 || nsplit != (nboxes + kboxes - 1) / kboxes || C1 % 8 ||
      C2 % 8 || Co % 8)
    return WG_ERR_PLAN;
  const int64_t dx1[5] = {C1, W, H, D, B}, dx2[5] = {C2 ? C2 : C1, W, H, D, B};
  const int64_t ddy[5] = {Co, W, H, D, B};
  const int abox[5] = {wg::CHUNK, wg::BOX_X, wg::HALO_Y, DW_BZ + 2, 1};
  const int dbox[5] = {wg::CHUNK, wg::BOX_X, wg::BOX_Y, DW_BZ, 1};
  CUtensorMap m1, m2, md;
  int e = wg_map(&m1, x1, 5, dx1, abox);
  if (!e) e = wg_map(&m2, C2 ? x2 : x1, 5, dx2, abox);
  if (!e) e = wg_map(&md, dy, 5, ddy, dbox);
  if (e) return e;
  DwParams p;
  p.C1 = C1;
  p.C2 = C2;
  p.nch1 = nch1;
  p.Co = Co;
  p.D = D;
  p.H = H;
  p.W = W;
  p.nbx = nbx;
  p.nby = nby;
  p.nbz = nbz;
  p.nboxes = nboxes;
  p.kboxes = kboxes;
  p.pro_s = (const float*)pro_s;
  p.pro_t = (const float*)pro_t;
  p.part = (float*)part;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3x3_dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  conv3x3x3_dw_wgmma_kernel<<<dim3((unsigned)(3 * nch),
                                   (unsigned)((Co + 63) / 64),
                                   (unsigned)nsplit),
                              DW_THREADS, DW_SMEM, (cudaStream_t)stream>>>(
      m1, m2, md, p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the wgmma kernel (for chip_smoke.py's report).
extern "C" int conv3x3x3_dw_wgmma_smem(void) { return DW_SMEM; }
