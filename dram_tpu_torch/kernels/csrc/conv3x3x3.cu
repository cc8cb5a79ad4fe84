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
// weights, the output split into the two parts of a virtual concat). Also
// the raw conv of the unfused stack (dram_tpu/core/pallas/conv3d.py
// :_fwd_impl) and its dx.
//
// Bound on the H100: operations. The flagship stacks do ~0.92 TFLOP per
// 80^3 chunk against a few hundred MB of activations, far above the
// card's ~295 flop/byte balance point, so the floor is FLOPs / 989
// TFLOP/s (bf16 tensor cores).
//
// Design (conv3x3x3_wgmma_kernel): implicit GEMM with the voxels as M, the
// output channels as N and K = 27 taps x Ci, on wgmma with f32
// accumulators in registers, fed by TMA through mbarrier rings
// (conv_wgmma.cuh). A block owns a box of 8 x 8 x BZ output voxels (x, y,
// z; BZ = 2 SLABS, one 64-voxel z-plane per wgmma) of one batch element and
// BN output channels. For each 64-channel K chunk and each x-shift dx of
// the taps, one TMA load brings the halo box (8 x 10 x (BZ + 2) voxels,
// shifted by dx) into shared memory; the 9 taps (dz, dy) of that dx read
// 64-voxel sub-boxes of it (whole swizzle atoms, conv_wgmma.cuh), so each
// staged input row serves up to 9 taps instead of one. TMA's zero fill
// outside the tensor is the conv's zero padding: no bounds masks on loads.
// The weights come by TMA as (tap, 64-channel chunk) tiles of the K-major
// packed layout (27, Co, Ci). Two parts of a virtual concat are two tensor
// maps; chunk k of the K loop reads part 1 for k < ceil(C1/64), part 2
// after, and the weight tile of a chunk starts at the part's first channel
// in Ci. Warp roles: warpgroups 0-1 consume (SLABS z-planes x BN columns
// of accumulators each); in warpgroup 2 one thread issues the TMA loads
// (rings of 2-3 halo and 4 weight stages) and three warps apply the
// prologue to each halo tile as it lands, while the consumers multiply
// the previous one.
//
// Modes, chosen by which optional pointers are non-null:
// - eval epilogue (ep_s, ep_t): y = relu(acc * ep_s + ep_t), rounded to
//   bf16 once, from the registers. The TPU path instead rounds the raw conv
//   output to bf16 before the next stack's prologue affine; the two differ
//   by bf16 rounding of the pre-affine value (~2^-8 relative).
// - raw output (no ep_s): y = bf16(acc), the training forward and dx.
// - prologue (pro_s, pro_t): each staged input element inside the volume
//   becomes bf16(relu(x * pro_s[c] + pro_t[c])) in f32, as
//   _dw_kernel_pro :249-254 does; elements outside the volume stay zero
//   AFTER the prologue (relu(0 * s + t) is not 0; JAX masks after the
//   affine, :255-258), and so do channels past Ci (wg::prologue_halo).
// - stats (partials): each block reduces the f32 accumulator of its
//   in-volume voxels per channel (sum and sum of squares, before any bf16
//   rounding, as the TPU epilogue does) with warp shuffles, then over its 8
//   consumer warps in a fixed order, and writes one row
//   partials[m tile][0|1][Co]; colsum_f32 reduces the rows in a second
//   pass. No atomics: the statistics are the same from run to run.
// - split output (y2): output channels [0, Co1) go to y1 and [Co1, Co1 +
//   Co2) to y2, the transpose of a virtual concat, so the two parts of dx
//   are written where they belong with no narrow/cat copy.
// Outputs are written from the registers as bf16 pairs, masked to the
// voxels inside the volume (the box's ragged edge at W = 10, 20, ...).
//
// The kernel needs every input part's channel count to be a multiple of 8
// (TMA strides are multiples of 16 bytes) and even output parts;
// conv_stack.py zero-pads an input part that is not (the network-entry
// conv's one CT channel) to 8 channels, with zero weights.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_wgmma.cuh"

namespace {

// --- wgmma kernel ------------------------------------------------------------

constexpr int FWD_THREADS = 384;  // 2 consumer warpgroups + 1 producer
constexpr int FWD_NB = 4;         // weight stages
constexpr int FWD_TRANSFORM = 96; // prologue threads (warps 9-11)

template <int BN, int SLABS>
struct FwdCfg {
  static constexpr int BZ = 2 * SLABS;   // output z-planes of a tile
  static constexpr int HZ = BZ + 2;
  static constexpr int A_ROWS = HZ * wg::HALO_Y * wg::BOX_X;
  static constexpr int A_BYTES = A_ROWS * wg::ROW_BYTES;
  static constexpr int B_BYTES = BN * wg::ROW_BYTES;
  static constexpr int NA = BN <= 64 ? 3 : 2;  // halo stages that fit
  static constexpr int RED_FLOATS = 8 * 2 * BN;
  static constexpr int SMEM = 1024 + NA * A_BYTES + FWD_NB * B_BYTES +
                              RED_FLOATS * 4 + 8 * (3 * NA + 2 * FWD_NB);
};

struct FwdParams {
  int C1, C2;       // input parts' channels
  int nch1, nch;    // K chunks of part 1, of both parts
  int Co1, Co2;     // output parts' channels
  int D, H, W;
  int nbx, nby, nbz;  // tiles per batch element along x, y, z
  int mtiles, ntiles;
  const float* pro_s;
  const float* pro_t;
  const float* ep_s;
  const float* ep_t;
  __nv_bfloat16* y1;
  __nv_bfloat16* y2;
  float* partials;
};

// first voxel (b, z0, y0, x0) of M tile m
template <int BZ>
__device__ __forceinline__ void fwd_tile(const FwdParams& p, int m, int& b,
                                         int& z0, int& y0, int& x0) {
  x0 = (m % p.nbx) * wg::BOX_X;
  m /= p.nbx;
  y0 = (m % p.nby) * wg::BOX_Y;
  m /= p.nby;
  z0 = (m % p.nbz) * BZ;
  b = m / p.nbz;
}

// Persistent: block i takes tiles i, i + gridDim.x, ... (N tile fastest);
// the rings and their phases carry over from tile to tile, so the
// producer loads the next tile while the consumers run the epilogue.
template <int BN, int SLABS>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    conv3x3x3_wgmma_kernel(const __grid_constant__ CUtensorMap map_x1,
                           const __grid_constant__ CUtensorMap map_x2,
                           const __grid_constant__ CUtensorMap map_w,
                           const FwdParams p) {
  using Cfg = FwdCfg<BN, SLABS>;
  constexpr int NACC = BN / 2, NA = Cfg::NA;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* As = smem;
  uint8_t* Bs = As + NA * Cfg::A_BYTES;
  float* red = reinterpret_cast<float*>(Bs + FWD_NB * Cfg::B_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + Cfg::RED_FLOATS);
  uint64_t* a_full = bars;
  uint64_t* a_ready = bars + NA;
  uint64_t* a_empty = bars + 2 * NA;
  uint64_t* b_full = bars + 3 * NA;
  uint64_t* b_empty = b_full + FWD_NB;

  const int ntot = p.mtiles * p.ntiles;
  const bool pro = p.pro_s != nullptr;
  const int warpgroup = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NA; ++i) {
      wg::mbar_init(&a_full[i], 1);
      wg::mbar_init(&a_ready[i], FWD_TRANSFORM);
      wg::mbar_init(&a_empty[i], 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < FWD_NB; ++i) {
      wg::mbar_init(&b_full[i], 1);
      wg::mbar_init(&b_empty[i], 8);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warpgroup == 2) {
    wg::regs_dec<72>();
    if (threadIdx.x < 288) {
      if (threadIdx.x == 256) {
        // producer: the consumers' schedule, chunk -> dx -> 9 taps
        int sa = 0, sb = 0;
        uint32_t pa = 0, pb = 0;
        for (int tile = blockIdx.x; tile < ntot; tile += gridDim.x) {
          int b, z0, y0, x0;
          fwd_tile<Cfg::BZ>(p, tile / p.ntiles, b, z0, y0, x0);
          const int n0 = (tile % p.ntiles) * BN;
          for (int kc = 0; kc < p.nch; ++kc) {
            const bool second = kc >= p.nch1;
            const CUtensorMap* mx = second ? &map_x2 : &map_x1;
            const int cl = (second ? kc - p.nch1 : kc) * wg::CHUNK;
            const int cw = (second ? p.C1 : 0) + cl;
            for (int dxi = 0; dxi < 3; ++dxi) {
              wg::mbar_wait(&a_empty[sa], pa ^ 1);
              wg::mbar_expect_tx(&a_full[sa], Cfg::A_BYTES);
              wg::tma_load_5d(As + sa * Cfg::A_BYTES, mx, &a_full[sa], cl,
                              x0 + dxi - 1, y0 - 1, z0 - 1, b);
              if (++sa == NA) {
                sa = 0;
                pa ^= 1;
              }
              for (int t9 = 0; t9 < 9; ++t9) {
                const int tap = (t9 / 3) * 9 + (t9 % 3) * 3 + dxi;
                wg::mbar_wait(&b_empty[sb], pb ^ 1);
                wg::mbar_expect_tx(&b_full[sb], Cfg::B_BYTES);
                wg::tma_load_3d(Bs + sb * Cfg::B_BYTES, &map_w, &b_full[sb],
                                cw, n0, tap);
                if (++sb == FWD_NB) {
                  sb = 0;
                  pb ^= 1;
                }
              }
            }
          }
        }
      }
    } else if (pro) {
      // prologue on each halo tile as it lands
      const int tid = threadIdx.x - 288;
      int sa = 0;
      uint32_t pa = 0;
      for (int tile = blockIdx.x; tile < ntot; tile += gridDim.x) {
        int b, z0, y0, x0;
        fwd_tile<Cfg::BZ>(p, tile / p.ntiles, b, z0, y0, x0);
        for (int kc = 0; kc < p.nch; ++kc) {
          const bool second = kc >= p.nch1;
          const int cl = (second ? kc - p.nch1 : kc) * wg::CHUNK;
          const int cg = (second ? p.C1 : 0) + cl;
          const int cvalid = (second ? p.C2 : p.C1) - cl;
          float sc[8], sh[8];
          wg::prologue_coeffs(sc, sh, tid & 7, cvalid, p.pro_s + cg,
                              p.pro_t + cg);
          for (int dxi = 0; dxi < 3; ++dxi) {
            wg::mbar_wait(&a_full[sa], pa);
            wg::prologue_halo(As + sa * Cfg::A_BYTES, Cfg::A_ROWS, tid,
                              FWD_TRANSFORM, x0 + dxi - 1, y0 - 1, z0 - 1,
                              p.D, p.H, p.W, cvalid, sc, sh);
            wg::fence_async_smem();
            wg::mbar_arrive(&a_ready[sa]);
            if (++sa == NA) {
              sa = 0;
              pa ^= 1;
            }
          }
        }
      }
    }
  } else {
    wg::regs_inc<216>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int Co = p.Co1 + p.Co2;
    float acc[SLABS][NACC];
    uint64_t* a_wait = pro ? a_ready : a_full;
    const uint32_t a_base = wg::smem_u32(As), b_base = wg::smem_u32(Bs);
    int sa = 0, sb = 0;
    uint32_t pa = 0, pb = 0;
    for (int tile = blockIdx.x; tile < ntot; tile += gridDim.x) {
      const int m = tile / p.ntiles;
      int b, z0, y0, x0;
      fwd_tile<Cfg::BZ>(p, m, b, z0, y0, x0);
      const int n0 = (tile % p.ntiles) * BN;
      int prev_sb = -1, prev_sa = -1;
      for (int kc = 0; kc < p.nch; ++kc) {
        for (int dxi = 0; dxi < 3; ++dxi) {
          wg::mbar_wait(&a_wait[sa], pa);
          for (int t9 = 0; t9 < 9; ++t9) {
            const int dzi = t9 / 3, dyi = t9 % 3;
            // the tile's first product overwrites the accumulators
            const int keep = kc | dxi | t9;
            wg::mbar_wait(&b_full[sb], pb);
            wg::wgmma_fence();
            const uint64_t db = wg::sw128_desc(b_base + sb * Cfg::B_BYTES);
#pragma unroll
            for (int s = 0; s < SLABS; ++s) {
              // the tap's 64 rows: halo z-plane z + dz + 1, y-rows dy + 1..
              const int arow =
                  ((warpgroup * SLABS + s + dzi) * wg::HALO_Y + dyi) *
                  wg::BOX_X;
              const uint64_t da = wg::sw128_desc(
                  a_base + sa * Cfg::A_BYTES + arow * wg::ROW_BYTES);
              wg::wgmma<BN, 0, 0>(acc[s], da, db, keep);
#pragma unroll
              for (int kk = 1; kk < 4; ++kk)
                wg::wgmma<BN, 0, 0>(acc[s], da + 2 * kk, db + 2 * kk);
            }
            wg::wgmma_commit();
            wg::wgmma_wait<1>();
            // the previous step's wgmmas are done: release its stages
            if (prev_sb >= 0 && lane == 0) {
              wg::mbar_arrive(&b_empty[prev_sb]);
              if (prev_sa >= 0) wg::mbar_arrive(&a_empty[prev_sa]);
            }
            __syncwarp();
            prev_sb = sb;
            prev_sa = t9 == 8 ? sa : -1;
            if (++sb == FWD_NB) {
              sb = 0;
              pb ^= 1;
            }
          }
          if (++sa == NA) {
            sa = 0;
            pa ^= 1;
          }
        }
      }
      wg::wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < SLABS; ++s) wg::fence_regs(acc[s]);
      // release the last stages before the epilogue: the producer moves on
      if (lane == 0) {
        wg::mbar_arrive(&b_empty[prev_sb]);
        wg::mbar_arrive(&a_empty[prev_sa]);
      }
      __syncwarp();

      // this thread's rows: z-plane (warpgroup SLABS + s) of the tile,
      // y-row 2 warp + h, x = lane / 4; columns q 8 + 2 (lane % 4) + {0, 1}
      const int x = x0 + (lane >> 2);
      bool valid[SLABS][2];
      int64_t vox[SLABS][2];
#pragma unroll
      for (int s = 0; s < SLABS; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int y = y0 + 2 * warp + h, z = z0 + warpgroup * SLABS + s;
          valid[s][h] = x < p.W && y < p.H && z < p.D;
          vox[s][h] =
              ((static_cast<int64_t>(b) * p.D + z) * p.H + y) * p.W + x;
        }

      if (p.partials != nullptr) {
        const int wrow = (warpgroup * 4 + warp) * 2 * BN;
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
          float su[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
          for (int s = 0; s < SLABS; ++s)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float a =
                    valid[s][h] ? acc[s][q * 4 + h * 2 + e] : 0.f;
                su[e] += a;
                sq[e] += a * a;
              }
#pragma unroll
          for (int k = 4; k < 32; k <<= 1)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              su[e] += __shfl_xor_sync(0xffffffffu, su[e], k);
              sq[e] += __shfl_xor_sync(0xffffffffu, sq[e], k);
            }
          if (lane < 4)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              red[wrow + q * 8 + 2 * lane + e] = su[e];
              red[wrow + BN + q * 8 + 2 * lane + e] = sq[e];
            }
        }
        wg::named_sync(1, 256);
        for (int i = threadIdx.x; i < 2 * BN; i += 256) {
          const int k = i / BN, col = i % BN;
          float tot = 0.f;
#pragma unroll
          for (int w = 0; w < 8; ++w) tot += red[w * 2 * BN + k * BN + col];
          if (n0 + col < Co)
            p.partials[static_cast<int64_t>(m) * 2 * Co + k * Co + n0 +
                       col] = tot;
        }
        wg::named_sync(1, 256);  // red is free for the next tile
      }

#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const int n = n0 + q * 8 + 2 * (lane & 3);
        if (n >= Co) continue;
        float es0 = 1.f, es1 = 1.f, et0 = 0.f, et1 = 0.f;
        if (p.ep_s != nullptr) {
          es0 = p.ep_s[n];
          es1 = p.ep_s[n + 1];
          et0 = p.ep_t[n];
          et1 = p.ep_t[n + 1];
        }
#pragma unroll
        for (int s = 0; s < SLABS; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!valid[s][h]) continue;
            float a0 = acc[s][q * 4 + h * 2], a1 = acc[s][q * 4 + h * 2 + 1];
            if (p.ep_s != nullptr) {
              a0 = fmaxf(a0 * es0 + et0, 0.f);
              a1 = fmaxf(a1 * es1 + et1, 0.f);
            }
            __nv_bfloat16* dst =
                n < p.Co1 ? p.y1 + vox[s][h] * p.Co1 + n
                          : p.y2 + vox[s][h] * p.Co2 + (n - p.Co1);
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(a0, a1);
          }
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <int BN, int SLABS>
int launch_wgmma(const CUtensorMap& m1, const CUtensorMap& m2,
                 const CUtensorMap& mw, const FwdParams& p,
                 cudaStream_t stream) {
  auto kern = conv3x3x3_wgmma_kernel<BN, SLABS>;
  const int smem = FwdCfg<BN, SLABS>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int ntot = p.mtiles * p.ntiles;
  const int grid = ntot < sm_count() ? ntot : sm_count();
  kern<<<grid, FWD_THREADS, smem, stream>>>(m1, m2, mw, p);
  return (int)cudaGetLastError();
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

}  // namespace

// One launch of the wgmma kernel in any mode (see the top of the file):
// x1 (C1) and optional x2 (C2) NDHWC bf16; wk the K-major weights
// (27, Co1 + Co2, C1 + C2) bf16; optional pro_s/pro_t (prologue),
// ep_s/ep_t (eval epilogue), y2 (split output), partials (statistics rows,
// one per M tile). plan = {bn, slabs, tiles x, y, z, M tiles, N tiles}:
// conv_stack.conv_plan decides the geometry and the kernel runs it; the
// launcher refuses a plan it is not built for or that does not cover the
// output (a tile past the batch would write outside y1).
extern "C" int conv3x3x3_wgmma_bf16(const void* x1, int C1, const void* x2,
                                    int C2, const void* wk, const void* pro_s,
                                    const void* pro_t, const void* ep_s,
                                    const void* ep_t, void* y1, int Co1,
                                    void* y2, int Co2, void* partials, int B,
                                    int D, int H, int W, const int64_t* plan,
                                    void* stream) {
  const int Co = Co1 + Co2, Ci = C1 + C2;
  if ((int64_t)B * D * H * W == 0 || Co == 0) return 0;
  const int bn = (int)plan[0], slabs = (int)plan[1];
  const int nbx = (int)plan[2], nby = (int)plan[3], nbz = (int)plan[4];
  if ((int64_t)nbx * wg::BOX_X < W || (int64_t)nby * wg::BOX_Y < H ||
      (int64_t)nbz * 2 * slabs < D ||
      plan[5] != (int64_t)B * nbx * nby * nbz || plan[6] * bn < Co ||
      C1 % 8 || C2 % 8 || Co1 % 2 || Co2 % 2)
    return WG_ERR_PLAN;
  const int64_t dx1[5] = {C1, W, H, D, B}, dx2[5] = {C2 ? C2 : C1, W, H, D, B};
  const int64_t dw[3] = {Ci, Co, 27};
  const int abox[5] = {wg::CHUNK, wg::BOX_X, wg::HALO_Y, 2 * slabs + 2, 1};
  const int wbox[3] = {wg::CHUNK, bn, 1};
  CUtensorMap m1, m2, mw;
  int e = wg_map(&m1, x1, 5, dx1, abox);
  if (!e) e = wg_map(&m2, C2 ? x2 : x1, 5, dx2, abox);
  if (!e) e = wg_map(&mw, wk, 3, dw, wbox);
  if (e) return e;
  FwdParams p;
  p.C1 = C1;
  p.C2 = C2;
  p.nch1 = (C1 + wg::CHUNK - 1) / wg::CHUNK;
  p.nch = p.nch1 + (C2 + wg::CHUNK - 1) / wg::CHUNK;
  p.Co1 = Co1;
  p.Co2 = Co2;
  p.D = D;
  p.H = H;
  p.W = W;
  p.nbx = nbx;
  p.nby = nby;
  p.nbz = nbz;
  p.mtiles = (int)plan[5];
  p.ntiles = (int)plan[6];
  p.pro_s = (const float*)pro_s;
  p.pro_t = (const float*)pro_t;
  p.ep_s = (const float*)ep_s;
  p.ep_t = (const float*)ep_t;
  p.y1 = (__nv_bfloat16*)y1;
  p.y2 = (__nv_bfloat16*)y2;
  p.partials = (float*)partials;
  cudaStream_t st = (cudaStream_t)stream;
  if (bn == 32 && slabs == 2) return launch_wgmma<32, 2>(m1, m2, mw, p, st);
  if (bn == 64 && slabs == 2) return launch_wgmma<64, 2>(m1, m2, mw, p, st);
  if (bn == 128 && slabs == 2)
    return launch_wgmma<128, 2>(m1, m2, mw, p, st);
  if (bn == 256 && slabs == 1)
    return launch_wgmma<256, 1>(m1, m2, mw, p, st);
  return WG_ERR_PLAN;
}

// Dynamic shared memory of the wgmma kernel built for (bn, slabs), 0 for a
// configuration it is not built for (for chip_smoke.py's report).
extern "C" int conv3x3x3_wgmma_smem(int bn, int slabs) {
  if (bn == 32 && slabs == 2) return FwdCfg<32, 2>::SMEM;
  if (bn == 64 && slabs == 2) return FwdCfg<64, 2>::SMEM;
  if (bn == 128 && slabs == 2) return FwdCfg<128, 2>::SMEM;
  if (bn == 256 && slabs == 1) return FwdCfg<256, 1>::SMEM;
  return 0;
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
