// Hopper building blocks shared by the 3x3x3 conv (conv3x3x3.cu) and its
// weight gradient (conv3x3x3_dw.cu): inline PTX for mbarriers, TMA tensor
// loads, wgmma (bf16 in, f32 accumulators in registers) and the fences
// between them, the halo tile geometry both kernels load, the BatchNorm
// prologue applied to a staged halo tile in shared memory, and the host
// side that encodes the tensor maps.
//
// Tile layout. TMA copies a box of a 5-D NDHWC bf16 tensor (dims, innermost
// first: C, W, H, D, B) with a 64-channel inner extent, so every voxel is
// one 128-byte row of shared memory, voxels in x-fastest order, under the
// 128-byte swizzle (the 16-byte chunk c of row r sits at chunk c ^ (r % 8)
// of a 1024-byte aligned tile). An 8-row group of such rows is one swizzle
// atom, which is what a wgmma descriptor addresses: with the box's x extent
// BOX_X = 8, one atom is one x-row of 8 voxels, and an atom shifted by
// whole y- or z-rows stays aligned. That is why a halo tile can serve
// several taps: the rows a tap reads are whole atoms of it.
// - K-major operand (conv: A = voxels x 64 channels, B = output channels x
//   64 input channels): 8-row groups 1024 bytes apart (SBO); the k16 step
//   inside the 128-byte row advances the start address by 32 bytes.
// - MN-major operand (weight gradient: A = channels x voxels, B = voxels x
//   output channels, K = voxels): the 64 M or N values of a row are
//   contiguous, a k16 step spans two atoms 1024 bytes apart (SBO); with an
//   M or N extent of 64 the leading offset is not used.
//
// Out-of-bounds box elements, negative coordinates included, are filled
// with zeros by TMA: that is the conv's zero padding, and channels past a
// part's count read as zeros too.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace wg {

constexpr int BOX_X = 8;   // voxels of a tile along x: one swizzle atom
constexpr int BOX_Y = 8;   // along y
constexpr int HALO_Y = BOX_Y + 2;
constexpr int CHUNK = 64;  // channels per K chunk: one 128-byte row
constexpr int ROW_BYTES = CHUNK * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarrier ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive and announce `bytes` of TMA transactions for the current phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
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

// --- TMA -----------------------------------------------------------------

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma / TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- warpgroup control ---------------------------------------------------

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// barrier over the first `n` threads of the block (id 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// --- wgmma ---------------------------------------------------------------

// descriptor of a 128-byte-swizzled operand whose 8-row groups are 1024
// bytes apart (SBO = 64 x 16 B); LBO = 1 (unused for these extents)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) | (static_cast<uint64_t>(64) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads of accumulators across a wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x N, f32) = A(64 x 16) * B(16 x N) + (acc ? D : 0), bf16 operands
// in shared memory; TA / TB = 1 for an MN-major A / B
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db, int acc = 1) {
  if constexpr (N == 32) wgmma_m64n32<TA, TB>(d, da, db, acc);
  else if constexpr (N == 64) wgmma_m64n64<TA, TB>(d, da, db, acc);
  else if constexpr (N == 128) wgmma_m64n128<TA, TB>(d, da, db, acc);
  else wgmma_m64n256<TA, TB>(d, da, db, acc);
}

// --- prologue on a staged halo tile --------------------------------------

// The scale and shift of the 8-channel group g (0..7) of a 64-channel chunk
// whose first `cvalid` channels exist; zeros past them.
__device__ __forceinline__ void prologue_coeffs(
    float (&sc)[8], float (&sh)[8], int g, int cvalid,
    const float* __restrict__ s, const float* __restrict__ t) {
  const bool cok = g * 8 < cvalid;  // part channel counts are multiples of 8
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = cok ? s[g * 8 + j] : 0.f;
    sh[j] = cok ? t[g * 8 + j] : 0.f;
  }
}

// In place on a halo tile of `rows` voxel rows (x-fastest, BOX_X x HALO_Y
// per z-plane, its first voxel at (gx0, gy0, gz0)) of one 64-channel chunk:
// every channel c < cvalid of a voxel inside the D x H x W volume becomes
// bf16(relu(x * s[c] + t[c])) in f32; every other element becomes zero,
// since relu(0 * s + t) is not 0 and the padding must stay zero after the
// prologue. Run by `nthreads` threads (a multiple of 8),
// `tid` in [0, nthreads): a thread keeps the 8-channel group tid % 8, whose
// coefficients (prologue_coeffs) it holds in registers, and works on four
// rows at a time so that their shared-memory loads overlap.
__device__ __forceinline__ void prologue_halo(
    uint8_t* tile, int rows, int tid, int nthreads, int gx0, int gy0,
    int gz0, int D, int H, int W, int cvalid, const float (&sc)[8],
    const float (&sh)[8]) {
  constexpr int NROW = 4;
  const int g = tid & 7, step = nthreads >> 3;
  const bool cok = g * 8 < cvalid;
  for (int r0 = tid >> 3; r0 < rows; r0 += NROW * step) {
    uint4 v[NROW];
    bool ok[NROW];
#pragma unroll
    for (int k = 0; k < NROW; ++k) {
      const int r = r0 + k * step;
      const int hx = r % BOX_X, hy = (r / BOX_X) % HALO_Y,
                hz = r / (BOX_X * HALO_Y);
      const int x = gx0 + hx, y = gy0 + hy, z = gz0 + hz;
      ok[k] = cok && r < rows && x >= 0 && x < W && y >= 0 && y < H &&
              z >= 0 && z < D;
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[k])
        v[k] = *reinterpret_cast<const uint4*>(tile + r * ROW_BYTES +
                                               ((g ^ (r & 7)) << 4));
    }
#pragma unroll
    for (int k = 0; k < NROW; ++k) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v[k]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        h[j] = __floats2bfloat162_rn(
            fmaxf(f.x * sc[2 * j] + sh[2 * j], 0.f),
            fmaxf(f.y * sc[2 * j + 1] + sh[2 * j + 1], 0.f));
      }
      if (!ok[k]) v[k] = make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < NROW; ++k) {
      const int r = r0 + k * step;
      if (r < rows)
        *reinterpret_cast<uint4*>(tile + r * ROW_BYTES +
                                  ((g ^ (r & 7)) << 4)) = v[k];
    }
  }
}

}  // namespace wg

// --- host: tensor maps ---------------------------------------------------

typedef CUresult (*wg_encode_fn)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library the process already has
// loaded (no link against libcuda)
static inline wg_encode_fn wg_encoder() {
  static wg_encode_fn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib == nullptr) lib = dlopen("libcuda.so", RTLD_NOW | RTLD_LOCAL);
    if (lib != nullptr)
      fn = reinterpret_cast<wg_encode_fn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// launcher errors besides cudaError_t values
constexpr int WG_ERR_PLAN = -1;     // a plan this build cannot run
constexpr int WG_ERR_DRIVER = -2;   // no cuTensorMapEncodeTiled
constexpr int WG_ERR_ENCODE = -100; // minus the CUresult of the encode

// bf16 tensor map of a dense tensor with dims[0] innermost, 128-byte
// swizzle, zero fill out of bounds; 0 or a WG_ERR_* code
static inline int wg_map(CUtensorMap* map, const void* ptr, int rank,
                         const int64_t* dims, const int* box) {
  wg_encode_fn enc = wg_encoder();
  if (enc == nullptr) return WG_ERR_DRIVER;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    bdim[i] = static_cast<cuuint32_t>(box[i]);
    estride[i] = 1;
    stride *= static_cast<uint64_t>(dims[i]);
    if (i + 1 < rank) gstride[i] = stride;
  }
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         static_cast<cuuint32_t>(rank), const_cast<void*>(ptr),
                         gdim, gstride, bdim, estride,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : WG_ERR_ENCODE - static_cast<int>(r);
}
