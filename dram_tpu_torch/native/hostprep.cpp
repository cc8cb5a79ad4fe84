// Native host-prep kernels: ITK-semantics iso resampling + wire packing.
//
// The Python data layer (dram_tpu/data/hostprep.py) calls these through
// ctypes for the prep->device hot path; the NumPy implementations remain
// as the portable fallback and the parity oracle (tests compare both).
//
// Semantics mirror core/resample.py: output voxel centers map to input
// continuous index src = i_out * scale per axis; linear interpolation with
// fill outside [-0.5, size-0.5); nearest = round-half-up. OpenMP over the
// output z axis.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <type_traits>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

// AVX-512 fast paths (the deploy host is a 1-core AVX-512 Xeon): the
// scalar code below each #else remains the portable reference; the SIMD
// variants are bit-identical — same f32 expression trees, and
// _mm512_cvtps_epi32 uses the same round-to-nearest-even as lrintf /
// nearbyintf in the default rounding mode.
#if defined(__AVX512F__) && defined(__AVX512BW__)
#define HP_AVX512 1
#include <immintrin.h>
#endif

namespace {

struct AxisTable {
    std::vector<int32_t> lo, hi;
    std::vector<float> frac;   // weight of hi
    std::vector<uint8_t> valid;
};

AxisTable make_axis(int in_size, int out_size, double scale, bool nearest,
                    int out_off = 0) {
    AxisTable t;
    t.lo.resize(out_size);
    t.hi.resize(out_size);
    t.frac.resize(out_size);
    t.valid.resize(out_size);
    for (int i = 0; i < out_size; ++i) {
        double src = (double)(i + out_off) * scale;
        // ITK IsInsideBuffer: [-0.5, size-0.5), end exclusive
        bool valid = (src >= -0.5) && (src < in_size - 0.5);
        t.valid[i] = valid ? 1 : 0;
        if (nearest) {
            int idx = (int)std::floor(src + 0.5);
            if (idx < 0) idx = 0;
            if (idx > in_size - 1) idx = in_size - 1;
            t.lo[i] = idx;
            t.hi[i] = idx;
            t.frac[i] = 0.f;
        } else {
            double s = src < 0 ? 0 : (src > in_size - 1 ? in_size - 1 : src);
            int lo = (int)std::floor(s);
            int hi = lo + 1 > in_size - 1 ? in_size - 1 : lo + 1;
            t.lo[i] = lo;
            t.hi[i] = hi;
            t.frac[i] = (float)(s - lo);
        }
    }
    return t;
}

// x-lerp one input row to oW floats — the only gathering loop of the
// plane-cache resample; everything downstream is contiguous and
// auto-vectorizes. Values match the naive 8-tap math bit-exactly: int16
// source values are exactly representable in f32, so computing the x
// lerp once and reusing it produces the identical f32 expression tree.
template <typename T>
inline void xlerp_row(const T* src, const AxisTable& tx, int oW,
                      float* out) {
    const int32_t* lo = tx.lo.data();
    const int32_t* hi = tx.hi.data();
    const float* fr = tx.frac.data();
    for (int x = 0; x < oW; ++x) {
        const float a = (float)src[lo[x]];
        out[x] = a + fr[x] * ((float)src[hi[x]] - a);
    }
}

#ifdef HP_AVX512
// Shuffle-gather plan for the i16 x-lerp: per 32-output block, both lerp
// taps are pulled from a 64-word source window with one vpermi2w each —
// eligible whenever the block's source span fits 64 words (always true
// for downsample factors < ~2; ineligible blocks fall back to scalar).
// Built once per resample call from the x axis table; load masks keep
// the window reads inside the row.
struct XPlan16 {
    int nb = 0;
    std::vector<int32_t> base;
    std::vector<uint16_t> idx;   // nb*64: 32 lo offsets then 32 hi offsets
    std::vector<float> frac;     // nb*32, tail lanes duplicated
    std::vector<uint8_t> ok;
    std::vector<uint32_t> m0, m1, sm;  // load masks, store mask
};

inline XPlan16 make_xplan16(const AxisTable& tx, int W, int oW) {
    XPlan16 p;
    p.nb = (oW + 31) / 32;
    p.base.resize(p.nb);
    p.idx.resize((size_t)p.nb * 64);
    p.frac.resize((size_t)p.nb * 32);
    p.ok.resize(p.nb);
    p.m0.resize(p.nb);
    p.m1.resize(p.nb);
    p.sm.resize(p.nb);
    for (int b = 0; b < p.nb; ++b) {
        const int x0 = b * 32;
        const int xe = oW < x0 + 32 ? oW : x0 + 32;
        const int32_t base = tx.lo[x0];
        bool ok = true;
        for (int x = x0; x < xe; ++x)
            if (tx.lo[x] < base || tx.hi[x] - base > 63) { ok = false; break; }
        p.base[b] = base;
        p.ok[b] = ok ? 1 : 0;
        uint16_t* ip = p.idx.data() + (size_t)b * 64;
        float* fp = p.frac.data() + (size_t)b * 32;
        for (int k = 0; k < 32; ++k) {
            const int x = x0 + k < xe ? x0 + k : xe - 1;  // dup tail lanes
            ip[k] = ok ? (uint16_t)(tx.lo[x] - base) : 0;
            ip[32 + k] = ok ? (uint16_t)(tx.hi[x] - base) : 0;
            fp[k] = tx.frac[x];
        }
        const int64_t rem0 = (int64_t)W - base;
        const int64_t rem1 = rem0 - 32;
        p.m0[b] = rem0 >= 32 ? 0xFFFFFFFFu
                             : (rem0 <= 0 ? 0u : ((1u << rem0) - 1u));
        p.m1[b] = rem1 >= 32 ? 0xFFFFFFFFu
                             : (rem1 <= 0 ? 0u : ((1u << rem1) - 1u));
        const int lanes = xe - x0;
        p.sm[b] = lanes >= 32 ? 0xFFFFFFFFu : ((1u << lanes) - 1u);
    }
    return p;
}

inline void xlerp_row_avx(const int16_t* src, const AxisTable& tx,
                          const XPlan16& p, int oW, float* out) {
    for (int b = 0; b < p.nb; ++b) {
        const int x0 = b * 32;
        if (!p.ok[b]) {
            const int xe = oW < x0 + 32 ? oW : x0 + 32;
            for (int x = x0; x < xe; ++x) {
                const float a = (float)src[tx.lo[x]];
                out[x] = a + tx.frac[x] * ((float)src[tx.hi[x]] - a);
            }
            continue;
        }
        const int16_t* s = src + p.base[b];
        const __m512i t0 = _mm512_maskz_loadu_epi16((__mmask32)p.m0[b], s);
        const __m512i t1 =
            _mm512_maskz_loadu_epi16((__mmask32)p.m1[b], s + 32);
        const uint16_t* ip = p.idx.data() + (size_t)b * 64;
        const __m512i a16 = _mm512_permutex2var_epi16(
            t0, _mm512_loadu_si512((const void*)ip), t1);
        const __m512i b16 = _mm512_permutex2var_epi16(
            t0, _mm512_loadu_si512((const void*)(ip + 32)), t1);
        const __m512 a0 = _mm512_cvtepi32_ps(
            _mm512_cvtepi16_epi32(_mm512_castsi512_si256(a16)));
        const __m512 a1 = _mm512_cvtepi32_ps(
            _mm512_cvtepi16_epi32(_mm512_extracti64x4_epi64(a16, 1)));
        const __m512 b0 = _mm512_cvtepi32_ps(
            _mm512_cvtepi16_epi32(_mm512_castsi512_si256(b16)));
        const __m512 b1 = _mm512_cvtepi32_ps(
            _mm512_cvtepi16_epi32(_mm512_extracti64x4_epi64(b16, 1)));
        const float* fp = p.frac.data() + (size_t)b * 32;
        const __m512 f0 = _mm512_loadu_ps(fp);
        const __m512 f1 = _mm512_loadu_ps(fp + 16);
        // a + f*(b-a), explicit mul+add (no fma) — matches the NumPy twin
        const __m512 r0 =
            _mm512_add_ps(a0, _mm512_mul_ps(f0, _mm512_sub_ps(b0, a0)));
        const __m512 r1 =
            _mm512_add_ps(a1, _mm512_mul_ps(f1, _mm512_sub_ps(b1, a1)));
        const uint32_t sm = p.sm[b];
        _mm512_mask_storeu_ps(out + x0, (__mmask16)(sm & 0xFFFFu), r0);
        _mm512_mask_storeu_ps(out + x0 + 16, (__mmask16)(sm >> 16), r1);
    }
}
#endif  // HP_AVX512

#if defined(__AVX512VBMI__)
// Byte shuffle-gather plan for nearest u8 rows: per 64-output block one
// vpermi2b pulls from a 128-byte source window (eligible for downsample
// factors < ~2; scalar fallback otherwise). Invalid lanes are masked out
// of the store, so rows are pre-zeroed by the caller.
#define HP_VBMI 1
struct BPlan8 {
    int nb = 0;
    std::vector<int32_t> base;
    std::vector<uint8_t> idx;  // nb*64 byte offsets
    std::vector<uint8_t> ok;
    std::vector<uint64_t> m0, m1, sm;
};

inline BPlan8 make_bplan8(const AxisTable& tx, int W, int oW) {
    BPlan8 p;
    p.nb = (oW + 63) / 64;
    p.base.resize(p.nb);
    p.idx.resize((size_t)p.nb * 64);
    p.ok.resize(p.nb);
    p.m0.resize(p.nb);
    p.m1.resize(p.nb);
    p.sm.resize(p.nb);
    int xa = 0, xb = oW;
    while (xa < oW && !tx.valid[xa]) ++xa;
    while (xb > xa && !tx.valid[xb - 1]) --xb;
    for (int b = 0; b < p.nb; ++b) {
        const int x0 = b * 64;
        const int xe = oW < x0 + 64 ? oW : x0 + 64;
        const int32_t base = tx.lo[x0];
        bool ok = true;
        for (int x = x0; x < xe; ++x)
            if (tx.lo[x] < base || tx.lo[x] - base > 127) {
                ok = false;
                break;
            }
        p.base[b] = base;
        p.ok[b] = ok ? 1 : 0;
        uint8_t* ip = p.idx.data() + (size_t)b * 64;
        for (int k = 0; k < 64; ++k) {
            const int x = x0 + k < xe ? x0 + k : xe - 1;
            ip[k] = ok ? (uint8_t)(tx.lo[x] - base) : 0;
        }
        const int64_t rem0 = (int64_t)W - base;
        const int64_t rem1 = rem0 - 64;
        p.m0[b] = rem0 >= 64 ? ~0ull
                             : (rem0 <= 0 ? 0ull : ((1ull << rem0) - 1ull));
        p.m1[b] = rem1 >= 64 ? ~0ull
                             : (rem1 <= 0 ? 0ull : ((1ull << rem1) - 1ull));
        uint64_t sm = xe - x0 >= 64 ? ~0ull : ((1ull << (xe - x0)) - 1ull);
        // clear lanes outside the valid span (stores skip them; the row
        // was zero-filled, matching the scalar 0-for-invalid semantics)
        for (int k = 0; k < 64; ++k) {
            const int x = x0 + k;
            if (x >= oW || x < xa || x >= xb) sm &= ~(1ull << k);
        }
        p.sm[b] = sm;
    }
    return p;
}

inline void nearest_row_vbmi(const uint8_t* row, const AxisTable& tx,
                             const BPlan8& p, int oW, uint8_t* op) {
    for (int b = 0; b < p.nb; ++b) {
        const int x0 = b * 64;
        if (!p.ok[b]) {
            const int xe = oW < x0 + 64 ? oW : x0 + 64;
            for (int x = x0; x < xe; ++x)
                op[x] = tx.valid[x] ? row[tx.lo[x]] : 0;
            continue;
        }
        const uint8_t* s = row + p.base[b];
        const __m512i t0 = _mm512_maskz_loadu_epi8((__mmask64)p.m0[b], s);
        const __m512i t1 =
            _mm512_maskz_loadu_epi8((__mmask64)p.m1[b], s + 64);
        const __m512i idx = _mm512_loadu_si512(
            (const void*)(p.idx.data() + (size_t)b * 64));
        const __m512i r = _mm512_permutex2var_epi8(t0, idx, t1);
        _mm512_mask_storeu_epi8(op + x0, (__mmask64)p.sm[b], r);
    }
}
#endif  // __AVX512VBMI__

// Dispatch: int16 rows take the shuffle-gather path when a plan exists.
template <typename T>
inline void do_xlerp(const T* src, const AxisTable& tx, int oW, float* out,
                     const void*) {
    xlerp_row(src, tx, oW, out);
}

#ifdef HP_AVX512
inline void do_xlerp(const int16_t* src, const AxisTable& tx, int oW,
                     float* out, const XPlan16* xp) {
    if (xp)
        xlerp_row_avx(src, tx, *xp, oW, out);
    else
        xlerp_row(src, tx, oW, out);
}
#endif

// xy-lerped plane of input z index zi. A 2-slot x-lerped row cache
// exploits the monotone y source indices so each input row is x-lerped
// once per plane.
template <typename T, typename XP>
void build_plane(const T* in, int64_t HW, int W, int zi,
                 const AxisTable& ty, const AxisTable& tx,
                 int oH, int oW, float* P, float* rowa, float* rowb,
                 const XP* xp) {
    const T* plane = in + (int64_t)zi * HW;
    int ia = -1, ib = -1;
    auto ensure = [&](int yi) -> const float* {
        if (yi == ia) return rowa;
        if (yi == ib) return rowb;
        if (ia < ib) {  // evict the older (smaller) index
            do_xlerp(plane + (int64_t)yi * W, tx, oW, rowa, xp);
            ia = yi;
            return rowa;
        }
        do_xlerp(plane + (int64_t)yi * W, tx, oW, rowb, xp);
        ib = yi;
        return rowb;
    };
    for (int y = 0; y < oH; ++y) {
        const float fy = ty.frac[y];
        const float* r0 = ensure(ty.lo[y]);
        const float* r1 = ensure(ty.hi[y]);
        float* op = P + (int64_t)y * oW;
        for (int x = 0; x < oW; ++x)
            op[x] = r0[x] + fy * (r1[x] - r0[x]);
    }
}

// Shared trilinear resample: plane-cached separable evaluation, serial z
// (the deploy host has one core; the z-plane cache depends on in-order
// traversal). ROUND selects int16 rounding vs raw float stores. EPI is a
// per-output-row epilogue (row pointer + flat row index) run while the
// row is still cache-hot — the w8+hist wire fuses there.
template <typename T, bool ROUND, typename EPI>
void resample_linear_impl(const T* in, int D, int H, int W,
                          double sz, double sy, double sx,
                          int offz, int offy, int offx,
                          int oD, int oH, int oW, double fill, T* out,
                          EPI epi) {
    AxisTable tz = make_axis(D, oD, sz, false, offz);
    AxisTable ty = make_axis(H, oH, sy, false, offy);
    AxisTable tx = make_axis(W, oW, sx, false, offx);
    const int64_t HW = (int64_t)H * W;
    const int64_t oHW = (int64_t)oH * oW;
    const T tfill = (T)fill;

    // contiguous valid spans (src coords are monotone in the index)
    int ya = 0, yb = oH, xa = 0, xb = oW;
    while (ya < oH && !ty.valid[ya]) ++ya;
    while (yb > ya && !ty.valid[yb - 1]) --yb;
    while (xa < oW && !tx.valid[xa]) ++xa;
    while (xb > xa && !tx.valid[xb - 1]) --xb;

    std::vector<float> P0((size_t)oHW), P1((size_t)oHW);
    std::vector<float> rowa(oW), rowb(oW);
    int c0 = -1, c1 = -1;

#ifdef HP_AVX512
    XPlan16 xplan_store;
    const XPlan16* xp = nullptr;
    if (std::is_same<T, int16_t>::value) {
        xplan_store = make_xplan16(tx, W, oW);
        xp = &xplan_store;
    }
#else
    const void* xp = nullptr;
#endif

    for (int z = 0; z < oD; ++z) {
        T* orow = out + (int64_t)z * oHW;
        if (!tz.valid[z]) {
            for (int y = 0; y < oH; ++y) {
                T* op = orow + (int64_t)y * oW;
                for (int x = 0; x < oW; ++x) op[x] = tfill;
                epi(op, (int64_t)z * oH + y);
            }
            continue;
        }
        const int z0 = tz.lo[z], z1 = tz.hi[z];
        const float fz = tz.frac[z];
        if (c0 != z0) {
            if (c1 == z0) {
                std::swap(P0, P1);
                std::swap(c0, c1);
            } else {
                build_plane(in, HW, W, z0, ty, tx, oH, oW, P0.data(),
                            rowa.data(), rowb.data(), xp);
                c0 = z0;
            }
        }
        const float* A = P0.data();
        const float* B;
        if (z1 == z0) {
            B = A;
        } else {
            if (c1 != z1) {
                build_plane(in, HW, W, z1, ty, tx, oH, oW, P1.data(),
                            rowa.data(), rowb.data(), xp);
                c1 = z1;
            }
            B = P1.data();
        }
        for (int y = 0; y < oH; ++y) {
            T* op = orow + (int64_t)y * oW;
            if (y < ya || y >= yb) {
                for (int x = 0; x < oW; ++x) op[x] = tfill;
                epi(op, (int64_t)z * oH + y);
                continue;
            }
            for (int x = 0; x < xa; ++x) op[x] = tfill;
            const float* a = A + (int64_t)y * oW;
            const float* b = B + (int64_t)y * oW;
            if (ROUND) {
                int x = xa;
#ifdef HP_AVX512
                // cvtps2dq rounds to nearest-even — identical to lrintf;
                // the saturating i32->i16 pack is exact because a lerp of
                // int16 endpoints stays inside the int16 range
                if (std::is_same<T, int16_t>::value) {
                    const __m512 fzv = _mm512_set1_ps(fz);
                    int16_t* opi = (int16_t*)op;
                    for (; x + 16 <= xb; x += 16) {
                        const __m512 av = _mm512_loadu_ps(a + x);
                        const __m512 bv = _mm512_loadu_ps(b + x);
                        const __m512 v = _mm512_add_ps(
                            av, _mm512_mul_ps(fzv, _mm512_sub_ps(bv, av)));
                        _mm256_storeu_si256(
                            (__m256i*)(opi + x),
                            _mm512_cvtsepi32_epi16(_mm512_cvtps_epi32(v)));
                    }
                }
#endif
                for (; x < xb; ++x) {
                    const float av = a[x];
                    op[x] = (T)std::lrintf(av + fz * (b[x] - av));
                }
            } else {
                for (int x = xa; x < xb; ++x)
                    op[x] = (T)(a[x] + fz * (b[x] - a[x]));
            }
            for (int x = xb; x < oW; ++x) op[x] = tfill;
            epi(op, (int64_t)z * oH + y);
        }
    }
}

struct NoEpi {
    template <typename T>
    void operator()(const T*, int64_t) const {}
};

}  // namespace

extern "C" {

// Trilinear resample int16 -> int16 (rounded), fill for outside points.
void resample_iso_linear_i16(const int16_t* in, int D, int H, int W,
                             double sz, double sy, double sx,
                             int oD, int oH, int oW,
                             double fill, int16_t* out) {
    resample_linear_impl<int16_t, true>(in, D, H, W, sz, sy, sx, 0, 0, 0,
                                        oD, oH, oW, fill, out, NoEpi());
}

// Window variant: emits only the output block starting at (offz, offy,
// offx) of the virtual full output grid — the prep path resamples the
// scan only inside the lung crop.
void resample_window_linear_i16(const int16_t* in, int D, int H, int W,
                                double sz, double sy, double sx,
                                int offz, int offy, int offx,
                                int oD, int oH, int oW,
                                double fill, int16_t* out) {
    resample_linear_impl<int16_t, true>(in, D, H, W, sz, sy, sx,
                                        offz, offy, offx,
                                        oD, oH, oW, fill, out, NoEpi());
}

// Trilinear resample float32 -> float32 (windowed images in the host
// transform pipeline), fill for outside points.
void resample_iso_linear_f32(const float* in, int D, int H, int W,
                             double sz, double sy, double sx,
                             int oD, int oH, int oW,
                             double fill, float* out) {
    resample_linear_impl<float, false>(in, D, H, W, sz, sy, sx, 0, 0, 0,
                                       oD, oH, oW, fill, out, NoEpi());
}

void window8_hist_i16(const int16_t* scan, const uint8_t* lobe, int64_t n,
                      double w_lo, double w_hi, uint8_t* u8_out,
                      int64_t* hist256);  // defined below

// Fused window-resample + u8 windowing + lung-masked histogram: one pass
// emits the cropped iso scan (i16), its windowed-u8 twin and the 256-bin
// Otsu histogram, replacing a separate full re-read of the crop
// (window8_hist). Outputs are bit-identical to the two-pass sequence:
// the u8 LUT is indexed by the already-rounded i16 value.
void resample_window_w8hist_i16(const int16_t* in, int D, int H, int W,
                                double sz, double sy, double sx,
                                int offz, int offy, int offx,
                                int oD, int oH, int oW,
                                double fill, double w_lo, double w_hi,
                                const uint8_t* lobe_c, int16_t* out,
                                uint8_t* u8_out, int64_t* hist256) {
    const float inv = (float)(255.0 / (w_hi - w_lo));
    const float flo = (float)w_lo, fhi = (float)w_hi;
    std::vector<uint8_t> lut(65536);
    for (int v16 = -32768; v16 < 32768; ++v16) {
        float v = (float)v16;
        if (v < flo) v = flo;
        if (v > fhi) v = fhi;
        lut[(uint16_t)(int16_t)v16] =
            (uint8_t)std::nearbyintf((v - flo) * inv);
    }
    std::memset(hist256, 0, 256 * sizeof(int64_t));
    std::vector<int64_t> subhist(4 * 256, 0);
    int64_t* const hsub = subhist.data();
    const uint8_t* lutp = lut.data();
    auto epi = [=](const int16_t* row, int64_t ri) {
        int64_t* const hist256 = hsub;  // 4 interleaved sub-histograms
        uint8_t* u8row = u8_out + ri * oW;
        const uint8_t* lrow = lobe_c + ri * oW;
#ifdef HP_AVX512
        // SIMD twin of the LUT math: clamp((float)v16) then
        // rint((v-flo)*inv) — the identical f32 expression per value
        const __m512 vlo = _mm512_set1_ps(flo);
        const __m512 vhi = _mm512_set1_ps(fhi);
        const __m512 vinv = _mm512_set1_ps(inv);
        int x = 0;
        for (; x + 16 <= oW; x += 16) {
            const __m512i i32 = _mm512_cvtepi16_epi32(
                _mm256_loadu_si256((const __m256i*)(row + x)));
            __m512 v = _mm512_cvtepi32_ps(i32);
            v = _mm512_min_ps(_mm512_max_ps(v, vlo), vhi);
            v = _mm512_mul_ps(_mm512_sub_ps(v, vlo), vinv);
            _mm_storeu_si128(
                (__m128i*)(u8row + x),
                _mm512_cvtusepi32_epi8(_mm512_cvtps_epi32(v)));
        }
        for (; x < oW; ++x) u8row[x] = lutp[(uint16_t)row[x]];
        // histogram only counts lung voxels: compress the lung-masked u8
        // values into a compact buffer, then bin with 4 interleaved
        // sub-histograms (hist256 has 4*256 slots; caller merges)
#if defined(__AVX512VBMI2__)
        uint8_t cbuf[512];
        int nc = 0;
        int q = 0;
        const __m512i zero = _mm512_setzero_si512();
        for (; q + 64 <= oW; q += 64) {
            const __mmask64 m = _mm512_cmpneq_epi8_mask(
                _mm512_loadu_si512((const void*)(lrow + q)), zero);
            _mm512_mask_compressstoreu_epi8(
                cbuf + nc, m,
                _mm512_loadu_si512((const void*)(u8row + q)));
            nc += (int)_mm_popcnt_u64((uint64_t)m);
            if (nc > (int)sizeof(cbuf) - 64) {
                int k = 0;
                for (; k + 4 <= nc; k += 4) {
                    hist256[cbuf[k]] += 1;
                    hist256[256 + cbuf[k + 1]] += 1;
                    hist256[512 + cbuf[k + 2]] += 1;
                    hist256[768 + cbuf[k + 3]] += 1;
                }
                for (; k < nc; ++k) hist256[cbuf[k]] += 1;
                nc = 0;
            }
        }
        for (; q < oW; ++q)
            if (lrow[q]) cbuf[nc++] = u8row[q];
        {
            int k = 0;
            for (; k + 4 <= nc; k += 4) {
                hist256[cbuf[k]] += 1;
                hist256[256 + cbuf[k + 1]] += 1;
                hist256[512 + cbuf[k + 2]] += 1;
                hist256[768 + cbuf[k + 3]] += 1;
            }
            for (; k < nc; ++k) hist256[cbuf[k]] += 1;
        }
#else
        uint64_t any = 0;
        int q = 0;
        for (; q + 8 <= oW; q += 8) {
            uint64_t w;
            std::memcpy(&w, lrow + q, 8);
            any |= w;
        }
        for (; q < oW; ++q) any |= lrow[q];
        if (any)
            for (int k = 0; k < oW; ++k)
                hist256[u8row[k]] += (int64_t)(lrow[k] > 0);
#endif
#else
        for (int x = 0; x < oW; ++x) {
            const uint8_t u = lutp[(uint16_t)row[x]];
            u8row[x] = u;
            hist256[u] += (int64_t)(lrow[x] > 0);
        }
#endif
    };
    resample_linear_impl<int16_t, true>(in, D, H, W, sz, sy, sx,
                                        offz, offy, offx,
                                        oD, oH, oW, fill, out, epi);
    for (int u = 0; u < 256; ++u)
        hist256[u] = hsub[u] + hsub[256 + u] + hsub[512 + u] +
                     hsub[768 + u];
}

// Per-label bbox over the nearest-sampled iso subgrid WITHOUT
// materializing the resampled volume: bbox(subgrid) == bbox of
// resample_iso_nearest_u8's output by construction (same axis tables).
void subgrid_bboxes_u8(const uint8_t* lobe, int D, int H, int W,
                       double sz, double sy, double sx,
                       int oD, int oH, int oW,
                       int n_labels, int32_t* mins, int32_t* maxs) {
    AxisTable tz = make_axis(D, oD, sz, true);
    AxisTable ty = make_axis(H, oH, sy, true);
    AxisTable tx = make_axis(W, oW, sx, true);
    for (int l = 0; l < n_labels; ++l)
        for (int ax = 0; ax < 3; ++ax) {
            mins[l * 3 + ax] = INT32_MAX;
            maxs[l * 3 + ax] = -1;
        }
    const int64_t HW = (int64_t)H * W;
    // valid indices form contiguous spans (monotone source coords)
    int xa = 0, xb = oW;
    while (xa < oW && !tx.valid[xa]) ++xa;
    while (xb > xa && !tx.valid[xb - 1]) --xb;
    if (xa >= xb) return;
#ifdef HP_VBMI
    // shuffle-gather the sampled row, then per-label cmpeq bitmasks give
    // presence + first/last sampled x without the scalar gather loop
    const BPlan8 bp = make_bplan8(tx, W, oW);
    std::vector<uint8_t> buf(((size_t)oW + 63) & ~63ull, 0);
    const int nb = bp.nb;
    for (int z = 0; z < oD; ++z) {
        if (!tz.valid[z]) continue;
        const uint8_t* plane = lobe + (int64_t)tz.lo[z] * HW;
        for (int y = 0; y < oH; ++y) {
            if (!ty.valid[y]) continue;
            const uint8_t* row = plane + (int64_t)ty.lo[y] * W;
            nearest_row_vbmi(row, tx, bp, oW, buf.data());
            for (int l = 0; l < n_labels; ++l) {
                const __m512i lab = _mm512_set1_epi8((char)(l + 1));
                int firstb = -1, lastb = -1;
                uint64_t firstm = 0, lastm = 0;
                for (int b = 0; b < nb; ++b) {
                    const uint64_t m = _mm512_cmpeq_epi8_mask(
                        _mm512_loadu_si512(
                            (const void*)(buf.data() + (size_t)b * 64)),
                        lab);
                    if (!m) continue;
                    if (firstb < 0) { firstb = b; firstm = m; }
                    lastb = b;
                    lastm = m;
                }
                if (firstb < 0) continue;
                int32_t* mn = mins + l * 3;
                int32_t* mx = maxs + l * 3;
                if (z < mn[0]) mn[0] = z;
                if (z > mx[0]) mx[0] = z;
                if (y < mn[1]) mn[1] = y;
                if (y > mx[1]) mx[1] = y;
                const int x0 = firstb * 64 + __builtin_ctzll(firstm);
                const int x1 = lastb * 64 + 63 - __builtin_clzll(lastm);
                if (x0 < mn[2]) mn[2] = x0;
                if (x1 > mx[2]) mx[2] = x1;
            }
        }
    }
#else
    const int rx0 = tx.lo[xa];
    const int rx1 = tx.lo[xb - 1] + 1;
    for (int z = 0; z < oD; ++z) {
        if (!tz.valid[z]) continue;
        const uint8_t* plane = lobe + (int64_t)tz.lo[z] * HW;
        for (int y = 0; y < oH; ++y) {
            if (!ty.valid[y]) continue;
            const uint8_t* row = plane + (int64_t)ty.lo[y] * W;
            // most sampled rows hold no lobe voxels: one wide OR pass
            // over the raw span skips them without the gather loop
            uint64_t anyv = 0;
            int i = rx0;
            for (; i + 8 <= rx1; i += 8) {
                uint64_t w;
                std::memcpy(&w, row + i, 8);
                anyv |= w;
            }
            for (; i < rx1; ++i) anyv |= row[i];
            if (!anyv) continue;
            for (int x = xa; x < xb; ++x) {
                const int l = row[tx.lo[x]] - 1;
                if (l < 0 || l >= n_labels) continue;
                int32_t* mn = mins + l * 3;
                int32_t* mx = maxs + l * 3;
                if (z < mn[0]) mn[0] = z;
                if (z > mx[0]) mx[0] = z;
                if (y < mn[1]) mn[1] = y;
                if (y > mx[1]) mx[1] = y;
                if (x < mn[2]) mn[2] = x;
                if (x > mx[2]) mx[2] = x;
            }
        }
    }
#endif
}

// Windowed nearest resample u8 -> u8 (labels inside the lung crop only).
void resample_window_nearest_u8(const uint8_t* in, int D, int H, int W,
                                double sz, double sy, double sx,
                                int offz, int offy, int offx,
                                int oD, int oH, int oW, uint8_t* out) {
    AxisTable tz = make_axis(D, oD, sz, true, offz);
    AxisTable ty = make_axis(H, oH, sy, true, offy);
    AxisTable tx = make_axis(W, oW, sx, true, offx);
    const int64_t HW = (int64_t)H * W;
    const int64_t oHW = (int64_t)oH * oW;
#ifdef HP_VBMI
    const BPlan8 bp = make_bplan8(tx, W, oW);
#endif
    for (int z = 0; z < oD; ++z) {
        uint8_t* orow = out + (int64_t)z * oHW;
        if (!tz.valid[z]) {
            std::memset(orow, 0, oHW);
            continue;
        }
        const uint8_t* slab = in + (int64_t)tz.lo[z] * HW;
        for (int y = 0; y < oH; ++y) {
            uint8_t* op = orow + (int64_t)y * oW;
            if (!ty.valid[y]) {
                std::memset(op, 0, oW);
                continue;
            }
            const uint8_t* row = slab + (int64_t)ty.lo[y] * W;
#ifdef HP_VBMI
            std::memset(op, 0, oW);
            nearest_row_vbmi(row, tx, bp, oW, op);
#else
            for (int x = 0; x < oW; ++x)
                op[x] = tx.valid[x] ? row[tx.lo[x]] : 0;
#endif
        }
    }
}

// Nearest resample uint8 -> uint8 (labels), 0 outside.
void resample_iso_nearest_u8(const uint8_t* in, int D, int H, int W,
                             double sz, double sy, double sx,
                             int oD, int oH, int oW, uint8_t* out) {
    AxisTable tz = make_axis(D, oD, sz, true);
    AxisTable ty = make_axis(H, oH, sy, true);
    AxisTable tx = make_axis(W, oW, sx, true);
    const int64_t HW = (int64_t)H * W;
    const int64_t oHW = (int64_t)oH * oW;
#ifdef HP_VBMI
    const BPlan8 bp = make_bplan8(tx, W, oW);
#endif
#pragma omp parallel for schedule(static)
    for (int z = 0; z < oD; ++z) {
        uint8_t* orow = out + (int64_t)z * oHW;
        if (!tz.valid[z]) {
            std::memset(orow, 0, oHW);
            continue;
        }
        const uint8_t* slab = in + (int64_t)tz.lo[z] * HW;
        for (int y = 0; y < oH; ++y) {
            uint8_t* op = orow + (int64_t)y * oW;
            if (!ty.valid[y]) {
                std::memset(op, 0, oW);
                continue;
            }
            const uint8_t* row = slab + (int64_t)ty.lo[y] * W;
#ifdef HP_VBMI
            std::memset(op, 0, oW);
            nearest_row_vbmi(row, tx, bp, oW, op);
#else
            for (int x = 0; x < oW; ++x)
                op[x] = tx.valid[x] ? row[tx.lo[x]] : 0;
#endif
        }
    }
}

// 12-bit wire packing of int16 HU values (clipped to [-2048, 2047]).
void pack12_i16(const int16_t* in, int64_t n, uint8_t* out) {
    const int64_t pairs = (n + 1) / 2;
#pragma omp parallel for schedule(static)
    for (int64_t p = 0; p < pairs; ++p) {
        int32_t v0 = in[2 * p];
        int32_t v1 = (2 * p + 1 < n) ? in[2 * p + 1] : -2048;
        if (v0 < -2048) v0 = -2048;
        if (v0 > 2047) v0 = 2047;
        if (v1 < -2048) v1 = -2048;
        if (v1 > 2047) v1 = 2047;
        const uint32_t u0 = (uint32_t)(v0 + 2048);
        const uint32_t u1 = (uint32_t)(v1 + 2048);
        out[3 * p] = (uint8_t)(u0 >> 4);
        out[3 * p + 1] = (uint8_t)(((u0 & 0xF) << 4) | (u1 >> 8));
        out[3 * p + 2] = (uint8_t)(u1 & 0xFF);
    }
}

// 4-bit packing of labels (0..15).
void pack4_u8(const uint8_t* in, int64_t n, uint8_t* out) {
    const int64_t pairs = (n + 1) / 2;
#pragma omp parallel for schedule(static)
    for (int64_t p = 0; p < pairs; ++p) {
        const uint8_t l0 = in[2 * p] & 0xF;
        const uint8_t l1 = (2 * p + 1 < n) ? (in[2 * p + 1] & 0xF) : 0;
        out[p] = (uint8_t)((l0 << 4) | l1);
    }
}

// ---------------------------------------------------------------------
// Chunk-wire prep kernels (dram_tpu/infer/fast.py prep_scan_chunks): the
// whole per-lobe chunk extraction runs here so the prep thread holds no
// GIL and allocates no NumPy temporaries — on single-core deploy hosts
// the Python version starved the dispatch loop.
// ---------------------------------------------------------------------

// Per-label inclusive bbox over the label volume, one pass.
// mins/maxs are (n_labels, 3); labels are 1..n_labels; a label with no
// voxels keeps min > max.
void lobe_bboxes_u8(const uint8_t* lobe, int D, int H, int W,
                    int n_labels, int32_t* mins, int32_t* maxs) {
    for (int l = 0; l < n_labels; ++l)
        for (int ax = 0; ax < 3; ++ax) {
            mins[l * 3 + ax] = INT32_MAX;
            maxs[l * 3 + ax] = -1;
        }
    // word-scan: lobe volumes are mostly zero, so rows are skipped at
    // 8 bytes per test; only nonzero words fall to the byte loop
    for (int z = 0; z < D; ++z)
        for (int y = 0; y < H; ++y) {
            const uint8_t* row = lobe + ((int64_t)z * H + y) * W;
            int x = 0;
            for (; x + 8 <= W; x += 8) {
                uint64_t w8;
                std::memcpy(&w8, row + x, 8);
                if (w8 == 0) continue;
                for (int k = 0; k < 8; ++k) {
                    const int l = row[x + k] - 1;
                    if (l < 0 || l >= n_labels) continue;
                    int32_t* mn = mins + l * 3;
                    int32_t* mx = maxs + l * 3;
                    if (z < mn[0]) mn[0] = z;
                    if (z > mx[0]) mx[0] = z;
                    if (y < mn[1]) mn[1] = y;
                    if (y > mx[1]) mx[1] = y;
                    if (x + k < mn[2]) mn[2] = x + k;
                    if (x + k > mx[2]) mx[2] = x + k;
                }
            }
            for (; x < W; ++x) {
                const int l = row[x] - 1;
                if (l < 0 || l >= n_labels) continue;
                int32_t* mn = mins + l * 3;
                int32_t* mx = maxs + l * 3;
                if (z < mn[0]) mn[0] = z;
                if (z > mx[0]) mx[0] = z;
                if (y < mn[1]) mn[1] = y;
                if (y > mx[1]) mx[1] = y;
                if (x < mn[2]) mn[2] = x;
                if (x > mx[2]) mx[2] = x;
            }
        }
}

// Contiguous copy of a crop window (replaces a slow NumPy strided copy
// in the prep path: ~250 ms -> memcpy speed for a 26 MB crop).
void crop_copy_u8(const uint8_t* in, int D, int H, int W,
                  int loz, int loy, int lox,
                  int od, int oh, int ow, uint8_t* out) {
    (void)D;
    for (int z = 0; z < od; ++z)
        for (int y = 0; y < oh; ++y)
            std::memcpy(out + ((int64_t)z * oh + y) * ow,
                        in + (((int64_t)(loz + z) * H + (loy + y)) * W
                              + lox),
                        (size_t)ow);
}

// Windowed-u8 lerp table for one axis of the fw chunk resize
// (fast.py _src_to_gather on the lobe's own crop): src = i*size/out,
// clipped to [0, size-1].
static void chunk_axis(int size, int out, int lo0, int32_t* lo,
                       int32_t* hi, float* fr) {
    for (int i = 0; i < out; ++i) {
        double src = (double)i * size / out;
        if (src < 0) src = 0;
        if (src > size - 1) src = size - 1;
        int l = (int)std::floor(src);
        int h = l + 1 > size - 1 ? size - 1 : l + 1;
        lo[i] = lo0 + l;
        hi[i] = lo0 + h;
        fr[i] = (float)(src - l);
    }
}

// One lobe's model chunk: value = (lobe == label) ? window8(scan) : 0 at
// full res, trilinear-resized from the lobe bbox (lo3, size3) to
// (cd, ch, cw), emitted as u8 (wire quantization).
// f32 -> bf16 bits, round-to-nearest-even (finite inputs only — the
// windowed field is in [0, 255]).
static inline uint16_t f32_to_bf16(float x) {
    uint32_t u;
    std::memcpy(&u, &x, 4);
    u += 0x7fffu + ((u >> 16) & 1u);
    return (uint16_t)(u >> 16);
}

static void extract_chunk_impl(const int16_t* scan, const uint8_t* lobe,
                               int D, int H, int W, int label,
                               const int32_t* lo3, const int32_t* size3,
                               double w_lo, double w_hi,
                               int cd, int ch, int cw, int as_bf16,
                               void* out_v) {
    (void)D;
    // Plane-cached separable evaluation of the masked-windowed field:
    // each raw row inside the lobe bbox is masked+windowed and x-lerped
    // once instead of the naive 8 gathered val() calls per output voxel.
    // Trilinear value matches the naive form within 1 u8 level (fp
    // association: a + f*(b-a) vs a*(1-f) + b*f), same as the NumPy twin
    // tolerance.
    std::vector<int32_t> zlo(cd), zhi(cd), ylo(ch), yhi(ch), xlo(cw), xhi(cw);
    std::vector<float> zf(cd), yf(ch), xf(cw);
    chunk_axis(size3[0], cd, 0, zlo.data(), zhi.data(), zf.data());
    chunk_axis(size3[1], ch, 0, ylo.data(), yhi.data(), yf.data());
    chunk_axis(size3[2], cw, 0, xlo.data(), xhi.data(), xf.data());
    // u8 wire: windowed values on the 0..255 level grid, rounded (the
    // wire quantization). bf16 wire: full-precision windowed values in
    // [0, 1] — NO level rounding, so the chunk wire carries exactly the
    // reference's windowing math (windowing is f32 in the reference;
    // only its Otsu quantizes to u8, reference utils.py:226-242)
    const float inv = as_bf16 ? (float)(1.0 / (w_hi - w_lo))
                              : (float)(255.0 / (w_hi - w_lo));
    const float flo = (float)w_lo, fhi = (float)w_hi;
    const int sw = size3[2];
    const uint8_t lab = (uint8_t)label;

    // masked + windowed (+ u8-rounded) raw row (f32), local x in bbox
    std::vector<float> mbuf(sw);
    auto mat_row = [&](int zi, int yi, float* mrow) {
        const int64_t off =
            ((int64_t)(lo3[0] + zi) * H + (lo3[1] + yi)) * W + lo3[2];
        const int16_t* srow = scan + off;
        const uint8_t* lrw = lobe + off;
        int x = 0;
#ifdef HP_AVX512
        const __m512 vlo = _mm512_set1_ps(flo);
        const __m512 vhi = _mm512_set1_ps(fhi);
        const __m512 vinv = _mm512_set1_ps(inv);
        const __m128i vlab = _mm_set1_epi8((char)lab);
        for (; x + 16 <= sw; x += 16) {
            const __mmask16 m = _mm_cmpeq_epi8_mask(
                _mm_loadu_si128((const __m128i*)(lrw + x)), vlab);
            __m512 v = _mm512_cvtepi32_ps(_mm512_cvtepi16_epi32(
                _mm256_loadu_si256((const __m256i*)(srow + x))));
            v = _mm512_min_ps(_mm512_max_ps(v, vlo), vhi);
            v = _mm512_mul_ps(_mm512_sub_ps(v, vlo), vinv);
            if (!as_bf16)
                v = _mm512_roundscale_ps(
                    v, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
            _mm512_storeu_ps(mrow + x, _mm512_maskz_mov_ps(m, v));
        }
#endif
        for (; x < sw; ++x) {
            if (lrw[x] != lab) {
                mrow[x] = 0.f;
                continue;
            }
            float v = (float)srow[x];
            if (v < flo) v = flo;
            if (v > fhi) v = fhi;
            const float t = (v - flo) * inv;
            mrow[x] = as_bf16 ? t : std::nearbyintf(t);
        }
    };

    std::vector<float> xra(cw), xrb(cw);        // x-lerped row cache
    std::vector<float> P0((size_t)ch * cw), P1((size_t)ch * cw);
    int c0 = -1, c1 = -1;

    auto build_plane = [&](int zi, float* P) {
        int ia = -1, ib = -1;
        auto ensure = [&](int yi) -> const float* {
            float* dst;
            if (yi == ia) return xra.data();
            if (yi == ib) return xrb.data();
            if (ia < ib) {
                dst = xra.data();
                ia = yi;
            } else {
                dst = xrb.data();
                ib = yi;
            }
            mat_row(zi, yi, mbuf.data());
            const float* mr = mbuf.data();
            for (int x = 0; x < cw; ++x) {
                const float a = mr[xlo[x]];
                dst[x] = a + xf[x] * (mr[xhi[x]] - a);
            }
            return dst;
        };
        for (int y = 0; y < ch; ++y) {
            const float fy = yf[y];
            const float* r0 = ensure(ylo[y]);
            const float* r1 = ensure(yhi[y]);
            float* op = P + (int64_t)y * cw;
            for (int x = 0; x < cw; ++x)
                op[x] = r0[x] + fy * (r1[x] - r0[x]);
        }
    };

    const int64_t plane_n = (int64_t)ch * cw;
    for (int z = 0; z < cd; ++z) {
        const int z0 = zlo[z], z1 = zhi[z];
        const float fz = zf[z];
        if (c0 != z0) {
            if (c1 == z0) {
                std::swap(P0, P1);
                std::swap(c0, c1);
            } else {
                build_plane(z0, P0.data());
                c0 = z0;
            }
        }
        const float* A = P0.data();
        const float* B;
        if (z1 == z0) {
            B = A;
        } else {
            if (c1 != z1) {
                build_plane(z1, P1.data());
                c1 = z1;
            }
            B = P1.data();
        }
        if (as_bf16) {
            // bf16 wire: full-precision windowed value in [0, 1],
            // RNE-rounded to bf16 bits — the same rounding the model's
            // bf16 input cast applies, so the wire adds NO quantization
            // beyond the compute dtype
            uint16_t* orow = (uint16_t*)out_v + (int64_t)z * plane_n;
            for (int64_t i = 0; i < plane_n; ++i) {
                const float a = A[i];
                orow[i] = f32_to_bf16(a + fz * (B[i] - a));
            }
            continue;
        }
        uint8_t* orow = (uint8_t*)out_v + (int64_t)z * plane_n;
        int64_t i = 0;
#ifdef HP_AVX512
        const __m512 fzv = _mm512_set1_ps(fz);
        for (; i + 16 <= plane_n; i += 16) {
            const __m512 av = _mm512_loadu_ps(A + i);
            const __m512 bv = _mm512_loadu_ps(B + i);
            const __m512 v = _mm512_add_ps(
                av, _mm512_mul_ps(fzv, _mm512_sub_ps(bv, av)));
            _mm_storeu_si128(
                (__m128i*)(orow + i),
                _mm512_cvtusepi32_epi8(_mm512_cvtps_epi32(v)));
        }
#endif
        for (; i < plane_n; ++i) {
            const float a = A[i];
            float r = std::nearbyintf(a + fz * (B[i] - a));
            if (r < 0.f) r = 0.f;
            if (r > 255.f) r = 255.f;
            orow[i] = (uint8_t)r;
        }
    }
}

void extract_chunk_w8(const int16_t* scan, const uint8_t* lobe,
                      int D, int H, int W, int label,
                      const int32_t* lo3, const int32_t* size3,
                      double w_lo, double w_hi,
                      int cd, int ch, int cw, uint8_t* out) {
    extract_chunk_impl(scan, lobe, D, H, W, label, lo3, size3, w_lo, w_hi,
                       cd, ch, cw, 0, out);
}

void extract_chunk_bf16(const int16_t* scan, const uint8_t* lobe,
                        int D, int H, int W, int label,
                        const int32_t* lo3, const int32_t* size3,
                        double w_lo, double w_hi,
                        int cd, int ch, int cw, uint16_t* out) {
    extract_chunk_impl(scan, lobe, D, H, W, label, lo3, size3, w_lo, w_hi,
                       cd, ch, cw, 1, out);
}

// Windowed-u8 wire + lung-masked 256-bin histogram in one pass (the
// histogram feeds the host Otsu for the intensity post rule).
void window8_hist_i16(const int16_t* scan, const uint8_t* lobe, int64_t n,
                      double w_lo, double w_hi, uint8_t* u8_out,
                      int64_t* hist256) {
    const float inv = (float)(255.0 / (w_hi - w_lo));
    const float flo = (float)w_lo, fhi = (float)w_hi;
    // 64K-entry LUT over the full int16 range replaces the per-voxel
    // clamp + nearbyint (identical rounding: the LUT is built with the
    // exact per-voxel math)
    static_assert(sizeof(int16_t) == 2, "int16 LUT");
    std::vector<uint8_t> lut(65536);
    for (int v16 = -32768; v16 < 32768; ++v16) {
        float v = (float)v16;
        if (v < flo) v = flo;
        if (v > fhi) v = fhi;
        lut[(uint16_t)(int16_t)v16] =
            (uint8_t)std::nearbyintf((v - flo) * inv);
    }
    std::memset(hist256, 0, 256 * sizeof(int64_t));
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t u = lut[(uint16_t)scan[i]];
        u8_out[i] = u;
        hist256[u] += (int64_t)(lobe[i] > 0);
    }
}

// Post-rule candidate, packed MSB-first: (u8 > th) && !vessel.
void cand_bits_u8(const uint8_t* u8, const uint8_t* vessel, int64_t n,
                  double th, uint8_t* bits) {
    const int64_t bytes = (n + 7) / 8;
    // integer threshold with identical semantics: (float)u > th for u8 u
    // is u >= uth where uth is the smallest u8 strictly above th
    const double fl = std::floor(th);
    int ith = (int)fl + 1;  // works for fractional and integer th alike
    if (th < 0) ith = 0;
    if (ith > 256) ith = 256;  // nothing passes
    const int64_t full = n / 8;
    if (vessel == nullptr) {
        for (int64_t b = 0; b < full; ++b) {
            const uint8_t* p = u8 + b * 8;
            bits[b] = (uint8_t)(((p[0] >= ith) << 7) | ((p[1] >= ith) << 6)
                                | ((p[2] >= ith) << 5) | ((p[3] >= ith) << 4)
                                | ((p[4] >= ith) << 3) | ((p[5] >= ith) << 2)
                                | ((p[6] >= ith) << 1) | (p[7] >= ith));
        }
    } else {
        for (int64_t b = 0; b < full; ++b) {
            const uint8_t* p = u8 + b * 8;
            const uint8_t* v = vessel + b * 8;
            uint8_t acc = 0;
            for (int k = 0; k < 8; ++k)
                acc |= (uint8_t)(((p[k] >= ith) & (v[k] == 0)) << (7 - k));
            bits[b] = acc;
        }
    }
    for (int64_t b = full; b < bytes; ++b) {
        uint8_t acc = 0;
        const int64_t base = b * 8;
        const int64_t lim = n - base;
        for (int64_t k = 0; k < lim; ++k) {
            const int64_t i = base + k;
            const bool c = (u8[i] >= ith) &&
                           (vessel == nullptr || vessel[i] == 0);
            if (c) acc |= (uint8_t)(0x80u >> k);
        }
        bits[b] = acc;
    }
}

// Per-lobe bucket masks (lobe == label within the bucket window starting
// at starts[l]), packed MSB-first over the flat (n_labels, bd, bh, bw).
void lobe_bucket_bits_u8(const uint8_t* lobe, int D, int H, int W,
                         const int32_t* starts, int bd, int bh, int bw,
                         int n_labels, uint8_t* bits) {
    (void)D;
    const int64_t per = (int64_t)bd * bh * bw;
    const int64_t total = per * n_labels;
    const int64_t bytes = (total + 7) / 8;
    if (bw % 8 == 0) {
        // fast path (bucket dims are multiples of 16 in practice): every
        // (l, z, y) row is byte-aligned — straight row-major bit packing,
        // no per-bit index arithmetic
#ifdef HP_AVX512
        // cmpeq gives 64 bits LSB-first; packbits wants MSB-first within
        // each byte, so each mask byte is bit-reversed through a table
        static const auto kRev = [] {
            std::vector<uint8_t> r(256);
            for (int v = 0; v < 256; ++v) {
                uint8_t b = 0;
                for (int k = 0; k < 8; ++k)
                    if (v & (1 << k)) b |= (uint8_t)(0x80u >> k);
                r[v] = b;
            }
            return r;
        }();
        const uint8_t* rev = kRev.data();
#endif
        for (int l = 0; l < n_labels; ++l) {
            const uint8_t lab = (uint8_t)(l + 1);
            const int sz = starts[l * 3], sy = starts[l * 3 + 1],
                      sx = starts[l * 3 + 2];
            uint8_t* ob = bits + (int64_t)l * per / 8;
            for (int z = 0; z < bd; ++z)
                for (int y = 0; y < bh; ++y) {
                    const uint8_t* src = lobe +
                        ((int64_t)(sz + z) * H + (sy + y)) * W + sx;
                    int xb = 0;
#ifdef HP_AVX512
                    const __m512i vlab = _mm512_set1_epi8((char)lab);
                    for (; xb + 8 <= bw / 8; xb += 8) {
                        const uint64_t m = _mm512_cmpeq_epi8_mask(
                            _mm512_loadu_si512(
                                (const void*)(src + xb * 8)),
                            vlab);
                        for (int k = 0; k < 8; ++k)
                            ob[k] = rev[(uint8_t)(m >> (8 * k))];
                        ob += 8;
                    }
#endif
                    for (; xb < bw / 8; ++xb) {
                        const uint8_t* p = src + xb * 8;
                        *ob++ = (uint8_t)(
                            ((p[0] == lab) << 7) | ((p[1] == lab) << 6) |
                            ((p[2] == lab) << 5) | ((p[3] == lab) << 4) |
                            ((p[4] == lab) << 3) | ((p[5] == lab) << 2) |
                            ((p[6] == lab) << 1) | (p[7] == lab));
                    }
                }
        }
        return;
    }
    for (int64_t b = 0; b < bytes; ++b) {
        uint8_t acc = 0;
        const int64_t base = b * 8;
        const int64_t lim = (base + 8 < total) ? 8 : total - base;
        for (int64_t k = 0; k < lim; ++k) {
            const int64_t fi = base + k;
            const int l = (int)(fi / per);
            const int64_t r = fi % per;
            const int z = (int)(r / ((int64_t)bh * bw));
            const int64_t r2 = r % ((int64_t)bh * bw);
            const int y = (int)(r2 / bw);
            const int x = (int)(r2 % bw);
            const int64_t src = ((int64_t)(starts[l * 3] + z) * H +
                                 (starts[l * 3 + 1] + y)) * W +
                                (starts[l * 3 + 2] + x);
            if (lobe[src] == l + 1) acc |= (uint8_t)(0x80u >> k);
        }
        bits[b] = acc;
    }
}

// MSB-first bit unpacking (np.unpackbits) for mask D2H decode.
void unpackbits_u8(const uint8_t* in, int64_t n_bytes, uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_bytes; ++i) {
        const uint8_t b = in[i];
        uint8_t* o = out + i * 8;
        o[0] = (b >> 7) & 1; o[1] = (b >> 6) & 1;
        o[2] = (b >> 5) & 1; o[3] = (b >> 4) & 1;
        o[4] = (b >> 3) & 1; o[5] = (b >> 2) & 1;
        o[6] = (b >> 1) & 1; o[7] = b & 1;
    }
}

// Nearest back-resample of a bit-packed iso-crop mask into a window of a
// full-resolution u8 volume — the host twin of the device back-gather
// (infer/fast.py stage2post `back()`), bit-identical by construction:
//   out[oz+z2, oy+y2, ox+x2] = bit[iz[z2], iy[y2], ix[x2]]
// `bits` holds D1*H1*W1 MSB-first packed bits in C order (source rows are
// NOT byte-aligned). Letting the device emit masks on the coarse iso grid
// and gathering here cuts the packed-mask D2H ~(spacing_z*y*x)x; output
// rows repeating a source row are memcpy'd (the out grid is finer than
// iso on every axis, so repeats are common).
void unpack_nearest_gather_u8(
        const uint8_t* bits, int D1, int H1, int W1,
        uint8_t* out, int Hf, int Wf,
        int oz, int oy, int ox,
        int D2, int H2, int W2,
        const int32_t* iz, const int32_t* iy, const int32_t* ix) {
#pragma omp parallel for schedule(static)
    for (int z2 = 0; z2 < D2; ++z2) {
        const int z1 = iz[z2];
        std::vector<uint8_t> row((size_t)W1);
        int prev_y1 = -1;
        for (int y2 = 0; y2 < H2; ++y2) {
            const int y1 = iy[y2];
            uint8_t* dst = out + ((int64_t)(oz + z2) * Hf + (oy + y2)) * Wf
                           + ox;
            if (y1 == prev_y1 && y2 > 0) {
                const uint8_t* prev =
                    out + ((int64_t)(oz + z2) * Hf + (oy + y2 - 1)) * Wf + ox;
                std::memcpy(dst, prev, (size_t)W2);
                continue;
            }
            prev_y1 = y1;
            const int64_t off = ((int64_t)z1 * H1 + y1) * (int64_t)W1;
            for (int x1 = 0; x1 < W1; ++x1) {
                const int64_t b = off + x1;
                row[(size_t)x1] =
                    (uint8_t)((bits[b >> 3] >> (7 - (b & 7))) & 1);
            }
            for (int x2 = 0; x2 < W2; ++x2) dst[x2] = row[(size_t)ix[x2]];
        }
    }
}

}  // extern "C"
