// Native host-side runtime for the GXZ engine (loaded via ctypes).
//
// Implements the SAME RANS-W32x16 stream format as ops/rans_np.py (the
// normative spec) as a fast scalar coder for host-side / small-section
// payloads, plus binary-record scanners (BAM) that are inherently serial
// pointer-chases and belong in native code (reference parity: the reference's
// entire runtime is C; here C++ covers only the host-serial parts while
// JAX/Pallas owns device compute).
//
// Build: g++ -O3 -march=native -shared -fPIC gxz_native.cpp -o libgxz.so -lz
//        [-DGXZ_LIBDEFLATE -ldeflate]
// (native/__init__.py builds it on first use, once per host CPU).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <algorithm>
#include <vector>
#include <memory>
#include <thread>
#include <zlib.h>

#ifdef GXZ_LIBDEFLATE
#include <libdeflate.h>
#else
// Hosts without libdeflate: zlib stand-ins for the libdeflate calls below.
// Same stream formats (other compressed bytes); levels above 9 are refused,
// so libdeflate-only settings (exact re-emission of libdeflate-written BGZF)
// fail instead of producing other bytes.
namespace {
struct libdeflate_compressor { int level; };
struct libdeflate_decompressor { int unused; };
enum libdeflate_result { LIBDEFLATE_SUCCESS = 0, LIBDEFLATE_BAD_DATA = 1 };

libdeflate_compressor* libdeflate_alloc_compressor(int level) {
    return level >= 1 && level <= 9 ? new libdeflate_compressor{level}
                                    : nullptr;
}
void libdeflate_free_compressor(libdeflate_compressor* c) { delete c; }
libdeflate_decompressor* libdeflate_alloc_decompressor() {
    return new libdeflate_decompressor{0};
}
void libdeflate_free_decompressor(libdeflate_decompressor* d) { delete d; }

size_t zlib_deflate(int level, int wbits, const void* in, size_t n,
                    void* out, size_t cap) {
    z_stream zs;
    memset(&zs, 0, sizeof zs);
    if (deflateInit2(&zs, level, Z_DEFLATED, wbits, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
        return 0;
    zs.next_in = (Bytef*)in;
    zs.avail_in = (uInt)n;
    zs.next_out = (Bytef*)out;
    zs.avail_out = (uInt)cap;
    int rc = deflate(&zs, Z_FINISH);
    size_t w = cap - zs.avail_out;
    deflateEnd(&zs);
    return rc == Z_STREAM_END ? w : 0;
}

libdeflate_result zlib_inflate(int wbits, const void* in, size_t n, void* out,
                               size_t cap, size_t* actual) {
    z_stream zs;
    memset(&zs, 0, sizeof zs);
    if (inflateInit2(&zs, wbits) != Z_OK) return LIBDEFLATE_BAD_DATA;
    zs.next_in = (Bytef*)in;
    zs.avail_in = (uInt)n;
    zs.next_out = (Bytef*)out;
    zs.avail_out = (uInt)cap;
    int rc = inflate(&zs, Z_FINISH);
    *actual = cap - zs.avail_out;
    inflateEnd(&zs);
    return rc == Z_STREAM_END ? LIBDEFLATE_SUCCESS : LIBDEFLATE_BAD_DATA;
}

size_t libdeflate_zlib_compress(libdeflate_compressor* c, const void* in,
                                size_t n, void* out, size_t cap) {
    return zlib_deflate(c->level, 15, in, n, out, cap);
}
size_t libdeflate_deflate_compress(libdeflate_compressor* c, const void* in,
                                   size_t n, void* out, size_t cap) {
    return zlib_deflate(c->level, -15, in, n, out, cap);
}
libdeflate_result libdeflate_zlib_decompress(libdeflate_decompressor*,
                                             const void* in, size_t n,
                                             void* out, size_t cap,
                                             size_t* actual) {
    return zlib_inflate(15, in, n, out, cap, actual);
}
libdeflate_result libdeflate_deflate_decompress(libdeflate_decompressor*,
                                                const void* in, size_t n,
                                                void* out, size_t cap,
                                                size_t* actual) {
    return zlib_inflate(-15, in, n, out, cap, actual);
}
uint32_t libdeflate_crc32(uint32_t crc, const void* p, size_t n) {
    return (uint32_t)crc32(crc, (const Bytef*)p, (uInt)n);
}
}  // namespace
#endif

namespace {

constexpr int SCALE_BITS = 12;
constexpr uint32_t SCALE = 1u << SCALE_BITS;
constexpr uint32_t RANS_L = 1u << 16;

// must replicate rans_np.choose_num_lanes exactly
int choose_log_lanes(int64_t n) {
    if (n <= 0) return 4;
    int64_t target = n / (n >= (1 << 20) ? 128 : 256);
    if (target <= 1) return 4;
    int k = 64 - __builtin_clzll((uint64_t)(target - 1));  // ceil(log2(target))
    return std::max(4, std::min(13, k));
}

// exact replica of rans_np.normalize_freqs (largest-remainder, ties by
// (-count, symbol) stable order)
void normalize_freqs(const int64_t* hist, uint32_t* f_out) {
    int64_t total = 0;
    for (int i = 0; i < 256; i++) total += hist[i];
    if (total == 0) {
        memset(f_out, 0, 256 * 4);
        f_out[0] = SCALE;
        return;
    }
    int64_t f[256];
    int64_t sum = 0;
    for (int i = 0; i < 256; i++) {
        f[i] = (int64_t)((unsigned __int128)hist[i] * SCALE / (uint64_t)total);
        if (hist[i] > 0 && f[i] == 0) f[i] = 1;
        sum += f[i];
    }
    int64_t diff = SCALE - sum;
    if (diff != 0) {
        int order[256];
        for (int i = 0; i < 256; i++) order[i] = i;
        std::stable_sort(order, order + 256, [&](int a, int b) {
            return hist[a] > hist[b];  // desc count; stable keeps sym asc
        });
        int64_t step = diff > 0 ? 1 : -1;
        int64_t remaining = diff > 0 ? diff : -diff;
        for (int64_t i = 0; remaining > 0; i++) {
            int s = order[i % 256];
            if (hist[s] > 0 && (step > 0 || f[s] > 1)) {
                f[s] += step;
                remaining--;
            }
        }
    }
    for (int i = 0; i < 256; i++) f_out[i] = (uint32_t)f[i];
}

size_t freqs_serialize(const uint32_t* f, uint8_t* out) {
    uint8_t* bitmap = out;
    memset(bitmap, 0, 32);
    size_t off = 32;
    for (int i = 0; i < 256; i++)
        if (f[i] > 0) bitmap[i >> 3] |= (uint8_t)(1u << (i & 7));
    for (int i = 0; i < 256; i++)
        if (f[i] > 0) {
            out[off++] = (uint8_t)(f[i] & 0xFF);
            out[off++] = (uint8_t)(f[i] >> 8);
        }
    return off;
}

size_t freqs_deserialize(const uint8_t* in, uint32_t* f) {
    size_t off = 32;
    for (int i = 0; i < 256; i++) {
        if (in[i >> 3] & (1u << (i & 7))) {
            f[i] = (uint32_t)in[off] | ((uint32_t)in[off + 1] << 8);
            off += 2;
        } else f[i] = 0;
    }
    return off;
}

struct LaneLayout {
    int64_t K;
    int N;
};

LaneLayout layout(int64_t n) {
    int N = 1 << choose_log_lanes(n);
    int64_t K = n > 0 ? (n + N - 1) / N : 0;
    return {K, N};
}

// (K, N) step-row plane -> (N, K) lane-chunk output, cache-blocked
void rans_transpose_out(const uint8_t* plane, int64_t n, int64_t K, int N,
                        uint8_t* out) {
    constexpr int64_t B = 64;
    for (int64_t t0 = 0; t0 < K; t0 += B)
        for (int64_t l0 = 0; l0 < N; l0 += B) {
            int64_t t1 = std::min(t0 + B, K), l1 = std::min(l0 + B, (int64_t)N);
            for (int64_t l = l0; l < l1; l++) {
                int64_t lane_end = std::min((int64_t)(l + 1) * K, n);
                int64_t tmax = std::min(t1, lane_end - l * K);
                for (int64_t t = t0; t < tmax; t++)
                    out[l * K + t] = plane[(size_t)t * N + l];
            }
        }
}

}  // namespace

extern "C" {

namespace {

// Granlund-Montgomery magic division: q = (x * M) >> (32 + l), exact for all
// x < 2^32 when e = M*d - 2^(32+l) satisfies 0 < e <= 2^l (checked at build).
struct Magic {
    uint64_t M;
    int sh;
    bool exact;
};

Magic make_magic(uint32_t d) {
    if (d == 0) return {0, 0, false};
    int l = 0;
    while ((1u << l) < d) l++;            // l = ceil(log2(d)), d <= 2^12
    if ((d & (d - 1)) == 0)               // power of two: M = 2^32, plain shift
        return {(uint64_t)1 << 32, 32 + l, true};
    uint64_t two_pow = (uint64_t)1 << (32 + l);
    uint64_t M = (two_pow + d - 1) / d;   // ceil
    uint64_t e = M * d - two_pow;         // Granlund-Montgomery exactness
    return {M, 32 + l, e > 0 && e <= ((uint64_t)1 << l)};
}

inline uint32_t magic_div(uint32_t x, const Magic& m, uint32_t d) {
    if (__builtin_expect(!m.exact, 0)) return x / d;
    return (uint32_t)(((unsigned __int128)x * m.M) >> m.sh);
}

}  // namespace

// ---------------------------------------------------------------------------
// AVX-512 rANS core.  The W32x16 stream format interleaves N (16..8192)
// lanes of 32-bit rANS states; 16 lanes fit exactly one zmm of u32, so both
// passes run one zmm per lane-group with zero scalar per-symbol work:
//   encode: ryg-style reciprocal multiply replaces the division, renorm
//           words are emitted backward with vpcompressd + 16-bit truncate
//           (byte-identical stream to the scalar coder: same lane layout,
//           same renorm rule (x>>20 >= f), same (t asc, lane asc) order);
//   decode: one fused u32 gather per step [sym(8) | freq-1(12) | cum(12)],
//           renorm words injected with vpexpandd.
// Input is transposed once into a (K, N) plane so each step touches 16
// contiguous bytes; the order-1 context row is simply the previous plane row.
// ---------------------------------------------------------------------------
#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512VL__)
#define GXZ_AVX512 1
#include <immintrin.h>

namespace {

inline __m512i mulhi_epu32(__m512i a, __m512i b) {
    __m512i lo = _mm512_mul_epu32(a, b);                      // even lanes
    __m512i hi = _mm512_mul_epu32(_mm512_srli_epi64(a, 32),
                                  _mm512_srli_epi64(b, 32));  // odd lanes
    lo = _mm512_srli_epi64(lo, 32);
    return _mm512_mask_blend_epi32(0xAAAA, lo, hi);
}

// (N, K)-lane-chunk layout -> (K, N) step-row plane, cache-blocked
void rans_transpose_in(const uint8_t* data, int64_t n, int64_t K, int N,
                       uint8_t* plane) {
    constexpr int64_t B = 64;
    for (int64_t l0 = 0; l0 < N; l0 += B)
        for (int64_t t0 = 0; t0 < K; t0 += B) {
            int64_t l1 = std::min(l0 + B, (int64_t)N), t1 = std::min(t0 + B, K);
            for (int64_t l = l0; l < l1; l++) {
                int64_t lane_end = std::min((int64_t)(l + 1) * K, n);
                int64_t tmax = std::min(t1, lane_end - l * K);
                for (int64_t t = t0; t < tmax; t++)
                    plane[(size_t)t * N + l] = data[l * K + t];
            }
        }
}

// per-symbol encode tables.  Division by freq uses the Granlund-Montgomery
// 33-bit round-up magic M = ceil(2^(32+l)/f), l = ceil(log2 f) — exact for
// ALL x < 2^32 (GM Thm 4.2; M always fits 33 bits).  SIMD evaluation with
// m = M - 2^32:  hi = mulhi(x, m);  q = (hi + ((x-hi)>>1)) >> (l-1).
// For freq==1: m=~0 gives hi = x-1, sh=0 gives q = x-1, and bias absorbs
// the off-by-one (bias = cum + SCALE - 1, so x' = x*SCALE + cum).
//   t0 = freq(13) | bias(13)<<13 | sh(4)<<26,  t1 = m.
void build_enc_tables(const uint32_t* freq, const uint32_t* cum, size_t ntab,
                      uint32_t* t0, uint32_t* t1) {
    for (size_t i = 0; i < ntab; i++) {
        uint32_t f = freq[i];
        if (!f) { t0[i] = 0; t1[i] = 0; continue; }
        uint32_t m, sh, bias;
        if (f < 2) {
            m = ~0u; sh = 0; bias = cum[i] + SCALE - 1;
        } else {
            uint32_t l = 0;
            while (f > (1u << l)) l++;
            uint64_t M = ((((uint64_t)1 << (32 + l)) + f - 1) / f);
            m = (uint32_t)(M - ((uint64_t)1 << 32));
            sh = l - 1; bias = cum[i];
        }
        t0[i] = f | (bias << 13) | (sh << 26);
        t1[i] = m;
    }
}

// encode core: fills words[] backward from words+cap, returns start index p
// and final states in x[].  freq/cum sized 256 (o0) or 65536 (o1).
int64_t rans_encode_core_avx512(const uint8_t* plane, int64_t n, int64_t K,
                                int N, int order, const uint32_t* t0,
                                const uint32_t* t1, uint32_t* x,
                                uint16_t* words, int64_t cap) {
    int64_t p = cap;
    int64_t L_full = K ? n / K : 0, rem = K ? n - L_full * K : 0;
    const __m512i m13 = _mm512_set1_epi32(0x1FFF);
    const __m512i mscale = _mm512_set1_epi32((int)SCALE);
    for (int64_t t = K - 1; t >= 0; t--) {
        int64_t active = L_full + (t < rem ? 1 : 0);
        const uint8_t* row = plane + (size_t)t * N;
        const uint8_t* prow = (order && t) ? row - N : nullptr;
        for (int g = N - 16; g >= 0; g -= 16) {
            if (g >= active) continue;
            __mmask16 am = (active - g >= 16)
                ? (__mmask16)0xFFFF : (__mmask16)((1u << (active - g)) - 1);
            __m512i ix = _mm512_cvtepu8_epi32(
                _mm_loadu_si128((const __m128i*)(row + g)));
            if (order) {
                __m512i ctx = prow
                    ? _mm512_cvtepu8_epi32(
                          _mm_loadu_si128((const __m128i*)(prow + g)))
                    : _mm512_setzero_si512();
                ix = _mm512_add_epi32(_mm512_slli_epi32(ctx, 8), ix);
            }
            __m512i e0 = _mm512_mask_i32gather_epi32(
                _mm512_setzero_si512(), am, ix, t0, 4);
            __m512i f = _mm512_and_si512(e0, m13);
            __m512i bias = _mm512_and_si512(_mm512_srli_epi32(e0, 13), m13);
            __m512i sh = _mm512_srli_epi32(e0, 26);
            __m512i xv = _mm512_loadu_si512(x + g);
            __mmask16 rm = _mm512_mask_cmpge_epu32_mask(
                am, _mm512_srli_epi32(xv, 20), f);
            int cnt = __builtin_popcount((unsigned)rm);
            if (cnt) {
                __m512i packed = _mm512_maskz_compress_epi32(rm, xv);
                __m256i w16 = _mm512_cvtepi32_epi16(packed);
                p -= cnt;
                _mm256_mask_storeu_epi16(words + p,
                                         (__mmask16)((1u << cnt) - 1), w16);
                xv = _mm512_mask_srli_epi32(xv, rm, xv, 16);
            }
            __m512i m = _mm512_mask_i32gather_epi32(
                _mm512_setzero_si512(), am, ix, t1, 4);
            __m512i hi = mulhi_epu32(xv, m);
            __m512i tq = _mm512_add_epi32(
                hi, _mm512_srli_epi32(_mm512_sub_epi32(xv, hi), 1));
            __m512i q = _mm512_srlv_epi32(tq, sh);
            __m512i cmpl = _mm512_sub_epi32(mscale, f);
            __m512i xn = _mm512_add_epi32(
                _mm512_add_epi32(xv, bias), _mm512_mullo_epi32(q, cmpl));
            xv = _mm512_mask_blend_epi32(am, xv, xn);
            _mm512_storeu_si512(x + g, xv);
        }
    }
    return p;
}

// decode core: consumes words[] forward from index p (2N after states),
// writes the (K, N) plane.  tab = fused per-slot table (o0: SCALE entries;
// o1: 256*SCALE).  Returns final p, or -1 on overconsumption.
int64_t rans_decode_core_avx512(uint8_t* plane, int64_t n, int64_t K, int N,
                                int order, const uint32_t* tab, uint32_t* x,
                                const uint16_t* words, int64_t nwords,
                                int64_t p) {
    int64_t L_full = K ? n / K : 0, rem = K ? n - L_full * K : 0;
    const __m512i mslot = _mm512_set1_epi32((int)(SCALE - 1));
    const __m512i m12 = _mm512_set1_epi32(0xFFF);
    const __m512i m8 = _mm512_set1_epi32(0xFF);
    const __m512i one = _mm512_set1_epi32(1);
    const __m512i lbound = _mm512_set1_epi32((int)RANS_L);
    for (int64_t t = 0; t < K; t++) {
        int64_t active = L_full + (t < rem ? 1 : 0);
        uint8_t* row = plane + (size_t)t * N;
        const uint8_t* prow = (order && t) ? row - N : nullptr;
        for (int g = 0; g < N; g += 16) {
            if (g >= active) break;
            __mmask16 am = (active - g >= 16)
                ? (__mmask16)0xFFFF : (__mmask16)((1u << (active - g)) - 1);
            __m512i xv = _mm512_loadu_si512(x + g);
            __m512i slot = _mm512_and_si512(xv, mslot);
            __m512i ix = slot;
            if (order) {
                __m512i ctx = prow
                    ? _mm512_cvtepu8_epi32(
                          _mm_loadu_si128((const __m128i*)(prow + g)))
                    : _mm512_setzero_si512();
                ix = _mm512_add_epi32(_mm512_slli_epi32(ctx, SCALE_BITS), slot);
            }
            __m512i e = _mm512_mask_i32gather_epi32(
                _mm512_setzero_si512(), am, ix, tab, 4);
            __m512i sym = _mm512_and_si512(e, m8);
            __m512i f = _mm512_add_epi32(
                _mm512_and_si512(_mm512_srli_epi32(e, 8), m12), one);
            __m512i c = _mm512_srli_epi32(e, 20);
            __m512i xn = _mm512_add_epi32(
                _mm512_mullo_epi32(f, _mm512_srli_epi32(xv, SCALE_BITS)),
                _mm512_sub_epi32(slot, c));
            xv = _mm512_mask_blend_epi32(am, xv, xn);
            __mmask16 rm = _mm512_mask_cmplt_epu32_mask(am, xv, lbound);
            int cnt = __builtin_popcount((unsigned)rm);
            if (cnt) {
                __m512i wv = _mm512_cvtepu16_epi32(
                    _mm256_loadu_si256((const __m256i*)(words + p)));
                wv = _mm512_maskz_expand_epi32(rm, wv);
                __m512i xr = _mm512_or_si512(_mm512_slli_epi32(xv, 16), wv);
                xv = _mm512_mask_blend_epi32(rm, xv, xr);
                p += cnt;
            }
            _mm512_storeu_si512(x + g, xv);
            _mm_storeu_si128((__m128i*)(row + g), _mm512_cvtepi32_epi8(sym));
        }
        if (p > nwords) return -1;
    }
    return p;
}

}  // namespace
#endif  // GXZ_AVX512

// Vector width (bits) of the rANS cores this build selected at compile time.
int gxz_simd_bits() {
#ifdef GXZ_AVX512
    return 512;
#else
    return 0;
#endif
}

// 1 when built against libdeflate, 0 when its zlib stand-ins are in use.
int gxz_has_libdeflate() {
#ifdef GXZ_LIBDEFLATE
    return 1;
#else
    return 0;
#endif
}

// ---------------------------------------------------------------------------
// rANS order-0 / order-1 encode.  Two cache-friendly passes: (A) per-lane
// sequential encode into per-lane word buffers + emit bitsets (lane chunks
// are contiguous input ranges); (B) bitset-driven merge into the single
// interleaved stream in (step desc, lane desc) order.
// Returns number of bytes written, or -1 on error.
// ---------------------------------------------------------------------------
int64_t gxz_rans_encode(const uint8_t* data, int64_t n, int order,
                        uint8_t* out, int64_t out_cap) {
    auto [K, N] = layout(n);
    int logN = choose_log_lanes(n);

    std::vector<uint32_t> freq, cum;
    std::vector<uint8_t> ftab;

    if (order == 0) {
        // 4-way split histogram: breaks the store-forward dependency chain
        int64_t h4[4][256] = {{0}};
        int64_t i = 0;
        for (; i + 4 <= n; i += 4) {
            h4[0][data[i]]++; h4[1][data[i + 1]]++;
            h4[2][data[i + 2]]++; h4[3][data[i + 3]]++;
        }
        for (; i < n; i++) h4[0][data[i]]++;
        int64_t hist[256];
        for (int s = 0; s < 256; s++)
            hist[s] = h4[0][s] + h4[1][s] + h4[2][s] + h4[3][s];
        freq.resize(256); cum.resize(256);
        normalize_freqs(hist, freq.data());
        uint32_t c = 0;
        for (int i = 0; i < 256; i++) { cum[i] = c; c += freq[i]; }
        ftab.resize(32 + 512);
        ftab.resize(freqs_serialize(freq.data(), ftab.data()));
    } else {
        std::vector<int64_t> hist2(256 * 256, 0);
        for (int l = 0; l < N; l++) {
            int64_t s0 = (int64_t)l * K, s1 = std::min(s0 + K, n);
            uint8_t ctx = 0;
            for (int64_t i = s0; i < s1; i++) {
                hist2[(size_t)ctx * 256 + data[i]]++;
                ctx = data[i];
            }
        }
        freq.assign(256 * 256, 0); cum.assign(256 * 256, 0);
        std::vector<uint8_t> raw(32, 0);
        for (int c0 = 0; c0 < 256; c0++) {
            int64_t t = 0;
            for (int s = 0; s < 256; s++) t += hist2[(size_t)c0 * 256 + s];
            if (t == 0) continue;
            raw[c0 >> 3] |= (uint8_t)(1u << (c0 & 7));
            normalize_freqs(&hist2[(size_t)c0 * 256], &freq[(size_t)c0 * 256]);
            uint32_t cc = 0;
            for (int s = 0; s < 256; s++) {
                cum[(size_t)c0 * 256 + s] = cc;
                cc += freq[(size_t)c0 * 256 + s];
            }
            uint8_t buf[32 + 512];
            size_t len = freqs_serialize(&freq[(size_t)c0 * 256], buf);
            raw.insert(raw.end(), buf, buf + len);
        }
        uLongf clen = compressBound(raw.size());
        std::vector<uint8_t> comp(clen);
        if (compress2(comp.data(), &clen, raw.data(), raw.size(), 6) != Z_OK)
            return -1;
        ftab.resize(8 + clen);
        uint32_t rl = (uint32_t)raw.size(), cl = (uint32_t)clen;
        memcpy(ftab.data(), &rl, 4);
        memcpy(ftab.data() + 4, &cl, 4);
        memcpy(ftab.data() + 8, comp.data(), clen);
    }

    int64_t hdr_len = 6 + (int64_t)ftab.size();
    int64_t max_words = n + 2 * (int64_t)N + 8;
    if (out_cap < hdr_len + max_words * 2) return -1;

    out[0] = (uint8_t)logN;
    out[1] = (uint8_t)order;
    uint32_t n32 = (uint32_t)n;
    memcpy(out + 2, &n32, 4);
    memcpy(out + 6, ftab.data(), ftab.size());

#ifdef GXZ_AVX512
    if (n >= 1024) {
        size_t ntab = order == 0 ? 256 : (size_t)256 * 256;
        std::vector<uint32_t> t0(ntab), t1(ntab);
        build_enc_tables(freq.data(), cum.data(), ntab, t0.data(), t1.data());
        // no init: cells past n are only read through am-masked gathers
        std::unique_ptr<uint8_t[]> plane(new uint8_t[(size_t)K * N]);
        rans_transpose_in(data, n, K, N, plane.get());
        std::vector<uint32_t> xs(N, RANS_L);
        std::unique_ptr<uint16_t[]> vwords(new uint16_t[max_words]);
        int64_t p = rans_encode_core_avx512(plane.get(), n, K, N, order,
                                            t0.data(), t1.data(), xs.data(),
                                            vwords.get(), max_words);
        for (int l = N - 1; l >= 0; l--) {
            vwords[--p] = (uint16_t)(xs[l] & 0xFFFF);
            vwords[--p] = (uint16_t)(xs[l] >> 16);
        }
        int64_t nw = max_words - p;
        memcpy(out + hdr_len, &vwords[p], (size_t)nw * 2);
        return hdr_len + nw * 2;
    }
#endif

    // magic-division tables (one per distinct freq value)
    size_t ntab = order == 0 ? 256 : 256 * 256;
    std::vector<Magic> magic(ntab);
    for (size_t i = 0; i < ntab; i++)
        if (freq[i]) magic[i] = make_magic(freq[i]);

    // pass A: per-lane sequential encode (lane chunk = contiguous input)
    std::vector<uint32_t> x(N, RANS_L);
    std::unique_ptr<uint16_t[]> lane_words(new uint16_t[n + N]);  // no init
    std::vector<int64_t> lane_wcnt(N, 0);
    int64_t bits_per_lane = (K + 63) / 64 + 1;
    std::vector<uint64_t> flags((size_t)bits_per_lane * N, 0);
    std::vector<int64_t> lane_wstart(N + 1, 0);
    // capacity: lane l emits at most lane_len words
    for (int l = 0; l < N; l++) {
        int64_t lane_len = std::min((int64_t)(l + 1) * K, n) - (int64_t)l * K;
        if (lane_len < 0) lane_len = 0;
        lane_wstart[l + 1] = lane_wstart[l] + lane_len;
    }
    // 4-way lane interleaving breaks the per-lane serial dependency chain
    // (the state update's div/mul latency would otherwise bound throughput)
    for (int g = 0; g < N; g += 4) {
        int nl = std::min(4, N - g);
        int64_t s0[4], len[4], wc[4] = {0, 0, 0, 0};
        uint32_t xx[4];
        uint16_t* wbuf[4];
        uint64_t* fl[4];
        int64_t tmax = 0;
        for (int j = 0; j < nl; j++) {
            int l = g + j;
            s0[j] = (int64_t)l * K;
            len[j] = std::max((int64_t)0, std::min(s0[j] + K, n) - s0[j]);
            xx[j] = RANS_L;
            wbuf[j] = &lane_words[lane_wstart[l]];
            fl[j] = &flags[(size_t)bits_per_lane * l];
            tmax = std::max(tmax, len[j]);
        }
        for (int64_t t = tmax - 1; t >= 0; t--) {
            for (int j = 0; j < nl; j++) {
                if (t >= len[j]) continue;
                uint8_t s = data[s0[j] + t];
                size_t ix;
                if (order == 0) ix = s;
                else {
                    uint8_t ctx = (t == 0) ? 0 : data[s0[j] + t - 1];
                    ix = (size_t)ctx * 256 + s;
                }
                uint32_t f = freq[ix], c = cum[ix];
                uint32_t v = xx[j];
                if ((v >> 20) >= f) {
                    wbuf[j][wc[j]++] = (uint16_t)(v & 0xFFFF);
                    v >>= 16;
                    fl[j][t >> 6] |= (uint64_t)1 << (t & 63);
                }
                uint32_t q = magic_div(v, magic[ix], f);
                xx[j] = (q << SCALE_BITS) + (v - q * f) + c;
            }
        }
        for (int j = 0; j < nl; j++) {
            x[g + j] = xx[j];
            lane_wcnt[g + j] = wc[j];
        }
    }

    // pass B: merge in (step desc, lane desc) order, writing backward
    std::unique_ptr<uint16_t[]> words(new uint16_t[max_words]);  // no init
    int64_t p = max_words;
    std::vector<int64_t> consumed(N, 0);  // words consumed per lane (from 0)
    for (int64_t t = K - 1; t >= 0; t--) {
        int64_t word_idx = t >> 6;
        uint64_t bit = (uint64_t)1 << (t & 63);
        for (int l = N - 1; l >= 0; l--) {
            if (flags[(size_t)bits_per_lane * l + word_idx] & bit)
                words[--p] = lane_words[lane_wstart[l] + consumed[l]++];
        }
    }
    // flush states backward: descending lane, lo then hi
    for (int l = N - 1; l >= 0; l--) {
        words[--p] = (uint16_t)(x[l] & 0xFFFF);
        words[--p] = (uint16_t)(x[l] >> 16);
    }
    int64_t nwords = max_words - p;
    memcpy(out + hdr_len, &words[p], (size_t)nwords * 2);
    return hdr_len + nwords * 2;
}

// ---------------------------------------------------------------------------
// rANS decode.  Returns bytes written to out (== n from header) or -1.
// ---------------------------------------------------------------------------
int64_t gxz_rans_decode(const uint8_t* in, int64_t in_len, uint8_t* out,
                        int64_t out_cap) {
    if (in_len < 6) return -1;
    int logN = in[0], order = in[1];
    int N = 1 << logN;
    uint32_t n32;
    memcpy(&n32, in + 2, 4);
    int64_t n = n32;
    if (out_cap < n) return -1;
    size_t off = 6;

#ifdef GXZ_AVX512
    if (n >= 1024) {
        // fused per-slot table: sym(8) | freq-1(12) | cum(12)
        std::vector<uint32_t> tab;
        size_t o2 = off;
        if (order == 0) {
            std::vector<uint32_t> f(256);
            o2 += freqs_deserialize(in + o2, f.data());
            tab.assign(SCALE, 0);
            uint32_t c = 0;
            for (int s = 0; s < 256; s++) {
                for (uint32_t j = 0; j < f[s]; j++)
                    tab[c + j] = (uint32_t)s | ((f[s] - 1) << 8) | (c << 20);
                c += f[s];
            }
        } else {
            uint32_t rawlen, clen;
            memcpy(&rawlen, in + o2, 4);
            memcpy(&clen, in + o2 + 4, 4);
            o2 += 8;
            std::vector<uint8_t> raw(rawlen);
            uLongf rl = rawlen;
            if (uncompress(raw.data(), &rl, in + o2, clen) != Z_OK) return -1;
            o2 += clen;
            tab.assign((size_t)256 * SCALE, 0);
            std::vector<uint32_t> f(256);
            size_t ro = 32;
            for (int c0 = 0; c0 < 256; c0++) {
                if (!(raw[c0 >> 3] & (1u << (c0 & 7)))) continue;
                ro += freqs_deserialize(raw.data() + ro, f.data());
                uint32_t cc = 0;
                uint32_t* trow = &tab[(size_t)c0 * SCALE];
                for (int s = 0; s < 256; s++) {
                    for (uint32_t j = 0; j < f[s]; j++)
                        trow[cc + j] =
                            (uint32_t)s | ((f[s] - 1) << 8) | (cc << 20);
                    cc += f[s];
                }
            }
        }
        int64_t nwords = (in_len - (int64_t)o2) / 2;
        if (nwords < 2 * N) return -2;
        // padded copy: the decode core bounds-checks the word cursor only
        // once per plane row, during which a corrupted archive can advance
        // it by up to N entries; each renorm does an unmasked 32B load at
        // the cursor, so pad by N+16 entries to keep every load in-bounds.
        std::vector<uint16_t> wpad((size_t)nwords + (size_t)N + 16, 0);
        memcpy(wpad.data(), in + o2, (size_t)nwords * 2);
        int64_t K = (n + N - 1) / N;
        std::vector<uint32_t> x(N);
        for (int l = 0; l < N; l++)
            x[l] = ((uint32_t)wpad[2 * l] << 16) | wpad[2 * l + 1];
        std::vector<uint8_t> plane((size_t)K * N, 0);
        int64_t p = rans_decode_core_avx512(plane.data(), n, K, N, order,
                                            tab.data(), x.data(), wpad.data(),
                                            nwords, 2 * N);
        if (p < 0) return -2;
        rans_transpose_out(plane.data(), n, K, N, out);
        return n;
    }
#endif

    std::vector<uint32_t> freq, cum;
    std::vector<uint8_t> slot2sym;

    if (order == 0) {
        freq.resize(256); cum.resize(256);
        off += freqs_deserialize(in + off, freq.data());
        uint32_t c = 0;
        slot2sym.resize(SCALE);
        for (int s = 0; s < 256; s++) {
            cum[s] = c;
            for (uint32_t j = 0; j < freq[s]; j++) slot2sym[c + j] = (uint8_t)s;
            c += freq[s];
        }
    } else {
        uint32_t rawlen, clen;
        memcpy(&rawlen, in + off, 4);
        memcpy(&clen, in + off + 4, 4);
        off += 8;
        std::vector<uint8_t> raw(rawlen);
        uLongf rl = rawlen;
        if (uncompress(raw.data(), &rl, in + off, clen) != Z_OK) return -1;
        off += clen;
        freq.assign(256 * 256, 0); cum.assign(256 * 256, 0);
        slot2sym.assign((size_t)256 * SCALE, 0);
        size_t o2 = 32;
        for (int c0 = 0; c0 < 256; c0++) {
            if (!(raw[c0 >> 3] & (1u << (c0 & 7)))) {
                continue;
            }
            size_t used = freqs_deserialize(raw.data() + o2, &freq[(size_t)c0 * 256]);
            o2 += used;
            uint32_t cc = 0;
            for (int s = 0; s < 256; s++) {
                cum[(size_t)c0 * 256 + s] = cc;
                for (uint32_t j = 0; j < freq[(size_t)c0 * 256 + s]; j++)
                    slot2sym[(size_t)c0 * SCALE + cc + j] = (uint8_t)s;
                cc += freq[(size_t)c0 * 256 + s];
            }
        }
    }

    const uint16_t* words = (const uint16_t*)(in + off);
    int64_t nwords = (in_len - (int64_t)off) / 2;
    // K from the HEADER's lane count — streams from other encoders (device
    // kernels) may use a different N than this encoder's heuristic picks
    int64_t K = n > 0 ? (n + N - 1) / N : 0;

    std::vector<uint32_t> x(N);
    for (int l = 0; l < N; l++)
        x[l] = ((uint32_t)words[2 * l] << 16) | words[2 * l + 1];
    int64_t p = 2 * N;

    // decode into a row-major (K, N) plane (sequential writes), then do a
    // cache-blocked transpose into the lane-chunk output layout
    std::vector<uint8_t> plane((size_t)K * N);
    std::vector<uint8_t> ctxv(N, 0);
    for (int64_t t = 0; t < K; t++) {
        uint8_t* row = &plane[(size_t)t * N];
        for (int l = 0; l < N; l++) {
            int64_t i = (int64_t)l * K + t;
            int64_t lane_end = std::min((int64_t)(l + 1) * K, n);
            if (i >= lane_end) { row[l] = 0; continue; }
            uint32_t xx = x[l];
            uint32_t slot = xx & (SCALE - 1);
            uint8_t s;
            uint32_t f, c;
            if (order == 0) {
                s = slot2sym[slot];
                f = freq[s]; c = cum[s];
            } else {
                uint8_t cc0 = ctxv[l];
                s = slot2sym[(size_t)cc0 * SCALE + slot];
                f = freq[(size_t)cc0 * 256 + s];
                c = cum[(size_t)cc0 * 256 + s];
                ctxv[l] = s;
            }
            xx = f * (xx >> SCALE_BITS) + slot - c;
            if (xx < RANS_L) {
                if (p >= nwords) return -2;
                xx = (xx << 16) | words[p++];
            }
            x[l] = xx;
            row[l] = s;
        }
    }
    // blocked transpose: out[l*K + t] = plane[t*N + l]
    constexpr int64_t B = 64;
    for (int64_t t0 = 0; t0 < K; t0 += B)
        for (int64_t l0 = 0; l0 < N; l0 += B) {
            int64_t t1 = std::min(t0 + B, K), l1 = std::min(l0 + B, (int64_t)N);
            for (int64_t l = l0; l < l1; l++) {
                int64_t lane_end = std::min((int64_t)(l + 1) * K, n);
                int64_t tmax = std::min(t1, lane_end - l * K);
                for (int64_t t = t0; t < tmax; t++)
                    out[l * K + t] = plane[(size_t)t * N + l];
            }
        }
    return n;
}

// ---------------------------------------------------------------------------
// zlib-format one-shot compress/decompress via libdeflate (~2-3x stdlib
// zlib; output is a standard zlib stream readable by zlib.decompress).
// ---------------------------------------------------------------------------
int64_t gxz_zlib_compress(const uint8_t* in, int64_t n, int level,
                          uint8_t* out, int64_t cap) {
    struct libdeflate_compressor* c =
        libdeflate_alloc_compressor(level < 1 ? 1 : (level > 12 ? 12 : level));
    if (!c) return -1;
    size_t w = libdeflate_zlib_compress(c, in, (size_t)n, out, (size_t)cap);
    libdeflate_free_compressor(c);
    return w ? (int64_t)w : -2;
}

int64_t gxz_zlib_decompress(const uint8_t* in, int64_t n, uint8_t* out,
                            int64_t out_len) {
    struct libdeflate_decompressor* d = libdeflate_alloc_decompressor();
    if (!d) return -1;
    size_t actual = 0;
    int rc = libdeflate_zlib_decompress(d, in, (size_t)n, out,
                                        (size_t)out_len, &actual);
    libdeflate_free_decompressor(d);
    return rc == LIBDEFLATE_SUCCESS ? (int64_t)actual : -2;
}

// ---------------------------------------------------------------------------
// Byte histogram (np.bincount replacement: no intp promotion / 8x temp).
// 4-way split tables break the store-forward dependency chain.
// ---------------------------------------------------------------------------
void gxz_byte_hist(const uint8_t* data, int64_t n, int64_t* out) {
    int64_t h4[4][256] = {{0}};
    int64_t i = 0;
    for (; i + 4 <= n; i += 4) {
        h4[0][data[i]]++; h4[1][data[i + 1]]++;
        h4[2][data[i + 2]]++; h4[3][data[i + 3]]++;
    }
    for (; i < n; i++) h4[0][data[i]]++;
    for (int s = 0; s < 256; s++)
        out[s] = h4[0][s] + h4[1][s] + h4[2][s] + h4[3][s];
}

// ---------------------------------------------------------------------------
// BAM record scan: walk the alignment-record chain, filling record offsets
// (relative to `data`) and sizes. Returns record count, or -1 if truncated
// mid-record. `data` points at the first alignment record (after header).
// ---------------------------------------------------------------------------
int64_t gxz_bam_scan(const uint8_t* data, int64_t len, int64_t* offsets,
                     int64_t max_records, int64_t* consumed) {
    int64_t off = 0, cnt = 0;
    while (off + 4 <= len && cnt < max_records) {
        uint32_t block_size;
        memcpy(&block_size, data + off, 4);
        if (off + 4 + (int64_t)block_size > len) break;
        offsets[cnt++] = off;
        off += 4 + block_size;
    }
    *consumed = off;
    return cnt;
}

// ---------------------------------------------------------------------------
// PBWT encode/decode (reference src/codec_pbwt.c; Durbin's algorithm with a
// stable counting sort per variant row). A[n][H] row-major uint8.
// ---------------------------------------------------------------------------
void gxz_pbwt_encode(const uint8_t* A, int64_t n, int64_t H, uint8_t* Y) {
    std::vector<int32_t> perm(H), nperm(H);
    for (int64_t j = 0; j < H; j++) perm[j] = (int32_t)j;
    std::vector<int64_t> cnt(257);
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* row = A + i * H;
        uint8_t* y = Y + i * H;
        for (int64_t j = 0; j < H; j++) y[j] = row[perm[j]];
        // stable counting sort of perm by y
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int64_t j = 0; j < H; j++) cnt[y[j] + 1]++;
        for (int k = 1; k <= 256; k++) cnt[k] += cnt[k - 1];
        for (int64_t j = 0; j < H; j++) nperm[cnt[y[j]]++] = perm[j];
        perm.swap(nperm);
    }
}

void gxz_pbwt_decode(const uint8_t* Y, int64_t n, int64_t H, uint8_t* A) {
    std::vector<int32_t> perm(H), nperm(H);
    for (int64_t j = 0; j < H; j++) perm[j] = (int32_t)j;
    std::vector<int64_t> cnt(257);
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* y = Y + i * H;
        uint8_t* row = A + i * H;
        for (int64_t j = 0; j < H; j++) row[perm[j]] = y[j];
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int64_t j = 0; j < H; j++) cnt[y[j] + 1]++;
        for (int k = 1; k <= 256; k++) cnt[k] += cnt[k - 1];
        for (int64_t j = 0; j < H; j++) nperm[cnt[y[j]]++] = perm[j];
        perm.swap(nperm);
    }
}

// ---------------------------------------------------------------------------
// Ragged range copy: for each row i, copy lens[i] bytes from
// src + src_starts[i] to dst + dst_starts[i]. The backbone of all ragged
// column ops (gather/scatter/interleave) — one pass, no index
// materialization (numpy needed an 8x-sized index array).
// ---------------------------------------------------------------------------
void gxz_copy_ranges(const uint8_t* src, const int64_t* src_starts,
                     uint8_t* dst, const int64_t* dst_starts,
                     const int64_t* lens, int64_t n,
                     int64_t src_size, int64_t dst_size, int packed) {
    if (packed) {
        // ragged columns are mostly tiny rows (VCF cells, SAM fields); a
        // fixed 16-byte copy beats memcpy's length dispatch. Safe ONLY for
        // packed ascending gathers (dst row i+1 starts at dst row i's end):
        // spill into the next row's span is overwritten by the next
        // iteration. NOT safe for scatter (interleave) callers.
        for (int64_t i = 0; i < n; i++) {
            int64_t l = lens[i], ss = src_starts[i], ds = dst_starts[i];
            if (l <= 16 && ss + 16 <= src_size && ds + 16 <= dst_size)
                memcpy(dst + ds, src + ss, 16);
            else
                memcpy(dst + ds, src + ss, (size_t)l);
        }
        return;
    }
    for (int64_t i = 0; i < n; i++)
        memcpy(dst + dst_starts[i], src + src_starts[i], (size_t)lens[i]);
}

// ---------------------------------------------------------------------------
// Per-row stats of strict comma-int lists "int(,int)*" (VCF AD/PL cells;
// reference src/vcf_gatk.c DP=sum(AD), GQ=PL2-PL1).  Keep-rules match the
// tokenizer spec exactly (ZIP pred == PIZ recompute): each segment is 1..18
// digits, no leading zero unless single digit.  ok=0 rows report all zeros
// except min1/min2 = INT64_MAX.  min2 counts duplicates (two equal minima
// -> min2 == min1), matching the mask-first-occurrence numpy formulation.
// ---------------------------------------------------------------------------
void gxz_int_list_stats(const uint8_t* data, const int64_t* offsets,
                        int64_t C, int64_t* sums, int64_t* min1,
                        int64_t* min2, int32_t* nvals, uint8_t* ok) {
    for (int64_t i = 0; i < C; i++) {
        int64_t p = offsets[i], end = offsets[i + 1];
        int64_t s = 0, m1 = INT64_MAX, m2 = INT64_MAX;
        int32_t k = 0;
        bool good = p < end;
        while (good && p < end) {
            int64_t st = p;
            int64_t v = 0;
            while (p < end && data[p] >= '0' && data[p] <= '9') {
                v = v * 10 + (data[p] - '0');
                p++;
            }
            int64_t dl = p - st;
            if (dl < 1 || dl > 18 || (dl > 1 && data[st] == '0')) {
                good = false;
                break;
            }
            k++;
            s += v;
            if (v < m1) { m2 = m1; m1 = v; }
            else if (v < m2) m2 = v;
            if (p < end) {
                if (data[p] != ',') { good = false; break; }
                p++;
                if (p == end) { good = false; break; }  // trailing comma
            }
        }
        if (good) {
            sums[i] = s; min1[i] = m1; min2[i] = m2;
            nvals[i] = k; ok[i] = 1;
        } else {
            sums[i] = 0; min1[i] = INT64_MAX; min2[i] = INT64_MAX;
            nvals[i] = 0; ok[i] = 0;
        }
    }
}

// ---------------------------------------------------------------------------
// Join consecutive ragged subfields into cells with a separator: cell i is
// subs[first..first+nsub[i]) joined by `sep` (the VCF sample-matrix ':'
// glue, vcf_samples.c reconstruction role).  out must be pre-sized to
// sum(lens) + sum(max(nsub-1,0)); cell_off gets C+1 offsets.
// ---------------------------------------------------------------------------
void gxz_join_cells(const uint8_t* data, const int64_t* offsets,
                    const int32_t* nsub, int64_t C, uint8_t sep,
                    uint8_t* out, int64_t* cell_off) {
    int64_t w = 0, s = 0;
    cell_off[0] = 0;
    for (int64_t i = 0; i < C; i++) {
        int32_t k = nsub[i];
        for (int32_t j = 0; j < k; j++, s++) {
            int64_t len = offsets[s + 1] - offsets[s];
            memcpy(out + w, data + offsets[s], (size_t)len);
            w += len;
            if (j + 1 < k) out[w++] = sep;
        }
        cell_off[i + 1] = w;
    }
}

// ---------------------------------------------------------------------------
// Flat parse of strict comma-int lists (same keep-rules as
// gxz_int_list_stats): values of OK rows written consecutively to `vals`,
// nvals[i] = count for OK rows else 0.  total[0] = values written.  `vals`
// must have room for (comma count + C) entries.
// ---------------------------------------------------------------------------
void gxz_int_list_parse(const uint8_t* data, const int64_t* offsets,
                        int64_t C, int64_t* vals, int32_t* nvals,
                        uint8_t* ok, int64_t* total) {
    int64_t w = 0;
    for (int64_t i = 0; i < C; i++) {
        int64_t p = offsets[i], end = offsets[i + 1];
        int64_t w0 = w;
        int32_t k = 0;
        bool good = p < end;
        while (good && p < end) {
            int64_t st = p;
            int64_t v = 0;
            while (p < end && data[p] >= '0' && data[p] <= '9') {
                v = v * 10 + (data[p] - '0');
                p++;
            }
            int64_t dl = p - st;
            if (dl < 1 || dl > 18 || (dl > 1 && data[st] == '0')) {
                good = false;
                break;
            }
            vals[w++] = v;
            k++;
            if (p < end) {
                if (data[p] != ',') { good = false; break; }
                p++;
                if (p == end) { good = false; break; }  // trailing comma
            }
        }
        if (good) {
            nvals[i] = k; ok[i] = 1;
        } else {
            w = w0;  // discard the row's partial values
            nvals[i] = 0; ok[i] = 0;
        }
    }
    total[0] = w;
}

// ---------------------------------------------------------------------------
// One-pass ragged field split (VCF FORMAT cells, sub-field lists): for each
// row, split on `sep` into at most T fields; field t of row i goes to
// f_start[t*C+i] / f_len[t*C+i] (tag-major so each tag's ranges are a
// contiguous slice).  nfields[i] = number of fields in row i (capped T+1 to
// signal overflow).  Replaces the colon-position nonzero/cumsum/fancy-index
// machinery (reference src/vcf_samples.c:1601 per-tag walk).
// ---------------------------------------------------------------------------
void gxz_split_fields(const uint8_t* data, const int64_t* offsets, int64_t C,
                      uint8_t sep, int T, int64_t* f_start, int32_t* f_len,
                      int32_t* nfields) {
    for (int64_t t = 0; t < (int64_t)T; t++) {
        int64_t* fs = f_start + t * C;
        int32_t* fl = f_len + t * C;
        memset(fl, 0, (size_t)C * 4);
        // start defaults matter only where len>0; leave fs uninitialized
        (void)fs;
    }
    for (int64_t i = 0; i < C; i++) {
        int64_t p = offsets[i], end = offsets[i + 1];
        if (p == end) { nfields[i] = 0; continue; }
        int t = 0;
        int64_t st = p;
        while (p < end && t < T) {
            if (data[p] == sep) {
                f_start[(size_t)t * C + i] = st;
                f_len[(size_t)t * C + i] = (int32_t)(p - st);
                t++;
                st = p + 1;
            }
            p++;
        }
        if (t < T) {
            f_start[(size_t)t * C + i] = st;
            f_len[(size_t)t * C + i] = (int32_t)(end - st);
            nfields[i] = t + 1;
        } else {
            nfields[i] = T + 1;  // overflow: more fields than T
        }
    }
}

// ---------------------------------------------------------------------------
// One-pass tokenizer scan (hot half of seg.py tokenizer_seg_col): per row,
// replace numeric digit-runs with a 0x01 placeholder in the template and emit
// their values (row-major). Keep rules match the python spec: run length
// <= 18, token index < max_tokens; zero-padded runs ARE kept, with the run
// width emitted so recon can re-pad (the reference's fixed-width flavor
// items, qname_flavors.h — BGI-style names zero-pad every field).
// Returns the number of emitted values; *tmpl_total gets the template bytes.
// ---------------------------------------------------------------------------
int64_t gxz_tokenize(const uint8_t* data, const int64_t* row_off, int64_t nrows,
                     int64_t max_tokens, uint8_t* tmpl, int64_t* tmpl_lens,
                     int64_t* values, int32_t* tok_idx, int64_t* tmpl_total,
                     uint8_t* widths) {
    int64_t nv = 0;
    int64_t tp = 0;
    for (int64_t r = 0; r < nrows; r++) {
        const uint8_t* p = data + row_off[r];
        int64_t len = row_off[r + 1] - row_off[r];
        int64_t tstart = tp;
        int32_t tok = 0;
        int64_t i = 0;
        while (i < len) {
            uint8_t c = p[i];
            if (c >= '0' && c <= '9') {
                int64_t j = i + 1;
                while (j < len && p[j] >= '0' && p[j] <= '9') j++;
                int64_t rl = j - i;
                bool keep = rl <= 18 && tok < max_tokens;
                if (keep) {
                    int64_t v = 0;
                    for (int64_t k = i; k < j; k++) v = v * 10 + (p[k] - '0');
                    values[nv] = v;
                    widths[nv] = (uint8_t)rl;
                    tok_idx[nv++] = tok++;
                    tmpl[tp++] = 0x01;
                } else {
                    memcpy(tmpl + tp, p + i, (size_t)rl);
                    tp += rl;
                }
                i = j;
            } else {
                tmpl[tp++] = c;
                i++;
            }
        }
        tmpl_lens[r] = tp - tstart;
    }
    *tmpl_total = tp;
    return nv;
}

// ---------------------------------------------------------------------------
// ACGT one-pass pack/unpack (reference src/codec_acgt.c): 2-bit codes packed
// 4/byte little-endian-within-byte; non-ACGT positions+bytes to exception
// channels. Returns exception count.
// ---------------------------------------------------------------------------
int64_t gxz_acgt_pack(const uint8_t* seq, int64_t n, uint8_t* packed,
                      uint32_t* exc_pos, uint8_t* exc_bytes) {
    static uint8_t code[256];
    static bool init = false;
    if (!init) {
        memset(code, 0xFF, 256);
        code['A'] = 0; code['C'] = 1; code['G'] = 2; code['T'] = 3;
        init = true;
    }
    int64_t ne = 0;
    int64_t nb = (n + 3) / 4;
    memset(packed, 0, (size_t)nb);
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = code[seq[i]];
        if (c == 0xFF) {
            exc_pos[ne] = (uint32_t)i;
            exc_bytes[ne++] = seq[i];
            c = 0;
        }
        packed[i >> 2] |= (uint8_t)(c << ((i & 3) * 2));
    }
    return ne;
}

void gxz_acgt_unpack(const uint8_t* packed, int64_t n, const uint32_t* exc_pos,
                     const uint8_t* exc_bytes, int64_t ne, uint8_t* out) {
    static const uint8_t ACGT[4] = {'A', 'C', 'G', 'T'};
    for (int64_t i = 0; i < n; i++)
        out[i] = ACGT[(packed[i >> 2] >> ((i & 3) * 2)) & 3];
    for (int64_t e = 0; e < ne; e++)
        out[exc_pos[e]] = exc_bytes[e];
}

// adler32 passthrough (zlib's is fast)
// inverse-BWT LF-mapping walk (codecs/bwt.py): the only serial step of
// the BWT codec — a plain n-step permutation chase
void gxz_bwt_walk(const int64_t* lf, const int64_t* li, int64_t prim,
                  int64_t n, uint8_t* out) {
    int64_t i = prim;
    for (int64_t k = n - 1; k >= 0; k--) {
        i = lf[i];
        out[k] = (uint8_t)(li[i] - 1);
    }
}

// XXH64 (public spec; the reference's default per-VB/file digest since
// 15.0.81 is XXH3 — we standardize on XXH64: same 64-bit collision
// resistance class, far above the 32-bit adler it replaces here).
namespace {
constexpr uint64_t XP1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t XP2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t XP3 = 0x165667B19E3779F9ULL;
constexpr uint64_t XP4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t XP5 = 0x27D4EB2F165667C5ULL;
inline uint64_t xrotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xread64(const uint8_t* p) {
    uint64_t v; memcpy(&v, p, 8); return v;   // little-endian host
}
inline uint32_t xread32(const uint8_t* p) {
    uint32_t v; memcpy(&v, p, 4); return v;
}
inline uint64_t xround(uint64_t acc, uint64_t input) {
    acc += input * XP2; acc = xrotl(acc, 31); return acc * XP1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t val) {
    acc ^= xround(0, val); return acc * XP1 + XP4;
}
}  // namespace

uint64_t gxz_xxh64(uint64_t seed, const uint8_t* p, int64_t len) {
    const uint8_t* end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = seed + XP1 + XP2, v2 = seed + XP2, v3 = seed,
                 v4 = seed - XP1;
        const uint8_t* limit = end - 32;
        do {
            v1 = xround(v1, xread64(p)); p += 8;
            v2 = xround(v2, xread64(p)); p += 8;
            v3 = xround(v3, xread64(p)); p += 8;
            v4 = xround(v4, xread64(p)); p += 8;
        } while (p <= limit);
        h = xrotl(v1, 1) + xrotl(v2, 7) + xrotl(v3, 12) + xrotl(v4, 18);
        h = xmerge(h, v1); h = xmerge(h, v2);
        h = xmerge(h, v3); h = xmerge(h, v4);
    } else {
        h = seed + XP5;
    }
    h += (uint64_t)len;
    while (p + 8 <= end) {
        h ^= xround(0, xread64(p));
        h = xrotl(h, 27) * XP1 + XP4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= (uint64_t)xread32(p) * XP1;
        h = xrotl(h, 23) * XP2 + XP3;
        p += 4;
    }
    while (p < end) {
        h ^= (*p++) * XP5;
        h = xrotl(h, 11) * XP1;
    }
    h ^= h >> 33; h *= XP2; h ^= h >> 29; h *= XP3; h ^= h >> 32;
    return h;
}

uint32_t gxz_adler32(uint32_t seed, const uint8_t* data, int64_t len) {
    return (uint32_t)adler32(seed, data, (uInt)len);
}

// ---------------------------------------------------------------------------
// AES-256-CTR (reference parity: src/aes.c / src/crypt.c — section-payload
// encryption). Plain byte-oriented AES; CTR keystream XOR in place.
// ---------------------------------------------------------------------------
namespace aes {

static const uint8_t SBOX[256] = {
0x63,0x7c,0x77,0x7b,0xf2,0x6b,0x6f,0xc5,0x30,0x01,0x67,0x2b,0xfe,0xd7,0xab,0x76,
0xca,0x82,0xc9,0x7d,0xfa,0x59,0x47,0xf0,0xad,0xd4,0xa2,0xaf,0x9c,0xa4,0x72,0xc0,
0xb7,0xfd,0x93,0x26,0x36,0x3f,0xf7,0xcc,0x34,0xa5,0xe5,0xf1,0x71,0xd8,0x31,0x15,
0x04,0xc7,0x23,0xc3,0x18,0x96,0x05,0x9a,0x07,0x12,0x80,0xe2,0xeb,0x27,0xb2,0x75,
0x09,0x83,0x2c,0x1a,0x1b,0x6e,0x5a,0xa0,0x52,0x3b,0xd6,0xb3,0x29,0xe3,0x2f,0x84,
0x53,0xd1,0x00,0xed,0x20,0xfc,0xb1,0x5b,0x6a,0xcb,0xbe,0x39,0x4a,0x4c,0x58,0xcf,
0xd0,0xef,0xaa,0xfb,0x43,0x4d,0x33,0x85,0x45,0xf9,0x02,0x7f,0x50,0x3c,0x9f,0xa8,
0x51,0xa3,0x40,0x8f,0x92,0x9d,0x38,0xf5,0xbc,0xb6,0xda,0x21,0x10,0xff,0xf3,0xd2,
0xcd,0x0c,0x13,0xec,0x5f,0x97,0x44,0x17,0xc4,0xa7,0x7e,0x3d,0x64,0x5d,0x19,0x73,
0x60,0x81,0x4f,0xdc,0x22,0x2a,0x90,0x88,0x46,0xee,0xb8,0x14,0xde,0x5e,0x0b,0xdb,
0xe0,0x32,0x3a,0x0a,0x49,0x06,0x24,0x5c,0xc2,0xd3,0xac,0x62,0x91,0x95,0xe4,0x79,
0xe7,0xc8,0x37,0x6d,0x8d,0xd5,0x4e,0xa9,0x6c,0x56,0xf4,0xea,0x65,0x7a,0xae,0x08,
0xba,0x78,0x25,0x2e,0x1c,0xa6,0xb4,0xc6,0xe8,0xdd,0x74,0x1f,0x4b,0xbd,0x8b,0x8a,
0x70,0x3e,0xb5,0x66,0x48,0x03,0xf6,0x0e,0x61,0x35,0x57,0xb9,0x86,0xc1,0x1d,0x9e,
0xe1,0xf8,0x98,0x11,0x69,0xd9,0x8e,0x94,0x9b,0x1e,0x87,0xe9,0xce,0x55,0x28,0xdf,
0x8c,0xa1,0x89,0x0d,0xbf,0xe6,0x42,0x68,0x41,0x99,0x2d,0x0f,0xb0,0x54,0xbb,0x16};

static const uint8_t RCON[15] = {0x00,0x01,0x02,0x04,0x08,0x10,0x20,0x40,
                                 0x80,0x1b,0x36,0x6c,0xd8,0xab,0x4d};

struct Ctx { uint8_t rk[15][16]; };

inline uint8_t xtime(uint8_t x) { return (uint8_t)((x << 1) ^ ((x >> 7) * 0x1b)); }

void key_expand(const uint8_t key[32], Ctx& c) {
    uint8_t w[60][4];
    memcpy(w, key, 32);
    for (int i = 8; i < 60; i++) {
        uint8_t t[4] = {w[i-1][0], w[i-1][1], w[i-1][2], w[i-1][3]};
        if (i % 8 == 0) {
            uint8_t tmp = t[0];
            t[0] = (uint8_t)(SBOX[t[1]] ^ RCON[i / 8]);
            t[1] = SBOX[t[2]]; t[2] = SBOX[t[3]]; t[3] = SBOX[tmp];
        } else if (i % 8 == 4) {
            for (int j = 0; j < 4; j++) t[j] = SBOX[t[j]];
        }
        for (int j = 0; j < 4; j++) w[i][j] = (uint8_t)(w[i-8][j] ^ t[j]);
    }
    memcpy(c.rk, w, 240);
}

void encrypt_block(const Ctx& c, const uint8_t in[16], uint8_t out[16]) {
    uint8_t s[16];
    for (int i = 0; i < 16; i++) s[i] = (uint8_t)(in[i] ^ c.rk[0][i]);
    for (int round = 1; round <= 14; round++) {
        uint8_t t[16];
        // SubBytes + ShiftRows
        for (int col = 0; col < 4; col++)
            for (int row = 0; row < 4; row++)
                t[col * 4 + row] = SBOX[s[((col + row) % 4) * 4 + row]];
        if (round < 14) {  // MixColumns
            for (int col = 0; col < 4; col++) {
                uint8_t* a = t + col * 4;
                uint8_t e = (uint8_t)(a[0] ^ a[1] ^ a[2] ^ a[3]);
                uint8_t a0 = a[0];
                uint8_t m0 = (uint8_t)(a[0] ^ e ^ xtime((uint8_t)(a[0] ^ a[1])));
                uint8_t m1 = (uint8_t)(a[1] ^ e ^ xtime((uint8_t)(a[1] ^ a[2])));
                uint8_t m2 = (uint8_t)(a[2] ^ e ^ xtime((uint8_t)(a[2] ^ a[3])));
                uint8_t m3 = (uint8_t)(a[3] ^ e ^ xtime((uint8_t)(a[3] ^ a0)));
                a[0] = m0; a[1] = m1; a[2] = m2; a[3] = m3;
            }
        }
        for (int i = 0; i < 16; i++) s[i] = (uint8_t)(t[i] ^ c.rk[round][i]);
    }
    memcpy(out, s, 16);
}

}  // namespace aes

// XOR data in place with the AES-256-CTR keystream. counter0 is the 16-byte
// initial counter block; incremented big-endian per block.
void gxz_aes256_ctr(const uint8_t* key, const uint8_t* counter0,
                    uint8_t* data, int64_t len) {
    aes::Ctx c;
    aes::key_expand(key, c);
    uint8_t ctr[16], ks[16];
    memcpy(ctr, counter0, 16);
    for (int64_t off = 0; off < len; off += 16) {
        aes::encrypt_block(c, ctr, ks);
        int64_t m = std::min((int64_t)16, len - off);
        for (int64_t j = 0; j < m; j++) data[off + j] ^= ks[j];
        for (int i = 15; i >= 0; i--)
            if (++ctr[i] != 0) break;
    }
}

// 64-bit per-row hash of a ragged byte column (8-byte blocks + mix), for
// vectorized dictionary dedup (collisions detected by gxz_rows_equal_rep).
void gxz_row_hash(const uint8_t* data, const int64_t* offsets, int64_t n,
                  uint64_t* out) {
    for (int64_t i = 0; i < n; i++) {
        int64_t p = offsets[i], end = offsets[i + 1];
        uint64_t h = 0x9E3779B97F4A7C15ull ^ (uint64_t)(end - p);
        while (p + 8 <= end) {
            uint64_t w;
            memcpy(&w, data + p, 8);
            h = (h ^ w) * 0x100000001B3ull;
            h ^= h >> 29;
            p += 8;
        }
        uint64_t w = 0;
        for (int j = 0; p < end; p++, j += 8) w |= (uint64_t)data[p] << j;
        h = (h ^ w) * 0x100000001B3ull;
        h ^= h >> 31;
        h *= 0xBF58476D1CE4E5B9ull;
        h ^= h >> 29;
        out[i] = h;
    }
}

// 1 if every row equals its representative row (rep[i] = row index), else 0.
int gxz_rows_equal_rep(const uint8_t* data, const int64_t* offsets,
                       const int64_t* rep, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        int64_t r = rep[i];
        int64_t la = offsets[i + 1] - offsets[i];
        int64_t lb = offsets[r + 1] - offsets[r];
        if (la != lb) return 0;
        if (la && memcmp(data + offsets[i], data + offsets[r], (size_t)la))
            return 0;
    }
    return 1;
}

// ---------------------------------------------------------------------------
// ARITH-W32: wide-interleaved adaptive range coder. Bit-exact twin of the
// numpy spec in ops/arith_np.py (the arith_dynamic.c role, redesigned as N
// lockstep carryless Subbotin lanes sharing ONE adaptive model with batched
// per-step updates). Model storage here is freq[] + a lazily-rebuilt
// exclusive-prefix snapshot per context — same values, faster walk.

namespace arith {

constexpr uint32_t A_TOP = 1u << 24, A_BOT = 1u << 16;
constexpr uint32_t A_INC = 24, A_MAX_TOTAL = 1u << 15;

int a_choose_log_lanes(int64_t n) {
    if (n < (1 << 12)) return 4;
    if (n < (1 << 18)) return 6;
    return 8;
}

// Model storage is freq[] + a lazily-rebuilt exclusive-prefix snapshot per
// context: freq is always >= 1, so the snapshot is strictly increasing and
// symbol search is a contiguous upper_bound (cache-friendly, branch-light);
// a context pays the 256-add rebuild only on its first use after an update
// (amortized ~1 op/byte at N=256 lanes for order-0 / small-alphabet order-1).
struct Model {
    int nctx;
    std::vector<uint32_t> freq;    // nctx*256
    std::vector<uint32_t> total;   // nctx
    std::vector<uint32_t> pre;     // nctx*257 exclusive prefix (lazy)
    std::vector<uint8_t> dirty;    // per-context: pre[] is stale
    std::vector<uint8_t> start;    // nctx*256 bucket->first-symbol (lazy)
    std::vector<uint8_t> bsh;      // nctx: bucket shift (total-1)>>bsh<256

    explicit Model(int order) : nctx(order ? 256 : 1),
        freq((size_t)nctx * 256, 1), total(nctx, 256),
        pre((size_t)nctx * 257, 0), dirty(nctx, 3),
        start((size_t)nctx * 256, 0), bsh(nctx, 0) {}
    // dirty bit 0: pre[] stale (encode+decode); bit 1: start[] stale
    // (decode-only — the encoder never searches, so it must not pay the
    // bucket-table rebuild)
    inline const uint32_t* snap(int c) {
        uint32_t* p = &pre[(size_t)c * 257];
        if (dirty[c] & 1) {
            const uint32_t* f = &freq[(size_t)c * 256];
            uint32_t acc = 0;
            for (int i = 0; i < 256; i++) { p[i] = acc; acc += f[i]; }
            p[256] = acc;
            dirty[c] &= ~1;
        }
        return p;
    }
    inline void add(int c, int s, uint32_t d) {
        freq[(size_t)c * 256 + s] += d;
        total[c] += d;
        dirty[c] = 3;
    }
    // largest sym with prefix(sym) <= v; sets cum = prefix(sym).
    // p = snap(c). Bucket table turns the per-symbol binary search into a
    // short linear walk; rebuilt lazily per context.
    inline int search_ctx(int c, const uint32_t* p, uint32_t v,
                          uint32_t* cum) {
        uint8_t* st = &start[(size_t)c * 256];
        if (dirty[c] & 2) {
            uint32_t tot = p[256];
            int sh = 0;
            while ((uint64_t)(tot - 1) >> sh >= 256) sh++;
            bsh[c] = (uint8_t)sh;
            int s = 0;
            for (int b = 0; b < 256; b++) {
                uint32_t v0 = (uint32_t)b << sh;
                while (s < 255 && p[s + 1] <= v0) s++;
                st[b] = (uint8_t)s;
            }
            dirty[c] &= ~2;
        }
        int s = st[v >> bsh[c]];
        while (s < 255 && p[s + 1] <= v) s++;
        *cum = p[s];
        return s;
    }
    // p = snap(c): strictly increasing, p[0]=0, p[256]=total.
    static inline int search(const uint32_t* p, uint32_t v, uint32_t* cum) {
        int lo = 0, hi = 255;            // invariant: p[lo] <= v < p[hi+1]
        while (lo < hi) {
            int mid = (lo + hi + 1) >> 1;
            if (p[mid] <= v) lo = mid; else hi = mid - 1;
        }
        *cum = p[lo];
        return lo;
    }
    void rescale(int c) {
        while (total[c] > A_MAX_TOTAL) {
            uint32_t* f = &freq[(size_t)c * 256];
            uint32_t tot = 0;
            for (int i = 0; i < 256; i++) { f[i] = (f[i] + 1) >> 1; tot += f[i]; }
            total[c] = tot;
        }
        dirty[c] = 3;
    }
};

}  // namespace arith

int64_t gxz_arith_encode(const uint8_t* data, int64_t n, int order,
                         uint8_t* out, int64_t cap) {
    using namespace arith;
    int logN = a_choose_log_lanes(n);
    int N = 1 << logN;
    int64_t K = n > 0 ? (n + N - 1) / N : 0;
    std::vector<int64_t> lane_len(N);
    for (int l = 0; l < N; l++) {
        int64_t v = n - (int64_t)l * K;
        lane_len[l] = v < 0 ? 0 : (v > K ? K : v);
    }
    std::vector<uint32_t> low(N, 0), rng(N, 0xFFFFFFFFu);
    std::vector<std::vector<uint8_t>> lane_bytes(N);
    std::vector<uint8_t> ev;              // global event order: lane ids
    Model model(order);
    std::vector<uint8_t> syms(N), ctxs(N);
    std::vector<int> dirty;
    // per-step shared reciprocals: lanes in the same context at the same
    // step divide by the same total — one magic per distinct context
    std::vector<Magic> mag(model.nctx);
    std::vector<int64_t> mag_gen(model.nctx, -1);
    std::vector<int> active(N), pend(N);
    ev.reserve((size_t)n / 2 + 64);

    for (int64_t t = 0; t < K; t++) {
        int na = 0;
        for (int l = 0; l < N; l++)
            if (t < lane_len[l]) active[na++] = l;   // lane_len non-increasing
        for (int ai = 0; ai < na; ai++) {
            int l = active[ai];
            uint8_t s = data[(int64_t)l * K + t];
            uint8_t cx = (order && t) ? data[(int64_t)l * K + t - 1] : 0;
            syms[l] = s; ctxs[l] = cx;
            uint32_t tot = model.total[cx];
            if (mag_gen[cx] != t) { mag[cx] = make_magic(tot); mag_gen[cx] = t; }
            uint32_t f = model.freq[(size_t)cx * 256 + s];
            uint32_t c = model.snap(cx)[s];
            uint32_t r = magic_div(rng[l], mag[cx], tot);
            low[l] += c * r;
            rng[l] = f * r;
        }
        // renorm, iteration-major (same byte interleave as the numpy spec):
        // each pass keeps only the lanes that still renorm
        int np_ = na;
        int* cur = active.data();
        int* nxt = pend.data();
        while (np_) {
            int nn = 0;
            for (int i = 0; i < np_; i++) {
                int l = cur[i];
                uint32_t lo = low[l], rg = rng[l];
                bool c1 = ((lo ^ (lo + rg)) < A_TOP), c2 = rg < A_BOT;
                if (!(c1 || c2)) continue;
                if (!c1) rng[l] = (0u - lo) & (A_BOT - 1);
                lane_bytes[l].push_back((uint8_t)(lo >> 24));
                ev.push_back((uint8_t)l);
                low[l] <<= 8; rng[l] <<= 8;
                nxt[nn++] = l;
            }
            np_ = nn;
            std::swap(cur, nxt);
        }
        dirty.clear();
        for (int l = 0; l < N; l++) {
            if (t >= lane_len[l]) continue;
            int cx = order ? ctxs[l] : 0;
            model.add(cx, syms[l], A_INC);
            if (model.total[cx] > A_MAX_TOTAL) dirty.push_back(cx);
        }
        for (int cx : dirty)
            if (model.total[cx] > A_MAX_TOTAL) model.rescale(cx);
    }
    for (int l = 0; l < N; l++)                    // flush
        for (int k = 0; k < 4; k++) {
            lane_bytes[l].push_back((uint8_t)(low[l] >> 24));
            low[l] <<= 8;
        }

    int64_t need = 6 + 4LL * N + (int64_t)ev.size();
    if (need > cap) return -1;
    uint8_t* p = out;
    *p++ = (uint8_t)logN; *p++ = (uint8_t)order;
    for (int k = 0; k < 4; k++) *p++ = (uint8_t)((uint64_t)n >> (8 * k));
    for (int l = 0; l < N; l++)
        for (int k = 0; k < 4; k++) *p++ = lane_bytes[l][k];
    std::vector<int64_t> j(N, 0);
    for (int32_t l : ev) *p++ = lane_bytes[l][4 + j[l]++];
    return p - out;
}

int64_t gxz_arith_decode(const uint8_t* in, int64_t in_len, uint8_t* out,
                         int64_t n_expect) {
    using namespace arith;
    if (in_len < 6) return -1;
    int logN = in[0], order = in[1];
    int N = 1 << logN;
    int64_t n = 0;
    for (int k = 0; k < 4; k++) n |= (int64_t)in[2 + k] << (8 * k);
    if (n != n_expect) return -2;
    int64_t K = n > 0 ? (n + N - 1) / N : 0;
    std::vector<int64_t> lane_len(N);
    for (int l = 0; l < N; l++) {
        int64_t v = n - (int64_t)l * K;
        lane_len[l] = v < 0 ? 0 : (v > K ? K : v);
    }
    const uint8_t* body = in + 6;
    const uint8_t* bend = in + in_len;
    if (body + 4LL * N > bend) return -3;
    std::vector<uint32_t> low(N, 0), rng(N, 0xFFFFFFFFu), code(N);
    for (int l = 0; l < N; l++) {
        code[l] = ((uint32_t)body[0] << 24) | ((uint32_t)body[1] << 16) |
                  ((uint32_t)body[2] << 8) | body[3];
        body += 4;
    }
    Model model(order);
    std::vector<uint8_t> syms(N), ctxs(N);
    std::vector<int> dirty;
    std::vector<Magic> mag(model.nctx);
    std::vector<int64_t> mag_gen(model.nctx, -1);
    std::vector<int> active(N), pend(N);
    for (int64_t t = 0; t < K; t++) {
        int na = 0;
        for (int l = 0; l < N; l++)
            if (t < lane_len[l]) active[na++] = l;
        for (int ai = 0; ai < na; ai++) {
            int l = active[ai];
            uint8_t cx = (order && t) ? out[(int64_t)l * K + t - 1] : 0;
            ctxs[l] = cx;
            uint32_t tot = model.total[cx];
            if (mag_gen[cx] != t) { mag[cx] = make_magic(tot); mag_gen[cx] = t; }
            uint32_t r = magic_div(rng[l], mag[cx], tot);
            uint32_t v = (code[l] - low[l]) / r;
            if (v > tot - 1) v = tot - 1;
            uint32_t c;
            int s = model.search_ctx(cx, model.snap(cx), v, &c);
            if (s > 255) s = 255;
            uint32_t f = model.freq[(size_t)cx * 256 + s];
            low[l] += c * r;
            rng[l] = f * r;
            out[(int64_t)l * K + t] = (uint8_t)s;
            syms[l] = (uint8_t)s;
        }
        int np_ = na;
        int* cur = active.data();
        int* nxt = pend.data();
        while (np_) {
            int nn = 0;
            for (int i = 0; i < np_; i++) {
                int l = cur[i];
                uint32_t lo = low[l], rg = rng[l];
                bool c1 = ((lo ^ (lo + rg)) < A_TOP), c2 = rg < A_BOT;
                if (!(c1 || c2)) continue;
                if (!c1) rng[l] = (0u - lo) & (A_BOT - 1);
                uint8_t b = body < bend ? *body++ : 0;
                code[l] = (code[l] << 8) | b;
                low[l] <<= 8; rng[l] <<= 8;
                nxt[nn++] = l;
            }
            np_ = nn;
            std::swap(cur, nxt);
        }
        dirty.clear();
        for (int l = 0; l < N; l++) {
            if (t >= lane_len[l]) continue;
            int cx = order ? ctxs[l] : 0;
            model.add(cx, syms[l], A_INC);
            if (model.total[cx] > A_MAX_TOTAL) dirty.push_back(cx);
        }
        for (int cx : dirty)
            if (model.total[cx] > A_MAX_TOTAL) model.rescale(cx);
    }
    return n;
}

// One-pass CIGAR-driven SEQ-vs-reference diff (reference parity:
// src/sam_seq.c sam_seg_SEQ hot loop). Walks the flat op table row-major,
// comparing M/=/X bytes against the 2-bit genome codes and streaming I/S
// bytes plus whole non-by_ref rows into the NONREF channel — no per-byte
// index arrays. Returns the mismatch count found; writes at most mm_cap
// entries (caller re-runs with a bigger buffer if count > mm_cap).
// nonref_len returns the bytes written to nonref (caller sizes it exactly).
int64_t gxz_seq_diff(
    const uint8_t* seq, const int64_t* seq_off, int64_t n,
    const uint8_t* by_ref, const int64_t* gpos0,
    const uint8_t* letters, const int64_t* oplen, const int64_t* oprow,
    const int64_t* roff, const int64_t* goff, int64_t K,
    const uint8_t* ref_codes,
    const uint8_t* match_lut, const uint8_t* ins_lut,
    const uint8_t* base2bit, const uint8_t* is_acgt,
    int32_t* mm_row, int32_t* mm_pos, uint8_t* mm_base, int64_t mm_cap,
    uint8_t* nonref, int64_t* nonref_len) {
    int64_t mm = 0, nr = 0, k = 0;
    for (int64_t row = 0; row < n; row++) {
        int64_t soff = seq_off[row];
        if (!by_ref[row]) {
            int64_t len = seq_off[row + 1] - soff;
            memcpy(nonref + nr, seq + soff, (size_t)len);
            nr += len;
            while (k < K && oprow[k] == row) k++;
            continue;
        }
        int64_t g0 = gpos0[row];
        for (; k < K && oprow[k] == row; k++) {
            uint8_t lt = letters[k];
            int64_t len = oplen[k];
            if (match_lut[lt]) {
                const uint8_t* s = seq + soff + roff[k];
                const uint8_t* r = ref_codes + g0 + goff[k];
                int64_t rp = roff[k];
                for (int64_t i = 0; i < len; i++) {
                    uint8_t b = s[i];
                    if (r[i] != base2bit[b] || !is_acgt[b]) {
                        if (mm < mm_cap) {
                            mm_row[mm] = (int32_t)row;
                            mm_pos[mm] = (int32_t)(rp + i);
                            mm_base[mm] = b;
                        }
                        mm++;
                    }
                }
            } else if (ins_lut[lt]) {
                memcpy(nonref + nr, seq + soff + roff[k], (size_t)len);
                nr += len;
            }
        }
    }
    *nonref_len = nr;
    return mm;
}

// Inverse of gxz_seq_diff: rebuild SEQ from the genome + NONREF stream in
// one CIGAR-driven pass (PIZ side of src/sam_seg.c SEQ-vs-ref; mismatch
// patches are applied by the caller — the patch list is tiny).
// ins_before[k] = NONREF bytes consumed by earlier I/S ops of the same row.
void gxz_seq_recon(
    uint8_t* out, const int64_t* out_off, int64_t n,
    const uint8_t* by_ref, const int64_t* gpos0,
    const uint8_t* letters, const int64_t* oplen, const int64_t* oprow,
    const int64_t* roff, const int64_t* goff, const int64_t* ins_before,
    int64_t K, const uint8_t* ref_codes, int64_t G, const uint8_t* acgt,
    const uint8_t* match_lut, const uint8_t* ins_lut,
    const uint8_t* nonref, const int64_t* nr_off) {
    int64_t k = 0;
    for (int64_t row = 0; row < n; row++) {
        uint8_t* dst0 = out + out_off[row];
        if (!by_ref[row]) {
            int64_t len = out_off[row + 1] - out_off[row];
            memcpy(dst0, nonref + nr_off[row], (size_t)len);
            while (k < K && oprow[k] == row) k++;
            continue;
        }
        int64_t g0 = gpos0[row];
        for (; k < K && oprow[k] == row; k++) {
            uint8_t lt = letters[k];
            int64_t len = oplen[k];
            if (match_lut[lt]) {
                uint8_t* d = dst0 + roff[k];
                int64_t g = g0 + goff[k];
                for (int64_t i = 0; i < len; i++) {
                    int64_t gi = g + i;
                    if (gi < 0) gi = 0;
                    else if (gi >= G) gi = G - 1;
                    d[i] = acgt[ref_codes[gi]];
                }
            } else if (ins_lut[lt]) {
                memcpy(dst0 + roff[k], nonref + nr_off[row] + ins_before[k],
                       (size_t)len);
            }
        }
    }
}

// Pack per-row ASCII SEQ back into BAM 4-bit nibble rows (2-aligned per
// row, high nibble first — PIZ half of bam_seg.c nibble handling).
void gxz_renibble(const uint8_t* data, const int64_t* offsets, int64_t n,
                  const uint8_t* nib_of, uint8_t* out,
                  const int64_t* out_off) {
    for (int64_t row = 0; row < n; row++) {
        const uint8_t* s = data + offsets[row];
        int64_t len = offsets[row + 1] - offsets[row];
        uint8_t* d = out + out_off[row];
        int64_t i = 0;
        for (; i + 1 < len; i += 2)
            d[i >> 1] = (uint8_t)((nib_of[s[i]] << 4) | nib_of[s[i + 1]]);
        if (i < len)
            d[i >> 1] = (uint8_t)(nib_of[s[i]] << 4);
    }
}

// Scatter pure-match reads into still-unset genome positions (REF_INTERNAL
// population, reference src/reference.c + ref_lock.c range writes). First
// writer wins; blk_set saturation counters updated incrementally.
void gxz_ref_populate(
    const uint8_t* seq, const int64_t* seq_off,
    const int64_t* rows, const int64_t* starts, int64_t nrows,
    const uint8_t* base2bit,
    uint8_t* ref_codes, uint8_t* is_set, int64_t* blk_set, int64_t blk) {
    for (int64_t i = 0; i < nrows; i++) {
        int64_t row = rows[i];
        const uint8_t* s = seq + seq_off[row];
        int64_t len = seq_off[row + 1] - seq_off[row];
        int64_t g = starts[i];
        for (int64_t j = 0; j < len; j++) {
            if (!is_set[g + j]) {
                ref_codes[g + j] = base2bit[s[j]];
                is_set[g + j] = 1;
                blk_set[(g + j) / blk]++;
            }
        }
    }
}

// In-place reverse (and optional complement via lut) of the selected rows —
// the NORMQ/strand-orient hot loop (reference src/codec_normq.c role).
void gxz_reverse_rows(
    uint8_t* data, const int64_t* offsets,
    const int64_t* rows, int64_t nrows, const uint8_t* comp_lut) {
    for (int64_t i = 0; i < nrows; i++) {
        int64_t row = rows[i];
        uint8_t* a = data + offsets[row];
        uint8_t* b = data + offsets[row + 1] - 1;
        if (comp_lut) {
            while (a < b) {
                uint8_t x = comp_lut[*a], y = comp_lut[*b];
                *a++ = y; *b-- = x;
            }
            if (a == b) *a = comp_lut[*a];
        } else {
            while (a < b) { uint8_t x = *a; *a++ = *b; *b-- = x; }
        }
    }
}

// Strict per-row decimal parse (ragged.atoi semantics): optional leading
// '-', 1..19 digits, no leading zeros on multi-digit values. Bad rows get
// ok=0 and val=0. Accumulation wraps in uint64 like the numpy int64 path.
void gxz_atoi(const uint8_t* data, const int64_t* offsets, int64_t n,
              int64_t* vals, uint8_t* ok) {
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* p = data + offsets[i];
        int64_t len = offsets[i + 1] - offsets[i];
        bool neg = len > 1 && p[0] == '-';
        const uint8_t* d = p + neg;
        int64_t dl = len - neg;
        if (dl < 1 || dl > 19 || (dl > 1 && d[0] == '0')) {
            vals[i] = 0; ok[i] = 0; continue;
        }
        uint64_t v = 0;
        bool good = true;
        for (int64_t j = 0; j < dl; j++) {
            uint8_t c = d[j];
            if (c < '0' || c > '9') { good = false; break; }
            v = v * 10 + (c - '0');
        }
        if (!good) { vals[i] = 0; ok[i] = 0; continue; }
        vals[i] = (int64_t)(neg ? 0ULL - v : v);   // mod-2^64, matches numpy
        ok[i] = 1;
    }
}

// Vectorized int64 -> decimal ascii rows. Pass 1 (out=NULL): fill offsets
// and return total bytes. Pass 2: fill out.
int64_t gxz_itoa(const int64_t* vals, int64_t n, int64_t* offsets,
                 uint8_t* out) {
    if (!out) {
        int64_t total = 0;
        offsets[0] = 0;
        for (int64_t i = 0; i < n; i++) {
            uint64_t a = vals[i] < 0 ? (uint64_t)(-(vals[i] + 1)) + 1
                                     : (uint64_t)vals[i];
            int nd = 1;
            for (uint64_t t = a / 10; t; t /= 10) nd++;
            total += nd + (vals[i] < 0);
            offsets[i + 1] = total;
        }
        return total;
    }
    for (int64_t i = 0; i < n; i++) {
        uint64_t a = vals[i] < 0 ? (uint64_t)(-(vals[i] + 1)) + 1
                                 : (uint64_t)vals[i];
        uint8_t* end = out + offsets[i + 1];
        do { *--end = (uint8_t)('0' + a % 10); a /= 10; } while (a);
        if (vals[i] < 0) *--end = '-';
    }
    return offsets[n];
}

// BAM 4-bit SEQ nibbles -> ASCII letters (reference src/sam_sa.c bam_seq
// semantics): one pass, 16-bit LUT pair-expand per input byte, truncated to
// l_seq letters per row; ok[i]=0 when an odd-length row's pad nibble != 0
// (such a row cannot round-trip through ASCII). Returns bytes written.
int64_t gxz_nib_expand(const uint8_t* nib, const int64_t* offsets,
                       const int64_t* lseq, int64_t nrows,
                       uint8_t* out, uint8_t* ok) {
    static uint16_t lut[256];
    static bool init = false;
    if (!init) {
        const char* NB = "=ACMGRSVTWYHKDBN";
        for (int b = 0; b < 256; b++)
            lut[b] = (uint16_t)((uint8_t)NB[b >> 4])
                   | ((uint16_t)((uint8_t)NB[b & 15]) << 8);
        init = true;
    }
    uint8_t* o = out;
    for (int64_t i = 0; i < nrows; i++) {
        const uint8_t* src = nib + offsets[i];
        int64_t nb = offsets[i + 1] - offsets[i];
        int64_t L = lseq[i];
        if (nb < (L + 1) >> 1) {   // malformed/truncated row: degrade, no overread
            for (int64_t k = 0; k < L; k++) *o++ = 'N';
            ok[i] = 0;
            continue;
        }
        int64_t pairs = L >> 1;
        for (int64_t k = 0; k < pairs; k++) {
            uint16_t v = lut[src[k]];
            memcpy(o, &v, 2);
            o += 2;
        }
        if (L & 1) *o++ = (uint8_t)lut[src[pairs]];
        ok[i] = !((L & 1) && nb > 0 && (src[nb - 1] & 15) != 0);
    }
    return o - out;
}

// ---------------------------------------------------------------------------
// BGZF block chain: scan (headers only) + batch inflate/deflate. Replaces the
// per-block python loop in utils/bgzf.py (reference src/mgzip.c: main thread
// reads whole blocks, compute threads inflate, zip.c:520-521).
// ---------------------------------------------------------------------------

// Scan whole BGZF blocks in buf[0:len): record each block's offset, bsize
// (on-disk) and isize (inflated). Returns block count; *consumed = bytes of
// whole blocks; *uniform stays 1 while every block's first 12 header bytes
// match the first block's.
int64_t gxz_bgzf_scan(const uint8_t* buf, int64_t len, int64_t max_blocks,
                      int64_t* boff, int32_t* bsize, int32_t* isize,
                      int64_t* consumed, int32_t* uniform) {
    int64_t off = 0, cnt = 0;
    *uniform = 1;
    while (cnt < max_blocks && off + 18 <= len) {
        const uint8_t* h = buf + off;
        if (!(h[0] == 0x1F && h[1] == 0x8B && (h[3] & 4) &&
              h[12] == 0x42 && h[13] == 0x43))
            break;   // not a BGZF header: stop (caller raises)
        int64_t bs = (int64_t)(h[16] | (h[17] << 8)) + 1;
        if (off + bs > len) break;   // partial block: wait for more bytes
        if (cnt > 0 && memcmp(buf + boff[0], h, 12)) *uniform = 0;
        boff[cnt] = off;
        bsize[cnt] = (int32_t)bs;
        uint32_t isz;
        memcpy(&isz, buf + off + bs - 4, 4);
        isize[cnt] = (int32_t)isz;
        off += bs;
        cnt++;
    }
    *consumed = off;
    return cnt;
}

// Inflate n scanned blocks into out (caller sized = sum of isizes).
// Returns total inflated bytes, or -(i+1) if block i failed.
// libdeflate raw-inflate: ~2-3x zlib (the reference vendors libdeflate for
// exactly this role).
int64_t gxz_bgzf_inflate(const uint8_t* buf, const int64_t* boff,
                         const int32_t* bsize, const int32_t* isize,
                         int64_t n, uint8_t* out) {
    // blocks are independent; output offsets are the isize prefix sums
    std::vector<int64_t> ooff(n + 1);
    ooff[0] = 0;
    for (int64_t i = 0; i < n; i++) ooff[i + 1] = ooff[i] + isize[i];
    int64_t total = ooff[n];
    unsigned hw = std::thread::hardware_concurrency();
    int nt = (int)std::min<int64_t>(std::max(1u, hw), std::max<int64_t>(1, n));
    if (total < (4 << 20)) nt = 1;  // not worth thread spawn
    std::vector<int64_t> fail(nt, 0);
    auto work = [&](int w) {
        struct libdeflate_decompressor* d = libdeflate_alloc_decompressor();
        if (!d) { fail[w] = -1; return; }
        // contiguous block ranges balanced by compressed bytes
        int64_t b0 = n * w / nt, b1 = n * (w + 1) / nt;
        for (int64_t i = b0; i < b1; i++) {
            int64_t comp_len = bsize[i] - 18 - 8;
            if (isize[i] == 0) { if (comp_len <= 2) continue; }
            size_t actual = 0;
            if (libdeflate_deflate_decompress(
                    d, buf + boff[i] + 18, (size_t)comp_len, out + ooff[i],
                    (size_t)isize[i], &actual) != LIBDEFLATE_SUCCESS ||
                actual != (size_t)isize[i]) {
                fail[w] = -(i + 1);
                break;
            }
        }
        libdeflate_free_decompressor(d);
    };
    if (nt == 1) {
        work(0);
    } else {
        std::vector<std::thread> th;
        for (int w = 0; w < nt; w++) th.emplace_back(work, w);
        for (auto& t : th) t.join();
    }
    for (int w = 0; w < nt; w++)
        if (fail[w] < 0) return fail[w];
    return total;
}

// Deflate payload into a chain of standard BGZF blocks (64KB plaintext per
// block, htslib convention, EOF marker NOT included). out must hold
// ~len + len/512 + 64 per block of overhead. Returns bytes written.
int64_t gxz_bgzf_deflate(const uint8_t* data, int64_t len, int block,
                         int level, uint8_t* out, int64_t cap) {
    struct libdeflate_compressor* c =
        libdeflate_alloc_compressor(level < 1 ? 1 : (level > 12 ? 12 : level));
    if (!c) return -1;
    int64_t off = 0, w = 0;
    while (off < len) {
        int64_t pl = len - off < block ? len - off : block;
        if (w + pl + 64 > cap) { libdeflate_free_compressor(c); return -2; }
        uint8_t* hdr = out + w;
        size_t comp = libdeflate_deflate_compress(
            c, data + off, (size_t)pl, hdr + 18, (size_t)(cap - w - 26));
        if (!comp) { libdeflate_free_compressor(c); return -3; }
        int64_t bs = (int64_t)comp + 26;
        const uint8_t fixed[16] = {0x1F, 0x8B, 8, 4, 0, 0, 0, 0, 0, 0xFF,
                                   6, 0, 0x42, 0x43, 2, 0};
        memcpy(hdr, fixed, 16);
        hdr[16] = (uint8_t)((bs - 1) & 0xFF);
        hdr[17] = (uint8_t)(((bs - 1) >> 8) & 0xFF);
        uint32_t crc = libdeflate_crc32(0, data + off, (size_t)pl);
        uint32_t isz = (uint32_t)pl;
        memcpy(hdr + 18 + comp, &crc, 4);
        memcpy(hdr + 18 + comp + 4, &isz, 4);
        w += bs;
        off += pl;
    }
    libdeflate_free_compressor(c);
    return w;
}

// Exact BGZF re-emission (reference --bgzf=exact, src/mgzip.c): deflate the
// payload into blocks of the RECORDED isizes with plain zlib at the
// discovered level — byte-identical to the original writer (python zlib is
// the same libz). hdr = the original 12-byte fixed header template.
// Blocks are independent -> threaded. Returns bytes written, or <0 on error.

static void bgzf_exact_range(const uint8_t* data, const int64_t* doff,
                             const uint32_t* isizes, int64_t b0, int64_t b1,
                             int level, const uint8_t* hdr, int hdr_len,
                             uint8_t* scratch, int64_t scratch_stride,
                             int32_t* out_lens, int use_libdeflate) {
    z_stream zs;
    struct libdeflate_compressor* lc = nullptr;
    if (use_libdeflate) {
        lc = libdeflate_alloc_compressor(level);
        if (!lc) {
            for (int64_t b = b0; b < b1; b++) out_lens[b] = -1;
            return;
        }
    } else {
        memset(&zs, 0, sizeof zs);
        if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                         Z_DEFAULT_STRATEGY) != Z_OK) {
            for (int64_t b = b0; b < b1; b++) out_lens[b] = -1;
            return;
        }
    }
    for (int64_t b = b0; b < b1; b++) {
        uint32_t pl = isizes[b];
        uint8_t* dst = scratch + (b - b0) * scratch_stride;
        int64_t comp;
        if (pl == 0) {
            // empty block (EOF marker): the canonical 2-byte zlib-style
            // final block, constant across writer libraries (htslib bgzf.c)
            dst[hdr_len + 6] = 0x03; dst[hdr_len + 7] = 0x00;
            comp = 2;
        } else if (use_libdeflate) {
            comp = (int64_t)libdeflate_deflate_compress(
                lc, data + doff[b], pl, dst + hdr_len + 6,
                (size_t)(scratch_stride - hdr_len - 14));
            if (!comp) { out_lens[b] = -1; break; }
        } else {
            zs.next_in = const_cast<uint8_t*>(data + doff[b]);
            zs.avail_in = pl;
            zs.next_out = dst + hdr_len + 6;
            zs.avail_out = (uInt)(scratch_stride - hdr_len - 14);
            if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
                out_lens[b] = -1;
                break;
            }
            comp = (int64_t)(scratch_stride - hdr_len - 14) - zs.avail_out;
        }
        int64_t bs = comp + hdr_len + 6 + 8;
        memcpy(dst, hdr, (size_t)hdr_len);
        dst[hdr_len + 0] = 0x42; dst[hdr_len + 1] = 0x43;
        dst[hdr_len + 2] = 2;    dst[hdr_len + 3] = 0;
        dst[hdr_len + 4] = (uint8_t)((bs - 1) & 0xFF);
        dst[hdr_len + 5] = (uint8_t)(((bs - 1) >> 8) & 0xFF);
        uint32_t crc = crc32(0, data + doff[b], pl);
        memcpy(dst + hdr_len + 6 + comp, &crc, 4);
        memcpy(dst + hdr_len + 6 + comp + 4, &pl, 4);
        out_lens[b] = (int32_t)bs;
        if (!use_libdeflate) deflateReset(&zs);
    }
    if (use_libdeflate) libdeflate_free_compressor(lc);
    else deflateEnd(&zs);
}

// Raw-deflate one payload with libdeflate (level discovery trials).
int64_t gxz_raw_deflate(const uint8_t* in, int64_t n, int level, uint8_t* out,
                        int64_t cap) {
    struct libdeflate_compressor* c = libdeflate_alloc_compressor(level);
    if (!c) return -1;
    size_t w = libdeflate_deflate_compress(c, in, (size_t)n, out, (size_t)cap);
    libdeflate_free_compressor(c);
    return (int64_t)w;
}

int64_t gxz_bgzf_deflate_exact(const uint8_t* data, int64_t len,
                               const uint32_t* isizes, int64_t nblocks,
                               int level, const uint8_t* hdr, int hdr_len,
                               int nthreads, uint8_t* out, int64_t cap,
                               int use_libdeflate) {
#ifndef GXZ_LIBDEFLATE
    if (use_libdeflate) return -12;   // needs the real libdeflate
#endif
    std::vector<int64_t> doff(nblocks + 1);
    int64_t acc = 0;
    int64_t max_isz = 1;
    for (int64_t b = 0; b < nblocks; b++) {
        doff[b] = acc;
        acc += isizes[b];
        if ((int64_t)isizes[b] > max_isz) max_isz = isizes[b];
    }
    doff[nblocks] = acc;
    if (acc != len) return -10;   // plaintext length != recorded isizes
    int64_t stride = max_isz + max_isz / 32 + hdr_len + 64;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 8) nthreads = 8;
    if (nblocks < 2 * nthreads) nthreads = 1;
    std::vector<int32_t> lens(nblocks);
    std::vector<std::vector<uint8_t>> scratch(nthreads);
    std::vector<std::thread> ths;
    int64_t per = (nblocks + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        int64_t b0 = t * per, b1 = std::min<int64_t>(b0 + per, nblocks);
        if (b0 >= b1) break;
        scratch[t].resize((size_t)((b1 - b0) * stride));
        ths.emplace_back(bgzf_exact_range, data, doff.data(), isizes, b0, b1,
                         level, hdr, hdr_len, scratch[t].data(), stride,
                         lens.data(), use_libdeflate);
    }
    for (auto& th : ths) th.join();
    int64_t w = 0;
    for (int t = 0, b = 0; t < (int)ths.size(); t++) {
        int64_t b0 = (int64_t)t * per;
        int64_t b1 = std::min<int64_t>(b0 + per, nblocks);
        for (int64_t i = b0; i < b1; i++, b++) {
            if (lens[i] < 0) return -(i + 1);
            if (w + lens[i] > cap) return -11;
            memcpy(out + w, scratch[t].data() + (i - b0) * stride,
                   (size_t)lens[i]);
            w += lens[i];
        }
    }
    return w;
}

// LUT-map + bit-pack in one pass (codecs PACK0/PACK1 hot half): codes =
// lut[data[i]] packed `width` bits each, little-endian within byte.
void gxz_pack_lut(const uint8_t* data, int64_t n, const uint8_t* lut,
                  int width, uint8_t* out) {
    int per = 8 / width;
    int64_t nb = (n + per - 1) / per;
    memset(out, 0, (size_t)nb);
    int64_t i = 0;
    if (width == 2) {
        int64_t n4 = n / 4;
        for (int64_t b = 0; b < n4; b++) {
            const uint8_t* p = data + b * 4;
            out[b] = (uint8_t)(lut[p[0]] | (lut[p[1]] << 2) |
                               (lut[p[2]] << 4) | (lut[p[3]] << 6));
        }
        i = n4 * 4;
    } else if (width == 4) {
        int64_t n2 = n / 2;
        for (int64_t b = 0; b < n2; b++) {
            const uint8_t* p = data + b * 2;
            out[b] = (uint8_t)(lut[p[0]] | (lut[p[1]] << 4));
        }
        i = n2 * 2;
    } else {
        int64_t n8 = n / 8;
        for (int64_t b = 0; b < n8; b++) {
            const uint8_t* p = data + b * 8;
            uint8_t v = 0;
            for (int k = 0; k < 8; k++) v |= lut[p[k]] << k;
            out[b] = v;
        }
        i = n8 * 8;
    }
    for (; i < n; i++)
        out[i / per] |= (uint8_t)(lut[data[i]] << ((i % per) * width));
}

// Unpack + symbol-map in one pass (PACK decode): out[i] = syms[code_i].
void gxz_unpack_lut(const uint8_t* packed, int64_t n, int width,
                    const uint8_t* syms, uint8_t* out) {
    if (width == 2) {
        // 32-bit LUT: one packed byte -> 4 output symbols
        uint32_t lut4[256];
        for (int b = 0; b < 256; b++) {
            uint8_t o[4] = {syms[b & 3], syms[(b >> 2) & 3],
                            syms[(b >> 4) & 3], syms[(b >> 6) & 3]};
            memcpy(&lut4[b], o, 4);
        }
        int64_t n4 = n / 4;
        for (int64_t b = 0; b < n4; b++) {
            uint32_t v = lut4[packed[b]];
            memcpy(out + b * 4, &v, 4);
        }
        for (int64_t i = n4 * 4; i < n; i++)
            out[i] = syms[(packed[i / 4] >> ((i % 4) * 2)) & 3];
    } else if (width == 4) {
        uint16_t lut2[256];
        for (int b = 0; b < 256; b++) {
            uint8_t o[2] = {syms[b & 15], syms[(b >> 4) & 15]};
            memcpy(&lut2[b], o, 2);
        }
        int64_t n2 = n / 2;
        for (int64_t b = 0; b < n2; b++) {
            uint16_t v = lut2[packed[b]];
            memcpy(out + b * 2, &v, 2);
        }
        for (int64_t i = n2 * 2; i < n; i++)
            out[i] = syms[(packed[i / 2] >> ((i % 2) * 4)) & 15];
    } else {
        for (int64_t i = 0; i < n; i++)
            out[i] = syms[(packed[i / 8] >> (i % 8)) & 1];
    }
}

// Per-row count of bytes equal to sep (ragged count_sep_per_row): one pass,
// no index materialization.
void gxz_count_eq(const uint8_t* data, const int64_t* off, int64_t n,
                  uint8_t sep, int64_t* out) {
    for (int64_t i = 0; i < n; i++) {
        int64_t c = 0;
        const uint8_t* p = data + off[i];
        const uint8_t* e = data + off[i + 1];
        for (; p < e; p++) c += (*p == sep);
        out[i] = c;
    }
}

// Byte offset just past the last newline whose 1-based ordinal is a multiple
// of `stride` (FASTQ record alignment); 0 if none. memchr = SIMD scan.
int64_t gxz_stride_boundary(const uint8_t* data, int64_t len, int64_t stride) {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    int64_t cnt = 0, last = -1;
    while (p < end) {
        const uint8_t* q = (const uint8_t*)memchr(p, '\n', (size_t)(end - p));
        if (!q) break;
        if ((++cnt % stride) == 0) last = q - data;
        p = q + 1;
    }
    return last + 1;
}

}  // extern "C"
