/* AES-256-GCM with AES-NI + PCLMULQDQ — host-side crypto kernel.
 *
 * Native counterpart of the reference's JCE "AES/GCM/NoPadding" path
 * (crypto/src/main/java/com/fspann/crypto/AesGcmCryptoService.java:30-33 in
 * the Java reference): 12-byte IV, 128-bit tag, optional AAD.  Exposes
 * batch seal/open entry points so the decrypt-and-refine stage processes a
 * whole candidate set per call (the reference decrypts one point at a time —
 * its dominant query cost).
 *
 * Build: gcc -O3 -maes -mpclmul -mssse3 -shared -fPIC
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>     /* getenv/atol (prefetch-depth knob) */
#include <string.h>
#include <wmmintrin.h>  /* AES-NI + PCLMUL */
#include <tmmintrin.h>  /* _mm_shuffle_epi8 */
#include <smmintrin.h>  /* _mm_insert_epi32 */
#if defined(__x86_64__) && defined(__GNUC__)
#include <immintrin.h>  /* VAES / VPCLMULQDQ wide paths (runtime-gated) */
#endif

/* Largest record (in GHASH blocks: 2 AAD + ceil(ct/16) + 1 len) served by
 * the aggregated short-record open below.  128 blocks covers f32 payloads
 * to ~2000 B (dim 500) and f16 to ~4000 B; longer records fall back to the
 * generic streaming path. */
#define GCM_SHORT_MAX_BLOCKS 128

typedef struct {
    __m128i rk[15];   /* AES-256 round keys */
    __m128i h[4];     /* GHASH key powers H^1..H^4, byte-reflected */
    /* Descending power table for the single-reduction aggregated GHASH:
     * hpow_desc[j] = H^(GCM_SHORT_MAX_BLOCKS - j), so a record of nb
     * blocks reads consecutive 4-lane groups starting at index
     * GCM_SHORT_MAX_BLOCKS - nb (block j multiplies H^(nb-j)). */
    __m128i hpow_desc[GCM_SHORT_MAX_BLOCKS];
    /* Round keys replicated 4x per 512-bit group for VAES, stored as plain
     * bytes (the ctx rides in ctypes buffers with no 64-byte alignment
     * guarantee — all wide loads use loadu). */
    uint8_t rk512[15][64];
} gcm_ctx;

size_t fspann_gcm_ctx_size(void) { return sizeof(gcm_ctx); }

/* ------------------------------------------------------------------ */
/* AES-256 key schedule                                                */
/* ------------------------------------------------------------------ */

static inline __m128i ks_mix(__m128i k) {
    k = _mm_xor_si128(k, _mm_slli_si128(k, 4));
    k = _mm_xor_si128(k, _mm_slli_si128(k, 4));
    k = _mm_xor_si128(k, _mm_slli_si128(k, 4));
    return k;
}

#define EXPAND_EVEN(i, rcon)                                              \
    do {                                                                  \
        __m128i t = _mm_aeskeygenassist_si128(rk[(i)-1], (rcon));         \
        t = _mm_shuffle_epi32(t, 0xff);                                   \
        rk[(i)] = _mm_xor_si128(ks_mix(rk[(i)-2]), t);                    \
    } while (0)

#define EXPAND_ODD(i)                                                     \
    do {                                                                  \
        __m128i t = _mm_aeskeygenassist_si128(rk[(i)-1], 0x00);           \
        t = _mm_shuffle_epi32(t, 0xaa);                                   \
        rk[(i)] = _mm_xor_si128(ks_mix(rk[(i)-2]), t);                    \
    } while (0)

static void aes256_expand(const uint8_t key[32], __m128i rk[15]) {
    rk[0] = _mm_loadu_si128((const __m128i *)key);
    rk[1] = _mm_loadu_si128((const __m128i *)(key + 16));
    EXPAND_EVEN(2, 0x01);  EXPAND_ODD(3);
    EXPAND_EVEN(4, 0x02);  EXPAND_ODD(5);
    EXPAND_EVEN(6, 0x04);  EXPAND_ODD(7);
    EXPAND_EVEN(8, 0x08);  EXPAND_ODD(9);
    EXPAND_EVEN(10, 0x10); EXPAND_ODD(11);
    EXPAND_EVEN(12, 0x20); EXPAND_ODD(13);
    EXPAND_EVEN(14, 0x40);
}

static inline __m128i aes256_enc(const __m128i rk[15], __m128i x) {
    x = _mm_xor_si128(x, rk[0]);
    for (int i = 1; i < 14; i++) x = _mm_aesenc_si128(x, rk[i]);
    return _mm_aesenclast_si128(x, rk[14]);
}

/* ------------------------------------------------------------------ */
/* GHASH (CLMUL, byte-reflected operands)                              */
/* ------------------------------------------------------------------ */

static inline __m128i bswap16(__m128i x) {
    const __m128i rev = _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7,
                                     8, 9, 10, 11, 12, 13, 14, 15);
    return _mm_shuffle_epi8(x, rev);
}

/* Carry-less 128x128 -> 256 multiply (no reduction); byte-reflected
 * operands.  Partial products of an aggregated GHASH group are XOR-summed
 * in the 256-bit domain and reduced once. */
static inline void clmul256(__m128i a, __m128i b, __m128i *hi, __m128i *lo) {
    __m128i t3 = _mm_clmulepi64_si128(a, b, 0x00);
    __m128i t4 = _mm_clmulepi64_si128(a, b, 0x10);
    __m128i t5 = _mm_clmulepi64_si128(a, b, 0x01);
    __m128i t6 = _mm_clmulepi64_si128(a, b, 0x11);
    t4 = _mm_xor_si128(t4, t5);
    t5 = _mm_slli_si128(t4, 8);
    t4 = _mm_srli_si128(t4, 8);
    *lo = _mm_xor_si128(t3, t5);
    *hi = _mm_xor_si128(t6, t4);
}

/* Shift the 256-bit product left one bit and reduce mod the GCM polynomial
 * (classic Intel white-paper two-phase reduction). */
static inline __m128i gcm_reduce(__m128i t6, __m128i t3) {
    __m128i t7, t8, t9;
    t7 = _mm_srli_epi32(t3, 31);
    t8 = _mm_srli_epi32(t6, 31);
    t3 = _mm_slli_epi32(t3, 1);
    t6 = _mm_slli_epi32(t6, 1);
    t9 = _mm_srli_si128(t7, 12);
    t8 = _mm_slli_si128(t8, 4);
    t7 = _mm_slli_si128(t7, 4);
    t3 = _mm_or_si128(t3, t7);
    t6 = _mm_or_si128(t6, t8);
    t6 = _mm_or_si128(t6, t9);

    t7 = _mm_slli_epi32(t3, 31);
    t8 = _mm_slli_epi32(t3, 30);
    t9 = _mm_slli_epi32(t3, 25);
    t7 = _mm_xor_si128(t7, t8);
    t7 = _mm_xor_si128(t7, t9);
    t8 = _mm_srli_si128(t7, 4);
    t7 = _mm_slli_si128(t7, 12);
    t3 = _mm_xor_si128(t3, t7);

    __m128i u1 = _mm_srli_epi32(t3, 1);
    __m128i u2 = _mm_srli_epi32(t3, 2);
    __m128i u3 = _mm_srli_epi32(t3, 7);
    u1 = _mm_xor_si128(u1, u2);
    u1 = _mm_xor_si128(u1, u3);
    u1 = _mm_xor_si128(u1, t8);
    t3 = _mm_xor_si128(t3, u1);
    return _mm_xor_si128(t6, t3);
}

static inline __m128i gfmul(__m128i a, __m128i b) {
    __m128i hi, lo;
    clmul256(a, b, &hi, &lo);
    return gcm_reduce(hi, lo);
}

static inline __m128i ghash_update(__m128i y, __m128i h, __m128i block) {
    return gfmul(_mm_xor_si128(y, bswap16(block)), h);
}

/* Aggregated 4-block GHASH: one reduction per 64 bytes breaks the serial
 * per-block reduce chain (the chain is the GHASH latency bottleneck). */
static inline __m128i ghash4(const gcm_ctx *ctx, __m128i y,
                             __m128i b0, __m128i b1, __m128i b2, __m128i b3) {
    __m128i hi, lo, hi2, lo2;
    clmul256(_mm_xor_si128(y, bswap16(b0)), ctx->h[3], &hi, &lo);
    clmul256(bswap16(b1), ctx->h[2], &hi2, &lo2);
    hi = _mm_xor_si128(hi, hi2); lo = _mm_xor_si128(lo, lo2);
    clmul256(bswap16(b2), ctx->h[1], &hi2, &lo2);
    hi = _mm_xor_si128(hi, hi2); lo = _mm_xor_si128(lo, lo2);
    clmul256(bswap16(b3), ctx->h[0], &hi2, &lo2);
    hi = _mm_xor_si128(hi, hi2); lo = _mm_xor_si128(lo, lo2);
    return gcm_reduce(hi, lo);
}

/* VPCLMULQDQ path: 4 GHASH blocks per carry-less-multiply instruction.
 * Blocks b0..b3 (b0 oldest) multiply H^4..H^1 held one per 128-bit lane;
 * the four 256-bit partial products fold across lanes and reduce once.
 * Runtime-gated; the SSE ghash4 below handles tails and older CPUs. */
#if defined(__x86_64__) && defined(__GNUC__)
static int fspann_has_vpclmul(void) {
    static int cached = -1;
    if (cached < 0)
        cached = __builtin_cpu_supports("avx512f")
                 && __builtin_cpu_supports("avx512bw")
                 && __builtin_cpu_supports("vpclmulqdq");
    return cached;
}

__attribute__((target("avx512f,avx512bw,vpclmulqdq")))
static __m128i ghash_buf_vpclmul(const gcm_ctx *ctx, __m128i y,
                                 const uint8_t *p, size_t len,
                                 size_t *consumed) {
    const __m512i rev = _mm512_broadcast_i32x4(
        _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15));
    __m512i hpow = _mm512_castsi128_si512(ctx->h[3]);      /* lane0: H^4 */
    hpow = _mm512_inserti32x4(hpow, ctx->h[2], 1);
    hpow = _mm512_inserti32x4(hpow, ctx->h[1], 2);
    hpow = _mm512_inserti32x4(hpow, ctx->h[0], 3);
    size_t done = 0;
    while (len - done >= 64) {
        __m512i blk = _mm512_loadu_si512((const void *)(p + done));
        blk = _mm512_shuffle_epi8(blk, rev);
        blk = _mm512_mask_xor_epi64(blk, 0x03, blk,
                                    _mm512_castsi128_si512(y));
        __m512i t00 = _mm512_clmulepi64_epi128(blk, hpow, 0x00);
        __m512i t11 = _mm512_clmulepi64_epi128(blk, hpow, 0x11);
        __m512i mid = _mm512_xor_si512(
            _mm512_clmulepi64_epi128(blk, hpow, 0x10),
            _mm512_clmulepi64_epi128(blk, hpow, 0x01));
        __m512i lo512 = _mm512_xor_si512(t00, _mm512_bslli_epi128(mid, 8));
        __m512i hi512 = _mm512_xor_si512(t11, _mm512_bsrli_epi128(mid, 8));
        /* fold the four lanes' partial products */
        __m256i lo256 = _mm256_xor_si256(_mm512_castsi512_si256(lo512),
                                         _mm512_extracti64x4_epi64(lo512, 1));
        __m256i hi256 = _mm256_xor_si256(_mm512_castsi512_si256(hi512),
                                         _mm512_extracti64x4_epi64(hi512, 1));
        __m128i lo = _mm_xor_si128(_mm256_castsi256_si128(lo256),
                                   _mm256_extracti128_si256(lo256, 1));
        __m128i hi = _mm_xor_si128(_mm256_castsi256_si128(hi256),
                                   _mm256_extracti128_si256(hi256, 1));
        y = gcm_reduce(hi, lo);
        done += 64;
    }
    *consumed = done;
    return y;
}
#else
static int fspann_has_vpclmul(void) { return 0; }
static __m128i ghash_buf_vpclmul(const gcm_ctx *ctx, __m128i y,
                                 const uint8_t *p, size_t len,
                                 size_t *consumed) {
    (void)ctx; (void)p; (void)len; *consumed = 0; return y;
}
#endif

static __m128i ghash_buf(const gcm_ctx *ctx, __m128i y, const uint8_t *p,
                         size_t len) {
    if (fspann_has_vpclmul() && len >= 64) {
        size_t done = 0;
        y = ghash_buf_vpclmul(ctx, y, p, len, &done);
        p += done; len -= done;
    }
    while (len >= 64) {
        y = ghash4(ctx, y,
                   _mm_loadu_si128((const __m128i *)p),
                   _mm_loadu_si128((const __m128i *)(p + 16)),
                   _mm_loadu_si128((const __m128i *)(p + 32)),
                   _mm_loadu_si128((const __m128i *)(p + 48)));
        p += 64; len -= 64;
    }
    while (len >= 16) {
        y = ghash_update(y, ctx->h[0], _mm_loadu_si128((const __m128i *)p));
        p += 16; len -= 16;
    }
    if (len) {
        uint8_t last[16] = {0};
        memcpy(last, p, len);
        y = ghash_update(y, ctx->h[0], _mm_loadu_si128((const __m128i *)last));
    }
    return y;
}

/* ------------------------------------------------------------------ */
/* GCM core                                                            */
/* ------------------------------------------------------------------ */

int fspann_gcm_init(void *vctx, const uint8_t key[32]) {
    gcm_ctx *ctx = (gcm_ctx *)vctx;
    aes256_expand(key, ctx->rk);
    ctx->h[0] = bswap16(aes256_enc(ctx->rk, _mm_setzero_si128()));
    ctx->h[1] = gfmul(ctx->h[0], ctx->h[0]);
    ctx->h[2] = gfmul(ctx->h[1], ctx->h[0]);
    ctx->h[3] = gfmul(ctx->h[2], ctx->h[0]);
    /* short-record open tables: descending H powers + replicated keys
     * (one-time ~microseconds per key version; contexts are cached) */
    __m128i p = ctx->h[0];
    ctx->hpow_desc[GCM_SHORT_MAX_BLOCKS - 1] = p;         /* H^1 */
    for (int k = 2; k <= GCM_SHORT_MAX_BLOCKS; k++) {
        p = gfmul(p, ctx->h[0]);
        ctx->hpow_desc[GCM_SHORT_MAX_BLOCKS - k] = p;     /* H^k */
    }
    for (int r = 0; r < 15; r++)
        for (int g = 0; g < 4; g++)
            memcpy(ctx->rk512[r] + 16 * g, &ctx->rk[r], 16);
    return 0;
}

static inline __m128i make_j0(const uint8_t iv[12]) {
    uint8_t j0[16];
    memcpy(j0, iv, 12);
    j0[12] = 0; j0[13] = 0; j0[14] = 0; j0[15] = 1;
    return _mm_loadu_si128((const __m128i *)j0);
}

/* Counter block i: J0 with its last 32 bits (big-endian) incremented by i.
 * Kept in registers: extract the base counter once, then insert
 * byte-swapped (base + i). */
static inline uint32_t ctr_base(__m128i j0) {
    return __builtin_bswap32((uint32_t)_mm_extract_epi32(j0, 3));
}

static inline __m128i ctr_block(__m128i j0, uint32_t c) {
    return _mm_insert_epi32(j0, (int)__builtin_bswap32(c), 3);
}

/* VAES path: 16 AES blocks per iteration in four zmm registers — the
 * AES-round work that dominates GCM runs 4 lanes per instruction.  Gated
 * at runtime (__builtin_cpu_supports); the SSE path below remains the
 * portable fallback and handles tails.  Measured ~2x on the record-open
 * hot path on Icelake-SP (VAES+AVX512). */
#if defined(__x86_64__) && defined(__GNUC__)
__attribute__((target("avx512f,avx512bw,vaes")))
static size_t ctr_xcrypt_vaes(const gcm_ctx *ctx, __m128i j0,
                              const uint8_t *in, uint8_t *out, size_t len,
                              uint32_t c) {
    __m512i rk512[15];
    for (int r = 0; r < 15; r++)
        rk512[r] = _mm512_broadcast_i32x4(ctx->rk[r]);
    const __m512i base = _mm512_broadcast_i32x4(j0);
    size_t done = 0;
    while (len - done >= 256) {
        __m512i b[4];
        for (int g = 0; g < 4; g++) {
            uint32_t l = c + 4 * (uint32_t)g;
            __m512i cnt = _mm512_set_epi32(
                (int)__builtin_bswap32(l + 3), 0, 0, 0,
                (int)__builtin_bswap32(l + 2), 0, 0, 0,
                (int)__builtin_bswap32(l + 1), 0, 0, 0,
                (int)__builtin_bswap32(l), 0, 0, 0);
            /* dword 3 of each 128-bit lane is the big-endian counter */
            b[g] = _mm512_xor_si512(
                _mm512_mask_blend_epi32(0x8888, base, cnt), rk512[0]);
        }
        for (int r = 1; r < 14; r++)
            for (int g = 0; g < 4; g++)
                b[g] = _mm512_aesenc_epi128(b[g], rk512[r]);
        for (int g = 0; g < 4; g++) {
            b[g] = _mm512_aesenclast_epi128(b[g], rk512[14]);
            _mm512_storeu_si512(
                (void *)(out + done + 64 * g),
                _mm512_xor_si512(
                    _mm512_loadu_si512((const void *)(in + done + 64 * g)),
                    b[g]));
        }
        done += 256; c += 16;
    }
    return done;
}

static int fspann_has_vaes(void) {
    static int cached = -1;
    if (cached < 0)
        cached = __builtin_cpu_supports("avx512f")
                 && __builtin_cpu_supports("avx512bw")
                 && __builtin_cpu_supports("vaes");
    return cached;
}
#else
static size_t ctr_xcrypt_vaes(const gcm_ctx *ctx, __m128i j0,
                              const uint8_t *in, uint8_t *out, size_t len,
                              uint32_t c) {
    (void)ctx; (void)j0; (void)in; (void)out; (void)len; (void)c;
    return 0;
}
static int fspann_has_vaes(void) { return 0; }
#endif

/* CTR keystream application.  8 blocks in flight so the AES round
 * instructions pipeline (aesenc latency ~4 cycles, throughput 1/cycle);
 * a serial per-block chain caps at ~1/4 of the unit's throughput. */
static void ctr_xcrypt(const gcm_ctx *ctx, __m128i j0, const uint8_t *in,
                       uint8_t *out, size_t len) {
    const __m128i *rk = ctx->rk;
    uint32_t c = ctr_base(j0) + 1;  /* first data counter is J0+1 */
    if (fspann_has_vaes() && len >= 256) {
        size_t done = ctr_xcrypt_vaes(ctx, j0, in, out, len, c);
        in += done; out += done; len -= done;
        c += (uint32_t)(done / 16);
    }
    while (len >= 128) {
        __m128i b[8];
        for (int i = 0; i < 8; i++)
            b[i] = _mm_xor_si128(ctr_block(j0, c + (uint32_t)i), rk[0]);
        for (int r = 1; r < 14; r++)
            for (int i = 0; i < 8; i++)
                b[i] = _mm_aesenc_si128(b[i], rk[r]);
        for (int i = 0; i < 8; i++) {
            b[i] = _mm_aesenclast_si128(b[i], rk[14]);
            _mm_storeu_si128((__m128i *)(out + 16 * i),
                _mm_xor_si128(
                    _mm_loadu_si128((const __m128i *)(in + 16 * i)), b[i]));
        }
        in += 128; out += 128; len -= 128; c += 8;
    }
    while (len >= 16) {
        __m128i k = aes256_enc(rk, ctr_block(j0, c++));
        _mm_storeu_si128((__m128i *)out,
            _mm_xor_si128(_mm_loadu_si128((const __m128i *)in), k));
        in += 16; out += 16; len -= 16;
    }
    if (len) {
        uint8_t ks[16];
        _mm_storeu_si128((__m128i *)ks, aes256_enc(rk, ctr_block(j0, c)));
        for (size_t i = 0; i < len; i++) out[i] = in[i] ^ ks[i];
    }
}

static __m128i gcm_tag(const gcm_ctx *ctx, __m128i j0, const uint8_t *aad,
                       size_t aad_len, const uint8_t *ct, size_t ct_len) {
    __m128i y = _mm_setzero_si128();
    y = ghash_buf(ctx, y, aad, aad_len);
    y = ghash_buf(ctx, y, ct, ct_len);
    uint8_t lens[16];
    uint64_t ab = (uint64_t)aad_len * 8, cb = (uint64_t)ct_len * 8;
    for (int i = 0; i < 8; i++) {
        lens[i] = (uint8_t)(ab >> (56 - 8 * i));
        lens[8 + i] = (uint8_t)(cb >> (56 - 8 * i));
    }
    y = ghash_update(y, ctx->h[0], _mm_loadu_si128((const __m128i *)lens));
    __m128i ek = aes256_enc(ctx->rk, j0);
    return _mm_xor_si128(bswap16(y), ek);
}

int fspann_gcm_seal(const void *vctx, const uint8_t iv[12],
                    const uint8_t *aad, size_t aad_len,
                    const uint8_t *pt, size_t pt_len,
                    uint8_t *ct, uint8_t tag[16]) {
    const gcm_ctx *ctx = (const gcm_ctx *)vctx;
    __m128i j0 = make_j0(iv);
    ctr_xcrypt(ctx, j0, pt, ct, pt_len);
    __m128i t = gcm_tag(ctx, j0, aad, aad_len, ct, pt_len);
    _mm_storeu_si128((__m128i *)tag, t);
    return 0;
}

int fspann_gcm_open(const void *vctx, const uint8_t iv[12],
                    const uint8_t *aad, size_t aad_len,
                    const uint8_t *ct, size_t ct_len,
                    const uint8_t tag[16], uint8_t *pt) {
    const gcm_ctx *ctx = (const gcm_ctx *)vctx;
    __m128i j0 = make_j0(iv);
    __m128i t = gcm_tag(ctx, j0, aad, aad_len, ct, ct_len);
    /* constant-time tag compare */
    __m128i diff = _mm_xor_si128(t, _mm_loadu_si128((const __m128i *)tag));
    if (_mm_movemask_epi8(_mm_cmpeq_epi8(diff, _mm_setzero_si128())) != 0xffff)
        return -1;
    ctr_xcrypt(ctx, j0, ct, pt, ct_len);
    return 0;
}

/* ------------------------------------------------------------------ */
/* Short-record open: the serving hot path                             */
/*                                                                     */
/* A candidate open is a ~150-550 B record: 2 AAD blocks + 9-35 CT     */
/* blocks + 1 length block.  The generic path pays, per record, a      */
/* serial GHASH reduce every 64 B, 15 per-call zmm round-key          */
/* broadcasts, and a separate serial E(J0).  This specialization:      */
/*   - aggregates the ENTIRE record's GHASH into unreduced partial     */
/*     products against a precomputed descending power table           */
/*     (H^nb..H^1) — ONE gcm_reduce per record, no latency chain;      */
/*   - folds E(J0) into the VAES counter batch (counters 1..nct+1,     */
/*     block 0 is the tag mask) with round keys preloaded from ctx;    */
/*   - applies the keystream with 64-B vector XORs + masked tail.      */
/* Exact GCM math — bit-identical results to fspann_gcm_open; the      */
/* dispatch falls back for records beyond the power table or on CPUs   */
/* without VAES/VPCLMULQDQ.  Measured ~1.8x on the 1M parity open      */
/* workload (346 -> ~190 ns compute per 256 B open, 1-core Icelake).   */
/* ------------------------------------------------------------------ */

#if defined(__x86_64__) && defined(__GNUC__)
__attribute__((target("avx512f,avx512bw,vaes,vpclmulqdq")))
static int gcm_open_short(const gcm_ctx *ctx, const uint8_t iv[12],
                          const uint8_t aad[32], const uint8_t *ct,
                          size_t ct_len, const uint8_t *tag, uint8_t *pt) {
    const size_t nct = (ct_len + 15) >> 4;
    const size_t nb = 3 + nct;            /* 2 AAD + CT + len block */
    if (nb > GCM_SHORT_MAX_BLOCKS)
        return -2;                        /* caller takes the generic path */

    /* gather the GHASH stream contiguously (all L1): aad | ct | pad | len */
    uint8_t buf[(GCM_SHORT_MAX_BLOCKS + 1) * 16]
        __attribute__((aligned(64)));
    memcpy(buf, aad, 32);
    memcpy(buf + 32, ct, ct_len);
    if (nct * 16 != ct_len)
        memset(buf + 32 + ct_len, 0, nct * 16 - ct_len);
    {
        uint8_t *lenb = buf + 32 + nct * 16;
        uint64_t ab = 32u * 8u, cb = (uint64_t)ct_len * 8u;
        for (int i = 0; i < 8; i++) {
            lenb[i] = (uint8_t)(ab >> (56 - 8 * i));
            lenb[8 + i] = (uint8_t)(cb >> (56 - 8 * i));
        }
    }

    /* fully-aggregated GHASH: block j multiplies H^(nb-j); partial
     * products accumulate unreduced across the whole record */
    const __m512i rev512 = _mm512_broadcast_i32x4(
        _mm_set_epi8(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15));
    const __m128i *hp = ctx->hpow_desc + (GCM_SHORT_MAX_BLOCKS - nb);
    __m512i t00 = _mm512_setzero_si512(), t11 = _mm512_setzero_si512();
    __m512i mid = _mm512_setzero_si512();
    size_t j = 0;
    for (; j + 4 <= nb; j += 4) {
        __m512i blk = _mm512_loadu_si512((const void *)(buf + 16 * j));
        blk = _mm512_shuffle_epi8(blk, rev512);
        __m512i hv = _mm512_loadu_si512((const void *)(hp + j));
        t00 = _mm512_xor_si512(t00,
                               _mm512_clmulepi64_epi128(blk, hv, 0x00));
        t11 = _mm512_xor_si512(t11,
                               _mm512_clmulepi64_epi128(blk, hv, 0x11));
        mid = _mm512_xor_si512(mid,
              _mm512_xor_si512(_mm512_clmulepi64_epi128(blk, hv, 0x10),
                               _mm512_clmulepi64_epi128(blk, hv, 0x01)));
    }
    __m512i lo512 = _mm512_xor_si512(t00, _mm512_bslli_epi128(mid, 8));
    __m512i hi512 = _mm512_xor_si512(t11, _mm512_bsrli_epi128(mid, 8));
    __m256i lo256 = _mm256_xor_si256(_mm512_castsi512_si256(lo512),
                                     _mm512_extracti64x4_epi64(lo512, 1));
    __m256i hi256 = _mm256_xor_si256(_mm512_castsi512_si256(hi512),
                                     _mm512_extracti64x4_epi64(hi512, 1));
    __m128i lo = _mm_xor_si128(_mm256_castsi256_si128(lo256),
                               _mm256_extracti128_si256(lo256, 1));
    __m128i hi = _mm_xor_si128(_mm256_castsi256_si128(hi256),
                               _mm256_extracti128_si256(hi256, 1));
    for (; j < nb; j++) {                 /* tail blocks, still unreduced */
        __m128i hi2, lo2;
        clmul256(bswap16(_mm_loadu_si128((const __m128i *)(buf + 16 * j))),
                 hp[j], &hi2, &lo2);
        hi = _mm_xor_si128(hi, hi2);
        lo = _mm_xor_si128(lo, lo2);
    }
    __m128i y = gcm_reduce(hi, lo);

    /* keystream, E(J0) included: counters 1 (tag mask) .. nct+1 (data);
     * VAES 4 blocks per zmm, round keys preloaded from ctx->rk512 */
    uint8_t ks[(GCM_SHORT_MAX_BLOCKS + 4) * 16]
        __attribute__((aligned(64)));
    const __m512i base = _mm512_broadcast_i32x4(make_j0(iv));
    const size_t nks = nct + 1;
    for (size_t g = 0; g * 4 < nks; g += 4) {   /* chunks of 4 zmm */
        __m512i b[4];
        int live = 0;
        for (int t = 0; t < 4 && (g + t) * 4 < nks; t++, live++) {
            uint32_t c = 1 + 4 * (uint32_t)(g + t);
            __m512i cnt = _mm512_set_epi32(
                (int)__builtin_bswap32(c + 3), 0, 0, 0,
                (int)__builtin_bswap32(c + 2), 0, 0, 0,
                (int)__builtin_bswap32(c + 1), 0, 0, 0,
                (int)__builtin_bswap32(c), 0, 0, 0);
            b[t] = _mm512_xor_si512(
                _mm512_mask_blend_epi32(0x8888, base, cnt),
                _mm512_loadu_si512((const void *)ctx->rk512[0]));
        }
        for (int r = 1; r < 14; r++) {
            __m512i rkv = _mm512_loadu_si512((const void *)ctx->rk512[r]);
            for (int t = 0; t < live; t++)
                b[t] = _mm512_aesenc_epi128(b[t], rkv);
        }
        __m512i rkl = _mm512_loadu_si512((const void *)ctx->rk512[14]);
        for (int t = 0; t < live; t++)
            _mm512_store_si512((void *)(ks + 64 * (g + t)),
                               _mm512_aesenclast_epi128(b[t], rkl));
    }

    /* constant-time tag check: bswap(GHASH) ^ E(J0) vs stored tag */
    __m128i t = _mm_xor_si128(bswap16(y),
                              _mm_load_si128((const __m128i *)ks));
    __m128i diff = _mm_xor_si128(t, _mm_loadu_si128((const __m128i *)tag));
    if (_mm_movemask_epi8(_mm_cmpeq_epi8(diff, _mm_setzero_si128()))
            != 0xffff)
        return -1;

    /* decrypt: pt = ct ^ ks[1..]; 64-B vector XORs, masked tail (the
     * masked lanes read uninitialized ks bytes whose results the mask
     * store discards) */
    const uint8_t *k1 = ks + 16;
    size_t i = 0;
    for (; i + 64 <= ct_len; i += 64)
        _mm512_storeu_si512((void *)(pt + i),
            _mm512_xor_si512(
                _mm512_loadu_si512((const void *)(ct + i)),
                _mm512_loadu_si512((const void *)(k1 + i))));
    if (i < ct_len) {
        __mmask64 m = (__mmask64)((~0ull) >> (64 - (ct_len - i)));
        _mm512_mask_storeu_epi8((void *)(pt + i), m,
            _mm512_xor_si512(
                _mm512_maskz_loadu_epi8(m, (const void *)(ct + i)),
                _mm512_loadu_si512((const void *)(k1 + i))));
    }
    return 0;
}

static int fspann_has_short(void) {
    static int cached = -1;
    if (cached < 0)
        cached = fspann_has_vaes() && fspann_has_vpclmul();
    return cached;
}
#else
static int gcm_open_short(const gcm_ctx *ctx, const uint8_t iv[12],
                          const uint8_t aad[32], const uint8_t *ct,
                          size_t ct_len, const uint8_t *tag, uint8_t *pt) {
    (void)ctx; (void)iv; (void)aad; (void)ct; (void)ct_len; (void)tag;
    (void)pt;
    return -2;
}
static int fspann_has_short(void) { return 0; }
#endif

/* 32-byte-AAD record open with the short fast path + generic fallback.
 * Bit-identical results either way (both compute exact AES-256-GCM). */
static inline int gcm_open_rec(const gcm_ctx *ctx, const uint8_t *iv,
                               const uint8_t aad[32], const uint8_t *ct,
                               size_t ct_len, const uint8_t *tag,
                               uint8_t *pt) {
    if (fspann_has_short()) {
        int rc = gcm_open_short(ctx, iv, aad, ct, ct_len, tag, pt);
        if (rc != -2)
            return rc;
    }
    return fspann_gcm_open(ctx, iv, aad, 32, ct, ct_len, tag, pt);
}

/* ------------------------------------------------------------------ */
/* Batched entry points (the hot path)                                 */
/* ------------------------------------------------------------------ */

/* Seal n records under ONE key context.  Buffers are flat; per-record
 * extents come as (offset, length) arrays.  ct shares pt's offsets. */
int fspann_gcm_seal_batch(const void *vctx, size_t n,
                          const uint8_t *ivs,
                          const uint8_t *aad, const uint64_t *aad_off,
                          const uint64_t *aad_len,
                          const uint8_t *pt, const uint64_t *off,
                          const uint64_t *len,
                          uint8_t *ct, uint8_t *tags) {
    for (size_t i = 0; i < n; i++) {
        fspann_gcm_seal(vctx, ivs + 12 * i, aad + aad_off[i], aad_len[i],
                        pt + off[i], len[i], ct + off[i], tags + 16 * i);
    }
    return 0;
}

/* Open n records, each under the key context selected by key_idx[i] into a
 * packed array of contexts (ctx_stride bytes apart).  ok[i] = 1 on tag
 * match, 0 on failure (output zeroed).  Returns count of failures. */
int fspann_gcm_open_batch(const void *ctxs, size_t ctx_stride,
                          const uint32_t *key_idx, size_t n,
                          const uint8_t *ivs,
                          const uint8_t *aad, const uint64_t *aad_off,
                          const uint64_t *aad_len,
                          const uint8_t *ct, const uint64_t *off,
                          const uint64_t *len,
                          const uint8_t *tags, uint8_t *pt, uint8_t *ok) {
    int failures = 0;
    for (size_t i = 0; i < n; i++) {
        const void *c = (const uint8_t *)ctxs + ctx_stride * key_idx[i];
        int rc = fspann_gcm_open(c, ivs + 12 * i, aad + aad_off[i],
                                 aad_len[i], ct + off[i], len[i],
                                 tags + 16 * i, pt + off[i]);
        ok[i] = (uint8_t)(rc == 0);
        if (rc != 0) {
            memset(pt + off[i], 0, len[i]);
            failures++;
        }
    }
    return failures;
}

/* Record-oriented open: decrypt n fixed-layout records IN PLACE out of one
 * base buffer (e.g. an mmap'd arena) — record i's IV/ciphertext/tag live at
 * base + rec_off[i] + {iv_rel, ct_rel, tag_rel}.  Plaintext row i lands at
 * pt + pt_off[i] (scatter-write).  Removes every copy between storage, AES
 * and the caller's output rows —
 * on bandwidth-starved hosts the copies, not the AES, are the bottleneck. */
int fspann_gcm_open_batch_rec(const void *ctxs, size_t ctx_stride,
                              const uint32_t *key_idx, size_t n,
                              const uint8_t *base, const uint64_t *rec_off,
                              uint32_t iv_rel, uint32_t ct_rel,
                              uint32_t tag_rel, uint64_t ct_len,
                              const uint8_t *aad, const uint64_t *aad_off,
                              const uint64_t *aad_len,
                              uint8_t *pt, const uint64_t *pt_off,
                              uint8_t *ok) {
    int failures = 0;
    for (size_t i = 0; i < n; i++) {
        const uint8_t *rec = base + rec_off[i];
        const void *c = (const uint8_t *)ctxs + ctx_stride * key_idx[i];
        int rc = fspann_gcm_open(c, rec + iv_rel, aad + aad_off[i],
                                 aad_len[i], rec + ct_rel, ct_len,
                                 rec + tag_rel, pt + pt_off[i]);
        ok[i] = (uint8_t)(rc == 0);
        if (rc != 0) {
            memset(pt + pt_off[i], 0, ct_len);
            failures++;
        }
    }
    return failures;
}

/* AAD synthesis fused into the open loop.  The AAD format is fixed-width
 * ("id:%010u|v:%08u|d:%05u", 32 bytes — common/EncryptedPoint AAD binding);
 * building it per record in a stack buffer costs a few ALU ops in L1,
 * whereas materializing an [n, 32] AAD matrix in numpy costs a full extra
 * DRAM pass over the candidate set — measured as large as the AES itself
 * on the bandwidth-starved host (scripts/profile_decrypt.py). */
static inline void fspann_format_aad(uint8_t *out, uint64_t id, uint32_t kv,
                                     uint32_t dim) {
    memcpy(out, "id:", 3);
    for (int i = 12; i >= 3; i--) { out[i] = (uint8_t)('0' + id % 10); id /= 10; }
    memcpy(out + 13, "|v:", 3);
    for (int i = 23; i >= 16; i--) { out[i] = (uint8_t)('0' + kv % 10); kv /= 10; }
    memcpy(out + 24, "|d:", 3);
    for (int i = 31; i >= 27; i--) { out[i] = (uint8_t)('0' + dim % 10); dim /= 10; }
}

/* Software-prefetch lookahead (records) for the open loops.  Default 4;
 * FSPANN_PF_DEPTH overrides (0 disables, clamped to 16).  Read once per
 * process — flipping it live is not supported. */
static size_t fspann_pf_depth(void) {
    static long cached = -1;
    if (cached < 0) {
        const char *e = getenv("FSPANN_PF_DEPTH");
        long v = e ? atol(e) : 4;
        if (v < 0) v = 0;
        if (v > 16) v = 16;
        cached = v;
    }
    return (size_t)cached;
}

/* open_batch_rec variant for the query hot path: one key version per call,
 * AADs synthesized from the candidate ids instead of passed as a matrix. */
static int open_batch_rec_id_range(const void *ctx,
                                   size_t lo, size_t hi,
                                   const uint8_t *base,
                                   const uint64_t *rec_off,
                                   uint32_t iv_rel, uint32_t ct_rel,
                                   uint32_t tag_rel, uint64_t ct_len,
                                   const int64_t *ids, uint32_t key_version,
                                   uint32_t dim,
                                   uint8_t *pt, const uint64_t *pt_off,
                                   uint8_t *ok,
                                   /* optional: squared-L2 norm of each
                                    * decrypted f32 row, written at
                                    * norms[pt_off[i]/row_stride] while the
                                    * plaintext is still in L1 — saves the
                                    * refine stage a full re-read pass over
                                    * the candidate matrix.  NULL to skip. */
                                   float *norms,
                                   /* payload_kind: 0 = f32 rows; 1 = f16
                                    * rows (little-endian halves; decrypt
                                    * lands in a scratch row and is widened
                                    * to f32 at pt+pt_off[i] in the same
                                    * L1-resident pass, norms included —
                                    * replaces the two full numpy passes
                                    * the Python f16 path needed); 2 = i8
                                    * rows with a per-row f32 scale prefix
                                    * ([scale f32 LE][dim x int8], v_j =
                                    * scale * q_j) — 4x less arena traffic
                                    * than f32, dequant fused the same way.
                                    * The scale rides INSIDE the ciphertext
                                    * so it is both confidential and tag-
                                    * authenticated. */
                                   int payload_kind,
                                   /* fused query scoring: when qvecs is
                                    * non-NULL, also write dots[row] =
                                    * <decrypted f32 row, qvecs[row /
                                    * rows_per_query]> (row = pt_off[i] /
                                    * row_stride) while the plaintext is in
                                    * L1.  With pt == NULL the plaintext is
                                    * decrypted into a thread-local scratch
                                    * row and NEVER written to DRAM — the
                                    * refine stage then needs only (dots,
                                    * norms), eliminating both the staging
                                    * write and the candidate-matrix re-read
                                    * on the DRAM-bandwidth-bound host. */
                                   const float *qvecs,
                                   uint64_t rows_per_query, float *dots) {
    int failures = 0;
    uint8_t aad[32];
    uint8_t scratch_stack[8192];
    uint8_t *scratch = NULL;
    const int score_only = (pt == NULL);
    /* scratch: one ct_len decrypt row.  Neither quantized kind ever
     * materializes a widened f32 row for scoring — f16 fuses norm+dot into
     * the cvtph pass, i8 accumulates straight from the int8 lanes
     * (norm = s^2 * sum q^2, dot = s * sum q*qv). */
    size_t scratch_need;
    if (payload_kind == 1 || payload_kind == 2)
        scratch_need = (size_t)ct_len;
    else
        scratch_need = score_only ? (size_t)ct_len : 0;
    if (scratch_need)
        scratch = (scratch_need <= sizeof(scratch_stack))
            ? scratch_stack : (uint8_t *)malloc(scratch_need);
    /* decoded output rows are always f32 [dim] regardless of payload kind
     * (f32: ct_len = 4*dim; f16: 2*(2*dim); i8: dim+4 with 4*dim out) */
    const uint64_t row_stride = 4ull * dim;
    if (scratch_need && scratch == NULL) {
        /* allocation failure: fail the whole range cleanly (ok=0, zeroed
         * plaintext + norms) instead of dereferencing NULL below */
        for (size_t i = lo; i < hi; i++) {
            if (pt) memset(pt + pt_off[i], 0, row_stride);
            ok[i] = 0;
            if (norms) norms[pt_off[i] / row_stride] = 0.f;
            if (dots) dots[pt_off[i] / row_stride] = 0.f;
        }
        return (int)(hi - lo);
    }
#if defined(__F16C__)
    const int have_f16c = __builtin_cpu_supports("f16c");
#else
    const int have_f16c = 0;
#endif
    /* records sit at ~10-20KB strides (candidate sets are sparse in the
     * arena) — beyond the hardware prefetcher's reach, so software-prefetch
     * ahead while the current record is in the AES units.  Depth swept on
     * the 1M f16 candidate-open workload (scripts/ab_prefetch_depth.py,
     * interleaved subprocess A/B): depths 1/2/4/8 land within host-weather
     * noise of each other (best 0.93-0.96 ms/q) — the one-record lookahead
     * already covers the latency on this host.  Kept as a knob
     * (FSPANN_PF_DEPTH) for hosts with deeper memory latency. */
    const size_t rec_span = (size_t)tag_rel + 16;
    const size_t pf_depth = fspann_pf_depth();
    for (size_t p = lo; p < lo + pf_depth && p < hi; p++) {
        const uint8_t *nxt = base + rec_off[p];
        for (size_t o = 0; o < rec_span; o += 64)
            __builtin_prefetch(nxt + o, 0, 1);
    }
    for (size_t i = lo; i < hi; i++) {
        if (i + pf_depth < hi) {
            const uint8_t *nxt = base + rec_off[i + pf_depth];
            for (size_t o = 0; o < rec_span; o += 64)
                __builtin_prefetch(nxt + o, 0, 1);
        }
        const uint8_t *rec = base + rec_off[i];
        const uint64_t row = pt_off[i] / row_stride;
        const float *qv = qvecs ? qvecs + (row / rows_per_query)
                                      * (row_stride / 4) : NULL;
        fspann_format_aad(aad, (uint64_t)ids[i], key_version, dim);
        uint8_t *dst = (payload_kind != 0 || score_only) ? scratch
                                                         : pt + pt_off[i];
        int rc = gcm_open_rec(ctx, rec + iv_rel, aad,
                              rec + ct_rel, ct_len,
                              rec + tag_rel, dst);
        ok[i] = (uint8_t)(rc == 0);
        if (rc != 0) {
            /* keep every output buffer fully defined: zero the row AND its
             * norms/dots slots (callers mask by ok, but a reused staging
             * buffer must never leak a previous batch's values) */
            if (pt) memset(pt + pt_off[i], 0, row_stride);
            if (norms) norms[row] = 0.f;
            if (dots) dots[row] = 0.f;
            failures++;
            continue;
        }
        if (payload_kind == 2) {
            /* i8 + per-row scale: dequantize/score while the row is in L1.
             * Sums of q^2 and q*qv accumulate over the int8 lane values;
             * the scale factors out (norm = s^2*ssq, dot = s*sdot), so the
             * per-element work is one widen + two FMAs — and the AES above
             * only processed (dim+4) bytes instead of 4*dim. */
            float s;
            memcpy(&s, scratch, 4);
            const int8_t *qd = (const int8_t *)(scratch + 4);
            const size_t nd = (size_t)ct_len - 4;   /* == dim */
            float *o = score_only ? NULL : (float *)(pt + pt_off[i]);
            int64_t ssq = 0;
            float sd0 = 0.f, sd1 = 0.f, sd2 = 0.f, sd3 = 0.f;
            size_t j = 0;
            for (; j + 4 <= nd; j += 4) {
                int32_t q0 = qd[j], q1 = qd[j + 1],
                        q2 = qd[j + 2], q3 = qd[j + 3];
                ssq += (int64_t)(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3);
                if (o) {
                    o[j] = s * (float)q0;
                    o[j + 1] = s * (float)q1;
                    o[j + 2] = s * (float)q2;
                    o[j + 3] = s * (float)q3;
                }
                if (qv) {
                    sd0 += (float)q0 * qv[j];
                    sd1 += (float)q1 * qv[j + 1];
                    sd2 += (float)q2 * qv[j + 2];
                    sd3 += (float)q3 * qv[j + 3];
                }
            }
            for (; j < nd; j++) {
                int32_t q0 = qd[j];
                ssq += (int64_t)(q0 * q0);
                if (o) o[j] = s * (float)q0;
                if (qv) sd0 += (float)q0 * qv[j];
            }
            if (norms) norms[row] = s * s * (float)ssq;
            if (qv) dots[row] = s * (sd0 + sd1 + sd2 + sd3);
        } else if (payload_kind == 1) {
            /* widen f16 -> f32 while the row is in L1, norm AND query dot
             * fused into the SAME vector pass; in score_only mode the
             * widened row is never materialized at all (it used to be
             * written to scratch then re-read by a separate 4-wide scalar
             * dot loop — a full extra row pass per open) */
            const uint16_t *h = (const uint16_t *)scratch;
            float *o = score_only ? NULL : (float *)(pt + pt_off[i]);
            size_t nd = ct_len / 2, j = 0;
            float acc = 0.f, dot = 0.f;
#if defined(__F16C__)
            if (have_f16c) {
                __m256 vacc = _mm256_setzero_ps();
                __m256 vdot = _mm256_setzero_ps();
                for (; j + 8 <= nd; j += 8) {
                    __m256 f = _mm256_cvtph_ps(
                        _mm_loadu_si128((const __m128i *)(h + j)));
                    if (o)
                        _mm256_storeu_ps(o + j, f);
                    vacc = _mm256_add_ps(vacc, _mm256_mul_ps(f, f));
                    if (qv)
                        vdot = _mm256_add_ps(vdot,
                            _mm256_mul_ps(f, _mm256_loadu_ps(qv + j)));
                }
                float lanes[8];
                _mm256_storeu_ps(lanes, vacc);
                for (int l = 0; l < 8; l++) acc += lanes[l];
                if (qv) {
                    _mm256_storeu_ps(lanes, vdot);
                    for (int l = 0; l < 8; l++) dot += lanes[l];
                }
            }
#endif
            for (; j < nd; j++) {
                /* scalar half->float (normal/subnormal/inf/nan) */
                uint16_t x = h[j];
                uint32_t sign = (uint32_t)(x & 0x8000) << 16;
                uint32_t expo = (x >> 10) & 0x1f;
                uint32_t mant = x & 0x3ff;
                uint32_t bits;
                if (expo == 0x1f) {
                    bits = sign | 0x7f800000u | (mant << 13);
                } else if (expo == 0) {
                    if (mant == 0) bits = sign;
                    else {
                        expo = 127 - 15 + 1;
                        while (!(mant & 0x400)) { mant <<= 1; expo--; }
                        mant &= 0x3ff;
                        bits = sign | (expo << 23) | (mant << 13);
                    }
                } else {
                    bits = sign | ((expo - 15 + 127) << 23) | (mant << 13);
                }
                float f;
                memcpy(&f, &bits, 4);
                if (o) o[j] = f;
                acc += f * f;
                if (qv) dot += f * qv[j];
            }
            if (norms) norms[row] = acc;
            if (qv) dots[row] = dot;
        } else if (norms || qv) {
            const float *v = (const float *)dst;
            size_t nd = ct_len / 4;
            float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
            float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
            size_t j = 0;
            if (qv) {
                /* one L1-resident pass: norm + query dot fused */
                for (; j + 4 <= nd; j += 4) {
                    acc0 += v[j] * v[j];
                    acc1 += v[j + 1] * v[j + 1];
                    acc2 += v[j + 2] * v[j + 2];
                    acc3 += v[j + 3] * v[j + 3];
                    d0 += v[j] * qv[j];
                    d1 += v[j + 1] * qv[j + 1];
                    d2 += v[j + 2] * qv[j + 2];
                    d3 += v[j + 3] * qv[j + 3];
                }
                for (; j < nd; j++) {
                    acc0 += v[j] * v[j];
                    d0 += v[j] * qv[j];
                }
                dots[row] = d0 + d1 + d2 + d3;
            } else {
                for (; j + 4 <= nd; j += 4) {
                    acc0 += v[j] * v[j];
                    acc1 += v[j + 1] * v[j + 1];
                    acc2 += v[j + 2] * v[j + 2];
                    acc3 += v[j + 3] * v[j + 3];
                }
                for (; j < nd; j++) acc0 += v[j] * v[j];
            }
            if (norms) norms[row] = acc0 + acc1 + acc2 + acc3;
        }
    }
    if (scratch && scratch != scratch_stack) free(scratch);
    return failures;
}

#include <pthread.h>

typedef struct {
    const void *ctx;
    size_t lo, hi;
    const uint8_t *base;
    const uint64_t *rec_off;
    uint32_t iv_rel, ct_rel, tag_rel;
    uint64_t ct_len;
    const int64_t *ids;
    uint32_t key_version, dim;
    uint8_t *pt;
    const uint64_t *pt_off;
    uint8_t *ok;
    float *norms;
    int payload_kind;
    const float *qvecs;
    uint64_t rows_per_query;
    float *dots;
    int failures;
} open_task;

static void *open_worker(void *p) {
    open_task *t = (open_task *)p;
    t->failures = open_batch_rec_id_range(
        t->ctx, t->lo, t->hi, t->base, t->rec_off, t->iv_rel, t->ct_rel,
        t->tag_rel, t->ct_len, t->ids, t->key_version, t->dim, t->pt,
        t->pt_off, t->ok, t->norms, t->payload_kind, t->qvecs,
        t->rows_per_query, t->dots);
    return NULL;
}

/* Batch open, optionally parallel.  Each record's outputs (ok[i],
 * pt+pt_off[i], norms slot) are disjoint per index, so a contiguous range
 * split is race-free; the expanded key context is read-only shared.  The
 * decrypt stage is the serving bottleneck and scales linearly with cores —
 * nthreads <= 1 keeps the single-threaded path (this build host has one
 * core; production hosts set FSPANN_THREADS). */
static int open_batch_rec_id_impl(const void *ctx, size_t n,
                                  const uint8_t *base,
                                  const uint64_t *rec_off,
                                  uint32_t iv_rel, uint32_t ct_rel,
                                  uint32_t tag_rel, uint64_t ct_len,
                                  const int64_t *ids, uint32_t key_version,
                                  uint32_t dim,
                                  uint8_t *pt, const uint64_t *pt_off,
                                  uint8_t *ok, float *norms, int nthreads,
                                  int payload_kind, const float *qvecs,
                                  uint64_t rows_per_query, float *dots) {
    if (nthreads <= 1 || n < 1024) {
        return open_batch_rec_id_range(ctx, 0, n, base, rec_off, iv_rel,
                                       ct_rel, tag_rel, ct_len, ids,
                                       key_version, dim, pt, pt_off, ok,
                                       norms, payload_kind, qvecs,
                                       rows_per_query, dots);
    }
    enum { MAX_THREADS = 64 };
    if (nthreads > MAX_THREADS) nthreads = MAX_THREADS;
    open_task tasks[MAX_THREADS];
    pthread_t tids[MAX_THREADS];
    int created[MAX_THREADS] = {0};
    size_t per = (n + (size_t)nthreads - 1) / (size_t)nthreads;
    int spawned = 0;
    for (int t = 0; t < nthreads; t++) {
        size_t lo = (size_t)t * per;
        if (lo >= n) break;
        size_t hi = lo + per < n ? lo + per : n;
        open_task task = {ctx, lo, hi, base, rec_off, iv_rel, ct_rel,
                          tag_rel, ct_len, ids, key_version, dim, pt,
                          pt_off, ok, norms, payload_kind, qvecs,
                          rows_per_query, dots, 0};
        tasks[t] = task;
        if (t == nthreads - 1 || hi == n) {
            /* run the last slice on the calling thread */
            tasks[t].failures = open_batch_rec_id_range(
                ctx, lo, hi, base, rec_off, iv_rel, ct_rel, tag_rel, ct_len,
                ids, key_version, dim, pt, pt_off, ok, norms, payload_kind,
                qvecs, rows_per_query, dots);
            spawned = t;
            break;
        }
        if (pthread_create(&tids[t], NULL, open_worker, &tasks[t]) != 0) {
            /* failed create (EAGAIN on a loaded host): run the slice
             * inline — never an undecrypted range or a join on an
             * uninitialized handle */
            open_worker(&tasks[t]);
            created[t] = 0;
        } else {
            created[t] = 1;
        }
    }
    int failures = tasks[spawned].failures;
    for (int t = 0; t < spawned; t++) {
        if (created[t]) pthread_join(tids[t], NULL);
        failures += tasks[t].failures;
    }
    return failures;
}

int fspann_gcm_open_batch_rec_id(const void *ctx, size_t n,
                                 const uint8_t *base, const uint64_t *rec_off,
                                 uint32_t iv_rel, uint32_t ct_rel,
                                 uint32_t tag_rel, uint64_t ct_len,
                                 const int64_t *ids, uint32_t key_version,
                                 uint32_t dim,
                                 uint8_t *pt, const uint64_t *pt_off,
                                 uint8_t *ok, float *norms, int nthreads,
                                 int payload_kind) {
    return open_batch_rec_id_impl(ctx, n, base, rec_off, iv_rel, ct_rel,
                                  tag_rel, ct_len, ids, key_version, dim,
                                  pt, pt_off, ok, norms, nthreads,
                                  payload_kind, NULL, 1, NULL);
}

/* Fused decrypt-and-score (the serving stage-B hot path): per record,
 * verify+decrypt, then compute the squared L2 norm AND the dot product
 * against the record's query vector while the plaintext is in L1.  With
 * pt == NULL the plaintext never touches DRAM at all — the refine stage
 * works from (dots, norms) alone: d2 = |c|^2 - 2<c,q> + |q|^2.  Removes
 * BOTH full passes over the candidate matrix (staging write + einsum
 * re-read) that the unfused path pays on a bandwidth-bound host. */
int fspann_gcm_open_batch_rec_id_scored(
        const void *ctx, size_t n, const uint8_t *base,
        const uint64_t *rec_off, uint32_t iv_rel, uint32_t ct_rel,
        uint32_t tag_rel, uint64_t ct_len, const int64_t *ids,
        uint32_t key_version, uint32_t dim, uint8_t *pt,
        const uint64_t *pt_off, uint8_t *ok, float *norms,
        const float *qvecs, uint64_t rows_per_query, float *dots,
        int nthreads, int payload_kind) {
    return open_batch_rec_id_impl(ctx, n, base, rec_off, iv_rel, ct_rel,
                                  tag_rel, ct_len, ids, key_version, dim,
                                  pt, pt_off, ok, norms, nthreads,
                                  payload_kind, qvecs,
                                  rows_per_query ? rows_per_query : 1, dots);
}

/* Fused re-encrypt: open under ctx_old, seal under ctx_new with fresh IVs;
 * one pass over the data for selective re-encryption sweeps. */
int fspann_gcm_rekey_batch(const void *ctx_old_arr, size_t ctx_stride,
                           const uint32_t *key_idx, const void *ctx_new,
                           size_t n,
                           const uint8_t *ivs_old, const uint8_t *ivs_new,
                           const uint8_t *aad_old, const uint64_t *aad_old_off,
                           const uint64_t *aad_old_len,
                           const uint8_t *aad_new, const uint64_t *aad_new_off,
                           const uint64_t *aad_new_len,
                           const uint8_t *ct_in, const uint64_t *off,
                           const uint64_t *len,
                           const uint8_t *tags_in,
                           uint8_t *ct_out, uint8_t *tags_out, uint8_t *ok) {
    int failures = 0;
    uint8_t scratch[4096];
    for (size_t i = 0; i < n; i++) {
        uint8_t *buf = scratch;
        if (len[i] > sizeof(scratch)) { ok[i] = 0; failures++; continue; }
        const void *c = (const uint8_t *)ctx_old_arr + ctx_stride * key_idx[i];
        int rc = fspann_gcm_open(c, ivs_old + 12 * i,
                                 aad_old + aad_old_off[i], aad_old_len[i],
                                 ct_in + off[i], len[i], tags_in + 16 * i, buf);
        if (rc != 0) { ok[i] = 0; failures++; continue; }
        fspann_gcm_seal(ctx_new, ivs_new + 12 * i,
                        aad_new + aad_new_off[i], aad_new_len[i],
                        buf, len[i], ct_out + off[i], tags_out + 16 * i);
        /* zeroize plaintext scratch (reference EncryptionUtils zeroize) */
        memset(buf, 0, len[i]);
        ok[i] = 1;
    }
    return failures;
}

/* ------------------------------------------------------------------ */
/* Record framing helpers (arena/metadata log hot paths)               */
/* ------------------------------------------------------------------ */

/* Slice-by-4 CRC32 (zlib-compatible, reflected poly 0xEDB88320) over n
 * fixed-length rows of a flat buffer — replaces n Python zlib calls in the
 * arena batch-append path. */
static uint32_t crc32_tab[4][256];
static int crc32_init_done = 0;

static void crc32_init(void) {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc32_tab[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++) {
        crc32_tab[1][i] = (crc32_tab[0][i] >> 8)
            ^ crc32_tab[0][crc32_tab[0][i] & 0xff];
        crc32_tab[2][i] = (crc32_tab[1][i] >> 8)
            ^ crc32_tab[0][crc32_tab[1][i] & 0xff];
        crc32_tab[3][i] = (crc32_tab[2][i] >> 8)
            ^ crc32_tab[0][crc32_tab[2][i] & 0xff];
    }
    crc32_init_done = 1;
}

static uint32_t crc32_one(const uint8_t *p, size_t len) {
    uint32_t c = 0xFFFFFFFFu;
    while (len >= 4) {
        c ^= (uint32_t)p[0] | ((uint32_t)p[1] << 8)
           | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
        c = crc32_tab[3][c & 0xff] ^ crc32_tab[2][(c >> 8) & 0xff]
          ^ crc32_tab[1][(c >> 16) & 0xff] ^ crc32_tab[0][c >> 24];
        p += 4; len -= 4;
    }
    while (len--) c = crc32_tab[0][(c ^ *p++) & 0xff] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

void fspann_crc32_rows(const uint8_t *buf, size_t n, size_t row_len,
                       uint32_t *out) {
    if (!crc32_init_done) crc32_init();
    for (size_t i = 0; i < n; i++)
        out[i] = crc32_one(buf + i * row_len, row_len);
}
