// Montgomery arithmetic over N little-endian u32 words, for sm_90a.
//
// Field elements are the canonical Montgomery residues a·R mod q with
// R = 2^(32·N) (= 2^(64·n64), the radix the transcript sees), stored as N
// consecutive u32 words, one element after the other.  N = 2·n64 is even:
// an element is whole 16-byte vectors when N is a multiple of 4 and whole
// 8-byte vectors otherwise (64-, 192-, 320- and 448-bit fields).  Every
// kernel of the port includes this header; mont_mul() below is the device
// function of K1 that every other kernel calls.
//
// One library is built per word count: the sources are compiled with
// -DZT_WORDS=N, and ZT_DISPATCH_WORDS binds N to it (a launch at any other
// width returns cudaErrorInvalidValue).
//
// Why CUDA C++ and not Triton: CIOS is a chain of 32×32→64-bit products whose
// high halves carry into the next word.  Triton has no carry flags and no
// wide multiply-add, so the chain would become emulated 64-bit arithmetic on
// top of its block model.  Here the chains are inline PTX with the carry
// flag: mad.lo.cc / madc.lo.cc for the low halves, mad.hi.cc / madc.hi.cc
// for the high halves, addc for the carry out, so each 32×32-bit step is one
// multiply-add with carry (IMAD) and no 64-bit add and shift.  Consecutive
// asm statements pass the carry flag: no compiler-made instruction between
// them writes it (PTX sets the flag only in .cc instructions).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#ifndef ZT_WORDS
#error "build with -DZT_WORDS=<words per element> (2, 4, ..., 16)"
#endif

#define ZT_MAX_WORDS 16

static_assert(ZT_WORDS % 2 == 0 && ZT_WORDS >= 2 && ZT_WORDS <= ZT_MAX_WORDS,
              "ZT_WORDS is 2·n64 for n64 = 1..8");

struct FieldParams {
    uint32_t q[ZT_MAX_WORDS];  // modulus words (first N used)
    uint32_t qinv;             // −q⁻¹ mod 2^32
};

struct Elem {
    uint32_t w[ZT_MAX_WORDS];
};

// ---------------------------------------------------------------------------
// carry-flag primitives (PTX)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
    uint32_t r;
    asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t r;
    asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

// ---------------------------------------------------------------------------
// loads and stores
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void load_elem(uint32_t (&x)[N], const uint32_t* __restrict__ p) {
    static_assert(N % 2 == 0, "elements are whole 8-byte vectors");
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N; i += 4) {
            const uint4 v = *reinterpret_cast<const uint4*>(p + i);
            x[i] = v.x;
            x[i + 1] = v.y;
            x[i + 2] = v.z;
            x[i + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; i += 2) {
            const uint2 v = *reinterpret_cast<const uint2*>(p + i);
            x[i] = v.x;
            x[i + 1] = v.y;
        }
    }
}

template <int N>
__device__ __forceinline__ void store_elem(uint32_t* __restrict__ p, const uint32_t (&x)[N]) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N; i += 4)
            *reinterpret_cast<uint4*>(p + i) = make_uint4(x[i], x[i + 1], x[i + 2], x[i + 3]);
    } else {
#pragma unroll
        for (int i = 0; i < N; i += 2) *reinterpret_cast<uint2*>(p + i) = make_uint2(x[i], x[i + 1]);
    }
}

// ---------------------------------------------------------------------------
// field operations on canonical residues (< q)
// ---------------------------------------------------------------------------

// r = a + b mod q, for a, b < q.  Correct for q > R/2 too: the carry out of
// the top word counts as "sum ≥ q".  r may alias a or b.
template <int N>
__device__ __forceinline__ void add_mod(uint32_t (&r)[N], const uint32_t (&a)[N],
                                        const uint32_t (&b)[N], const FieldParams& f) {
    uint32_t s[N], d[N];
    s[0] = add_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < N; ++i) s[i] = addc_cc(a[i], b[i]);
    const uint32_t c = addc(0u, 0u);
    d[0] = sub_cc(s[0], f.q[0]);
#pragma unroll
    for (int i = 1; i < N; ++i) d[i] = subc_cc(s[i], f.q[i]);
    // c − borrow is all ones exactly when the sum is below q
    const bool below = (int32_t)subc(c, 0u) < 0;
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = below ? s[i] : d[i];
}

// r = a − b mod q, for a, b < q.  r may alias a or b.
template <int N>
__device__ __forceinline__ void sub_mod(uint32_t (&r)[N], const uint32_t (&a)[N],
                                        const uint32_t (&b)[N], const FieldParams& f) {
    uint32_t d[N];
    d[0] = sub_cc(a[0], b[0]);
#pragma unroll
    for (int i = 1; i < N; ++i) d[i] = subc_cc(a[i], b[i]);
    const uint32_t mask = subc(0u, 0u);  // all ones after a borrow
    r[0] = add_cc(d[0], f.q[0] & mask);
#pragma unroll
    for (int i = 1; i < N; ++i) r[i] = addc_cc(d[i], f.q[i] & mask);
}

// r = a·b·R⁻¹ mod q (CIOS), for a, b < q.  r may alias a or b: both are read
// in full before r is written.  Per word of b: t += a·b[i] (a chain of low
// halves into t[j], then one of high halves into t[j+1]), m = t[0]·qinv,
// t += m·q the same way, and a shift by one word; 4N multiply-adds, so
// 4N² for the product.  t stays below 2q between words.
template <int N>
__device__ __forceinline__ void mont_mul(uint32_t (&r)[N], const uint32_t (&a)[N],
                                         const uint32_t (&b)[N], const FieldParams& f) {
    uint32_t t[N + 2];
#pragma unroll
    for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const uint32_t bi = b[i];
        t[0] = mad_lo_cc(a[0], bi, t[0]);
#pragma unroll
        for (int j = 1; j < N; ++j) t[j] = madc_lo_cc(a[j], bi, t[j]);
        t[N] = addc_cc(t[N], 0u);
        t[N + 1] = addc(t[N + 1], 0u);
        t[1] = mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
        for (int j = 1; j < N; ++j) t[j + 1] = madc_hi_cc(a[j], bi, t[j + 1]);
        t[N + 1] = addc(t[N + 1], 0u);

        const uint32_t m = t[0] * f.qinv;
        t[0] = mad_lo_cc(m, f.q[0], t[0]);  // 0, with its carry
#pragma unroll
        for (int j = 1; j < N; ++j) t[j] = madc_lo_cc(m, f.q[j], t[j]);
        t[N] = addc_cc(t[N], 0u);
        t[N + 1] = addc(t[N + 1], 0u);
        t[1] = mad_hi_cc(m, f.q[0], t[1]);
#pragma unroll
        for (int j = 1; j < N; ++j) t[j + 1] = madc_hi_cc(m, f.q[j], t[j + 1]);
        t[N + 1] = addc(t[N + 1], 0u);
#pragma unroll
        for (int j = 0; j <= N; ++j) t[j] = t[j + 1];
        t[N + 1] = 0;
    }
    // t < 2q: one conditional subtraction (t[N] is the bit above R)
    uint32_t d[N];
    d[0] = sub_cc(t[0], f.q[0]);
#pragma unroll
    for (int i = 1; i < N; ++i) d[i] = subc_cc(t[i], f.q[i]);
    const bool below = (int32_t)subc(t[N], 0u) < 0;
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = below ? t[i] : d[i];
}

// p = a·b, the full 2N-word product with no reduction (2N² multiply-adds,
// half a Montgomery product's).  Row 0 writes words 0..N; row i ≥ 1 adds
// a·b[i] at word i, its low halves carrying into word i+N (written fresh)
// and its high halves ending below word i+N+1.  A sum of such products is
// reduced once, by redc_wide.
template <int N>
__device__ __forceinline__ void mul_wide(uint32_t (&p)[2 * N], const uint32_t (&a)[N],
                                         const uint32_t (&b)[N]) {
    const uint32_t b0 = b[0];
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = a[j] * b0;
    p[1] = mad_hi_cc(a[0], b0, p[1]);
#pragma unroll
    for (int j = 1; j < N - 1; ++j) p[j + 1] = madc_hi_cc(a[j], b0, p[j + 1]);
    p[N] = madc_hi(a[N - 1], b0, 0u);
#pragma unroll
    for (int i = 1; i < N; ++i) {
        const uint32_t bi = b[i];
        p[i] = mad_lo_cc(a[0], bi, p[i]);
#pragma unroll
        for (int j = 1; j < N; ++j) p[i + j] = madc_lo_cc(a[j], bi, p[i + j]);
        p[i + N] = addc(0u, 0u);
        p[i + 1] = mad_hi_cc(a[0], bi, p[i + 1]);
#pragma unroll
        for (int j = 1; j < N - 1; ++j) p[i + j + 1] = madc_hi_cc(a[j], bi, p[i + j + 1]);
        p[i + N] = madc_hi(a[N - 1], bi, p[i + N]);
    }
}

// r = x mod q for x < 2^kbits·q held in N+1 words: subtracting q·2^i where
// it fits, for i from kbits−1 down to 0, leaves x below q.
template <int N>
__device__ __forceinline__ void reduce_below(uint32_t (&r)[N], uint32_t (&x)[N + 1], int kbits,
                                             const FieldParams& f) {
    for (int i = kbits - 1; i >= 0; --i) {
        uint32_t s[N + 1], d[N + 1];
        s[0] = f.q[0] << i;
#pragma unroll
        for (int j = 1; j < N; ++j) s[j] = __funnelshift_l(f.q[j - 1], f.q[j], i);
        s[N] = __funnelshift_l(f.q[N - 1], 0u, i);
        d[0] = sub_cc(x[0], s[0]);
#pragma unroll
        for (int j = 1; j <= N; ++j) d[j] = subc_cc(x[j], s[j]);
        const bool below = (int32_t)subc(0u, 0u) < 0;
#pragma unroll
        for (int j = 0; j <= N; ++j) x[j] = below ? x[j] : d[j];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) r[j] = x[j];
}

// r = w·R⁻¹ mod q for a sum w of 2N-word products of residues, held in 2N+1
// words: w < k·q·R for k terms, and kbits is the bit length of k (≥ 1).
// Montgomery's reduction, one word at a time, leaves x = (w + m·q)/R below
// (k+1)·q ≤ 2^kbits·q in N+1 words, which reduce_below takes below q.  w is
// overwritten.
template <int N>
__device__ __forceinline__ void redc_wide(uint32_t (&r)[N], uint32_t (&w)[2 * N + 1], int kbits,
                                          const FieldParams& f) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const uint32_t m = w[i] * f.qinv;
        w[i] = mad_lo_cc(m, f.q[0], w[i]);  // 0, with its carry
#pragma unroll
        for (int j = 1; j < N; ++j) w[i + j] = madc_lo_cc(m, f.q[j], w[i + j]);
#pragma unroll
        for (int k = i + N; k < 2 * N; ++k) w[k] = addc_cc(w[k], 0u);
        w[2 * N] = addc(w[2 * N], 0u);
        w[i + 1] = mad_hi_cc(m, f.q[0], w[i + 1]);
#pragma unroll
        for (int j = 1; j < N; ++j) w[i + j + 1] = madc_hi_cc(m, f.q[j], w[i + j + 1]);
#pragma unroll
        for (int k = i + N + 1; k < 2 * N; ++k) w[k] = addc_cc(w[k], 0u);
        w[2 * N] = addc(w[2 * N], 0u);
    }
    uint32_t x[N + 1];
#pragma unroll
    for (int j = 0; j <= N; ++j) x[j] = w[N + j];
    reduce_below<N>(r, x, kbits, f);
}

// ---------------------------------------------------------------------------
// host helpers
// ---------------------------------------------------------------------------

inline FieldParams make_params(const uint32_t* q, int n32, uint32_t qinv) {
    FieldParams f{};
    for (int i = 0; i < n32 && i < ZT_MAX_WORDS; ++i) f.q[i] = q[i];
    f.qinv = qinv;
    return f;
}

inline Elem make_elem(const uint32_t* w, int n32) {
    Elem e{};
    for (int i = 0; i < n32 && i < ZT_MAX_WORDS; ++i) e.w[i] = w[i];
    return e;
}

inline int grid_for(int64_t n, int block, int max_blocks) {
    int64_t g = (n + block - 1) / block;
    if (g < 1) g = 1;
    return (int)(g < max_blocks ? g : max_blocks);
}

// Runs the statement with `N` bound to this library's word count, and
// refuses any other (variadic, so launch syntax with commas passes through).
#define ZT_DISPATCH_WORDS(n32, ...)                               \
    do {                                                          \
        if ((n32) != ZT_WORDS) return (int)cudaErrorInvalidValue; \
        constexpr int N = ZT_WORDS;                               \
        __VA_ARGS__;                                              \
    } while (0)
