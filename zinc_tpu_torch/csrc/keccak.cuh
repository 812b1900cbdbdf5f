// The Keccak-256 sponge (rate 136 bytes, pad 0x01 ... 0x80) and the
// transcript's byte framing, for one thread: the serial half of fs_round
// (fs.cu).  It replaces the reference's device sponge,
// zinc_tpu/ops/keccak_kernel.py:64 (keccak_f1600_device), :183 (absorb_dyn)
// and :206 (digest_dyn), and mirrors zinc_tpu_torch/hashing/keccak.py and
// zinc_tpu_torch/transcript.py bit for bit.
//
// The sponge is its 25 lanes and a message buffer: the bytes not yet
// absorbed, at the buffer's start, followed by whatever the caller appends
// (frames, the ratchet).  keccak_absorb_blocks takes every whole 136-byte
// block of the buffer, as 17 aligned 8-byte words, and moves the rest to
// the front, so the lanes see a block at a time, never a byte.  The
// permutation is written out with constant indices and its 24 rounds
// unrolled, so its lanes stay in registers.
//
// The code is plain C++ on uint64_t lanes with no CUDA intrinsic, so the
// same header compiles for the host (ZT_HD is then static inline).

#pragma once

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#define ZT_HD static __host__ __device__ __forceinline__
#define ZT_HD_NOINLINE static __host__ __device__ __noinline__
#else
#define ZT_HD static inline
#define ZT_HD_NOINLINE static inline
#endif

#define ZT_KECCAK_RATE 136
// 25 lanes as (lo, hi) u32 pairs, then the buffered bytes: the sponge's
// words in device memory (ops/keccak_kernel.py:STATE_WORDS)
#define ZT_KECCAK_STATE_WORDS (50 + ZT_KECCAK_RATE / 4)

ZT_HD uint64_t keccak_rotl(uint64_t v, int n) { return n ? (v << n) | (v >> (64 - n)) : v; }

ZT_HD void keccak_f1600(uint64_t (&s)[25]) {
    const uint64_t rc[24] = {
        0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
        0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
        0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
        0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
        0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
        0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
    };
    // rotation of lane x + 5y
    const int rot[25] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43,
                         25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14};
#pragma unroll
    for (int round = 0; round < 24; ++round) {
        uint64_t c[5], b[25];
#pragma unroll
        for (int x = 0; x < 5; ++x) c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
#pragma unroll
        for (int x = 0; x < 5; ++x) {
            const uint64_t d = c[(x + 4) % 5] ^ keccak_rotl(c[(x + 1) % 5], 1);
#pragma unroll
            for (int y = 0; y < 25; y += 5) s[y + x] ^= d;
        }
        // rho and pi: lane x + 5y, rotated, lands in lane y + 5·((2x + 3y) mod 5)
#pragma unroll
        for (int x = 0; x < 5; ++x)
#pragma unroll
            for (int y = 0; y < 5; ++y)
                b[y + 5 * ((2 * x + 3 * y) % 5)] = keccak_rotl(s[x + 5 * y], rot[x + 5 * y]);
#pragma unroll
        for (int y = 0; y < 25; y += 5)
#pragma unroll
            for (int x = 0; x < 5; ++x)
                s[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
        s[0] ^= rc[round];
    }
}

// The 8 little-endian bytes at p (8-byte aligned on the device).
ZT_HD uint64_t keccak_load_le64(const uint8_t* p) {
#ifdef __CUDA_ARCH__
    return *reinterpret_cast<const uint64_t*>(p);
#else
    uint64_t w;
    std::memcpy(&w, p, 8);
    return w;
#endif
}

// Absorb every whole block of msg[0, len) (msg 8-byte aligned), move the
// remaining bytes to msg's start and return their count.  The lanes are
// copied in and out once, so the loop keeps them in registers.
ZT_HD_NOINLINE int keccak_absorb_blocks(uint64_t (&s)[25], uint8_t* msg, int len) {
    uint64_t x[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) x[i] = s[i];
    int off = 0;
    for (; off + ZT_KECCAK_RATE <= len; off += ZT_KECCAK_RATE) {
#pragma unroll
        for (int i = 0; i < ZT_KECCAK_RATE / 8; ++i) x[i] ^= keccak_load_le64(msg + off + 8 * i);
        keccak_f1600(x);
    }
#pragma unroll
    for (int i = 0; i < 25; ++i) s[i] = x[i];
    for (int i = off; i < len; ++i) msg[i - off] = msg[i];
    return len - off;
}

// The 32-byte digest of the stream whose unabsorbed bytes are msg[0, len),
// len < 136; the lanes are left as they are, and msg's bytes from len on are
// overwritten (with the padding).
ZT_HD_NOINLINE void keccak_digest(const uint64_t (&s)[25], uint8_t* msg, int len,
                                  uint8_t (&out)[32]) {
    for (int i = len; i < ZT_KECCAK_RATE; ++i) msg[i] = 0;
    msg[len] ^= 0x01;
    msg[ZT_KECCAK_RATE - 1] ^= 0x80;
    uint64_t x[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) x[i] = s[i];
#pragma unroll
    for (int i = 0; i < ZT_KECCAK_RATE / 8; ++i) x[i] ^= keccak_load_le64(msg + 8 * i);
    keccak_f1600(x);
#pragma unroll
    for (int i = 0; i < 32; ++i) out[i] = (uint8_t)(x[i / 8] >> (8 * (i % 8)));
}

// The sponge from its words (lanes, then the buffer) at fill level pos: the
// lanes into s, the pending bytes into msg[0, pos).
ZT_HD void sponge_load(uint64_t (&s)[25], uint8_t* msg, const uint32_t* w, int pos) {
    for (int i = 0; i < 25; ++i) s[i] = (uint64_t)w[2 * i] | ((uint64_t)w[2 * i + 1] << 32);
    for (int i = 0; i < pos; ++i) msg[i] = (uint8_t)(w[50 + i / 4] >> (8 * (i % 4)));
}

// The sponge's words from s and the pending bytes msg[0, pos); the buffer's
// bytes past pos are written as 0.
ZT_HD void sponge_store(uint32_t* w, const uint64_t (&s)[25], const uint8_t* msg, int pos) {
    for (int i = 0; i < 25; ++i) {
        w[2 * i] = (uint32_t)s[i];
        w[2 * i + 1] = (uint32_t)(s[i] >> 32);
    }
    for (int i = 0; i < ZT_KECCAK_RATE / 4; ++i) {
        uint32_t x = 0;
        for (int k = 0; k < 4; ++k) {
            const int j = 4 * i + k;
            x |= (uint32_t)(j < pos ? msg[j] : 0) << (8 * k);
        }
        w[50 + i] = x;
    }
}

// absorb_field's bytes (transcript.py), 0x03 ‖ q_be ‖ 0x05 0x01 ‖ mont_be ‖
// 0x03, written at dst for n32-word q and mont (little-endian words, written
// big-endian); returns their count, 8·n32 + 4.
ZT_HD int put_field_frame(uint8_t* dst, const uint32_t* q, const uint32_t* mont, int n32) {
    const int nb = 4 * n32;
    dst[0] = 0x03;
    dst[nb + 1] = 0x05;
    dst[nb + 2] = 0x01;
    dst[2 * nb + 3] = 0x03;
    for (int i = 0; i < n32; ++i)
        for (int k = 0; k < 4; ++k) {
            const int at = 4 * (n32 - 1 - i) + (3 - k);
            dst[1 + at] = (uint8_t)(q[i] >> (8 * k));
            dst[nb + 3 + at] = (uint8_t)(mont[i] >> (8 * k));
        }
    return 2 * nb + 4;
}

// get_challenge's value (transcript.py; not yet in Montgomery form) from the
// digest d, in n32 words: lo + hi·2^128 with lo and hi the big-endian halves
// of d, masked to min(qbits − 1, 256) bits.  Every regime of get_challenge
// is that mask: n64 = 1 keeps lo's low 64 bits and then qbits − 1 < 64 of
// them; q under 2^128 keeps qbits − 1 bits of lo, under 2^256 qbits − 129
// bits of hi, and from 2^256 on all 256.
ZT_HD void challenge_value(uint32_t* value, const uint8_t (&d)[32], int n32, int qbits) {
    uint32_t x[8];
    for (int j = 0; j < 4; ++j)
        for (int half = 0; half < 2; ++half) {
            const uint8_t* p = d + 16 * half + 12 - 4 * j;
            x[4 * half + j] = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                              ((uint32_t)p[2] << 8) | (uint32_t)p[3];
        }
    const int keep = qbits - 1 < 256 ? qbits - 1 : 256;
    for (int i = 0; i < n32; ++i) {
        const uint32_t w = i < 8 ? x[i] : 0u;
        const int avail = keep - 32 * i;
        value[i] = avail >= 32 ? w : avail <= 0 ? 0u : w & ((1u << avail) - 1u);
    }
}

// The squeeze of transcript.py:get_challenge on the sponge (s, msg[0, len)):
// the digest d, then the ratchet 0x00 ‖ d ‖ 0x01 appended to msg; returns the
// new length (the caller absorbs the blocks).
ZT_HD int sponge_squeeze(const uint64_t (&s)[25], uint8_t* msg, int len, uint8_t (&d)[32]) {
    keccak_digest(s, msg, len, d);
    msg[len] = 0x00;
    for (int i = 0; i < 32; ++i) msg[len + 1 + i] = d[i];
    msg[len + 33] = 0x01;
    return len + 34;
}
