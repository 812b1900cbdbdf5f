// The Keccak-256 sponge (rate 136 bytes, pad 0x01 ... 0x80) spread over the
// lanes of one warp, and the transcript's byte framing: the sponge half of
// fs_round (fs.cu).  It replaces the reference's device sponge,
// zinc_tpu/ops/keccak_kernel.py:64 (keccak_f1600_device), :183 (absorb_dyn)
// and :206 (digest_dyn), and mirrors zinc_tpu_torch/hashing/keccak.py and
// zinc_tpu_torch/transcript.py bit for bit.
//
// Lane l < 25 of the warp holds state lane l = x + 5y of Keccak-f[1600] as
// two u32 registers (lo, hi); lanes 25-31 shadow lanes 0-6 with values no
// real lane reads.  A round is shuffles and a few logic operations a lane:
//   θ  the column parity C[x] from the four other lanes of the column, then
//      D = C[x−1] ^ rotl(C[x+1], 1) from lanes x−1 and x+1 of row 0;
//   ρ  a rotation of the lane by its own offset (keccak_rho);
//   π  one shuffle from the lane whose value lands here (keccak_pi_src);
//   χ  two shuffles, from lanes x+1 and x+2 of the row;
//   ι  the round constant on lane 0.
// The 24 rounds are a loop, not unrolled: one warp alone on its SM runs
// this, and its code must stay in the instruction cache.  (The single-thread
// permutation it replaces, unrolled in each of its call sites, took 5.6-15
// µs a permutation on the H100: instruction fetch, not arithmetic.)
//
// The message buffer lives in shared memory: the bytes not yet absorbed, at
// the buffer's start, followed by whatever the caller appends (frames, the
// ratchet).  Absorbing a block is lanes 0-16 each XORing their aligned
// 8-byte word of it; the leftover bytes move to the front a byte a lane;
// the sponge's words in device memory load and store a word a lane.  Every
// function here is called by all 32 lanes of the warp with the same length
// arguments.

#pragma once

#include <cstdint>

#define ZT_KECCAK_RATE 136
#define ZT_KECCAK_RATE_LANES (ZT_KECCAK_RATE / 8)
// 25 lanes as (lo, hi) u32 pairs, then the buffered bytes: the sponge's
// words in device memory (ops/keccak_kernel.py:STATE_WORDS)
#define ZT_KECCAK_STATE_WORDS (50 + ZT_KECCAK_RATE / 4)
#define ZT_WARP_ALL 0xffffffffu

// ρ: the rotation of lane x + 5y (FIPS 202, 3.2.2).  Lane 0 is not rotated;
// from (x, y) = (1, 0), step t = 0..23 rotates its lane by (t+1)(t+2)/2 mod
// 64 and moves on to (y, (2x + 3y) mod 5).
static __constant__ int keccak_rho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                                          25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
// π: lane x + 5y moves to lane y + 5·((2x + 3y) mod 5) (FIPS 202, 3.2.3), so
// keccak_pi_src[d] is the lane x + 5y with y + 5·((2x + 3y) mod 5) = d: the
// lane a shuffle into lane d reads.
static __constant__ int keccak_pi_src[25] = {0, 6,  12, 18, 24, 3, 9,  10, 16, 22, 1, 7, 13,
                                             19, 20, 4, 5, 11, 17, 23, 2, 8, 14, 15, 21};
// ι: the 24 round constants as (lo, hi) pairs
static __constant__ uint32_t keccak_rc[48] = {
    0x00000001u, 0x00000000u, 0x00008082u, 0x00000000u, 0x0000808Au, 0x80000000u,
    0x80008000u, 0x80000000u, 0x0000808Bu, 0x00000000u, 0x80000001u, 0x00000000u,
    0x80008081u, 0x80000000u, 0x00008009u, 0x80000000u, 0x0000008Au, 0x00000000u,
    0x00000088u, 0x00000000u, 0x80008009u, 0x00000000u, 0x8000000Au, 0x00000000u,
    0x8000808Bu, 0x00000000u, 0x0000008Bu, 0x80000000u, 0x00008089u, 0x80000000u,
    0x00008003u, 0x80000000u, 0x00008002u, 0x80000000u, 0x00000080u, 0x80000000u,
    0x0000800Au, 0x00000000u, 0x8000000Au, 0x80000000u, 0x80008081u, 0x80000000u,
    0x00008080u, 0x80000000u, 0x80000001u, 0x00000000u, 0x80008008u, 0x80000000u,
};

// The lanes a lane of the warp reads in a round, fixed for the kernel.
struct KeccakLanes {
    int col[4];  // θ: the other lanes of this lane's column
    int xm1, xp1;  // θ: columns x−1 and x+1 (row 0)
    int pi, rho;   // π's source lane, ρ's rotation
    int chi1, chi2;  // χ: lanes x+1 and x+2 of this row
    uint32_t first;  // all ones on lane 0 (ι)
};

__device__ __forceinline__ KeccakLanes keccak_lanes(int lane) {
    const int l = lane < 25 ? lane : lane - 25;
    const int x = l % 5, y = l / 5;
    KeccakLanes k;
#pragma unroll
    for (int i = 0; i < 4; ++i) k.col[i] = x + 5 * ((y + 1 + i) % 5);
    k.xm1 = (x + 4) % 5;
    k.xp1 = (x + 1) % 5;
    k.pi = keccak_pi_src[l];
    k.rho = keccak_rho[keccak_pi_src[l]];  // ρ rotates the lane π then moves here
    k.chi1 = (x + 1) % 5 + 5 * y;
    k.chi2 = (x + 2) % 5 + 5 * y;
    k.first = lane == 0 ? ZT_WARP_ALL : 0u;
    return k;
}

// (lo, hi) rotated left by n in 0..63
__device__ __forceinline__ void keccak_rotl(uint32_t& lo, uint32_t& hi, int n) {
    const uint32_t l = (n & 32) ? hi : lo, h = (n & 32) ? lo : hi;
    lo = __funnelshift_l(h, l, n & 31);
    hi = __funnelshift_l(l, h, n & 31);
}

__device__ __forceinline__ uint32_t shfl(uint32_t v, int src) {
    return __shfl_sync(ZT_WARP_ALL, v, src);
}

// Keccak-f[1600] of the warp's lanes.  ρ and π are applied in one step: the
// lane pulls its π source and rotates it by that source's ρ offset.
__device__ __forceinline__ void keccak_f1600_warp(uint32_t& lo, uint32_t& hi, const KeccakLanes& k) {
#pragma unroll 1
    for (int round = 0; round < 24; ++round) {
        uint32_t cl = lo, ch = hi;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            cl ^= shfl(lo, k.col[i]);
            ch ^= shfl(hi, k.col[i]);
        }
        const uint32_t pl = shfl(cl, k.xp1), ph = shfl(ch, k.xp1);
        lo ^= shfl(cl, k.xm1) ^ __funnelshift_l(ph, pl, 1);
        hi ^= shfl(ch, k.xm1) ^ __funnelshift_l(pl, ph, 1);
        uint32_t bl = shfl(lo, k.pi), bh = shfl(hi, k.pi);
        keccak_rotl(bl, bh, k.rho);
        const uint32_t l1 = shfl(bl, k.chi1), h1 = shfl(bh, k.chi1);
        const uint32_t l2 = shfl(bl, k.chi2), h2 = shfl(bh, k.chi2);
        lo = bl ^ (~l1 & l2) ^ (keccak_rc[2 * round] & k.first);
        hi = bh ^ (~h1 & h2) ^ (keccak_rc[2 * round + 1] & k.first);
    }
}

// Lanes 0-16 XOR their 8-byte word of the block at p (8-byte aligned).
__device__ __forceinline__ void keccak_xor_block(uint32_t& lo, uint32_t& hi, const uint8_t* p,
                                                 int lane) {
    if (lane < ZT_KECCAK_RATE_LANES) {
        const uint2 v = *reinterpret_cast<const uint2*>(p + 8 * lane);
        lo ^= v.x;
        hi ^= v.y;
    }
}

// Absorb every whole block of msg[0, len) (msg 8-byte aligned), move the
// remaining bytes to msg's start and return their count.
__device__ __forceinline__ int keccak_absorb_warp(uint32_t& lo, uint32_t& hi, uint8_t* msg,
                                                  int len, const KeccakLanes& k, int lane) {
    __syncwarp();
    int off = 0;
    for (; off + ZT_KECCAK_RATE <= len; off += ZT_KECCAK_RATE) {
        keccak_xor_block(lo, hi, msg + off, lane);
        keccak_f1600_warp(lo, hi, k);
    }
    if (off) {  // the leftover (< 136 bytes) lies past the first block: no overlap
        __syncwarp();
        for (int i = lane; i < len - off; i += 32) msg[i] = msg[off + i];
        __syncwarp();
    }
    return len - off;
}

// The squeeze of transcript.py:get_challenge on the sponge (lanes, msg[0,
// len)), len < 136: the digest d of the padded stream (from a copy of the
// lanes: the sponge's own lanes are left as they are), then the ratchet
// 0x00 ‖ d ‖ 0x01 written at msg + len.  Returns the new length (the caller
// absorbs the blocks); d lies at msg + len + 1.
__device__ __forceinline__ int keccak_squeeze_warp(uint32_t lo, uint32_t hi, uint8_t* msg, int len,
                                                   const KeccakLanes& k, int lane) {
    __syncwarp();
    for (int i = len + lane; i < ZT_KECCAK_RATE; i += 32)
        msg[i] = (i == len ? 0x01 : 0x00) ^ (i == ZT_KECCAK_RATE - 1 ? 0x80 : 0x00);
    __syncwarp();
    keccak_xor_block(lo, hi, msg, lane);
    keccak_f1600_warp(lo, hi, k);  // lanes 0-3 now hold the digest's 32 bytes
    if (lane < 4) {
#pragma unroll
        for (int b = 0; b < 8; ++b) msg[len + 1 + 8 * lane + b] = (uint8_t)((b < 4 ? lo : hi) >> (8 * (b % 4)));
    }
    if (lane == 4) {
        msg[len] = 0x00;
        msg[len + 33] = 0x01;
    }
    __syncwarp();
    return len + 34;
}

// The sponge from its words w (lanes, then the buffer) at fill level pos: a
// lane's two words into (lo, hi), the buffer's words into msg from its start
// (the bytes from pos on are left to be overwritten).
__device__ __forceinline__ void sponge_load_warp(uint32_t& lo, uint32_t& hi, uint8_t* msg,
                                                 const uint32_t* w, int pos, int lane) {
    const int l = lane < 25 ? lane : 0;
    lo = w[2 * l];
    hi = w[2 * l + 1];
    uint32_t* m = reinterpret_cast<uint32_t*>(msg);
    for (int i = lane; i < (pos + 3) / 4; i += 32) m[i] = w[50 + i];
    __syncwarp();  // before any lane writes a byte into the last word
}

// The sponge's words from the lanes and the pending bytes msg[0, pos), a
// word a lane; the buffer's bytes past pos are written as 0.
__device__ __forceinline__ void sponge_store_warp(uint32_t* w, uint32_t lo, uint32_t hi,
                                                  const uint8_t* msg, int pos, int lane) {
    __syncwarp();
    if (lane < 25) {
        w[2 * lane] = lo;
        w[2 * lane + 1] = hi;
    }
    const uint32_t* m = reinterpret_cast<const uint32_t*>(msg);
    for (int i = lane; i < ZT_KECCAK_RATE / 4; i += 32) {
        const int keep = pos - 4 * i;  // bytes of this word below pos
        w[50 + i] = keep >= 4 ? m[i] : keep <= 0 ? 0u : m[i] & ((1u << (8 * keep)) - 1u);
    }
}

// Byte j of absorb_field's frame (transcript.py), 0x03 ‖ q_be ‖ 0x05 0x01 ‖
// v_be ‖ 0x03, for n32-word q and v (little-endian words, written
// big-endian): 8·n32 + 4 bytes.
__device__ __forceinline__ uint8_t frame_byte(int j, const uint32_t* q, const uint32_t* v, int n32) {
    const int nb = 4 * n32;
    if (j == 0 || j == 2 * nb + 3) return 0x03;
    if (j == nb + 1) return 0x05;
    if (j == nb + 2) return 0x01;
    const uint32_t* src = j <= nb ? q : v;
    const int i = j <= nb ? j - 1 : j - nb - 3;  // big-endian byte of src
    return (uint8_t)(src[n32 - 1 - i / 4] >> (8 * (3 - i % 4)));
}

// get_challenge's value (transcript.py; not yet in Montgomery form) from the
// digest d, in n32 words: lo + hi·2^128 with lo and hi the big-endian halves
// of d, masked to min(qbits − 1, 256) bits.  Every regime of get_challenge
// is that mask: n64 = 1 keeps lo's low 64 bits and then qbits − 1 < 64 of
// them; q under 2^128 keeps qbits − 1 bits of lo, under 2^256 qbits − 129
// bits of hi, and from 2^256 on all 256.
template <int N>
__device__ __forceinline__ void challenge_value(uint32_t (&value)[N], const uint8_t* d, int qbits) {
    uint32_t x[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const uint8_t* p = d + 16 * half + 12 - 4 * j;
            x[4 * half + j] = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                              ((uint32_t)p[2] << 8) | (uint32_t)p[3];
        }
    const int keep = qbits - 1 < 256 ? qbits - 1 : 256;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const uint32_t w = i < 8 ? x[i < 8 ? i : 0] : 0u;
        const int avail = keep - 32 * i;
        value[i] = avail >= 32 ? w : avail <= 0 ? 0u : w & ((1u << avail) - 1u);
    }
}
