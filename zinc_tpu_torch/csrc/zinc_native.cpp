// zinc-tpu-torch native host runtime: Keccak-256 sponge + BLAKE3.
//
// The port's own copy of the JAX package's native/zinc_native.cpp, with one
// repair: zn_parallel_16aligned below sizes its chunks by ceiling division,
// so every batch tail reaches a thread at every thread count.
//
// The Fiat-Shamir transcript (Keccak-256, legacy 0x01 padding — the sha3
// crate's Keccak256 used at zinc/src/transcript.rs:15-18) and the
// Merkle hash (BLAKE3, zinc/src/zip/pcs/utils.rs:87-118) are the
// host-side hot paths of the verifier and of proof (de)serialization; this
// translation unit provides them as a small C ABI consumed via ctypes
// (zinc_tpu_torch/native.py).  Pure C++17, no external dependencies.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC -pthread -o libzinc_native.so zinc_native.cpp

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <cstdlib>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// Host parallelism for path-independent batches (Merkle folds, leaf hashes).
// ZINC_TPU_NATIVE_THREADS overrides (read per call so tests can vary it);
// default = hardware concurrency.  Chunks stay 16-aligned so the 16-lane
// AVX-512 blocks never split; each path's output is position-independent,
// so the split is bit-exact regardless of thread count.
// ---------------------------------------------------------------------------

static unsigned zn_nthreads() {
    const char* e = std::getenv("ZINC_TPU_NATIVE_THREADS");
    if (e && *e) {
        long v = std::strtol(e, nullptr, 10);
        return (unsigned)(v < 1 ? 1 : v > 256 ? 256 : v);
    }
    unsigned h = std::thread::hardware_concurrency();
    return h ? h : 1u;
}

template <class Fn>
static void zn_parallel_16aligned(uint64_t n, Fn fn) {
    const uint64_t kMinPerThread = 16 * 16;  // don't spawn under 256 paths/thread
    unsigned nt = zn_nthreads();
    if (nt > 1 && n / kMinPerThread < nt) nt = (unsigned)(n / kMinPerThread);
    if (nt <= 1) {
        fn((uint64_t)0, n);
        return;
    }
    // ceil(n / nt), rounded up to 16: chunk·nt ≥ n, so no tail is left out
    const uint64_t chunk = ((n + nt - 1) / nt + 15) / 16 * 16;
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < nt; ++t) {
        uint64_t lo = (uint64_t)t * chunk;
        if (lo >= n) break;
        uint64_t hi = lo + chunk < n ? lo + chunk : n;
        ts.emplace_back([=] { fn(lo, hi); });
    }
    for (auto& th : ts) th.join();
}

// ---------------------------------------------------------------------------
// Keccak-f[1600]
// ---------------------------------------------------------------------------

static const uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

static const int KECCAK_ROT[25] = {
    0,  1,  62, 28, 27,
    36, 44, 6,  55, 20,
    3,  10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2,  61, 56, 14,
};

static inline uint64_t rotl64(uint64_t v, int n) {
    return n == 0 ? v : (v << n) | (v >> (64 - n));
}

static void keccak_f1600(uint64_t s[25]) {
    for (int round = 0; round < 24; ++round) {
        uint64_t c[5], d[5], b[25];
        for (int x = 0; x < 5; ++x)
            c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
        for (int x = 0; x < 5; ++x)
            d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
        for (int y = 0; y < 25; y += 5)
            for (int x = 0; x < 5; ++x) s[y + x] ^= d[x];
        for (int x = 0; x < 5; ++x)
            for (int y = 0; y < 5; ++y)
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(s[x + 5 * y], KECCAK_ROT[x + 5 * y]);
        for (int y = 0; y < 25; y += 5)
            for (int x = 0; x < 5; ++x)
                s[y + x] = b[y + x] ^ ((~b[y + (x + 1) % 5]) & b[y + (x + 2) % 5]);
        s[0] ^= KECCAK_RC[round];
    }
}

static const size_t KECCAK_RATE = 136;  // Keccak-256

extern "C" {

// Absorb nblocks full 136-byte blocks into the 25-lane state (in place).
void zn_keccak_absorb_blocks(uint64_t* state, const uint8_t* blocks, uint64_t nblocks) {
    for (uint64_t blk = 0; blk < nblocks; ++blk) {
        const uint8_t* p = blocks + blk * KECCAK_RATE;
        for (size_t i = 0; i < KECCAK_RATE / 8; ++i) {
            uint64_t lane;
            std::memcpy(&lane, p + 8 * i, 8);
            state[i] ^= lane;  // little-endian host assumed (x86-64 / TPU VM)
        }
        keccak_f1600(state);
    }
}

// Finalize a COPY of the state with the buffered tail (< 136 bytes) using
// legacy Keccak 0x01 padding; writes the 32-byte digest.
void zn_keccak_finalize(const uint64_t* state, const uint8_t* tail, uint64_t taillen,
                        uint8_t* out32) {
    uint64_t s[25];
    std::memcpy(s, state, sizeof(s));
    uint8_t block[KECCAK_RATE];
    std::memset(block, 0, sizeof(block));
    std::memcpy(block, tail, taillen);
    block[taillen] ^= 0x01;
    block[KECCAK_RATE - 1] ^= 0x80;
    for (size_t i = 0; i < KECCAK_RATE / 8; ++i) {
        uint64_t lane;
        std::memcpy(&lane, block + 8 * i, 8);
        s[i] ^= lane;
    }
    keccak_f1600(s);
    std::memcpy(out32, s, 32);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BLAKE3 (hash-only mode, arbitrary length: chunks + binary merge tree)
// ---------------------------------------------------------------------------

static const uint32_t B3_IV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

static const uint8_t B3_MSG_PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};

enum {
    B3_CHUNK_START = 1 << 0,
    B3_CHUNK_END = 1 << 1,
    B3_PARENT = 1 << 2,
    B3_ROOT = 1 << 3,
};

static inline uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

static inline void b3_g(uint32_t* st, int a, int b, int c, int d, uint32_t mx, uint32_t my) {
    st[a] = st[a] + st[b] + mx;
    st[d] = rotr32(st[d] ^ st[a], 16);
    st[c] = st[c] + st[d];
    st[b] = rotr32(st[b] ^ st[c], 12);
    st[a] = st[a] + st[b] + my;
    st[d] = rotr32(st[d] ^ st[a], 8);
    st[c] = st[c] + st[d];
    st[b] = rotr32(st[b] ^ st[c], 7);
}

static void b3_compress(const uint32_t cv[8], const uint32_t block[16], uint64_t counter,
                        uint32_t block_len, uint32_t flags, uint32_t out[8]) {
    uint32_t st[16];
    std::memcpy(st, cv, 32);
    st[8] = B3_IV[0];
    st[9] = B3_IV[1];
    st[10] = B3_IV[2];
    st[11] = B3_IV[3];
    st[12] = (uint32_t)(counter & 0xFFFFFFFFu);
    st[13] = (uint32_t)(counter >> 32);
    st[14] = block_len;
    st[15] = flags;
    uint32_t m[16];
    std::memcpy(m, block, 64);
    for (int round = 0; round < 7; ++round) {
        b3_g(st, 0, 4, 8, 12, m[0], m[1]);
        b3_g(st, 1, 5, 9, 13, m[2], m[3]);
        b3_g(st, 2, 6, 10, 14, m[4], m[5]);
        b3_g(st, 3, 7, 11, 15, m[6], m[7]);
        b3_g(st, 0, 5, 10, 15, m[8], m[9]);
        b3_g(st, 1, 6, 11, 12, m[10], m[11]);
        b3_g(st, 2, 7, 8, 13, m[12], m[13]);
        b3_g(st, 3, 4, 9, 14, m[14], m[15]);
        if (round != 6) {
            uint32_t p[16];
            for (int i = 0; i < 16; ++i) p[i] = m[B3_MSG_PERM[i]];
            std::memcpy(m, p, 64);
        }
    }
    for (int i = 0; i < 8; ++i) out[i] = st[i] ^ st[i + 8];
}

// Hash one chunk (<= 1024 bytes) producing its chaining value; `flags_extra`
// carries ROOT when this chunk is the whole input.
static void b3_chunk_cv(const uint8_t* data, size_t len, uint64_t chunk_counter,
                        uint32_t flags_extra, uint32_t cv_out[8]) {
    uint32_t cv[8];
    std::memcpy(cv, B3_IV, 32);
    size_t nblocks = len == 0 ? 1 : (len + 63) / 64;
    for (size_t i = 0; i < nblocks; ++i) {
        uint32_t block[16];
        std::memset(block, 0, 64);
        size_t off = 64 * i;
        size_t blen = (len > off) ? (len - off < 64 ? len - off : 64) : 0;
        std::memcpy(block, data + off, blen);
        uint32_t flags = 0;
        if (i == 0) flags |= B3_CHUNK_START;
        if (i == nblocks - 1) flags |= B3_CHUNK_END | flags_extra;
        uint32_t out[8];
        b3_compress(cv, block, chunk_counter, (uint32_t)blen, flags, out);
        std::memcpy(cv, out, 32);
    }
    std::memcpy(cv_out, cv, 32);
}

// Merge two chaining values into a parent CV.
static void b3_parent_cv(const uint32_t l[8], const uint32_t r[8], uint32_t flags_extra,
                         uint32_t out[8]) {
    uint32_t block[16];
    std::memcpy(block, l, 32);
    std::memcpy(block + 8, r, 32);
    b3_compress(B3_IV, block, 0, 64, B3_PARENT | flags_extra, out);
}

// Number of chunks in the left subtree: largest power of two < total chunks.
static uint64_t b3_left_len(uint64_t chunks) {
    uint64_t p = 1;
    while (p * 2 < chunks) p *= 2;
    return p;
}

// Recursive subtree CV over whole chunks [start, start+chunks).
static void b3_subtree_cv(const uint8_t* data, uint64_t start_chunk, uint64_t chunks,
                          size_t nbytes, uint32_t cv_out[8]) {
    if (chunks == 1) {
        b3_chunk_cv(data, nbytes, start_chunk, 0, cv_out);
        return;
    }
    uint64_t left = b3_left_len(chunks);
    uint32_t lcv[8], rcv[8];
    b3_subtree_cv(data, start_chunk, left, left * 1024, lcv);
    b3_subtree_cv(data + left * 1024, start_chunk + left, chunks - left, nbytes - left * 1024,
                  rcv);
    b3_parent_cv(lcv, rcv, 0, cv_out);
}

// ---------------------------------------------------------------------------
// 16-lane vectorized BLAKE3 single-block compress (GCC vector extensions;
// lowers to AVX-512 / 2xAVX2 under -march=native).  Each lane is an
// independent message — used for batched equal-length leaf hashing and
// Merkle path folding where every compression is a one-block hash
// (cv = IV, counter = 0, CHUNK_START|CHUNK_END|ROOT).
// ---------------------------------------------------------------------------

typedef uint32_t v16 __attribute__((vector_size(64)));

static inline v16 rotr16v(v16 x, int n) { return (x >> n) | (x << (32 - n)); }

static inline void b3_g16(v16* st, int a, int b, int c, int d, v16 mx, v16 my) {
    st[a] = st[a] + st[b] + mx;
    st[d] = rotr16v(st[d] ^ st[a], 16);
    st[c] = st[c] + st[d];
    st[b] = rotr16v(st[b] ^ st[c], 12);
    st[a] = st[a] + st[b] + my;
    st[d] = rotr16v(st[d] ^ st[a], 8);
    st[c] = st[c] + st[d];
    st[b] = rotr16v(st[b] ^ st[c], 7);
}

// sched[r][i] = index into the ORIGINAL message of the word at position i in
// round r (replaces the physical permutation of the scalar path).
static uint8_t B3_SCHED[7][16];
static bool b3_sched_init = []() {
    for (int i = 0; i < 16; ++i) B3_SCHED[0][i] = (uint8_t)i;
    for (int r = 1; r < 7; ++r)
        for (int i = 0; i < 16; ++i) B3_SCHED[r][i] = B3_SCHED[r - 1][B3_MSG_PERM[i]];
    return true;
}();

// One-block hash of 16 lanes: m[16] transposed message words, block_len and
// flags shared across lanes; result (transposed) written into dig[8].
static void b3_compress16_oneblock(const v16 m[16], uint32_t block_len, v16 dig[8]) {
    v16 st[16];
    for (int i = 0; i < 8; ++i) st[i] = B3_IV[i] - v16{};  // broadcast
    st[8] = B3_IV[0] - v16{};
    st[9] = B3_IV[1] - v16{};
    st[10] = B3_IV[2] - v16{};
    st[11] = B3_IV[3] - v16{};
    st[12] = v16{};
    st[13] = v16{};
    st[14] = block_len - v16{};
    st[15] = (uint32_t)(B3_CHUNK_START | B3_CHUNK_END | B3_ROOT) - v16{};
    for (int r = 0; r < 7; ++r) {
        const uint8_t* s = B3_SCHED[r];
        b3_g16(st, 0, 4, 8, 12, m[s[0]], m[s[1]]);
        b3_g16(st, 1, 5, 9, 13, m[s[2]], m[s[3]]);
        b3_g16(st, 2, 6, 10, 14, m[s[4]], m[s[5]]);
        b3_g16(st, 3, 7, 11, 15, m[s[6]], m[s[7]]);
        b3_g16(st, 0, 5, 10, 15, m[s[8]], m[s[9]]);
        b3_g16(st, 1, 6, 11, 12, m[s[10]], m[s[11]]);
        b3_g16(st, 2, 7, 8, 13, m[s[12]], m[s[13]]);
        b3_g16(st, 3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (int i = 0; i < 8; ++i) dig[i] = st[i] ^ st[i + 8];
}

// Strided-path Merkle fold core: path p's siblings live at
//   sib_base + (p / paths_per_rec) * rec_stride + (p % paths_per_rec) * path_stride
// (depth consecutive 32-byte digests).  16 paths folded per vector group.
// Folds paths with GLOBAL indices in [q0, q1) — callers may split the batch
// across threads at 16-aligned boundaries (record/sibling addressing uses
// the global path index, so chunk offsets need no rebasing).
static void merkle_fold_core(const uint8_t* leaves, const uint8_t* sib_base,
                             uint64_t rec_stride, uint64_t paths_per_rec,
                             uint64_t path_stride, const uint64_t* indices, uint64_t q0,
                             uint64_t q1, uint64_t depth, uint8_t* out) {
    uint64_t p = q0;
    for (; p + 16 <= q1; p += 16) {
        const uint8_t* sib_ptr[16];
        uint64_t idx[16];
        v16 dig[8];
        uint32_t tmp[8][16];
        for (int l = 0; l < 16; ++l) {
            uint64_t q = p + l;
            sib_ptr[l] = sib_base + (q / paths_per_rec) * rec_stride +
                         (q % paths_per_rec) * path_stride;
            idx[l] = indices[q];
            uint32_t lw[8];
            std::memcpy(lw, leaves + 32 * q, 32);
            for (int w = 0; w < 8; ++w) tmp[w][l] = lw[w];
        }
        for (int w = 0; w < 8; ++w) std::memcpy(&dig[w], tmp[w], 64);
        for (uint64_t d = 0; d < depth; ++d) {
            v16 sib[8], bm;
            uint32_t bits[16];
            for (int l = 0; l < 16; ++l) {
                uint32_t sw[8];
                std::memcpy(sw, sib_ptr[l] + d * 32, 32);
                for (int w = 0; w < 8; ++w) tmp[w][l] = sw[w];
                bits[l] = (idx[l] >> d) & 1 ? 0xFFFFFFFFu : 0;
            }
            std::memcpy(&bm, bits, 64);
            for (int w = 0; w < 8; ++w) std::memcpy(&sib[w], tmp[w], 64);
            v16 m[16];
            for (int w = 0; w < 8; ++w) {
                m[w] = (sib[w] & bm) | (dig[w] & ~bm);      // left child
                m[8 + w] = (dig[w] & bm) | (sib[w] & ~bm);  // right child
            }
            b3_compress16_oneblock(m, 64, dig);
        }
        for (int w = 0; w < 8; ++w) std::memcpy(tmp[w], &dig[w], 64);
        for (int l = 0; l < 16; ++l) {
            uint32_t ow[8];
            for (int w = 0; w < 8; ++w) ow[w] = tmp[w][l];
            std::memcpy(out + 32 * (p + l), ow, 32);
        }
    }
    for (; p < q1; ++p) {  // scalar tail
        uint8_t cur[64], digest[32];
        std::memcpy(digest, leaves + 32 * p, 32);
        const uint8_t* sp = sib_base + (p / paths_per_rec) * rec_stride +
                            (p % paths_per_rec) * path_stride;
        uint64_t idx = indices[p];
        for (uint64_t d = 0; d < depth; ++d) {
            const uint8_t* sib = sp + d * 32;
            if (idx & 1) {
                std::memcpy(cur, sib, 32);
                std::memcpy(cur + 32, digest, 32);
            } else {
                std::memcpy(cur, digest, 32);
                std::memcpy(cur + 32, sib, 32);
            }
            uint32_t cv[8];
            uint32_t block[16];
            std::memcpy(block, cur, 64);
            b3_compress(B3_IV, block, 0, 64, B3_CHUNK_START | B3_CHUNK_END | B3_ROOT, cv);
            std::memcpy(digest, cv, 32);
            idx >>= 1;
        }
        std::memcpy(out + 32 * p, digest, 32);
    }
}

extern "C" {

void zn_blake3(const uint8_t* data, uint64_t len, uint8_t* out32) {
    uint64_t chunks = len <= 1024 ? 1 : (len + 1023) / 1024;
    if (chunks == 1) {
        uint32_t cv[8];
        b3_chunk_cv(data, len, 0, B3_ROOT, cv);
        std::memcpy(out32, cv, 32);
        return;
    }
    uint64_t left = b3_left_len(chunks);
    uint32_t lcv[8], rcv[8], root[8];
    b3_subtree_cv(data, 0, left, left * 1024, lcv);
    b3_subtree_cv(data + left * 1024, left, chunks - left, len - left * 1024, rcv);
    b3_parent_cv(lcv, rcv, B3_ROOT, root);
    std::memcpy(out32, root, 32);
}

// 16-lane one-block batch hash for equal-length messages <= 64 bytes.
static void blake3_batch_short(const uint8_t* data, uint64_t n, uint64_t msg_len,
                               uint8_t* out) {
    uint64_t p = 0;
    for (; p + 16 <= n; p += 16) {
        uint32_t tmp[16][16];
        std::memset(tmp, 0, sizeof(tmp));
        for (int l = 0; l < 16; ++l) {
            uint8_t block[64];
            std::memset(block, 0, 64);
            std::memcpy(block, data + (p + l) * msg_len, msg_len);
            uint32_t bw[16];
            std::memcpy(bw, block, 64);
            for (int w = 0; w < 16; ++w) tmp[w][l] = bw[w];
        }
        v16 m[16], dig[8];
        for (int w = 0; w < 16; ++w) std::memcpy(&m[w], tmp[w], 64);
        b3_compress16_oneblock(m, (uint32_t)msg_len, dig);
        uint32_t ot[8][16];
        for (int w = 0; w < 8; ++w) std::memcpy(ot[w], &dig[w], 64);
        for (int l = 0; l < 16; ++l) {
            uint32_t ow[8];
            for (int w = 0; w < 8; ++w) ow[w] = ot[w][l];
            std::memcpy(out + 32 * (p + l), ow, 32);
        }
    }
    for (; p < n; ++p) zn_blake3(data + p * msg_len, msg_len, out + 32 * p);
}

// n equal-length messages, contiguous with the given stride.
void zn_blake3_batch(const uint8_t* data, uint64_t n, uint64_t msg_len, uint8_t* out) {
    if (msg_len <= 64) {
        zn_parallel_16aligned(n, [&](uint64_t lo, uint64_t hi) {
            blake3_batch_short(data + lo * msg_len, hi - lo, msg_len, out + 32 * lo);
        });
        return;
    }
    zn_parallel_16aligned(n, [&](uint64_t lo, uint64_t hi) {
        for (uint64_t i = lo; i < hi; ++i)
            zn_blake3(data + i * msg_len, msg_len, out + 32 * i);
    });
}

// n digest pairs (64 bytes each) -> n parent digests (Merkle level merge).
void zn_blake3_merge_batch(const uint8_t* pairs, uint64_t n, uint8_t* out) {
    zn_parallel_16aligned(n, [&](uint64_t lo, uint64_t hi) {
        blake3_batch_short(pairs + lo * 64, hi - lo, 64, out + 32 * lo);
    });
}

// Verify a batch of Merkle paths: for each of n leaves, fold `depth`
// siblings (32 bytes each) using the leaf's index bits for ordering, and
// write the resulting root digest.  leaves: n x 32, siblings: n x depth x 32,
// indices: n leaf positions.  Roots are written to out (n x 32); the caller
// compares against the committed roots.
void zn_merkle_fold_batch(const uint8_t* leaves, const uint8_t* siblings,
                          const uint64_t* indices, uint64_t n, uint64_t depth, uint8_t* out) {
    zn_parallel_16aligned(n, [&](uint64_t lo, uint64_t hi) {
        merkle_fold_core(leaves, siblings, 0, n ? n : 1, depth * 32, indices, lo, hi,
                         depth, out);
    });
}

// Strided variant: paths_per_rec paths per record, records rec_stride bytes
// apart, paths path_stride bytes apart within a record (lets the verifier
// fold straight out of the raw proof buffer with no repacking copy).
void zn_merkle_fold_batch_strided(const uint8_t* leaves, const uint8_t* sib_base,
                                  uint64_t rec_stride, uint64_t paths_per_rec,
                                  uint64_t path_stride, const uint64_t* indices, uint64_t n,
                                  uint64_t depth, uint8_t* out) {
    zn_parallel_16aligned(n, [&](uint64_t lo, uint64_t hi) {
        merkle_fold_core(leaves, sib_base, rec_stride, paths_per_rec, path_stride,
                         indices, lo, hi, depth, out);
    });
}

}  // extern "C"
