// The BLAKE3 Merkle trees of the Zip commit: leaves and merge levels.
//
// Replaces zinc_tpu/ops/blake3_kernel.py:48-175 (compress_batch, the lax.scan
// over the 7 rounds; hash_single_chunk_batch; merge_pairs_batch;
// limbs16_to_msg_words; merkle_tree_device), an XLA program in the reference,
// not Pallas.  Every node is one BLAKE3 compression of one 64-byte block from
// the IV at counter 0 with flags CHUNK_START | CHUNK_END | ROOT: a leaf hashes
// one codeword element's 8·kw-byte serialization, a merge the 64 bytes of its
// two children's digests.
//
// Layout.  R rows of N leaves (N a power of two) are one flat forest of R·N
// leaves: node k of a level has children 2k and 2k+1 of the level below, and
// no pair crosses a row while a level has two or more nodes a row.  The levels
// are written one after the other into one buffer of int64 lanes holding u32
// words (the plain version's dtype): 8 lanes a node, a level of M nodes after
// the levels below it.
//
// Design.  One thread a compression: the 16 message words and the 16 state
// words stay in registers, the rotations are funnel shifts, and the seven
// rounds and the message permutation between them are unrolled at compile
// time, so the permutation is a renaming of registers.  A block of
// T = 2^ZT_B3_LOG_BLOCK threads (given by the build from ops/blake3.py's
// LOG_BLOCK, which plans the launches with it)
// hashes T consecutive leaves (zt_blake3_leaves) or merges 2T consecutive
// nodes (zt_blake3_merge), then goes on merging its own subtree in shared
// memory, half the threads a level, writing every level it passes: `levels`
// merges in all, at most log2(T) after the leaves and log2(T) + 1 in a merge
// launch.  The wrapper (ops/blake3.py) asks no launch for more levels than a
// row has.
//
// What bounds it on the H100.  A G step is 2 three-input adds, 2 adds, 4
// xors and 4 rotations, 12 instructions at their fewest; a compression is
// 56 G steps and 8 xors, 680 instructions, of which the 456 xors and
// rotations have only the ALU pipe (64 lanes a clock an SM) while the adds
// may issue as IMAD on the FMA pipe (the SM issues 128 lanes a clock in
// all).  At 1024 rows of 2048 codewords (kw = 4) the tree is 1024 × 4095 =
// 4,193,280 compressions: 1.91 G ALU instructions over 132 SMs × 64 lanes ×
// 1,980 MHz ≈ 0.115 ms (all 2.85 G over 128 lanes ≈ 0.085 ms).  Its bytes,
// the 134 MB of int64 codeword lanes read and 268 MB of int64 levels
// written, take ≈ 0.120 ms at 3.35 TB/s, so the bytes bound it, with the ALU
// pipe close behind.  Nothing here is a product, and the design keeps the
// state out of memory so that the compressions' instructions and the
// levels' stores are all the card issues.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t IV0 = 0x6A09E667u, IV1 = 0xBB67AE85u, IV2 = 0x3C6EF372u, IV3 = 0xA54FF53Au,
                   IV4 = 0x510E527Fu, IV5 = 0x9B05688Cu, IV6 = 0x1F83D9ABu, IV7 = 0x5BE0CD19u;
constexpr uint32_t FLAGS = 1u | 2u | 8u;  // CHUNK_START | CHUNK_END | ROOT
#ifndef ZT_B3_LOG_BLOCK
#error "build with -DZT_B3_LOG_BLOCK (ops/blake3.py:LOG_BLOCK)"
#endif
constexpr int LOG_BLOCK = ZT_B3_LOG_BLOCK;
constexpr int BLOCK = 1 << LOG_BLOCK;  // threads a block: T

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

#define ZT_G(a, b, c, d, x, y)      \
    a = a + b + (x);                \
    d = rotr(d ^ a, 16);            \
    c = c + d;                      \
    b = rotr(b ^ c, 12);            \
    a = a + b + (y);                \
    d = rotr(d ^ a, 8);             \
    c = c + d;                      \
    b = rotr(b ^ c, 7);

// out = the first 8 words of compress(IV, m, counter 0, block_len, FLAGS);
// m is permuted in place.
__device__ __forceinline__ void compress(uint32_t (&out)[8], uint32_t (&m)[16], uint32_t block_len) {
    uint32_t s0 = IV0, s1 = IV1, s2 = IV2, s3 = IV3, s4 = IV4, s5 = IV5, s6 = IV6, s7 = IV7;
    uint32_t s8 = IV0, s9 = IV1, s10 = IV2, s11 = IV3, s12 = 0u, s13 = 0u, s14 = block_len,
             s15 = FLAGS;
#pragma unroll
    for (int r = 0; r < 7; ++r) {
        ZT_G(s0, s4, s8, s12, m[0], m[1]);
        ZT_G(s1, s5, s9, s13, m[2], m[3]);
        ZT_G(s2, s6, s10, s14, m[4], m[5]);
        ZT_G(s3, s7, s11, s15, m[6], m[7]);
        ZT_G(s0, s5, s10, s15, m[8], m[9]);
        ZT_G(s1, s6, s11, s12, m[10], m[11]);
        ZT_G(s2, s7, s8, s13, m[12], m[13]);
        ZT_G(s3, s4, s9, s14, m[14], m[15]);
        // MSG_PERMUTATION = [2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8]
        const uint32_t p[16] = {m[2], m[6], m[3],  m[10], m[7],  m[0],  m[4],  m[13],
                                m[1], m[11], m[12], m[5], m[9], m[14], m[15], m[8]};
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = p[i];
    }
    out[0] = s0 ^ s8;
    out[1] = s1 ^ s9;
    out[2] = s2 ^ s10;
    out[3] = s3 ^ s11;
    out[4] = s4 ^ s12;
    out[5] = s5 ^ s13;
    out[6] = s6 ^ s14;
    out[7] = s7 ^ s15;
}

#undef ZT_G

// node k of level l in a buffer of the levels above m0 nodes of level 0,
// whose first `skip` nodes are not in the buffer: the levels below l hold
// m0 + m0/2 + ... = 2·m0 − 2·(m0 >> l) nodes
__device__ __forceinline__ unsigned long long* node_at(unsigned long long* buf, int64_t m0,
                                                       int64_t skip, int l, int64_t k) {
    return buf + 8 * (2 * m0 - 2 * (m0 >> l) - skip + k);
}

__device__ __forceinline__ void store_digest(unsigned long long* p, const uint32_t (&h)[8]) {
    ulonglong2* v = reinterpret_cast<ulonglong2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = make_ulonglong2(h[2 * i], h[2 * i + 1]);
}

// The block's subtree from its level-`first` digests in sh (`width` of them,
// node base0 + t for thread t) up `levels` more levels, each written at
// level first + i of buf.  `valid` is the level-`first` node count of the
// whole forest.  Every thread of the block calls it.
__device__ __forceinline__ void merge_up(uint32_t (*sh)[8], unsigned long long* buf, int64_t m0,
                                         int64_t skip, int first, int64_t base0, int64_t valid,
                                         int levels) {
    const int t = threadIdx.x;
    int64_t base = base0, count = valid;
    for (int i = 1; i <= levels; ++i) {
        base >>= 1;
        count >>= 1;
        const int width = blockDim.x >> i;
        uint32_t m[16], h[8];
        const bool active = t < width && base + t < count;
        if (active) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                m[j] = sh[2 * t][j];
                m[8 + j] = sh[2 * t + 1][j];
            }
        }
        __syncthreads();
        if (active) {
            compress(h, m, 64u);
#pragma unroll
            for (int j = 0; j < 8; ++j) sh[t][j] = h[j];
            store_digest(node_at(buf, m0, skip, first + i, base + t), h);
        }
        __syncthreads();
    }
}

}  // namespace

// Leaves: thread t hashes leaf blockIdx.x·T + t of the R·N leaves; enc holds
// each leaf's w = 2·kw u32 words, one every `step` u32 (1: int32 lanes, 2:
// the low halves of int64 lanes).  Then `levels` merges in the block.
__global__ void __launch_bounds__(BLOCK) blake3_leaves_kernel(
    unsigned long long* __restrict__ buf, const uint32_t* __restrict__ enc, int64_t leaves, int w,
    int step, int levels) {
    __shared__ uint32_t sh[BLOCK][8];
    const int t = threadIdx.x;
    const int64_t base = (int64_t)blockIdx.x * blockDim.x;
    const int64_t leaf = base + t;
    if (leaf < leaves) {
        // the u64 word i of a codeword element serializes as BE(w[2i+1]) ‖ BE(w[2i])
        // (little-endian word order, big-endian bytes): message words 2i and 2i+1
        // are bswap(w[2i+1]) and bswap(w[2i]); the rest of the block is zero
        const uint32_t* p = enc + leaf * w * step;
        uint32_t m[16], h[8];
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = i < w ? __byte_perm(p[(i ^ 1) * step], 0u, 0x0123) : 0u;
        compress(h, m, 4u * w);
#pragma unroll
        for (int j = 0; j < 8; ++j) sh[t][j] = h[j];
        store_digest(node_at(buf, leaves, 0, 0, leaf), h);
    }
    __syncthreads();
    merge_up(sh, buf, leaves, 0, 0, base, leaves, levels);
}

// Merges: thread t merges nodes 2(blockIdx.x·T + t) and +1 of `in` (n nodes,
// int64 lanes of u32 words) into level 1 of buf, which holds the levels
// above `in`; then `levels` − 1 more merges in the block.
__global__ void __launch_bounds__(BLOCK) blake3_merge_kernel(
    unsigned long long* __restrict__ buf, const unsigned long long* __restrict__ in, int64_t n,
    int levels) {
    __shared__ uint32_t sh[BLOCK][8];
    const int t = threadIdx.x;
    const int64_t base = (int64_t)blockIdx.x * blockDim.x;
    const int64_t k = base + t;
    if (k < n / 2) {
        const unsigned long long* p = in + 16 * k;
        uint32_t m[16], h[8];
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = (uint32_t)p[i];
        compress(h, m, 64u);
#pragma unroll
        for (int j = 0; j < 8; ++j) sh[t][j] = h[j];
        store_digest(node_at(buf, n, n, 1, k), h);
    }
    __syncthreads();
    merge_up(sh, buf, n, n, 1, base, n / 2, levels - 1);
}

// buf: the levels 0..levels of `leaves` leaves (2·leaves − 2·(leaves >> levels)
// nodes of 8 int64 lanes); enc: leaves × w u32 words, each `step` u32 apart.
extern "C" int zt_blake3_leaves(void* buf, const void* enc, int64_t leaves, int w, int step,
                                int levels, void* stream) {
    if (leaves <= 0) return 0;
    if (w < 2 || w > 16 || w % 2 || (step != 1 && step != 2) || levels < 0 || levels > LOG_BLOCK ||
        leaves % (1ll << levels))
        return (int)cudaErrorInvalidValue;
    const int64_t grid = (leaves + BLOCK - 1) / BLOCK;
    blake3_leaves_kernel<<<(unsigned)grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (unsigned long long*)buf, (const uint32_t*)enc, leaves, w, step, levels);
    return (int)cudaGetLastError();
}

// buf: the levels 1..levels above the n nodes of `in` (n − 2·(n >> levels)
// nodes of 8 int64 lanes).
extern "C" int zt_blake3_merge(void* buf, const void* in, int64_t n, int levels, void* stream) {
    if (n <= 0) return 0;
    if (levels < 1 || levels > LOG_BLOCK + 1 || n % (1ll << levels)) return (int)cudaErrorInvalidValue;
    const int64_t grid = (n / 2 + BLOCK - 1) / BLOCK;
    blake3_merge_kernel<<<(unsigned)grid, BLOCK, 0, (cudaStream_t)stream>>>(
        (unsigned long long*)buf, (const unsigned long long*)in, n, levels);
    return (int)cudaGetLastError();
}
