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
// memory, half the threads a level, writing every level it passes: at most
// log2(T) levels after the leaves and log2(T) + 1 in a merge launch.
//
// The cluster tail.  A leaves launch asked for more than log2(T) levels
// runs blake3_leaves_cluster_kernel in thread-block clusters of
// C = 2^(levels − log2 T) blocks, C at most 2^ZT_B3_LOG_CLUSTER
// (ops/blake3.py's LOG_CLUSTER; 8, the portable size): a row of up to C·T
// leaves is one cluster, so the 2^20 commit's tree (1024 rows of 2^11
// leaves) is one launch, and the merge launch it took before, which waited
// on the whole leaves launch to read 8 digests a row back from device
// memory, and its second call from the host, are gone.  Every thread
// arrives on the cluster barrier when it starts and again when it is done;
// warp 0 of each block writes the block's level-log2(T) digest into the
// first block's shared memory (distributed shared memory) before its second
// arrival, and only the first block's warp 0 waits, then merges the log2(C)
// levels above the C digests.  Once a block's levels are down to warp 0,
// its other warps leave (merge_up), in every launch.  zt_blake3_merge stays
// for rows deeper than a cluster covers and for merging the roots of a row
// split over devices.  The wrapper (ops/blake3.py:tree_plan) asks no launch
// for more levels than a row has.
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
// written, take ≈ 0.120 ms at 3.35 TB/s (bench_kernels.merkle_cases counts
// 0.1202 ms for the whole tree), so the bytes bound it, with the ALU pipe
// close behind.  What holds it back is residency: a block's levels above
// the leaves leave fewer threads busy each level, so the launch is bound by
// how many blocks the SMs hold and how long each stays.  The cluster tail
// adds log2(C) serial compressions in one block, and a cluster is placed
// only where all its blocks fit at once (62 clusters of 8 blocks at a time,
// at this kernel's 56 registers, against 5 blocks an SM at 48 without the
// tail).  Measured on one NVIDIA H100 80GB HBM3 at 700.00 W (bench_kernels.py, this
// design beside the one before it in one call): the 2^20 tree in this one
// launch 0.2965 ms, in the leaves launch and merge launch it replaces
// 0.2398 ms; the leaves launch without the tail 0.2277 ms (0.2314 before
// its warps left early).  Nothing here is a product, and the design keeps
// the state out of memory so that the compressions' instructions and the
// levels' stores are all the card issues.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t IV0 = 0x6A09E667u, IV1 = 0xBB67AE85u, IV2 = 0x3C6EF372u, IV3 = 0xA54FF53Au,
                   IV4 = 0x510E527Fu, IV5 = 0x9B05688Cu, IV6 = 0x1F83D9ABu, IV7 = 0x5BE0CD19u;
constexpr uint32_t FLAGS = 1u | 2u | 8u;  // CHUNK_START | CHUNK_END | ROOT
#ifndef ZT_B3_LOG_BLOCK
#error "build with -DZT_B3_LOG_BLOCK (ops/blake3.py:LOG_BLOCK)"
#endif
constexpr int LOG_BLOCK = ZT_B3_LOG_BLOCK;
constexpr int BLOCK = 1 << LOG_BLOCK;  // threads a block: T
#ifndef ZT_B3_LOG_CLUSTER
#error "build with -DZT_B3_LOG_CLUSTER (ops/blake3.py:LOG_CLUSTER)"
#endif
constexpr int LOG_CLUSTER = ZT_B3_LOG_CLUSTER;  // blocks a cluster: at most 2^LOG_CLUSTER
static_assert(LOG_CLUSTER >= 0 && LOG_CLUSTER <= 4, "a cluster holds at most 16 blocks");

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

// The block's subtree from its level-`first` digests in sh (`width0` of them,
// node base0 + t for thread t) up `levels` more levels, each written at
// level first + i of buf.  `valid` is the level-`first` node count of the
// whole forest.  Every thread of the block calls it.  Once a level's inputs
// all come from warp 0 (16 nodes or fewer), the other warps leave: they
// return false, and warp 0 syncs with __syncwarp from there.
__device__ __forceinline__ bool merge_up(uint32_t (*sh)[8], unsigned long long* buf, int64_t m0,
                                         int64_t skip, int first, int64_t base0, int64_t valid,
                                         int width0, int levels) {
    const int t = threadIdx.x;
    int64_t base = base0, count = valid;
#pragma unroll 1  // one compression in the code, also where `levels` is a constant
    for (int i = 1; i <= levels; ++i) {
        base >>= 1;
        count >>= 1;
        const int width = width0 >> i;
        const bool warp = width <= 16;
        if (warp && t >= 32) return false;
        uint32_t m[16], h[8];
        const bool active = t < width && base + t < count;
        if (active) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                m[j] = sh[2 * t][j];
                m[8 + j] = sh[2 * t + 1][j];
            }
        }
        if (warp) __syncwarp(); else __syncthreads();
        if (active) {
            compress(h, m, 64u);
#pragma unroll
            for (int j = 0; j < 8; ++j) sh[t][j] = h[j];
            store_digest(node_at(buf, m0, skip, first + i, base + t), h);
        }
        if (warp) __syncwarp(); else __syncthreads();
    }
    return true;
}

// The cluster barrier in two phases: every thread arrives once at its
// start (phase 1: its block has started, so its shared memory may be
// written) and once when it is done (phase 2); only the cluster's first
// block waits on phase 2.  A thread waits on phase 1 before it arrives again.
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed;" : : : "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
    asm volatile("barrier.cluster.arrive.release;" : : : "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait;" : : : "memory");
}

// The cluster tail of a leaves launch, in warp 0 of every block of a cluster
// of 2^up blocks, the block's level-LOG_BLOCK digest in sh[0]: each block
// writes it into the first block's `tops` through distributed shared
// memory and arrives; the first block waits for all of them and merges
// them up `up` levels (levels LOG_BLOCK + 1 .. LOG_BLOCK + up of the forest
// of `leaves` leaves).
__device__ __forceinline__ void cluster_tail(uint32_t (*sh)[8], unsigned long long* buf,
                                             int64_t leaves, int up) {
    __shared__ uint32_t tops[1 << LOG_CLUSTER][8];
    cg::cluster_group cluster = cg::this_cluster();
    const int t = threadIdx.x;
    const unsigned rank = cluster.block_rank();
    cluster_wait();  // phase 1: the first block has started
    if (t < 8) cluster.map_shared_rank(&tops[0][0], 0)[8 * rank + t] = sh[0][t];
    cluster_arrive_release();
    if (rank != 0) return;
    cluster_wait();  // phase 2: every block's digest is in tops
    merge_up(tops, buf, leaves, 0, LOG_BLOCK, blockIdx.x, leaves >> LOG_BLOCK, 1 << up, up);
}

// Leaves: thread t hashes leaf blockIdx.x·T + t of the R·N leaves; enc holds
// each leaf's w = 2·kw u32 words, one every `step` u32 (1: int32 lanes, 2:
// the low halves of int64 lanes).  Then `levels` merges: in the block, and
// with CLUSTER (levels > LOG_BLOCK, a cluster of 2^(levels − LOG_BLOCK)
// blocks) the rest in the cluster's first block.
template <bool CLUSTER>
__device__ __forceinline__ void leaves_body(unsigned long long* __restrict__ buf,
                                            const uint32_t* __restrict__ enc, int64_t leaves,
                                            int w, int step, int levels) {
    __shared__ uint32_t sh[BLOCK][8];
    if constexpr (CLUSTER) cluster_arrive_relaxed();  // phase 1
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
    [[maybe_unused]] const bool on =
        merge_up(sh, buf, leaves, 0, 0, base, leaves, BLOCK, CLUSTER ? LOG_BLOCK : levels);
    if constexpr (CLUSTER) {
        if (on) {
            cluster_tail(sh, buf, leaves, levels - LOG_BLOCK);
        } else {  // done: phase 2 at once
            cluster_wait();
            cluster_arrive_release();
        }
    }
}

}  // namespace

__global__ void __launch_bounds__(BLOCK) blake3_leaves_kernel(
    unsigned long long* __restrict__ buf, const uint32_t* __restrict__ enc, int64_t leaves, int w,
    int step, int levels) {
    leaves_body<false>(buf, enc, leaves, w, step, levels);
}

// The same in clusters.  Held to 4 blocks an SM: left to itself ptxas gives
// it 57 registers, and the launch was slower on the card than at the 56
// this bound gives (no spills).
__global__ void __launch_bounds__(BLOCK, 4) blake3_leaves_cluster_kernel(
    unsigned long long* __restrict__ buf, const uint32_t* __restrict__ enc, int64_t leaves, int w,
    int step, int levels) {
    leaves_body<true>(buf, enc, leaves, w, step, levels);
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
    merge_up(sh, buf, n, n, 1, base, n / 2, BLOCK, levels - 1);
}

namespace {

// a launch in clusters of `blocks` blocks; above the portable 8 the kernel
// must first allow it
cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, unsigned grid,
                           int blocks, cudaStream_t stream) {
    if (blocks > 8) {
        const cudaError_t e = cudaFuncSetAttribute(
            blake3_leaves_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
    }
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)blocks;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(BLOCK);
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaSuccess;
}

}  // namespace

// buf: the levels 0..levels of `leaves` leaves (2·leaves − 2·(leaves >> levels)
// nodes of 8 int64 lanes); enc: leaves × w u32 words, each `step` u32 apart.
// More than LOG_BLOCK levels launch in clusters; a refused cluster launch
// returns its error and is not retried another way.
extern "C" int zt_blake3_leaves(void* buf, const void* enc, int64_t leaves, int w, int step,
                                int levels, void* stream) {
    if (leaves <= 0) return 0;
    if (w < 2 || w > 16 || w % 2 || (step != 1 && step != 2) || levels < 0 ||
        levels > LOG_BLOCK + LOG_CLUSTER || leaves % (1ll << levels))
        return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((leaves + BLOCK - 1) / BLOCK);
    unsigned long long* out = (unsigned long long*)buf;
    const uint32_t* in = (const uint32_t*)enc;
    if (levels <= LOG_BLOCK) {
        blake3_leaves_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(out, in, leaves, w, step,
                                                                       levels);
        return (int)cudaGetLastError();
    }
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e =
        cluster_config(cfg, attr, grid, 1 << (levels - LOG_BLOCK), (cudaStream_t)stream);
    if (e == cudaSuccess)
        e = cudaLaunchKernelEx(&cfg, blake3_leaves_cluster_kernel, out, in, leaves, w, step, levels);
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
}

// *out: cudaOccupancyMaxActiveClusters of the leaves kernel's cluster launch
// in clusters of 2^log_cluster blocks (1 ≤ log_cluster ≤ 4), on the current
// card: how many such clusters it holds at once.
extern "C" int zt_blake3_max_clusters(int log_cluster, int* out) {
    if (log_cluster < 1 || log_cluster > 4) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = cluster_config(cfg, attr, 1u << log_cluster, 1 << log_cluster, nullptr);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveClusters(out, blake3_leaves_cluster_kernel, &cfg);
    return (int)e;
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
