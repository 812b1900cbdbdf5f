// The eq table of a point r (s variables) in one launch: eq_table_kernel.
//
// Replaces zinc_tpu/poly/device.py:69-77 (_eq_table_device) and
// zinc_tpu/sumcheck/mxu_exec.py:835 (build_eq_suffix_flat), jitted XLA
// programs in the reference, not Pallas.  Level k of the table is the eq
// table of r[k:] (2^(s−k) entries, bit j of an index ↔ r[k+j]); level s is
// [1̂], and level k comes from level k+1 by the recurrence
//     out[2i+1] = buf[i]·r_k·R⁻¹,   out[2i] = buf[i] − out[2i+1]   (mod q),
// one Montgomery product a pair.  The table is written level after level,
// level 0 first (2^(s+1) − 1 entries), or, for the callers that take only
// the full table, level 0 alone (the ALL flag: no other level is written).
// Every entry is the canonical Montgomery residue of one ring element, the
// product of (1 − r_j) or r_j over its bits, so the words equal the plain
// chain's (ops/field_kernels.eq_levels_plain) whatever order the products
// take.
//
// What bounds it on the H100: a 2^20 table at 8 words is 2^20 − 1
// products, 4N² + 2N integer slots each (0.0171 ms), against 64 MB of
// levels written once (0.0200 ms at 3.35 TB/s; level 0 alone 0.0100 ms).
// The chain it replaced was one launch a level: 20 launches, 20 host calls
// and each level read back from memory to make the next.  This design:
//   * Block b of 2^t (t = s − e) owns the slice of each level k ≤ e whose
//     indices have b as their top t bits.  It first forms its entry of
//     level e, the product of the t factors (1 − r_{e+j}) or r_{e+j} picked
//     by b's bits: warp 0 holds a factor a lane and takes their suffix
//     products by a Hillis-Steele scan of ⌈log2 t⌉ product steps, so lane j
//     holds the entry b >> j of level e + j (written by the block whose low
//     j bits are 0: every entry of the top levels exactly once).
//   * It then doubles its entry e times in shared memory, a pair a thread
//     a level, and writes each level's slice (contiguous: 2^(e−k) entries
//     at b·2^(e−k)) from shared memory with 16-byte stores.  Nothing is read
//     back from device memory but r.
// What holds it back is the product's latency (one Montgomery product at 8
// words is a chain of some 300 dependent multiply-adds): a block's scan and
// its first doublings keep few threads busy.  Two levels a step (three
// independent products an entry) and a two-launch split (a block-wide table
// of the low variables, then one product an entry) were tried on the H100
// and measured no faster at 8 words and slower at 16, so the recurrence
// stays a level a step.
// e is the host's choice (ops/field_kernels.eq_block_levels): the largest
// for which the two buffers, 1.5·2^e entries, fit 48 KB, at most 10, so a
// 2^20 table is 1024 blocks of 256 threads, about 4% more products (the
// scans) than the chain.  One launch a table, whatever its size.

#include "field.cuh"

#define ZT_EQ_BLOCK 256
#define ZT_EQ_SMEM_LIMIT (48 * 1024)

struct EqArgs {
    FieldParams f;
    uint32_t one[ZT_MAX_WORDS];  // 1̂ = R mod q
    int s, e;                    // variables; levels a block doubles its entry
};

template <int N>
__device__ __forceinline__ void copy_elem(uint32_t (&x)[N], const uint32_t* p) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
}

// The first entry of level k in the table's buffer: level 0 first.
__device__ __forceinline__ int64_t level_offset(int s, int k) {
    return (int64_t)(2ll << s) - (int64_t)(2ll << (s - k));
}

template <int N, bool ALL>
__global__ void __launch_bounds__(ZT_EQ_BLOCK) eq_table_kernel(uint32_t* __restrict__ out,
                                                               const uint32_t* __restrict__ r,
                                                               const EqArgs a) {
    extern __shared__ uint4 eq_smem[];
    const FieldParams& f = a.f;
    const int tid = threadIdx.x, s = a.s, e = a.e, t = s - e;
    const int64_t b = blockIdx.x;
    // level k of the block lies in buf[k & 1]: level 0 (2^e entries) in the
    // first, level 1 (2^(e−1)) in the second
    uint32_t* buf[2] = {reinterpret_cast<uint32_t*>(eq_smem),
                        reinterpret_cast<uint32_t*>(eq_smem) + ((int64_t)N << e)};

    if (tid < 32) {  // warp 0: the block's entries of levels e..s
        uint32_t x[N];
        copy_elem<N>(x, a.one);
        if (tid < t) {
            uint32_t rj[N];
            load_elem<N>(rj, r + (int64_t)(e + tid) * N);
            if ((b >> tid) & 1) {
                copy_elem<N>(x, rj);
            } else {
                sub_mod<N>(x, x, rj, f);
            }
        }
        // x_j ← Π_{i ≥ j} x_i (lanes ≥ t keep 1̂)
        for (int d = 1; d < t; d <<= 1) {
            uint32_t y[N];
#pragma unroll
            for (int i = 0; i < N; ++i) y[i] = __shfl_down_sync(0xffffffffu, x[i], d);
            mont_mul<N>(y, x, y, f);
            if (tid + d < t) copy_elem<N>(x, y);
        }
        if (tid <= t && (ALL || e + tid == 0) && (b & ((1ll << tid) - 1)) == 0)
            store_elem<N>(out + (level_offset(s, e + tid) + (b >> tid)) * N, x);
        if (tid == 0) store_elem<N>(buf[e & 1], x);
    }
    __syncthreads();

    for (int k = e - 1; k >= 0; --k) {
        const int half = 1 << (e - 1 - k);  // entries of level k + 1 in this block
        const uint32_t* cur = buf[(k + 1) & 1];
        uint32_t* nxt = buf[k & 1];
        uint32_t rk[N];
        load_elem<N>(rk, r + (int64_t)k * N);
        for (int i = tid; i < half; i += ZT_EQ_BLOCK) {
            uint32_t x[N], hi[N], lo[N];
            load_elem<N>(x, cur + (int64_t)i * N);
            mont_mul<N>(hi, x, rk, f);
            sub_mod<N>(lo, x, hi, f);
            store_elem<N>(nxt + (int64_t)(2 * i) * N, lo);
            store_elem<N>(nxt + (int64_t)(2 * i + 1) * N, hi);
        }
        __syncthreads();
        if (ALL || k == 0) {  // the block's slice of level k, 16 bytes a thread a step
            const int vecs = half * N / 2;  // 2·half entries of N words, as uint4
            const uint4* src = reinterpret_cast<const uint4*>(nxt);
            uint4* dst = reinterpret_cast<uint4*>(
                out + ((ALL ? level_offset(s, k) : 0) + b * 2 * half) * N);
            for (int i = tid; i < vecs; i += ZT_EQ_BLOCK) dst[i] = src[i];
        }
    }
}

// The eq table of r ((s, N) words on the card) into out: all s + 1 levels,
// level 0 first (2^(s+1) − 1 entries), when all_levels, else level 0 (2^s
// entries).  Each block doubles its entry e times (0 ≤ e ≤ s, s − e ≤ 30,
// 1.5·2^e entries ≤ ZT_EQ_SMEM_LIMIT bytes); one launch.
extern "C" int zt_eq_table(void* out, const void* r, int s, int e, int all_levels, int n32,
                           const uint32_t* q, uint32_t qinv, const uint32_t* one, void* stream) {
    if (s < 0 || e < 0 || e > s || s - e > 30 || e > 20 ||
        ((int64_t)3 << e) * 2 * n32 > ZT_EQ_SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
    EqArgs a{};
    a.f = make_params(q, n32, qinv);
    for (int i = 0; i < n32 && i < ZT_MAX_WORDS; ++i) a.one[i] = one[i];
    a.s = s;
    a.e = e;
    const int smem = (3 << e) * 2 * n32;  // 1.5·2^e entries of 4·n32 bytes
    const unsigned grid = 1u << (s - e);
    cudaStream_t st = (cudaStream_t)stream;
    ZT_DISPATCH_WORDS(n32, {
        if (all_levels)
            eq_table_kernel<N, true><<<grid, ZT_EQ_BLOCK, smem, st>>>(
                (uint32_t*)out, (const uint32_t*)r, a);
        else
            eq_table_kernel<N, false><<<grid, ZT_EQ_BLOCK, smem, st>>>(
                (uint32_t*)out, (const uint32_t*)r, a);
    });
    return (int)cudaGetLastError();
}
