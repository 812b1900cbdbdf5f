// The generic-combination sumcheck round kernels, over the tables layout of
// sumcheck.cu: table m, entry x at word offset (m·B + x)·N; a round pairs
// entries (2p, 2p+1).
//
// round_eval_generic replaces zinc_tpu/ops/pallas_field.py:round_eval_pallas
// (K7) and zinc_tpu/sumcheck/pallas_exec.py:_eval_fixed (K9).  For every term
// of the combination (1 or more factors, any number of points) it sums, over
// all pairs p and for t = 0..n_pts−1, the product Π_{k∈term} M_k(t, p) with
// M_k(t, p) = v0_k + t·(v1_k − v0_k), as exact 64-bit word columns.  The
// coefficient kinds u/n/g of the reference are applied to those sums on the
// host (they are linear), as for K3.
//
// fold_round_eval replaces pallas_exec.py:_fold_eval_fixed (K10).  One launch
// folds every table by r, v0 + r·(v1 − v0) over pairs (2x, 2x+1), into a
// fresh output, and gives the round sums of every term over the folded
// pairs.  The reference folds in place into the buffer's prefix, which is
// safe only because a Pallas grid runs in order; CUDA blocks do not, so a
// block would overwrite entries another block has yet to read.  A thread
// owns eval pair p of the folded tables: it folds raw entries 4p..4p+3 of
// every table into folded entries 2p, 2p+1, stores them, and reads them back
// for the evaluation (its own stores, hence the coherent loads below).
//
// Bound: at 256 bits a 7-factor, 8-point term is 6·8 Montgomery products per
// pair on 448 B read, far more work per byte than the fold, so the expected
// bound is the integer pipes; not profiled (the warp sums and shared-memory
// atomics below may cost as much as the products).  Registers are the scarce
// resource: a thread that kept every factor's stepping value and every
// point's sum in registers would need several hundred at 7 factors and 9
// points.  Here the loop runs over factors
// outside and points inside, so a thread holds one factor's (value, step);
// the partial product of each point waits in shared memory (laid out
// [point][word][thread], so a warp's accesses hit 32 banks), and each
// finished product is summed over the warp at once (__reduce_add_sync on its
// 16-bit halves, exact) and added by one lane into the block's 64-bit sums
// in shared memory.  No register array grows with the factor or point
// count.  Each block writes one partial row; the caller sums the rows.

#include "field.cuh"
#include "generic.cuh"

// The combination's factor lists: term j is fac[start[j] .. start[j+1]).
struct Comb {
    int n_terms;
    int start[ZT_GEN_MAX_TERMS + 1];
    int fac[ZT_GEN_MAX_ENTRIES];
};

// A load that may follow this thread's own store to the same address: no
// __restrict__, so it stays on the coherent path.
template <int N>
__device__ __forceinline__ void load_elem_rw(uint32_t (&x)[N], const uint32_t* p) {
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

// red[idx] += Σ_lanes x.  Every lane of the warp calls it with its own x.
__device__ __forceinline__ void warp_add(unsigned long long* red, int idx, uint32_t x, int lane) {
    const unsigned lo = __reduce_add_sync(0xFFFFFFFFu, x & 0xFFFFu);
    const unsigned hi = __reduce_add_sync(0xFFFFFFFFu, x >> 16);
    if (lane == (idx & 31))
        atomicAdd(&red[idx], (unsigned long long)lo + ((unsigned long long)hi << 16));
}

// Adds the products of every term at pair p into red[(j·n_pts + t)·N + w].
// Every thread of the block calls it the same number of times; an inactive
// thread (p beyond the last pair) contributes zeros.
template <int N>
__device__ __forceinline__ void eval_pair(unsigned long long* red, uint32_t* sprod,
                                          const uint32_t* tables, int64_t b, int64_t p,
                                          bool active, const Comb& comb, int n_pts,
                                          const FieldParams& f, int lane) {
    const int tid = threadIdx.x;
    for (int j = 0; j < comb.n_terms; ++j) {
        const int k0 = comb.start[j], k1 = comb.start[j + 1];
        for (int k = k0; k < k1; ++k) {
            uint32_t m[N], d[N];
            if (active) {
                const uint32_t* base = tables + ((int64_t)comb.fac[k] * b + 2 * p) * N;
                uint32_t v1[N];
                load_elem_rw<N>(m, base);
                load_elem_rw<N>(v1, base + N);
                sub_mod<N>(d, v1, m, f);
            } else {
#pragma unroll
                for (int w = 0; w < N; ++w) m[w] = d[w] = 0;
            }
            for (int t = 0; t < n_pts; ++t) {
                uint32_t* slot = sprod + (int64_t)t * N * ZT_GEN_BLOCK + tid;
                uint32_t prod[N];
                if (k == k0) {
#pragma unroll
                    for (int w = 0; w < N; ++w) prod[w] = m[w];
                } else {
#pragma unroll
                    for (int w = 0; w < N; ++w) prod[w] = slot[w * ZT_GEN_BLOCK];
                    mont_mul<N>(prod, prod, m, f);
                }
                if (k == k1 - 1) {
#pragma unroll
                    for (int w = 0; w < N; ++w) warp_add(red, (j * n_pts + t) * N + w, prod[w], lane);
                } else {
#pragma unroll
                    for (int w = 0; w < N; ++w) slot[w * ZT_GEN_BLOCK] = prod[w];
                }
                if (t + 1 < n_pts) add_mod<N>(m, m, d, f);
            }
        }
    }
}

// Dynamic shared memory: the block's sums (n_out u64), then the partial
// products (n_pts·N·BLOCK u32).
__host__ __device__ inline int64_t gen_smem_bytes(int n_terms, int n_pts, int n32) {
    return (int64_t)n_terms * n_pts * n32 * ZT_GEN_SUM_BYTES +
           (int64_t)n_pts * n32 * ZT_GEN_BLOCK * ZT_GEN_PROD_BYTES;
}

template <int N>
__device__ __forceinline__ void gen_begin(unsigned long long*& red, uint32_t*& sprod, int n_out) {
    extern __shared__ unsigned long long smem[];
    red = smem;
    sprod = reinterpret_cast<uint32_t*>(smem + n_out);
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) red[i] = 0;
    __syncthreads();
}

__device__ __forceinline__ void gen_end(int64_t* partial, const unsigned long long* red, int n_out) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_out; i += blockDim.x)
        partial[(int64_t)blockIdx.x * n_out + i] = (int64_t)red[i];
}

template <int N>
__global__ void __launch_bounds__(ZT_GEN_BLOCK) round_eval_generic_kernel(
    int64_t* __restrict__ partial, const uint32_t* tables, int64_t b, int64_t pairs,
    const __grid_constant__ Comb comb, int n_pts, FieldParams f) {
    const int n_out = comb.n_terms * n_pts * N;
    unsigned long long* red;
    uint32_t* sprod;
    gen_begin<N>(red, sprod, n_out);
    const int lane = threadIdx.x & 31;
    const int64_t stride = (int64_t)gridDim.x * ZT_GEN_BLOCK;
    for (int64_t p0 = (int64_t)blockIdx.x * ZT_GEN_BLOCK; p0 < pairs; p0 += stride) {
        const int64_t p = p0 + threadIdx.x;
        eval_pair<N>(red, sprod, tables, b, p, p < pairs, comb, n_pts, f, lane);
    }
    gen_end(partial, red, n_out);
}

// in: (n_tab, b_in) raw tables; out: (n_tab, b_in/2) folded; pairs = b_in/4
// eval pairs of the folded tables.
template <int N>
__global__ void __launch_bounds__(ZT_GEN_BLOCK) fold_round_eval_kernel(
    int64_t* __restrict__ partial, uint32_t* out, const uint32_t* __restrict__ in, int n_tab,
    int64_t b_in, int64_t pairs, Elem r, const __grid_constant__ Comb comb, int n_pts,
    FieldParams f) {
    const int n_out = comb.n_terms * n_pts * N;
    unsigned long long* red;
    uint32_t* sprod;
    gen_begin<N>(red, sprod, n_out);
    uint32_t rr[N];
#pragma unroll
    for (int i = 0; i < N; ++i) rr[i] = r.w[i];
    const int lane = threadIdx.x & 31;
    const int64_t half = b_in / 2;
    const int64_t stride = (int64_t)gridDim.x * ZT_GEN_BLOCK;
    for (int64_t p0 = (int64_t)blockIdx.x * ZT_GEN_BLOCK; p0 < pairs; p0 += stride) {
        const int64_t p = p0 + threadIdx.x;
        const bool active = p < pairs;
        if (active) {
            for (int m = 0; m < n_tab; ++m) {
                const uint32_t* src = in + ((int64_t)m * b_in + 4 * p) * N;
                uint32_t* dst = out + ((int64_t)m * half + 2 * p) * N;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    uint32_t v0[N], v1[N];
                    load_elem<N>(v0, src + 2 * h * N);
                    load_elem<N>(v1, src + (2 * h + 1) * N);
                    sub_mod<N>(v1, v1, v0, f);
                    mont_mul<N>(v1, v1, rr, f);
                    add_mod<N>(v0, v0, v1, f);
                    store_elem<N>(dst + h * N, v0);
                }
            }
        }
        eval_pair<N>(red, sprod, out, half, p, active, comb, n_pts, f, lane);
    }
    gen_end(partial, red, n_out);
}

// Number of blocks (= partial rows) the generic kernels use for `pairs` pairs.
extern "C" int zt_gen_blocks(int64_t pairs) {
    return grid_for(pairs, ZT_GEN_BLOCK, 132 * 16);
}

static int make_comb(Comb& c, const int* start, const int* fac, int n_terms) {
    if (n_terms < 1 || n_terms > ZT_GEN_MAX_TERMS || start[0] != 0 ||
        start[n_terms] > ZT_GEN_MAX_ENTRIES)
        return (int)cudaErrorInvalidValue;
    c.n_terms = n_terms;
    for (int j = 0; j <= n_terms; ++j) {
        if (j > 0 && start[j] <= start[j - 1]) return (int)cudaErrorInvalidValue;
        c.start[j] = start[j];
    }
    for (int k = 0; k < start[n_terms]; ++k) c.fac[k] = fac[k];
    return 0;
}

extern "C" int zt_round_eval_generic(void* partial, const void* tables, int64_t b, int64_t pairs,
                                     const int* start, const int* fac, int n_terms, int n_pts,
                                     int n32, const uint32_t* q, uint32_t qinv, void* stream) {
    Comb comb{};
    int rc = make_comb(comb, start, fac, n_terms);
    if (rc || n_pts < 1) return rc ? rc : (int)cudaErrorInvalidValue;
    const FieldParams f = make_params(q, n32, qinv);
    const int64_t smem = gen_smem_bytes(n_terms, n_pts, n32);
    const int grid = zt_gen_blocks(pairs);
    cudaStream_t s = (cudaStream_t)stream;
    ZT_DISPATCH_WORDS(n32, {
        if ((rc = prepare_smem(round_eval_generic_kernel<N>, smem))) return rc;
        round_eval_generic_kernel<N><<<grid, ZT_GEN_BLOCK, smem, s>>>(
            (int64_t*)partial, (const uint32_t*)tables, b, pairs, comb, n_pts, f);
    });
    return (int)cudaGetLastError();
}

extern "C" int zt_fold_round_eval(void* partial, void* out, const void* in, int n_tab,
                                  int64_t b_in, const uint32_t* r, const int* start,
                                  const int* fac, int n_terms, int n_pts, int n32,
                                  const uint32_t* q, uint32_t qinv, void* stream) {
    Comb comb{};
    int rc = make_comb(comb, start, fac, n_terms);
    if (rc || n_pts < 1 || b_in % 4) return rc ? rc : (int)cudaErrorInvalidValue;
    const FieldParams f = make_params(q, n32, qinv);
    const Elem re = make_elem(r, n32);
    const int64_t pairs = b_in / 4;
    const int64_t smem = gen_smem_bytes(n_terms, n_pts, n32);
    const int grid = zt_gen_blocks(pairs);
    cudaStream_t s = (cudaStream_t)stream;
    ZT_DISPATCH_WORDS(n32, {
        if ((rc = prepare_smem(fold_round_eval_kernel<N>, smem))) return rc;
        fold_round_eval_kernel<N><<<grid, ZT_GEN_BLOCK, smem, s>>>(
            (int64_t*)partial, (uint32_t*)out, (const uint32_t*)in, n_tab, b_in, pairs, re,
            comb, n_pts, f);
    });
    return (int)cudaGetLastError();
}
