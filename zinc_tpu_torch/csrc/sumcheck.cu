// K2-K4: the sumcheck round kernels, over tables stored batch-major in
// natural order: table m, entry x at word offset (m·B + x)·N.  A round pairs
// entries (2p, 2p+1), the host prover's order (zinc_tpu/sumcheck/prover.py
// :58-84).  The reference's bit-reversed limb-major layout and its bf16
// Toeplitz REDC (zinc_tpu/sumcheck/mxu_exec.py:132-255, 604-625) exist for
// the TPU's matrix unit and are not carried over.
//
// K2 fold replaces mxu_exec.py:_fold_lm.  out[m][p] = v0 + r·(v1 − v0) with
// (v0, v1) = (in[m][2p], in[m][2p+1]); it writes a fresh half-size output.
// Bound: at 256 bits a pair reads 64 B and writes 32 B per table for one
// Montgomery product, so it is memory-bound on the H100; the design streams
// the pairs with vector loads on neighbouring addresses and keeps r in the
// kernel's parameter space, or, in the device-resident Fiat-Shamir loop,
// loads r's N words from device memory once a thread (an L2 hit).
//
// K3 round_eval replaces mxu_exec.py:_eval_lm, K4 round_eval_gruen replaces
// mxu_exec.py:_eval_lm_gruen: one template, one launch per round for the
// whole combination.  For every term j, point t = 0..n_pts−1 and pair p it
// forms Π_{k∈term} M_k(t, p) (K4: times the suffix-eq weight E[p]) with
// M_k(t, p) = v0_k + t·(v1_k − v0_k), and returns the sums over p reduced
// mod q, as canonical residues (n_terms, n_pts, N); the host applies each
// term's coefficient and, for K4, the Gruen factor pref·c_j(t).
//
// Bound: at the R1CS shapes a pair reads 64 B per factor for one to three
// products, so these kernels are bound by the integer multiply-add pipe, or
// near the memory's rate once the products get cheap.  What the design does
// about it:
// * Fewer multiply-adds.  A term's sum is only ever needed mod q, so its
//   last factor's product is summed unreduced, as 2N-word integers (mul_wide:
//   N² multiply-adds, half a Montgomery product's), and reduced once per
//   block (redc_wide).  K4 multiplies E into the term's first factor once per
//   pair (E·M_0(t) is linear in t too), or, for a term of one factor, makes
//   E that factor's partner in the unreduced product.
// * Fewer modular additions.  A term of k factors is a polynomial of degree
//   k in t, so k + 1 sums fix it: its values at t = 0 and 1 are products of
//   the entries as loaded, its leading coefficient the product of the steps
//   v1 − v0, and only t = 2..k−1 need stepping.  The last block extends
//   each term to n_pts points by finite differences (round_sums.cuh:
//   extend_points, exact mod q).
// * Registers: a thread holds one term's factors (two entries) at a time and
//   no accumulator: its running sums live in shared memory, 2N + 1 words a
//   slot, [slot][word][thread] (conflict-free), so two 256-thread blocks fit
//   on an SM at ≤ 8 words.
// * Each table's pair and E are loaded once per pair at the R1CS shapes; a
//   table that a later term repeats is read again from L1.
// * The grid reduces itself: each block adds its threads' sums exactly (a
//   tree of carry chains), reduces each slot once and writes one row of
//   residues; the last block to finish (a counter in the launch's own
//   buffer, zeroed on its stream) sums the rows (add_mod) and writes the
//   output.  No atomics on the sums, no second launch.

#include "field.cuh"
#include "round_eval.cuh"
#include "round_sums.cuh"

template <int N>
__global__ void __launch_bounds__(256) fold_kernel(uint32_t* __restrict__ out,
                                                   const uint32_t* __restrict__ in,
                                                   int64_t n_out, Elem r,
                                                   const uint32_t* __restrict__ r_dev,
                                                   FieldParams f) {
    uint32_t rr[N];
#pragma unroll
    for (int i = 0; i < N; ++i) rr[i] = r_dev ? r_dev[i] : r.w[i];
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_out; i += stride) {
        // (m, p) with i = m·half + p reads entries 2p and 2p+1 of table m,
        // which sit at flat element 2i and 2i+1
        uint32_t v0[N], v1[N], d[N];
        load_elem<N>(v0, in + 2 * i * N);
        load_elem<N>(v1, in + (2 * i + 1) * N);
        sub_mod<N>(d, v1, v0, f);
        mont_mul<N>(d, d, rr, f);
        add_mod<N>(v0, v0, d, f);
        store_elem<N>(out + i * N, v0);
    }
}

// The combination: term j has n_fac[j] = D factors, fac[j][0 .. D), so its
// sum is a polynomial of degree D in t; it takes the D + 1 wide slots
// slot[j] .. slot[j] + D: its values at t = 0..D−1 and, last, its leading
// coefficient, Σ_p Π_k (v1_k − v0_k) (for D = 1: its values at t = 0, 1).
struct EvalComb {
    int n_terms;
    int n_slots;
    int n_fac[ZT_EVAL_MAX_TERMS];
    int slot[ZT_EVAL_MAX_TERMS];
    int fac[ZT_EVAL_MAX_TERMS][ZT_EVAL_MAX_FACTORS];
};

// acc[slot][word][thread] += x, a 2N-word product, in this thread's column.
template <int N>
__device__ __forceinline__ void acc_add_wide(uint32_t* acc, int slot, const uint32_t (&x)[2 * N]) {
    const int T = blockDim.x;
    uint32_t* p = acc + slot * wide_words<N>() * T + threadIdx.x;
    p[0] = add_cc(p[0], x[0]);
#pragma unroll
    for (int w = 1; w < 2 * N; ++w) p[w * T] = addc_cc(p[w * T], x[w]);
    p[2 * N * T] = addc(p[2 * N * T], 0u);
}

// acc[slot][0..N)[thread] += x (mod q), a residue, in this thread's column.
template <int N>
__device__ __forceinline__ void acc_add_mod(uint32_t* acc, int slot, const uint32_t (&x)[N],
                                            const FieldParams& f) {
    const int T = blockDim.x;
    uint32_t* p = acc + slot * wide_words<N>() * T + threadIdx.x;
    uint32_t a[N];
#pragma unroll
    for (int w = 0; w < N; ++w) a[w] = p[w * T];
    add_mod<N>(a, a, x, f);
#pragma unroll
    for (int w = 0; w < N; ++w) p[w * T] = a[w];
}

// Sums every slot's 2N+1 words over the block's threads into thread 0's
// column, exactly (a tree of carry chains; blockDim.x is a power of two):
// T threads of k products each stay below T·k·R², inside 2N+1 words.
template <int N>
__device__ __noinline__ void block_sum_wide(uint32_t* acc, int n_slots) {
    const int T = blockDim.x, tid = threadIdx.x;
    for (int h = T / 2; h > 0; h >>= 1) {
        __syncthreads();
        if (tid < h) {
            for (int s = 0; s < n_slots; ++s) {
                uint32_t* p = acc + s * wide_words<N>() * T + tid;
                p[0] = add_cc(p[0], p[h]);
#pragma unroll
                for (int w = 1; w < 2 * N; ++w) p[w * T] = addc_cc(p[w * T], p[w * T + h]);
                p[2 * N * T] = addc(p[2 * N * T], p[2 * N * T + h]);
            }
        }
    }
    __syncthreads();
}

// Sums every slot's residue (its first N words) over the block's threads
// into thread 0's column (a tree of add_mod; blockDim.x is a power of two).
template <int N>
__device__ __noinline__ void block_sum(uint32_t* acc, int n_slots, const FieldParams& f) {
    const int T = blockDim.x, tid = threadIdx.x;
    for (int h = T / 2; h > 0; h >>= 1) {
        __syncthreads();
        if (tid < h) {
            for (int s = 0; s < n_slots; ++s) {
                uint32_t* p = acc + s * wide_words<N>() * T + tid;
                uint32_t x[N], y[N];
#pragma unroll
                for (int w = 0; w < N; ++w) {
                    x[w] = p[w * T];
                    y[w] = p[w * T + h];
                }
                add_mod<N>(x, x, y, f);
#pragma unroll
                for (int w = 0; w < N; ++w) p[w * T] = x[w];
            }
        }
    }
    __syncthreads();
}

// wide = Π_k x[k] over the term's nf factors: Montgomery products but for
// the last factor, whose product is left unreduced; with e_last (K4, one
// factor) wide = x[0]·E.
template <int N, int MAXF>
__device__ __forceinline__ void term_product(uint32_t (&wide)[2 * N], const uint32_t (&x)[MAXF][N],
                                             int nf, bool e_last, const uint32_t (&ew)[N],
                                             const FieldParams& f) {
    if (e_last) {
        mul_wide<N>(wide, x[0], ew);
        return;
    }
    uint32_t prod[N];
#pragma unroll
    for (int w = 0; w < N; ++w) prod[w] = x[0][w];
#pragma unroll
    for (int k = 1; k < MAXF; ++k) {
        if (k < nf - 1) mont_mul<N>(prod, prod, x[k], f);
        else if (k == nf - 1) mul_wide<N>(wide, prod, x[k]);
    }
}

// out: (n_terms, n_pts, N) residues; partial: (gridDim.x, n_slots, N)
// residues; done: this launch's counter, 0 before it.  At ≤ 8 words two
// blocks fit on an SM (≤ 128 registers).
template <int N, bool GRUEN>
__global__ void __launch_bounds__(ZT_EVAL_BLOCK, N <= 8 ? 2 : 1) round_eval_kernel(
    uint32_t* __restrict__ out, uint32_t* __restrict__ partial, unsigned int* __restrict__ done,
    const uint32_t* __restrict__ tables, int64_t b, int64_t pairs,
    const uint32_t* __restrict__ e, const __grid_constant__ EvalComb comb, int n_pts,
    FieldParams f) {
    constexpr int SW = wide_words<N>();
    constexpr int MAXF = GRUEN ? ZT_EVAL_MAX_FACTORS - 1 : ZT_EVAL_MAX_FACTORS;
    extern __shared__ uint32_t acc[];
    const int T = blockDim.x, tid = threadIdx.x;
    const int n_slots = comb.n_slots;
    for (int i = 0; i < n_slots * SW; ++i) acc[i * T + tid] = 0;

    const int64_t stride = (int64_t)gridDim.x * T;
    for (int64_t p = (int64_t)blockIdx.x * T + tid; p < pairs; p += stride) {
        uint32_t ew[N];
        if constexpr (GRUEN) load_elem<N>(ew, e + p * N);
        (void)ew;
        for (int j = 0; j < comb.n_terms; ++j) {
            const int nf = comb.n_fac[j], s0 = comb.slot[j];
            uint32_t v0[MAXF][N], v1[MAXF][N];
#pragma unroll
            for (int k = 0; k < MAXF; ++k) {
                if (k < nf) {
                    const uint32_t* base = tables + ((int64_t)comb.fac[j][k] * b + 2 * p) * N;
                    load_elem<N>(v0[k], base);
                    load_elem<N>(v1[k], base + N);
                }
            }
            // K4 with two or more factors: E·M_0(t) is linear in t too, so E
            // enters the first factor's two entries; with one factor, E is
            // that factor's partner in the unreduced product
            bool e_last = false;
            if constexpr (GRUEN) {
                if (nf > 1) {
                    mont_mul<N>(v0[0], v0[0], ew, f);
                    mont_mul<N>(v1[0], v1[0], ew, f);
                } else {
                    e_last = true;
                }
            }
            uint32_t wide[2 * N];
            // t = 0 and t = 1: the entries themselves
            term_product<N, MAXF>(wide, v0, nf, e_last, ew, f);
            acc_add_wide<N>(acc, s0, wide);
            term_product<N, MAXF>(wide, v1, nf, e_last, ew, f);
            acc_add_wide<N>(acc, s0 + 1, wide);
            if (nf >= 2) {
                // v0 becomes the steps v1 − v0; t = 2..nf−1 by stepping v1
#pragma unroll
                for (int k = 0; k < MAXF; ++k)
                    if (k < nf) sub_mod<N>(v0[k], v1[k], v0[k], f);
                for (int t = 2; t < nf; ++t) {
#pragma unroll
                    for (int k = 0; k < MAXF; ++k)
                        if (k < nf) add_mod<N>(v1[k], v1[k], v0[k], f);
                    term_product<N, MAXF>(wide, v1, nf, false, ew, f);
                    acc_add_wide<N>(acc, s0 + t, wide);
                }
                // the leading coefficient: the product of the steps
                term_product<N, MAXF>(wide, v0, nf, false, ew, f);
                acc_add_wide<N>(acc, s0 + nf, wide);
            }
        }
    }

    // the block's exact sums, reduced once per slot (a block summed at most
    // T·kp products a slot): one row of partial
    block_sum_wide<N>(acc, n_slots);
    const int64_t kp = (int64_t)T * ((pairs + stride - 1) / stride);
    const int kbits = kp > 0 ? 64 - __clzll(kp) : 1;
    const int n_words = n_slots * N;
    for (int s = tid; s < n_slots; s += T) {
        uint32_t w[SW], r[N];
#pragma unroll
        for (int i = 0; i < SW; ++i) w[i] = acc[(s * SW + i) * T];
        redc_wide<N>(r, w, kbits, f);
#pragma unroll
        for (int i = 0; i < N; ++i) partial[(int64_t)blockIdx.x * n_words + s * N + i] = r[i];
    }
    __threadfence();
    int last = 0;
    __syncthreads();
    if (tid == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
    if (!__syncthreads_or(last)) return;

    // the last block: the grid's sums, then each term's remaining points
    __threadfence();
    for (int s = 0; s < n_slots; ++s)
        for (int w = 0; w < N; ++w) acc[(s * SW + w) * T + tid] = 0;
    for (int64_t blk = tid; blk < gridDim.x; blk += T) {
        const uint32_t* row = partial + blk * n_words;
        for (int s = 0; s < n_slots; ++s) {
            uint32_t x[N];
#pragma unroll
            for (int w = 0; w < N; ++w) x[w] = __ldcg(row + s * N + w);
            acc_add_mod<N>(acc, s, x, f);
        }
    }
    block_sum<N>(acc, n_slots, f);
    for (int j = tid; j < comb.n_terms; j += T) {
        // values at t = 0..h−1 into the output, then the rest of the points
        const int D = comb.n_fac[j], h = D >= 2 ? D : 2;
        uint32_t* y = out + (int64_t)j * n_pts * N;
        uint32_t lead[N];
        for (int t = 0; t <= D; ++t)
#pragma unroll
            for (int w = 0; w < N; ++w) {
                const uint32_t x = acc[((comb.slot[j] + t) * SW + w) * T];
                if (t < h) y[t * N + w] = x;
                else lead[w] = x;
            }
        extend_points<N>(y, h, D >= 2 ? lead : nullptr, n_pts, f);
    }
}

// r: the challenge as host words (it rides in the parameter space), or
// null and r_dev its words in device memory, which every thread loads at its
// start (the device-resident Fiat-Shamir loop's r, written by fs_round).
extern "C" int zt_fold(void* out, const void* in, int64_t n_out, int n32, const uint32_t* r,
                       const void* r_dev, const uint32_t* q, uint32_t qinv, void* stream) {
    if ((r == nullptr) == (r_dev == nullptr)) return (int)cudaErrorInvalidValue;
    if (n_out <= 0) return 0;
    const FieldParams f = make_params(q, n32, qinv);
    const Elem re = r ? make_elem(r, n32) : Elem{};
    const int block = 256;
    const int grid = grid_for(n_out, block, 132 * 64);
    cudaStream_t s = (cudaStream_t)stream;
    ZT_DISPATCH_WORDS(n32, fold_kernel<N><<<grid, block, 0, s>>>(
        (uint32_t*)out, (const uint32_t*)in, n_out, re, (const uint32_t*)r_dev, f));
    return (int)cudaGetLastError();
}

// Shared memory of a block of T threads with n_slots wide slots.
static int64_t eval_smem(int n_slots, int n32, int T) {
    return (int64_t)n_slots * (2 * n32 + 1) * ZT_EVAL_ACC_BYTES * T;
}

template <bool G>
static int eval_occupancy(int block, int64_t smem, int* per_sm) {
    int rc = prepare_smem(round_eval_kernel<ZT_WORDS, G>, smem);
    if (rc) return rc;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, round_eval_kernel<ZT_WORDS, G>, block, (size_t)smem);
}

static bool eval_block_ok(int block, int n_slots, int n32) {
    return block >= ZT_EVAL_MIN_BLOCK && block <= ZT_EVAL_BLOCK && !(block & (block - 1)) &&
           n_slots >= 1 && eval_smem(n_slots, n32, block) <= ZT_SMEM_LIMIT;
}

// The most blocks of `block` threads that fit at once on the card, for a
// launch of `n_slots` wide slots (Σ_j n_fac[j] + 1).  The block itself is
// chosen by the caller (sumcheck/kernels.py:eval_block).
extern "C" int zt_eval_max_grid(int gruen, int n_slots, int n32, int block, int* max_grid) {
    *max_grid = 0;
    if (n32 != ZT_WORDS || !eval_block_ok(block, n_slots, n32)) return (int)cudaErrorInvalidValue;
    const int64_t smem = eval_smem(n_slots, n32, block);
    int dev = 0, sms = 0, per_sm = 0, rc = 0;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return rc;
    rc = gruen ? eval_occupancy<true>(block, smem, &per_sm)
               : eval_occupancy<false>(block, smem, &per_sm);
    if (rc) return rc;
    *max_grid = (per_sm > 0 ? per_sm : 1) * sms;
    return 0;
}

// K3 (e == nullptr) or K4 over `pairs` pairs in `grid` blocks of `block`
// threads; fac holds ZT_EVAL_MAX_FACTORS slots per term.  `done` is this
// launch's own counter of finished blocks, zeroed here on the launch's
// stream, so launches on other streams never share it.
extern "C" int zt_round_eval(void* out, void* partial, void* done, const void* tables, int64_t b,
                             int64_t pairs, const void* e, const int* n_fac, const int* fac,
                             int n_terms, int n_pts, int block, int grid, int n32,
                             const uint32_t* q, uint32_t qinv, void* stream) {
    const bool gruen = e != nullptr;
    const int most = gruen ? ZT_EVAL_MAX_FACTORS - 1 : ZT_EVAL_MAX_FACTORS;
    if (n_terms < 1 || n_terms > ZT_EVAL_MAX_TERMS || n_pts < 1 || n_pts > ZT_EVAL_MAX_POINTS ||
        grid < 1)
        return (int)cudaErrorInvalidValue;
    EvalComb comb{};
    comb.n_terms = n_terms;
    for (int j = 0; j < n_terms; ++j) {
        if (n_fac[j] < (gruen ? 1 : 2) || n_fac[j] > most || n_fac[j] + 1 > n_pts)
            return (int)cudaErrorInvalidValue;
        comb.n_fac[j] = n_fac[j];
        comb.slot[j] = comb.n_slots;
        comb.n_slots += n_fac[j] + 1;
        for (int k = 0; k < n_fac[j]; ++k) comb.fac[j][k] = fac[j * ZT_EVAL_MAX_FACTORS + k];
    }
    if (!eval_block_ok(block, comb.n_slots, n32)) return (int)cudaErrorInvalidValue;
    const int64_t smem = eval_smem(comb.n_slots, n32, block);
    const FieldParams f = make_params(q, n32, qinv);
    cudaStream_t s = (cudaStream_t)stream;
    int rc = 0;
    if ((rc = (int)cudaMemsetAsync(done, 0, sizeof(unsigned int), s))) return rc;
    ZT_DISPATCH_WORDS(n32, {
        if (gruen) {
            if ((rc = prepare_smem(round_eval_kernel<N, true>, smem))) return rc;
            round_eval_kernel<N, true><<<grid, block, smem, s>>>(
                (uint32_t*)out, (uint32_t*)partial, (unsigned int*)done, (const uint32_t*)tables,
                b, pairs, (const uint32_t*)e, comb, n_pts, f);
        } else {
            if ((rc = prepare_smem(round_eval_kernel<N, false>, smem))) return rc;
            round_eval_kernel<N, false><<<grid, block, smem, s>>>(
                (uint32_t*)out, (uint32_t*)partial, (unsigned int*)done, (const uint32_t*)tables,
                b, pairs, nullptr, comb, n_pts, f);
        }
    });
    return (int)cudaGetLastError();
}
