// The generic-combination sumcheck round kernels, over the tables layout of
// sumcheck.cu: table m, entry x at word offset (m·B + x)·N; a round pairs
// entries (2p, 2p+1).
//
// round_eval_generic replaces zinc_tpu/ops/pallas_field.py:round_eval_pallas
// (K7) and zinc_tpu/sumcheck/pallas_exec.py:_eval_fixed (K9);
// fold_round_eval replaces pallas_exec.py:_fold_eval_fixed (K10).  For every
// term of the combination (one or more factors) and t = 0..n_pts−1 they
// return Σ_p Π_{k∈term} M_k(t, p) mod q, M_k(t, p) = v0_k + t·(v1_k − v0_k),
// as canonical residues (n_terms, n_pts, N), from one launch per round; the
// host applies the coefficient kinds u/n/g (they are linear), as for K3.
// K10 first folds every table by r, v0 + r·(v1 − v0) over pairs (2x, 2x+1),
// into a fresh output, and evaluates the folded pairs.  The reference folds
// in place into the buffer's prefix, which is safe only because a Pallas grid
// runs in order; CUDA blocks do not, so a block would overwrite entries
// another block has yet to read.
//
// Bound: at 256 bits path A's round (terms of 5 and 2 factors, 6 points)
// needs 18 Montgomery and 9 unreduced products a pair on 192 B read, path
// B's (one term of 7, 8 points) 40 and 8 on 224 B, so both are bound by the
// integer pipes, 2.7× and 5.3× above the memory's time at 2^20
// (benches/bench_kernels.py).  What the design does about it:
// * The products the round needs and no more (bench_kernels.round_products).
//   A term of k ≥ 2 factors is a polynomial of degree k in t.  Where
//   n_pts > k it is evaluated at t = 0..k−1 (t = 0, 1 from the entries as
//   loaded, t ≥ 2 by stepping) and at its leading coefficient
//   Π_k (v1_k − v0_k), and the last block extends it to every point by finite
//   differences (extend_points); where n_pts ≤ k, at its n_pts points.  Each
//   evaluation is k − 2 Montgomery products and one unreduced product by the
//   last factor (mul_wide, 2N words), summed as it is and reduced once per
//   warp (redc_wide).  A term of one factor takes no product: its entries
//   are summed as x·R, which the same reduction undoes.
// * A warp per pass.  A term's evaluations are split into passes of
//   gen_pass<N>(); warp w of a block takes pass w of the combination for
//   tiles of 32 pairs, lane l the tile's pair l.  The lanes of a warp run the
//   same term and points, so they never diverge, and each keeps its pass's
//   running sums (2N + 1 words each) in registers across all of its tiles.
//   A pass's products do not depend on each other and are one straight run
//   of code, so the integer pipes can interleave their carry chains.  Running
//   sums in shared memory, a thread's for every slot of the combination (as
//   K3/K4 keep theirs), would take 612 B a thread for path A's 9 sums at 8
//   words: at most 372 threads an SM.
// * K10 folds once.  The block folds the tile's entries of every table once
//   (one Montgomery product per folded entry), its threads on consecutive
//   entries, writes them to the fresh output, which the next round reads,
//   and keeps them in shared memory (the stage), where every warp reads them
//   after the block's barrier; the first sweep never reads its output back.
//   Tables too many for a stage, and later sweeps, read the output.  K7
//   reads the tables in device memory: its warps share the lines through
//   the L1 and never wait for each other (a stage and its barriers measured
//   slower there).
// * Sums.  A warp adds its lanes' sums once at the end (shuffles and carry
//   chains), reduces each slot once and adds its words into the grid's 64-bit
//   column sums (one atomic a word, a slot and a warp); the last block to
//   finish (a counter beside them in the launch's own buffer, zeroed on its
//   stream) carries and reduces each slot and writes the output.  No
//   reduction per pair, no second launch, and no serial walk over every
//   block's row in the last block.
// * The block is a warp for each pass of the term with the most passes (up
//   to ZT_GEN_BLOCK threads), so that its warps carry passes of equal cost;
//   the other terms' passes follow in further sweeps over the pairs (path
//   A: its 5-factor term's 3 passes, then its 2-factor term's 2).  Block and
//   stage are chosen by sumcheck/kernels.py:generic_plan, and this file
//   reports the occupancy (zt_gen_max_grid).

#include "field.cuh"
#include "generic.cuh"
#include "round_sums.cuh"

// Points a pass evaluates together: each adds a product chain beside the
// others (generic.cuh; sumcheck/kernels.py counts the passes from the same
// defines).
template <int N>
__host__ __device__ constexpr int gen_pass() {
    return N <= 8 ? ZT_GEN_PASS : ZT_GEN_PASS_WIDE;
}

// Running sums of a term of k factors at n_pts points, and whether its last
// one is the leading coefficient (sumcheck/kernels.py:generic_term_slots).
__host__ __device__ inline int gen_term_slots(int k, int n_pts) {
    const int h = k >= 2 ? k + 1 : 2;
    return h < n_pts ? h : n_pts;
}
__host__ __device__ inline bool gen_has_lead(int k, int n_pts) { return k >= 2 && n_pts > k; }

// The combination: term j has k[j] factors fac[start[j] .. start[j] + k[j])
// and h[j] running sums, slots slot[j] .. slot[j] + h[j] − 1, evaluated in
// ceil(h[j] / gen_pass) passes; n_passes over all terms.
struct GenComb {
    int n_terms;
    int n_slots;
    int n_passes;
    int k[ZT_GEN_MAX_TERMS];
    int h[ZT_GEN_MAX_TERMS];
    int slot[ZT_GEN_MAX_TERMS];
    int start[ZT_GEN_MAX_TERMS];
    int fac[ZT_GEN_MAX_ENTRIES];
};

// A load that may follow a store to the same address by another thread of
// the block, before a barrier: no __restrict__, so it stays on the coherent
// path.
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

// Where a lane reads the entries of its pair: tables in device memory of b
// entries each, or (stage ≠ nullptr) the tile's stage in shared memory,
// word w of entry e (0, 1) of table m for lane l at ((m·2 + e)·N + w)·32 + l.
struct PairSrc {
    const uint32_t* g;
    int64_t b;
    const uint32_t* stage;
};

template <int N>
__device__ __forceinline__ uint32_t* stage_at(uint32_t* stage, int m, int e, int lane) {
    return stage + ((m * 2 + e) * N) * 32 + lane;
}

// K7 reads tables no launch writes meanwhile; K10's come from its own block.
template <int N, bool FOLD>
__device__ __forceinline__ void fetch_pair(uint32_t (&v0)[N], uint32_t (&v1)[N], const PairSrc& s,
                                           int m, int64_t p, int lane) {
    if (s.stage) {
        const uint32_t* c = s.stage + ((m * 2) * N) * 32 + lane;
#pragma unroll
        for (int w = 0; w < N; ++w) {
            v0[w] = c[w * 32];
            v1[w] = c[(N + w) * 32];
        }
        return;
    }
    const uint32_t* base = s.g + ((int64_t)m * s.b + 2 * p) * N;
    if constexpr (FOLD) {
        load_elem_rw<N>(v0, base);
        load_elem_rw<N>(v1, base + N);
    } else {
        load_elem<N>(v0, base);
        load_elem<N>(v1, base + N);
    }
}

// acc += x, a 2N-word product, in registers.
template <int N>
__device__ __forceinline__ void reg_add_wide(uint32_t (&acc)[2 * N + 1], const uint32_t (&x)[2 * N]) {
    acc[0] = add_cc(acc[0], x[0]);
#pragma unroll
    for (int w = 1; w < 2 * N; ++w) acc[w] = addc_cc(acc[w], x[w]);
    acc[2 * N] = addc(acc[2 * N], 0u);
}

// acc += x·R (x in the upper N words), a residue: redc_wide gives back x.
template <int N>
__device__ __forceinline__ void reg_add_high(uint32_t (&acc)[2 * N + 1], const uint32_t (&x)[N]) {
    acc[N] = add_cc(acc[N], x[0]);
#pragma unroll
    for (int w = 1; w < N; ++w) acc[N + w] = addc_cc(acc[N + w], x[w]);
    acc[2 * N] = addc(acc[2 * N], 0u);
}

// A factor's value at evaluation e0 + c of a pass of C: d (its step) at the
// leading coefficient, else cur, its value at t = e0 + c.  Then, unless this
// is the pass's last evaluation, cur moves on to the next t (from t = 0: v1).
template <int N, int C>
__device__ __forceinline__ void factor_at(uint32_t (&x)[N], uint32_t (&cur)[N],
                                          const uint32_t (&v1)[N], const uint32_t (&d)[N], int c,
                                          int e0, int lead, const FieldParams& f) {
#pragma unroll
    for (int w = 0; w < N; ++w) x[w] = e0 + c == lead ? d[w] : cur[w];
    if (c + 1 < C) {
        uint32_t nx[N];
        add_mod<N>(nx, cur, d, f);
#pragma unroll
        for (int w = 0; w < N; ++w) cur[w] = c == 0 && e0 == 0 ? v1[w] : nx[w];
    }
}

// One pass at pair p: evaluations e0 .. e0 + C − 1 of a term of k factors,
// evaluation `lead` (or −1) being its leading coefficient, added into
// acc[0 .. C).  Evaluation e < lead is the term at t = e.  Per factor: one
// load of the pair (the next factor's is issued before this one's
// products), the C factor values by stepping, and C independent products in
// one straight run of code.
template <int N, int C, int P, bool FOLD>
__device__ __forceinline__ void eval_pass(uint32_t (&acc)[P][2 * N + 1], const int* fac, int k,
                                          int e0, int lead, const PairSrc& src, int64_t p,
                                          int lane, const FieldParams& f) {
    uint32_t prod[C][N], n0[N], n1[N];
    fetch_pair<N, FOLD>(n0, n1, src, fac[0], p, lane);
    for (int i = 0; i < k; ++i) {
        uint32_t v0[N], v1[N], d[N], cur[N], x[N];
#pragma unroll
        for (int w = 0; w < N; ++w) {
            v0[w] = n0[w];
            v1[w] = n1[w];
        }
        if (i + 1 < k) fetch_pair<N, FOLD>(n0, n1, src, fac[i + 1], p, lane);
        sub_mod<N>(d, v1, v0, f);
        // cur: the factor at t = e0
#pragma unroll
        for (int w = 0; w < N; ++w) cur[w] = e0 == 0 ? v0[w] : v1[w];
        for (int t = 1; t < e0; ++t) add_mod<N>(cur, cur, d, f);
        if (i == 0) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                factor_at<N, C>(x, cur, v1, d, c, e0, lead, f);
#pragma unroll
                for (int w = 0; w < N; ++w) prod[c][w] = x[w];
            }
        } else if (i + 1 < k) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                factor_at<N, C>(x, cur, v1, d, c, e0, lead, f);
                mont_mul<N>(prod[c], prod[c], x, f);
            }
        } else {
#pragma unroll
            for (int c = 0; c < C; ++c) {
                factor_at<N, C>(x, cur, v1, d, c, e0, lead, f);
                uint32_t wide[2 * N];
                mul_wide<N>(wide, prod[c], x);
                reg_add_wide<N>(acc[c], wide);
            }
        }
    }
    if (k == 1) {
#pragma unroll
        for (int c = 0; c < C; ++c) reg_add_high<N>(acc[c], prod[c]);
    }
}

// eval_pass with C = ne ≤ CMAX, chosen at run time.
template <int N, int CMAX, int P, bool FOLD>
__device__ __forceinline__ void eval_pass_n(int ne, uint32_t (&acc)[P][2 * N + 1], const int* fac,
                                            int k, int e0, int lead, const PairSrc& src, int64_t p,
                                            int lane, const FieldParams& f) {
    if constexpr (CMAX > 1) {
        if (ne < CMAX) {
            eval_pass_n<N, CMAX - 1, P, FOLD>(ne, acc, fac, k, e0, lead, src, p, lane, f);
            return;
        }
    }
    eval_pass<N, CMAX, P, FOLD>(acc, fac, k, e0, lead, src, p, lane, f);
}

// K10: folds raw entries 4p0 .. 4p0 + 127 of every table into its folded
// entries 2p0 .. 2p0 + 63 of `out` (one Montgomery product each), and into
// the stage if there is one; the block's threads on consecutive entries.
template <int N>
__device__ __forceinline__ void fold_tile(uint32_t* out, uint32_t* stage,
                                          const uint32_t* __restrict__ in, int n_tab, int64_t b_in,
                                          int64_t p0, int64_t pairs, const uint32_t (&rr)[N],
                                          const FieldParams& f) {
    const int64_t half = b_in / 2;
    for (int i = threadIdx.x; i < n_tab * 64; i += blockDim.x) {
        const int m = i / 64, e = i % 64;
        if (p0 + e / 2 >= pairs) continue;
        const int64_t x = 2 * p0 + e;
        uint32_t v0[N], v1[N];
        load_elem<N>(v0, in + ((int64_t)m * b_in + 2 * x) * N);
        load_elem<N>(v1, in + ((int64_t)m * b_in + 2 * x + 1) * N);
        sub_mod<N>(v1, v1, v0, f);
        mont_mul<N>(v1, v1, rr, f);
        add_mod<N>(v0, v0, v1, f);
        store_elem<N>(out + ((int64_t)m * half + x) * N, v0);
        if (stage) {
            uint32_t* c = stage_at<N>(stage, m, e & 1, e / 2);
#pragma unroll
            for (int w = 0; w < N; ++w) c[w * 32] = v0[w];
        }
    }
}

// The exact sum over the warp of each lane's acc (a tree of shuffles and
// carry chains), in lane 0.  Every lane of the warp calls it.
template <int N, int P>
__device__ __forceinline__ void warp_sum_wide(uint32_t (&acc)[P][2 * N + 1]) {
#pragma unroll
    for (int c = 0; c < P; ++c) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            uint32_t y[2 * N + 1];
#pragma unroll
            for (int w = 0; w <= 2 * N; ++w) y[w] = __shfl_down_sync(0xFFFFFFFFu, acc[c][w], off);
            acc[c][0] = add_cc(acc[c][0], y[0]);
#pragma unroll
            for (int w = 1; w < 2 * N; ++w) acc[c][w] = addc_cc(acc[c][w], y[w]);
            acc[c][2 * N] = addc(acc[c][2 * N], y[2 * N]);
        }
    }
}

// K7/K9 (FOLD = false): the round sums of `tables` (b entries a table).
// K10 (FOLD = true): `tables` are the raw tables of b entries, folded into
// `folded` (b/2 entries a table), and the round sums are those of `folded`.
// A block is blockDim.x / 32 warps and walks tiles of 32 pairs; warp w of
// the block evaluates pass s + w of the combination (a sweep s, every
// blockDim.x / 32 passes) for the tile's pairs, lane l for pair p0 + l, and
// keeps its running sums in registers.  K7's warps read the tables in
// device memory (the block's warps read the same lines, so the L1 serves all
// but the first) and never wait for each other.  K10's block folds the
// tile's entries once, its threads on consecutive entries, into its output
// and, with a stage (n_tab·2N·32 words of shared memory), into the stage,
// and every warp reads them from there after the block's barrier.  out: (n_terms, n_pts, N) residues; sums: (n_slots, N),
// the grid's sum of each slot; colsum: (n_slots, N) 64-bit sums over the
// blocks of each word of each block's reduced slot, then this launch's
// counter of finished blocks, all 0 before it.
template <int N, bool FOLD>
__global__ void __launch_bounds__(ZT_GEN_BLOCK) generic_round_kernel(
    uint32_t* __restrict__ out, uint32_t* __restrict__ sums,
    unsigned long long* __restrict__ colsum, uint32_t* folded, const uint32_t* tables, int n_tab,
    int64_t b, int64_t pairs, Elem r, const uint32_t* __restrict__ r_dev,
    const __grid_constant__ GenComb comb, int n_pts, int staged, FieldParams f) {
    constexpr int P = gen_pass<N>();
    constexpr int SW = wide_words<N>();
    extern __shared__ uint32_t stage_mem[];
    const int tid = threadIdx.x, lane = tid % 32, warps = blockDim.x / 32;
    const int n_slots = comb.n_slots;
    unsigned int* done = reinterpret_cast<unsigned int*>(colsum + (int64_t)n_slots * N);
    uint32_t rr[N];
#pragma unroll
    for (int i = 0; i < N; ++i) rr[i] = FOLD ? (r_dev ? r_dev[i] : r.w[i]) : 0u;
    uint32_t* stage = FOLD && staged ? stage_mem : nullptr;
    const int64_t tiles = (pairs + 31) / 32;
    // a lane adds at most one product a tile to each of its sums
    const int64_t kp = 32 * ((tiles + gridDim.x - 1) / gridDim.x);
    const int kbits = 64 - __clzll(kp);

    for (int s = 0; s < comb.n_passes; s += warps) {
        // this warp's pass: term j, evaluations e0 .. e0 + ne − 1
        int j = 0, e0 = 0, ne = 0;
        for (int q = s + tid / 32, jj = 0; jj < comb.n_terms; ++jj) {
            const int np = (comb.h[jj] + P - 1) / P;
            if (q < np) {
                j = jj;
                e0 = q * P;
                ne = comb.h[jj] - e0 < P ? comb.h[jj] - e0 : P;
                break;
            }
            q -= np;
        }
        const int lead = gen_has_lead(comb.k[j], n_pts) ? comb.k[j] : -1;
        uint32_t acc[P][SW];
#pragma unroll
        for (int c = 0; c < P; ++c)
#pragma unroll
            for (int w = 0; w < SW; ++w) acc[c][w] = 0;
        // K10 folds in the first sweep and reads its stage then, its output
        // (written before the block's barriers) in later ones
        const PairSrc src = FOLD ? PairSrc{folded, b / 2, s == 0 ? stage : nullptr}
                                 : PairSrc{tables, b, nullptr};
        for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
            const int64_t p0 = t * 32;
            if constexpr (FOLD) {
                if (s == 0) fold_tile<N>(folded, stage, tables, n_tab, b, p0, pairs, rr, f);
                __syncthreads();
            }
            if (ne > 0 && p0 + lane < pairs)
                eval_pass_n<N, P, P, FOLD>(ne, acc, comb.fac + comb.start[j], comb.k[j], e0, lead,
                                           src, p0 + lane, lane, f);
            if constexpr (FOLD) __syncthreads();
        }
        // the warp's exact sums, each reduced once and its words added into
        // the grid's 64-bit column sums
        warp_sum_wide<N, P>(acc);
        if (lane == 0) {
#pragma unroll
            for (int c = 0; c < P; ++c) {
                if (c < ne) {
                    uint32_t x[N];
                    redc_wide<N>(x, acc[c], kbits, f);
                    const int slot = comb.slot[j] + e0 + c;
#pragma unroll
                    for (int i = 0; i < N; ++i) atomicAdd(colsum + slot * N + i, (unsigned long long)x[i]);
                }
            }
        }
    }
    // every column sum is added before the block counts itself done
    __threadfence();
    __syncthreads();
    int last = 0;
    if (tid == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
    if (!__syncthreads_or(last)) return;

    // the last block: each slot's column sums (below gridDim.x·q) carried
    // and reduced mod q, then each term's points
    __threadfence();
    const int gbits = 64 - __clzll((long long)gridDim.x);
    for (int sl = tid; sl < n_slots; sl += blockDim.x) {
        uint32_t x[N + 1], y[N];
        unsigned long long c = 0;
#pragma unroll
        for (int w = 0; w < N; ++w) {
            c += __ldcg(colsum + sl * N + w);
            x[w] = (uint32_t)c;
            c >>= 32;
        }
        x[N] = (uint32_t)c;
        reduce_below<N>(y, x, gbits, f);
#pragma unroll
        for (int w = 0; w < N; ++w) sums[sl * N + w] = y[w];
    }
    __syncthreads();
    for (int jt = tid; jt < comb.n_terms; jt += blockDim.x) {
        // the values at t = 0..hv−1 into the output, then the other points
        const bool has_lead = gen_has_lead(comb.k[jt], n_pts);
        const int hv = comb.h[jt] - (has_lead ? 1 : 0);
        const uint32_t* sv = sums + comb.slot[jt] * N;
        uint32_t* y = out + (int64_t)jt * n_pts * N;
        for (int i = 0; i < hv * N; ++i) y[i] = sv[i];
        if (hv < n_pts) extend_points<N>(y, hv, has_lead ? sv + hv * N : nullptr, n_pts, f);
    }
}

static int make_comb(GenComb& c, const int* start, const int* fac, int n_terms, int n_pts,
                     int pass) {
    if (n_terms < 1 || n_terms > ZT_GEN_MAX_TERMS || n_pts < 1 || n_pts > ZT_GEN_MAX_POINTS ||
        start[0] != 0 || start[n_terms] > ZT_GEN_MAX_ENTRIES)
        return (int)cudaErrorInvalidValue;
    c.n_terms = n_terms;
    c.n_slots = c.n_passes = 0;
    for (int j = 0; j < n_terms; ++j) {
        const int k = start[j + 1] - start[j];
        if (k < 1) return (int)cudaErrorInvalidValue;
        c.k[j] = k;
        c.start[j] = start[j];
        c.h[j] = gen_term_slots(k, n_pts);
        c.slot[j] = c.n_slots;
        c.n_slots += c.h[j];
        c.n_passes += (c.h[j] + pass - 1) / pass;
    }
    for (int e = 0; e < start[n_terms]; ++e) c.fac[e] = fac[e];
    return 0;
}

// Shared memory of a block with a stage of n_tab tables (0: none).
static int64_t gen_smem(int n32, int stage_tables) {
    return (int64_t)stage_tables * 2 * n32 * 32 * (int64_t)sizeof(uint32_t);
}

static bool gen_block_ok(int block) {
    return block >= 32 && block <= ZT_GEN_BLOCK && block % 32 == 0;
}

// The most blocks of `block` threads with `smem` bytes of shared memory that
// fit at once on the card, for K7/K9 (fold = 0) or K10.  The block and the
// stage are chosen by the caller (sumcheck/kernels.py:generic_plan).
extern "C" int zt_gen_max_grid(int fold, int block, int64_t smem, int n32, int* max_grid) {
    *max_grid = 0;
    if (n32 != ZT_WORDS || !gen_block_ok(block) || smem > ZT_SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0, per_sm = 0, rc = 0;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return rc;
    if (fold) {
        if ((rc = prepare_smem(generic_round_kernel<ZT_WORDS, true>, smem))) return rc;
        rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, generic_round_kernel<ZT_WORDS, true>, block, (size_t)smem);
    } else {
        if ((rc = prepare_smem(generic_round_kernel<ZT_WORDS, false>, smem))) return rc;
        rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, generic_round_kernel<ZT_WORDS, false>, block, (size_t)smem);
    }
    if (rc) return rc;
    *max_grid = (per_sm > 0 ? per_sm : 1) * sms;
    return 0;
}

// One launch of either kernel: checks the plan (block, grid, stage) against
// the combination, zeroes the launch's column sums and counter on its
// stream.
template <bool FOLD>
static int gen_launch(void* out, void* sums, void* colsum, void* folded, const void* tables,
                      int n_tab, int64_t b, int64_t pairs, const uint32_t* r,
                      const void* r_dev, const int* start,
                      const int* fac, int n_terms, int n_pts, int block, int grid, int staged,
                      int n32, const uint32_t* q, uint32_t qinv, void* stream) {
    GenComb comb{};
    int rc = make_comb(comb, start, fac, n_terms, n_pts, gen_pass<ZT_WORDS>());
    if (rc) return rc;
    if (!gen_block_ok(block) || block / 32 > comb.n_passes || grid < 1)
        return (int)cudaErrorInvalidValue;
    const int64_t smem = gen_smem(n32, staged ? n_tab : 0);
    const FieldParams f = make_params(q, n32, qinv);
    if (FOLD && (r == nullptr) == (r_dev == nullptr)) return (int)cudaErrorInvalidValue;
    const Elem re = FOLD && r ? make_elem(r, n32) : Elem{};
    cudaStream_t s = (cudaStream_t)stream;
    const size_t zeroed = (size_t)comb.n_slots * n32 * sizeof(unsigned long long) + sizeof(unsigned int);
    if ((rc = (int)cudaMemsetAsync(colsum, 0, zeroed, s))) return rc;
    ZT_DISPATCH_WORDS(n32, {
        if ((rc = prepare_smem(generic_round_kernel<N, FOLD>, smem))) return rc;
        generic_round_kernel<N, FOLD><<<grid, block, smem, s>>>(
            (uint32_t*)out, (uint32_t*)sums, (unsigned long long*)colsum, (uint32_t*)folded,
            (const uint32_t*)tables, n_tab, b, pairs, re, (const uint32_t*)r_dev, comb, n_pts,
            staged, f);
    });
    return (int)cudaGetLastError();
}

// K7/K9 over (n_tab, b) tables, b/2 pairs.
extern "C" int zt_round_eval_generic(void* out, void* sums, void* colsum, const void* tables,
                                     int n_tab, int64_t b, const int* start, const int* fac,
                                     int n_terms, int n_pts, int block, int grid, int staged,
                                     int n32, const uint32_t* q, uint32_t qinv, void* stream) {
    if (b % 2) return (int)cudaErrorInvalidValue;
    return gen_launch<false>(out, sums, colsum, nullptr, tables, n_tab, b, b / 2, nullptr,
                             nullptr, start, fac, n_terms, n_pts, block, grid, staged, n32, q,
                             qinv, stream);
}

// K10: (n_tab, b_in) raw tables folded by r into `folded`, (n_tab, b_in/2),
// and the round sums of its b_in/4 pairs.  r as host words, or null and
// r_dev its words in device memory (as zt_fold).
extern "C" int zt_fold_round_eval(void* out, void* sums, void* colsum, void* folded,
                                  const void* in, int n_tab, int64_t b_in, const uint32_t* r,
                                  const void* r_dev, const int* start, const int* fac,
                                  int n_terms, int n_pts, int block, int grid, int staged,
                                  int n32, const uint32_t* q, uint32_t qinv, void* stream) {
    if (b_in % 4) return (int)cudaErrorInvalidValue;
    return gen_launch<true>(out, sums, colsum, folded, in, n_tab, b_in, b_in / 4, r, r_dev, start,
                            fac, n_terms, n_pts, block, grid, staged, n32, q, qinv, stream);
}
