// fs_round: one round of the device-resident Fiat-Shamir sumcheck, from
// the round's sums to the next challenge, in one launch.  It replaces the
// reference's XLA round step, zinc_tpu/sumcheck/device_fs.py:85
// (_make_fs_step) with the sponge calls it makes (keccak.cuh), and the
// decode of the round's sums before it (g_to_evals_device and
// gruen_g_to_evals_device, zinc_tpu/sumcheck/mxu_exec.py).  Given the sums
// of D blocks, (D, n_terms, n_pts, N) canonical residues (K3, K4, K7/K9 or
// K10 output, one buffer per block, stacked on this device), it
//
//   * adds the D residues of each (term, point) mod q;
//   * forms s(t) = Σ_k coeff_k · res_k(t), times pref · ((1−β_j)(1−t) + β_j·t)
//     for Gruen, where pref is first ratcheted by eq(β_{j−1}, r_{j−1}) in
//     rounds j ≥ 1 (device_fs.py:206-208 ratchets at the same place);
//   * writes s(0..d) to evals[j];
//   * absorbs each as 0x03 ‖ q_be ‖ 0x05 0x01 ‖ mont_be ‖ 0x03, squeezes
//     (digest, ratchet 0x00 ‖ digest ‖ 0x01, masked value), turns the value
//     into Montgomery form (a product with R² mod q), absorbs r's frame and
//     writes r to rs[j], where the next round's fold reads it.
//
// The sponge (25 lanes and the 136 buffered bytes, keccak.cuh) lives in
// device memory between launches; its fill level is computed on the host
// from the sizes (sumcheck/device_fs.py) and passed in.
//
// Bound: the launch floor.  A round reads a few hundred bytes and forms a
// few dozen Montgomery products and P Keccak-f permutations (P = 3 for the
// R1CS sumcheck 1 at 8 words, up to 10 for path B at 16 words), so the
// least time is that of an empty launch (0.0019 ms on the H100, PERF.md
// and chip_smoke.py's [launch] line).  What it costs beyond that is a
// serial chain: P permutations and the products that feed the first
// frame, then r's.  The single-thread sponge this replaces ran that chain
// at 5.6-15 µs a permutation (a fit over bench_kernels.fs_cases, PERF.md),
// from a kernel of 95-168 registers and a 240-byte stack frame whose
// unrolled permutations outgrew the instruction cache of the one SM it runs
// on.  The design shortens both halves of the chain:
//   * the permutation is spread over the warp (keccak.cuh): a state lane a
//     lane, a round a handful of shuffles, its 24 rounds a loop that stays
//     in the instruction cache; absorbing, moving the leftover bytes,
//     padding and the sponge's load and store are a word or byte a lane;
//   * the products run in steps of one product a lane, from one call site:
//     step 0 forms every coeff_k · res_k(t) of a group of points at once
//     (a lane a term and point) and the ratchet's β_{j−1}·r_{j−1}; Gruen
//     adds step 1 (acc_t · c_t, and pref · eq on the ratchet's lane) and
//     step 2 (· pref).  The eq factors need no product: c_t = (1 − β_j) +
//     t·(2β_j − 1) and eq(b, r) = 1 − b − r + 2·b·r are additions, and 1̂
//     comes in as a constant like R².  So a Gruen round's chain is 3
//     products, then the permutations, then r's product.
// One launch a round, one warp; the next round's kernels queue behind it
// with no sync.

#include "field.cuh"
#include "keccak.cuh"

// one warp: the sponge on lanes 0-24, a term × point product a lane
#define ZT_FS_BLOCK 32
// the message buffer: the sponge's pending bytes and a frame a point of a group
#define ZT_FS_MSG_BYTES (ZT_KECCAK_RATE + ZT_FS_BLOCK * (8 * ZT_MAX_WORDS + 4))
// the lane of the Gruen ratchet's products
#define ZT_FS_RATCHET_LANE (ZT_FS_BLOCK - 1)

struct FsArgs {
    FieldParams f;
    uint32_t r2[ZT_MAX_WORDS];   // R² mod q
    uint32_t one[ZT_MAX_WORDS];  // 1̂ = R mod q
    int qbits, n_blocks, n_terms, n_pts, pos, rnd;
};

template <int N>
__device__ __forceinline__ void load_words(uint32_t (&x)[N], const uint32_t* p) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
}

template <int N>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = x[i];
}

// r = a + t·d mod q for a small t ≥ 0: double and add over t's bits.
template <int N>
__device__ __forceinline__ void add_small_multiple(uint32_t (&r)[N], const uint32_t (&a)[N],
                                                   const uint32_t (&d)[N], int t,
                                                   const FieldParams& f) {
    uint32_t m[N];
#pragma unroll
    for (int i = 0; i < N; ++i) m[i] = 0;
    for (int bit = t ? 31 - __clz(t) : -1; bit >= 0; --bit) {
        add_mod<N>(m, m, m, f);
        if ((t >> bit) & 1) add_mod<N>(m, m, d, f);
    }
    add_mod<N>(r, a, m, f);
}

template <int N>
__global__ void __launch_bounds__(ZT_FS_BLOCK) fs_round_kernel(
    uint32_t* __restrict__ state, const uint32_t* __restrict__ sums,
    const uint32_t* __restrict__ coeffs, const uint32_t* __restrict__ beta, uint32_t* pref,
    uint32_t* evals, uint32_t* rs, const FsArgs a) {
    constexpr int FRAME = 8 * N + 4;
    __shared__ uint32_t prod_s[ZT_FS_BLOCK][N];  // step 0's products, a lane each
    __shared__ uint32_t val_s[ZT_FS_BLOCK + 1][N];  // the group's s(t), then r: their frames
    __shared__ uint32_t q_s[N], e_s[N], pref_s[N];
    __shared__ __align__(8) uint8_t msg[ZT_FS_MSG_BYTES];
    const FieldParams& f = a.f;
    const int lane = threadIdx.x;
    const bool gruen = beta != nullptr;
    const bool ratchet = gruen && a.rnd > 0;  // pref ← pref · eq(β_{j−1}, r_{j−1})
    const KeccakLanes k = keccak_lanes(lane);
    uint32_t lo, hi;
    sponge_load_warp(lo, hi, msg, state, a.pos, lane);
    int len = a.pos;
    uint32_t one[N], c0[N], dc[N], p0[N];
    load_words<N>(one, a.one);
    if (lane == 0) load_words<N>(q_s, f.q);
    if (gruen) {  // the eq factor of β_j at t: (1 − β_j) + t·(2β_j − 1), adds only
        uint32_t b[N];
        load_words<N>(b, beta + (int64_t)a.rnd * N);
        sub_mod<N>(c0, one, b, f);
        add_mod<N>(dc, b, b, f);
        sub_mod<N>(dc, dc, one, f);
        load_words<N>(p0, pref);
    }

    uint32_t* ev = evals + (int64_t)a.rnd * a.n_pts * N;
    const int64_t block_words = (int64_t)a.n_terms * a.n_pts * N;
    // points a group: a lane for each term × point, and the ratchet's lane
    const int per = (gruen ? ZT_FS_BLOCK - 1 : ZT_FS_BLOCK) / a.n_terms;
    const int group = per > 0 ? per : 1;
    // 32 Gruen terms leave no lane free in step 0: the ratchet's first
    // product then takes a step of its own (step −1)
    const bool own_step = ratchet && a.n_terms * group >= ZT_FS_BLOCK;
    for (int base = 0; base < a.n_pts; base += group) {
        const int g = a.n_pts - base < group ? a.n_pts - base : group;
        const bool first = base == 0;
        const bool br = ratchet && first && lane == ZT_FS_RATCHET_LANE;  // this lane's β_{j−1}·r_{j−1}
        uint32_t acc[N];
        // Every product of the group is one step of this loop, one product a
        // lane: a single call site, so later steps run from the instruction
        // cache.  Step 0: coeff_k · Σ_D sums on lane k·g + t, and the
        // ratchet's β_{j−1}·r_{j−1}.  Gruen, step 1: acc_t · c_t, and the
        // ratchet's pref · e; step 2: pref · (acc_t · c_t).
        for (int step = first && own_step ? -1 : 0; step < (gruen ? 3 : 1); ++step) {
            uint32_t x[N], y[N], u[N];
#pragma unroll
            for (int i = 0; i < N; ++i) x[i] = y[i] = 0;
            if (step <= 0 && br && (step < 0) == own_step) {
                load_words<N>(x, beta + (int64_t)(a.rnd - 1) * N);
                load_words<N>(y, rs + (int64_t)(a.rnd - 1) * N);
            } else if (step == 0) {
                if (lane < a.n_terms * g) {
                    const int t = base + lane % g;
                    const uint32_t* sk = sums + ((int64_t)(lane / g) * a.n_pts + t) * N;
                    load_words<N>(x, sk);
                    for (int d = 1; d < a.n_blocks; ++d) {
                        load_words<N>(u, sk + d * block_words);
                        add_mod<N>(x, x, u, f);
                    }
                    load_words<N>(y, coeffs + (int64_t)(lane / g) * N);
                }
            } else if (step == 1) {
                if (lane < g) {
                    load_words<N>(x, acc);
                    add_small_multiple<N>(y, c0, dc, base + lane, f);
                } else if (lane == ZT_FS_RATCHET_LANE) {
                    load_words<N>(x, p0);
                    load_words<N>(y, e_s);
                }
            } else {
                load_words<N>(x, acc);
                load_words<N>(y, pref_s);
            }
            mont_mul<N>(u, x, y, f);
            if (step <= 0 && br && (step < 0) == own_step) {
                // eq(b, r) = (1 − b)(1 − r) + b·r = 1 − b − r + 2·b·r
                uint32_t e[N];
                add_mod<N>(e, u, u, f);
                add_mod<N>(e, e, one, f);
                sub_mod<N>(e, e, x, f);
                sub_mod<N>(e, e, y, f);
                store_words<N>(e_s, e);
            }
            if (step == 0) {
                if (lane < a.n_terms * g) store_words<N>(prod_s[lane], u);
                __syncwarp();
                load_words<N>(acc, prod_s[lane < g ? lane : 0]);
                for (int t = 1; t < a.n_terms; ++t) {
                    load_words<N>(u, prod_s[t * g + (lane < g ? lane : 0)]);
                    add_mod<N>(acc, acc, u, f);
                }
            } else if (step == 1) {
                if (first && lane == ZT_FS_RATCHET_LANE) {
                    if (!ratchet) load_words<N>(u, p0);
                    store_words<N>(pref_s, u);
                    if (ratchet) store_words<N>(pref, u);
                }
                load_words<N>(acc, u);
                __syncwarp();
            } else if (step == 2) {
                load_words<N>(acc, u);
            }
        }
        if (lane < g) {
            store_words<N>(ev + (int64_t)(base + lane) * N, acc);
            store_words<N>(val_s[lane], acc);
        }
        __syncwarp();
        for (int j = lane; j < g * FRAME; j += ZT_FS_BLOCK)
            msg[len + j] = frame_byte(j % FRAME, q_s, val_s[j / FRAME], N);
        len = keccak_absorb_warp(lo, hi, msg, len + g * FRAME, k, lane);
    }

    len = keccak_squeeze_warp(lo, hi, msg, len, k, lane);
    uint32_t r[N], r2[N];
    challenge_value<N>(r, msg + len - 33, a.qbits);  // every lane: the same r
    load_words<N>(r2, a.r2);
    mont_mul<N>(r, r, r2, f);
    if (lane == 0) store_words<N>(val_s[ZT_FS_BLOCK], r);
    __syncwarp();
    for (int j = lane; j < FRAME; j += ZT_FS_BLOCK)
        msg[len + j] = frame_byte(j, q_s, val_s[ZT_FS_BLOCK], N);
    len = keccak_absorb_warp(lo, hi, msg, len + FRAME, k, lane);
    if (lane == 0) store_words<N>(rs + (int64_t)a.rnd * N, r);
    sponge_store_warp(state, lo, hi, msg, len, lane);
}

// One round: `state` the sponge's ZT_KECCAK_STATE_WORDS words at fill level
// `pos`; `sums` (n_blocks, n_terms, n_pts, N); `coeffs` (n_terms, N);
// `beta` (≥ rnd + 1 rows of N) and `pref` (N) for Gruen, both null
// otherwise; at most 32 terms (the round kernels' most);
// `evals` (≥ rnd + 1, n_pts, N) and `rs` (≥ rnd + 1, N), whose row rnd this
// round writes (rs's row rnd − 1 is read for Gruen); r2 and one are R² and
// 1̂ = R mod q.
extern "C" int zt_fs_round(void* state, int pos, const void* sums, int n_blocks, int n_terms,
                           int n_pts, const void* coeffs, const void* beta, void* pref, int rnd,
                           void* evals, void* rs, int n32, const uint32_t* q, uint32_t qinv,
                           const uint32_t* r2, const uint32_t* one, int qbits, void* stream) {
    if (pos < 0 || pos >= ZT_KECCAK_RATE || n_blocks < 1 || n_terms < 1 || n_pts < 1 || rnd < 0 ||
        (beta == nullptr) != (pref == nullptr) || n_terms > ZT_FS_BLOCK || qbits < 2 || qbits > 32 * n32)
        return (int)cudaErrorInvalidValue;
    FsArgs a{};
    a.f = make_params(q, n32, qinv);
    for (int i = 0; i < n32 && i < ZT_MAX_WORDS; ++i) {
        a.r2[i] = r2[i];
        a.one[i] = one[i];
    }
    a.qbits = qbits;
    a.n_blocks = n_blocks;
    a.n_terms = n_terms;
    a.n_pts = n_pts;
    a.pos = pos;
    a.rnd = rnd;
    cudaStream_t s = (cudaStream_t)stream;
    ZT_DISPATCH_WORDS(n32, fs_round_kernel<N><<<1, ZT_FS_BLOCK, 0, s>>>(
        (uint32_t*)state, (const uint32_t*)sums, (const uint32_t*)coeffs, (const uint32_t*)beta,
        (uint32_t*)pref, (uint32_t*)evals, (uint32_t*)rs, a));
    return (int)cudaGetLastError();
}
