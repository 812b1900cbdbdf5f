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
// few dozen Montgomery products and two to ten Keccak-f permutations, so
// the least time is that of an empty launch (0.0019 ms on the H100, PERF.md
// and chip_smoke.py's [launch] line); what it costs beyond that is a chain
// of dependent steps no parallelism shortens: the sponge is serial by
// construction.  The design keeps that chain short.  One warp evaluates up
// to ZT_FS_BLOCK points at once, a thread a point, and each thread writes
// its point's frame into the message buffer in shared memory; then thread 0
// absorbs the buffer's whole blocks, 17 aligned 8-byte words a block, with
// the lanes in its registers (keccak.cuh).  No byte goes through the sponge
// one at a time.  What the launch saves is the host's round trip: the next
// round's kernels queue behind it with no sync.

#include "field.cuh"
#include "keccak.cuh"

// one warp: up to ZT_FS_BLOCK points at a time, then thread 0's sponge
#define ZT_FS_BLOCK 32
// the message buffer: the sponge's pending bytes and a frame a thread
#define ZT_FS_MSG_BYTES (ZT_KECCAK_RATE + ZT_FS_BLOCK * (8 * ZT_MAX_WORDS + 4))

struct FsArgs {
    FieldParams f;
    uint32_t r2[ZT_MAX_WORDS];  // R² mod q
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

// The small integer v in Montgomery form.
template <int N>
__device__ __forceinline__ void small_to_mont(uint32_t (&r)[N], uint32_t v, const uint32_t (&r2)[N],
                                              const FieldParams& f) {
    uint32_t x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = i ? 0u : v;
    mont_mul<N>(r, x, r2, f);
}

// e = (1 − b)(1 − x) + b·x, the eq factor of one variable.
template <int N>
__device__ __forceinline__ void eq_factor(uint32_t (&e)[N], const uint32_t (&b)[N],
                                          const uint32_t (&x)[N], const uint32_t (&one)[N],
                                          const FieldParams& f) {
    uint32_t u[N], w[N];
    sub_mod<N>(u, one, b, f);
    sub_mod<N>(w, one, x, f);
    mont_mul<N>(u, u, w, f);
    mont_mul<N>(w, b, x, f);
    add_mod<N>(e, u, w, f);
}

template <int N>
__global__ void __launch_bounds__(ZT_FS_BLOCK) fs_round_kernel(
    uint32_t* __restrict__ state, const uint32_t* __restrict__ sums,
    const uint32_t* __restrict__ coeffs, const uint32_t* __restrict__ beta, uint32_t* pref,
    uint32_t* evals, uint32_t* rs, const FsArgs a) {
    constexpr int FRAME = 8 * N + 4;
    __shared__ uint32_t pref_s[N];
    __shared__ __align__(8) uint8_t msg[ZT_FS_MSG_BYTES];
    __shared__ int len_s;
    const FieldParams& f = a.f;
    const int tid = threadIdx.x;
    uint32_t r2[N], one[N];
#pragma unroll
    for (int i = 0; i < N; ++i) r2[i] = a.r2[i];
    small_to_mont<N>(one, 1u, r2, f);
    uint64_t s[25];  // thread 0's lanes
    if (tid == 0) {
        sponge_load(s, msg, state, a.pos);
        len_s = a.pos;
        if (beta != nullptr) {
            uint32_t p[N];
            load_words<N>(p, pref);
            if (a.rnd > 0) {  // pref ← pref · eq(β_{j−1}, r_{j−1})
                uint32_t b[N], r[N], e[N];
                load_words<N>(b, beta + (int64_t)(a.rnd - 1) * N);
                load_words<N>(r, rs + (int64_t)(a.rnd - 1) * N);
                eq_factor<N>(e, b, r, one, f);
                mont_mul<N>(p, p, e, f);
                store_words<N>(pref, p);
            }
            store_words<N>(pref_s, p);
        }
    }
    __syncthreads();

    uint32_t* ev = evals + (int64_t)a.rnd * a.n_pts * N;
    const int64_t block_words = (int64_t)a.n_terms * a.n_pts * N;
    for (int base = 0; base < a.n_pts; base += ZT_FS_BLOCK) {
        const int t = base + tid, len = len_s;
        if (t < a.n_pts) {
            uint32_t acc[N];
#pragma unroll
            for (int i = 0; i < N; ++i) acc[i] = 0;
            for (int k = 0; k < a.n_terms; ++k) {
                const uint32_t* sk = sums + ((int64_t)k * a.n_pts + t) * N;
                uint32_t res[N], x[N];
                load_words<N>(res, sk);
                for (int d = 1; d < a.n_blocks; ++d) {
                    load_words<N>(x, sk + d * block_words);
                    add_mod<N>(res, res, x, f);
                }
                load_words<N>(x, coeffs + (int64_t)k * N);
                mont_mul<N>(res, res, x, f);
                add_mod<N>(acc, acc, res, f);
            }
            if (beta != nullptr) {  // times pref · ((1−β_j)(1−t) + β_j·t)
                uint32_t b[N], tm[N], c[N], p[N];
                load_words<N>(b, beta + (int64_t)a.rnd * N);
                small_to_mont<N>(tm, (uint32_t)t, r2, f);
                eq_factor<N>(c, b, tm, one, f);
#pragma unroll
                for (int i = 0; i < N; ++i) p[i] = pref_s[i];
                mont_mul<N>(c, p, c, f);
                mont_mul<N>(acc, c, acc, f);
            }
            store_words<N>(ev + (int64_t)t * N, acc);
            put_field_frame(msg + len + tid * FRAME, f.q, acc, N);
        }
        __syncthreads();
        if (tid == 0) {
            const int n = a.n_pts - base < ZT_FS_BLOCK ? a.n_pts - base : ZT_FS_BLOCK;
            len_s = keccak_absorb_blocks(s, msg, len + n * FRAME);
        }
        __syncthreads();
    }
    if (tid != 0) return;

    uint8_t d[32];
    int len = sponge_squeeze(s, msg, len_s, d);
    uint32_t r[N];
    challenge_value(r, d, N, a.qbits);
    mont_mul<N>(r, r, r2, f);
    len = keccak_absorb_blocks(s, msg, len + put_field_frame(msg + len, f.q, r, N));
    store_words<N>(rs + (int64_t)a.rnd * N, r);
    sponge_store(state, s, msg, len);
}

// One round: `state` the sponge's ZT_KECCAK_STATE_WORDS words at fill level
// `pos`; `sums` (n_blocks, n_terms, n_pts, N); `coeffs` (n_terms, N);
// `beta` (≥ rnd + 1 rows of N) and `pref` (N) for Gruen, both null
// otherwise; `evals` (≥ rnd + 1, n_pts, N) and `rs` (≥ rnd + 1, N), whose
// row rnd this round writes (rs's row rnd − 1 is read for Gruen).
extern "C" int zt_fs_round(void* state, int pos, const void* sums, int n_blocks, int n_terms,
                           int n_pts, const void* coeffs, const void* beta, void* pref, int rnd,
                           void* evals, void* rs, int n32, const uint32_t* q, uint32_t qinv,
                           const uint32_t* r2, int qbits, void* stream) {
    if (pos < 0 || pos >= ZT_KECCAK_RATE || n_blocks < 1 || n_terms < 1 || n_pts < 1 || rnd < 0 ||
        (beta == nullptr) != (pref == nullptr) || qbits < 2 || qbits > 32 * n32)
        return (int)cudaErrorInvalidValue;
    FsArgs a{};
    a.f = make_params(q, n32, qinv);
    for (int i = 0; i < n32 && i < ZT_MAX_WORDS; ++i) a.r2[i] = r2[i];
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
