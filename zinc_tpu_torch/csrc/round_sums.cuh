// What the round kernels share, K3/K4 (sumcheck.cu) and the generic kernels
// (generic.cu): the width of a running sum of unreduced products, and the
// extension of a term's sums from its first points (and leading
// coefficient) to every point of the round.

#pragma once

#include "field.cuh"

// Words of a wide slot: a sum of 2N-word products and its carry word.
template <int N>
__host__ __device__ constexpr int wide_words() { return 2 * N + 1; }

// y[0..h) are the values at t = 0..h−1 of a polynomial of degree D (N-word
// residues, one after the other), and `lead` its leading coefficient when
// h = D (nullptr when h = D + 1); writes its values at t = h..n_pts−1 after
// them.  Forward differences at 0 (the D-th is D!·lead), the top one held
// constant, then running sums back up; exact mod q.
template <int N>
__device__ __noinline__ void extend_points(uint32_t* y, int h, const uint32_t* lead, int n_pts,
                                           const FieldParams& f) {
    const int D = lead ? h : h - 1;
    uint32_t x[N], z[N];
    for (int k = 1; k < h; ++k) {
        for (int i = h - 1; i >= k; --i) {
#pragma unroll
            for (int w = 0; w < N; ++w) {
                x[w] = y[i * N + w];
                z[w] = y[(i - 1) * N + w];
            }
            sub_mod<N>(x, x, z, f);
#pragma unroll
            for (int w = 0; w < N; ++w) y[i * N + w] = x[w];
        }
    }
    if (lead) {  // Δ^D = D!·lead
#pragma unroll
        for (int w = 0; w < N; ++w) x[w] = lead[w];
        for (int m = 2; m <= D; ++m) {
#pragma unroll
            for (int w = 0; w < N; ++w) z[w] = x[w];
            for (int i = 1; i < m; ++i) add_mod<N>(x, x, z, f);
        }
#pragma unroll
        for (int w = 0; w < N; ++w) y[D * N + w] = x[w];
    }
    for (int i = D + 1; i < n_pts; ++i)
#pragma unroll
        for (int w = 0; w < N; ++w) y[i * N + w] = y[D * N + w];
    for (int k = D - 1; k >= 0; --k) {
        for (int t = k + 1; t < n_pts; ++t) {
#pragma unroll
            for (int w = 0; w < N; ++w) {
                x[w] = y[t * N + w];
                z[w] = y[(t - 1) * N + w];
            }
            add_mod<N>(x, x, z, f);
#pragma unroll
            for (int w = 0; w < N; ++w) y[t * N + w] = x[w];
        }
    }
}
