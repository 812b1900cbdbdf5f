// K1: batched Montgomery product out[i] = a[i]·b[i]·R⁻¹ mod q.
//
// Replaces zinc_tpu/ops/pallas_field.py:mont_mul_pallas_t (the limb-major
// 16-bit-limb Pallas kernel behind ops/sparse.py:_mont_mul_best).  Here one
// thread takes one element and runs CIOS over 32-bit words (field.cuh).
//
// What bounds it on the H100: at 256 bits an element is 32 bytes, so a
// product reads 64 B and writes 32 B, against 64 32×32-bit multiply-adds
// for the product and 64 for the reduction.  At ~96 B per 128 mads it sits
// near the ridge of the card's integer rate and its 3.35 TB/s; the design
// keeps each thread's loads as 16-byte vectors on neighbouring addresses
// (coalesced) and the whole CIOS chain in registers, with no shared memory.
//
// The file also holds one level of the eq recurrence (eq_level_kernel,
// below), K1's product and a subtraction an entry.

#include "field.cuh"

template <int N>
__global__ void __launch_bounds__(256) mont_mul_kernel(uint32_t* __restrict__ out,
                                                       const uint32_t* __restrict__ a,
                                                       const uint32_t* __restrict__ b,
                                                       int64_t n, FieldParams f) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        uint32_t x[N], y[N], z[N];
        load_elem<N>(x, a + i * N);
        load_elem<N>(y, b + i * N);
        mont_mul<N>(z, x, y, f);
        store_elem<N>(out + i * N, z);
    }
}

extern "C" int zt_mont_mul(void* out, const void* a, const void* b, int64_t n, int n32,
                           const uint32_t* q, uint32_t qinv, void* stream) {
    if (n <= 0) return 0;
    const FieldParams f = make_params(q, n32, qinv);
    const int block = 256;
    const int grid = grid_for(n, block, 132 * 64);
    cudaStream_t s = (cudaStream_t)stream;
    ZT_DISPATCH_WORDS(n32, mont_mul_kernel<N><<<grid, block, 0, s>>>(
        (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, f));
    return (int)cudaGetLastError();
}

// One level of the eq recurrence: from the eq table `buf` of r[j+1:] (n
// entries) and r_j, the table of r[j:] (2n entries, r_j on the lowest index
// bit): out[2i+1] = buf[i]·r_j·R⁻¹ and out[2i] = buf[i] − out[2i+1] mod q,
// both canonical residues, so the words equal the plain version's
// (poly/device.py:eq_levels, which launches this once a level).
//
// Replaces the levels of zinc_tpu/poly/device.py:69-77 (_eq_table_device)
// and zinc_tpu/sumcheck/mxu_exec.py:835 (build_eq_suffix_flat), jitted XLA
// programs in the reference, not Pallas.  r_j is read from the card (a row
// of the (s, n32) r), so a table of s levels is s launches and no host copy.
//
// What bounds it on the H100: one Montgomery product an entry in (4N² + 2N
// integer slots) against reading an element and writing two.  A 2^20 table
// at 8 words is 2^20 − 1 products over its 20 levels, ≈ 0.017 ms of slots,
// and ≈ 96 MB read and written, ≈ 0.03 ms; its 20 launches at the card's
// launch floor take about as long.  The design is K1's: one thread an
// entry, the chain in registers, the two outputs stored side by side.
template <int N>
__global__ void __launch_bounds__(256) eq_level_kernel(uint32_t* __restrict__ out,
                                                       const uint32_t* __restrict__ buf,
                                                       const uint32_t* __restrict__ r,
                                                       int64_t n, FieldParams f) {
    uint32_t rj[N];
    load_elem<N>(rj, r);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        uint32_t x[N], hi[N], lo[N];
        load_elem<N>(x, buf + i * N);
        mont_mul<N>(hi, x, rj, f);
        sub_mod<N>(lo, x, hi, f);
        store_elem<N>(out + 2 * i * N, lo);
        store_elem<N>(out + (2 * i + 1) * N, hi);
    }
}

extern "C" int zt_eq_level(void* out, const void* buf, const void* r, int64_t n, int n32,
                           const uint32_t* q, uint32_t qinv, void* stream) {
    if (n <= 0) return 0;
    const FieldParams f = make_params(q, n32, qinv);
    const int block = 256;
    const int grid = grid_for(n, block, 132 * 64);
    cudaStream_t s = (cudaStream_t)stream;
    ZT_DISPATCH_WORDS(n32, eq_level_kernel<N><<<grid, block, 0, s>>>(
        (uint32_t*)out, (const uint32_t*)buf, (const uint32_t*)r, n, f));
    return (int)cudaGetLastError();
}
