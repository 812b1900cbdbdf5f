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
