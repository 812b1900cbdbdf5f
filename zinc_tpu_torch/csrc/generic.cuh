// The generic kernels' scope, the one place it is written: generic.cu
// includes this file and zinc_tpu_torch/sumcheck/kernels.py reads its
// #defines.  The combination rides in the launch's parameter block (at most
// ZT_GEN_MAX_TERMS terms and ZT_GEN_MAX_ENTRIES factor indices over all
// terms); a block keeps its 64-bit sums (ZT_GEN_SUM_BYTES per term, point
// and word) and its partial products (ZT_GEN_PROD_BYTES per point, word and
// thread) in dynamic shared memory, at most ZT_SMEM_LIMIT bytes (the H100's
// opt-in limit per block); prepare_smem below applies it to a launch.

#pragma once

#define ZT_GEN_BLOCK 64
#define ZT_GEN_MAX_TERMS 32
#define ZT_GEN_MAX_ENTRIES 256
#define ZT_GEN_SUM_BYTES 8
#define ZT_GEN_PROD_BYTES 4
#define ZT_SMEM_LIMIT 232448

#include <cstdint>
#include <cuda_runtime.h>

// Opts `kernel` in to `smem` bytes of dynamic shared memory (above the
// default 48 KB); refuses more than ZT_SMEM_LIMIT.
template <typename K>
static int prepare_smem(K kernel, int64_t smem) {
    if (smem > ZT_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024)
        return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    return 0;
}
