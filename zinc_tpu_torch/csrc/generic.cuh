// The generic kernels' scope and shape, the one place they are written:
// generic.cu includes this file and zinc_tpu_torch/sumcheck/kernels.py reads
// its #defines.  The combination rides in the launch's parameter block (at
// most ZT_GEN_MAX_TERMS terms and ZT_GEN_MAX_ENTRIES factor indices over all
// terms), at most ZT_GEN_MAX_POINTS points.  A term of k factors takes
// min(k + 1, n_pts) evaluations (a term of one factor min(2, n_pts)), in
// passes of ZT_GEN_PASS of them (ZT_GEN_PASS_WIDE above 8 words); a warp
// takes one pass, and a block is a warp for each pass of the term with the
// most passes, up to ZT_GEN_BLOCK threads (sumcheck/kernels.py:generic_plan,
// checked by the launch).  K10's stage
// holds the folded entries of 32 pairs of every table in shared memory, when
// they fit ZT_SMEM_LIMIT bytes (the H100's opt-in limit a block);
// prepare_smem below applies the shared memory to a launch.

#pragma once

#define ZT_GEN_BLOCK 256
#define ZT_GEN_PASS 2
#define ZT_GEN_PASS_WIDE 1
#define ZT_GEN_MAX_TERMS 32
#define ZT_GEN_MAX_ENTRIES 256
#define ZT_GEN_MAX_POINTS 1024
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
