// The scope of the K3/K4 round kernels (sumcheck.cu), the one place it is
// written: sumcheck.cu includes this file and zinc_tpu_torch/sumcheck/kernels.py
// reads its #defines.  The combination rides in the launch's parameter block
// (at most ZT_EVAL_MAX_TERMS terms of at most ZT_EVAL_MAX_FACTORS factors; K4
// takes one factor fewer, the eq weight being the last); at most
// ZT_EVAL_MAX_POINTS points.  A thread keeps one running sum per term and
// evaluated point in shared memory, 2N + 1 words of ZT_EVAL_ACC_BYTES, so a
// block of T threads needs slots·(2N + 1)·ZT_EVAL_ACC_BYTES·T bytes of the
// ZT_SMEM_LIMIT (generic.cuh); T is the largest power of two from
// ZT_EVAL_BLOCK down to ZT_EVAL_MIN_BLOCK that fits, chosen by
// sumcheck/kernels.py:eval_block and checked by the launch.

#pragma once

#include "generic.cuh"

#define ZT_EVAL_BLOCK 256
#define ZT_EVAL_MIN_BLOCK 32
#define ZT_EVAL_MAX_TERMS 32
#define ZT_EVAL_MAX_FACTORS 4
#define ZT_EVAL_MAX_POINTS 5
#define ZT_EVAL_ACC_BYTES 4
