// The Zip open's column records, written on the card in their wire layout.
//
// Replaces zinc_tpu/zip/device.py:261-346 (dispatch_column_gathers, the XLA
// gathers of the opened columns and of their Merkle siblings, and
// write_column_records, which lays them into the records on the host), XLA
// and numpy in the reference, not Pallas.  It takes no field, so it is built
// into the BLAKE3 target's library, once.
//
// Layout (zip/pcs.py:open_poly's bytes).  Record c of n_open opens column
// cols[c] of R codeword rows of cw = 2^depth elements: first each row's kw32
// words as little-endian u32 (the values, 4·kw32 bytes a row), then one
// Merkle path a row: its depth as 8 big-endian bytes, then, level l = 0 ..
// depth − 1, the sibling (cols[c] >> l) ^ 1 of level l as 8 little-endian u32
// (the low 32 bits of the level's int64 lanes).  Both sections are whole
// 8-byte units (kw32 is even, a path is 8 + 32·depth bytes), and so is a
// record, so each thread writes one 8-byte unit: a pair of a row's words, a
// path's header, or half a digest's words, the latter read as two int64
// lanes.  A path is 8-byte aligned and not 16-byte aligned, so 8 bytes is
// the widest store every unit can make.
//
// Grid: x over the units of one record (consecutive threads write
// consecutive units, so a warp stores 256 contiguous bytes), y over the
// records.  Four consecutive threads read one 64-byte digest and a row's
// values are 4·kw32 contiguous bytes, so every 32-byte sector read is used
// whole.  What bounds it on the H100: the bytes, at 1000 records of 1024 rows
// of 2048 codewords (kw32 = 8, depth 11) 33 MB of values and 721 MB of
// sibling lanes read and 401 MB written, ≈ 0.35 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#define ZR_MAX_DEPTH 32
#define ZR_BLOCK 256
#define ZR_MAX_GRID_Y 65535

// every level's int64 digest lanes, (R, cw >> l, 8) each
struct ZrLevels {
    const unsigned long long* p[ZR_MAX_DEPTH];
};

__global__ void __launch_bounds__(ZR_BLOCK)
zip_records_kernel(unsigned long long* __restrict__ out, const unsigned long long* __restrict__ enc,
                   const long long* __restrict__ cols, const ZrLevels levels, int64_t n_open,
                   uint32_t cw, uint32_t half, uint32_t val_units, uint32_t path_units,
                   uint32_t rec_units, unsigned long long header) {
    const uint32_t u = blockIdx.x * ZR_BLOCK + threadIdx.x;
    if (u >= rec_units) return;
    for (int64_t c = blockIdx.y; c < n_open; c += gridDim.y) {
        const uint32_t col = (uint32_t)cols[c];
        unsigned long long v;
        if (u < val_units) {  // words 2w, 2w + 1 of row r
            const uint32_t r = u / half, w = u - r * half;
            v = enc[((uint64_t)r * cw + col) * half + w];
        } else {
            const uint32_t p = u - val_units, r = p / path_units, k = p - r * path_units;
            if (k == 0) {
                v = header;
            } else {  // words 2j, 2j + 1 of the sibling at level lvl
                const uint32_t lvl = (k - 1) >> 2, j = (k - 1) & 3;
                const uint32_t sib = (col >> lvl) ^ 1u;
                const unsigned long long* d =
                    levels.p[lvl] + ((uint64_t)r * (cw >> lvl) + sib) * 8 + 2 * j;
                v = (d[0] & 0xffffffffull) | (d[1] << 32);
            }
        }
        out[(uint64_t)c * rec_units + u] = v;
    }
}

// out: (n_open, rec_bytes) bytes, rec_bytes = rows·(4·kw32 + 8 + 32·depth);
// enc: (rows, cw, kw32) u32 words, cw = 2^depth; cols: n_open int64 column
// indices below cw, on the card; levels: `depth` device pointers (a host
// array), level l's (rows, cw >> l, 8) int64 lanes.
extern "C" int zt_zip_records(void* out, const void* enc, const void* cols, const int64_t* levels,
                              int64_t n_open, int64_t rows, int64_t cw, int kw32, int depth,
                              void* stream) {
    if (n_open <= 0 || rows <= 0) return 0;
    if (kw32 < 2 || kw32 % 2 || depth < 0 || depth > ZR_MAX_DEPTH || cw != (1ll << depth))
        return (int)cudaErrorInvalidValue;
    const int64_t half = kw32 / 2, path_units = 1 + 4 * (int64_t)depth;
    const int64_t val_units = rows * half, rec_units = val_units + rows * path_units;
    if (rec_units >= (1ll << 32) - ZR_BLOCK) return (int)cudaErrorInvalidValue;
    ZrLevels lv = {};
    for (int l = 0; l < depth; l++) lv.p[l] = (const unsigned long long*)levels[l];
    // depth (at most 32) as 8 big-endian bytes, read as a little-endian u64: its last byte
    const unsigned long long header = (unsigned long long)depth << 56;
    const dim3 grid((unsigned)((rec_units + ZR_BLOCK - 1) / ZR_BLOCK),
                    (unsigned)(n_open < ZR_MAX_GRID_Y ? n_open : ZR_MAX_GRID_Y));
    zip_records_kernel<<<grid, ZR_BLOCK, 0, (cudaStream_t)stream>>>(
        (unsigned long long*)out, (const unsigned long long*)enc, (const long long*)cols, lv, n_open,
        (uint32_t)cw, (uint32_t)half, (uint32_t)val_units, (uint32_t)path_units,
        (uint32_t)rec_units, header);
    return (int)cudaGetLastError();
}
