"""BLAKE3 of inputs of at most 64 bytes (one chunk, one block), batched in
numpy: the leaf and node hashes of the Zip commitment's Merkle trees."""

from __future__ import annotations

import numpy as np

IV = np.array([0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
               0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], np.uint32)
PERM = [2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8]
CHUNK_START, CHUNK_END, ROOT = 1, 2, 8
BATCH = 1 << 15  # lanes a pass: the working set stays in cache


def _rotr(x, n):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _compress(m: list, block_len: int) -> np.ndarray:
    n = len(m[0])
    s = [np.full(n, v, np.uint32) for v in IV] + [np.full(n, v, np.uint32) for v in IV[:4]]
    s += [np.zeros(n, np.uint32), np.zeros(n, np.uint32),
          np.full(n, block_len, np.uint32), np.full(n, CHUNK_START | CHUNK_END | ROOT, np.uint32)]

    def g(a, b, c, d, x, y):
        s[a] = s[a] + s[b] + x
        s[d] = _rotr(s[d] ^ s[a], 16)
        s[c] = s[c] + s[d]
        s[b] = _rotr(s[b] ^ s[c], 12)
        s[a] = s[a] + s[b] + y
        s[d] = _rotr(s[d] ^ s[a], 8)
        s[c] = s[c] + s[d]
        s[b] = _rotr(s[b] ^ s[c], 7)

    for rnd in range(7):
        g(0, 4, 8, 12, m[0], m[1])
        g(1, 5, 9, 13, m[2], m[3])
        g(2, 6, 10, 14, m[4], m[5])
        g(3, 7, 11, 15, m[6], m[7])
        g(0, 5, 10, 15, m[8], m[9])
        g(1, 6, 11, 12, m[10], m[11])
        g(2, 7, 8, 13, m[12], m[13])
        g(3, 4, 9, 14, m[14], m[15])
        if rnd != 6:
            m = [m[p] for p in PERM]
    return np.stack([s[i] ^ s[i + 8] for i in range(8)], axis=-1)


def hash_short(data: np.ndarray) -> np.ndarray:
    """(..., k) uint8 inputs of one length k ≤ 64 → (..., 32) uint8 digests."""
    k = data.shape[-1]
    flat = data.reshape(-1, k)
    block = np.zeros((len(flat), 64), np.uint8)
    block[:, :k] = flat
    words = block.view("<u4").astype(np.uint32)
    out = np.empty((len(flat), 8), np.uint32)
    with np.errstate(over="ignore"):
        for i in range(0, len(flat), BATCH):
            w = words[i:i + BATCH]
            out[i:i + BATCH] = _compress([w[:, j] for j in range(16)], k)
    return out.astype("<u4").view(np.uint8).reshape(data.shape[:-1] + (32,))


def merkle_levels(leaves: np.ndarray) -> list[np.ndarray]:
    """Every level of the trees over the last-but-one axis: ``leaves`` is
    (..., 2^d, k) uint8; level 0 holds the leaf digests (..., 2^d, 32) and
    level d the roots (..., 1, 32).  A node hashes its children's 64 bytes."""
    levels = [hash_short(leaves)]
    while levels[-1].shape[-2] > 1:
        lv = levels[-1]
        pairs = lv.reshape(lv.shape[:-2] + (lv.shape[-2] // 2, 64))
        levels.append(hash_short(pairs))
    return levels
