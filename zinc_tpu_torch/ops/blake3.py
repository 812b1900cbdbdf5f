"""Batched BLAKE3 Merkle trees in plain PyTorch.

The port of ``zinc_tpu/ops/blake3_kernel.py`` (XLA code in the reference,
not Pallas).  Every node is one BLAKE3 compression over a 64-byte block:
a leaf hashes one codeword element's 8·k_words-byte serialization, a merge
hashes two 32-byte child digests.  Lanes are int64 tensors holding u32
values, masked to 32 bits after each add and rotate (torch's CPU uint32 has
no add).  The tree is hashed level by level.  A hand-written kernel for
this is later work.
"""

from __future__ import annotations

import torch

from ..hashing.blake3 import CHUNK_END, CHUNK_START, IV, MSG_PERMUTATION, ROOT

M32 = 0xFFFFFFFF
FLAGS = CHUNK_START | CHUNK_END | ROOT  # every node is one single-block chunk


def _round_perms() -> list[list[int]]:
    perm = list(range(16))
    out = []
    for _ in range(7):
        out.append(perm)
        perm = [perm[i] for i in MSG_PERMUTATION]
    return out


_PERMS = _round_perms()


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & M32


def _g(s, a, b, c, d, mx, my) -> None:
    s[a] = (s[a] + s[b] + mx) & M32
    s[d] = _rotr(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & M32
    s[b] = _rotr(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b] + my) & M32
    s[d] = _rotr(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & M32
    s[b] = _rotr(s[b] ^ s[c], 7)


def compress_batch(msg: torch.Tensor, block_len: int, flags: int) -> torch.Tensor:
    """One BLAKE3 compression from the IV, counter 0: msg (B, 16) u32 words
    in int64 lanes → (B, 8) output chaining values."""
    b = msg.shape[0]
    m = [msg[:, i] for i in range(16)]

    def const(v):
        return torch.full((b,), v, dtype=torch.int64, device=msg.device)

    s = [const(IV[i]) for i in range(8)] + [
        const(IV[0]), const(IV[1]), const(IV[2]), const(IV[3]),
        const(0), const(0), const(block_len), const(flags),
    ]
    for perm in _PERMS:
        mr = [m[perm[i]] for i in range(16)]
        _g(s, 0, 4, 8, 12, mr[0], mr[1])
        _g(s, 1, 5, 9, 13, mr[2], mr[3])
        _g(s, 2, 6, 10, 14, mr[4], mr[5])
        _g(s, 3, 7, 11, 15, mr[6], mr[7])
        _g(s, 0, 5, 10, 15, mr[8], mr[9])
        _g(s, 1, 6, 11, 12, mr[10], mr[11])
        _g(s, 2, 7, 8, 13, mr[12], mr[13])
        _g(s, 3, 4, 9, 14, mr[14], mr[15])
    return torch.stack([s[i] ^ s[i + 8] for i in range(8)], dim=1)


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    return (
        ((x & 0xFF) << 24) | (((x >> 8) & 0xFF) << 16) | (((x >> 16) & 0xFF) << 8) | (x >> 24)
    )


def leaf_msg_words(words: torch.Tensor) -> torch.Tensor:
    """(B, 2·kw) canonical u32 words of two's-complement values → (B, 16)
    BLAKE3 message words of their leaf serialization: little-endian u64 word
    order, big-endian bytes inside each u64 (``zip/merkle.py:int_to_leaf_bytes``).
    The u64 word i serializes as BE(w[2i+1]) ‖ BE(w[2i]), so message word 2i
    is bswap(w[2i+1]) and 2i+1 is bswap(w[2i])."""
    b, n = words.shape
    assert n <= 16, "leaves longer than one 64-byte block"
    sw = _bswap32(words).reshape(b, n // 2, 2).flip(-1).reshape(b, n)
    return torch.cat([sw, sw.new_zeros((b, 16 - n))], dim=1)


def merkle_tree_device(enc: torch.Tensor, k_words: int) -> list[torch.Tensor]:
    """Full Merkle layers for every row at once.

    enc: (R, N, 2·k_words) canonical u32 words (int32 or int64) of the
    codeword elements, N a power of two.  Returns [leaves (R, N, 8),
    (R, N/2, 8), ..., root (R, 1, 8)] int64 digest words (the digest bytes
    are the words in little-endian order)."""
    r, n, w = enc.shape
    assert w == 2 * k_words
    msg = leaf_msg_words(enc.reshape(r * n, w).to(torch.int64) & M32)
    level = compress_batch(msg, 8 * k_words, FLAGS).reshape(r, n, 8)
    layers = [level]
    while level.shape[1] > 1:
        level = merge_level(level)
        layers.append(level)
    return layers


def merge_level(level: torch.Tensor) -> torch.Tensor:
    """One Merkle level up: (R, N, 8) digests → (R, N/2, 8), node i the hash
    of children 2i ‖ 2i+1."""
    return compress_batch(level.reshape(-1, 16), 64, FLAGS).reshape(level.shape[0], -1, 8)
