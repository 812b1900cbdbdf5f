"""BLAKE3 — host reference implementation.

The Merkle commitment layer hashes codeword elements and merges digests with
BLAKE3 (leaf = blake3(bytes), merge = blake3(left ‖ right); see
zinc/src/zip/pcs/utils.rs:87-118).  Every node is a plain hash of
at most a few blocks, so the batched device kernels (ops/blake3.py,
csrc/blake3.cu) only need the single-chunk path; this host implementation is the general
oracle it is tested against.
"""

from __future__ import annotations

import struct

IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

MSG_PERMUTATION = [2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8]

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

BLOCK_LEN = 64
CHUNK_LEN = 1024
OUT_LEN = 32

_M32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


def compress(cv: list[int], block_words: list[int], counter: int, block_len: int, flags: int) -> list[int]:
    """The BLAKE3 compression function; returns the full 16-word state."""
    state = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        IV[0], IV[1], IV[2], IV[3],
        counter & _M32, (counter >> 32) & _M32, block_len, flags,
    ]
    m = list(block_words)

    def g(a, b, c, d, mx, my):
        state[a] = (state[a] + state[b] + mx) & _M32
        state[d] = _rotr(state[d] ^ state[a], 16)
        state[c] = (state[c] + state[d]) & _M32
        state[b] = _rotr(state[b] ^ state[c], 12)
        state[a] = (state[a] + state[b] + my) & _M32
        state[d] = _rotr(state[d] ^ state[a], 8)
        state[c] = (state[c] + state[d]) & _M32
        state[b] = _rotr(state[b] ^ state[c], 7)

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
            m = [m[p] for p in MSG_PERMUTATION]

    return [
        (state[i] ^ state[i + 8]) & _M32 if i < 8 else (state[i] ^ cv[i - 8]) & _M32
        for i in range(16)
    ]


def _block_words(block: bytes) -> list[int]:
    block = block + b"\x00" * (BLOCK_LEN - len(block))
    return list(struct.unpack("<16I", block))


def _chunk_cv(chunk: bytes, chunk_counter: int, is_root: bool) -> list[int]:
    """Chaining value (or root state) of one ≤1024-byte chunk."""
    blocks = [chunk[i : i + BLOCK_LEN] for i in range(0, max(len(chunk), 1), BLOCK_LEN)]
    cv = list(IV)
    for i, block in enumerate(blocks):
        flags = 0
        if i == 0:
            flags |= CHUNK_START
        if i == len(blocks) - 1:
            flags |= CHUNK_END
            if is_root:
                flags |= ROOT
        cv = compress(cv, _block_words(block), chunk_counter, len(block), flags)[:8]
    return cv


def _parent_cv(left: list[int], right: list[int], is_root: bool) -> list[int]:
    flags = PARENT | (ROOT if is_root else 0)
    return compress(list(IV), left + right, 0, BLOCK_LEN, flags)[:8]


def _tree_cv(chunks: list[bytes], first_counter: int, is_root: bool) -> list[int]:
    if len(chunks) == 1:
        return _chunk_cv(chunks[0], first_counter, is_root)
    # left subtree gets the largest power of two strictly less than len
    split = 1 << (len(chunks) - 1).bit_length() - 1
    left = _tree_cv(chunks[:split], first_counter, False)
    right = _tree_cv(chunks[split:], first_counter + split, False)
    return _parent_cv(left, right, is_root)


def blake3_py(data: bytes) -> bytes:
    """32-byte BLAKE3 hash (unkeyed) — pure-Python reference path."""
    chunks = [data[i : i + CHUNK_LEN] for i in range(0, max(len(data), 1), CHUNK_LEN)]
    cv = _tree_cv(chunks, 0, True)
    return struct.pack("<8I", *cv)


def _pick_impl():
    from ..native import get_lib

    lib = get_lib()
    if lib is None:
        return blake3_py
    import ctypes

    def blake3_native(data: bytes) -> bytes:
        out = (ctypes.c_uint8 * 32)()
        lib.zn_blake3(data, len(data), out)
        return bytes(out)

    return blake3_native


blake3 = _pick_impl()


def blake3_parent(left: bytes, right: bytes) -> bytes:
    """blake3(left ‖ right) for two 32-byte digests — the Merkle merge.

    This equals the generic hash of the 64-byte concatenation (single chunk,
    single block), NOT the internal parent-node function; the reference
    merges with a plain hasher (utils.rs:106-114)."""
    return blake3(left + right)
