"""Batched BLAKE3 Merkle trees: the CUDA kernels and their plain versions.

The port of ``zinc_tpu/ops/blake3_kernel.py`` (XLA code in the reference,
not Pallas).  Every node is one BLAKE3 compression over a 64-byte block:
a leaf hashes one codeword element's 8·k_words-byte serialization, a merge
hashes two 32-byte child digests.  Digests are int64 tensors of u32 words,
8 a node (the digest bytes are the words in little-endian order).

On a CUDA tensor the tree is ``csrc/blake3.cu``, one thread a compression,
built once as its own library (it takes no field): :func:`hash_leaves`
hashes the leaves and merges up to ``LEAF_LEVELS`` levels in one launch
(past the kernel's block of 2^``LOG_BLOCK`` threads, across a thread-block
cluster of up to 2^``LOG_CLUSTER`` blocks), :func:`merge_levels` up to
``MERGE_LEVELS`` a launch: a row of up to 2^11 codewords (the 2^20
commit's) takes one launch, of up to 2^20 two (:func:`tree_plan`).  The
build passes ``LOG_BLOCK`` and ``LOG_CLUSTER`` to the source.  The plain versions
(:func:`compress_batch` over a level at a time, lanes masked to 32 bits
after each add and rotate, since torch's CPU uint32 has no add) serve CPU
tensors and the tests, and are what ``chip_smoke.py`` holds the kernels
against on the card.

Wrapper rule: a CPU tensor goes to the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..hashing.blake3 import CHUNK_END, CHUNK_START, IV, MSG_PERMUTATION, ROOT
from . import _cuda

M32 = 0xFFFFFFFF
FLAGS = CHUNK_START | CHUNK_END | ROOT  # every node is one single-block chunk
LOG_BLOCK = 8  # a kernel block is 2^LOG_BLOCK threads (csrc/blake3.cu's ZT_B3_LOG_BLOCK)
LOG_CLUSTER = 3  # a leaves launch's cluster is up to 2^LOG_CLUSTER blocks (ZT_B3_LOG_CLUSTER)
# merges a leaves launch makes: its blocks' subtrees, then their clusters'
LEAF_LEVELS = LOG_BLOCK + LOG_CLUSTER
MERGE_LEVELS = LOG_BLOCK + 1  # merges a merge launch makes in its blocks of 2^(LOG_BLOCK+1) nodes


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
    sw = _bswap32(words).reshape(b, n // 2, 2).flip(-1).reshape(b, n)
    return torch.cat([sw, sw.new_zeros((b, 16 - n))], dim=1)


def _depth(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what}: {n} nodes a row is not a power of two")
    return n.bit_length() - 1


def _split(buf: torch.Tensor, rows: int, sizes: list[int]) -> list[torch.Tensor]:
    """Views of the levels laid one after the other in ``buf``."""
    out, off = [], 0
    for n in sizes:
        out.append(buf[off : off + rows * n * 8].view(rows, n, 8))
        off += rows * n * 8
    return out


def hash_leaves_plain(enc: torch.Tensor, k_words: int, levels: int) -> list[torch.Tensor]:
    """The plain PyTorch version of :func:`hash_leaves` (any device)."""
    r, n, w = enc.shape
    msg = leaf_msg_words(enc.reshape(r * n, w).to(torch.int64) & M32)
    leaves = compress_batch(msg, 8 * k_words, FLAGS).reshape(r, n, 8)
    return [leaves] + merge_levels_plain(leaves, levels)


def hash_leaves(enc: torch.Tensor, k_words: int, levels: int) -> list[torch.Tensor]:
    """The leaves of every row and the ``levels`` levels above them.

    enc: (R, N, 2·k_words) canonical u32 words (int32 or int64 lanes) of the
    codeword elements, N a power of two, 1 ≤ k_words ≤ 8 (a leaf fits one
    block), levels ≤ min(LEAF_LEVELS, log2 N).  Returns [leaves (R, N, 8),
    (R, N/2, 8), ..., (R, N >> levels, 8)] int64 digest words."""
    if enc.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"hash_leaves: expected int32 or int64 words, got {enc.dtype}")
    if enc.dim() != 3 or not 1 <= k_words <= 8 or enc.shape[2] != 2 * k_words:
        raise ValueError(f"hash_leaves: expected (R, N, {2 * k_words}) words of 1-8 u64 words, "
                         f"got {tuple(enc.shape)}")
    r, n, w = enc.shape
    if not 0 <= levels <= min(LEAF_LEVELS, _depth(n, "hash_leaves")):
        raise ValueError(f"hash_leaves: {levels} levels above {n} leaves a row")
    if not enc.is_cuda:
        return hash_leaves_plain(enc, k_words, levels)
    enc = enc.contiguous()
    sizes = [n >> lvl for lvl in range(levels + 1)]
    buf = torch.empty(r * sum(sizes) * 8, dtype=torch.int64, device=enc.device)
    with _cuda.on_device(enc):
        rc = _cuda.blake3_lib().zt_blake3_leaves(
            buf.data_ptr(), enc.data_ptr(), r * n, w, enc.element_size() // 4, levels,
            _cuda.stream_ptr(enc.device),
        )
    _cuda.check(rc, "blake3_leaves")
    _cuda.LAUNCHES["blake3_leaves"] += 1
    return _split(buf, r, sizes)


def merge_levels_plain(level: torch.Tensor, count: int) -> list[torch.Tensor]:
    """The plain PyTorch version of :func:`merge_levels` (any device)."""
    out = []
    for _ in range(count):
        level = compress_batch(level.reshape(-1, 16), 64, FLAGS).reshape(level.shape[0], -1, 8)
        out.append(level)
    return out


def merge_levels(level: torch.Tensor, count: int) -> list[torch.Tensor]:
    """The ``count`` Merkle levels above ``level`` (R, N, 8) int64 digest
    words, N a power of two, 1 ≤ count ≤ min(MERGE_LEVELS, log2 N):
    [(R, N/2, 8), ..., (R, N >> count, 8)], node i the hash of children
    2i ‖ 2i+1."""
    if level.dtype != torch.int64:
        raise TypeError(f"merge_levels: expected int64 digest words, got {level.dtype}")
    if level.dim() != 3 or level.shape[2] != 8:
        raise ValueError(f"merge_levels: expected (R, N, 8) digests, got {tuple(level.shape)}")
    r, n, _ = level.shape
    if not 1 <= count <= min(MERGE_LEVELS, _depth(n, "merge_levels")):
        raise ValueError(f"merge_levels: {count} levels above {n} nodes a row")
    if not level.is_cuda:
        return merge_levels_plain(level, count)
    level = level.contiguous()
    sizes = [n >> lvl for lvl in range(1, count + 1)]
    buf = torch.empty(r * sum(sizes) * 8, dtype=torch.int64, device=level.device)
    with _cuda.on_device(level):
        rc = _cuda.blake3_lib().zt_blake3_merge(buf.data_ptr(), level.data_ptr(), r * n, count,
                                             _cuda.stream_ptr(level.device))
    _cuda.check(rc, "blake3_merge")
    _cuda.LAUNCHES["blake3_merge"] += 1
    return _split(buf, r, sizes)


def merge_plan(levels: int) -> list[int]:
    """The levels of each merge launch that merges ``levels`` levels: as
    many as a launch takes, the rest in the last."""
    return [min(MERGE_LEVELS, levels - i) for i in range(0, levels, MERGE_LEVELS)]


def tree_plan(n: int) -> tuple[int, list[int]]:
    """The launches of a tree of rows of ``n`` leaves: (the levels the leaves
    launch merges, [the levels of each merge launch after it])."""
    depth = _depth(n, "tree_plan")
    leaf = min(LEAF_LEVELS, depth)
    return leaf, merge_plan(depth - leaf)


def merkle_tree_device(enc: torch.Tensor, k_words: int) -> list[torch.Tensor]:
    """Full Merkle layers for every row at once.

    enc: (R, N, 2·k_words) canonical u32 words (int32 or int64) of the
    codeword elements, N a power of two.  Returns [leaves (R, N, 8),
    (R, N/2, 8), ..., root (R, 1, 8)] int64 digest words."""
    leaf, merges = tree_plan(enc.shape[1])
    layers = hash_leaves(enc, k_words, leaf)
    for count in merges:
        layers += merge_levels(layers[-1], count)
    return layers


def max_active_clusters(log_cluster: int, device="cuda") -> int:
    """How many clusters of 2^log_cluster leaves-kernel blocks the card holds
    at once (``cudaOccupancyMaxActiveClusters``, 1 ≤ log_cluster ≤ 4)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        rc = _cuda.blake3_lib().zt_blake3_max_clusters(log_cluster, ctypes.byref(out))
    _cuda.check(rc, "blake3_max_clusters")
    return out.value
