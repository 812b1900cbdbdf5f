"""BLAKE3 Merkle trees over codeword rows (host backend).

Layout mirrors zinc/src/zip/pcs/utils.rs:66-211: a flat layer
array ``[leaf hashes (2^depth) | level (2^(depth-1)) | ... | 2 | ]`` with the
root kept separately; sibling-path proofs walk ``(leaf >> k) ^ 1``.

Leaves are hashed from the integer serialization ``to_bytes`` of the
reference (little-endian word order, big-endian bytes within each 64-bit
word — zinc/src/field/int.rs:201-210); level merges hash the
64-byte concatenation of the child digests.

The batched device implementation (ops/blake3.py + zip/device.py)
produces bit-identical trees; this host version is its oracle and the
fallback for tiny sizes.
"""

from __future__ import annotations

from ..hashing.blake3 import blake3

_ZERO32 = b"\x00" * 32


def int_to_leaf_bytes(value: int, nwords: int) -> bytes:
    """Two's-complement serialization: LE word order, BE bytes per word."""
    u = value & ((1 << (64 * nwords)) - 1)
    return b"".join(((u >> (64 * i)) & ((1 << 64) - 1)).to_bytes(8, "big") for i in range(nwords))


class MerkleTree:
    __slots__ = ("root", "depth", "layers")

    def __init__(self, root: bytes, depth: int, layers: list[bytes]):
        self.root = root
        self.depth = depth
        self.layers = layers

    @staticmethod
    def from_leaves(depth: int, leaf_bytes: list[bytes]) -> "MerkleTree":
        assert len(leaf_bytes) == 1 << depth
        n = 1 << depth
        layers: list[bytes] | None = None
        if n >= 16 and len({len(b) for b in leaf_bytes}) == 1:
            # batched native tier (16-lane vectorized BLAKE3)
            from ..native import blake3_batch, blake3_merge_batch

            hashed = blake3_batch(b"".join(leaf_bytes), n, len(leaf_bytes[0]))
            if hashed is not None:
                layers = [hashed[32 * i : 32 * (i + 1)] for i in range(n)]
                level_cat = hashed
                width = n
                while width > 1:
                    level_cat = blake3_merge_batch(level_cat, width // 2)
                    width //= 2
                    layers.extend(
                        level_cat[32 * i : 32 * (i + 1)] for i in range(width)
                    )
        if layers is None:  # pure-Python fallback
            layers = [blake3(b) for b in leaf_bytes]
            offset = 0
            width = n
            while width > 1:
                level = layers[offset : offset + width]
                layers.extend(
                    blake3(level[2 * i] + level[2 * i + 1]) for i in range(width // 2)
                )
                offset += width
                width //= 2
        root = layers.pop()
        return MerkleTree(root, depth, layers)

    def path(self, leaf: int) -> list[bytes]:
        """Sibling hashes bottom-up for the given leaf index."""
        out = []
        offset = 0
        idx = leaf
        for d in range(self.depth, 0, -1):
            width = 1 << d
            out.append(self.layers[offset + (idx ^ 1)])
            offset += width
            idx >>= 1
        return out


def verify_merkle_path(root: bytes, leaf_bytes: bytes, leaf_index: int, path: list[bytes]) -> bool:
    current = blake3(leaf_bytes)
    idx = leaf_index
    for sibling in path:
        if idx & 1 == 0:
            current = blake3(current + sibling)
        else:
            current = blake3(sibling + current)
        idx >>= 1
    return current == root
