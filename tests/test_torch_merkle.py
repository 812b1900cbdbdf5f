"""The port's BLAKE3 Merkle trees (``zinc_tpu_torch/ops/blake3.py``) against
the JAX package's ``zinc_tpu/ops/blake3_kernel.py`` on the CPU, compared as
the digest bytes of every layer: every leaf length from 8 to 64 bytes,
words with the sign bit set in int32 and int64 lanes, rows that span a
cluster of blocks, and a row deep enough that the tree takes a leaves
launch and a merge launch on the card (split as ``tree_plan`` plans it).
The wrappers' refusals and their CPU rule (the plain version, no build, no
launch) are held here too; the kernels themselves are held against these
plain versions on the card in ``tests/test_torch_kernels.py``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zinc_tpu.ops.blake3_kernel import merge_pairs_batch as j_merge_pairs
from zinc_tpu.ops.blake3_kernel import merkle_tree_device as j_merkle_tree
from zinc_tpu_torch.ops import _cuda
from zinc_tpu_torch.ops import blake3 as b3

# (rows, codewords a row, k_words): k_words 1, 2, 4 and 8 give 8-, 16-, 32-
# and 64-byte leaves; 1024 codewords span a cluster of 4 blocks on the card
SHAPES = [(1, 2, 1), (3, 64, 1), (2, 8, 2), (3, 32, 4), (1, 64, 4), (2, 16, 8), (1, 1024, 1)]


def _words(rows: int, n: int, k_words: int, seed: int) -> np.ndarray:
    """(rows, n, 2·k_words) uniform u32 words, with the extremes mixed in."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(rows, n, 2 * k_words), dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    flat[:: 7] = 0xFFFFFFFF  # −1 in an int32 lane
    flat[3 :: 11] = 0x80000000
    flat[5 :: 13] = 0
    return w


def _limbs16(words: np.ndarray) -> np.ndarray:
    """u32 words → the JAX kernel's 16-bit two's-complement limbs, low first."""
    limbs = np.stack([words & 0xFFFF, words >> 16], axis=-1)
    return limbs.reshape(words.shape[:-1] + (2 * words.shape[-1],)).astype(np.uint32)


def _bytes(layer) -> bytes:
    return np.asarray(layer).astype("<u4").tobytes()


@functools.lru_cache(maxsize=None)
def _jax_layers(rows: int, n: int, k_words: int, seed: int) -> tuple[bytes, ...]:
    layers = j_merkle_tree(jnp.asarray(_limbs16(_words(rows, n, k_words, seed))), k_words)
    return tuple(_bytes(x) for x in layers)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("rows,n,k_words", SHAPES)
def test_merkle_layers_match_jax(rows, n, k_words, dtype):
    words = _words(rows, n, k_words, seed=rows * 1000 + n + k_words)
    lanes = words.view(np.int32) if dtype == torch.int32 else words.astype(np.int64)
    layers = b3.merkle_tree_device(torch.from_numpy(lanes), k_words)
    want = _jax_layers(rows, n, k_words, rows * 1000 + n + k_words)
    assert [tuple(x.shape) for x in layers] == [(rows, n >> i, 8) for i in range(len(want))]
    assert all(x.dtype == torch.int64 for x in layers)
    assert [_bytes(x.numpy()) for x in layers] == list(want)


@pytest.mark.parametrize("rows,n,count", [(1, 2, 1), (3, 8, 1), (2, 16, 3), (1, 512, 9)])
def test_merge_levels_match_merge_pairs(rows, n, count):
    rng = np.random.default_rng(rows + n + count)
    digests = rng.integers(0, 1 << 32, size=(rows, n, 8), dtype=np.uint64).astype(np.uint32)
    got = b3.merge_levels(torch.from_numpy(digests.astype(np.int64)), count)
    level = jnp.asarray(digests)
    for i in range(count):
        level = j_merge_pairs(level.reshape(-1, 2, 8)).reshape(rows, -1, 8)
        assert _bytes(got[i].numpy()) == _bytes(level)
    one = b3.merge_levels(torch.from_numpy(digests.astype(np.int64)), 1)[0]
    assert torch.equal(one, got[0])


@pytest.mark.parametrize("log_n", range(21))
def test_tree_plan_covers_the_row_in_launches_the_kernels_take(log_n):
    """The plan's levels sum to the row's depth; the leaves launch takes
    every level up to LEAF_LEVELS = LOG_BLOCK + LOG_CLUSTER and each merge
    launch at most MERGE_LEVELS, every launch but the last a full one."""
    leaf, merges = b3.tree_plan(1 << log_n)
    assert leaf + sum(merges) == log_n
    assert leaf == min(log_n, b3.LOG_BLOCK + b3.LOG_CLUSTER) == min(log_n, b3.LEAF_LEVELS)
    assert all(1 <= m <= b3.MERGE_LEVELS for m in merges)
    assert all(m == b3.MERGE_LEVELS for m in merges[:-1])
    assert len(merges) == -(-(log_n - leaf) // b3.MERGE_LEVELS)
    full, rest = divmod(log_n, b3.MERGE_LEVELS)
    assert b3.merge_plan(log_n) == [b3.MERGE_LEVELS] * full + [rest] * (rest > 0)


def test_plan_split_at_2p12_matches_jax():
    """A row of 2^12 leaves (k_words 1) is deeper than a cluster: the plain
    leaves layer and levels the leaves launch takes, then the plain merge of
    the levels left, equal the JAX package's merkle_tree_device byte for
    byte."""
    n, seed = 1 << 12, 4096
    words = torch.from_numpy(_words(1, n, 1, seed).view(np.int32))
    leaf, merges = b3.tree_plan(n)
    assert (leaf, merges) == (b3.LEAF_LEVELS, [12 - b3.LEAF_LEVELS])
    layers = b3.hash_leaves_plain(words, 1, leaf)
    for count in merges:
        layers += b3.merge_levels_plain(layers[-1], count)
    assert [_bytes(x.numpy()) for x in layers] == list(_jax_layers(1, n, 1, seed))


@pytest.mark.parametrize("log_n,columns,merges", [
    (20, 1, 0),  # the 2^20 commit: rows of 2^11 codewords, one cluster each
    (20, 2, 1),  # two column blocks: their roots merged in one launch
    (20, 4, 1),
    (24, 1, 1),  # rows of 2^13 codewords: a cluster and a merge launch
    (10, 1, 0),
])
def test_chip_smoke_counts_merge_launches_from_the_plan(log_n, columns, merges):
    """chip_smoke.py's launch checks read tree_plan: a commit whose rows a
    cluster covers must launch no blake3_merge, and one that merges must."""
    import chip_smoke

    assert chip_smoke.commit_merges(log_n, columns) == merges
    must, must_not = chip_smoke.tree_kernels(("blake3_leaves",), (), log_n, columns)
    assert ("blake3_merge" in must, "blake3_merge" in must_not) == (merges > 0, merges == 0)


def test_the_split_into_launches_is_the_plain_tree():
    """merkle_tree_device's leaves launch and merge launches give the layers
    of one leaves call with no merges followed by one merge at a time."""
    words = torch.from_numpy(_words(2, 1 << 10, 2, 9).view(np.int32))
    layers = b3.merkle_tree_device(words, 2)
    want = b3.hash_leaves_plain(words, 2, 0)
    while want[-1].shape[1] > 1:
        want += b3.merge_levels_plain(want[-1], 1)
    assert len(layers) == 11 and all(torch.equal(a, b) for a, b in zip(layers, want))


def test_cpu_tensors_take_the_plain_versions():
    words = torch.from_numpy(_words(2, 256, 4, 10).view(np.int32))
    _cuda.reset_launches()
    layers = b3.merkle_tree_device(words, 4)
    assert all(torch.equal(a, b) for a, b in zip(layers, b3.hash_leaves_plain(words, 4, 8)))
    assert torch.equal(b3.merge_levels(layers[0], 1)[0], layers[1])
    assert all(v == 0 for v in _cuda.LAUNCHES.values())
    assert _cuda._libs == {}  # nothing was built for CPU tensors


def test_blake3_library_is_built_with_the_wrappers_block():
    """csrc/blake3.cu is its own library (with csrc/zip_records.cu, which
    takes no field either), built with the block the wrappers plan their
    launches with; no field width's library compiles them."""
    assert _cuda._sources(_cuda.BLAKE3) == ("blake3.cu", "zip_records.cu")
    assert all(src not in _cuda._sources(n) for n in _cuda.KERNEL_WORDS
               for src in _cuda._sources(_cuda.BLAKE3))
    assert _cuda._defines(_cuda.BLAKE3) == [f"-DZT_B3_LOG_BLOCK={b3.LOG_BLOCK}",
                                            f"-DZT_B3_LOG_CLUSTER={b3.LOG_CLUSTER}"]
    assert (b3.LEAF_LEVELS, b3.MERGE_LEVELS) == (b3.LOG_BLOCK + b3.LOG_CLUSTER, b3.LOG_BLOCK + 1)
    assert 1 << b3.LOG_CLUSTER <= 8  # a portable cluster
    assert _cuda._lib_path(_cuda.BLAKE3) != _cuda._lib_path(8)
    assert _cuda._libs == {}  # naming a library builds nothing


def test_wrappers_reject_bad_inputs():
    words = torch.zeros((2, 8, 4), dtype=torch.int32)
    level = torch.zeros((2, 8, 8), dtype=torch.int64)
    with pytest.raises(TypeError):
        b3.hash_leaves(words.to(torch.float64), 2, 0)
    with pytest.raises(ValueError):
        b3.hash_leaves(words, 1, 0)  # 4 words are k_words = 2
    with pytest.raises(ValueError):
        b3.hash_leaves(torch.zeros((2, 8, 18), dtype=torch.int32), 9, 0)  # over one block
    with pytest.raises(ValueError):
        b3.hash_leaves(torch.zeros((2, 6, 4), dtype=torch.int32), 2, 0)  # 6 leaves a row
    with pytest.raises(ValueError):
        b3.hash_leaves(words, 2, 4)  # 8 leaves have 3 levels above them
    with pytest.raises(ValueError):
        b3.hash_leaves(torch.zeros((1, 4096, 4), dtype=torch.int32), 2, 12)  # over LEAF_LEVELS
    with pytest.raises(TypeError):
        b3.merge_levels(level.to(torch.int32), 1)
    with pytest.raises(ValueError):
        b3.merge_levels(level[:, :, :4], 1)
    with pytest.raises(ValueError):
        b3.merge_levels(level, 4)
    with pytest.raises(ValueError):
        b3.merge_levels(level, 0)
    with pytest.raises(ValueError):
        b3.merge_levels(torch.zeros((1, 2048, 8), dtype=torch.int64), 10)  # over MERGE_LEVELS
