"""The RAA code of the Zip commitment: codeword = accumulate(σ₂(accumulate(
σ₁(row ‖ row)))), with σ₁, σ₂ the permutations that rand 0.9's
``StdRng::seed_from_u64(seed)`` and ``slice.shuffle`` give (ChaCha12 seeded
by SplitMix64, the ``IncreasingUniform`` index schedule).  A frozen copy of
that derivation; the encoder works on whole matrices of rows at once.
"""

from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def _splitmix64_seed(state: int) -> list[int]:
    words = []
    while len(words) < 8:
        state = (state + 0x9E3779B97F4A7C15) & _M64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        words.append((z ^ (z >> 31)) & _M32)
    return words


def _chacha12_block(key: list[int], counter: int) -> list[int]:
    st = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574] + key + [
        counter & _M32, counter >> 32, 0, 0]
    x = list(st)

    def qr(a, b, c, d):
        for s1, s2 in ((16, 12), (8, 7)):
            x[a] = (x[a] + x[b]) & _M32
            x[d] ^= x[a]
            x[d] = ((x[d] << s1) | (x[d] >> (32 - s1))) & _M32
            x[c] = (x[c] + x[d]) & _M32
            x[b] ^= x[c]
            x[b] = ((x[b] << s2) | (x[b] >> (32 - s2))) & _M32

    for _ in range(6):
        qr(0, 4, 8, 12), qr(1, 5, 9, 13), qr(2, 6, 10, 14), qr(3, 7, 11, 15)
        qr(0, 5, 10, 15), qr(1, 6, 11, 12), qr(2, 7, 8, 13), qr(3, 4, 9, 14)
    return [(x[i] + st[i]) & _M32 for i in range(16)]


class _StdRng:
    def __init__(self, seed: int):
        self.key = _splitmix64_seed(seed & _M64)
        self.counter = 0
        self.buf: list[int] = []

    def next_u32(self) -> int:
        if not self.buf:
            self.buf = _chacha12_block(self.key, self.counter)
            self.counter += 1
        return self.buf.pop(0)

    def below(self, n: int) -> int:
        """Uniform in [0, n): Canon's method with Lemire's early out."""
        m = self.next_u32() * n
        result, lo = m >> 32, m & _M32
        if lo > ((1 << 32) - n) & _M32:
            if lo + ((self.next_u32() * n) >> 32) > _M32:
                result += 1
        return result


def permutation(seed: int, length: int) -> np.ndarray:
    """σ with shuffled[k] = input[σ(k)]: rand's forward Durstenfeld walk,
    indices drawn in chunks of the longest run of bounds whose product fits
    in 32 bits."""
    rng = _StdRng(seed)
    arr = np.arange(length, dtype=np.int64)
    chunk, left = 0, 1
    for i in range(length):
        bound = i + 1
        if left == 0:
            product, k = bound, bound + 1
            while product * k < (1 << 32):
                product *= k
                k += 1
            chunk, left = rng.below(product), k - bound - 1
        else:
            left -= 1
        j = chunk % bound
        chunk //= bound
        arr[i], arr[j] = arr[j], arr[i]
    return arr


def encode_rows(rows: np.ndarray, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Codewords (object ints, exact) of an (R, L) integer matrix at rate 1/2."""
    vec = np.concatenate([rows, rows], axis=1).astype(object)
    acc = np.cumsum(vec[:, p1], axis=1)
    return np.cumsum(acc[:, p2], axis=1)


def words_of(values: np.ndarray, nwords: int) -> np.ndarray:
    """Exact integers below 2^127 in magnitude as ``nwords`` little-endian
    two's-complement 64-bit words (..., nwords) uint64."""
    lo = (values & _M64).astype(np.uint64)
    hi = (values >> 64).astype(np.int64)
    out = np.empty(values.shape + (nwords,), np.uint64)
    out[..., 0] = lo
    out[..., 1] = hi.view(np.uint64)
    out[..., 2:] = np.where(hi < 0, np.uint64(_M64), np.uint64(0))[..., None]
    return out
