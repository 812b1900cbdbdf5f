"""Seeded deterministic permutations for the RAA code — rand 0.9 compatible.

The reference derives its two RAA permutations with
``StdRng::seed_from_u64(seed)`` + ``slice.shuffle`` (``shuffle_seeded``,
zinc/src/zip/utils.rs:139-142; Cargo.toml pins ``rand = "0.9.2"``).
``StdRng`` is ChaCha12 seeded via SplitMix64; both are reproduced here
exactly.  The draw *schedule* reproduces rand 0.9's ``shuffle`` →
``partial_shuffle`` chain bit-for-bit:

- ``partial_shuffle(rng, len)`` (rand ``src/seq/slice.rs``) iterates
  *forward* ``i ∈ m..len`` (full shuffle: ``m = 0``) swapping ``i`` with a
  uniform index in ``0..=i`` — a growing-region Durstenfeld walk.
- The indices come from ``IncreasingUniform`` (rand
  ``src/seq/increasing_uniform.rs``): one ``u32`` draw in
  ``[0, b·(b+1)·…·(b+r-1))`` — the maximal run of consecutive factors
  starting at the current bound ``b`` whose product fits in ``u32`` — is
  split into ``r`` successive indices by mod/div against the increasing
  bounds.  Construction with ``n = 0`` sets ``chunk_remaining = 1`` so the
  first index is 0 without consuming the stream.
- Each chunk is drawn with ``Rng::random_range(..bound)`` →
  ``UniformInt::<u32>::sample_single_inclusive(0, bound-1)`` (rand
  ``src/distr/uniform_int.rs``, default features): Canon's method with a
  Lemire-style early-out — one widening multiply ``v·range``; if the low
  word exceeds ``range.wrapping_neg()`` a *second* ``u32`` is drawn and its
  widened high word is added as a carry-correction.  Unbiased to 2^-32 and,
  crucially, a deterministic word-consumption schedule.

The full derivation (with a worked trace) is in docs/RAND_PARITY.md; vectors
are pinned in tests/test_zip_pcs.py.  The permutation is a deterministic pure
function of the 64-bit transcript seed, shared by prover and verifier.
"""

from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def splitmix64_seed(state: int, nbytes: int = 32) -> bytes:
    """rand_core's ``seed_from_u64``: fill the seed 4 bytes at a time with the
    low half of successive SplitMix64 outputs."""
    out = bytearray()
    while len(out) < nbytes:
        state = (state + 0x9E3779B97F4A7C15) & _M64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        z = z ^ (z >> 31)
        out += (z & _M32).to_bytes(4, "little")
    return bytes(out[:nbytes])


def chacha_block_words(key: list[int], counter: int, rounds: int) -> list[int]:
    """One ChaCha block, djb layout (64-bit counter, zero 64-bit nonce), as
    16 output u32 words.  ``rounds`` is parametric so the SAME core can be
    externally cross-validated at 20 rounds against OpenSSL's ChaCha20 (for
    a zero nonce and counter < 2^32 the djb and RFC-7539 state layouts
    coincide) — see tests/test_rng_external.py; StdRng uses 12."""
    c = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]
    st = c + list(key) + [counter & _M32, (counter >> 32) & _M32, 0, 0]
    x = list(st)

    def qr(a, b, cc, d):
        x[a] = (x[a] + x[b]) & _M32
        x[d] ^= x[a]
        x[d] = ((x[d] << 16) | (x[d] >> 16)) & _M32
        x[cc] = (x[cc] + x[d]) & _M32
        x[b] ^= x[cc]
        x[b] = ((x[b] << 12) | (x[b] >> 20)) & _M32
        x[a] = (x[a] + x[b]) & _M32
        x[d] ^= x[a]
        x[d] = ((x[d] << 8) | (x[d] >> 24)) & _M32
        x[cc] = (x[cc] + x[d]) & _M32
        x[b] ^= x[cc]
        x[b] = ((x[b] << 7) | (x[b] >> 25)) & _M32

    assert rounds % 2 == 0
    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)

    return [(x[i] + st[i]) & _M32 for i in range(16)]


class ChaCha12:
    """ChaCha with 12 rounds, djb layout (64-bit counter, 64-bit nonce) —
    the core of rand's StdRng.  Emits the keystream as sequential u32 words."""

    def __init__(self, seed32: bytes):
        assert len(seed32) == 32
        self.key = [int.from_bytes(seed32[4 * i : 4 * i + 4], "little") for i in range(8)]
        self.counter = 0
        self.buf: list[int] = []

    @staticmethod
    def from_seed_u64(seed: int) -> "ChaCha12":
        return ChaCha12(splitmix64_seed(seed & _M64))

    def _block(self, counter: int) -> list[int]:
        return chacha_block_words(self.key, counter, 12)

    def next_u32(self) -> int:
        if not self.buf:
            self.buf = self._block(self.counter)
            self.counter += 1
        return self.buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def next_below(self, n: int) -> int:
        """Uniform in [0, n) — rand 0.9's ``sample_single_inclusive(0, n-1)``:
        Canon's method with Lemire early-out (``src/distr/uniform_int.rs``,
        default features).  One widening multiply; with probability
        ``(range-1)/2^32`` a second draw supplies a carry correction."""
        assert 0 < n <= _M32
        v = self.next_u32()
        m = v * n
        result, lo_order = m >> 32, m & _M32
        if lo_order > ((1 << 32) - n) & _M32:
            new_hi = (self.next_u32() * n) >> 32
            if lo_order + new_hi > _M32:
                result += 1
        return result


def _calculate_bound_u32(m: int) -> tuple[int, int]:
    """rand's ``calculate_bound_u32``: the longest run of consecutive factors
    ``m·(m+1)·…·(m+r-1)`` whose product fits in u32; returns (product, r)."""
    assert m > 0
    product, current = m, m + 1
    while product * current < (1 << 32):
        product *= current
        current += 1
    return product, current - m


def permutation_from_seed(seed: int, length: int) -> np.ndarray:
    """The seeded permutation σ with shuffled[k] = input[σ(k)], reproducing
    ``StdRng::seed_from_u64(seed)`` + rand 0.9.2 ``slice.shuffle`` exactly.

    Applying rand's swap sequence to the identity yields precisely the gather
    index array: after ``swap(i, j)`` steps, ``arr[k]`` is the origin of the
    element a reference shuffle would place at position ``k``.

    Schedule = ``partial_shuffle(rng, len)``: forward walk ``i ∈ 0..len``,
    ``swap(i, IncreasingUniform::next_index())`` (see module docstring)."""
    rng = ChaCha12.from_seed_u64(seed)
    arr = np.arange(length, dtype=np.int64)
    # IncreasingUniform::new(rng, m=0): n=0, chunk=0, chunk_remaining=1 (the
    # first index is always 0 and consumes nothing from the stream).
    n, chunk, chunk_remaining = 0, 0, 1
    for i in range(length):
        next_n = n + 1
        if chunk_remaining == 0:
            bound, remaining = _calculate_bound_u32(next_n)
            chunk = rng.next_below(bound)
            chunk_remaining = remaining - 1
        else:
            chunk_remaining -= 1
        j = chunk % next_n if next_n > 1 else 0
        chunk //= next_n
        n = next_n
        arr[i], arr[j] = arr[j], arr[i]
    return arr
