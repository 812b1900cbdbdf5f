"""Host big-integer helpers: the BigInt wire form and NAF recoding.

The port's copy of the four host helpers of ``zinc_tpu/fields/limbs.py``
(``bigint_serialize``, ``bigint_deserialize``, ``find_naf``,
``find_relaxed_naf``).  The rest of that module is the TPU's layout of 16-bit
limbs in uint32 lanes and its carry algebra, which the port does not use: its
device numbers are 32-bit words (``fields/montgomery.py``).
"""

from __future__ import annotations


def bigint_serialize(value: int, n64: int) -> bytes:
    """Canonical BigInt wire form: n64 u64 words, little-endian per word,
    word 0 first — the mirror of the reference's CanonicalSerialize for
    BigInt<N> (zinc/src/field/biginteger.rs:67-79, which defers to
    `[u64; N]`: consecutive LE u64s).  `value` must be a non-negative
    canonical representative < 2^(64·n64)."""
    if value < 0 or value >> (64 * n64):
        raise ValueError(f"value does not fit in {n64} u64 limbs")
    return value.to_bytes(8 * n64, "little")


def bigint_deserialize(data: bytes, n64: int) -> int:
    """Inverse of :func:`bigint_serialize`
    (zinc/src/field/biginteger.rs:86-97)."""
    if len(data) != 8 * n64:
        raise ValueError(f"expected {8 * n64} bytes, got {len(data)}")
    return int.from_bytes(data, "little")


def find_naf(num: int) -> list[int]:
    """Non-adjacent form of a nonnegative integer, little-endian digits in
    {-1, 0, 1} (mirror of zinc/src/field/biginteger/arithmetic.rs:146-199)."""
    if num < 0:
        raise ValueError("NAF input must be nonnegative")
    res: list[int] = []
    while num != 0:
        if num & 1:
            z = 2 - (num % 4)
            num -= z
        else:
            z = 0
        res.append(z)
        num >>= 1
    return res


def find_relaxed_naf(num: int) -> list[int]:
    """NAF with the top-of-sequence `0 -1 0 1` → `0 1 1` rewrite that saves
    one doubling (zinc/src/field/biginteger/arithmetic.rs:201-229)."""
    res = find_naf(num)
    if len(res) >= 3 and res[-2] == 0 and res[-3] == -1:
        res[-3] = 1
        res[-2] = 1
        res.pop()
    return res
