"""Multilinear tables over Z_q as numpy arrays of Python ints.

Index bits are little-endian: entry i of a table over n variables is its
value at (bit_0(i), ..., bit_{n-1}(i)), and the first variable pairs
entries (2b, 2b + 1).
"""

from __future__ import annotations

import functools

import numpy as np


def as_ints(values, q: int) -> np.ndarray:
    """Any integers (int64 array, list) as an object array of residues mod q."""
    return np.asarray(values).astype(object) % q


def eq_table(r: list[int], q: int) -> np.ndarray:
    """eq(x, r) for every x: entry i = Π_j (bit_j(i) ? r_j : 1 − r_j)."""
    buf = np.array([(1 - r[-1]) % q, r[-1] % q], dtype=object)
    for rj in reversed(r[:-1]):
        t = buf * rj % q
        nxt = np.empty(2 * len(buf), dtype=object)
        nxt[0::2] = (buf - t) % q
        nxt[1::2] = t
        buf = nxt
    return buf


def dot(a: np.ndarray, b: np.ndarray, q: int) -> int:
    return int((a * b).sum()) % q


def eq_eval(x: list[int], y: list[int], q: int) -> int:
    out = 1
    for a, b in zip(x, y):
        out = out * (2 * a * b - a - b + 1) % q
    return out


def interpolate(evals: list[int], x: int, q: int) -> int:
    """The polynomial of degree len(evals) − 1 through (i, evals[i]), at x."""
    n = len(evals)
    if x < n:
        return evals[x] % q
    w = _lagrange_weights(n, q)
    left = [1] * n  # Π_{j<i} (x − j)
    for i in range(1, n):
        left[i] = left[i - 1] * (x - i + 1) % q
    out, right = 0, 1  # Π_{j>i} (x − j)
    for i in reversed(range(n)):
        out += evals[i] * w[i] % q * left[i] % q * right
        right = right * (x - i) % q
    return out % q


@functools.lru_cache(maxsize=8)
def _lagrange_weights(n: int, q: int) -> list[int]:
    """1 / Π_{j≠i} (i − j) mod q, for i < n."""
    out = []
    for i in range(n):
        den = 1
        for j in range(n):
            if j != i:
                den = den * (i - j) % q
        out.append(pow(den, -1, q))
    return out
