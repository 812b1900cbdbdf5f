"""Index helpers for batched/merged MLEs.

The port's copy of ``zinc_tpu/poly/util.py``, the mirror of
zinc/src/poly/util.rs:11-70.
"""

from __future__ import annotations

from ..fields.config import FieldConfig, Fp


def bit_decompose(value: int, num_var: int) -> list[bool]:
    """LE bit decomposition (reference src/poly/util.rs:11-20)."""
    return [bool((value >> i) & 1) for i in range(num_var)]


def project(bits: list[bool]) -> int:
    """Inverse of bit_decompose."""
    return sum(1 << i for i, b in enumerate(bits) if b)


def gen_eval_point(index: int, index_len: int, point: list[Fp], cfg: FieldConfig) -> list[Fp]:
    """point ‖ bits(index) as field elements (reference src/poly/util.rs:23-36)."""
    index_vec = [cfg.one() if b else cfg.zero() for b in bit_decompose(index, index_len)]
    return list(point) + index_vec


def get_batched_nv(num_var: int, polynomials_len: int) -> int:
    """Variables needed to batch `polynomials_len` MLEs of num_var vars
    (reference src/poly/util.rs:39-42, ark log2 = ceil)."""
    return num_var + _ceil_log2(polynomials_len)


def _ceil_log2(x: int) -> int:
    return 0 if x <= 1 else (x - 1).bit_length()


def get_index(i: int, num_vars: int) -> tuple[int, int, bool]:
    """For i = (i_0 … i_{n-1}) LE, return (x0, x1, sign) where
    x0 = (0, i_0 … i_{n-2}), x1 = (1, i_0 … i_{n-2}), sign = i_{n-1}
    (reference src/poly/util.rs:44-60)."""
    bits = bit_decompose(i, num_vars)
    x0 = project([False] + bits[: num_vars - 1])
    x1 = project([True] + bits[: num_vars - 1])
    return x0, x1, bits[num_vars - 1]
