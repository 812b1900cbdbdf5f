"""Vector helpers for CCS relations.

Mirror of zinc/src/ccs/utils.rs:14-73 (vec_add, vec_scalar_mul,
hadamard, mat_vec_mul).  Generic over host element types: works for Python
ints (the ℤ flavor) and Fp (the field flavor) — both define +, *.

The port's copy of ``zinc_tpu/ccs/utils.py``.
"""

from __future__ import annotations

from ..sparse import SparseMatrix, mat_vec_mul  # re-export (utils.rs:48-73)

__all__ = ["vec_add", "vec_scalar_mul", "hadamard", "mat_vec_mul", "SparseMatrix"]


def vec_add(a: list, b: list) -> list:
    """Elementwise a + b (reference src/ccs/utils.rs:14-24)."""
    if len(a) != len(b):
        raise ValueError(f"vector length mismatch: {len(a)} vs {len(b)}")
    return [x + y for x, y in zip(a, b)]


def vec_scalar_mul(v: list, c) -> list:
    """Elementwise c · v (reference src/ccs/utils.rs:26-32)."""
    return [x * c for x in v]


def hadamard(a: list, b: list) -> list:
    """Elementwise a ∘ b (reference src/ccs/utils.rs:34-46)."""
    if len(a) != len(b):
        raise ValueError(f"vector length mismatch: {len(a)} vs {len(b)}")
    return [x * y for x, y in zip(a, b)]
