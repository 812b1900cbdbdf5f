"""Sparse matrices over ℤ and over the random field.

Row-major list-of-rows representation matching the reference
(zinc/src/sparse_matrix.rs:12-17): ``rows[i]`` is a list of
``(value, col)`` pairs.  Padding is metadata-only (pad_rows/pad_cols).

Besides the reference operations (mat_vec_mul, compute_eval_table_sparse,
FieldMap projection) this adds ``evaluate_mle``: the O(nnz) sparse evaluation
of the matrix MLE at a split point — the verifier-side replacement for the
reference's dense ``from_matrix`` + ``evaluate`` (which materializes all
2^(s+s') entries, zinc/src/zinc/verifier.rs:249-261).
"""

from __future__ import annotations

from itertools import chain
from operator import itemgetter

from .fields.config import FieldConfig, Fp
from .poly.mle import build_eq_x_r_vec

# packings built (memo misses) by path: "flat" (int64 values) or "fallback"
# (the value list: wide ints, field elements)
PACKS = {"flat": 0, "fallback": 0}


class SparseMatrix:
    """Sparse matrix; values are ints (ℤ flavor) or Fp (field flavor)."""

    __slots__ = ("n_rows", "n_cols", "rows", "_packed")

    def __init__(self, n_rows: int, n_cols: int, rows: list):
        self.n_rows = n_rows
        self.n_cols = n_cols
        self.rows = rows  # list[list[(value, col)]]
        self._packed = None

    def packed_coo(self):
        """Memoized COO packing ``(rows i32, cols i32, vals)`` for device
        uploads and native mirrors, in row-major entry order.  Both the
        prover and the verifier re-upload the same statement matrices on
        every proof, so it is built once per matrix.  The pass is flat: the
        row indices repeat ``arange`` by the row lengths, and the columns and
        values come from one chained list of the ``(value, col)`` pairs,
        with no Python work per row.  ``vals`` is the values'
        ``fields.integers.int_vector``: int64 when every (integer) value
        fits, else an object array (wide ints, field elements).  ``PACKS``
        counts the packings by path."""
        if self._packed is None:
            import numpy as np

            from .fields.integers import int_vector

            n = len(self.rows)
            lens = np.fromiter(map(len, self.rows), np.int64, n)
            flat = list(chain.from_iterable(self.rows))
            rows_np = np.repeat(np.arange(n, dtype=np.int32), lens)
            cols_np = np.fromiter(map(itemgetter(1), flat), np.int32, len(flat))
            vals = int_vector(list(map(itemgetter(0), flat)))
            PACKS["flat" if vals.dtype == np.int64 else "fallback"] += 1
            self._packed = (rows_np, cols_np, vals)
        return self._packed

    @staticmethod
    def from_dense(dense: list[list]) -> "SparseMatrix":
        rows = []
        for drow in dense:
            row = []
            for col, v in enumerate(drow):
                nz = not v.is_zero() if isinstance(v, Fp) else v != 0
                if nz:
                    row.append((v, col))
            rows.append(row)
        return SparseMatrix(len(dense), len(dense[0]), rows)

    def pad_rows(self, new_size: int) -> None:
        if new_size > self.n_rows:
            self.n_rows = new_size

    def pad_cols(self, new_size: int) -> None:
        if new_size > self.n_cols:
            self.n_cols = new_size

    def map_to_field(self, cfg: FieldConfig) -> "SparseMatrix":
        rows = [[(cfg.fp(v), c) for v, c in row] for row in self.rows]
        return SparseMatrix(self.n_rows, self.n_cols, rows)

    def to_dense(self, zero):
        d = [[zero for _ in range(self.n_cols)] for _ in range(self.n_rows)]
        for i, row in enumerate(self.rows):
            for v, c in row:
                d[i][c] = v
        return d

    def nnz(self) -> int:
        return sum(len(r) for r in self.rows)


def mat_vec_mul(m: SparseMatrix, z: list):
    """M·z for both flavors; result has len(m.rows) entries (logical padding
    to n_rows is the caller's concern, as in the reference)."""
    if m.n_cols != len(z):
        raise ValueError(f"matrix has {m.n_cols} cols, vector has {len(z)}")
    out = []
    for row in m.rows:
        acc = None
        for v, c in row:
            t = z[c] * v
            acc = t if acc is None else acc + t
        if acc is None:
            z0 = z[0]
            acc = z0.cfg.zero() if isinstance(z0, Fp) else 0
        out.append(acc)
    return out


def compute_eval_table_sparse(
    m: SparseMatrix, rx: list[Fp], num_rows: int, num_cols: int, cfg: FieldConfig
) -> list[Fp]:
    """rᵀ·M accumulation (zinc/src/sparse_matrix.rs:165-182)."""
    assert len(rx) == num_rows
    out = [cfg.zero() for _ in range(num_cols)]
    for row_i, row in enumerate(m.rows):
        rv = rx[row_i]
        for v, c in row:
            out[c] = out[c] + rv * v
    return out


def evaluate_mle(m: SparseMatrix, r_row: list[Fp], r_col: list[Fp], cfg: FieldConfig) -> Fp:
    """M̃(r_row, r_col) = Σ_{(i,j)∈nnz} M[i,j]·eq(i, r_row)·eq(j, r_col).

    Equals the reference's column-major ``from_matrix`` + ``evaluate`` at the
    concatenated point [r_row ‖ r_col] (row bits are the low variables), in
    O(nnz + 2^s + 2^s') instead of O(2^(s+s'))."""
    eq_row = build_eq_x_r_vec(r_row) if r_row else [cfg.one()]
    eq_col = build_eq_x_r_vec(r_col) if r_col else [cfg.one()]
    acc = cfg.zero()
    for i, row in enumerate(m.rows):
        ei = eq_row[i]
        for v, c in row:
            acc = acc + ei * eq_col[c] * v
    return acc
