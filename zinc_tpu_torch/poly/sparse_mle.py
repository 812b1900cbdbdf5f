"""Sparse multilinear extensions (dict-backed) over the field and over ℤ.

Mirror of zinc/src/poly_f/mle/sparse.rs:22-541 and
zinc/src/poly_z/mle/sparse.rs (the BTreeMap-backed twins of the
dense MLEs): entries are {index: value} with the same little-endian
variable order as the dense layout (poly/mle.py).  Host backend — sparse
MLEs only appear at setup/verification scale in the protocol, never on the
prover's hot path.

The port's copy of ``zinc_tpu/poly/sparse_mle.py``.
"""

from __future__ import annotations

from ..fields.config import FieldConfig, Fp
from .mle import DenseMleF, DenseMleZ, _swap_bits


def _relabel_entries(entries, num_vars: int, a: int, b: int, k: int):
    """Shared relabel core (src/poly_f/mle/sparse.rs:148-171)."""
    if a > b:
        a, b = b, a
    if a == b or k == 0:
        return dict(entries)
    if b + k > num_vars:
        raise ValueError("invalid relabel argument")
    if a + k > b:
        raise ValueError("overlapped swap window is not allowed")
    return {_swap_bits(i, a, b, k): v for i, v in entries.items()}


class SparseMleF:
    """Sparse MLE over the random field.

    Reference: SparseMultilinearExtension (src/poly_f/mle/sparse.rs:22-30);
    `from_sparse_slice` (:121), `evaluate` (:56), `fix_variables` (:169),
    `to_dense` == `to_evaluations` (:199).
    """

    __slots__ = ("num_vars", "entries", "cfg")

    def __init__(self, num_vars: int, entries: dict[int, Fp], cfg: FieldConfig):
        for idx in entries:
            if idx >= 1 << num_vars:
                raise ValueError(f"index {idx} out of range for {num_vars} vars")
        self.num_vars = num_vars
        self.entries = {i: v for i, v in entries.items() if not v.is_zero()}
        self.cfg = cfg

    @staticmethod
    def from_sparse_slice(num_vars: int, pairs, cfg: FieldConfig) -> "SparseMleF":
        return SparseMleF(num_vars, dict(pairs), cfg)

    @staticmethod
    def from_matrix(matrix, cfg: FieldConfig) -> "SparseMleF":
        """Column-major matrix flattening (same layout as DenseMleF.from_matrix,
        reference src/poly_f/mle/sparse.rs:100-119)."""
        s = max(matrix.n_rows - 1, 1).bit_length() if matrix.n_rows > 1 else 0
        sp = max(matrix.n_cols - 1, 1).bit_length() if matrix.n_cols > 1 else 0
        padded_rows = 1 << s
        entries = {}
        for row_i, row in enumerate(matrix.rows):
            for val, col_i in row:
                entries[padded_rows * col_i + row_i] = val
        return SparseMleF(s + sp, entries, cfg)

    def fix_variables(self, point: list[Fp]) -> "SparseMleF":
        """Fix the first len(point) variables (pairing indices 2b/2b+1)."""
        assert len(point) <= self.num_vars
        entries = self.entries
        nv = self.num_vars
        one = self.cfg.one()
        for r in point:
            nxt: dict[int, Fp] = {}
            for idx, val in entries.items():
                w = r if idx & 1 else one - r
                tgt = idx >> 1
                cur = nxt.get(tgt)
                contrib = val * w
                nxt[tgt] = contrib if cur is None else cur + contrib
            entries = nxt
            nv -= 1
        return SparseMleF(nv, entries, self.cfg)

    def evaluate(self, point: list[Fp]) -> Fp:
        if len(point) != self.num_vars:
            raise ValueError("point/vars mismatch")
        fixed = self.fix_variables(point)
        return fixed.entries.get(0, self.cfg.zero())

    def to_dense(self) -> DenseMleF:
        evals = [self.cfg.zero()] * (1 << self.num_vars)
        for idx, val in self.entries.items():
            evals[idx] = val
        return DenseMleF(self.num_vars, evals, self.cfg)

    def to_evaluations(self) -> list[Fp]:
        return self.to_dense().evaluations

    @staticmethod
    def rand_with_config(
        num_vars: int, num_nonzero: int, cfg: FieldConfig, rng
    ) -> "SparseMleF":
        """Uniform random sparse MLE with `num_nonzero` rejection-sampled
        distinct indices (src/poly_f/mle/sparse.rs:68-98)."""
        if num_nonzero > 1 << num_vars:
            raise ValueError("more nonzero entries than the hypercube")
        entries: dict[int, Fp] = {}
        while len(entries) < num_nonzero:
            idx = rng.randrange(1 << num_vars)
            if idx not in entries:
                entries[idx] = cfg.fp(rng.randrange(cfg.q))
        return SparseMleF(num_vars, entries, cfg)

    @staticmethod
    def rand(num_vars: int, cfg: FieldConfig, rng) -> "SparseMleF":
        """sqrt(2^num_vars) nonzero entries (src/poly_f/mle/sparse.rs:144-146)."""
        return SparseMleF.rand_with_config(num_vars, 1 << (num_vars // 2), cfg, rng)

    def relabel(self, a: int, b: int, k: int) -> "SparseMleF":
        return SparseMleF(
            self.num_vars, _relabel_entries(self.entries, self.num_vars, a, b, k), self.cfg
        )

    # -- ring ops (sparse union; src/poly_f/mle/sparse.rs:232-420) -----------

    def _check_compat(self, other: "SparseMleF") -> None:
        if self.num_vars != other.num_vars:
            raise ValueError("trying to combine sparse MLEs with different numbers of variables")

    def __add__(self, other: "SparseMleF") -> "SparseMleF":
        if not other.entries:
            return SparseMleF(self.num_vars, self.entries, self.cfg)
        if not self.entries:
            return SparseMleF(other.num_vars, other.entries, other.cfg)
        self._check_compat(other)
        out = dict(self.entries)
        for i, v in other.entries.items():
            cur = out.get(i)
            out[i] = v if cur is None else cur + v
        return SparseMleF(self.num_vars, out, self.cfg)

    def __neg__(self) -> "SparseMleF":
        return SparseMleF(self.num_vars, {i: -v for i, v in self.entries.items()}, self.cfg)

    def __sub__(self, other: "SparseMleF") -> "SparseMleF":
        return self + (-other)

    def __mul__(self, scalar: Fp) -> "SparseMleF":
        return SparseMleF(
            self.num_vars, {i: v * scalar for i, v in self.entries.items()}, self.cfg
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SparseMleF)
            and self.num_vars == other.num_vars
            and self.entries == other.entries
        )


class SparseMleZ:
    """Sparse MLE over ℤ (integer twin, src/poly_z/mle/sparse.rs)."""

    __slots__ = ("num_vars", "entries")

    def __init__(self, num_vars: int, entries: dict[int, int]):
        for idx in entries:
            if idx >= 1 << num_vars:
                raise ValueError(f"index {idx} out of range for {num_vars} vars")
        self.num_vars = num_vars
        self.entries = {i: v for i, v in entries.items() if v != 0}

    def map_to_field(self, cfg: FieldConfig) -> SparseMleF:
        return SparseMleF(self.num_vars, {i: cfg.fp(v) for i, v in self.entries.items()}, cfg)

    def fix_variables(self, point: list[int]) -> "SparseMleZ":
        entries = self.entries
        nv = self.num_vars
        for r in point:
            nxt: dict[int, int] = {}
            for idx, val in entries.items():
                w = r if idx & 1 else 1 - r
                tgt = idx >> 1
                nxt[tgt] = nxt.get(tgt, 0) + val * w
            entries = nxt
            nv -= 1
        return SparseMleZ(nv, entries)

    def evaluate(self, point: list[int]) -> int:
        if len(point) != self.num_vars:
            raise ValueError("point/vars mismatch")
        return self.fix_variables(point).entries.get(0, 0)

    def to_dense(self) -> DenseMleZ:
        evals = [0] * (1 << self.num_vars)
        for idx, val in self.entries.items():
            evals[idx] = val
        return DenseMleZ(self.num_vars, evals)

    def to_evaluations(self) -> list[int]:
        return self.to_dense().evaluations

    def relabel(self, a: int, b: int, k: int) -> "SparseMleZ":
        return SparseMleZ(self.num_vars, _relabel_entries(self.entries, self.num_vars, a, b, k))

    def _check_compat(self, other: "SparseMleZ") -> None:
        if self.num_vars != other.num_vars:
            raise ValueError("trying to combine sparse MLEs with different numbers of variables")

    def __add__(self, other: "SparseMleZ") -> "SparseMleZ":
        if not other.entries:
            return SparseMleZ(self.num_vars, self.entries)
        if not self.entries:
            return SparseMleZ(other.num_vars, other.entries)
        self._check_compat(other)
        out = dict(self.entries)
        for i, v in other.entries.items():
            out[i] = out.get(i, 0) + v
        return SparseMleZ(self.num_vars, out)

    def __neg__(self) -> "SparseMleZ":
        return SparseMleZ(self.num_vars, {i: -v for i, v in self.entries.items()})

    def __sub__(self, other: "SparseMleZ") -> "SparseMleZ":
        return self + (-other)

    def __mul__(self, scalar: int) -> "SparseMleZ":
        return SparseMleZ(self.num_vars, {i: v * scalar for i, v in self.entries.items()})

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SparseMleZ)
            and self.num_vars == other.num_vars
            and self.entries == other.entries
        )
