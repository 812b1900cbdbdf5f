"""Dense multilinear extensions over the random field and over ℤ.

Variable-order convention (matching the reference, zinc/src/poly_f/
mle.rs:13-18): evaluation index bits are little-endian — index ``0b1011``
holds P(1,1,0,1); ``fix_variables`` fixes the FIRST variable, pairing indices
(2b, 2b+1) and folding ``left + r·(right−left)``
(zinc/src/poly_f/mle/dense.rs:142-168).

Two matrix→MLE layouts exist in the reference and both are kept:

* field MLEs are built column-major — ``v[padded_rows·col + row]``
  (zinc/src/poly_f/mle/dense.rs:69-87), so the row bits are the
  low (first-fixed) variables;
* integer MLEs are built row-major — ``v[padded_cols·row + col]``
  (zinc/src/poly_z/mle/dense.rs:67-85).

These host classes are the specification backend; the device backend
(fields/montgomery.py + poly/device.py) holds the same residues in
``(..., L16)`` uint32 limb arrays.
"""

from __future__ import annotations

from ..fields.config import FieldConfig, Fp


def _swap_bits(x: int, a: int, b: int, k: int) -> int:
    """Swap the k-bit windows at bit positions a and b of x (a+k <= b)."""
    mask = (1 << k) - 1
    xa = (x >> a) & mask
    xb = (x >> b) & mask
    return (x & ~((mask << a) | (mask << b))) | (xa << b) | (xb << a)


def _relabel_evals(evals, num_vars: int, a: int, b: int, k: int):
    """Shared relabel core (zinc/src/poly_f/mle/dense.rs:104-120)."""
    if a > b:
        a, b = b, a
    if a == b or k == 0:
        return list(evals)
    if b + k > num_vars:
        raise ValueError("invalid relabel argument")
    if a + k > b:
        raise ValueError("overlapped swap window is not allowed")
    out = list(evals)
    for i in range(len(out)):
        j = _swap_bits(i, a, b, k)
        if i < j:
            out[i], out[j] = out[j], out[i]
    return out


class DenseMleF:
    """Dense MLE over the random field (host backend, list of Fp)."""

    __slots__ = ("evaluations", "num_vars", "cfg")

    def __init__(self, num_vars: int, evaluations: list[Fp], cfg: FieldConfig):
        assert len(evaluations) <= 1 << num_vars
        if len(evaluations) != 1 << num_vars:
            evaluations = evaluations + [cfg.zero()] * ((1 << num_vars) - len(evaluations))
        self.num_vars = num_vars
        self.evaluations = evaluations
        self.cfg = cfg

    def copy(self) -> "DenseMleF":
        return DenseMleF(self.num_vars, list(self.evaluations), self.cfg)

    def fix_variables(self, point: list[Fp]) -> "DenseMleF":
        """Return the MLE with the first len(point) variables fixed."""
        assert len(point) <= self.num_vars
        poly = self.evaluations
        nv = self.num_vars
        for i, r in enumerate(point, start=1):
            half = 1 << (nv - i)
            poly = [poly[2 * b] + r * (poly[2 * b + 1] - poly[2 * b]) for b in range(half)]
        return DenseMleF(nv - len(point), poly, self.cfg)

    def evaluate(self, point: list[Fp]) -> Fp:
        if len(point) != self.num_vars:
            raise ValueError(f"point has {len(point)} coords, MLE has {self.num_vars} vars")
        return self.fix_variables(point).evaluations[0]

    def to_evaluations(self) -> list[Fp]:
        return list(self.evaluations)

    @staticmethod
    def zero(cfg: FieldConfig) -> "DenseMleF":
        """The additive identity: 0 vars, single zero evaluation
        (zinc/src/poly_f/mle/dense.rs:181-192)."""
        return DenseMleF(0, [cfg.zero()], cfg)

    def is_zero(self) -> bool:
        return self.num_vars == 0 and self.evaluations[0].is_zero()

    @staticmethod
    def rand(num_vars: int, cfg: FieldConfig, rng) -> "DenseMleF":
        return DenseMleF(
            num_vars, [cfg.fp(rng.randrange(cfg.q)) for _ in range(1 << num_vars)], cfg
        )

    def relabel(self, a: int, b: int, k: int) -> "DenseMleF":
        """Swap the k variables starting at a with those starting at b
        (zinc/src/poly_f/mle/dense.rs:136-140)."""
        return DenseMleF(
            self.num_vars, _relabel_evals(self.evaluations, self.num_vars, a, b, k), self.cfg
        )

    # -- ring-ops suite (zinc/src/poly_f/mle/dense.rs:181-423) ----

    def _check_compat(self, other: "DenseMleF") -> None:
        if self.num_vars != other.num_vars:
            raise ValueError("trying to combine dense MLEs with different numbers of variables")
        if self.cfg.q != other.cfg.q:
            raise ValueError("trying to combine dense MLEs in different fields")

    def __add__(self, other):
        if isinstance(other, Fp):  # MLE + scalar: shift every evaluation
            return DenseMleF(self.num_vars, [v + other for v in self.evaluations], self.cfg)
        if other.is_zero():
            return self.copy()
        if self.is_zero():
            return other.copy()
        self._check_compat(other)
        return DenseMleF(
            self.num_vars,
            [a + b for a, b in zip(self.evaluations, other.evaluations)],
            self.cfg,
        )

    def __sub__(self, other):
        if isinstance(other, Fp):
            return DenseMleF(self.num_vars, [v - other for v in self.evaluations], self.cfg)
        return self + (-other)

    def __neg__(self) -> "DenseMleF":
        return DenseMleF(self.num_vars, [-v for v in self.evaluations], self.cfg)

    def __mul__(self, scalar: Fp) -> "DenseMleF":
        return DenseMleF(self.num_vars, [v * scalar for v in self.evaluations], self.cfg)

    def add_scaled(self, r: Fp, other: "DenseMleF") -> "DenseMleF":
        """self + r·other (AddAssign<(F, &Self)>, dense.rs:265-295)."""
        if other.is_zero():
            return self.copy()
        if self.is_zero():
            return other * r
        self._check_compat(other)
        return DenseMleF(
            self.num_vars,
            [a + r * b for a, b in zip(self.evaluations, other.evaluations)],
            self.cfg,
        )

    def __getitem__(self, index: int) -> Fp:
        return self.evaluations[index]

    def __setitem__(self, index: int, value: Fp) -> None:
        self.evaluations[index] = value

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, DenseMleF)
            and self.num_vars == other.num_vars
            and self.evaluations == other.evaluations
        )

    @staticmethod
    def from_matrix(matrix, cfg: FieldConfig) -> "DenseMleF":
        """Column-major flattening of a sparse matrix into an MLE (field layout).

        The resulting MLE has s + s' variables; the first s (row) variables are
        the low index bits.
        """
        s = max(matrix.n_rows - 1, 1).bit_length() if matrix.n_rows > 1 else 0
        sp = max(matrix.n_cols - 1, 1).bit_length() if matrix.n_cols > 1 else 0
        padded_rows = 1 << s
        n_vars = s + sp
        evals = [cfg.zero()] * (1 << n_vars)
        for row_i, row in enumerate(matrix.rows):
            for val, col_i in row:
                evals[padded_rows * col_i + row_i] = val
        return DenseMleF(n_vars, evals, cfg)


class DenseMleZ:
    """Dense MLE over ℤ (host backend, list of Python ints)."""

    __slots__ = ("evaluations", "num_vars")

    def __init__(self, num_vars: int, evaluations: list[int]):
        assert len(evaluations) <= 1 << num_vars
        if len(evaluations) != 1 << num_vars:
            evaluations = list(evaluations) + [0] * ((1 << num_vars) - len(evaluations))
        self.num_vars = num_vars
        self.evaluations = list(evaluations)

    def map_to_field(self, cfg: FieldConfig) -> DenseMleF:
        return DenseMleF(self.num_vars, [cfg.fp(v) for v in self.evaluations], cfg)

    def fix_variables(self, point: list[int]) -> "DenseMleZ":
        poly = self.evaluations
        nv = self.num_vars
        for i, r in enumerate(point, start=1):
            half = 1 << (nv - i)
            poly = [poly[2 * b] + r * (poly[2 * b + 1] - poly[2 * b]) for b in range(half)]
        return DenseMleZ(nv - len(point), poly)

    def evaluate(self, point: list[int]) -> int:
        if len(point) != self.num_vars:
            raise ValueError("point/vars mismatch")
        return self.fix_variables(point).evaluations[0]

    def to_evaluations(self) -> list[int]:
        return list(self.evaluations)

    @staticmethod
    def zero() -> "DenseMleZ":
        return DenseMleZ(0, [0])

    def is_zero(self) -> bool:
        return self.num_vars == 0 and self.evaluations[0] == 0

    def relabel(self, a: int, b: int, k: int) -> "DenseMleZ":
        return DenseMleZ(self.num_vars, _relabel_evals(self.evaluations, self.num_vars, a, b, k))

    def _check_compat(self, other: "DenseMleZ") -> None:
        if self.num_vars != other.num_vars:
            raise ValueError("trying to combine dense MLEs with different numbers of variables")

    def __add__(self, other):
        if isinstance(other, int):
            return DenseMleZ(self.num_vars, [v + other for v in self.evaluations])
        if other.is_zero():
            return DenseMleZ(self.num_vars, self.evaluations)
        if self.is_zero():
            return DenseMleZ(other.num_vars, other.evaluations)
        self._check_compat(other)
        return DenseMleZ(
            self.num_vars, [a + b for a, b in zip(self.evaluations, other.evaluations)]
        )

    def __sub__(self, other):
        if isinstance(other, int):
            return DenseMleZ(self.num_vars, [v - other for v in self.evaluations])
        return self + (-other)

    def __neg__(self) -> "DenseMleZ":
        return DenseMleZ(self.num_vars, [-v for v in self.evaluations])

    def __mul__(self, scalar: int) -> "DenseMleZ":
        return DenseMleZ(self.num_vars, [v * scalar for v in self.evaluations])

    def __getitem__(self, index: int) -> int:
        return self.evaluations[index]

    def __setitem__(self, index: int, value: int) -> None:
        self.evaluations[index] = value

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, DenseMleZ)
            and self.num_vars == other.num_vars
            and self.evaluations == other.evaluations
        )


def build_eq_x_r_vec_z(r: list[int]) -> list[int]:
    """Integer eq(x, r) table (zinc/src/poly_z/mle/dense.rs:444-461)."""
    if not r:
        raise ValueError("r must be non-empty")
    buf = [1 - r[-1], r[-1]]
    for rj in reversed(r[:-1]):
        nxt = []
        for b in buf:
            t = rj * b
            nxt.append(b - t)
            nxt.append(t)
        buf = nxt
    return buf


def build_eq_x_r_z(r: list[int]) -> DenseMleZ:
    return DenseMleZ(len(r), build_eq_x_r_vec_z(r))


def build_eq_x_r_vec(r: list[Fp]) -> list[Fp]:
    """Table of eq(x, r) over x ∈ {0,1}^n, index bits little-endian in x.

    eq[i] = Π_j (bit_j(i) ? r_j : 1 − r_j), built by the doubling recursion of
    zinc/src/sumcheck/utils.rs:120-177.
    """
    if not r:
        raise ValueError("r must be non-empty")
    cfg = r[0].cfg
    one = cfg.one()
    buf = [one - r[-1], r[-1]]
    for rj in reversed(r[:-1]):
        nxt = []
        for b in buf:
            t = rj * b
            nxt.append(b - t)
            nxt.append(t)
        buf = nxt
    return buf


def build_eq_x_r(r: list[Fp], cfg: FieldConfig) -> DenseMleF:
    return DenseMleF(len(r), build_eq_x_r_vec(r), cfg)


def eq_eval(x: list[Fp], y: list[Fp]) -> Fp:
    """eq(x, y) = Π (x_i·y_i + (1−x_i)(1−y_i))."""
    if len(x) != len(y):
        raise ValueError("x and y have different lengths")
    cfg = x[0].cfg if x else None
    if cfg is None:
        raise ValueError("empty points")
    res = cfg.one()
    one = cfg.one()
    for xi, yi in zip(x, y):
        xy = xi * yi
        res = res * (xy + xy - xi - yi + one)
    return res
