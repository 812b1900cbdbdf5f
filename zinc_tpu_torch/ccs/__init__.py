"""Customizable Constraint Systems (CCS, eprint 2023/552) over ℤ and Z_q.

Mirrors zinc/src/ccs/: shapes (m, n, l, t, q, d, s, s'),
multisets S with coefficients c, relation check
Σᵢ cᵢ·⊙_{j∈Sᵢ} Mⱼz == 0, power-of-two padding, z = (io ‖ 1 ‖ w), and the
ℤ→Z_q projection of whole statements.

The ℤ flavor carries Python-int values (arbitrary precision, signed); the
field flavor carries Fp values.  Test fixture generators (the Vitalik
x³+x+5 R1CS and arbitrary-size identity/squaring dummy CCS) mirror
ccs_z.rs:232-323 and test_utils.rs:89-185.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..fields.config import FieldConfig, Fp
from ..sparse import SparseMatrix, mat_vec_mul


class CSError(Exception):
    pass


@dataclass
class CCS:
    """CCS shape. ``c`` holds ints (ℤ flavor) or Fp (field flavor)."""

    m: int  # rows of each M_i
    n: int  # cols of each M_i = |z|
    l: int  # |io|
    t: int  # number of matrices
    q: int  # number of multisets
    d: int  # max degree
    s: int  # log2(m)
    s_prime: int  # log2(n)
    S: list = field(default_factory=list)
    c: list = field(default_factory=list)

    def map_to_field(self, cfg: FieldConfig) -> "CCS":
        return replace(self, S=[list(si) for si in self.S], c=[cfg.fp(ci) for ci in self.c])

    def pad(self, statement: "Statement", size: int) -> None:
        """Pad to a square power-of-two shape ≥ size (ccs_z.rs:110-130)."""
        size = 1 << (size - 1).bit_length() if size > 1 else 1
        if size > self.m:
            log_m = size.bit_length() - 1
            self.m = size
            self.s = log_m
            self.n = size
            self.s_prime = log_m
            for mat in statement.constraints:
                mat.pad_cols(size)
                mat.pad_rows(size)

    def check_relation(self, matrices: list[SparseMatrix], z: list) -> None:
        over_field = isinstance(z[0], Fp)
        zero = z[0].cfg.zero() if over_field else 0
        one = z[0].cfg.one() if over_field else 1
        for mat in matrices:
            if mat.n_rows != self.m or mat.n_cols != self.n:
                raise CSError("matrix shape mismatch")
        result = [zero] * self.m
        for i in range(self.q):
            hadamard = [one] * self.m
            for j in self.S[i]:
                mz = mat_vec_mul(matrices[j], z)
                mz = mz + [zero] * (self.m - len(mz))
                hadamard = [h * v for h, v in zip(hadamard, mz)]
            ci = self.c[i]
            if over_field and not isinstance(ci, Fp):
                ci = z[0].cfg.fp(ci)
            result = [r + h * ci for r, h in zip(result, hadamard)]
        ok = all(v.is_zero() if over_field else v == 0 for v in result)
        if not ok:
            raise CSError("CCS relation not satisfied")


class InstanceZ:
    """Behaviour of a satisfying instance of a constraint system: given a
    witness, produce the z concatenation (io ‖ 1 ‖ w).  Mirror of the
    reference trait `Instance_Z` (zinc/src/ccs/ccs_z.rs:211-229),
    implemented by :class:`Statement`."""

    def get_z_vector(self, w: list, one=1) -> list:
        raise NotImplementedError


@dataclass
class Statement(InstanceZ):
    """Constraint matrices + public input (ℤ or field flavor)."""

    constraints: list  # list[SparseMatrix]
    public_input: list  # list[int] or list[Fp]

    def map_to_field(self, cfg: FieldConfig) -> "Statement":
        return Statement(
            constraints=[m.map_to_field(cfg) for m in self.constraints],
            public_input=[cfg.fp(v) for v in self.public_input],
        )

    def get_z_vector(self, w: list, one=1) -> list:
        return list(self.public_input) + [one] + list(w)


@dataclass
class Witness:
    w_ccs: list  # list[int] or list[Fp]

    def map_to_field(self, cfg: FieldConfig) -> "Witness":
        return Witness(w_ccs=[cfg.fp(v) for v in self.w_ccs])


# ---------------------------------------------------------------------------
# Fixtures (mirrors of the reference test generators)
# ---------------------------------------------------------------------------


def _z_matrix(rows: list[list[int]]) -> SparseMatrix:
    return SparseMatrix.from_dense(rows)


def vitalik_ccs() -> CCS:
    """R1CS for x³ + x + 5 = y (ccs_z.rs:232-251)."""
    return CCS(m=4, n=6, l=1, t=3, q=2, d=2, s=2, s_prime=3, S=[[0, 1], [2]], c=[1, -1])


def vitalik_statement(input_value: int) -> Statement:
    a = _z_matrix(
        [
            [1, 0, 0, 0, 0, 0],
            [0, 0, 0, 1, 0, 0],
            [1, 0, 0, 0, 1, 0],
            [0, 5, 0, 0, 0, 1],
        ]
    )
    b = _z_matrix(
        [
            [1, 0, 0, 0, 0, 0],
            [1, 0, 0, 0, 0, 0],
            [0, 1, 0, 0, 0, 0],
            [0, 1, 0, 0, 0, 0],
        ]
    )
    c = _z_matrix(
        [
            [0, 0, 0, 1, 0, 0],
            [0, 0, 0, 0, 1, 0],
            [0, 0, 0, 0, 0, 1],
            [0, 0, 1, 0, 0, 0],
        ]
    )
    return Statement(constraints=[a, b, c], public_input=[input_value])


def vitalik_witness(x: int) -> Witness:
    return Witness(w_ccs=[x**3 + x + 5, x**2, x**3, x**3 + x])


def vitalik_fixture(input_value: int):
    """(ccs, statement, witness) padded to power-of-two, relation-checked."""
    ccs = vitalik_ccs()
    statement = vitalik_statement(input_value)
    witness = vitalik_witness(input_value)
    z = statement.get_z_vector(witness.w_ccs)
    ccs.check_relation(statement.constraints, z)
    size = max(ccs.m, ccs.n)
    ccs.pad(statement, size)
    return ccs, statement, witness


def identity_matrix(rows: int, cols: int) -> SparseMatrix:
    return SparseMatrix(rows, cols, [[(1, i)] for i in range(rows)])


def squaring_matrix(rows: int, cols: int, witness: list[int]) -> SparseMatrix:
    assert rows == len(witness)
    return SparseMatrix(rows, cols, [[(witness[i], i)] for i in range(rows)])


def dummy_ccs_from_z(z: list[int], pub_io_len: int = 1):
    """Arbitrary-size satisfied CCS: A·z ∘ B·z − C·z = z² − z·z = 0
    (test_utils.rs:89-121)."""
    n = len(z)
    s = (n - 1).bit_length()
    ccs = CCS(m=n, n=n, l=pub_io_len, t=3, q=2, d=2, s=s, s_prime=s, S=[[0, 1], [2]], c=[1, -1])
    a = identity_matrix(n, n)
    b = identity_matrix(n, n)
    c = squaring_matrix(n, n, z)
    statement = Statement(constraints=[a, b, c], public_input=z[:pub_io_len])
    wit = Witness(w_ccs=z[pub_io_len + 1 :])
    return ccs, statement, wit


def dummy_ccs_of_size(n: int, rng, int_bits: int = 63):
    """Random z of length n (z[l] forced to 1) + its dummy CCS."""
    z = [rng.randrange(-(1 << int_bits), 1 << int_bits) for _ in range(n)]
    z[1] = 1
    ccs, statement, wit = dummy_ccs_from_z(z, pub_io_len=1)
    return z, ccs, statement, wit
