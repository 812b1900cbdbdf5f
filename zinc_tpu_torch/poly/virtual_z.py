"""Virtual-polynomial helpers over ℤ (host backend).

Mirror of zinc/src/poly_z/polynomials/multilinear_polynomial.rs —
the integer-ring twins of poly/virtual.py: random product/zero MLE lists,
permutation MLEs, optimized evaluation, first/last-variable fixing, and
polynomial merging.  The reference's `I::random` draws uniform bits over the
full signed word width (field/int.rs:187-192); here the sampling width is an
explicit `bits` parameter (uniform over [−2^(bits−1), 2^(bits−1))).

The port's copy of ``zinc_tpu/poly/virtual_z.py``.
"""

from __future__ import annotations

from .mle import DenseMleZ
from .util import get_batched_nv


def _rand_int(rng, bits: int) -> int:
    return rng.randrange(1 << bits) - (1 << (bits - 1))


def random_mle_list_z(nv: int, degree: int, rng, bits: int = 64):
    """`degree` random ℤ-MLEs + the sum over the hypercube of their product
    (reference poly_z/polynomials/multilinear_polynomial.rs:18-49)."""
    multiplicands: list[list[int]] = [[] for _ in range(degree)]
    total = 0
    for _ in range(1 << nv):
        product = 1
        for e in multiplicands:
            val = _rand_int(rng, bits)
            e.append(val)
            product *= val
        total += product
    return [DenseMleZ(nv, evals) for evals in multiplicands], total


def random_zero_mle_list_z(nv: int, degree: int, rng, bits: int = 64):
    """Random ℤ-MLE list whose product vanishes on the hypercube (the first
    factor is identically zero — reference :51-77)."""
    multiplicands: list[list[int]] = [[] for _ in range(degree)]
    for _ in range(1 << nv):
        multiplicands[0].append(0)
        for e in multiplicands[1:]:
            e.append(_rand_int(rng, bits))
    return [DenseMleZ(nv, evals) for evals in multiplicands]


def identity_permutation_z(num_vars: int, num_chunks: int) -> list[int]:
    """(reference :78-82)"""
    return list(range(num_chunks << num_vars))


def identity_permutation_mles_z(num_vars: int, num_chunks: int):
    """(reference :84-99)"""
    n = 1 << num_vars
    return [
        DenseMleZ(num_vars, list(range(c * n, (c + 1) * n))) for c in range(num_chunks)
    ]


def random_permutation_z(num_vars: int, num_chunks: int, rng) -> list[int]:
    """Removal-sampling permutation of the identity (reference :101-115)."""
    s_id = list(range(num_chunks << num_vars))
    out = []
    while s_id:
        out.append(s_id.pop(rng.randrange(len(s_id))))
    return out


def random_permutation_mles_z(num_vars: int, num_chunks: int, rng):
    """(reference :117-134)"""
    perm = random_permutation_z(num_vars, num_chunks, rng)
    n = 1 << num_vars
    return [DenseMleZ(num_vars, perm[c * n : (c + 1) * n]) for c in range(num_chunks)]


def evaluate_opt_z(poly: DenseMleZ, point: list[int]) -> int:
    """(reference :136-139)"""
    assert poly.num_vars == len(point)
    return poly.fix_variables(point).evaluations[0]


def fix_variables_z(poly: DenseMleZ, partial_point: list[int]) -> DenseMleZ:
    """Fix the FIRST variables (reference :141-158)."""
    return poly.fix_variables(partial_point)


def fix_last_variables_z(poly: DenseMleZ, partial_point: list[int]) -> DenseMleZ:
    """Fix the LAST variables, from the last point backwards
    (reference :223-266): fold pairs (b, b + half)."""
    assert len(partial_point) <= poly.num_vars
    evals = poly.evaluations
    nv = poly.num_vars
    for r in reversed(partial_point):
        half = 1 << (nv - 1)
        evals = [evals[b] + r * (evals[b + half] - evals[b]) for b in range(half)]
        nv -= 1
    return DenseMleZ(nv, evals)


def merge_polynomials_z(polynomials: list[DenseMleZ]) -> DenseMleZ:
    """Concatenate equal-width ℤ-MLEs into one zero-padded MLE
    (reference :200-221)."""
    nv = polynomials[0].num_vars
    if any(p.num_vars != nv for p in polynomials):
        raise ValueError("num_vars do not match for polynomials")
    merged_nv = get_batched_nv(nv, len(polynomials))
    scalars: list[int] = []
    for p in polynomials:
        scalars.extend(p.evaluations)
    return DenseMleZ(merged_nv, scalars)
