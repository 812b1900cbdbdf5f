"""Virtual-polynomial helpers (HyperPlonk-derived, host backend).

Mirror of zinc/src/poly_f/polynomials/multilinear_polynomial.rs:
random product/zero MLE lists for tests and benches, permutation MLEs,
optimized evaluation, first/last-variable fixing, and polynomial merging.

The port's copy of ``zinc_tpu/poly/virtual.py``.
"""

from __future__ import annotations

from ..fields.config import FieldConfig, Fp
from .mle import DenseMleF
from .util import get_batched_nv


def random_mle_list(nv: int, degree: int, rng, cfg: FieldConfig):
    """`degree` random MLEs + the sum over the hypercube of their product
    (reference multilinear_polynomial.rs:20-56)."""
    multiplicands: list[list[Fp]] = [[] for _ in range(degree)]
    total = cfg.zero()
    for _ in range(1 << nv):
        product = cfg.one()
        for e in multiplicands:
            val = cfg.fp(rng.randrange(cfg.q))
            e.append(val)
            product = product * val
        total = total + product
    return [DenseMleF(nv, evals, cfg) for evals in multiplicands], total


def random_zero_mle_list(nv: int, degree: int, rng, cfg: FieldConfig):
    """Random MLE list whose product is identically zero on the hypercube
    (first factor is the zero MLE — reference :58-88)."""
    multiplicands: list[list[Fp]] = [[] for _ in range(degree)]
    for _ in range(1 << nv):
        multiplicands[0].append(cfg.zero())
        for e in multiplicands[1:]:
            e.append(cfg.fp(rng.randrange(cfg.q)))
    return [DenseMleF(nv, evals, cfg) for evals in multiplicands]


def identity_permutation(num_vars: int, num_chunks: int, cfg: FieldConfig) -> list[Fp]:
    """(reference :90-94)"""
    return [cfg.fp(i) for i in range(num_chunks << num_vars)]


def identity_permutation_mles(num_vars: int, num_chunks: int, cfg: FieldConfig):
    """(reference :96-112)"""
    n = 1 << num_vars
    return [
        DenseMleF(num_vars, [cfg.fp(i) for i in range(c * n, (c + 1) * n)], cfg)
        for c in range(num_chunks)
    ]


def random_permutation(num_vars: int, num_chunks: int, rng, cfg: FieldConfig) -> list[Fp]:
    """Fisher-Yates-style removal sampling (reference :114-128)."""
    s_id = [cfg.fp(i) for i in range(num_chunks << num_vars)]
    out = []
    while s_id:
        out.append(s_id.pop(rng.randrange(len(s_id))))
    return out


def random_permutation_mles(num_vars: int, num_chunks: int, rng, cfg: FieldConfig):
    """(reference :131-150)"""
    perm = random_permutation(num_vars, num_chunks, rng, cfg)
    n = 1 << num_vars
    return [DenseMleF(num_vars, perm[c * n : (c + 1) * n], cfg) for c in range(num_chunks)]


def evaluate_opt(poly: DenseMleF, point: list[Fp]) -> Fp:
    """(reference :152-155)"""
    assert poly.num_vars == len(point)
    return poly.fix_variables(point).evaluations[0]


def fix_variables(poly: DenseMleF, partial_point: list[Fp]) -> DenseMleF:
    """Fix the FIRST variables (reference :157-179)."""
    return poly.fix_variables(partial_point)


def fix_last_variables(poly: DenseMleF, partial_point: list[Fp]) -> DenseMleF:
    """Fix the LAST variables, from the last point backwards
    (reference :278-308): fold pairs (b, b + half)."""
    assert len(partial_point) <= poly.num_vars
    evals = poly.evaluations
    nv = poly.num_vars
    for r in reversed(partial_point):
        half = 1 << (nv - 1)
        evals = [evals[b] + r * (evals[b + half] - evals[b]) for b in range(half)]
        nv -= 1
    return DenseMleF(nv, evals, poly.cfg)


def merge_polynomials(polynomials: list[DenseMleF], cfg: FieldConfig) -> DenseMleF:
    """Concatenate equal-width MLEs into one (zero-padded) MLE
    (reference :227-249)."""
    nv = polynomials[0].num_vars
    if any(p.num_vars != nv for p in polynomials):
        raise ValueError("num_vars do not match for polynomials")
    merged_nv = get_batched_nv(nv, len(polynomials))
    scalars: list[Fp] = []
    for p in polynomials:
        scalars.extend(p.evaluations)
    return DenseMleF(merged_nv, scalars, cfg)
