"""Multilinear sumcheck verifier.

Mirrors zinc/src/sumcheck.rs:116-164 and
zinc/src/sumcheck/verifier.rs:97-303: replay the transcript,
check p(0) + p(1) = claim each round, and reduce the claim by Lagrange
interpolation of the d+1 evaluation points at the round challenge.

``interpolate_uni_poly`` computes the same value as the reference's
factorial-ratio implementation (zinc/src/sumcheck/verifier.rs:161-303
— its i64/i128/field regimes are arithmetic optimizations of one formula).
Python ints are arbitrary-precision, so all three regimes collapse into one:
the denominators (−1)^(n−1−i)·i!·(n−1−i)! stay plain ints, and the per-term
field divisions of the reference are replaced by one batch inversion
(Montgomery's trick) — a single modular inversion per round instead of d+1.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.config import FieldConfig, Fp
from ..transcript import KeccakTranscript
from .prover import SumcheckProof, _absorb_nvars_degree


class SumcheckError(Exception):
    pass


@dataclass
class SubClaim:
    point: list  # list[Fp]
    expected_evaluation: Fp


def interpolate_uni_poly(evals: list[Fp], x: Fp) -> Fp:
    """Evaluate at x the unique degree-(len−1) polynomial through
    (i, evals[i]) for i = 0..len−1.

    p(x) = prod · Σᵢ evals[i] / (denomᵢ · (x−i)) with prod = Πⱼ (x−j) and
    denomᵢ = (−1)^(n−1−i)·i!·(n−1−i)! = Π_{j≠i}(i−j).  The n divisors are
    inverted together with one batch inversion.
    """
    cfg = x.cfg
    n = len(evals)
    # diffs + early exit when x is one of the nodes (matches reference
    # behavior and avoids division by zero)
    diffs = []
    prod = cfg.one()
    for i in range(n):
        d = x - cfg.fp(i)
        if d.is_zero():
            return evals[i]
        diffs.append(d)
        prod = prod * d
    fact = [1] * n
    for i in range(1, n):
        fact[i] = fact[i - 1] * i
    divisors = []
    for i in range(n):
        den = fact[i] * fact[n - 1 - i]
        if (n - 1 - i) & 1:
            den = -den
        divisors.append(cfg.fp(den) * diffs[i])
    # batch inversion: prefix products, one inversion, backward sweep
    prefix = [cfg.one()]
    for d in divisors:
        prefix.append(prefix[-1] * d)
    inv_run = prefix[-1].inverse()
    res = cfg.zero()
    for i in range(n - 1, -1, -1):
        inv_i = inv_run * prefix[i]
        inv_run = inv_run * divisors[i]
        res = res + evals[i] * prod * inv_i
    return res


def verify_as_subprotocol(
    transcript: KeccakTranscript,
    num_vars: int,
    degree: int,
    claimed_sum: Fp,
    proof: SumcheckProof,
    cfg: FieldConfig,
) -> SubClaim:
    _absorb_nvars_degree(transcript, num_vars, degree, cfg)

    if num_vars == 0:
        transcript.absorb_field(claimed_sum)
        return SubClaim(point=[], expected_evaluation=claimed_sum)

    if len(proof) != num_vars:
        raise SumcheckError(f"invalid proof length: expected {num_vars}, got {len(proof)}")

    randomness: list[Fp] = []
    for evals in proof:
        transcript.absorb_field_slice(evals)
        r = transcript.get_challenge(cfg)
        transcript.absorb_field(r)
        randomness.append(r)

    expected = claimed_sum
    for i in range(num_vars):
        evals = proof[i]
        if len(evals) != degree + 1:
            raise SumcheckError("max degree exceeded")
        if degree > 0:
            if not (evals[0] + evals[1]) == expected:
                raise SumcheckError(
                    f"sumcheck round {i}: p(0)+p(1) != expected claim"
                )
        else:
            if not evals[0] == expected:
                raise SumcheckError(f"sumcheck round {i}: constant mismatch")
        expected = interpolate_uni_poly(evals, randomness[i])

    return SubClaim(point=randomness, expected_evaluation=expected)
