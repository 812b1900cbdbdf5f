"""Multilinear sumcheck prover (non-interactive, transcript-driven).

Protocol flow mirrors zinc/src/sumcheck.rs:56-112 +
zinc/src/sumcheck/prover.rs:62-179 (the Jolt-style incremental
round evaluation): per round, fix the previous challenge into every MLE, then
for each hypercube pair evaluate the combination function at points
0..=degree by stepping ``vals += (v1 − v0)``, and sum.

The combination function is a *sum of scaled monomials* in the MLE values:
``comb(vals) = Σ_k coeff_k · Π_{j ∈ indices_k} vals[j]``.  This covers every
use in the system (Spartan round 1 distributes the trailing eq factor into
each monomial, round 2 is the single monomial vals[0]·vals[1]) and — unlike
an opaque closure — is directly compilable by the device engine.

Transcript schedule per round (bit-exact with the reference): absorb the
d+1 evaluations, squeeze the challenge, absorb the challenge.  Before round
one: absorb nvars and degree as field elements (u64 mapping when the field
has one word, u128 otherwise — both reduce to the same residues).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.config import FieldConfig, Fp
from ..poly.mle import DenseMleF
from ..transcript import KeccakTranscript

# (coefficient, mle indices) monomials
CombSpec = list  # list[tuple[Fp, tuple[int, ...]]]

SumcheckProof = list  # list[list[Fp]]: per-round evaluations at 0..=degree


def comb_eval(comb: CombSpec, vals: list[Fp], cfg: FieldConfig) -> Fp:
    acc = cfg.zero()
    for coeff, idxs in comb:
        term = coeff
        for j in idxs:
            term = term * vals[j]
        acc = acc + term
    return acc


@dataclass
class ProverState:
    randomness: list
    mles: list  # final (fully folded or partially folded) MLEs
    num_vars: int
    max_degree: int


def _absorb_nvars_degree(transcript: KeccakTranscript, nvars: int, degree: int, cfg: FieldConfig):
    transcript.absorb_field(cfg.fp(nvars))
    transcript.absorb_field(cfg.fp(degree))


def _round_evals(
    mles: list[list[Fp]], degree: int, comb: CombSpec, cfg: FieldConfig
) -> list[Fp]:
    """Evaluations of the round polynomial at 0..=degree (host engine)."""
    half = len(mles[0]) // 2
    evals = [cfg.zero() for _ in range(degree + 1)]
    nm = len(mles)
    for b in range(half):
        vals0 = [mles[j][2 * b] for j in range(nm)]
        evals[0] = evals[0] + comb_eval(comb, vals0, cfg)
        if degree > 0:
            vals1 = [mles[j][2 * b + 1] for j in range(nm)]
            evals[1] = evals[1] + comb_eval(comb, vals1, cfg)
            steps = [v1 - v0 for v0, v1 in zip(vals0, vals1)]
            vals = list(vals1)
            for t in range(2, degree + 1):
                vals = [v + s for v, s in zip(vals, steps)]
                evals[t] = evals[t] + comb_eval(comb, vals, cfg)
    return evals


def _fold(mles: list[list[Fp]], r: Fp) -> list[list[Fp]]:
    out = []
    for evs in mles:
        half = len(evs) // 2
        out.append([evs[2 * b] + r * (evs[2 * b + 1] - evs[2 * b]) for b in range(half)])
    return out


def prove_as_subprotocol(
    transcript: KeccakTranscript,
    mles: list[DenseMleF],
    nvars: int,
    degree: int,
    comb: CombSpec,
    cfg: FieldConfig,
) -> tuple[SumcheckProof, ProverState]:
    _absorb_nvars_degree(transcript, nvars, degree, cfg)

    if nvars == 0:
        return [], ProverState(randomness=[], mles=mles, num_vars=0, max_degree=degree)

    tables = [list(m.evaluations) for m in mles]
    randomness: list[Fp] = []
    proof: SumcheckProof = []

    for rnd in range(nvars):
        if rnd > 0:
            tables = _fold(tables, randomness[-1])
        evals = _round_evals(tables, degree, comb, cfg)
        transcript.absorb_field_slice(evals)
        proof.append(evals)
        r = transcript.get_challenge(cfg)
        transcript.absorb_field(r)
        randomness.append(r)

    tables = _fold(tables, randomness[-1])
    final_mles = [DenseMleF(0, t, cfg) for t in tables]
    return proof, ProverState(
        randomness=randomness, mles=final_mles, num_vars=nvars, max_degree=degree
    )
