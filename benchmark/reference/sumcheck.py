"""The sumcheck verifier's replay: the transcript, p(0) + p(1) against the
running claim each round, and the claim carried to the next round by
interpolation at the round's challenge."""

from __future__ import annotations

from .field import interpolate
from .transcript import Field, Transcript


def replay(t: Transcript, f: Field, nvars: int, degree: int, claim: int,
           proof_mont: list[list[int]]) -> tuple[list[int], int, int]:
    """(challenges, the claim left after the last round, rounds that fail)
    for a proof given as each round's d + 1 evaluations in Montgomery form.
    A proof of the wrong shape fails every round."""
    t.absorb_field(f, f.mont(nvars))
    t.absorb_field(f, f.mont(degree))
    if len(proof_mont) != nvars or any(len(e) != degree + 1 for e in proof_mont):
        return [], claim, nvars
    rs, bad = [], 0
    for evals_m in proof_mont:
        for m in evals_m:
            t.absorb_field(f, m)
        r = t.challenge(f)
        t.absorb_field(f, f.mont(r))
        evals = [f.canon(m) for m in evals_m]
        bad += (evals[0] + evals[1]) % f.q != claim
        claim = interpolate(evals, r, f.q)
        rs.append(r)
    return rs, claim, bad
