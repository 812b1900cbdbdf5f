"""What a sumcheck proof of Σ_x Σ_j c_j · Π_{k∈P_j} T_k(x) must say, from
the tables and coefficients alone.

The products P_j take consecutive tables, as many as the configuration's
``factors_per_product`` says (``terms``).  The tables are given as the
program holds them, Montgomery residues m = a·R mod q, and the statement
is about the values a; the coefficients c_j are canonical.  Every
transcript first absorbs its step index (8 bytes, little-endian), as the
traffic sets it up.

``check`` judges one proof in full: each round's p(0) + p(1) against the
running claim from the true sum, the challenges and the final folded
values against the reference's, and the last claim against the products
of the tables' multilinear extensions at the challenge point.  A folded
value is linear in the table, so the Montgomery table folds to the
Montgomery form of the value's fold.  ``chains`` judges every proof of a
window cheaply, without the tables: the transcripts replayed together,
each round's p(0) + p(1) against the last round's polynomial at its
challenge, and the last round's at its challenge against the program's
final values.
"""

from __future__ import annotations

import numpy as np

from . import field as fl
from .sumcheck import replay
from .transcript import Field, Transcript, TranscriptBatch

NUMBERS = ("rounds", "challenges", "finals", "final_claim", "chains")


def terms(cfg: dict) -> list[tuple[int, ...]]:
    """The products' table indices: consecutive runs of the stated lengths."""
    out, k = [], 0
    for n in cfg["factors_per_product"]:
        out.append(tuple(range(k, k + n)))
        k += n
    return out


def _final(f: Field, cfg: dict, coeffs: list[int], finals_mont: list[int]) -> int:
    """Σ_j c_j · Π_{k∈P_j} a_k at the challenge point, from the folded
    values."""
    out = 0
    for c, term in zip(coeffs, terms(cfg)):
        p = c
        for k in term:
            p = p * f.canon(finals_mont[k]) % f.q
        out += p
    return out % f.q


def check(tables_mont: list[np.ndarray], step: int, proof: dict, cfg: dict,
          coeffs: list[int]) -> dict[str, int]:
    """Counts of disagreements of one proof (all of ``NUMBERS`` but
    ``chains``), all 0 for a right proof.  ``proof`` holds ``evals`` (each
    round's), ``challenges`` and ``finals``, in Montgomery form, as plain
    ints."""
    f = Field(cfg["modulus"], cfg["field_n64"])
    q = f.q
    claim = 0
    for c, term in zip(coeffs, terms(cfg)):
        prod = tables_mont[term[0]] % q
        for k in term[1:]:
            prod = prod * tables_mont[k] % q
        claim += c * (int(prod.sum()) % q) * pow(f.r_inv, len(term), q)
        del prod
    claim %= q

    t = Transcript()
    t.absorb(step.to_bytes(8, "little"))
    nvars = len(tables_mont[0]).bit_length() - 1
    rs, last, bad = replay(t, f, nvars, cfg["degree"], claim, proof["evals"])
    out = dict.fromkeys(NUMBERS[:-1], 0)
    out["rounds"] = bad
    n_tables = len(tables_mont)
    if len(rs) != nvars:
        out.update(challenges=nvars, finals=n_tables, final_claim=1)
        return out
    out["challenges"] = sum(f.mont(r) != m for r, m in zip(rs, proof["challenges"]))
    out["challenges"] += abs(len(rs) - len(proof["challenges"]))
    eq_r = fl.eq_table(rs, q)
    finals = [fl.dot(tab, eq_r, q) for tab in tables_mont]
    out["finals"] = sum(a != b for a, b in zip(finals, proof["finals"]))
    out["finals"] += abs(len(finals) - len(proof["finals"]))
    out["final_claim"] = int(_final(f, cfg, coeffs, finals) != last)
    return out


def chains(steps: list[int], proofs: list[dict], coeffs: list[list[int]], cfg: dict,
           nvars: int) -> list[bool]:
    """For each proof, whether its rounds hold together (see the module's
    notes); a proof of the wrong shape, or with a value that is no residue
    below q, does not."""
    f = Field(cfg["modulus"], cfg["field_n64"])
    q, degree = f.q, cfg["degree"]
    n_tables = sum(cfg["factors_per_product"])

    def shaped(p):
        ev = p["evals"]
        return (len(ev) == nvars and all(len(e) == degree + 1 for e in ev)
                and len(p["challenges"]) == nvars and len(p["finals"]) == n_tables
                and all(0 <= m < q for e in ev for m in e))

    ok = [shaped(p) for p in proofs]
    live = [b for b in range(len(proofs)) if ok[b]]
    if not live:
        return ok
    t = TranscriptBatch(len(live))
    t.absorb([steps[b].to_bytes(8, "little") for b in live])
    t.absorb_field(f, [f.mont(nvars)] * len(live))
    t.absorb_field(f, [f.mont(degree)] * len(live))
    claims = [None] * len(live)
    for rnd in range(nvars):
        for j in range(degree + 1):
            t.absorb_field(f, [proofs[b]["evals"][rnd][j] for b in live])
        rs = t.challenge(f)
        t.absorb_field(f, [f.mont(r) for r in rs])
        for i, (b, r) in enumerate(zip(live, rs)):
            evals = [f.canon(m) for m in proofs[b]["evals"][rnd]]
            if rnd and (evals[0] + evals[1]) % q != claims[i]:
                ok[b] = False
            if f.mont(r) != proofs[b]["challenges"][rnd]:
                ok[b] = False
            claims[i] = fl.interpolate(evals, r, q)
    for i, b in enumerate(live):
        if _final(f, cfg, coeffs[b], proofs[b]["finals"]) != claims[i]:
            ok[b] = False
    return ok
