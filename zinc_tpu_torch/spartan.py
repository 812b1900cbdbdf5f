"""Spartan PIOP over the random field: two sumchecks over a CCS relation.

Mirrors the prover pipeline of zinc/src/zinc/prover.rs:130-303 and
the verifier of zinc/src/zinc/verifier.rs:104-219:

* sumcheck 1 ("linearization"): prove Σ_x eq(β,x)·Σᵢ cᵢ·Π_{j∈Sᵢ} M̃ⱼz(x) = 0
  with β squeezed after absorbing ``b"beta_s"``; degree d+1.
* sumcheck 2: prove Σ_y (Σⱼ γʲ·(eq(r_x)ᵀMⱼ))(y) · z̃(y) = Σⱼ γʲ·V_s[j]
  with γ squeezed after absorbing ``b"gamma"``; degree 2.
* V_s[j] = M̃ⱼz(r_x) closes the loop between the two.
"""

from __future__ import annotations

from dataclasses import dataclass

from .ccs import CCS, Statement
from .fields.config import FieldConfig, Fp
from .poly.mle import DenseMleF, DenseMleZ, build_eq_x_r, build_eq_x_r_vec, eq_eval
from .sparse import compute_eval_table_sparse, mat_vec_mul
from .sumcheck import SumcheckError, prove_as_subprotocol, verify_as_subprotocol
from .transcript import KeccakTranscript


class SpartanError(Exception):
    pass


@dataclass
class SpartanProof:
    linearization_sumcheck: list  # per-round evals
    second_sumcheck: list
    V_s: list  # list[Fp]


@dataclass
class VerificationPoints:
    rx_ry: list  # r_x ‖ r_y
    e_y: Fp
    gamma: Fp


def squeeze_beta_challenges(transcript: KeccakTranscript, n: int, cfg: FieldConfig) -> list[Fp]:
    transcript.absorb(b"beta_s")
    return transcript.get_challenges(n, cfg)


def squeeze_gamma_challenge(transcript: KeccakTranscript, cfg: FieldConfig) -> Fp:
    transcript.absorb(b"gamma")
    return transcript.get_challenge(cfg)


def calculate_mz_mles(
    constraints, s: int, z_ccs: list[Fp], cfg: FieldConfig
) -> list[DenseMleF]:
    mles = []
    for m in constraints:
        mz = mat_vec_mul(m, z_ccs)
        if len(mz) > 1 << s:
            raise SpartanError("Mz longer than 2^s")
        mles.append(DenseMleF(s, mz, cfg))
    return mles


def lin_comb_gamma(gamma: Fp, values: list[Fp]) -> Fp:
    """Σⱼ γʲ·values[j] by Horner from the top."""
    res = gamma.cfg.zero()
    for v in reversed(values):
        res = res * gamma + v
    return res


def spartan_prove(
    statement_f: Statement,
    z_ccs: list[Fp],
    z_mle: DenseMleZ,
    ccs_f: CCS,
    transcript: KeccakTranscript,
    cfg: FieldConfig,
) -> tuple[SpartanProof, list[Fp]]:
    # ---- sumcheck 1 -------------------------------------------------------
    beta_s = squeeze_beta_challenges(transcript, ccs_f.s, cfg)
    mz_mles = calculate_mz_mles(statement_f.constraints, ccs_f.s, z_ccs, cfg)
    eq_beta = build_eq_x_r(beta_s, cfg)
    g_mles = mz_mles + [eq_beta]
    eq_idx = len(mz_mles)
    comb1 = [
        (ci, tuple(ccs_f.S[i]) + (eq_idx,))
        for i, ci in enumerate(ccs_f.c)
        if not ci.is_zero()
    ]
    degree1 = ccs_f.d + 1
    proof1, state1 = prove_as_subprotocol(transcript, g_mles, ccs_f.s, degree1, comb1, cfg)
    r_x = state1.randomness

    # ---- sumcheck 2 -------------------------------------------------------
    gamma = squeeze_gamma_challenge(transcript, cfg)
    eq_rx = build_eq_x_r_vec(r_x)
    evals_vec = [
        compute_eval_table_sparse(m, eq_rx, ccs_f.m, ccs_f.m, cfg)
        for m in statement_f.constraints
    ]
    evals = [
        lin_comb_gamma(gamma, [ev[i] for ev in evals_vec]) for i in range(len(evals_vec[0]))
    ]
    evals_mle = DenseMleF(ccs_f.s_prime, evals, cfg)
    z_mle_f = z_mle.map_to_field(cfg)
    comb2 = [(cfg.one(), (0, 1))]
    proof2, state2 = prove_as_subprotocol(
        transcript, [evals_mle, z_mle_f], ccs_f.s, 2, comb2, cfg
    )
    r_y = state2.randomness

    # ---- V_s --------------------------------------------------------------
    v_s = [mle.evaluate(r_x) for mle in mz_mles]

    return SpartanProof(proof1, proof2, v_s), r_y


def spartan_verify(
    proof: SpartanProof,
    ccs_f: CCS,
    transcript: KeccakTranscript,
    cfg: FieldConfig,
) -> VerificationPoints:
    beta_s = squeeze_beta_challenges(transcript, ccs_f.s, cfg)

    # sumcheck 1: claimed sum is zero
    try:
        sub1 = verify_as_subprotocol(
            transcript, ccs_f.s, ccs_f.d + 1, cfg.zero(), proof.linearization_sumcheck, cfg
        )
    except SumcheckError as e:
        raise SpartanError(f"linearization sumcheck failed: {e}") from e
    r_x, s_val = sub1.point, sub1.expected_evaluation

    # linearization claim: eq(r_x, β)·Σᵢ cᵢ·Π_{j∈Sᵢ} V_s[j] == s_val
    e = eq_eval(r_x, beta_s)
    acc = cfg.zero()
    for i, ci in enumerate(ccs_f.c):
        term = ci
        for j in ccs_f.S[i]:
            term = term * proof.V_s[j]
        acc = acc + term
    if not (e * acc) == s_val:
        raise SpartanError("linearization claim mismatch")

    gamma = squeeze_gamma_challenge(transcript, cfg)
    claim2 = lin_comb_gamma(gamma, proof.V_s)

    try:
        sub2 = verify_as_subprotocol(
            transcript, ccs_f.s_prime, 2, claim2, proof.second_sumcheck, cfg
        )
    except SumcheckError as e:
        raise SpartanError(f"second sumcheck failed: {e}") from e

    return VerificationPoints(rx_ry=r_x + sub2.point, e_y=sub2.expected_evaluation, gamma=gamma)
