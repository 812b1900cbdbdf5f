"""Device sumcheck: round kernels on the device, Fiat-Shamir on the host.

The port of ``zinc_tpu/sumcheck/device_fs.py``.  Each round runs the fold
(K2) and the round evaluation (K3, or K4 for Gruen) on the device, fetches
the round's sums (the one sync of the round), and lets the host
``KeccakTranscript`` absorb the d+1 evaluations and squeeze r, exactly as
``zinc_tpu/sumcheck/prover.py:87-118`` does.  The reference's device-
resident sponge (``ops/keccak_kernel.py``) is not ported.

Gruen (sumcheck 1): the eq MLE never enters the fold.  Round j evaluates
s_j(t) = pref_j · c_j(t) · Σ_i coeff_i · Σ_p E_j[p] · Π_{m∈S_i} M_m(t, p)
with c_j(t) = (1−β_j)(1−t) + β_j·t, pref ratcheted by eq(β_j, r_j), and
E_j the eq table of the unbound suffix β_{j+1..n} in natural order, so
that E_j[p] weighs pair p (the reference builds it bit-reversed for its
layout).  The tail gets the folded eq row pref·E back, so the final values
are those of the classic sumcheck.

Rounds whose table has at most ``HOST_TAIL`` entries finish on the host
with the reference's host prover; transcripts do not depend on the split.

A combination outside K3's scope (a term of 1 or more than 4 factors, more
than 5 points, or more terms than its launch holds), when Gruen does not
apply, goes whole to the generic
tier, ``executor.py`` (``zinc_tpu/sumcheck/device_fs.py:284,332-351``).
"""

from __future__ import annotations

import torch

from ..fields.config import FieldConfig, Fp
from ..sumcheck.prover import _absorb_nvars_degree, _fold, _round_evals
from ..transcript import KeccakTranscript
from ..fields.montgomery import device_field
from ..ops.field_kernels import mont_mul
from ..poly.device import eq_levels, fps_to_limbs, fps_to_tensor, tensor_to_fps
from . import kernels
from .executor import HOST_TAIL, make_executor, prove_with_executor, round_values


def wants_gruen(cfg: FieldConfig, comb, eq_idx: int, b: int) -> bool:
    """True when the Gruen kernel drives this shape: every term carries eq
    last with 1-3 other factors, ≤ 512-bit field, and at least two device
    rounds (so the ratchet and the fold both run)."""
    idx_terms = [tuple(idxs) for _, idxs in comb]
    return kernels.gruen_supported(idx_terms, eq_idx, 2 * cfg.n64) and b > 2 * HOST_TAIL


def _eq_factor(beta: Fp, r: Fp) -> Fp:
    one = beta.cfg.one()
    return (one - beta) * (one - r) + beta * r


def uses_generic(cfg: FieldConfig, comb, degree: int) -> bool:
    """True when the classic rounds send this comb to the generic tier:
    some term is outside K3's scope (``device_fs.py:284``), or the degree
    needs more points than K3 takes."""
    idx_terms = [tuple(idxs) for _, idxs in comb]
    return degree + 1 > kernels.MAX_POINTS or not kernels.classic_supported(
        idx_terms, 2 * cfg.n64, degree + 1)


def prove_as_subprotocol_device(
    transcript: KeccakTranscript,
    cfg: FieldConfig,
    tables: torch.Tensor,  # (n_mles, 2^nvars, n32) Montgomery residues
    nvars: int,
    degree: int,
    comb,
    eq_beta: list[Fp] | None = None,  # Gruen: tables EXCLUDE eq (index n_mles)
):
    """Transcript-identical sumcheck.  Returns (proof, randomness, finals):
    finals are the fully folded values of every MLE (the eq MLE last when
    ``eq_beta`` is given)."""
    ctx = device_field(cfg)
    if ctx.n32 > kernels.MAX_WORDS:
        raise ValueError(f"no round kernels for {ctx.n32}-word fields (at most {kernels.MAX_WORDS})")
    if eq_beta is None and uses_generic(cfg, comb, degree):
        ex = make_executor(cfg, tables, degree, comb)
        proof, randomness = prove_with_executor(transcript, ex, nvars, degree, cfg)
        return proof, randomness, ex.final_values()
    _absorb_nvars_degree(transcript, nvars, degree, cfg)
    n_pts = degree + 1
    b = tables.shape[1]
    assert b == 1 << nvars, (b, nvars)
    idx_terms = [tuple(idxs) for _, idxs in comb]
    coeffs = [c for c, _ in comb]
    gruen = eq_beta is not None
    if gruen:
        if not wants_gruen(cfg, comb, tables.shape[0], b):
            raise ValueError("the Gruen rounds need wants_gruen(); use the classic rounds")
        rests = [t[:-1] for t in idx_terms]
        levels = eq_levels(ctx, fps_to_tensor(eq_beta, cfg, tables.device))
        pref = cfg.one()

    proof: list[list[Fp]] = []
    randomness: list[Fp] = []
    n_dev = 0
    while n_dev < nvars and (b >> n_dev) > HOST_TAIL:
        n_dev += 1

    buf = tables.contiguous()
    for rnd in range(n_dev):
        if rnd > 0:
            buf = kernels.fold(ctx, buf, fps_to_limbs([randomness[-1]], cfg)[0])
            if gruen:
                pref = pref * _eq_factor(eq_beta[rnd - 1], randomness[-1])
        if gruen:
            sums = kernels.round_eval_gruen(ctx, buf, levels[rnd + 1], rests, n_pts)
        else:
            sums = kernels.round_eval(ctx, buf, idx_terms, n_pts)
        gruen_factor = (pref, eq_beta[rnd]) if gruen else None
        evals = round_values(cfg, sums, coeffs, gruen_factor)
        transcript.absorb_field_slice(evals)
        proof.append(evals)
        r = transcript.get_challenge(cfg)
        transcript.absorb_field(r)
        randomness.append(r)

    if n_dev:
        buf = kernels.fold(ctx, buf, fps_to_limbs([randomness[-1]], cfg)[0])
    mles = [tensor_to_fps(buf[i], cfg) for i in range(buf.shape[0])]
    if gruen:
        if n_dev:
            pref = pref * _eq_factor(eq_beta[n_dev - 1], randomness[-1])
        eq_row = mont_mul(ctx, levels[n_dev], fps_to_tensor([pref], cfg, buf.device)[0])
        mles.append(tensor_to_fps(eq_row, cfg))

    for rnd in range(n_dev, nvars):
        if rnd > n_dev:
            mles = _fold(mles, randomness[-1])
        evals = _round_evals(mles, degree, comb, cfg)
        transcript.absorb_field_slice(evals)
        proof.append(evals)
        r = transcript.get_challenge(cfg)
        transcript.absorb_field(r)
        randomness.append(r)
    if nvars > n_dev:
        mles = _fold(mles, randomness[-1])
    return proof, randomness, [m[0] for m in mles]
