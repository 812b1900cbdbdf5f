"""The port's sumcheck (K2-K4 plain versions and the round loop) against the JAX
package: its XLA twins of the Pallas round kernels (decoded round values
and folded tables, not G planes) and its host prover, whose transcripts
must come out byte-identical.  Exact equality throughout."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zinc_tpu.fields.config import FieldConfig as JFieldConfig
from zinc_tpu.fields.montgomery import device_field as j_device_field
from zinc_tpu.poly.device import fps_to_limbs as j_fps_to_limbs
from zinc_tpu.poly.mle import DenseMleF as JDenseMleF
from zinc_tpu.poly.mle import build_eq_x_r as j_build_eq_x_r
from zinc_tpu.sumcheck.mxu_exec import (
    TILE,
    _from_lm,
    _to_lm,
    build_eq_suffix_flat,
    eval_lm_gruen_ref,
    eval_lm_ref,
    fold_lm_ref,
    g_to_evals_host,
    gruen_g_to_evals_host,
    gruen_term_meta,
    term_meta,
)
from zinc_tpu.sumcheck.prover import prove_as_subprotocol as j_prove
from zinc_tpu.transcript import KeccakTranscript as JKeccakTranscript
from zinc_tpu_torch.fields.config import FieldConfig
from zinc_tpu_torch.sumcheck.prover import _fold, _round_evals
from zinc_tpu_torch.transcript import KeccakTranscript
from zinc_tpu_torch.fields import montgomery as fm
from zinc_tpu_torch.fields.montgomery import device_field
from zinc_tpu_torch.poly.device import eq_levels, fps_to_tensor
from zinc_tpu_torch.sumcheck import kernels
from zinc_tpu_torch.sumcheck.device import prove_as_subprotocol_device, round_values

Q = (1 << 255) + 95
CFG, JCFG = FieldConfig(Q, 4), JFieldConfig(Q, 4)


def _tables(cfg, b: int, n: int, seed: int) -> list[list[int]]:
    rng = random.Random(seed)
    return [[rng.randrange(cfg.q) for _ in range(b)] for _ in range(n)]


def _port_tables(cfg, vals) -> torch.Tensor:
    return torch.stack([fm.to_tensor(fm.ints_to_words(v, 2 * cfg.n64)) for v in vals])


def _jax_lm(jcfg, vals, b):
    return _to_lm(jnp.asarray(np.stack([fm.to_jax_limbs(fm.ints_to_words(v, 2 * jcfg.n64))
                                        for v in vals])), b)


def _jfps(jcfg, vals):
    return [jcfg.fp_from_mont(v) for v in vals]


def test_fold_matches_twin_and_host():
    b = 4 * TILE * 2
    vals = _tables(CFG, b, 3, 0)
    r = random.Random(1).randrange(Q)
    got = kernels.fold(device_field(CFG), _port_tables(CFG, vals), fm.int_to_words(r, 8))
    got_ints = [fm.words_to_ints(fm.to_numpy(got[i])) for i in range(3)]
    buf = fold_lm_ref(j_device_field(JCFG), _jax_lm(JCFG, vals, b),
                      jnp.asarray(j_fps_to_limbs([JCFG.fp_from_mont(r)], JCFG)[0]), b // (4 * TILE))
    twin = np.asarray(_from_lm(buf, b // 2))
    assert got_ints == [fm.words_to_ints(fm.from_jax_limbs(twin[i])) for i in range(3)]
    host = _fold([[CFG.fp_from_mont(v) for v in t] for t in vals], CFG.fp_from_mont(r))
    assert got_ints == [[x.m for x in t] for t in host]


@pytest.mark.parametrize(
    "idx_terms,degree,coeffs",
    [(((0, 3), (1, 3), (2, 3)), 3, (1, 1, 1)), (((0, 1), (2, 1)), 2, (1, -1)),
     (((0, 1, 2, 3), (1, 2, 3)), 4, (5, -1))],
    ids=["3x2-factor", "2-factor", "4-factor-deg4"],
)
def test_classic_round_eval_matches_twin(idx_terms, degree, coeffs):
    b = 2 * TILE * 2
    vals = _tables(CFG, b, 4, 2)
    comb = [(CFG.fp(c), t) for c, t in zip(coeffs, idx_terms)]
    sums = kernels.round_eval(device_field(CFG), _port_tables(CFG, vals), list(idx_terms), degree + 1)
    got = [x.m for x in round_values(CFG, sums, [c for c, _ in comb])]

    jcomb = [(JCFG.fp(c), t) for c, t in zip(coeffs, idx_terms)]
    terms = term_meta(idx_terms, JCFG.n16)
    gs = eval_lm_ref(j_device_field(JCFG), _jax_lm(JCFG, vals, b), terms, b // (2 * TILE))
    twin = g_to_evals_host(JCFG, [np.asarray(g) for g in gs], jcomb, terms, degree)
    assert got == [x.m for x in twin]
    host = _round_evals([[CFG.fp_from_mont(v) for v in t] for t in vals], degree, comb, CFG)
    assert got == [x.m for x in host]


def test_gruen_round_eval_matches_twin():
    nv = 11
    b = 1 << nv
    vals = _tables(CFG, b, 3, 3)
    rng = random.Random(4)
    beta = [rng.randrange(Q) for _ in range(nv)]
    idx_terms = ((0, 1, 2, 3), (0, 3))  # a 3-factor rest and a 1-factor rest
    degree = 4
    comb = [(CFG.fp(3), idx_terms[0]), (CFG.one(), idx_terms[1])]
    ctx = device_field(CFG)
    levels = eq_levels(ctx, fps_to_tensor([CFG.fp_from_mont(x) for x in beta], CFG, "cpu"))
    sums = kernels.round_eval_gruen(ctx, _port_tables(CFG, vals), levels[1],
                                    [t[:-1] for t in idx_terms], degree + 1)
    got = [x.m for x in round_values(CFG, sums, [c for c, _ in comb],
                                     (CFG.one(), CFG.fp_from_mont(beta[0])))]

    jctx = j_device_field(JCFG)
    terms = gruen_term_meta(idx_terms, 3, JCFG.n16)
    jbeta = _jfps(JCFG, beta)
    e_flat = build_eq_suffix_flat(jctx, jnp.asarray(j_fps_to_limbs(jbeta, JCFG)), nv)
    gs = eval_lm_gruen_ref(jctx, _jax_lm(JCFG, vals, b), e_flat, terms, b // (2 * TILE), 0)
    jcomb = [(JCFG.fp(3), idx_terms[0]), (JCFG.one(), idx_terms[1])]
    twin = gruen_g_to_evals_host(JCFG, gs, jcomb, terms, degree, jbeta[0], JCFG.one())
    assert got == [x.m for x in twin]
    # the suffix levels equal the eq tables of the β suffixes
    eq1 = j_build_eq_x_r(jbeta[1:], JCFG).evaluations
    assert fm.words_to_ints(fm.to_numpy(levels[1])) == [x.m for x in eq1]


def test_round_evals_192bit_match_twins():
    """K3 and K4's plain versions over a 192-bit field (n64 = 3, 6 words),
    against the XLA twins as above: every term of 1-3 factors before eq, and
    points that the kernels extend by finite differences."""
    q = (1 << 191) + 5
    cfg, jcfg = FieldConfig(q, 3), JFieldConfig(q, 3)
    ctx, jctx = device_field(cfg), j_device_field(jcfg)
    b = 2 * TILE * 2
    vals = _tables(cfg, b, 4, 10)
    idx_terms, coeffs, degree = ((0, 1, 2, 3), (1, 2, 3)), (5, -1), 4
    sums = kernels.round_eval(ctx, _port_tables(cfg, vals), list(idx_terms), degree + 1)
    got = [x.m for x in round_values(cfg, sums, [cfg.fp(c) for c in coeffs])]
    terms = term_meta(idx_terms, jcfg.n16)
    gs = eval_lm_ref(jctx, _jax_lm(jcfg, vals, b), terms, b // (2 * TILE))
    jcomb = [(jcfg.fp(c), t) for c, t in zip(coeffs, idx_terms)]
    assert got == [x.m for x in g_to_evals_host(jcfg, [np.asarray(g) for g in gs], jcomb, terms, degree)]

    nv = 11
    vals = _tables(cfg, 1 << nv, 3, 11)
    beta = [random.Random(12).randrange(q) for _ in range(nv)]
    idx_terms = ((0, 1, 2, 3), (2, 3), (0, 1, 3))
    comb = [(cfg.fp(3), idx_terms[0]), (cfg.one(), idx_terms[1]), (cfg.fp(-2), idx_terms[2])]
    levels = eq_levels(ctx, fps_to_tensor([cfg.fp_from_mont(x) for x in beta], cfg, "cpu"))
    sums = kernels.round_eval_gruen(ctx, _port_tables(cfg, vals), levels[1],
                                    [t[:-1] for t in idx_terms], degree + 1)
    got = [x.m for x in round_values(cfg, sums, [c for c, _ in comb],
                                     (cfg.one(), cfg.fp_from_mont(beta[0])))]
    gterms = gruen_term_meta(idx_terms, 3, jcfg.n16)
    jbeta = _jfps(jcfg, beta)
    e_flat = build_eq_suffix_flat(jctx, jnp.asarray(j_fps_to_limbs(jbeta, jcfg)), nv)
    gs = eval_lm_gruen_ref(jctx, _jax_lm(jcfg, vals, 1 << nv), e_flat, gterms, (1 << nv) // (2 * TILE), 0)
    jcomb = [(jcfg.fp(3), idx_terms[0]), (jcfg.one(), idx_terms[1]), (jcfg.fp(-2), idx_terms[2])]
    assert got == [x.m for x in gruen_g_to_evals_host(jcfg, gs, jcomb, gterms, degree, jbeta[0],
                                                      jcfg.one())]


def _run_both(cfg, jcfg, vals, nvars, degree, comb_spec, beta=None):
    """The port's sumcheck and the JAX package's host prover on the same
    tables; returns both (proof, randomness, finals, next challenge) as ints."""
    comb = [(cfg.fp(c), t) for c, t in comb_spec]
    jcomb = [(jcfg.fp(c), t) for c, t in comb_spec]
    t = KeccakTranscript()
    t.absorb(b"sumcheck-test")
    eq_beta = [cfg.fp_from_mont(x) for x in beta] if beta is not None else None
    proof, rnd, finals = prove_as_subprotocol_device(
        t, cfg, _port_tables(cfg, vals), nvars, degree, comb, eq_beta=eq_beta
    )
    port = ([[x.m for x in e] for e in proof], [x.m for x in rnd], [x.m for x in finals],
            t.get_challenge(cfg).m)

    jt = JKeccakTranscript()
    jt.absorb(b"sumcheck-test")
    jmles = [JDenseMleF(nvars, _jfps(jcfg, v), jcfg) for v in vals]
    if beta is not None:
        jmles.append(j_build_eq_x_r(_jfps(jcfg, beta), jcfg))
    jproof, state = j_prove(jt, jmles, nvars, degree, jcomb, jcfg)
    host = ([[x.m for x in e] for e in jproof], [x.m for x in state.randomness],
            [m.evaluations[0].m for m in state.mles], jt.get_challenge(jcfg).m)
    return port, host


@pytest.mark.parametrize("nvars", [10, 12])
def test_gruen_sumcheck1_matches_host_prover(nvars):
    """Sumcheck 1 of the dummy R1CS: A·B·eq − C·eq, degree 3, Gruen."""
    vals = _tables(CFG, 1 << nvars, 3, 5)
    beta = [random.Random(6).randrange(Q) for _ in range(nvars)]
    port, host = _run_both(CFG, JCFG, vals, nvars, 3, [(1, (0, 1, 3)), (-1, (2, 3))], beta)
    assert port == host


@pytest.mark.parametrize("nvars", [10, 11])
def test_classic_sumcheck2_matches_host_prover(nvars):
    """Sumcheck 2: the γ-combined table times z, degree 2."""
    vals = _tables(CFG, 1 << nvars, 2, 7)
    port, host = _run_both(CFG, JCFG, vals, nvars, 2, [(1, (0, 1))])
    assert port == host


def test_sumcheck_384bit_field():
    cfg6, jcfg6 = FieldConfig((1 << 383) + 369, 6), JFieldConfig((1 << 383) + 369, 6)
    nvars = 9
    vals = _tables(cfg6, 1 << nvars, 3, 8)
    beta = [random.Random(9).randrange(cfg6.q) for _ in range(nvars)]
    port, host = _run_both(cfg6, jcfg6, vals, nvars, 3, [(1, (0, 1, 3)), (-1, (2, 3))], beta)
    assert port == host
    port, host = _run_both(cfg6, jcfg6, vals[:2], nvars, 2, [(1, (0, 1))])
    assert port == host
