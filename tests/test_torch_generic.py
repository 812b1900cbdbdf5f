"""The port's generic sumcheck tier against the JAX package: the plain
versions of ``round_eval_generic`` and ``fold_round_eval`` against the XLA
round body (``zinc_tpu/sumcheck/device.py:_round_body``), the sumcheck and
the executor against the JAX provers, and path A, a degree-4 CCS whose
sumcheck 1 runs on the generic tier, end to end.  Exact equality
throughout."""

import hashlib
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import zinc_tpu_torch as zt
from tests.test_torch_sumcheck import _run_both
from zinc_tpu.fields.config import FieldConfig as JFieldConfig
from zinc_tpu.fields.limbs import limbs_to_int
from zinc_tpu.fields.montgomery import device_field as j_device_field
from zinc_tpu.poly.device import fps_to_limbs as j_fps_to_limbs
from zinc_tpu.sumcheck.device import DeviceSumcheckExecutor as JExecutor
from zinc_tpu.sumcheck.device import _round_kernel
from zinc_tpu.sumcheck.device import prove_as_subprotocol_device as j_prove_with_executor
from zinc_tpu_torch.fields.config import FieldConfig
from zinc_tpu_torch.sumcheck.verifier import verify_as_subprotocol
from zinc_tpu_torch.transcript import KeccakTranscript
from zinc_tpu_torch.fields import montgomery as fm
from zinc_tpu_torch.fields.montgomery import device_field
from zinc_tpu_torch.sumcheck import device as sdev
from zinc_tpu_torch.sumcheck import kernels
from zinc_tpu_torch.sumcheck.executor import make_executor, prove_with_executor, round_values

Q, Q192, Q384, Q512 = (1 << 255) + 95, (1 << 191) + 5, (1 << 383) + 369, (1 << 511) + 187
GENERIC_COEFF = 0x1234_5678_9ABC_DEF0_1357_9BDF_2468_ACE0
SPARTAN_A = [(1, (0, 1, 2, 3, 5)), (-1, (4, 5))]  # path A's sumcheck 1, degree 5

# (q, n64, n_tables, comb spec, degree)
ROUND_CASES = {
    "7-factor-deg7": (Q, 4, 7, [(1, tuple(range(7)))], 7),
    "spartan-deg5": (Q, 4, 6, SPARTAN_A, 5),
    "1-factor-generic-coeff": (Q, 4, 4, [(GENERIC_COEFF, (2,)), (-1, (0, 1, 3))], 3),
    "384-bit": (Q384, 6, 5, [(3, (0, 1, 2, 3, 4)), (GENERIC_COEFF, (4,))], 5),
    # k + 1 < n_pts: a term of two factors and one of one, extended to 6 points
    "extended-terms": (Q, 4, 3, [(1, (0, 1)), (-1, (2,))], 5),
    # n_pts ≤ k: the three points of a 5-factor term evaluated directly
    "direct-points": (Q, 4, 5, [(1, (0, 1, 2, 3, 4)), (2, (1, 3, 4))], 2),
    "192-bit": (Q192, 3, 4, [(1, (0, 1, 2)), (GENERIC_COEFF, (3,))], 4),
    "512-bit": (Q512, 8, 3, [(1, (0, 1, 2, 1)), (-1, (2, 0))], 4),
}


def _tables(q: int, b: int, n: int, seed: int) -> list[list[int]]:
    rng = random.Random(seed)
    return [[rng.randrange(q) for _ in range(b)] for _ in range(n)]


def _port_tables(cfg, vals) -> torch.Tensor:
    return torch.stack([fm.to_tensor(fm.ints_to_words(v, 2 * cfg.n64)) for v in vals])


def _port_ints(cfg, tables: torch.Tensor) -> list[list[int]]:
    return [fm.words_to_ints(fm.to_numpy(t)) for t in tables]


def _jax_round(jcfg, vals, r: int, spec, degree: int, first: bool):
    """``_round_body`` on the natural-order tables, decoded as the JAX
    ``DeviceSumcheckExecutor.round`` decodes it; returns (tables as ints,
    round values as Montgomery ints)."""
    jctx = j_device_field(jcfg)
    tabs = jnp.asarray(np.stack([fm.to_jax_limbs(fm.ints_to_words(v, 2 * jcfg.n64)) for v in vals]))
    rl = jnp.asarray(j_fps_to_limbs([jcfg.fp_from_mont(r)], jcfg)[0])
    coeffs = jnp.asarray(j_fps_to_limbs([jcfg.fp(c) for c, _ in spec], jcfg))
    out, wide = _round_kernel(jctx, tabs, (rl, coeffs), first, degree, tuple(t for _, t in spec))
    wide = np.asarray(wide)
    evals = [limbs_to_int(wide[t]) % jcfg.q for t in range(wide.shape[0])]
    out = np.asarray(out)
    return [fm.words_to_ints(fm.from_jax_limbs(out[i])) for i in range(out.shape[0])], evals


def _port_values(cfg, sums, spec) -> list[int]:
    return [x.m for x in round_values(cfg, sums, [cfg.fp(c) for c, _ in spec])]


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_generic_eval_plain_matches_xla_round_body(case):
    q, n64, n_tab, spec, degree = ROUND_CASES[case]
    cfg, jcfg = FieldConfig(q, n64), JFieldConfig(q, n64)
    vals = _tables(q, 1 << 8, n_tab, 10)
    sums = kernels.round_eval_generic(device_field(cfg), _port_tables(cfg, vals),
                                      [t for _, t in spec], degree + 1)
    _, want = _jax_round(jcfg, vals, 0, spec, degree, first=True)
    assert _port_values(cfg, sums, spec) == want


@pytest.mark.parametrize("case", ["7-factor-deg7", "spartan-deg5", "384-bit", "direct-points",
                                  "192-bit", "512-bit"])
def test_fused_fold_eval_plain_matches_xla_round_body(case):
    q, n64, n_tab, spec, degree = ROUND_CASES[case]
    cfg, jcfg = FieldConfig(q, n64), JFieldConfig(q, n64)
    vals = _tables(q, 1 << 9, n_tab, 11)
    r = random.Random(12).randrange(q)
    folded, sums = kernels.fold_round_eval(device_field(cfg), _port_tables(cfg, vals),
                                           fm.int_to_words(r, 2 * n64), [t for _, t in spec],
                                           degree + 1)
    want_tabs, want = _jax_round(jcfg, vals, r, spec, degree, first=False)
    assert _port_ints(cfg, folded) == want_tabs
    assert _port_values(cfg, sums, spec) == want


@pytest.mark.parametrize("nvars", [10, 11])
def test_generic_sumcheck_matches_host_prover(nvars):
    """Path A's sumcheck 1 (5 Mz tables and eq, degree 5) through the port's
    ``prove_as_subprotocol_device``, which sends it to the generic tier."""
    cfg, jcfg = FieldConfig(Q, 4), JFieldConfig(Q, 4)
    assert sdev.uses_generic(cfg, [(cfg.fp(c), t) for c, t in SPARTAN_A], 5)
    vals = _tables(Q, 1 << nvars, 6, 13)
    port, host = _run_both(cfg, jcfg, vals, nvars, 5, SPARTAN_A)
    assert port == host


def test_executor_matches_jax_executor():
    """Path B's shape at nv 9: a product of 7 tables, degree 7, through the
    executor and its round loop, against the JAX ``DeviceSumcheckExecutor`` on
    XLA; the host verifier accepts and its subclaim is the product of the
    final values."""
    nv, n_fac = 9, 7
    cfg, jcfg = FieldConfig(Q, 4), JFieldConfig(Q, 4)
    vals = _tables(Q, 1 << nv, n_fac, 14)
    ex = make_executor(cfg, _port_tables(cfg, vals), n_fac, [(cfg.one(), tuple(range(n_fac)))])
    proof, rnd = prove_with_executor(KeccakTranscript(), ex, nv, n_fac, cfg)
    finals = ex.final_values()

    from zinc_tpu.transcript import KeccakTranscript as JKeccakTranscript

    jtabs = jnp.asarray(np.stack([fm.to_jax_limbs(fm.ints_to_words(v, 8)) for v in vals]))
    jex = JExecutor(jcfg, jtabs, n_fac, [(jcfg.one(), tuple(range(n_fac)))])
    jproof, jrnd = j_prove_with_executor(JKeccakTranscript(), jex, nv, n_fac, jcfg)
    assert [[x.m for x in e] for e in proof] == [[x.m for x in e] for e in jproof]
    assert [x.m for x in rnd] == [x.m for x in jrnd]
    assert [x.m for x in finals] == [x.m for x in jex.final_values()]

    claimed = cfg.zero()
    for col in zip(*vals):
        prod = cfg.one()
        for v in col:
            prod = prod * cfg.fp_from_mont(v)
        claimed = claimed + prod
    sub = verify_as_subprotocol(KeccakTranscript(), nv, n_fac, claimed, proof, cfg)
    expected = cfg.one()
    for v in finals:
        expected = expected * v
    assert sub.expected_evaluation == expected


def _count_calls(monkeypatch, names, tables_seen=None):
    """Spies on the round kernels' wrappers: counts the calls of each, and
    appends the shape of each call's tables to ``tables_seen``."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(kernels, name)

        def spy(ctx, tables, *a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            if tables_seen is not None:
                tables_seen.append((_name, tuple(tables.shape)))
            return _fn(ctx, tables, *a, **k)

        monkeypatch.setattr(kernels, name, spy)
    return calls


ROUND_FNS = ("round_eval", "round_eval_gruen", "round_eval_generic", "fold_round_eval")


def _jax_path_a_proof(n: int, seed: int) -> bytes:
    from zinc_tpu import ccs as jccs
    from zinc_tpu.prime import draw_random_field
    from zinc_tpu.serialize import serialize_proof
    from zinc_tpu.transcript import KeccakTranscript as JKeccakTranscript
    from zinc_tpu.zinc import ZincProver
    from zinc_tpu.zip.code import ZipTypes

    ccs, statement, wit = chip_smoke.degree4_fixture(n, seed, jccs)
    t = JKeccakTranscript()
    cfg = draw_random_field(statement.public_input, t, 1, 4)
    return serialize_proof(ZincProver(ZipTypes(1), backend="host").prove(statement, wit, t, ccs, cfg),
                           cfg)


@pytest.mark.parametrize("log_n", [8, 10])
def test_path_a_matches_jax_host_prover(monkeypatch, log_n):
    """The degree-4 CCS z⁴ − z³·z = 0: the port's proof bytes equal the JAX
    host prover's, sumcheck 1 ran on the generic tier, the port's verifier
    accepts and rejects the V_s[0] + 1 tamper; at 2^10 the bytes hash to the
    digest chip_smoke.py holds the card's proof to."""
    seed = 1234
    ccs, statement, wit = chip_smoke.degree4_fixture(1 << log_n, seed)
    seen = []
    calls = _count_calls(monkeypatch, ROUND_FNS, seen)
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, 1, 4)
    proof = zt.ZincProver(zt.ZipTypes(1), device="cpu").prove(statement, wit, t, ccs, cfg)
    blob = zt.serialize_proof(proof, cfg)
    assert calls["round_eval_generic"] == 1 and calls["fold_round_eval"] > 0
    # sumcheck 1 stacks the five Mz tables and eq(β): Gruen does not apply
    assert ("round_eval_generic", (6, 1 << log_n, 8)) in seen
    assert calls["round_eval_gruen"] == 0 and calls["round_eval"] > 0  # sumcheck 2 stays on K3

    want = _jax_path_a_proof(1 << log_n, seed)
    assert blob == want
    if log_n == 10:
        assert hashlib.sha256(want).hexdigest() == chip_smoke.PATH_A_SHA256_2P10

    verifier = zt.ZincVerifier(zt.ZipTypes(1), device="cpu")
    verifier.verify(statement, zt.deserialize_proof(blob, cfg), zt.KeccakTranscript(), ccs, cfg)
    assert len(proof.spartan_proof.V_s) == 5
    bad = zt.deserialize_proof(blob, cfg)
    bad.spartan_proof.V_s[0] = bad.spartan_proof.V_s[0] + cfg.one()
    with pytest.raises(zt.ZincError):
        verifier.verify(statement, bad, zt.KeccakTranscript(), ccs, cfg)


def test_path_a_sumcheck1_stacks_eq():
    """Gruen does not apply to path A, so sumcheck 1 stacks the five Mz
    tables and eq(β) (t + 1 = 6) and goes to the generic tier."""
    cfg = FieldConfig(Q, 4)
    comb = [(cfg.fp(c), t) for c, t in SPARTAN_A]
    assert not sdev.wants_gruen(cfg, comb, 5, 1 << 20)
    assert sdev.uses_generic(cfg, comb, 5)


def test_r1cs_route_is_unchanged(monkeypatch):
    """The dummy R1CS keeps its kernels: sumcheck 1 on Gruen (K4), sumcheck
    2 on K3, nothing on the generic tier (``test_torch_e2e.py`` pins its
    bytes)."""
    cfg = FieldConfig(Q, 4)
    comb1 = [(cfg.one(), (0, 1, 3)), (cfg.fp(-1), (2, 3))]
    assert sdev.wants_gruen(cfg, comb1, 3, 1 << 8)
    assert not sdev.uses_generic(cfg, [(cfg.one(), (0, 1))], 2)
    calls = _count_calls(monkeypatch, ROUND_FNS)
    _, ccs, statement, wit = zt.dummy_ccs_of_size(1 << 8, random.Random(99), int_bits=62)
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, 1, 4)
    zt.ZincProver(zt.ZipTypes(1), device="cpu").prove(statement, wit, t, ccs, cfg)
    assert calls["round_eval_gruen"] > 0 and calls["round_eval"] > 0
    assert calls["round_eval_generic"] == 0 and calls["fold_round_eval"] == 0


def test_bench_sumcheck_runs_on_the_cpu():
    """Path B's entry point at nv 8 on CPU tables: the host verifier accepts
    (``run`` raises otherwise), the timed prove launched no kernel (the
    wrappers took their plain versions), and the claimed sum is the product
    summed over Python ints."""
    from zinc_tpu_torch.benches import bench_sumcheck as bs

    res = bs.run(8, "cpu", seed=3)
    assert res["accepted"] and not any(res["launches"].values())
    cfg = FieldConfig(bs.Q, 4)
    tabs = bs.random_tables(cfg, 8, bs.N_FACTORS, 3, "cpu")
    want = cfg.zero()
    for col in zip(*_port_ints(cfg, tabs)):
        prod = cfg.one()
        for v in col:
            prod = prod * cfg.fp_from_mont(v)
        want = want + prod
    assert bs.claimed_sum(cfg, tabs) == want


def test_fields_over_512_bits_are_refused():
    """The port has no kernel width above 16 words: a 576-bit field raises
    rather than falling back."""
    cfg = FieldConfig((1 << 575) + 1515, 9)
    vals = _tables(cfg.q, 1 << 8, 2, 15)
    with pytest.raises(ValueError):
        sdev.prove_as_subprotocol_device(KeccakTranscript(), cfg, _port_tables(cfg, vals), 8, 2,
                                         [(cfg.one(), (0, 1))])
