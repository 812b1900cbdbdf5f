"""The port's host protocol held against the JAX package: the host sumcheck
(tests/test_sumcheck.py: ``zinc_tpu_torch/sumcheck/prover.py`` +
``verifier.py``), host Spartan and the CCS relation (tests/test_spartan.py:
``spartan.py``, ``ccs/``, ``sparse.py``) and the randomized end-to-end
instances of tests/test_property_e2e.py through the port's host backend
(``ZincProver``/``ZincVerifier(backend="host")``).  The same seeded inputs
go through both packages; proofs are compared as ints and bytes, and every
rejection must raise the port's own error class."""

import random
from types import SimpleNamespace

import pytest

import zinc_tpu.ccs as jccs
import zinc_tpu.sumcheck as jsc
import zinc_tpu_torch as zt
import zinc_tpu_torch.ccs as ccs
import zinc_tpu_torch.sumcheck as sc
from zinc_tpu import spartan as jspartan
from zinc_tpu.fields.config import FieldConfig as JFieldConfig
from zinc_tpu.poly import mle as jmle
from zinc_tpu.prime import draw_random_field as j_draw_random_field
from zinc_tpu.serialize import serialize_proof as j_serialize_proof
from zinc_tpu.sparse import evaluate_mle as j_evaluate_mle
from zinc_tpu.transcript import KeccakTranscript as JKeccakTranscript
from zinc_tpu.zinc import ZincProver as JZincProver
from zinc_tpu.zip.code import ZipTypes as JZipTypes
from zinc_tpu_torch import spartan
from zinc_tpu_torch.fields.config import FieldConfig
from zinc_tpu_torch.poly import mle
from zinc_tpu_torch.sparse import evaluate_mle
from zinc_tpu_torch.transcript import KeccakTranscript

Q128 = 312829638388039969874974628075306023441
PORT = SimpleNamespace(cfg=FieldConfig(Q128, 3), mle=mle, sc=sc, T=KeccakTranscript, ccs=ccs,
                       spartan=spartan)
JAX = SimpleNamespace(cfg=JFieldConfig(Q128, 3), mle=jmle, sc=jsc, T=JKeccakTranscript, ccs=jccs,
                      spartan=jspartan)
CFG = PORT.cfg


def _ints(rounds) -> list:
    """A proof's rounds (or a list of field elements) as ints."""
    return [_ints(r) if isinstance(r, (list, tuple)) else r.to_int() for r in rounds]


# ---------------------------------------------------------------------------
# the host sumcheck (tests/test_sumcheck.py)
# ---------------------------------------------------------------------------


def _rand_product_poly(pkg, nv, num_multiplicands_range, num_products, rng):
    """A random sum of products of MLEs: (mles, degree, comb, claimed sum)."""
    cfg = pkg.cfg
    mles, comb, total, degree, idx = [], [], cfg.zero(), 0, 0
    for _ in range(num_products):
        k = rng.randrange(*num_multiplicands_range)
        degree = max(degree, k)
        coeff = cfg.fp(rng.randrange(cfg.q))
        tables = [[cfg.fp(rng.randrange(cfg.q)) for _ in range(1 << nv)] for _ in range(k)]
        psum = cfg.zero()
        for b in range(1 << nv):
            t = cfg.one()
            for tab in tables:
                t = t * tab[b]
            psum = psum + t
        total = total + coeff * psum
        mles.extend(pkg.mle.DenseMleF(nv, t, cfg) for t in tables)
        comb.append((coeff, tuple(range(idx, idx + k))))
        idx += k
    return mles, degree, comb, total


def _prove(pkg, nv=5, seed=0, num_products=3):
    mles, degree, comb, total = _rand_product_poly(pkg, nv, (2, 4), num_products, random.Random(seed))
    proof, state = pkg.sc.prove_as_subprotocol(pkg.T(), mles, nv, degree, comb, pkg.cfg)
    return mles, degree, comb, total, proof, state


@pytest.fixture(scope="module")
def proved():
    """The port's proof of the seed-0 instance, checked equal to the JAX
    package's (every round's evaluations and the prover's randomness)."""
    port, ref = _prove(PORT), _prove(JAX)
    assert _ints(port[4]) == _ints(ref[4])
    assert _ints(port[5].randomness) == _ints(ref[5].randomness)
    return port


def test_sumcheck_roundtrip(proved):
    mles, degree, comb, total, proof, state = proved
    sub = sc.verify_as_subprotocol(KeccakTranscript(), 5, degree, total, proof, CFG)
    vals = [m.evaluate(sub.point) for m in mles]
    acc = CFG.zero()
    for coeff, idxs in comb:
        term = coeff
        for j in idxs:
            term = term * vals[j]
        acc = acc + term
    assert acc == sub.expected_evaluation
    assert state.randomness == sub.point
    jsub = jsc.verify_as_subprotocol(JKeccakTranscript(), 5, degree, JAX.cfg.fp(total.to_int()),
                                     [[JAX.cfg.fp(v) for v in r] for r in _ints(proof)], JAX.cfg)
    assert _ints(sub.point) == _ints(jsub.point)
    assert sub.expected_evaluation.to_int() == jsub.expected_evaluation.to_int()


def _rejects(proved, match, transcript=None, total_delta=0, proof=None, degree_delta=0):
    """The port's verifier raises its SumcheckError, from the branch that
    ``match`` names."""
    _, degree, _, total, good, _ = proved
    with pytest.raises(sc.SumcheckError, match=match):
        sc.verify_as_subprotocol(transcript or KeccakTranscript(), 5, degree + degree_delta,
                                 total + CFG.fp(total_delta), good if proof is None else proof, CFG)


def test_sumcheck_wrong_sum_rejected(proved):
    _rejects(proved, r"round 0: p\(0\)\+p\(1\)", total_delta=1)


def test_sumcheck_tampered_message_rejected(proved):
    proof = [list(r) for r in proved[4]]
    proof[2][1] = proof[2][1] + CFG.one()
    _rejects(proved, r"round 2: p\(0\)\+p\(1\)", proof=proof)


def test_sumcheck_tampered_transcript_rejected(proved):
    vt = KeccakTranscript()
    vt.absorb(b"extra bytes the prover never saw")
    _rejects(proved, r"round 1: p\(0\)\+p\(1\)", transcript=vt)


def test_sumcheck_incomplete_proof_rejected(proved):
    _rejects(proved, "invalid proof length", proof=proved[4][:-1])


@pytest.mark.parametrize("delta", [1, -1])
def test_sumcheck_wrong_degree_rejected(proved, delta):
    _rejects(proved, "max degree exceeded", degree_delta=delta)


def test_sumcheck_determinism():
    *_, proof1, s1 = _prove(PORT, seed=7)
    *_, proof2, s2 = _prove(PORT, seed=7)
    assert proof1 == proof2 and s1.randomness == s2.randomness
    assert _ints(proof1) == _ints(_prove(JAX, seed=7)[4])


def test_extract_sum(proved):
    assert proved[4][0][0] + proved[4][0][1] == proved[3]


def test_interpolate_uni_poly():
    def p(cfg, x):
        return cfg.fp(3) * x * x * x + x + cfg.fp(7)

    evals = [p(CFG, CFG.fp(i)) for i in range(4)]
    jevals = [JAX.cfg.fp(v.to_int()) for v in evals]
    rng = random.Random(3)
    for _ in range(20):
        x = rng.randrange(CFG.q)
        got = sc.interpolate_uni_poly(evals, CFG.fp(x))
        assert got == p(CFG, CFG.fp(x))
        assert got.to_int() == jsc.interpolate_uni_poly(jevals, JAX.cfg.fp(x)).to_int()
    assert sc.interpolate_uni_poly(evals, CFG.fp(2)) == evals[2]  # the node's early exit
    # more nodes than the factorial ratios' small case, at a node and off one
    evals9 = [CFG.fp(random.Random(i).randrange(CFG.q)) for i in range(9)]
    for x in (4, 123456789):
        assert sc.interpolate_uni_poly(evals9, CFG.fp(x)).to_int() == jsc.interpolate_uni_poly(
            [JAX.cfg.fp(v.to_int()) for v in evals9], JAX.cfg.fp(x)).to_int()


def test_eq_table_and_eval():
    rng = random.Random(5)
    r = [rng.randrange(CFG.q) for _ in range(4)]
    table = mle.build_eq_x_r_vec([CFG.fp(v) for v in r])
    assert _ints(table) == _ints(jmle.build_eq_x_r_vec([JAX.cfg.fp(v) for v in r]))
    one, zero = CFG.one(), CFG.zero()
    for i in range(16):
        x = [one if (i >> j) & 1 else zero for j in range(4)]
        assert mle.eq_eval(x, [CFG.fp(v) for v in r]) == table[i]
    acc = CFG.zero()
    for v in table:
        acc = acc + v
    assert acc == one


def test_zero_vars_sumcheck():
    proof, _ = sc.prove_as_subprotocol(KeccakTranscript(), [mle.DenseMleF(0, [CFG.fp(5)], CFG)], 0,
                                       1, [(CFG.one(), (0,))], CFG)
    assert proof == []
    sub = sc.verify_as_subprotocol(KeccakTranscript(), 0, 1, CFG.fp(5), proof, CFG)
    assert sub.expected_evaluation == CFG.fp(5)


# ---------------------------------------------------------------------------
# host Spartan and the CCS relation (tests/test_spartan.py)
# ---------------------------------------------------------------------------


def _prepare(pkg, c, statement, witness):
    """prepare_for_random_field_piop (prover.rs:172-239) in ``pkg``."""
    cfg = pkg.cfg
    z_ccs = statement.get_z_vector(witness.w_ccs)
    if len(z_ccs) <= c.m:
        z_ccs = z_ccs + [0] * (c.m - len(z_ccs))
    return ([cfg.fp(v) for v in z_ccs], pkg.mle.DenseMleZ(c.s_prime, z_ccs), c.map_to_field(cfg),
            statement.map_to_field(cfg))


def _spartan(pkg, fixture):
    """(proof, r_y, ccs, statement, witness) of the fixture (ccs, statement,
    witness) proved by ``pkg``'s host Spartan."""
    c, statement, witness = fixture
    z_ccs, z_mle, ccs_f, statement_f = _prepare(pkg, c, statement, witness)
    proof, r_y = pkg.spartan.spartan_prove(statement_f, z_ccs, z_mle, ccs_f, pkg.T(), pkg.cfg)
    return proof, r_y, ccs_f, statement_f, z_mle


def _spartan_ints(proof) -> list:
    return [_ints(proof.linearization_sumcheck), _ints(proof.second_sumcheck), _ints(proof.V_s)]


def _dummy(pkg, log_n, seed):
    _, c, statement, wit = pkg.ccs.dummy_ccs_of_size(1 << log_n, random.Random(seed))
    return c, statement, wit


def test_ccs_relation_vitalik():
    c, statement, witness = ccs.vitalik_fixture(3)
    z = statement.get_z_vector(witness.w_ccs)
    assert z == jccs.vitalik_fixture(3)[1].get_z_vector(witness.w_ccs)
    c.check_relation(statement.constraints, z + [0] * (c.n - len(z)))


def test_ccs_relation_violation():
    c, statement, witness = ccs.vitalik_fixture(3)
    witness.w_ccs[0] += 1
    z = statement.get_z_vector(witness.w_ccs)
    with pytest.raises(ccs.CSError):
        c.check_relation(statement.constraints, z + [0] * (c.n - len(z)))


def test_ccs_relation_field_flavor():
    c, statement, witness = ccs.vitalik_fixture(3)
    z_ccs, _, ccs_f, statement_f = _prepare(PORT, c, statement, witness)
    ccs_f.check_relation(statement_f.constraints, z_ccs)
    z_ccs[1] = z_ccs[1] + CFG.one()
    with pytest.raises(ccs.CSError):
        ccs_f.check_relation(statement_f.constraints, z_ccs)


def test_spartan_roundtrip_vitalik():
    proof, r_y, ccs_f, statement_f, z_mle = _spartan(PORT, ccs.vitalik_fixture(3))
    jproof, jr_y, *_ = _spartan(JAX, jccs.vitalik_fixture(3))
    assert _spartan_ints(proof) == _spartan_ints(jproof) and _ints(r_y) == _ints(jr_y)
    points = spartan.spartan_verify(proof, ccs_f, KeccakTranscript(), CFG)
    s = ccs_f.s
    assert points.rx_ry[s:] == r_y
    v_xy = [evaluate_mle(m, points.rx_ry[:s], r_y, CFG) for m in statement_f.constraints]
    v = z_mle.map_to_field(CFG).evaluate(r_y)
    assert spartan.lin_comb_gamma(points.gamma, v_xy) * v == points.e_y


def test_spartan_roundtrip_dummy_ccs():
    proof, _, ccs_f, _, _ = _spartan(PORT, _dummy(PORT, 8, 42))
    assert _spartan_ints(proof) == _spartan_ints(_spartan(JAX, _dummy(JAX, 8, 42))[0])
    points = spartan.spartan_verify(proof, ccs_f, KeccakTranscript(), CFG)
    assert len(points.rx_ry) == ccs_f.s + ccs_f.s_prime


def test_spartan_rejects_corrupted_witness():
    fixtures = []
    for pkg in (PORT, JAX):
        c, statement, wit = _dummy(pkg, 6, 43)
        wit.w_ccs[3] = wit.w_ccs[3] + 1  # breaks the squaring relation
        fixtures.append((c, statement, wit))
    proof, _, ccs_f, _, _ = _spartan(PORT, fixtures[0])
    assert _spartan_ints(proof) == _spartan_ints(_spartan(JAX, fixtures[1])[0])
    with pytest.raises(spartan.SpartanError, match="linearization sumcheck failed"):
        spartan.spartan_verify(proof, ccs_f, KeccakTranscript(), CFG)


def test_spartan_rejects_tampered_v_s():
    proof, _, ccs_f, _, _ = _spartan(PORT, ccs.vitalik_fixture(3))
    proof.V_s[0] = proof.V_s[0] + CFG.one()
    with pytest.raises(spartan.SpartanError, match="linearization claim mismatch"):
        spartan.spartan_verify(proof, ccs_f, KeccakTranscript(), CFG)


def test_sparse_mle_evaluation_matches_dense():
    """evaluate_mle (sparse) against the dense column-major layout, and
    against the JAX package's on the same point."""
    rng = random.Random(44)
    pt = [rng.randrange(CFG.q) for _ in range(6)]
    m = ccs.vitalik_fixture(3)[1].map_to_field(CFG).constraints[0]
    jm = jccs.vitalik_fixture(3)[1].map_to_field(JAX.cfg).constraints[0]
    r = [CFG.fp(v) for v in pt]
    dense = mle.DenseMleF.from_matrix(m, CFG)
    got = evaluate_mle(m, r[:3], r[3:], CFG)
    assert dense.num_vars == 6 and dense.evaluate(r) == got
    jr = [JAX.cfg.fp(v) for v in pt]
    assert got.to_int() == j_evaluate_mle(jm, jr[:3], jr[3:], JAX.cfg).to_int()


# ---------------------------------------------------------------------------
# randomized instances end to end on the host backend (tests/test_property_e2e.py)
# ---------------------------------------------------------------------------


def _host_prove(statement, wit, c, jax_side: bool):
    """(proof, cfg, bytes) of one host prove, by the JAX package or the port."""
    if jax_side:
        t = JKeccakTranscript()
        cfg = j_draw_random_field(statement.public_input, t, 1, 4)
        proof = JZincProver(JZipTypes(1)).prove(statement, wit, t, c, cfg)
        return proof, cfg, j_serialize_proof(proof, cfg)
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, 1, 4)
    proof = zt.ZincProver(zt.ZipTypes(1), device="cpu", backend="host").prove(statement, wit, t, c, cfg)
    return proof, cfg, zt.serialize_proof(proof, cfg)


@pytest.mark.parametrize("seed", range(4))
def test_random_instance_roundtrip(seed):
    """A random shape, size and IO split (the JAX test's draws): the port's
    host proof has the JAX host prover's bytes and verifies; a corrupted
    witness gives the JAX package's bytes again and the port's verifier
    rejects it with ZincError."""
    rng = random.Random(1000 + seed)
    log_n = rng.choice([3, 4, 5, 6])
    pub_io = rng.choice([1, 2, 3])
    bits = rng.choice([8, 31, 62])
    z = [rng.randrange(-(1 << bits), 1 << bits) for _ in range(1 << log_n)]
    z[pub_io] = 1  # the fixed one-entry after the public IO
    c, statement, wit = ccs.dummy_ccs_from_z(z, pub_io_len=pub_io)
    jc, jstatement, jwit = jccs.dummy_ccs_from_z(z, pub_io_len=pub_io)
    verifier = zt.ZincVerifier(zt.ZipTypes(1), device="cpu", backend="host")

    proof, cfg, blob = _host_prove(statement, wit, c, False)
    assert blob == _host_prove(jstatement, jwit, jc, True)[2]
    verifier.verify(statement, proof, zt.KeccakTranscript(), c, cfg)

    if wit.w_ccs:
        i = rng.randrange(len(wit.w_ccs))
        bad = list(wit.w_ccs)
        bad[i] += 1
        bad_proof, cfg2, bad_blob = _host_prove(statement, ccs.Witness(w_ccs=bad), c, False)
        assert bad_blob == _host_prove(jstatement, jccs.Witness(w_ccs=bad), jc, True)[2]
        with pytest.raises(zt.ZincError):
            verifier.verify(statement, bad_proof, zt.KeccakTranscript(), c, cfg2)
