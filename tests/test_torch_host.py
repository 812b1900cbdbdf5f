"""The port's host backend against the JAX package's: the host Zip PCS
(``zinc_tpu_torch/zip/pcs.py``: commit, open, batch, encode-only commit,
the ZipLinearCode) byte for byte against ``zinc_tpu/zip/pcs.py``, the
adversarial proofs of tests/test_zip_adversarial.py built by the port's own
host PCS, ``ZincProver(backend="host")`` against the JAX host prover (the
golden, a 192-bit field, path A, wide witnesses), and both verifier
backends on both provers' proofs.  Exact equality throughout."""

import hashlib
import random

import pytest

import chip_smoke
import zinc_tpu_torch as zt
from tests.golden.gen import N, SEED
from tests.test_torch_generic import _jax_path_a_proof
from zinc_tpu import ccs as jccs
from zinc_tpu.fields.config import FieldConfig as JFieldConfig
from zinc_tpu.poly.mle import DenseMleZ as JDenseMleZ
from zinc_tpu.prime import draw_random_field as j_draw_random_field
from zinc_tpu.serialize import serialize_proof as j_serialize_proof
from zinc_tpu.transcript import KeccakTranscript as JKeccakTranscript
from zinc_tpu.zinc import ZincProver as JZincProver
from zinc_tpu.zip import code as jcode
from zinc_tpu.zip import pcs as jpcs
from zinc_tpu.zip.transcript import PcsTranscript as JPcsTranscript
from zinc_tpu_torch import ccs
from zinc_tpu_torch.fields.config import FieldConfig
from zinc_tpu_torch.parallel import Mesh
from zinc_tpu_torch.poly.mle import DenseMleZ
from zinc_tpu_torch.zip import code, pcs
from zinc_tpu_torch.zip.merkle import MerkleTree, int_to_leaf_bytes
from zinc_tpu_torch.zip.transcript import PcsTranscript

Q256 = 57316695564490278656402085503  # the prime of the reference's PCS tests
GOLDEN_CASE = N, SEED


class _Counter:
    """The reference's deterministic counter transcript (pcs/tests.rs:26-56)."""

    def __init__(self):
        self.counter = 0

    def get_u64(self):
        self.counter += 1
        return self.counter


def _seeds(which: str, pkg):
    """The code's seed source: the counter, or a Keccak transcript after a
    label (the reference tests' two ways)."""
    if which == "counter":
        return _Counter()
    t = pkg.KeccakTranscript()
    t.absorb(which.encode())
    return t


class _Side:
    """One package's host PCS at ``num_vars`` (the port's or the JAX one's)."""

    def __init__(self, port: bool, num_vars: int, code_name: str, seeds: str, evals):
        self.port = port
        mods = (pcs, code, DenseMleZ, FieldConfig, PcsTranscript, zt) if port else (
            jpcs, jcode, JDenseMleZ, JFieldConfig, JPcsTranscript, _JaxTranscripts)
        self.pcs, c, mle, fc, self.Pcst, pkg = mods
        zt1 = c.ZipTypes(1)
        code_cls = c.RaaCode if code_name == "raa" else c.ZipLinearCode
        self.pp = self.pcs.setup(1 << num_vars, code_cls(c.DefaultLinearCodeSpec(), 1 << num_vars,
                                                         _seeds(seeds, pkg), zt1), zt1)
        self.cfg = fc(Q256, 4)
        self.poly = mle(num_vars, list(evals))

    def point(self, ints):
        return [self.cfg.fp(x) for x in ints]

    def commit_open(self, point_ints):
        data, comm = self.pcs.commit(self.pp, self.poly)
        t = self.Pcst()
        self.pcs.open_poly(self.pp, self.poly, data, self.point(point_ints), self.cfg, t)
        v = self.poly.map_to_field(self.cfg).evaluate(self.point(point_ints))
        return data, comm, v, t.into_proof()


class _JaxTranscripts:
    KeccakTranscript = JKeccakTranscript


def _pair(num_vars, code_name="raa", seeds="counter", evals=None, seed=1):
    rng = random.Random(seed)
    if evals is None:
        evals = [rng.randrange(-(1 << 30), 1 << 30) for _ in range(1 << num_vars)]
    point = [rng.randrange(Q256) for _ in range(num_vars)]
    return (_Side(True, num_vars, code_name, seeds, evals),
            _Side(False, num_vars, code_name, seeds, evals), point)


def _verify(side, comm, point_ints, v, proof):
    pcs.verify_poly(side.pp, comm, side.point(point_ints), v, PcsTranscript.from_proof(proof),
                    side.cfg, device="cpu")


@pytest.mark.parametrize("code_name,seeds,num_vars", [
    ("raa", "counter", 4), ("raa", "host-pcs", 6), ("zlc", "zlc-pcs", 4),
], ids=["raa-counter-2^4", "raa-keccak-2^6", "zip-linear-code-2^4"])
def test_host_pcs_matches_jax_host_pcs(code_name, seeds, num_vars):
    """The host commit (rows, roots) and open (bytes) equal the JAX host
    PCS's; the port's verifier accepts the opening on the CPU."""
    port, jax_side, point = _pair(num_vars, code_name, seeds)
    data, comm, v, proof = port.commit_open(point)
    jdata, jcomm, jv, jproof = jax_side.commit_open(point)
    assert data.rows == jdata.rows and data.roots() == jdata.roots() == comm.roots == jcomm.roots
    assert proof == jproof and v.m == jv.m
    _verify(port, comm, point, v, proof)


@pytest.mark.parametrize("code_name", ["raa", "zlc"], ids=["raa", "zip-linear-code"])
@pytest.mark.parametrize("probe", ["wrong-eval", "tampered-proof", "wrong-root"])
def test_host_pcs_openings_are_rejected_when_wrong(code_name, probe):
    """A wrong evaluation, a flipped byte in the proximity row and a zeroed
    root are each rejected with PcsError."""
    port, _, point = _pair(4, code_name, "counter" if code_name == "raa" else "zlc-pcs", seed=2)
    _, comm, v, proof = port.commit_open(point)
    if probe == "wrong-eval":
        v = v + port.cfg.one()
    elif probe == "tampered-proof":
        bad = bytearray(proof)
        bad[5] ^= 0xFF
        proof = bytes(bad)
    else:
        comm = pcs.ZipCommitment([b"\x00" * 32] + comm.roots[1:])
    with pytest.raises(pcs.PcsError):
        _verify(port, comm, point, v, proof)


def test_host_pcs_batch_matches_jax():
    """batch_commit / batch_open / batch_verify over three polynomials: the
    roots and the one transcript's bytes equal the JAX host PCS's."""
    rng = random.Random(5)
    polys = [[rng.randrange(-100, 100) for _ in range(16)] for _ in range(3)]
    points = [[rng.randrange(Q256) for _ in range(4)] for _ in polys]
    out = []
    for side in (_Side(True, 4, "raa", "counter", polys[0]), _Side(False, 4, "raa", "counter", polys[0])):
        mles = [type(side.poly)(4, p) for p in polys]
        pts = [side.point(p) for p in points]
        results = side.pcs.batch_commit(side.pp, mles)
        t = side.Pcst()
        side.pcs.batch_open(side.pp, mles, [d for d, _ in results], pts, side.cfg, t)
        evals = [m.map_to_field(side.cfg).evaluate(p) for m, p in zip(mles, pts)]
        out.append(([c.roots for _, c in results], t.into_proof(), [e.m for e in evals]))
        if side.port:
            pcs.batch_verify(side.pp, [c for _, c in results], pts, evals,
                             PcsTranscript.from_proof(out[-1][1]), side.cfg, device="cpu")
    assert out[0] == out[1]


def test_commit_no_merkle_rows_equal_commit_rows():
    """The encode-only commit gives the full commit's rows, no trees and no
    roots, as the JAX package's does."""
    rng = random.Random(5)
    evals = [rng.randrange(-(1 << 40), 1 << 40) for _ in range(64)]
    port = _Side(True, 6, "raa", "cnm", evals)
    full, comm = pcs.commit(port.pp, port.poly)
    rows, no_comm = pcs.commit_no_merkle(port.pp, port.poly)
    jrows, _ = jpcs.commit_no_merkle(_Side(False, 6, "raa", "cnm", evals).pp,
                                     JDenseMleZ(6, evals))
    assert rows.rows == full.rows == jrows.rows
    assert rows.trees == [] and no_comm.roots == [] and comm.roots


# ---- adversarial openings (tests/test_zip_adversarial.py), by the port ----

ADV_NV = 6


def _adversarial(case: str):
    """(pp, commitment, point, v, proof) of the case, built by the port's
    host PCS as the reference's adversarial tests build theirs."""
    seed = {"far-row": 1, "one-column": 2, "witness-swap": 3, "honest": 4, "close-codeword": 5,
            "zero-root": 6}[case]
    rng = random.Random(seed)
    cfg = FieldConfig((1 << 255) + 95, 4)
    evals = [rng.randrange(-(1 << 30), 1 << 30) for _ in range(1 << ADV_NV)]
    poly = DenseMleZ(ADV_NV, evals)
    t = zt.KeccakTranscript()
    t.absorb(b"adversarial")
    zt1 = code.ZipTypes(1)
    pp = pcs.setup(1 << ADV_NV, code.RaaCode(code.DefaultLinearCodeSpec(), 1 << ADV_NV, t, zt1), zt1)
    point = [cfg.fp(rng.randrange(cfg.q)) for _ in range(ADV_NV)]
    data, comm = pcs.commit(pp, poly)
    cw = pp.code.codeword_len()
    opened = poly
    if case == "far-row":
        for c in range(cw):
            data.rows[c] += 1  # row 0, every column
    elif case == "one-column":
        data.rows[3] += 12345
    elif case == "witness-swap":
        other = random.Random(99)
        opened = DenseMleZ(ADV_NV, [other.randrange(-(1 << 30), 1 << 30) for _ in range(1 << ADV_NV)])
    elif case == "close-codeword":
        # one entry bumped, the trees rebuilt over the corrupted rows
        data.rows[0] += 1
        depth = max((cw - 1).bit_length(), 0)
        data.trees = [MerkleTree.from_leaves(depth, [int_to_leaf_bytes(x, pp.zt.k_words)
                                                     for x in data.rows[r * cw : (r + 1) * cw]])
                      for r in range(pp.num_rows)]
    pt = PcsTranscript()
    pcs.open_poly(pp, opened, data, point, cfg, pt)
    if case == "zero-root":
        comm.roots[0] = bytes(32)
    return pp, comm, point, poly.map_to_field(cfg).evaluate(point), pt.into_proof(), cfg


@pytest.mark.parametrize("case,error", [
    ("far-row", pcs.PcsError), ("one-column", pcs.PcsError), ("witness-swap", pcs.PcsError),
    ("zero-root", pcs.MerkleError), ("honest", None), ("close-codeword", "opens"),
])
def test_adversarial_openings(case, error):
    """A row corrupted in every column, one corrupted entry, a different
    witness opened against an honest commitment and a zeroed root are
    rejected by ``verify_poly(device="cpu")`` (the root as a MerkleError);
    the honest opening is accepted, and a codeword within the proximity
    radius (trees rebuilt over it) still opens."""
    pp, comm, point, v, proof, cfg = _adversarial(case)
    if error == "opens":
        assert proof
        return
    run = lambda: pcs.verify_poly(pp, comm, point, v, PcsTranscript.from_proof(proof), cfg, "cpu")
    if error is None:
        run()
    else:
        with pytest.raises(error):
            run()


# ---- the host backend ------------------------------------------------------


def _jax_host(n, seed, n64=4) -> bytes:
    _, jc, st, wit = jccs.dummy_ccs_of_size(n, random.Random(seed), int_bits=62)
    t = JKeccakTranscript()
    cfg = j_draw_random_field(st.public_input, t, 1, n64)
    return j_serialize_proof(JZincProver(jcode.ZipTypes(1), backend="host").prove(st, wit, t, jc, cfg),
                             cfg)


def _port_prove(fixture, n64=4, ztypes=None, **kw):
    c, st, wit = fixture
    ztypes = ztypes or zt.ZipTypes(1)
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(st.public_input, t, ztypes.n_words, n64)
    proof = zt.ZincProver(ztypes, **kw).prove(st, wit, t, c, cfg)
    return proof, cfg, zt.serialize_proof(proof, cfg)


def _r1cs(n, seed):
    return zt.dummy_ccs_of_size(n, random.Random(seed), int_bits=62)[1:]


@pytest.mark.parametrize("case", ["golden-2^10", "192-bit-2^8", "path-A-2^8"])
def test_host_backend_matches_jax_host_prover(case):
    """``ZincProver(backend="host")`` gives the JAX host prover's bytes: the
    2^10 golden, the 192-bit 2^8 proof (N64_3_SHA256) and path A at 2^8."""
    if case == "golden-2^10":
        _, _, blob = _port_prove(_r1cs(*GOLDEN_CASE), backend="host")
        assert blob == (chip_smoke.ROOT / "tests" / "golden" / "proof_2p10.bin").read_bytes()
    elif case == "192-bit-2^8":
        n, seed = chip_smoke.N64_3_CASE
        _, _, blob = _port_prove(_r1cs(n, seed), n64=3, backend="host")
        assert blob == _jax_host(n, seed, n64=3)
        assert hashlib.sha256(blob).hexdigest() == chip_smoke.N64_3_SHA256
    else:
        _, _, blob = _port_prove(chip_smoke.degree4_fixture(1 << 8, 1234), backend="host")
        assert blob == _jax_path_a_proof(1 << 8, 1234)


def test_both_verifier_backends_take_both_provers_proofs():
    """At 2^8 the host and device(cpu) provers give the same bytes; the host
    and device(cpu) verifiers accept both proofs and reject the V_s[0] + 1
    tamper and a flipped PCS byte."""
    fixture = _r1cs(1 << 8, 17)
    c, st, _ = fixture
    host, cfg, blob = _port_prove(fixture, backend="host")
    dev, _, dev_blob = _port_prove(fixture, device="cpu")
    assert blob == dev_blob
    verifiers = [zt.ZincVerifier(zt.ZipTypes(1), backend="host"),
                 zt.ZincVerifier(zt.ZipTypes(1), device="cpu")]
    for verifier in verifiers:
        for proof in (host, dev):
            verifier.verify(st, proof, zt.KeccakTranscript(), c, cfg)
        bad = zt.deserialize_proof(blob, cfg)
        bad.spartan_proof.V_s[0] = bad.spartan_proof.V_s[0] + cfg.one()
        with pytest.raises(zt.ZincError):
            verifier.verify(st, bad, zt.KeccakTranscript(), c, cfg)
        raw = bytearray(blob)
        raw[len(raw) // 2] ^= 0x01
        with pytest.raises(Exception):
            verifier.verify(st, zt.deserialize_proof(bytes(raw), cfg), zt.KeccakTranscript(), c, cfg)


def test_host_backend_reads_no_device_and_refuses_a_mesh():
    """The host backend needs no card (its ``device`` is not read, even at
    the default "cuda") and refuses a mesh; an unknown backend is refused;
    the default backend is "device"."""
    assert zt.ZincProver(zt.ZipTypes(1), backend="host").device is None
    assert zt.ZincVerifier(zt.ZipTypes(1), backend="host").device is None
    with pytest.raises(ValueError, match="no mesh"):
        zt.ZincProver(zt.ZipTypes(1), backend="host", mesh=Mesh(["cpu"] * 2))
    for cls in (zt.ZincProver, zt.ZincVerifier):
        with pytest.raises(ValueError, match="backend"):
            cls(zt.ZipTypes(1), device="cpu", backend="tpu")
        assert cls(zt.ZipTypes(1), device="cpu").backend == "device"


# ---- wide witnesses (tests/test_wide_witness.py) ---------------------------

@pytest.mark.parametrize("k_words,bits", [(2, 100), (2, 127), (1, 63)],
                         ids=["ZipTypes(2)-2^100", "ZipTypes(2)-2^127", "ZipTypes(1)-2^63"])
def test_wide_witnesses_match_jax_host_prover(k_words, bits):
    """``dummy_ccs_from_z`` over 32 entries with |z| < 2^bits: the port's
    host prover and its device(cpu) prover give the JAX host prover's bytes
    (the witness words past int64), and the port's verifier accepts."""
    rng = random.Random(123 + bits)
    z = [rng.randrange(-(1 << bits), 1 << bits) for _ in range(1 << 5)]
    z[1] = 1
    jc, jst, jwit = jccs.dummy_ccs_from_z(z, pub_io_len=1)
    t = JKeccakTranscript()
    jcfg = j_draw_random_field(jst.public_input, t, k_words, 4)
    want = j_serialize_proof(JZincProver(jcode.ZipTypes(k_words), backend="host").prove(
        jst, jwit, t, jc, jcfg), jcfg)
    fixture = ccs.dummy_ccs_from_z(z, pub_io_len=1)
    ztypes = zt.ZipTypes(k_words)
    for kw in ({"backend": "host"}, {"device": "cpu"}):
        proof, cfg, blob = _port_prove(fixture, ztypes=ztypes, **kw)
        assert blob == want
        zt.ZincVerifier(ztypes, device="cpu").verify(fixture[1], proof, zt.KeccakTranscript(),
                                                     fixture[0], cfg)
