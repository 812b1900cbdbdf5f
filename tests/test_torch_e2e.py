"""The port's whole prove + verify against the JAX package: the pinned 2^10
golden proof, a live second seed against ``zinc_tpu``'s host prover (and a
192-bit field), the tamper probes of tests/test_golden.py, a run with jax
unimportable, and the entry points' default device."""

import hashlib
import inspect
import os
import random
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import chip_smoke
import zinc_tpu_torch as zt
from tests.golden.gen import N, SEED
from zinc_tpu_torch.zip import pcs

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "proof_2p10.bin"


def _setup(n, seed):
    _, ccs, statement, wit = zt.dummy_ccs_of_size(n, random.Random(seed), int_bits=62)
    ztypes = zt.ZipTypes(1)
    cfg = zt.draw_random_field(statement.public_input, zt.KeccakTranscript(), ztypes.n_words, 4)
    return ccs, statement, wit, ztypes, cfg


def _prove(n, seed) -> bytes:
    ccs, statement, wit, ztypes, _ = _setup(n, seed)
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, ztypes.n_words, 4)
    proof = zt.ZincProver(ztypes, device="cpu").prove(statement, wit, t, ccs, cfg)
    return zt.serialize_proof(proof, cfg)


def test_port_prove_reproduces_golden_2p10():
    assert _prove(N, SEED) == GOLDEN.read_bytes()


def _jax_host_proof(n, seed, n64=4) -> bytes:
    from zinc_tpu.ccs import dummy_ccs_of_size
    from zinc_tpu.prime import draw_random_field
    from zinc_tpu.serialize import serialize_proof
    from zinc_tpu.transcript import KeccakTranscript
    from zinc_tpu.zinc import ZincProver
    from zinc_tpu.zip.code import ZipTypes

    _, ccs, statement, wit = dummy_ccs_of_size(n, random.Random(seed), int_bits=62)
    t = KeccakTranscript()
    cfg = draw_random_field(statement.public_input, t, 1, n64)
    return serialize_proof(ZincProver(ZipTypes(1), backend="host").prove(statement, wit, t, ccs, cfg), cfg)


def test_port_matches_jax_host_prover_2p8():
    assert _prove(1 << 8, 99) == _jax_host_proof(1 << 8, 99)


def test_port_matches_jax_host_prover_192bit_2p8():
    """A field of n64 = 3 (6 words, a width whose elements are 8-byte
    vectors on the card): at 2^8 both sumchecks run device rounds, Gruen's
    included, and the proof bytes equal the JAX host prover's; they hash to
    the digest chip_smoke.py holds the card's proof to.  The verifier
    accepts and rejects the V_s[0] + 1 tamper."""
    n, seed = chip_smoke.N64_3_CASE
    _, ccs, statement, wit = zt.dummy_ccs_of_size(n, random.Random(seed), int_bits=62)
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, 1, 3)
    assert cfg.q.bit_length() == 192
    proof = zt.ZincProver(zt.ZipTypes(1), device="cpu").prove(statement, wit, t, ccs, cfg)
    blob = zt.serialize_proof(proof, cfg)
    assert blob == _jax_host_proof(n, seed, n64=3)
    assert hashlib.sha256(blob).hexdigest() == chip_smoke.N64_3_SHA256
    verifier = zt.ZincVerifier(zt.ZipTypes(1), device="cpu")
    verifier.verify(statement, proof, zt.KeccakTranscript(), ccs, cfg)
    proof.spartan_proof.V_s[0] = proof.spartan_proof.V_s[0] + cfg.one()
    with pytest.raises(zt.ZincError):
        verifier.verify(statement, proof, zt.KeccakTranscript(), ccs, cfg)


def test_port_matches_jax_host_prover_64bit_2p8():
    """A field of n64 = 1 (q < 2^64, where the int64 field map does not
    apply): the device prover on the CPU maps z and the matrices by the
    wide path, and its proof bytes equal the JAX host prover's; the
    verifier accepts them."""
    _, ccs, statement, wit = zt.dummy_ccs_of_size(1 << 8, random.Random(1234), int_bits=62)
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, 1, 1)
    assert cfg.q < 1 << 64
    proof = zt.ZincProver(zt.ZipTypes(1), device="cpu").prove(statement, wit, t, ccs, cfg)
    assert zt.serialize_proof(proof, cfg) == _jax_host_proof(1 << 8, 1234, n64=1)
    zt.ZincVerifier(zt.ZipTypes(1), device="cpu").verify(statement, proof, zt.KeccakTranscript(),
                                                         ccs, cfg)


def test_entry_points_default_to_the_card():
    """With no ``device`` argument the prover, the verifier and the PCS
    verifier run on CUDA, on the "device" backend; without a card they raise
    rather than fall back to the CPU (or to the host backend)."""
    for fn in (zt.ZincProver.__init__, zt.ZincVerifier.__init__, pcs.verify_poly):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for fn in (zt.ZincProver.__init__, zt.ZincVerifier.__init__):
        assert inspect.signature(fn).parameters["backend"].default == "device"
    for cls in (zt.ZincProver, zt.ZincVerifier):
        if torch.cuda.is_available():
            assert cls(zt.ZipTypes(1)).device == torch.device("cuda")
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls(zt.ZipTypes(1))
        assert cls(zt.ZipTypes(1), device="cpu").device == torch.device("cpu")


def test_port_verifier_accepts_golden_and_rejects_tampering():
    ccs, statement, _, ztypes, cfg = _setup(N, SEED)
    blob = GOLDEN.read_bytes()
    verifier = zt.ZincVerifier(ztypes, device="cpu")
    verifier.verify(statement, zt.deserialize_proof(blob, cfg), zt.KeccakTranscript(), ccs, cfg)

    # probe 1: a claimed matrix evaluation that survives parsing
    bad = zt.deserialize_proof(blob, cfg)
    bad.spartan_proof.V_s[0] = bad.spartan_proof.V_s[0] + cfg.one()
    with pytest.raises(zt.ZincError):
        verifier.verify(statement, bad, zt.KeccakTranscript(), ccs, cfg)

    # probe 2: one flipped byte deep in the PCS stream
    raw = bytearray(blob)
    raw[len(raw) // 2] ^= 0x01
    with pytest.raises(Exception):
        verifier.verify(statement, zt.deserialize_proof(bytes(raw), cfg), zt.KeccakTranscript(),
                        ccs, cfg)


def test_port_runs_without_jax():
    """The card's situation: jax cannot be imported at all.  A prove and a
    verify on one device, the prove on a mesh of 4 CPU shards and a prove
    and a verify on the host backend (the same bytes), and the import of
    ``zinc_tpu_torch.parallel`` (no process group), load no jax and no
    module of the JAX package."""
    script = textwrap.dedent(
        f"""
        import os, random, sys
        sys.modules["jax"] = None
        sys.path.insert(0, {str(ROOT)!r})
        import zinc_tpu_torch as zt
        from zinc_tpu_torch.ops import _cuda
        _, ccs, st, wit = zt.dummy_ccs_of_size(1 << 8, random.Random(5), int_bits=62)
        t = zt.KeccakTranscript()
        cfg = zt.draw_random_field(st.public_input, t, 1, 4)
        proof = zt.ZincProver(zt.ZipTypes(1), device="cpu").prove(st, wit, t, ccs, cfg)
        zt.ZincVerifier(zt.ZipTypes(1), device="cpu").verify(st, proof, zt.KeccakTranscript(), ccs, cfg)
        from zinc_tpu_torch.parallel import Mesh
        mesh = Mesh(["cpu"] * 4)
        t = zt.KeccakTranscript()
        cfg = zt.draw_random_field(st.public_input, t, 1, 4)
        sharded = zt.ZincProver(zt.ZipTypes(1), mesh=mesh).prove(st, wit, t, ccs, cfg)
        assert zt.serialize_proof(sharded, cfg) == zt.serialize_proof(proof, cfg)
        assert mesh.stats["commit"] == ["4 row blocks"]
        t = zt.KeccakTranscript()
        cfg = zt.draw_random_field(st.public_input, t, 1, 4)
        host = zt.ZincProver(zt.ZipTypes(1), backend="host").prove(st, wit, t, ccs, cfg)
        assert zt.serialize_proof(host, cfg) == zt.serialize_proof(proof, cfg)
        zt.ZincVerifier(zt.ZipTypes(1), backend="host").verify(st, host, zt.KeccakTranscript(), ccs, cfg)
        import torch.distributed as dist
        from zinc_tpu_torch.parallel import hierarchical_mesh, init_distributed
        assert not dist.is_initialized()
        assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
        assert "zinc_tpu" not in sys.modules and _cuda._libs == {{}}
        ref = os.path.join({str(ROOT)!r}, "zinc_tpu") + os.sep
        loaded = [getattr(m, "__file__", None) or "" for m in list(sys.modules.values()) if m]
        assert not [f for f in loaded if os.path.abspath(f).startswith(ref)], "reference module loaded"
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
