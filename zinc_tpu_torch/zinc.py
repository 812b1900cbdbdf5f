"""The Zinc protocol: Spartan over a CCS of integers + Zip PCS.

The port of ``zinc_tpu/zinc.py``.  The prover projects the integer
statement into the Fiat-Shamir-derived field, runs the two Spartan
sumchecks, commits to the integer witness with the RAA Zip PCS and proves
its evaluation at r_y.  The verifier re-derives the field, verifies
Spartan, verifies the PCS opening and closes with
Σⱼ γʲ·M̃ⱼ(r_x‖r_y)·v == e_y.

Two backends, as in the reference, with byte-identical proofs:
``backend="device"`` (the port's default) runs the hot paths on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``, and raises
when there is no card; ``backend="host"`` is the pure-Python path over
``Fp`` ints, which runs no kernel and touches no card: the oracle the
device path is held to.  The reference defaults to ``"host"``; the port's
entry points run on the card.  The device prover also runs on a
``parallel.Mesh`` of devices (1-D, 2-D "r" × "c", or a ("host", "chip")
mesh whose rows are processes), with the same proof bytes; the verifier
runs on one device, as the reference's does.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from .ccs import CCS, Statement, Witness
from .fields.config import FieldConfig, Fp
from .poly.mle import DenseMleZ
from .prime import draw_random_field
from .sparse import evaluate_mle
from .spartan import SpartanError, SpartanProof, lin_comb_gamma, spartan_prove, spartan_verify
from .transcript import KeccakTranscript
from .zip.code import DefaultLinearCodeSpec, LinearCodeSpec, RaaCode, ZipTypes
from .zip.transcript import PcsTranscript
from .ops._cuda import target_device
from .timing import timed
from .zip.pcs import ZipCommitment, commit, open_poly, setup, verify_poly

BACKENDS = ("host", "device")


class ZincError(Exception):
    pass


@dataclass
class ZipProof:
    z_comm: ZipCommitment
    v: Fp
    pcs_proof: bytes


@dataclass
class ZincProof:
    spartan_proof: SpartanProof
    zip_proof: ZipProof


def _z_vector(statement: Statement, wit: Witness, ccs: CCS) -> list[int]:
    z_ccs = statement.get_z_vector(wit.w_ccs)
    if len(z_ccs) <= ccs.m:
        z_ccs = z_ccs + [0] * (ccs.m - len(z_ccs))
    return z_ccs


def prepare_for_random_field_piop(statement: Statement, wit: Witness, ccs: CCS, cfg: FieldConfig):
    """z = (io ‖ 1 ‖ w) padded to m; its integer MLE; the field projections
    (``zinc_tpu/zinc.py:52-63``)."""
    z_ccs = _z_vector(statement, wit, ccs)
    z_mle = DenseMleZ(ccs.s_prime, z_ccs)
    z_ccs_f = [cfg.fp(v) for v in z_ccs]
    return z_ccs_f, z_mle, ccs.map_to_field(cfg), statement.map_to_field(cfg)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")


class ZincProver:
    """Top-level prover.  ``backend="device"`` runs every hot path on
    ``device``, or on ``mesh`` (``zinc_tpu/zinc.py:147-166``): then the
    upload and the Spartan setups run on the mesh's first local device, the
    sumchecks over its shards, and the commit over its rows (1-D) or rows ×
    columns (2-D), and ``device`` is not used.  ``backend="host"`` is the
    pure-Python prover (``zinc_tpu/zinc.py:96-105``): it reads neither
    ``device`` nor a card, and refuses a ``mesh``.  The default is
    ``"device"``, where the reference's is ``"host"``."""

    def __init__(self, zt: ZipTypes, lc_spec: LinearCodeSpec | None = None, device="cuda", mesh=None,
                 backend: str = "device"):
        self.zt = zt
        self.lc_spec = lc_spec or DefaultLinearCodeSpec()
        _check_backend(backend)
        self.backend = backend
        self.mesh = mesh
        if backend == "host":
            if mesh is not None:
                raise ValueError("the host backend runs in one process on the host: no mesh")
            self.device = None
            return
        if mesh is not None and len(mesh.axis_names) > 2:
            raise ValueError(f"a mesh of 1 or 2 axes, not {mesh.axis_names}")
        if mesh is not None and mesh.group is not None and mesh.devices.shape[0] != mesh.group.world:
            raise ValueError(f"a mesh of {mesh.devices.shape[0]} process rows over "
                             f"{mesh.group.world} processes")
        self.device = target_device(device if mesh is None else mesh.first)

    def prove(
        self, statement: Statement, wit: Witness, transcript: KeccakTranscript, ccs: CCS,
        cfg: FieldConfig,
    ) -> ZincProof:
        if self.backend == "host":
            return self._prove_host(statement, wit, transcript, ccs, cfg)
        from .spartan_dev import DeviceStatement, spartan_prove_device, z_to_device
        from .zip.device import commit_device, open_device

        mesh = self.mesh

        z_ccs = _z_vector(statement, wit, ccs)
        with timed("prove.upload"):
            dstatement = DeviceStatement.upload(cfg, statement, self.device)
            z_f = z_to_device(cfg, z_ccs, self.device)
        with timed("prove.spartan"):
            spartan_proof, r_y, v = spartan_prove_device(dstatement, z_f, ccs, transcript, cfg, mesh)

        code = RaaCode(self.lc_spec, ccs.m, transcript, self.zt)
        pp = setup(ccs.m, code, self.zt)
        if all(-(1 << 63) <= x < (1 << 63) for x in z_ccs):
            z_vals = np.array(z_ccs, np.int64)
        else:
            z_vals = z_ccs
        with timed("prove.zip_commit"):
            if mesh is None:
                data, z_comm = commit_device(pp, z_vals, cfg, self.device)
            elif len(mesh.axis_names) == 2:
                from .parallel.zip import commit_device_sharded_2d

                data, z_comm = commit_device_sharded_2d(pp, z_vals, cfg, mesh)
            else:
                from .parallel.zip import commit_device_sharded

                data, z_comm = commit_device_sharded(pp, z_vals, cfg, mesh)
        with timed("prove.zip_open"):
            pcs_transcript = PcsTranscript()
            # row blocks spread over processes are opened with the mesh's collectives
            group = mesh.group if mesh is not None and isinstance(data, list) else None
            open_device(pp, z_vals, z_f, data, r_y, cfg, pcs_transcript, group)
        zip_proof = ZipProof(z_comm=z_comm, v=v, pcs_proof=pcs_transcript.into_proof())
        return ZincProof(spartan_proof=spartan_proof, zip_proof=zip_proof)

    def _prove_host(self, statement, wit, transcript, ccs, cfg) -> ZincProof:
        z_ccs_f, z_mle, ccs_f, statement_f = prepare_for_random_field_piop(statement, wit, ccs, cfg)
        spartan_proof, r_y = spartan_prove(statement_f, z_ccs_f, z_mle, ccs_f, transcript, cfg)
        code = RaaCode(self.lc_spec, ccs_f.m, transcript, self.zt)
        pp = setup(ccs_f.m, code, self.zt)
        data, z_comm = commit(pp, z_mle)
        pcs_transcript = PcsTranscript()
        v = z_mle.map_to_field(cfg).evaluate(r_y)
        open_poly(pp, z_mle, data, r_y, cfg, pcs_transcript)
        zip_proof = ZipProof(z_comm=z_comm, v=v, pcs_proof=pcs_transcript.into_proof())
        return ZincProof(spartan_proof=spartan_proof, zip_proof=zip_proof)


class ZincVerifier:
    """``backend="device"`` (the default): the matrix upload and the final
    Σγʲ·M̃ⱼ(r_x‖r_y) evaluations run on ``device`` in background threads,
    under the host-side Spartan and PCS checks; every worker is joined
    before the verifier raises.  ``backend="host"`` evaluates the matrices
    sparsely in Python ints and runs the PCS checks on the CPU
    (``zinc_tpu/zinc.py:265, 348``); it reads neither ``device`` nor a card.
    The reference's default is ``"host"``."""

    def __init__(self, zt: ZipTypes, lc_spec: LinearCodeSpec | None = None, device="cuda",
                 backend: str = "device"):
        self.zt = zt
        self.lc_spec = lc_spec or DefaultLinearCodeSpec()
        _check_backend(backend)
        self.backend = backend
        self.device = None if backend == "host" else target_device(device)
        # (statement, q, DeviceCsr list): a verifier checks many proofs of
        # one circuit, so the matrix upload is kept
        self._csr_cache: tuple | None = None

    def verify(
        self, statement: Statement, proof: ZincProof, transcript: KeccakTranscript, ccs: CCS,
        cfg: FieldConfig,
    ) -> None:
        with timed("verify.draw_field"):
            drawn = draw_random_field(statement.public_input, transcript, self.zt.n_words, cfg.n64)
            if drawn != cfg:
                raise ZincError("field config mismatch: wrong public input binding")
        ccs_f = ccs.map_to_field(cfg)
        if self.backend == "host":
            points = self._verify_spartan(proof, ccs_f, transcript, cfg)
            r_x, r_y = points.rx_ry[: ccs_f.s], points.rx_ry[ccs_f.s :]
            self._verify_pcs(proof, ccs_f, transcript, cfg, r_y, "cpu")
            with timed("verify.final_evals"):
                v_xy = [evaluate_mle(m, r_x, r_y, cfg)
                        for m in statement.map_to_field(cfg).constraints]
        else:
            points, v_xy = self._verify_device(statement, proof, transcript, ccs_f, cfg)
        if not lin_comb_gamma(points.gamma, v_xy) * proof.zip_proof.v == points.e_y:
            raise ZincError("gamma combination of matrix evaluations != e_y")

    @staticmethod
    def _verify_spartan(proof, ccs_f, transcript, cfg):
        with timed("verify.spartan"):
            try:
                return spartan_verify(proof.spartan_proof, ccs_f, transcript, cfg)
            except SpartanError as e:
                raise ZincError(f"Spartan verification failed: {e}") from e

    def _verify_pcs(self, proof, ccs_f, transcript, cfg, r_y, device) -> None:
        with timed("verify.code_setup"):
            code = RaaCode(self.lc_spec, ccs_f.m, transcript, self.zt)
            pp = setup(ccs_f.m, code, self.zt)
        pcs_transcript = PcsTranscript.from_proof(proof.zip_proof.pcs_proof)
        with timed("verify.pcs"):
            try:
                verify_poly(pp, proof.zip_proof.z_comm, r_y, proof.zip_proof.v, pcs_transcript,
                            cfg, device)
            except Exception as e:
                raise ZincError(f"PCS verification failed: {e}") from e

    def _verify_device(self, statement, proof, transcript, ccs_f, cfg):
        """Spartan and the PCS on the host and ``device``, the final
        evaluations on ``device``: (points, [M̃ⱼ(r_x‖r_y)])."""
        from .ops.sparse import dispatch_mle_evals, fetch_mle_evals, upload_matrix

        # the matrix upload, then (once r_x, r_y are known) the final
        # evaluations, run in one background thread
        jobs: dict = {}
        points_ready = threading.Event()

        def _upload_and_eval():
            try:
                cache = self._csr_cache
                if cache is not None and cache[0] is statement and cache[1] == cfg.q:
                    ms = cache[2]
                else:
                    ms = [upload_matrix(cfg, m, self.device, with_col_views=False)
                          for m in statement.constraints]
                    self._csr_cache = (statement, cfg.q, ms)
                points_ready.wait()
                if "points" in jobs:
                    jobs["handles"] = dispatch_mle_evals(cfg, ms, *jobs["points"])
            except BaseException as e:  # re-raised after the join
                jobs["error"] = e

        worker = threading.Thread(target=_upload_and_eval, daemon=True)
        worker.start()
        try:
            points = self._verify_spartan(proof, ccs_f, transcript, cfg)
            r_x = points.rx_ry[: ccs_f.s]
            r_y = points.rx_ry[ccs_f.s :]
            jobs["points"] = (r_x, r_y)
            points_ready.set()
            self._verify_pcs(proof, ccs_f, transcript, cfg, r_y, self.device)
        finally:
            points_ready.set()
            worker.join()
        with timed("verify.final_evals"):
            if "error" in jobs:
                raise jobs["error"]
            return points, fetch_mle_evals(cfg, jobs["handles"])
