"""The Zinc protocol on the device: Spartan over a CCS of integers + Zip PCS.

The port of the device path of ``zinc_tpu/zinc.py``.  The prover projects
the integer statement into the Fiat-Shamir-derived field, runs the two
Spartan sumchecks, commits to the integer witness with the RAA Zip PCS and
proves its evaluation at r_y.  The verifier re-derives the field, verifies
Spartan, verifies the PCS opening and closes with
Σⱼ γʲ·M̃ⱼ(r_x‖r_y)·v == e_y, evaluated sparsely on the device.

Both run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, and raise when there is no card; proofs are
byte-identical to the JAX package's for the same inputs.  The prover also
runs on a ``parallel.Mesh`` of devices (1-D, or 2-D "r" × "c"), with the
same proof bytes; the verifier runs on one device, as the reference's does.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from .ccs import CCS, Statement, Witness
from .fields.config import FieldConfig, Fp
from .prime import draw_random_field
from .spartan import SpartanError, SpartanProof, lin_comb_gamma, spartan_verify
from .transcript import KeccakTranscript
from .zip.code import DefaultLinearCodeSpec, LinearCodeSpec, RaaCode, ZipTypes
from .zip.transcript import PcsTranscript
from .ops._cuda import target_device
from .timing import timed
from .zip.pcs import ZipCommitment, setup, verify_poly


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


class ZincProver:
    """Top-level prover; every hot path runs on ``device``, or on ``mesh``
    (``zinc_tpu/zinc.py:147-166``): then the upload and the Spartan setups
    run on the mesh's first device, the sumchecks over all its shards, and
    the commit over its rows (1-D) or rows × columns (2-D), and ``device``
    is not used."""

    def __init__(self, zt: ZipTypes, lc_spec: LinearCodeSpec | None = None, device="cuda", mesh=None):
        self.zt = zt
        self.lc_spec = lc_spec or DefaultLinearCodeSpec()
        if mesh is not None and len(mesh.axis_names) > 2:
            raise ValueError(f"a mesh of 1 or 2 axes, not {mesh.axis_names}")
        self.mesh = mesh
        self.device = target_device(device if mesh is None else mesh.first)

    def prove(
        self, statement: Statement, wit: Witness, transcript: KeccakTranscript, ccs: CCS,
        cfg: FieldConfig,
    ) -> ZincProof:
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
            open_device(pp, z_vals, z_f, data, r_y, cfg, pcs_transcript)
        zip_proof = ZipProof(z_comm=z_comm, v=v, pcs_proof=pcs_transcript.into_proof())
        return ZincProof(spartan_proof=spartan_proof, zip_proof=zip_proof)


class ZincVerifier:
    """The matrix upload and the final Σγʲ·M̃ⱼ(r_x‖r_y) evaluations run on
    ``device`` in background threads, under the host-side Spartan and PCS
    checks; every worker is joined before the verifier raises."""

    def __init__(self, zt: ZipTypes, lc_spec: LinearCodeSpec | None = None, device="cuda"):
        self.zt = zt
        self.lc_spec = lc_spec or DefaultLinearCodeSpec()
        self.device = target_device(device)
        # (statement, q, DeviceCsr list): a verifier checks many proofs of
        # one circuit, so the matrix upload is kept
        self._csr_cache: tuple | None = None

    def verify(
        self, statement: Statement, proof: ZincProof, transcript: KeccakTranscript, ccs: CCS,
        cfg: FieldConfig,
    ) -> None:
        from .ops.sparse import dispatch_mle_evals, fetch_mle_evals, upload_matrix

        with timed("verify.draw_field"):
            drawn = draw_random_field(statement.public_input, transcript, self.zt.n_words, cfg.n64)
            if drawn != cfg:
                raise ZincError("field config mismatch: wrong public input binding")
        ccs_f = ccs.map_to_field(cfg)

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
            with timed("verify.spartan"):
                try:
                    points = spartan_verify(proof.spartan_proof, ccs_f, transcript, cfg)
                except SpartanError as e:
                    raise ZincError(f"Spartan verification failed: {e}") from e
            r_x = points.rx_ry[: ccs_f.s]
            r_y = points.rx_ry[ccs_f.s :]
            jobs["points"] = (r_x, r_y)
            points_ready.set()
            with timed("verify.code_setup"):
                code = RaaCode(self.lc_spec, ccs_f.m, transcript, self.zt)
                pp = setup(ccs_f.m, code, self.zt)
            pcs_transcript = PcsTranscript.from_proof(proof.zip_proof.pcs_proof)
            with timed("verify.pcs"):
                try:
                    verify_poly(pp, proof.zip_proof.z_comm, r_y, proof.zip_proof.v,
                                pcs_transcript, cfg, self.device)
                except Exception as e:
                    raise ZincError(f"PCS verification failed: {e}") from e
        finally:
            points_ready.set()
            worker.join()
        with timed("verify.final_evals"):
            if "error" in jobs:
                raise jobs["error"]
            v_xy = fetch_mle_evals(cfg, jobs["handles"])
        if not lin_comb_gamma(points.gamma, v_xy) * proof.zip_proof.v == points.e_y:
            raise ZincError("gamma combination of matrix evaluations != e_y")
