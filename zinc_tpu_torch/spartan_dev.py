"""Device Spartan prover, transcript-identical to ``spartan.spartan_prove``.

The port of ``zinc_tpu/spartan_dev.py``.  The witness-sized state lives on
the device: the field-projected z, the Mz tables, the eq tables and the
sumcheck folds.  Each sumcheck runs device-resident Fiat-Shamir
(``sumcheck/device_fs.py``), one host sync a sumcheck, on one device or
on a mesh (in one process or over several), whose executor shards the
tables where the mesh's shards divide the hypercube and keeps them whole
on its first device where they do not (``parallel/sumcheck.py``).  The
reference (``spartan_dev.py:100-137``) takes its per-round sharded
driver on the second kind of mesh; the port needs no such fork.  The
folded values double as V_s (sumcheck 1) and as the PCS opening value
z̃(r_y) (sumcheck 2).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .ccs import CCS, Statement
from .fields.config import FieldConfig
from .spartan import SpartanProof, squeeze_beta_challenges, squeeze_gamma_challenge
from .transcript import KeccakTranscript
from .fields import montgomery as fm
from .fields.montgomery import device_field
from .ops.field_kernels import mont_mul
from .ops.field_map import vector_to_field
from .ops.sparse import eval_table_device, make_csr, mat_vec_mul_device
from .poly.device import _eq_table_device, fps_to_tensor
from .sumcheck.device import wants_gruen
from .sumcheck.device_fs import prove_as_subprotocol_device_fs
from .timing import timed


@dataclass
class DeviceStatement:
    """Statement uploaded once; reusable across proofs of the same circuit."""

    matrices: list  # list[DeviceCsr]
    cfg: FieldConfig

    @staticmethod
    def upload(cfg: FieldConfig, statement: Statement, device) -> "DeviceStatement":
        """``ops.sparse.upload_matrix`` of each matrix, its three steps spanned."""
        matrices = []
        for m in statement.constraints:
            with timed("prove.upload.coo"):
                rows, cols, vals = m.packed_coo()
            with timed("prove.upload.field_map"):
                vals_f = vector_to_field(cfg, vals, device)
            with timed("prove.upload.csr"):
                matrices.append(make_csr(rows, cols, vals_f, m.n_rows, m.n_cols, device))
        return DeviceStatement(matrices=matrices, cfg=cfg)


def _sc1_setup(cfg, mats, z_f, beta_t, with_eq: bool) -> torch.Tensor:
    """Mz per matrix (+ the eq(β) table unless Gruen factors eq out):
    (t[+1], m, n32)."""
    mz = [mat_vec_mul_device(cfg, m, z_f) for m in mats]
    if with_eq:
        mz.append(_eq_table_device(device_field(cfg), beta_t))
    return torch.stack(mz)


def _sc2_setup(cfg, mats, z_f, rx_t, gamma_t) -> torch.Tensor:
    """eq(r_x), Σⱼ γʲ·(r_xᵀMⱼ) by Horner, stacked with z: (2, m, n32)."""
    ctx = device_field(cfg)
    eq_rx = _eq_table_device(ctx, rx_t)
    evals = None
    for m in reversed(mats):
        table_j = eval_table_device(cfg, m, eq_rx)
        evals = table_j if evals is None else fm.mont_add(ctx, mont_mul(ctx, evals, gamma_t), table_j)
    return torch.stack([evals, z_f])


def spartan_prove_device(
    dstatement: DeviceStatement,
    z_f: torch.Tensor,  # (m, n32) field-projected z
    ccs: CCS,  # integer-flavour CCS
    transcript: KeccakTranscript,
    cfg: FieldConfig,
    mesh=None,
    sumcheck=None,
):
    """Returns (SpartanProof, r_y, v) with v = z̃(r_y) for the PCS binding.

    With a ``mesh`` (``parallel.Mesh``), the setups run where z_f lies (the
    mesh's first device) and both sumchecks run block-sharded over the
    mesh's shards; the transcript is identical.  ``sumcheck`` replaces the
    driver of both sumchecks (``sumcheck.device.prove_as_subprotocol_device``
    or a function with its arguments, ``mesh`` included, and returns), so
    that a caller can hold one driver against another on the same tables."""
    device = z_f.device
    c_f = [cfg.fp(ci) for ci in ccs.c]
    prove = sumcheck or prove_as_subprotocol_device_fs

    # ---- sumcheck 1 -------------------------------------------------------
    beta_s = squeeze_beta_challenges(transcript, ccs.s, cfg)
    eq_idx = len(dstatement.matrices)
    comb1 = [(ci, tuple(ccs.S[i]) + (eq_idx,)) for i, ci in enumerate(c_f) if not ci.is_zero()]
    gruen1 = wants_gruen(cfg, comb1, eq_idx, ccs.m)
    with timed("spartan.sc1_setup"):
        tables = _sc1_setup(
            cfg, dstatement.matrices, z_f, fps_to_tensor(beta_s, cfg, device), not gruen1
        )
    with timed("spartan.sumcheck1"):
        proof1, r_x, finals1 = prove(
            transcript, cfg, tables, ccs.s, ccs.d + 1, comb1,
            eq_beta=beta_s if gruen1 else None, mesh=mesh,
        )
    v_s = finals1[: len(dstatement.matrices)]

    # ---- sumcheck 2 -------------------------------------------------------
    gamma = squeeze_gamma_challenge(transcript, cfg)
    with timed("spartan.sc2_setup"):
        tables2 = _sc2_setup(
            cfg, dstatement.matrices, z_f, fps_to_tensor(r_x, cfg, device),
            fps_to_tensor([gamma], cfg, device)[0],
        )
    comb2 = [(cfg.one(), (0, 1))]
    with timed("spartan.sumcheck2"):
        proof2, r_y, finals2 = prove(transcript, cfg, tables2, ccs.s, 2, comb2, mesh=mesh)
    v = finals2[1]

    return SpartanProof(proof1, proof2, v_s), r_y, v
