"""End-to-end example: the same prove sharded over a mesh of devices.

The port of ``zinc_tpu/examples/mesh_prove.py``.  The sumchecks, the
commit and the open run sharded over a ``parallel.Mesh``; the example
proves on one device and on the mesh, checks that the serialized proofs are
the same bytes, and verifies the mesh's proof.  The mesh spans every
visible card, or, on one card, four shards of it (``Mesh([cuda:0] * 4)``);
on the CPU, four shards of the CPU:

    python -m zinc_tpu_torch.examples.mesh_prove [cpu]
"""

from __future__ import annotations

import random
import sys
import time

import torch

from ..ccs import dummy_ccs_of_size
from ..parallel import Mesh, local_mesh
from ..prime import draw_random_field
from ..serialize import serialize_proof
from ..sumcheck.executor import SUMCHECKS
from ..transcript import KeccakTranscript
from ..zinc import ZincProver, ZincVerifier
from ..zip.code import ZipTypes

INT_LIMBS = 1
FIELD_LIMBS = 4


def default_mesh(device="cuda") -> Mesh:
    """Every visible card, or four shards of the one card (or of the CPU)."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() > 1:
        return local_mesh()
    return Mesh([torch.device(device)] * 4)


def run_example(log_n: int = 10, verbose: bool = True, device="cuda", mesh: Mesh | None = None):
    zt = ZipTypes(INT_LIMBS)
    mesh = mesh or default_mesh(device)
    _, ccs, statement, witness = dummy_ccs_of_size(1 << log_n, random.Random(7), int_bits=62)

    def prove(**where):
        t = KeccakTranscript()
        cfg = draw_random_field(statement.public_input, t, zt.n_words, FIELD_LIMBS)
        t0 = time.perf_counter()
        proof = ZincProver(zt, **where).prove(statement, witness, t, ccs, cfg)
        return cfg, proof, time.perf_counter() - t0

    if verbose:
        print(f"2^{log_n} constraints, {mesh}")
    cfg_1, proof_1, dt_1 = prove(device=mesh.first)  # one device, the reference
    cfg_m, proof_m, dt_m = prove(mesh=mesh)
    blob_1, blob_m = serialize_proof(proof_1, cfg_1), serialize_proof(proof_m, cfg_m)
    assert blob_1 == blob_m, "mesh proof bytes diverge from one device's"
    if verbose:
        rounds = [r["sharded_rounds"] for r in list(SUMCHECKS)[-2:]]
        print(f"one device {dt_1:.2f} s | mesh of {mesh.size} {dt_m:.2f} s; sharded rounds per "
              f"sumcheck {rounds}, commit {mesh.stats['commit']}")
        print(f"proof bytes identical across layouts ({len(blob_m)} bytes)")

    ZincVerifier(zt, device=mesh.first).verify(statement, proof_m, KeccakTranscript(), ccs, cfg_m)
    if verbose:
        print("verification: ACCEPT")
    return proof_m


if __name__ == "__main__":
    run_example(device=sys.argv[1] if len(sys.argv) > 1 else "cuda")
