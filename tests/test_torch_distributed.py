"""The port's mesh over two processes (zinc_tpu_torch.parallel), the
counterpart of tests/test_dcn_multiprocess.py: two processes run gloo over
localhost, each with the local devices ["cpu", "cpu"], on
``hierarchical_mesh(2, 2)``, so every cross-shard step of the prove (the
round residues, the hand-over, the commit's roots, the open's accumulators
and column records) is an all-gather between the processes.  The children
import the port only, with jax unimportable.  Each child has a timeout of
its own, and a process that dies makes the other raise, not hang."""

import os
import random
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import zinc_tpu_torch as zt
from tests.golden.gen import N, SEED
from zinc_tpu_torch.parallel import Mesh, ProcessGroup, hierarchical_mesh, init_distributed

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "proof_2p10.bin"
CHILD_TIMEOUT_S = 240

_WORKER = textwrap.dedent(
    """
    import os, random, sys
    sys.modules["jax"] = None
    sys.path.insert(0, {root!r})
    rank, port, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3]

    import zinc_tpu_torch as zt
    from zinc_tpu_torch.parallel import hierarchical_mesh, init_distributed

    if mode == "prove":  # torch's variables, set by the parent
        assert init_distributed(timeout_s=60)
    else:
        assert init_distributed(init_method=f"tcp://127.0.0.1:{{port}}", world_size=2, rank=rank,
                                timeout_s=60)
    assert init_distributed()  # a second call is a no-op
    if mode == "exit" and rank == 1:
        os._exit(3)  # a rank that dies before the prove
    mesh = hierarchical_mesh(2, 2, devices=["cpu", "cpu"])
    assert mesh.axis_names == ("host", "chip") and mesh.shape == {{"host": 2, "chip": 2}}
    assert mesh.group.backend == "gloo" and mesh.local_rows == range(rank, rank + 1)

    _, ccs, st, wit = zt.dummy_ccs_of_size({n}, random.Random({seed}), int_bits=62)

    def prove(**kw):
        t = zt.KeccakTranscript()
        cfg = zt.draw_random_field(st.public_input, t, 1, 4)
        return zt.ZincProver(zt.ZipTypes(1), **kw).prove(st, wit, t, ccs, cfg), cfg

    proof, cfg = prove(mesh=mesh)
    blob = zt.serialize_proof(proof, cfg)
    host, _ = prove(backend="host")
    assert blob == zt.serialize_proof(host, cfg), "the two-process proof differs from the host oracle"
    assert blob == open({golden!r}, "rb").read(), "the two-process proof differs from the golden"
    zt.ZincVerifier(zt.ZipTypes(1), device="cpu").verify(st, proof, zt.KeccakTranscript(), ccs, cfg)
    assert mesh.stats == {{"sharded_rounds": [2, 2], "commit": ["2 row blocks x 2 column blocks"]}}
    assert mesh.group.calls > 0 and mesh.group.bytes > 0
    assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
    assert "zinc_tpu" not in sys.modules
    print("DIST_OK", rank, len(blob), mesh.group.calls, mesh.group.bytes, flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two(tmp_path, mode: str) -> list[tuple[int, str]]:
    """Both ranks' (return code, output); each child is killed at its own
    timeout, and a child that had to be killed fails the test."""
    worker = tmp_path / "dist_worker.py"
    worker.write_text(_WORKER.format(root=str(ROOT), n=N, seed=SEED, golden=str(GOLDEN)))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JAX") and k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                                                    "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "2"
    coords = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2"}
    procs = [subprocess.Popen([sys.executable, str(worker), str(rank), str(port), mode],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env={**env, **coords, "RANK": str(rank)} if mode == "prove" else env)
             for rank in (0, 1)]
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
            results.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def test_two_process_mesh_prove_is_the_golden(tmp_path):
    """Both ranks, started from torch's variables (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK), prove the 2^10 golden on a (2 host × 2 chip) mesh of
    CPU shards, equal to the port's host oracle; the verifier accepts."""
    results = _run_two(tmp_path, "prove")
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, out[-3000:]
        assert f"DIST_OK {rank} {GOLDEN.stat().st_size}" in out, out[-3000:]


def test_a_rank_that_exits_makes_the_other_raise(tmp_path):
    """Ranks started from explicit coordinates; rank 1 exits after the group
    is up: rank 0's first collective raises, within its timeout, and its
    process exits non-zero."""
    (rc0, out0), (rc1, _) = _run_two(tmp_path, "exit")
    assert rc1 == 3
    assert rc0 not in (0, None) and "DIST_OK" not in out0
    assert "Error" in out0, out0[-3000:]


def test_init_distributed_without_coordinates_starts_nothing(monkeypatch):
    """No arguments and none of torch's variables: False, and no group; a
    world of one starts none either.  Half the coordinates, or NCCL where
    the processes have no card each, raise before any group starts."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert init_distributed(init_method="tcp://127.0.0.1:1", world_size=1, rank=0) is False
    with pytest.raises(ValueError, match="world_size"):
        init_distributed(init_method="tcp://127.0.0.1:1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="NCCL"):
        init_distributed(init_method="tcp://127.0.0.1:1", world_size=2, rank=0, backend="nccl")
    assert not torch.distributed.is_initialized()


def test_single_process_hierarchical_mesh_proves_as_its_mesh():
    """In one process ``hierarchical_mesh(2, 2, devices)`` is the 2 × 2
    ``Mesh`` of those devices: the same proof (the golden), the same
    layout; without a shape it raises, as the reference's does."""
    _, ccs, statement, wit = zt.dummy_ccs_of_size(N, random.Random(SEED), int_bits=62)
    blobs = []
    h = hierarchical_mesh(2, 2, devices=["cpu"] * 4)
    plain = Mesh(np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2), ("host", "chip"))
    assert h.group is None and h.shape == plain.shape == {"host": 2, "chip": 2}
    for mesh in (h, plain):
        t = zt.KeccakTranscript()
        cfg = zt.draw_random_field(statement.public_input, t, 1, 4)
        proof = zt.ZincProver(zt.ZipTypes(1), mesh=mesh).prove(statement, wit, t, ccs, cfg)
        blobs.append(zt.serialize_proof(proof, cfg))
    assert blobs[0] == blobs[1] == GOLDEN.read_bytes()
    assert h.stats == plain.stats
    with pytest.raises(ValueError, match="explicit shape"):
        hierarchical_mesh(devices=["cpu"] * 4)


def test_a_process_mesh_must_have_a_row_per_process():
    """A mesh whose rows are processes must have as many rows as there are
    processes: the prover refuses two rows over three processes, as it
    refuses more than two axes; a rank needs a row of its own."""
    two_rows = np.empty((2, 2), dtype=object)
    two_rows[0] = ["cpu", "cpu"]
    mesh = Mesh(two_rows, ("host", "chip"), ProcessGroup(0, 3, "gloo", "cpu"))
    assert mesh.first == torch.device("cpu") and mesh.local_rows == range(0, 1)
    with pytest.raises(ValueError, match="process rows"):
        zt.ZincProver(zt.ZipTypes(1), mesh=mesh)
    with pytest.raises(ValueError, match="no row"):
        Mesh(two_rows, ("host", "chip"), ProcessGroup(2, 3, "gloo", "cpu"))
