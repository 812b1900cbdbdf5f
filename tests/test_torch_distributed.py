"""The port's mesh over two processes (zinc_tpu_torch.parallel), the
counterpart of tests/test_dcn_multiprocess.py: two processes run gloo over
localhost, each with the local devices ["cpu", "cpu"], on
``hierarchical_mesh(2, 2)``, so every cross-shard step of the prove (the
round sums, the hand-over, the commit's roots, the open's accumulators
and column records) is an all-gather between the processes.  Both
sumchecks run the device-FS driver (``sumcheck/device_fs.py``) on every rank,
each rank's sponge squeezing over every shard's gathered sums, and are
held against the per-round driver on the same tables.  The children
import the port (and chip_smoke.py, which imports nothing else) only,
with jax unimportable.  Each child has a timeout of its own, and a process
that dies makes the other raise, not hang."""

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

import chip_smoke
import zinc_tpu_torch as zt
from tests.golden.gen import N, SEED
from zinc_tpu_torch.parallel import (
    Mesh,
    ProcessGroup,
    hierarchical_mesh,
    init_distributed,
)
from zinc_tpu_torch.sumcheck.device_fs import start_fs
from zinc_tpu_torch.sumcheck.executor import make_executor

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "proof_2p10.bin"
CHILD_TIMEOUT_S = 240

_WORKER = textwrap.dedent(
    """
    import os, random, sys
    sys.modules["jax"] = None
    sys.path.insert(0, {root!r})
    rank, port, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3]

    import hashlib, json
    import torch
    import chip_smoke
    import zinc_tpu_torch as zt
    from zinc_tpu_torch.parallel import hierarchical_mesh, init_distributed
    from zinc_tpu_torch.sumcheck.executor import SUMCHECKS

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
    group = mesh.group

    if mode == "gather":
        x = torch.arange(6, dtype=torch.int32).reshape(2, 3) + 100 * rank
        out = group.all_gather_stacked(x)
        assert out.shape == (2, 2, 3) and out.dtype == x.dtype and out.device == x.device
        for r in range(2):
            assert torch.equal(out[r], torch.arange(6, dtype=torch.int32).reshape(2, 3) + 100 * r)
        assert (group.calls, group.bytes, group.staged) == (1, 24, 0)
        print("GATHER_OK", rank, flush=True)
        raise SystemExit(0)

    if mode == "drivers":  # the golden's tables under both sharded drivers
        chip_smoke.compare_drivers("2 processes", chip_smoke.setup({n}, {seed})[:3], device="cpu",
                                   mesh=mesh)
        print("DRIVERS_OK", rank, flush=True)
        raise SystemExit(0)

    def prove(st, wit, ccs, **kw):
        t = zt.KeccakTranscript()
        cfg = zt.draw_random_field(st.public_input, t, 1, 4)
        proof = zt.ZincProver(zt.ZipTypes(1), **kw).prove(st, wit, t, ccs, cfg)
        return proof, cfg, t

    def sumchecks():
        return json.dumps([(r["driver"], r["fetches"], r["sharded_rounds"]) for r in SUMCHECKS])

    if mode == "path_a":  # sumcheck 1 on the generic tier
        ccs, st, wit = chip_smoke.degree4_fixture(1 << 10, 1234)
        proof, cfg, _ = prove(st, wit, ccs, mesh=mesh)
        digest = hashlib.sha256(zt.serialize_proof(proof, cfg)).hexdigest()
        assert digest == chip_smoke.PATH_A_SHA256_2P10, digest
        assert [r["sharded_rounds"] for r in SUMCHECKS] == [2, 2]
        print("PATH_A_OK", rank, group.calls, sumchecks(), flush=True)
        raise SystemExit(0)

    _, ccs, st, wit = zt.dummy_ccs_of_size({n}, random.Random({seed}), int_bits=62)
    proof, cfg, t = prove(st, wit, ccs, mesh=mesh)
    print("SUMCHECKS", sumchecks(), flush=True)
    print("TRANSCRIPT", t.h.digest().hex(), flush=True)
    blob = zt.serialize_proof(proof, cfg)
    host, _, _ = prove(st, wit, ccs, backend="host")
    assert blob == zt.serialize_proof(host, cfg), "the two-process proof differs from the host oracle"
    assert blob == open({golden!r}, "rb").read(), "the two-process proof differs from the golden"
    zt.ZincVerifier(zt.ZipTypes(1), device="cpu").verify(st, proof, zt.KeccakTranscript(), ccs, cfg)
    assert [r["sharded_rounds"] for r in SUMCHECKS] == [2, 2]
    assert mesh.stats == {{"commit": ["2 row blocks x 2 column blocks"]}}
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


@pytest.fixture(scope="module")
def proved(tmp_path_factory):
    """Both ranks' (return code, output) of the "prove" run."""
    return _run_two(tmp_path_factory.mktemp("prove"), "prove")


def _line(out: str, tag: str) -> str:
    found = [ln for ln in out.splitlines() if ln.startswith(tag + " ")]
    assert found, out[-3000:]
    return found[-1][len(tag) + 1:]


def test_two_process_mesh_prove_is_the_golden(proved):
    """Both ranks, started from torch's variables (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK), prove the 2^10 golden on a (2 host × 2 chip) mesh of
    CPU shards, equal to the port's host oracle; the verifier accepts."""
    for rank, (rc, out) in enumerate(proved):
        assert rc == 0, out[-3000:]
        assert f"DIST_OK {rank} {GOLDEN.stat().st_size}" in out, out[-3000:]


def test_two_process_mesh_prove_runs_device_fs(proved):
    """The golden prove on two processes runs both sumchecks on the device-FS
    driver on each rank, 2 rounds of each on the 4 shards and one fetch
    each (gloo gathers CPU tensors as they are: nothing is staged), in 10
    all-gathers a rank (the open's column records in one); both ranks'
    transcripts end in the same sponge."""
    digests = []
    for rank, (rc, out) in enumerate(proved):
        assert rc == 0, out[-3000:]
        assert _line(out, "SUMCHECKS") == '[["device_fs", 1, 2], ["device_fs", 1, 2]]'
        assert _line(out, f"DIST_OK {rank}").split()[1] == "10"
        digests.append(_line(out, "TRANSCRIPT"))
    assert digests[0] == digests[1]


def test_two_process_drivers_agree(tmp_path):
    """On each rank, Spartan's two sumchecks of the golden circuit under the
    device-FS driver and under the per-round driver, both on the mesh, on
    the same tables from clones of one transcript: equal proofs, r_y, v and
    transcript states (chip_smoke.compare_drivers, which also checks each
    run's drivers and the device-FS runs' single fetch)."""
    for rank, (rc, out) in enumerate(_run_two(tmp_path, "drivers")):
        assert rc == 0, out[-3000:]
        assert f"DRIVERS_OK {rank}" in out, out[-3000:]


def test_two_process_path_a_hashes_to_the_pin(tmp_path):
    """Path A at 2^10 (sumcheck 1 on the generic tier, the plain versions of
    K7/K10) on two processes: both ranks' proofs hash to
    PATH_A_SHA256_2P10, both sumchecks on the device-FS driver, in 10
    all-gathers a rank."""
    for rank, (rc, out) in enumerate(_run_two(tmp_path, "path_a")):
        assert rc == 0, out[-3000:]
        calls, recs = _line(out, f"PATH_A_OK {rank}").split(" ", 1)
        assert calls == "10" and recs == '[["device_fs", 1, 2], ["device_fs", 1, 2]]'


def test_all_gather_stacked_is_in_rank_order(tmp_path):
    """``ProcessGroup.all_gather_stacked`` returns every rank's tensor stacked
    in rank order, on the input's device and of its dtype, and counts one
    call and the bytes in from the other rank; a CPU tensor under gloo is
    not staged."""
    for rank, (rc, out) in enumerate(_run_two(tmp_path, "gather")):
        assert rc == 0, out[-3000:]
        assert f"GATHER_OK {rank}" in out, out[-3000:]


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


def _rank0_mesh(world: int = 2, backend: str = "gloo", device: str = "cpu") -> Mesh:
    rows = np.empty((world, 2), dtype=object)
    rows[0] = [device, device]
    return Mesh(rows, ("host", "chip"), ProcessGroup(0, world, backend, device))


def test_a_process_mesh_takes_the_device_fs_driver():
    """A mesh over processes takes the device-FS driver: ``start_fs``
    accepts its executor (``make_executor(..., mesh=)``), whose blocks are
    rank 0's two of four."""
    mesh = _rank0_mesh()
    ccs, statement, wit, _, cfg = chip_smoke.setup(1 << 10, 5)
    comb = [(cfg.one(), (0, 1))]
    tables = torch.zeros((2, 1 << 10, 2 * cfg.n64), dtype=torch.int32)
    ex = make_executor(cfg, tables, 2, comb, mesh=mesh)
    assert ex.group is mesh.group and ex.n_blocks == 4 and len(ex.blocks) == 2
    run = start_fs(zt.KeccakTranscript(), ex, 10, 2)
    assert run.n_dev == 4 and run.rs.shape == (4, 2 * cfg.n64)


def test_nccl_gathers_only_on_the_groups_card():
    """Under NCCL ``all_gather_stacked`` refuses a tensor that does not lie on
    the group's card, before any collective (nothing is staged quietly)."""
    group = ProcessGroup(0, 2, "nccl", "cuda:0")
    with pytest.raises(ValueError, match="NCCL"):
        group.all_gather_stacked(torch.zeros(4, dtype=torch.int32))
    assert (group.calls, group.bytes, group.staged) == (0, 0, 0)


def test_gloo_stages_only_tensors_on_a_card():
    """``ProcessGroup.stages`` says which gathers go through the host: under
    gloo those of tensors on a card, never those of CPU tensors, and never
    under NCCL (which gathers card to card or refuses)."""
    gloo, nccl = ProcessGroup(0, 2, "gloo", "cpu"), ProcessGroup(0, 2, "nccl", "cuda:0")
    assert gloo.stages("cuda:0") and gloo.stages(torch.device("cuda", 1))
    assert not gloo.stages("cpu")
    assert not nccl.stages("cuda:0") and not nccl.stages("cpu")
