"""The four-card cell's driver (``drivers/zinc_r1cs_mesh.py``) on the CPU
at 2^10, its prover on ``Mesh(["cpu"] * 4)``: sound runs come out correct,
every proof byte-identical to the reference's and accepted by the
verifier; a shard's block of the sumcheck tables altered after the
scatter comes out not correct; each step keeps the program's count of
the copies between the shards, which ``mesh_bytes`` reads."""

import time

from _paths import ROOT  # noqa: F401
from benchmark.harness import spec as specs
from benchmark.harness.runner import run_cell
from zinc_tpu_torch.parallel import sumcheck as psumcheck

CELL = "r1cs-2p22.mesh4"


def _spec(warm=1):
    spec = specs.load(CELL)
    spec.traffic = dict(spec.traffic, log_n=10, warmup_steps=warm, check_sample=2)
    return spec


def _run(seed=987654321014, control=False, warm=1):
    return run_cell(CELL, seed, 0.5, False, "cpu", time.perf_counter(), spec=_spec(warm),
                    control=control)


def test_mesh_cell_is_a_four_card_prover_cell():
    spec = specs.load(CELL)
    assert spec.workload["chips"] == spec.config["mesh"]["cards"] == 4
    assert [m["name"] for m in spec.end_to_end] == ["prove_s", "setup_s"]
    assert spec.traffic["log_n"] == 22


def test_sound_mesh_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert res["device"]["count"] == 4


def test_mesh_control_is_not_correct():
    res = _run(control=True)
    assert not res["correct"]
    assert sum(c["value"] for c in res["checks"].values()) > 0


def test_a_shard_altered_after_the_scatter_is_not_correct(monkeypatch):
    real = psumcheck.shard_tables

    def altered(mesh, tables):
        blocks, group = real(mesh, tables)
        if len(blocks) > 1:
            blocks[1] = blocks[1].clone()
            blocks[1][0, 0, 0] ^= 1
        return blocks, group

    monkeypatch.setattr(psumcheck, "shard_tables", altered)
    res = _run(warm=0)
    assert not res["correct"], res["checks"]


def test_each_step_keeps_the_mesh_count():
    spec = _spec()
    cell = specs.module("drivers", spec.config["driver"]).Cell(spec.config, spec.traffic,
                                                               987654321015, "cpu")
    try:
        assert cell.mesh.size == 4 and cell.cards == []
        rec = cell.step(0, cell.inputs(0))
        assert rec["error"] is None and rec["accepted"]
        assert rec["mesh"]["bytes"] > 0 and rec["mesh"]["scatter"] > 0
        assert rec["mesh"]["handover"] > 0
    finally:
        cell.close()

    class Run:
        completed = [rec, dict(rec, mesh=None)]

    mesh_bytes = specs.module("metrics", "mesh_bytes")
    assert mesh_bytes.read(Run) == rec["mesh"]["bytes"] / 1e6
    Run.completed = [dict(rec, mesh=None)]
    assert mesh_bytes.read(Run) is None
    Run.window_peak_bytes = None  # a run off the cards
    assert specs.module("metrics", "peak_mem_gib.mesh").read(Run) is None
