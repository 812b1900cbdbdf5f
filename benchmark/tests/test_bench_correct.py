"""The comparison that decides ``correct``, driven through the harness on
the CPU at 2^10 (the card's look skipped): sound runs come out correct;
the control (the program at the next narrower field) and each fault the
cells can have, planted in the program underneath the timed path, come out
not correct.  One chip: no exchange between chips to leave out."""

import time

import pytest
import torch

from _paths import ROOT  # noqa: F401
from benchmark.harness import spec as specs
from benchmark.harness.runner import run_cell
from zinc_tpu_torch.sumcheck import executor, kernels
from zinc_tpu_torch.zip import device as zip_device

CELLS = ["r1cs-2p14", "sumcheck-2p20"]


def _run(cell, seed=987654321012, control=False, warm=1):
    spec = specs.load(cell)
    spec.traffic = dict(spec.traffic, log_n=10, warmup_steps=warm, check_sample=2)
    return run_cell(cell, seed, 0.5, False, "cpu", time.perf_counter(), spec=spec,
                    control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = _run(cell, control=True)
    assert not res["correct"]
    assert sum(c["value"] for c in res["checks"].values()) > 0


def _altered_values(monkeypatch):
    """An answer altered where it is produced: each round's first value."""
    real = executor.round_values

    def altered(*a, **k):
        vals = real(*a, **k)
        return [vals[0] + vals[0].cfg.one()] + vals[1:]

    monkeypatch.setattr(executor, "round_values", altered)


def _unchanged_state(monkeypatch):
    """A fold that leaves its state as it was: the pairs' first entries,
    untouched by the challenge."""
    real_fre = kernels.fold_round_eval

    def fold(ctx, tables, r):
        return tables[..., 0::2, :].contiguous()

    def fold_round_eval(ctx, tables, r, terms, n_pts):
        folded = tables[..., 0::2, :].contiguous()
        return folded, kernels.round_eval_generic(ctx, folded, terms, n_pts)

    monkeypatch.setattr(kernels, "fold", fold)
    monkeypatch.setattr(kernels, "fold_round_eval", fold_round_eval)
    assert real_fre is not kernels.fold_round_eval


def _half_batch(monkeypatch):
    """Half of the pairs left out of a round's sums, the other half counted
    twice (the mean taken over the rest)."""
    for name in ("round_eval", "round_eval_generic", "round_eval_gruen"):
        real = getattr(kernels, name)

        def half(ctx, tables, *rest, _real=real):
            b = tables.shape[-2]
            if b >= 4:
                first = tables[..., : b // 2, :]
                tables = torch.cat([first, first], dim=-2).contiguous()
            return _real(ctx, tables, *rest)

        monkeypatch.setattr(kernels, name, half)


def _altered_root(monkeypatch):
    """A commitment altered where it is produced: one bit of the first root."""
    real = zip_device.commit_device

    def commit(*a, **k):
        data, comm = real(*a, **k)
        comm.roots[0] = bytes([comm.roots[0][0] ^ 1]) + comm.roots[0][1:]
        return data, comm

    monkeypatch.setattr(zip_device, "commit_device", commit)


# the R1CS path's sumchecks run their rounds' values on the device (device
# Fiat-Shamir), so its altered answer is the commitment's
FAULTS = {"sumcheck-2p20": {"altered_values": _altered_values, "unchanged_state": _unchanged_state,
                            "half_batch": _half_batch},
          "r1cs-2p14": {"altered_root": _altered_root, "unchanged_state": _unchanged_state,
                        "half_batch": _half_batch}}


@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS for f in sorted(FAULTS[c])])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[cell][fault](monkeypatch)
    res = _run(cell, warm=0)
    assert not res["correct"], res["checks"]


def test_chains_alone_find_a_fault_in_every_step(monkeypatch):
    """With no step sampled for the full reference, the every-step chains
    still find an altered answer, and each such step counts as failed."""
    _altered_values(monkeypatch)
    spec = specs.load("sumcheck-2p20")
    spec.traffic = dict(spec.traffic, log_n=10, warmup_steps=0, check_sample=0)
    res = run_cell("sumcheck-2p20", 987654321013, 0.5, False, "cpu", time.perf_counter(),
                   spec=spec)
    assert not res["correct"]
    assert res["checks"]["chains"]["value"] == res["attempted"] == res["failed"] >= 1
    assert res["checks"]["rounds"]["value"] == 0  # nothing sampled
