"""Shared reading for the metrics' readers (``metrics/<name>.py``): each
reader is ``read(run) -> number | None`` over a ``runner.Run``."""

from __future__ import annotations

from .stats import covered, mean, union


def walls(run, kind: str) -> list[float]:
    return [s["walls"][kind] for s in run.completed if kind in s["walls"]]


def stage_mean(run, label: str) -> float | None:
    """The mean over the window's steps of a stage wall the program records
    (``zinc_tpu_torch.timing.STAGES``)."""
    return mean(s["stages"][label] for s in run.completed if label in s["stages"])


def proves(run):
    """The traced prove spans (starts, ends in µs), or None untraced."""
    if run.trace is None:
        return None
    starts, ends = run.trace.spans("bench.prove")
    return (starts, ends) if len(starts) else None


def device_busy_in_proves(run) -> tuple[float, float] | None:
    """(µs in which the device worked inside the prove spans, µs of the
    spans)."""
    sp = proves(run)
    if sp is None:
        return None
    tr = run.trace
    s, e = union(tr.dev_start, tr.dev_end)
    busy = sum(covered(s, e, lo, hi) for lo, hi in zip(*sp))
    return busy, float((sp[1] - sp[0]).sum())
