"""The program's own spans in the trace (``zinc_tpu_torch/timing.py``:
``record_function`` while the profiler runs), read a prove at a time."""

from __future__ import annotations

import numpy as np

from .readout import proves


def seconds_in_proves(run, name: str) -> list[float] | None:
    """For each traced prove span, the summed seconds of the program's
    ``name`` spans that start inside it; None untraced, or where the
    program records no such span."""
    sp = proves(run)
    if sp is None:
        return None
    starts, ends = run.trace.spans(name)
    if not len(starts):
        return None
    return [float(np.sum((ends - starts)[(starts >= lo) & (starts < hi)])) / 1e6
            for lo, hi in zip(*sp)]


def mean_in_proves(run, name: str) -> float | None:
    """The mean over the traced proves of :func:`seconds_in_proves`."""
    per_prove = seconds_in_proves(run, name)
    return None if per_prove is None else sum(per_prove) / len(per_prove)
