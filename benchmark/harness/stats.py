"""The arithmetic of the metrics: means, a nearest-rank percentile, and
unions of time intervals."""

from __future__ import annotations

import math

import numpy as np


def mean(values) -> float | None:
    values = list(values)
    return sum(values) / len(values) if values else None


def percentile(values, p: float) -> float | None:
    """Nearest rank: the smallest value with at least p% of the values at or
    below it."""
    values = sorted(values)
    if not values:
        return None
    return values[max(0, math.ceil(p / 100 * len(values)) - 1)]


def union(starts, ends) -> tuple[np.ndarray, np.ndarray]:
    """The disjoint, sorted intervals that cover [starts[i], ends[i]]."""
    starts, ends = np.asarray(starts, float), np.asarray(ends, float)
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.empty(len(s), bool)
    new[0] = True
    new[1:] = s[1:] > e[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(e[idx[1:] - 1], e[-1])


def covered(starts, ends, lo: float, hi: float) -> float:
    """Length of [lo, hi] covered by the disjoint intervals."""
    s, e = np.clip(starts, lo, hi), np.clip(ends, lo, hi)
    return float(np.sum(e - s))
