"""The profiler's trace of a window, reduced to what the per-layer metrics
and the breakdown read.

The window runs under ``torch.profiler`` (host ops and the device's
activity); its Chrome trace is written to a temporary file, read back and
deleted.  Device work is every kernel, copy and memset; host spans are the
benchmark's own (``bench.*``, from ``span``) and the program's torch ops.
All times are the trace's microseconds, host and device on one clock.
"""

from __future__ import annotations

import json
import os
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np

from .stats import covered, union

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160  # a kernel's template name can run to a kilobyte
HOST_CATS = ("cpu_op", "user_annotation")


@contextmanager
def span(name: str):
    """A host span in the trace (free when nothing is profiling)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


@dataclass
class Trace:
    dev_name: list
    dev_start: np.ndarray
    dev_end: np.ndarray
    dev_kernel: np.ndarray  # bool: a kernel (not a copy or memset)
    host_name: list
    host_start: np.ndarray
    host_end: np.ndarray

    @staticmethod
    def from_events(events: list[dict]) -> "Trace":
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]

        def arrays(evs):
            start = np.array([float(e["ts"]) for e in evs])
            return start, start + np.array([float(e.get("dur", 0)) for e in evs])

        ds, de = arrays(dev)
        hs, he = arrays(host)
        return Trace([e["name"][:NAME_CHARS] for e in dev], ds, de,
                     np.array([e["cat"] == "kernel" for e in dev], bool),
                     [e["name"][:NAME_CHARS] for e in host], hs, he)

    def spans(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        idx = [i for i, n in enumerate(self.host_name) if n == name]
        return self.host_start[idx], self.host_end[idx]

    def busy_us(self, lo: float, hi: float) -> float:
        s, e = union(self.dev_start, self.dev_end)
        return covered(s, e, lo, hi)

    def inside(self, starts, ends) -> np.ndarray:
        """Device events that start inside one of the disjoint spans."""
        order = np.argsort(starts)
        starts, ends = np.asarray(starts)[order], np.asarray(ends)[order]
        i = np.searchsorted(starts, self.dev_start, side="right") - 1
        ok = i >= 0
        ok[ok] = self.dev_start[ok] < ends[i[ok]]
        return ok

    def top_ops(self, lo: float, hi: float, k: int = 10) -> list:
        tot: dict[str, float] = {}
        for n, s, e in zip(self.dev_name, self.dev_start, self.dev_end):
            if s >= lo and s < hi:
                tot[n] = tot.get(n, 0.0) + (e - s) / 1e6
        return sorted(([n, t] for n, t in tot.items()), key=lambda x: -x[1])[:k]

    def host_at(self, t: float) -> str:
        """The innermost host span covering time t: the latest to start, the
        first to end among those."""
        live = np.flatnonzero((self.host_start <= t) & (self.host_end >= t))
        if live.size == 0:
            return "no host span"
        return self.host_name[live[np.lexsort((self.host_end[live], -self.host_start[live]))[0]]]

    def idle_gaps(self, lo: float, hi: float, k: int = 10) -> list:
        """The k longest stretches of [lo, hi] with no device work, each
        named by the host span that covers its middle."""
        s, e = union(self.dev_start, self.dev_end)
        keep = (e > lo) & (s < hi)
        s, e = np.clip(s[keep], lo, hi), np.clip(e[keep], lo, hi)
        gap_s = np.concatenate([[lo], e])
        gap_e = np.concatenate([s, [hi]])
        length = gap_e - gap_s
        order = np.argsort(-length)[:k]
        return [[self.host_at((gap_s[i] + gap_e[i]) / 2), float(length[i]) / 1e6]
                for i in order if length[i] > 0]


def profiler(device: str):
    """``torch.profiler`` of the host ops and, on the card, its activity."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def read(prof) -> Trace:
    """The closed profiler's trace, through a temporary Chrome trace file."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
    finally:
        os.remove(path)
    return Trace.from_events(data["traceEvents"] if isinstance(data, dict) else data)
