"""Spans of the prover and verifier: nested host walls, on the profiler's
clock.

``with timed(label):`` is a span.  It records only while a
``torch.profiler`` session runs or ``ZINC_TPU_TRACE`` is set.  Otherwise
``timed`` returns one shared no-op context: a span then costs a check of
the profiler's flag and of the environment, and makes no
``record_function``, no device sync and no write to ``STAGES``.

While recording, a span

* enters ``torch.profiler.record_function(label)`` when a profiler runs,
  so that it sits in the Chrome trace as a ``user_annotation`` on the clock
  of the device's events, nested by time in its parents;
* with ``sync=True`` waits for the queued CUDA work at both ends, so that
  its wall covers its device work (the stages whose walls are read as
  layers: ``prove.upload``, ``prove.spartan``, ``prove.zip_commit``,
  ``prove.zip_open``, ``verify.pcs``); every other span takes host time
  only, and its device work is read from the trace;
* adds its wall to its root's total for its label.  A root span
  (``root=True``: ``prove``, ``verify``) starts empty totals; when it ends,
  ``STAGES[label]`` becomes its total for each label recorded in it (its
  own included; a label that the root's previous span recorded and this
  one did not leaves ``STAGES``), and ``ZINC_TPU_TRACE`` prints those
  totals to stderr, indented by depth.  A span outside any root sets
  ``STAGES[label]`` to its own wall (and ``ZINC_TPU_TRACE`` prints it).

The profiler's flag is process-wide, so a worker thread records when the
thread that started it did; :func:`carried` runs the worker's function
inside the span its starter was in, so that its spans count toward that
root.  The profiler records ``record_function`` on the thread that started
it only: a worker's spans reach ``STAGES``, not the trace.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

import torch
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

STAGES: dict[str, float] = {}
_ROOT_LABELS: dict[str, set] = {}  # the labels each root's latest span recorded

_OFF = contextlib.nullcontext()
_lock = threading.Lock()  # the totals of a root whose workers record too


class _Here(threading.local):
    root: "_Root | None" = None  # the innermost root span's totals
    depth = 0  # the spans open around this point


_here = _Here()


class _Root:
    def __init__(self):
        self.totals: dict[str, float] = {}
        self.depths: dict[str, int] = {}  # in the order the labels first started

    def add(self, label: str, dt: float) -> None:
        with _lock:
            self.totals[label] = self.totals.get(label, 0.0) + dt

    def close(self, label: str) -> None:
        for stale in _ROOT_LABELS.get(label, set()) - self.totals.keys():
            STAGES.pop(stale, None)
        _ROOT_LABELS[label] = set(self.totals)
        STAGES.update(self.totals)
        if _env():
            for name, depth in self.depths.items():
                if name in self.totals:
                    _print(name, self.totals[name], depth)


def _env() -> bool:
    return bool(os.environ.get("ZINC_TPU_TRACE"))


def _recording() -> bool:
    return _profiler._is_profiler_enabled or _env()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _print(label: str, seconds: float, depth: int = 0) -> None:
    name = "  " * depth + label
    print(f"[zinc-tpu-torch] {name} {'.' * max(2, 48 - len(name))} {seconds:.3f} s", file=sys.stderr)


class _Span:
    __slots__ = ("label", "sync", "root", "outer", "annotation", "t0")

    def __init__(self, label: str, sync: bool, root: bool):
        self.label, self.sync, self.root = label, sync, root

    def __enter__(self):
        if self.sync:
            _sync()
        self.outer = (_here.root, _here.depth)
        if self.root:
            _here.root = _Root()
        if _here.root is not None:
            _here.root.depths.setdefault(self.label, _here.depth)
        _here.depth += 1
        self.annotation = record_function(self.label) if _profiler._is_profiler_enabled else None
        if self.annotation is not None:
            self.annotation.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            _sync()
        dt = time.perf_counter() - self.t0
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        root = _here.root
        _here.root, _here.depth = self.outer
        if root is None:
            STAGES[self.label] = dt
            if _env():
                _print(self.label, dt)
            return False
        root.add(self.label, dt)
        if self.root:
            root.close(self.label)
        return False


def timed(label: str, sync: bool = False, root: bool = False):
    """A span of ``label`` (see the module notes); ``sync`` waits for the
    card at both ends, ``root`` starts the totals that ``STAGES`` takes."""
    return _Span(label, sync, root) if _recording() else _OFF


def carried(fn):
    """``fn`` to run in a worker thread inside the span this thread is in
    now: the worker's spans then count toward this thread's root and sit
    one level below the current span.  ``fn`` itself when nothing records."""
    root, depth = _here.root, _here.depth
    if root is None:
        return fn

    def run(*args, **kwargs):
        _here.root, _here.depth = root, depth
        return fn(*args, **kwargs)

    return run
