"""One run of one cell: set-up, warm-up, a closed-loop window of
``seconds``, the comparison with the reference, and the result line.

A driver (``drivers/<name>.py``) gives a ``Cell(config, traffic, seed,
device)`` whose construction and ``warm()`` are the set-up, ``inputs(i)``
makes step i's inputs (outside every wall), ``step(i, inputs)`` times its
own walls and returns the step's record, ``plain(output)`` keeps what the
reference judges, ``close()`` frees the program's state and
``check(kept, steps)`` compares the kept steps with the reference (and may
judge every step's record, marking a step it rejects as not accepted).
"""

from __future__ import annotations

import random
import sys
import time

from . import guard, readout, spec as specs
from . import trace as tracing
from .trace import span


class Run:
    """What the metrics' readers see of a run."""

    def __init__(self, spec, card, steps, setup_s, trace, window, window_peak_bytes):
        self.spec, self.card, self.steps, self.setup_s = spec, card, steps, setup_s
        self.trace, self.window, self.window_peak_bytes = trace, window, window_peak_bytes
        self.completed = [s for s in steps if not s["error"]]


class Reservoir:
    """A uniform sample of k steps out of a stream of unknown length, drawn
    from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.slots = k, random.Random(seed), 0, []

    def offer(self, i: int) -> int | None:
        """The step that step i replaces in the sample (-1 for none), or None
        when i is passed over."""
        self.seen += 1
        if len(self.slots) < self.k:
            self.slots.append(i)
            return -1
        j = self.rng.randrange(self.seen)
        if j >= self.k:
            return None
        drop, self.slots[j] = self.slots[j], i
        return drop


def sync(device: str) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, spec=None, control: bool = False) -> dict:
    """The run's result line as a dict.  ``control`` runs the program at
    the configuration's ``control`` settings (the next precision down)
    while the reference keeps the stated ones: its result must not be
    correct."""
    import torch

    spec = spec or specs.load(workload)
    on_card = device.startswith("cuda")
    t_import = time.perf_counter()
    cell = specs.module("drivers", spec.config["driver"]).Cell(spec.config, spec.traffic, seed,
                                                                device, control)
    t_cell = time.perf_counter()
    cell.warm()
    sync(device)
    pre_peak = 0
    if on_card:
        pre_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    if trace:
        seconds = min(seconds, spec.traffic.get("trace_seconds", seconds))
    sample = Reservoir(spec.traffic["check_sample"], seed)
    kept: dict = {}
    steps: list[dict] = []
    prof = tracing.profiler(device) if trace else None
    if prof:
        prof.start()  # the profiler's start is set-up, outside the window
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    print(f"setup: start to harness {t_import - t_start:.2f} s, inputs' fixed parts "
          f"{t_cell - t_import:.2f} s, warm-up {t0 - t_cell:.2f} s", file=sys.stderr)
    with span("bench.window"):
        while time.perf_counter() - t0 < seconds:
            i = len(steps)
            with span("bench.inputs"):
                inputs = cell.inputs(i)
            rec = cell.step(i, inputs)
            output = rec.pop("output", None)
            if rec["error"] and not any(st["error"] for st in steps):
                print(f"step {i} failed: {rec['error']}", file=sys.stderr)
            drop = None if rec["error"] else sample.offer(i)
            if drop is not None:
                kept.pop(drop, None)
                kept[i] = cell.plain(output)
            del inputs, output
            steps.append(rec)
        sync(device)
    window = time.perf_counter() - t0
    if prof:
        prof.stop()
    window_peak = torch.cuda.max_memory_allocated() if on_card else None
    peak = max(pre_peak, window_peak) if on_card else None
    t1 = time.perf_counter()
    tr = tracing.read(prof) if prof else None
    del prof
    cell.close()
    t2 = time.perf_counter()

    card = guard.card_info(device) if on_card else None  # after the window: nvidia-smi is slow
    run = Run(spec, card, steps, setup_s, tr, window, window_peak)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = specs.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    for kind in sorted({k for st in run.completed for k in st["walls"]}):
        print(f"walls {kind}: " + " ".join(f"{w:.4f}" for w in readout.walls(run, kind)),
              file=sys.stderr)
    numbers = cell.check(kept, steps)
    print(f"run: setup {setup_s:.1f} s, window {window:.1f} s, trace read {t2 - t1:.1f} s, "
          f"{len(kept)} steps checked in {time.perf_counter() - t2:.1f} s", file=sys.stderr)
    failed = sum(1 for s in steps if s["error"] or not s.get("accepted", True))
    numbers["failed_steps"] = (failed, 0)
    numbers["unchecked_samples"] = (min(spec.traffic["check_sample"], len(steps)) - len(kept), 0)
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    result = {
        "correct": bool(steps) and all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(steps),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(torch.device(device)) if on_card else "cpu",
                   "count": spec.workload["chips"], "memory_peak_bytes": peak},
    }
    if tr is not None:
        lo, hi = (float(x[0]) for x in tr.spans("bench.window"))
        result["device"]["busy_s"] = tr.busy_us(lo, hi) / 1e6
        result["device"]["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = {"device_ops": tr.top_ops(lo, hi), "idle_gaps": tr.idle_gaps(lo, hi)}
    result["checks"] = checks
    return result
