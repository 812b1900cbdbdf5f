"""A cell's files, found by the names in ``BENCHMARK.json``:
``configs/<config>.json`` (its ``driver`` and ``reference`` name the
modules ``drivers/<driver>.py`` and ``reference/<reference>.py``),
``traffic/<traffic>.json`` and ``metrics/<metric>.py``."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclass
class Spec:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list[dict]  # the cell's end-to-end metrics
    per_layer: list[dict]  # the cell's per-layer metrics


def load(workload: str, root: Path = ROOT) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    per_layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return Spec(w, config, traffic, e2e, per_layer)


def module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, loaded by its path (a name
    may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
