"""BENCHMARK.json holds to the benchmark's contract, and every cell's
configuration, traffic, driver, reference and metric files are found by
name from it."""

import importlib
import json
import math
import re

import pytest

from _paths import ROOT
from benchmark.harness import spec as specs

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p and not p.startswith("/")
        assert not p.endswith("_torch")
    for word in BENCH["command"]:
        assert _line(word) and not word.startswith("/")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert NAME.match(x["name"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))


def test_setup_s_and_four_chip_cap():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, math.floor(len(CELLS) / 4))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = specs.load(cell)
    e2e = [m["name"] for m in spec.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and spec.per_layer
    driver = specs.module("drivers", spec.config["driver"])
    assert hasattr(driver, "Cell")
    ref = importlib.import_module(f"benchmark.reference.{spec.config['reference']}")
    assert set(ref.NUMBERS) == set(spec.config["limits"])
    for key in ("log_n", "warmup_steps", "check_sample", "trace_seconds"):
        assert key in spec.traffic
    for m in spec.end_to_end + spec.per_layer:
        assert callable(specs.module("metrics", m["name"]).read)


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_per_layer_workloads_report_what_they_move():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in [e["name"] for e in specs.load(cell).end_to_end]
