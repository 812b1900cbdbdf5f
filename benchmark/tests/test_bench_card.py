"""Each cell on the card, briefly, through the benchmark's own command:
its result line comes out correct and names the card.  Skipped without a
card; run on the card with ``python -m pytest benchmark/tests -m cuda``."""

import json
import subprocess
import sys

import pytest
import torch

from _paths import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           "2718281828", "--seconds", "3", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu" and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
