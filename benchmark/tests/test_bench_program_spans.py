"""The readers of the program's spans on a synthetic trace: each span
counted in the prove it starts in, summed a prove, mean over the proves;
nothing read untraced or from a program that records no such span; and
the window's idle gaps named by the innermost program span."""

import pytest

from _paths import ROOT  # noqa: F401
from benchmark.harness import spec as specs
from benchmark.harness.program_spans import seconds_in_proves
from benchmark.harness.runner import Run
from benchmark.harness.trace import Trace

METRICS = {"upload_coo_s": "prove.upload.coo", "zip_open_fetch_s": "prove.zip_open.fetch",
           "zip_open_write_s": "prove.zip_open.write", "host_tail_s": "sumcheck.host_tail",
           "host_tail_s.sumcheck": "sumcheck.host_tail",
           "challenge_s.sumcheck": "sumcheck.challenge"}


def _trace(program: bool = True) -> Trace:
    # proves [0, 1000) and [2000, 3000) µs; a span at 1500 lies outside both
    host = [("bench.window", 0, 4000), ("bench.prove", 0, 1000), ("bench.prove", 2000, 1000),
            ("bench.inputs", 1000, 1000)]
    if program:
        for name in set(METRICS.values()):
            host += [(name, 100, 50), (name, 300, 30), (name, 1500, 400), (name, 2100, 20)]
        host += [("prove", 0, 990), ("prove.upload", 10, 500)]
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": t, "dur": d}
              for n, t, d in host]
    events += [{"ph": "X", "cat": "kernel", "name": "k", "ts": t, "dur": 10}
               for t in (0, 90, 600, 2000, 2990)]
    return Trace.from_events(events)


def _run(cell: str, trace) -> Run:
    steps = [{"error": None, "accepted": True, "walls": {"prove": 1e-3}, "stages": {},
              "sumchecks": []}] * 2
    return Run(specs.load(cell), None, steps, 1.0, trace, 4e-3, None)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reader_sums_spans_a_prove(name):
    cell = "sumcheck-2p20" if name.endswith(".sumcheck") else "r1cs-2p20"
    read = specs.module("metrics", name).read
    # (50 + 30) µs in the first prove, 20 µs in the second; 1500 is outside
    assert read(_run(cell, _trace())) == pytest.approx((80e-6 + 20e-6) / 2)
    assert read(_run(cell, None)) is None
    assert read(_run(cell, _trace(program=False))) is None
    assert name in {m["name"] for m in specs.load(cell).per_layer}


def test_per_prove_sums_and_idle_gaps_named_by_program_span():
    tr = _trace()
    assert seconds_in_proves(_run("r1cs-2p20", tr), "prove.upload") == [500e-6, 0.0]
    # the longest idle stretch, [100, 600), is named at its middle (350) by
    # the innermost live span: prove.upload, inside prove, inside bench.prove
    assert tr.idle_gaps(0, 1000, k=1) == [["prove.upload", pytest.approx(500e-6)]]
