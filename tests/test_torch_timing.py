"""The port's spans (``zinc_tpu_torch/timing.py``) on the CPU.

Off, a device-path prove and verify sync nothing, enter no
``record_function`` and leave ``STAGES`` as it was.  With the profiler's
flag up, a prove and verify enter their spans' annotations nested on the
main thread, only the five stage spans sync, ``STAGES`` holds each label's
total within its root, and the proof's bytes are the untraced ones; under
a real ``torch.profiler`` a span is a ``user_annotation`` in the Chrome
trace.  A root's totals count a worker thread's spans and print indented
by depth.
"""

import json
import os
import random
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest

import zinc_tpu_torch as zt
from zinc_tpu_torch import timing

GOLDEN = Path(__file__).resolve().parent / "golden" / "proof_2p10.bin"
SYNCED = ("prove.upload", "prove.spartan", "prove.zip_commit", "prove.zip_open", "verify.pcs")


@pytest.fixture(scope="module")
def fixture_2p10():
    _, ccs, st, wit = zt.dummy_ccs_of_size(1 << 10, random.Random(1234), int_bits=62)
    return ccs, st, wit


def _prove(fixture):
    ccs, st, wit = fixture
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(st.public_input, t, 1, 4)
    return zt.ZincProver(zt.ZipTypes(1), device="cpu").prove(st, wit, t, ccs, cfg), cfg


def _verify(fixture, proof, cfg) -> bytes:
    ccs, st, _ = fixture
    zt.ZincVerifier(zt.ZipTypes(1), device="cpu").verify(st, proof, zt.KeccakTranscript(), ccs,
                                                         cfg)
    return zt.serialize_proof(proof, cfg)


@pytest.fixture
def counted(monkeypatch):
    """Calls of the sync and of ``record_function``, with recording left to
    the test (no ``ZINC_TPU_TRACE``); ``STAGES`` starts empty."""
    calls = {"sync": 0, "record_function": 0}
    real = timing.record_function

    def sync():
        calls["sync"] += 1

    def record_function(name):
        calls["record_function"] += 1
        return real(name)

    monkeypatch.setattr(timing, "_sync", sync)
    monkeypatch.setattr(timing, "record_function", record_function)
    monkeypatch.delenv("ZINC_TPU_TRACE", raising=False)
    monkeypatch.setattr(timing, "STAGES", {})
    monkeypatch.setattr(timing, "_ROOT_LABELS", {})
    return calls


def test_off_records_nothing(fixture_2p10, counted):
    timing.STAGES["untouched"] = 1.0
    assert _verify(fixture_2p10, *_prove(fixture_2p10)) == GOLDEN.read_bytes()
    assert counted == {"sync": 0, "record_function": 0}
    assert timing.STAGES == {"untouched": 1.0}


class _Annotations:
    """A stand-in for ``record_function`` that logs each span's enter and
    exit with its thread, in order."""

    def __init__(self):
        self.log: list[tuple[str, str, int]] = []

    def __call__(self, name):
        log = self.log

        class Annotation:
            def __enter__(self):
                log.append(("enter", name, threading.get_ident()))

            def __exit__(self, *exc):
                log.append(("exit", name, threading.get_ident()))

        return Annotation()

    def parents(self, thread: int) -> set[tuple[str, str]]:
        """Every (outer, inner) pair of spans on ``thread`` whose inner
        opened while the outer was open; enters and exits must pair up."""
        stack, pairs = [], set()
        for kind, name, tid in self.log:
            if tid != thread:
                continue
            if kind == "enter":
                pairs.update((outer, name) for outer in stack)
                stack.append(name)
            else:
                assert stack.pop() == name
        assert not stack
        return pairs


def test_spans_nest_on_the_main_thread_while_a_profiler_runs(fixture_2p10, counted, monkeypatch):
    """A prove and verify with the profiler's flag up: each span enters its
    annotation nested in its parents' on the main thread, only the five
    stage spans sync, ``STAGES`` holds each label's total within its root,
    and the proof's bytes are the untraced ones."""
    annotations = _Annotations()
    monkeypatch.setattr(timing, "_profiler", SimpleNamespace(_is_profiler_enabled=True))
    monkeypatch.setattr(timing, "record_function", annotations)
    assert _verify(fixture_2p10, *_prove(fixture_2p10)) == GOLDEN.read_bytes()
    assert counted["sync"] == 2 * len(SYNCED)
    stages = timing.STAGES
    assert set(SYNCED) | {"prove", "verify", "verify.pcs.device_checks"} <= set(stages)
    assert stages["prove.upload"] <= stages["prove"]
    pairs = annotations.parents(threading.get_ident())
    for pair in [("prove", "prove.upload"), ("prove.upload", "prove.upload.coo"),
                 ("prove", "prove.zip_open"), ("prove.zip_open", "prove.zip_open.fetch"),
                 ("sumcheck.fs.finish", "sumcheck.host_tail"), ("verify", "verify.pcs")]:
        assert pair in pairs, pair


def test_a_span_is_a_user_annotation_in_the_chrome_trace(counted, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.timed("prove", root=True):
            with timing.timed("prove.upload"):
                pass
    assert set(timing.STAGES) == {"prove", "prove.upload"}
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    outer, inner = spans["prove"], spans["prove.upload"]
    assert outer["tid"] == inner["tid"] and float(outer["ts"]) <= float(inner["ts"])
    assert float(inner["ts"]) + float(inner["dur"]) <= float(outer["ts"]) + float(outer["dur"])


def test_trace_env_totals_per_root_with_a_worker(counted, monkeypatch, capsys):
    monkeypatch.setenv("ZINC_TPU_TRACE", "1")
    clock = iter(range(1000))
    monkeypatch.setattr(timing, "time", SimpleNamespace(perf_counter=lambda: float(next(clock))))

    def work():
        with timing.timed("prove.worker"):
            pass

    with timing.timed("outside"):  # 0 .. 1
        pass
    with timing.timed("prove", root=True):  # 2 .. 9
        for _ in range(2):
            with timing.timed("prove.step", sync=True):  # 3 .. 4, 5 .. 6
                pass
        worker = threading.Thread(target=timing.carried(work))
        worker.start()  # 7 .. 8
        worker.join()
    assert timing.STAGES == {"outside": 1.0, "prove": 7.0, "prove.step": 2.0,
                             "prove.worker": 1.0}
    assert counted["sync"] == 4
    lines = capsys.readouterr().err.splitlines()
    assert [line.split(" .")[0] for line in lines] == [
        "[zinc-tpu-torch] outside", "[zinc-tpu-torch] prove", "[zinc-tpu-torch]   prove.step",
        "[zinc-tpu-torch]   prove.worker"]
    assert lines[2].endswith(" 2.000 s")
    with timing.timed("prove", root=True):  # the latest root's totals replace the last's
        with timing.timed("prove.step"):
            pass
    assert timing.STAGES == {"outside": 1.0, "prove": 3.0, "prove.step": 1.0}


def test_root_totals_lose_no_worker_update(counted, monkeypatch):
    """More workers than cores add to one label of one root, switching
    often: with a clock of each thread's own, every span reads 1 s."""
    monkeypatch.setenv("ZINC_TPU_TRACE", "1")
    ticks = threading.local()

    def clock():
        ticks.n = getattr(ticks, "n", -1) + 1
        return float(ticks.n)

    monkeypatch.setattr(timing, "time", SimpleNamespace(perf_counter=clock))
    n_threads, spans = 2 * (os.cpu_count() or 1), 200

    def work():
        for _ in range(spans):
            with timing.timed("prove.worker"):
                pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with timing.timed("prove", root=True):
            workers = [threading.Thread(target=timing.carried(work)) for _ in range(n_threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    assert timing.STAGES == {"prove": 1.0, "prove.worker": float(n_threads * spans)}
