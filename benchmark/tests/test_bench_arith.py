"""The metrics' arithmetic on synthetic data: means of walls, the 95th
percentile over all proves, unions of device intervals inside the prove
spans, idle gaps named by the host span, and the roofline's hand count."""

import numpy as np
import pytest

from _paths import ROOT  # noqa: F401
from benchmark.harness import roofline, spec as specs, stats
from benchmark.harness.runner import Reservoir, Run
from benchmark.harness.trace import Trace
from benchmark.reference.keccak import Keccak256, Keccak256Batch
from benchmark.reference.transcript import Field, Transcript, TranscriptBatch


def _run(steps, trace=None, cell="r1cs-2p20", peak=None):
    return Run(specs.load(cell), {"max_sm_mhz": 1980.0}, steps, 12.5, trace, 10.0, peak)


def _steps(walls):
    return [{"error": None, "accepted": True, "walls": {"prove": w, "verify": w / 10},
             "stages": {"prove.upload": w / 2}, "sumchecks": [{"fetches": 1}, {"fetches": 1}]}
            for w in walls]


def test_mean_and_p95_over_all_proves():
    walls = [float(x) for x in range(1, 21)]
    run = _run(_steps(walls) + [{"error": "boom"}])
    read = lambda name: specs.module("metrics", name).read(run)  # noqa: E731
    assert read("prove_s") == pytest.approx(10.5)
    assert read("prove_p95_s") == 19.0  # nearest rank: the 19th of 20
    assert read("verify_s") == pytest.approx(1.05)
    assert read("upload_s") == pytest.approx(5.25)
    assert read("sumcheck_fetches") == 2.0
    assert read("setup_s") == 12.5
    assert stats.percentile([5.0], 95) == 5.0 and stats.percentile([], 95) is None


def test_union_of_intervals():
    s, e = stats.union([0, 5, 1, 10, 12], [2, 6, 3, 11, 15])
    assert s.tolist() == [0, 5, 10, 12] and e.tolist() == [3, 6, 11, 15]
    assert stats.covered(s, e, 1, 13) == 2 + 1 + 1 + 1


def _trace():
    # two proves [0, 100) and [200, 300) µs; the window [0, 400)
    host = [("bench.window", 0, 400), ("bench.prove", 0, 100), ("bench.prove", 200, 100),
            ("bench.inputs", 100, 100), ("aten::copy_", 40, 10)]
    dev = [("k1", 10, 20, "kernel"), ("k2", 20, 20, "kernel"), ("Memcpy HtoD", 60, 10, "gpu_memcpy"),
           ("k1", 210, 30, "kernel"), ("k3", 120, 5, "kernel")]
    events = [{"ph": "X", "cat": "user_annotation" if n.startswith("bench") else "cpu_op",
               "name": n, "ts": t, "dur": d} for n, t, d in host]
    events += [{"ph": "X", "cat": c, "name": n, "ts": t, "dur": d} for n, t, d, c in dev]
    events.append({"ph": "i", "cat": "kernel", "name": "not a span", "ts": 5})
    return Trace.from_events(events)


def test_trace_reduction():
    tr = _trace()
    run = _run(_steps([1.0, 1.0]), trace=tr)
    # inside the proves: [10, 40) + [60, 70) + [210, 240) = 70 µs of 200
    assert specs.module("metrics", "device_idle").read(run) == pytest.approx(65.0)
    assert specs.module("metrics", "kernels_per_proof").read(run) == 2.0
    assert tr.busy_us(0, 400) == pytest.approx(75.0)
    assert tr.top_ops(0, 400)[0] == ["k1", pytest.approx(50e-6)]
    gaps = tr.idle_gaps(0, 400, k=3)
    assert gaps[0] == ["bench.window", pytest.approx(160e-6)]  # 240 .. 400
    assert gaps[1][0] == "bench.inputs" and gaps[2][0] == "bench.prove"
    assert tr.host_at(45) == "aten::copy_"


@pytest.mark.parametrize("name", ["sumcheck_fetches", "device_idle", "kernels_per_proof"])
def test_sumcheck_cells_split_reads_as_the_original(name):
    run = _run(_steps([1.0, 3.0]), trace=_trace(), cell="sumcheck-2p20")
    split = specs.module("metrics", f"{name}.sumcheck").read(run)
    assert split is not None and split == specs.module("metrics", name).read(run)
    assert specs.module("metrics", "prove_mean_s").read(run) == pytest.approx(2.0)


def test_untraced_run_reads_no_trace_metric():
    run = _run(_steps([1.0]))
    for name in ("device_idle", "kernels_per_proof", "peak_mem_gib"):
        assert specs.module("metrics", name).read(run) is None


def test_round_kernels_roofline_on_a_trace():
    tr = _trace()
    run = _run(_steps([1.0, 1.0]), trace=tr, cell="sumcheck-2p20")
    products = [(0, 1), (2, 3, 4), (5, 6, 7, 8), (9, 10), (11, 12, 13), (14, 15, 16, 17),
                (18, 19, 20)]  # the configuration's 2, 3, 4, 2, 3, 4, 3 factors
    # degree 4: 4 points a round (p(1) is the claim less p(0)), 6 words
    least = roofline.sumcheck_least_ms(20, 21, products, 4, 6, 1980.0)
    kernel_ms = (20 + 20 + 30) / 1e3 / 2
    got = specs.module("metrics", "round_kernels_roofline").read(run)
    assert got == pytest.approx(100 * least / kernel_ms)


def test_least_time_by_hand():
    # 2 tables of 2^3 entries, one term of 2 factors, 3 points, 2 words
    mhz, n32 = 1000.0, 2
    slots = 132 * 64 * mhz * 1e3  # IMAD slots a ms
    full, lazy = 4 * n32 * n32 + 2 * n32, 2 * n32 * n32
    byte_ms = 1e3 / 3.35e12
    rounds = [(2 * 8 * 8, 0, 4 * 3),  # round 1: read 16 entries; 4 pairs x 3 points
              (2 * 12 * 8, 8, 2 * 3),  # fold 2 x 8 -> 4, 2 pairs
              (2 * 6 * 8, 4, 1 * 3)]  # fold 2 x 4 -> 2, 1 pair
    want = sum(max(b * byte_ms, (f * full + lz * lazy) / slots) for b, f, lz in rounds)
    got = roofline.sumcheck_least_ms(3, 2, [(0, 1)], 3, n32, mhz)
    assert got == pytest.approx(want)
    assert roofline.round_products(10, [(0,), (0, 1, 2)], 3) == (30, 30)


def test_reservoir_keeps_k_uniformly():
    counts = np.zeros(10)
    for seed in range(2000):
        r, kept = Reservoir(2, seed), set()
        for i in range(10):
            drop = r.offer(i)
            if drop is not None:
                kept.discard(drop)
                kept.add(i)
        assert len(kept) == 2
        counts[list(kept)] += 1
    assert counts.min() > 0.8 * 400 and counts.max() < 1.2 * 400


def test_batched_sponge_matches_the_sponge():
    rng = np.random.default_rng(5)
    hs, hb = [Keccak256() for _ in range(3)], Keccak256Batch(3)
    for n in (0, 8, 52, 135, 1, 136, 300, 34):
        data = rng.integers(0, 256, (3, n), dtype=np.uint8)
        for h, row in zip(hs, data):
            h.update(row.tobytes())
        hb.update(data)
        assert [d.tobytes() for d in hb.digest()] == [h.digest() for h in hs]
    assert Keccak256().digest().hex().startswith("c5d2460186f7233c")  # Keccak-256("")


def test_batched_transcript_matches_the_transcript():
    f = Field(312829638388039969874974628075306023441, 3)
    ts, tb = [Transcript() for _ in range(2)], TranscriptBatch(2)
    for t, s in zip(ts, (b"a" * 8, b"b" * 8)):
        t.absorb(s)
    tb.absorb([b"a" * 8, b"b" * 8])
    for k in range(4):
        vals = [f.mont(7 * k + 1), f.mont(11 * k + 2)]
        for t, v in zip(ts, vals):
            t.absorb_field(f, v)
        tb.absorb_field(f, vals)
        assert tb.challenge(f) == [t.challenge(f) for t in ts]
