"""One Spartan sumcheck round over a 2^20 hypercube, 256-bit field, on the
card: the port's form of ``bench.py``'s headline metric.

    python -m zinc_tpu_torch.benches.bench_round [log_n] [device]   # 20, cuda

The field and terms are ``bench.py:193-199``'s: q = 2^255 + 95 (n64 = 4),
terms (0, 3), (1, 3), (2, 3) (three Mz tables × eq), degree 3.  The round is
``native/cpu_baseline.cpp``'s round, the work of the first round of a
2^log_n prove: K4 ``round_eval_gruen`` of the 4-point sums over all
2^(log_n − 1) pairs of the three Mz tables against a suffix-eq level of as
many entries, and K2 ``fold`` of the three tables by the round's challenge.
It is not ``bench.py``'s chain, which folds first and evaluates the folded
tables (2^(log_n − 2) pairs), so its number and ``bench.py``'s TPU figure
are not like for like.  The terms are always K4's (``gruen_supported`` is
asserted): the classic tier's K3 never runs here.

Before it is timed the round is held against its plain versions
(``round_eval_gruen_plain`` and ``fold_plain``) on the same inputs: they
must be exactly equal.  The time is device-only on the card
(``bench_kernels.device_ms`` around the evaluation and the fold; the fold
is out of place, so every call sees the same input), the host clock on the
CPU.

``vs_baseline`` is measured live on this host, as ``bench.py`` measures it:
``native/cpu_baseline.cpp`` (a single-core C++ mirror of the reference's
round loop at 2^20, read here only as a source file) is built with g++ into
``zinc_tpu_torch/_build/`` against the port's ``csrc/zinc_native.cpp`` and
run with ``--threads 1 --iters 3 sumcheck_round``; without g++ or the source
the bench raises.  Below 2^20 the round's time is scaled linearly to 2^20
and the line says ``"extrapolated": true``, as ``bench.py`` does on a CPU.

Prints the device, the host's CPU model and the baseline, then one JSON line
with the JAX bench's metric name, its tier, the launches of the checked and
timed calls and, on the card, the round's bound (``bench_kernels.bound_ms``
of what the round must do: read each Mz table and the eq level once, write
the folded tables, and form the fold's and the sums' products) beside
``unfused_bound_ms``, the sum of the two launches' bounds, which count the
tables read twice.  On the CPU the size defaults to 2^10.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..fields import montgomery as fm
from ..fields.config import FieldConfig
from ..fields.montgomery import device_field
from ..ops import _cuda
from ..sumcheck import kernels as sk
from ._common import call_ms, device_line, emit, host_cpu, is_cuda, parse_one
from .bench_kernels import bound_ms, card, random_residues, round_products

Q = (1 << 255) + 95
TERMS = ((0, 3), (1, 3), (2, 3))  # three Mz tables × eq: Spartan's sumcheck 1
EQ_IDX, DEGREE = 3, 3
METRIC = "spartan_sumcheck_round_2p20_256bit"
TARGET_LOG_N = 20

_PKG = Path(__file__).resolve().parents[1]
BASELINE_SRC = _PKG.parent / "native" / "cpu_baseline.cpp"
NATIVE_SRC = _PKG / "csrc" / "zinc_native.cpp"


def round_calls(ctx, log_n: int, device, seed: int = 0) -> dict:
    """One round at 2^log_n entries a table, on random residues made from
    ``seed``: the argument-free calls of the evaluation and the fold
    (``kernel``) and of their plain versions (``plain``), and each call's
    work for ``bench_kernels.bound_ms`` (bytes moved, Montgomery and
    unreduced products, counted as ``bench_kernels.cases`` counts them): the
    round's (``work``), which reads each table once, and each launch's
    (``launch_work``), the fold reading the tables again."""
    n_pts, eb = DEGREE + 1, 4 * ctx.n32
    assert sk.gruen_supported(TERMS, EQ_IDX, ctx.n32, n_pts), "bench.py's terms are K4's"
    rng = np.random.default_rng(seed)
    n, rests = 1 << log_n, [t[:-1] for t in TERMS]
    mz = random_residues(rng, ctx, (EQ_IDX, n), device)
    r = fm.to_numpy(random_residues(rng, ctx, (1,), "cpu"))[0]
    e_level = random_residues(rng, ctx, (n // 2,), device)
    eval_full, eval_lazy = round_products(n // 2, rests, n_pts, gruen=True)
    return {
        "kernel": (lambda: sk.round_eval_gruen(ctx, mz, e_level, rests, n_pts),
                   lambda: sk.fold(ctx, mz, r)),
        "plain": (lambda: sk.round_eval_gruen_plain(ctx, mz, e_level, rests, n_pts),
                  lambda: sk.fold_plain(ctx, mz, r)),
        "work": ((3 * n + n // 2 + 3 * n // 2) * eb, eval_full + 3 * n // 2, eval_lazy),
        "launch_work": [((3 * n + n // 2) * eb, eval_full, eval_lazy),
                        (3 * (n + n // 2) * eb, 3 * n // 2, 0)],
    }


def run(log_n: int, device, seed: int = 0) -> dict:
    """The round checked against its plain versions, then timed: milliseconds
    a round, the launches of the checked and timed calls (the counts are set
    to 0 just before them) and, on the card, the round's bound and the sum
    of its two launches' bounds.  Raises if the round differs from its plain
    versions."""
    ctx = device_field(FieldConfig(Q, 4))
    rnd = round_calls(ctx, log_n, device, seed)
    _cuda.reset_launches()
    got, want = [f() for f in rnd["kernel"]], [f() for f in rnd["plain"]]
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("the round differs from its plain versions")
    ms = call_ms(lambda: [f() for f in rnd["kernel"]], device)
    res = {"log_n": log_n, "ms": ms,
           "launches": {k: v for k, v in _cuda.LAUNCHES.items() if v}}
    if is_cuda(device):
        mhz = card(device)["max_sm_mhz"]
        res["bound_ms"], res["bound_by"] = bound_ms(ctx.n32, *rnd["work"], mhz)
        res["unfused_bound_ms"] = sum(bound_ms(ctx.n32, *w, mhz)[0] for w in rnd["launch_work"])
    return res


def native_baseline_ms() -> float:
    """Milliseconds of one 2^20 round of ``native/cpu_baseline.cpp`` on one
    core of this host (best of 3), built once per source pair into
    ``_build/``.  Raises when g++ or a source is missing."""
    gxx = shutil.which("g++")
    if gxx is None or not BASELINE_SRC.exists() or not NATIVE_SRC.exists():
        raise RuntimeError(f"the native baseline needs g++ and {BASELINE_SRC}")
    digest = hashlib.sha256(BASELINE_SRC.read_bytes() + NATIVE_SRC.read_bytes()).hexdigest()[:16]
    exe = _PKG / "_build" / f"cpu_baseline_{digest}"
    if not exe.exists():
        exe.parent.mkdir(parents=True, exist_ok=True)
        tmp = f"{exe}.{os.getpid()}.tmp"
        subprocess.run([gxx, "-O3", "-march=native", "-std=c++17", "-pthread", "-o", tmp,
                        str(BASELINE_SRC), str(NATIVE_SRC)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, exe)
    out = subprocess.run([str(exe), "--threads", "1", "--iters", "3", "sumcheck_round"],
                         check=True, capture_output=True, text=True, timeout=300)
    return json.loads(out.stdout)["sumcheck_round_2p20_s"] * 1e3


def main(argv: list[str]) -> list[dict]:
    log_n, device = parse_one(argv[1:], TARGET_LOG_N, 10)
    print(device_line(device), flush=True)
    res = run(log_n, device)
    base_ms = native_baseline_ms()
    print(f"host: {host_cpu()}; native/cpu_baseline.cpp round at 2^20 on one core: "
          f"{base_ms} ms", flush=True)
    scale = 2 ** (TARGET_LOG_N - res["log_n"])
    extra = {} if scale == 1 else {"extrapolated": True, "measured_log_n": res["log_n"]}
    if "bound_ms" in res:
        extra.update(bound_ms=res["bound_ms"] * scale, bound_by=res["bound_by"],
                     unfused_bound_ms=res["unfused_bound_ms"] * scale)
    scaled = res["ms"] * scale
    return [emit(METRIC, scaled, "ms", vs_baseline=base_ms / scaled, tier="gruen",
                 launches=res["launches"], **extra)]


if __name__ == "__main__":
    main(sys.argv)
