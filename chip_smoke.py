"""Drive the PyTorch/CUDA port of Zinc on one GPU and check it end to end.

    python3 chip_smoke.py            # every phase, as the quick proof that the port runs

Phases (any failure exits non-zero; there is no CPU fallback):

0. the card (nvidia-smi name and power limit), torch/CUDA versions, the
   kernels' build time and registers, and a pinned native thread count;
1. each CUDA kernel against its plain PyTorch version at the shapes the
   paths below give it (2^20 tables, and path B's last fold at 7 × 128):
   exactly equal (every value is an integer residue), with both times
   (CUDA events, median of 7 kernel and 3 plain runs); then the generic
   eval against K3 at K3's shape, equal sums and both times;
2. 2^10: the port's prove reproduces tests/golden/proof_2p10.bin byte for
   byte through the kernels, its verifier accepts it, and both tamper
   probes are rejected; every kernel of the dummy-R1CS path launched, and
   none of the generic tier;
3. 2^20 (seed 5, the production configuration): one prove and one verify
   through ZincProver/ZincVerifier, with the launch counts of that run,
   the stage walls, the proof size and the peak device memory; the
   V_s[0] + 1 tamper is rejected;
4. a second 2^20 prove under torch.profiler: the device's busy share and
   the kernels that take the most device time;
5. path A, a degree-4 CCS outside K3's scope (z⁴ − z³·z = 0, five
   matrices, sumcheck 1 on the generic tier): the 2^10 proof hashes to
   PATH_A_SHA256_2P10 (the JAX host prover's proof, pinned by
   tests/test_torch_generic.py), and at 2^20 (seed 5) one prove and one
   verify, with walls, launches and peak memory; the V_s tamper is rejected;
6. path B, zinc_tpu_torch.benches.bench_sumcheck at 2^20 (7 factors,
   degree 7): prove and verify times, accepted by the host verifier.

The line before the last is a JSON object with one entry per kernel, its
launches summed over the three 2^20 runs (phase 3, path A at 2^20, path B's
timed prove), each counted from 0; the 2^10 runs' launches are logged on
their own lines.  The last line is the JSON result object.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

KERNELS = {
    # name: (route, source, TPU kernels it replaces)
    "mont_mul": ("cuda", "zinc_tpu_torch/csrc/mont_mul.cu",
                 "zinc_tpu/ops/pallas_field.py:265 (K1 mont_mul_pallas_t); "
                 "zinc_tpu/ops/pallas_field.py:241 (K5 mont_mul_pallas)"),
    "fold": ("cuda", "zinc_tpu_torch/csrc/sumcheck.cu",
             "zinc_tpu/sumcheck/mxu_exec.py:662 (K2 _fold_lm); "
             "zinc_tpu/ops/pallas_field.py:295 (K6 mont_fold_pallas); "
             "zinc_tpu/sumcheck/pallas_exec.py:67 (K8 _fold_fixed)"),
    "round_eval": ("cuda", "zinc_tpu_torch/csrc/sumcheck.cu",
                   "zinc_tpu/sumcheck/mxu_exec.py:762 (K3 _eval_lm)"),
    "round_eval_gruen": ("cuda", "zinc_tpu_torch/csrc/sumcheck.cu",
                         "zinc_tpu/sumcheck/mxu_exec.py:955 (K4 _eval_lm_gruen)"),
    "round_eval_generic": ("cuda", "zinc_tpu_torch/csrc/generic.cu",
                           "zinc_tpu/ops/pallas_field.py:374 (K7 round_eval_pallas); "
                           "zinc_tpu/sumcheck/pallas_exec.py:133 (K9 _eval_fixed)"),
    "fold_round_eval": ("cuda", "zinc_tpu_torch/csrc/generic.cu",
                        "zinc_tpu/sumcheck/pallas_exec.py:192 (K10 _fold_eval_fixed)"),
}
# the kernels each path must launch (and the dummy R1CS none of the generic tier)
R1CS_KERNELS = ("mont_mul", "fold", "round_eval", "round_eval_gruen")
GENERIC_KERNELS = ("round_eval_generic", "fold_round_eval")
PATH_A_KERNELS = ("mont_mul", "fold", "round_eval") + GENERIC_KERNELS
PATH_B_KERNELS = ("fold",) + GENERIC_KERNELS

# sha256 of the path A proof at 2^10 (seed 1234): the JAX package's host
# prover gives these bytes (tests/test_torch_generic.py holds the two equal)
PATH_A_SHA256_2P10 = "39ecc9b919b83f83f3831af319fa005ee7a7fcd766535b59caa0a115c79e0505"


def log(msg: str) -> None:
    print(msg, flush=True)


def setup(n: int, seed: int):
    import zinc_tpu_torch as zt

    _, ccs, statement, wit = zt.dummy_ccs_of_size(n, random.Random(seed), int_bits=62)
    ztypes = zt.ZipTypes(1)
    cfg = zt.draw_random_field(statement.public_input, zt.KeccakTranscript(), ztypes.n_words, 4)
    return ccs, statement, wit, ztypes, cfg


def degree4_fixture(n: int, seed: int, ccs_mod=None):
    """Path A: the CCS z⁴ − z³·z = 0 of n constraints, (ccs, statement,
    witness).  S = [[0,1,2,3],[4]], c = [1, −1], A = B = C = D = I and
    E = diag(z³); z uniform in [−2^15, 2^15) from Random(seed), z[1] = 1, so
    E's entries fit in int64.  ``ccs_mod`` is the ccs module to build it
    from (the port's host layer by default; a test passes zinc_tpu.ccs)."""
    if ccs_mod is None:
        from zinc_tpu_torch._host import ccs as ccs_mod

    rng = random.Random(seed)
    z = [rng.randrange(-(1 << 15), 1 << 15) for _ in range(n)]
    z[1] = 1
    s = (n - 1).bit_length()
    ccs = ccs_mod.CCS(m=n, n=n, l=1, t=5, q=2, d=4, s=s, s_prime=s, S=[[0, 1, 2, 3], [4]],
                      c=[1, -1])
    mats = [ccs_mod.identity_matrix(n, n) for _ in range(4)]
    mats.append(ccs_mod.SparseMatrix(n, n, [[(z[i] ** 3, i)] for i in range(n)]))
    statement = ccs_mod.Statement(constraints=mats, public_input=z[:1])
    return ccs, statement, ccs_mod.Witness(w_ccs=z[2:])


def pcs_batch_sizes(n: int) -> list[int]:
    """Paths the verifier hands the native runtime at size n (leaf hashes
    and Merkle folds alike): column openings × PCS rows."""
    from zinc_tpu_torch._host.zip.code import DefaultLinearCodeSpec, _row_len_for

    rows = max(1, n // _row_len_for(n))
    return [DefaultLinearCodeSpec().num_column_opening() * rows]


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------


def phase0(sizes: list[int]) -> None:
    import torch

    from zinc_tpu_torch.native_threads import safe_native_threads
    from zinc_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    # native/zinc_native.cpp:38-56 drops the tail of a batch at some thread
    # counts (a valid proof is then rejected): pin a count that covers every
    # batch this run hands the native runtime, before any native call
    batches = sorted({b for n in sizes for b in pcs_batch_sizes(n)})
    nt = safe_native_threads(batches, os.cpu_count() or 1)
    os.environ["ZINC_TPU_NATIVE_THREADS"] = str(nt)
    log(f"native threads {nt} (batches {batches})")
    t0 = time.perf_counter()
    _cuda.lib()
    log(f"kernel build {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_cuda.BUILD['seconds']:.1f} s, cached={_cuda.BUILD['cached']})")
    for line in ptxas_summary(_cuda.BUILD["ptxas"]):
        log(f"[ptxas] {line}")


def ptxas_summary(report: str) -> list[str]:
    """One line per compiled kernel from nvcc -Xptxas -v: its name and
    template arguments, registers and spill bytes."""
    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            base, rest = m.group(2)[:n], m.group(2)[n:]
            name = base + "<" + ",".join(re.findall(r"L[ib](\d+)E", rest)) + ">"
            spill = ""
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers; {spill}")
            name = None
    return out


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions at the 2^20 shapes
# ---------------------------------------------------------------------------


def _time_ms(fn, runs: int = 7) -> float:
    import torch

    fn()  # warm-up (and the build, for the first kernel)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _random_residues(rng, ctx, shape, device):
    """Uniform-ish residues < q: random words with the top word below q's."""
    import numpy as np

    from zinc_tpu_torch.fields import montgomery as fm

    words = rng.integers(0, 1 << 32, size=shape + (ctx.n32,), dtype=np.uint64).astype(np.uint32)
    words[..., -1] = rng.integers(0, int(ctx.q[-1]), size=shape, dtype=np.uint64).astype(np.uint32)
    return fm.to_tensor(words, device)


def phase1(cfg) -> dict:
    import numpy as np
    import torch

    from zinc_tpu_torch.fields.montgomery import device_field
    from zinc_tpu_torch.ops import field_kernels as fk
    from zinc_tpu_torch.sumcheck import kernels as sk
    from zinc_tpu_torch.sumcheck.executor import HOST_TAIL

    dev = "cuda"
    ctx = device_field(cfg)
    rng = np.random.default_rng(20)
    n = 1 << 20
    a = _random_residues(rng, ctx, (n,), dev)
    b = _random_residues(rng, ctx, (n,), dev)
    sc1 = _random_residues(rng, ctx, (3, n), dev)  # Mz tables of sumcheck 1 (Gruen)
    sc2 = _random_residues(rng, ctx, (2, n), dev)  # (γ-table, z) of sumcheck 2
    e_lvl = _random_residues(rng, ctx, (n // 2,), dev)  # suffix-eq level of round 1
    r = _random_residues(rng, ctx, (1,), "cpu")[0].numpy().view(np.uint32)
    gruen_terms, classic_terms = [(0, 1), (2,)], [(0, 1)]
    cases = [
        # (kernel, shape label, kernel call, plain call); the first case of a
        # kernel gives its times in the kernels line
        ("mont_mul", "2^20", lambda: fk.mont_mul(ctx, a, b), lambda: fk.mont_mul_plain(ctx, a, b)),
        ("fold", "3 x 2^20", lambda: sk.fold(ctx, sc1, r), lambda: sk.fold_plain(ctx, sc1, r)),
        ("round_eval", "2 x 2^20, 1 term, 3 points",
         lambda: sk.round_eval(ctx, sc2, classic_terms, 3),
         lambda: sk.round_eval_plain(ctx, sc2, classic_terms, 3)),
        ("round_eval_gruen", "3 x 2^20 + E, 2 terms, 4 points",
         lambda: sk.round_eval_gruen(ctx, sc1, e_lvl, gruen_terms, 4),
         lambda: sk.round_eval_gruen_plain(ctx, sc1, e_lvl, gruen_terms, 4)),
    ]
    # the generic tier at the shapes of its two paths: path B (7 factors,
    # degree 7) and path A's sumcheck 1 (5 Mz tables + eq, the degree-5
    # comb), each in round 0 and in its first fused round, and the last
    # device fold of path B (a table of 2·HOST_TAIL entries)
    sc7 = _random_residues(rng, ctx, (7, n), dev)
    sc6 = _random_residues(rng, ctx, (6, n), dev)
    tail7 = sc7[:, : 2 * HOST_TAIL].contiguous()
    t7, t_a = [tuple(range(7))], [(0, 1, 2, 3, 5), (4, 5)]
    cases += [
        ("round_eval_generic", "path B: 7 x 2^20, 1 term of 7, 8 points",
         lambda: sk.round_eval_generic(ctx, sc7, t7, 8), lambda: sk.round_eval_plain(ctx, sc7, t7, 8)),
        ("round_eval_generic", "path A: 6 x 2^20, terms of 5 and 2, 6 points",
         lambda: sk.round_eval_generic(ctx, sc6, t_a, 6), lambda: sk.round_eval_plain(ctx, sc6, t_a, 6)),
        ("fold_round_eval", "path A: 6 x 2^20 -> 2^19, terms of 5 and 2, 6 points",
         lambda: sk.fold_round_eval(ctx, sc6, r, t_a, 6),
         lambda: sk.fold_round_eval_plain(ctx, sc6, r, t_a, 6)),
        ("fold_round_eval", "path B: 7 x 2^20 -> 2^19, 1 term of 7, 8 points",
         lambda: sk.fold_round_eval(ctx, sc7, r, t7, 8),
         lambda: sk.fold_round_eval_plain(ctx, sc7, r, t7, 8)),
        ("fold", f"path B's last: 7 x {2 * HOST_TAIL} -> {HOST_TAIL}",
         lambda: sk.fold(ctx, tail7, r), lambda: sk.fold_plain(ctx, tail7, r)),
    ]

    def flat(x):
        return [x] if isinstance(x, torch.Tensor) else list(x)

    results = {}
    for name, shape, kern, plain in cases:
        got, want = flat(kern()), flat(plain())
        torch.cuda.synchronize()
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item())
                  for g, w in zip(got, want))
        ms, plain_ms = _time_ms(kern), _time_ms(plain, 3)
        log(f"[kernel] {name} ({shape}): shapes {[tuple(g.shape) for g in got]} max_abs_err {err} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        row = results.setdefault(name, {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms})
        row["max_abs_err"] = max(row["max_abs_err"], err)

    # no path's shape: the generic kernel at K3's (sumcheck 2's), to see
    # whether one kernel could serve the classic rounds too
    if not torch.equal(sk.round_eval_generic(ctx, sc2, classic_terms, 3),
                       sk.round_eval(ctx, sc2, classic_terms, 3)):
        raise AssertionError("round_eval_generic disagrees with round_eval at K3's shape")
    k3_ms = _time_ms(lambda: sk.round_eval(ctx, sc2, classic_terms, 3))
    gen_ms = _time_ms(lambda: sk.round_eval_generic(ctx, sc2, classic_terms, 3))
    log(f"[compare] 2 x 2^20, 1 term of 2, 3 points: round_eval {k3_ms:.4f} ms, "
        f"round_eval_generic {gen_ms:.4f} ms (equal sums)")
    return results


# ---------------------------------------------------------------------------
# phases 2 and 3: the main path
# ---------------------------------------------------------------------------


def prove_verify(ccs, statement, wit, device: str):
    import zinc_tpu_torch as zt

    ztypes = zt.ZipTypes(1)
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, ztypes.n_words, 4)
    t0 = time.perf_counter()
    proof = zt.ZincProver(ztypes, device=device).prove(statement, wit, t, ccs, cfg)
    prove_s = time.perf_counter() - t0
    verifier = zt.ZincVerifier(ztypes, device=device)
    t0 = time.perf_counter()
    verifier.verify(statement, proof, zt.KeccakTranscript(), ccs, cfg)
    verify_s = time.perf_counter() - t0
    return proof, cfg, (ztypes, verifier), prove_s, verify_s


def expect_reject(fn, what: str) -> None:
    try:
        fn()
    except Exception as e:  # any rejection counts: parse or verify
        log(f"[tamper] {what}: rejected ({type(e).__name__})")
        return
    raise AssertionError(f"tamper probe accepted: {what}")


def phase2(device: str) -> None:
    import zinc_tpu_torch as zt
    from zinc_tpu_torch.ops import _cuda

    ccs, statement, wit, _, _ = setup(1 << 10, 1234)
    _cuda.reset_launches()
    proof, cfg, (ztypes, _), _, _ = prove_verify(ccs, statement, wit, device)
    blob = zt.serialize_proof(proof, cfg)
    golden = (ROOT / "tests" / "golden" / "proof_2p10.bin").read_bytes()
    if blob != golden:
        raise AssertionError("the 2^10 proof differs from tests/golden/proof_2p10.bin")
    launches = dict(_cuda.LAUNCHES)
    log(f"[2^10] golden proof reproduced ({len(blob)} bytes), verifier accepted; "
        f"launches {launches}")
    check_launches(launches, R1CS_KERNELS, GENERIC_KERNELS, "the 2^10 dummy R1CS")

    def bad_vs():
        p = zt.deserialize_proof(golden, cfg)
        p.spartan_proof.V_s[0] = p.spartan_proof.V_s[0] + cfg.one()
        zt.ZincVerifier(ztypes, device=device).verify(statement, p, zt.KeccakTranscript(), ccs, cfg)

    def bad_byte():
        raw = bytearray(golden)
        raw[len(raw) // 2] ^= 0x01
        p = zt.deserialize_proof(bytes(raw), cfg)
        zt.ZincVerifier(ztypes, device=device).verify(statement, p, zt.KeccakTranscript(), ccs, cfg)

    expect_reject(bad_vs, "V_s[0] + 1")
    expect_reject(bad_byte, "PCS byte flip")


def check_launches(launches: dict, must: tuple, must_not: tuple, what: str) -> None:
    missing = [k for k in must if launches[k] == 0]
    stray = [k for k in must_not if launches[k] != 0]
    if missing or stray:
        raise AssertionError(f"{what}: kernels not launched {missing}, launched off the path "
                             f"{stray}: {launches}")


def prove_verify_large(label: str, fixture, must: tuple, must_not: tuple) -> dict:
    """One prove and one verify on the card with the launch counts of that
    run, the stage walls, the proof size and the peak device memory; then
    the V_s[0] + 1 tamper, which must be rejected."""
    import torch

    import zinc_tpu_torch as zt
    from zinc_tpu_torch.ops import _cuda
    from zinc_tpu_torch.timing import STAGES

    ccs, statement, wit = fixture
    torch.cuda.reset_peak_memory_stats()
    STAGES.clear()
    _cuda.reset_launches()
    proof, cfg, (_, verifier), prove_s, verify_s = prove_verify(ccs, statement, wit, "cuda")
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    size = len(zt.serialize_proof(proof, cfg))
    walls = {k: round(v, 4) for k, v in STAGES.items()}
    log(f"[{label}] prove {prove_s:.3f} s, verify {verify_s:.3f} s (accepted), "
        f"proof {size} bytes, peak device memory {peak / 2**30:.3f} GiB")
    log(f"[{label}] stage walls (s): {json.dumps(walls)}")
    log(f"[{label}] launches: {launches}")
    check_launches(launches, must, must_not, label)

    def bad_vs():
        proof.spartan_proof.V_s[0] = proof.spartan_proof.V_s[0] + cfg.one()
        verifier.verify(statement, proof, zt.KeccakTranscript(), ccs, cfg)

    expect_reject(bad_vs, f"{label}: V_s[0] + 1")
    return launches


def phase3(log_n: int) -> dict:
    ccs, statement, wit, _, _ = setup(1 << log_n, 5)
    return prove_verify_large(f"2^{log_n}", (ccs, statement, wit), R1CS_KERNELS, GENERIC_KERNELS)


def phase5(log_n: int) -> dict:
    """Path A: the pinned 2^10 proof through the kernels, then 2^log_n;
    returns the launches of the 2^log_n run."""
    import zinc_tpu_torch as zt
    from zinc_tpu_torch.ops import _cuda

    ccs, statement, wit = degree4_fixture(1 << 10, 1234)
    _cuda.reset_launches()
    proof, cfg, _, _, _ = prove_verify(ccs, statement, wit, "cuda")
    launches = dict(_cuda.LAUNCHES)
    digest = hashlib.sha256(zt.serialize_proof(proof, cfg)).hexdigest()
    log(f"[path A 2^10] proof sha256 {digest}, verifier accepted; launches {launches}")
    if digest != PATH_A_SHA256_2P10:
        raise AssertionError(f"path A 2^10 proof hashes to {digest}, not {PATH_A_SHA256_2P10}")
    check_launches(launches, PATH_A_KERNELS, ("round_eval_gruen",), "path A 2^10")
    return prove_verify_large(f"path A 2^{log_n}", degree4_fixture(1 << log_n, 5), PATH_A_KERNELS,
                              ("round_eval_gruen",))


def phase6(log_n: int) -> dict:
    """Path B: the sumcheck bench entry point on the card; returns the
    launches of its timed prove (the bench sets the counts to 0 just before
    it)."""
    from zinc_tpu_torch.benches import bench_sumcheck

    res = bench_sumcheck.run(log_n, "cuda")
    launches = res["launches"]
    log(f"[path B 2^{log_n} x 7 factors] prove {res['prove_s']:.4f} s, verify "
        f"{res['verify_s']:.4f} s, accepted by the host verifier; launches of the timed "
        f"prove {launches}")
    check_launches(launches, PATH_B_KERNELS, ("mont_mul", "round_eval", "round_eval_gruen"),
                   "path B")
    return launches


def profile_prove(log_n: int) -> None:
    """A second 2^log_n prove under torch.profiler: the device's busy share
    (summed kernel and copy time over the wall) and the kernels that take
    the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import zinc_tpu_torch as zt

    ccs, statement, wit, ztypes, _ = setup(1 << log_n, 5)
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, ztypes.n_words, 4)
    prover = zt.ZincProver(ztypes, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prover.prove(statement, wit, t, ccs, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): an op's own entry repeats
    # the device time of the kernels it launched
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy = sum(dev_us(e) for e in events) / 1e6
    log(f"[profile 2^{log_n}] prove wall {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}% of the wall)")
    for e in sorted(events, key=dev_us, reverse=True)[:15]:
        log(f"[profile] {dev_us(e) / 1e3:10.2f} ms  x{e.count:<6} {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is false")

    phase0([1 << 10, 1 << 20])
    _, _, _, _, cfg = setup(1 << 10, 1234)  # any field of the main path's width
    kernels = phase1(cfg)
    phase2("cuda")
    runs = [phase3(20)]
    profile_prove(20)
    runs += [phase5(20), phase6(20)]
    # the main paths' launches: the three 2^20 runs (each counted from 0)
    launches = {name: sum(r[name] for r in runs) for name in KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"a kernel launched in none of the 2^20 runs: {launches}")
    rows = [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": launches[name], **kernels[name]}
        for name, (route, src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
