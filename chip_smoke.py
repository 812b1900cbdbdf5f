"""Drive the PyTorch/CUDA port of Zinc on one GPU and check it end to end.

    python3 chip_smoke.py            # every phase, as the quick proof that the port runs
    python3 chip_smoke.py --rank R --world W --port P --log-n L --devices D
                                     # one rank of phase 9 (started by phase 9 itself)

Phases (any failure exits non-zero; there is no CPU fallback):

0. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   kernels' build: the 6-, 8- and 16-word libraries (n64 = 3, 4, 8), every
   nvcc process at once, with each kernel's registers and spills, and the
   instruction mix (IMAD, IADD3.X, other) in the SASS of mont_mul_kernel
   (one product) and of the generic kernels, whole and in their largest
   basic blocks (a pass's products);
1. each CUDA kernel against its plain PyTorch version at the shapes the
   paths below give it (2^20 tables, path B's last fold at 7 × 128) at
   n64 = 4 and n64 = 3: exactly equal (every value is an integer residue),
   with its device-only time (CUDA events around 20 back-to-back wrapper
   calls), its single-launch time (median of 7), the plain time (median of
   3) and its bound (zinc_tpu_torch/benches/bench_kernels.py); then the
   generic eval against K3 and K4 at their shapes, equal sums and both
   device-only times; then fold_round_eval at each of the 13 round shapes of
   paths A and B, with the sums over the rounds;
2. 2^10: the port's prove reproduces tests/golden/proof_2p10.bin byte for
   byte through the kernels, its verifier accepts it, and both tamper
   probes are rejected; every kernel of the dummy-R1CS path launched, and
   none of the generic tier.  Then the 2^8 dummy R1CS over a 192-bit field
   (n64 = 3) through the kernels: the proof hashes to N64_3_SHA256 (the JAX
   host prover's bytes, pinned by tests/test_torch_e2e.py) and verifies;
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
   degree 7): prove and verify times, accepted by the host verifier;
7. the sharded prove (zinc_tpu_torch.parallel) on the card: (a) the 2^20
   R1CS on Mesh([cuda:0] * 4), byte-identical to phase 3's proof, verified,
   the tamper rejected, with walls, launches, peak memory, 12 of the 20
   rounds of each sumcheck on the shards and the commit in 4 row blocks;
   (b) path A at 2^10 on four shards, hashed to PATH_A_SHA256_2P10; (c) a
   2 x 2 mesh of cuda:0 at 2^20 whose roots and proof equal (a)'s; (d) with
   two cards or more, (a) again on local_mesh() over the real cards;
8. the host backend (pure Python, no kernel) as the oracle: (a) the 2^14
   R1CS of tests/golden/gen.py, whose host proof hashes to
   tests/golden/proof_2p14.sha256 and whose device proof has the same
   bytes, each accepted by the other backend's verifier; (b) a seed drawn
   at run time and printed: device bytes equal host bytes for the 2^12
   R1CS at n64 = 4 and 3 and for path A at 2^12, with both walls;
9. a mesh over two processes (``chip_smoke.py --rank R ...`` children, each
   with a timeout): two ranks on this card over gloo, each with the local
   devices [cuda:0, cuda:0] on hierarchical_mesh(2, 2), prove the 2^20 R1CS
   of phase 3 to its sha256; rank 0 verifies and rejects the tamper; every
   rank's stage walls, launches and the bytes its all-gathers brought in;
   with two cards or more, one rank per card over NCCL.

The native runtime runs at its default thread count.  The line before the
last is a JSON object with one entry per kernel: its launches summed over
the four 2^20 runs (phase 3, path A at 2^20, path B's timed prove, phase
7's (a)), phase 8's device proves and phase 9's ranks, each counted from 0,
and the numbers of its first phase-1 case; the 2^10 runs' launches are
logged on their own lines.  The last line is the JSON result object.
"""

from __future__ import annotations

import hashlib
import json
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
GENERIC_ROWS = GENERIC_KERNELS  # the phase-1 rows that also report an issue-slot floor

# sha256 of the path A proof at 2^10 (seed 1234): the JAX package's host
# prover gives these bytes (tests/test_torch_generic.py holds the two equal)
PATH_A_SHA256_2P10 = "39ecc9b919b83f83f3831af319fa005ee7a7fcd766535b59caa0a115c79e0505"
# (n, seed) of the dummy R1CS proved over a 192-bit field (n64 = 3), and the
# sha256 of the JAX host prover's proof (tests/test_torch_e2e.py holds the two equal)
N64_3_CASE = (1 << 8, 1234)
N64_3_SHA256 = "facb3c5b1a8356f5f60363993fc196150c9ceecfeedf8cf32fe1dc4a5551bf8a"


def log(msg: str) -> None:
    print(msg, flush=True)


def setup(n: int, seed: int, n64: int = 4):
    import zinc_tpu_torch as zt

    _, ccs, statement, wit = zt.dummy_ccs_of_size(n, random.Random(seed), int_bits=62)
    ztypes = zt.ZipTypes(1)
    cfg = zt.draw_random_field(statement.public_input, zt.KeccakTranscript(), ztypes.n_words, n64)
    return ccs, statement, wit, ztypes, cfg


def degree4_fixture(n: int, seed: int, ccs_mod=None):
    """Path A: the CCS z⁴ − z³·z = 0 of n constraints, (ccs, statement,
    witness).  S = [[0,1,2,3],[4]], c = [1, −1], A = B = C = D = I and
    E = diag(z³); z uniform in [−2^15, 2^15) from Random(seed), z[1] = 1, so
    E's entries fit in int64.  ``ccs_mod`` is the ccs module to build it
    from (the port's host layer by default; a test passes zinc_tpu.ccs)."""
    if ccs_mod is None:
        from zinc_tpu_torch import ccs as ccs_mod

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


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------

BUILD_WIDTHS = (6, 8, 16)  # n64 = 3 (phases 1, 2), 4 (every path), 8 (registers only)


def phase0() -> dict:
    """The card and the build; returns the card's name, power limit and
    maximum SM clock (the bounds' clock)."""
    import torch

    from zinc_tpu_torch.benches.bench_kernels import card
    from zinc_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    info = card()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}, "
        f"max SM clock {info['max_sm_mhz']:.0f} MHz")
    t0 = time.perf_counter()
    _cuda.build(BUILD_WIDTHS)
    log(f"kernel build {time.perf_counter() - t0:.1f} s, widths {list(BUILD_WIDTHS)} "
        f"(cached {[_cuda.BUILD[n]['cached'] for n in BUILD_WIDTHS]})")
    for n in BUILD_WIDTHS:
        for line in ptxas_summary(_cuda.BUILD[n]["ptxas"]):
            log(f"[ptxas] {line}")
    for line in sass_mix(_cuda.BUILD[8]["path"]):
        log(f"[sass] {line}")
    from zinc_tpu_torch.sumcheck.kernels import GENERIC_LIMITS

    info["per_product"] = product_instructions(_cuda.BUILD[8]["path"], GENERIC_LIMITS["ZT_GEN_PASS"])
    log(f"[sass] instructions a Montgomery product, an unreduced product and its sum "
        f"(generic_round_kernel<8,0>): {info['per_product']}")
    return info


SASS_KERNELS = ("mont_mul_kernel", "generic_round_kernel")


def _kernel_name(mangled: str) -> str:
    """``_Z20generic_round_kernelILi8ELb1E...`` → ``generic_round_kernel<8,1>``."""
    m = re.match(r"_Z(\d+)(\w+)", mangled)
    if not m:
        return mangled
    n = int(m.group(1))
    base, rest = m.group(2)[:n], m.group(2)[n:]
    return base + "<" + ",".join(re.findall(r"L[ib](\d+)E", rest.split("EE")[0] + "E")) + ">"


def _counts(ops: list[str]) -> tuple[int, int, int]:
    """(IMAD, IADD3.X, other) instructions among ``ops``."""
    imad = sum(o.startswith("IMAD") for o in ops)
    xadd = sum(o.startswith("IADD3") and ".X" in o for o in ops)
    return imad, xadd, len(ops) - imad - xadd


def _mix(ops: list[str]) -> str:
    return "{} IMAD / {} IADD3.X / {} other".format(*_counts(ops))


def sass_blocks(lib_path: str, kernels=SASS_KERNELS) -> dict[str, tuple[list, list]]:
    """Each of ``kernels`` in a library's SASS (cuobjdump): its instructions'
    opcodes but NOPs, and its basic blocks (straight-line code between labels
    and branches), largest first."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name = _kernel_name(chunk.split("\n", 1)[0].strip())
        if not name.startswith(kernels):
            continue
        ops, blocks, cur = [], [], []
        for line in chunk.splitlines():
            if re.match(r"\s*\.L_x_\d+:", line):
                blocks.append(cur)
                cur = []
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if not m or m.group(1) == "NOP":
                continue
            ops.append(m.group(1))
            cur.append(m.group(1))
            if m.group(1).split(".")[0] in ("BRA", "EXIT", "RET", "CALL", "BRX", "JMP"):
                blocks.append(cur)
                cur = []
        blocks.append(cur)
        out[name] = (ops, sorted(blocks, key=len, reverse=True))
    return out


def sass_mix(lib_path: str, kernels=SASS_KERNELS, top: int = 2) -> list[str]:
    """The instruction mix of each of ``kernels`` (IMADs of every variant,
    IADD3s with carry-in, all other instructions but NOPs), for the whole
    function and for its ``top`` largest basic blocks, which in the generic
    kernel are a pass's products.  mont_mul_kernel's largest block is one
    Montgomery product with its loads and store."""
    try:
        found = sass_blocks(lib_path, kernels)
    except (OSError, subprocess.SubprocessError) as e:
        return [f"cuobjdump failed: {type(e).__name__}"]
    return [f"{name}: {_mix(ops)} (whole); largest blocks: "
            + "; ".join(f"{len(b)} = {_mix(b)}" for b in blocks[:top])
            for name, (ops, blocks) in found.items()]


def product_instructions(lib_path: str, run: int) -> tuple[float, float] | None:
    """Instructions of one Montgomery product and of one unreduced product
    with its sum, as the generic kernel's SASS forms them (8 words): its
    largest basic block is a pass of ``run`` Montgomery products; a pass of
    ``run`` unreduced products is the largest block with 40-70% of its
    IMADs.  None where the SASS shows no such blocks."""
    try:
        found = sass_blocks(lib_path, ("generic_round_kernel",))
    except (OSError, subprocess.SubprocessError):
        return None
    blocks = found.get("generic_round_kernel<8,0>", ([], []))[1]
    if not blocks:
        return None
    top = _counts(blocks[0])[0]
    lazy = [b for b in blocks[1:] if 0.4 * top <= _counts(b)[0] <= 0.7 * top]
    return (len(blocks[0]) / run, len(lazy[0]) / run) if lazy else None


def issue_floor_ms(full: int, lazy: int, per_product: tuple[float, float], max_sm_mhz: float) -> float:
    """The least time the card could issue the products' instructions of a
    call: full Montgomery and lazy unreduced products at the per-product
    instructions of :func:`product_instructions`, over 132 SMs × 4 warp
    instructions a clock × 32 threads × the SM clock.  Only the products
    count, so it is a floor."""
    instr = full * per_product[0] + lazy * per_product[1]
    return instr / (132 * 4 * 32 * max_sm_mhz * 1e6) * 1e3


def ptxas_summary(report: str) -> list[str]:
    """One line per compiled kernel from nvcc -Xptxas -v: its name and
    template arguments, registers and spill bytes."""
    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            base, rest = m.group(2)[:n], m.group(2)[n:]
            name = _kernel_name(m.group(0))
            spill = ""
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers; {spill}")
            name = None
    return out


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions at the paths' shapes
# ---------------------------------------------------------------------------


def _time_ms(fn, runs: int = 7) -> float:
    """Median of ``runs`` single calls, CUDA events around each."""
    import torch

    fn()  # warm-up
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


def _flat(x):
    import torch

    return [x] if isinstance(x, torch.Tensor) else list(x)


def phase1(cfg8, cfg6, info: dict) -> dict:
    """Every case of bench_kernels at 2^20 (256 bits) and at 2^16 (192 bits)
    against its plain version; returns the kernels-line numbers of each
    kernel (its first 256-bit case; max_abs_err over all its cases)."""
    import torch

    from zinc_tpu_torch.benches import bench_kernels as bk
    from zinc_tpu_torch.fields.montgomery import device_field

    results = {}
    floor_ms = bk.launch_floor_ms()
    log(f"[launch] an empty kernel (torch.cuda._sleep(0)) takes {floor_ms:.4f} ms device-only: "
        f"the launch floor")
    for cfg, log_n in ((cfg8, 20), (cfg6, 20)):
        ctx = device_field(cfg)
        for c in bk.cases(ctx, "cuda", log_n):
            got, want = _flat(c["kernel"]()), _flat(c["plain"]())
            torch.cuda.synchronize()
            err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item())
                      for g, w in zip(got, want))
            exact = err == 0 and all(torch.equal(g, w) for g, w in zip(got, want))
            ms, single_ms = bk.device_ms(c["kernel"]), _time_ms(c["kernel"])
            plain_ms = _time_ms(c["plain"], 3)
            bound, by = bk.bound_ms(ctx.n32, c["bytes"], c["full"], c["lazy"], info["max_sm_mhz"])
            floor = ""
            if ctx.n32 == 8 and c["name"] in GENERIC_ROWS and info["per_product"]:
                floor = (f" issue-slot floor "
                         f"{issue_floor_ms(c['full'], c['lazy'], info['per_product'], info['max_sm_mhz']):.4f} ms")
            if c["launch_bound"]:
                floor += f" bound with the launch floor {max(bound, floor_ms):.4f} ms"
            log(f"[kernel] {c['name']} ({c['shape']}, {ctx.n32} words): shapes "
                f"{[tuple(g.shape) for g in got]} max_abs_err {err} device-only {ms:.4f} ms "
                f"single {single_ms:.4f} ms plain {plain_ms:.4f} ms bound {bound:.4f} ms ({by}; "
                f"{c['full']} + {c['lazy']} unreduced products, {c['bytes']} bytes) "
                f"share {bound / ms:.3f}{floor}")
            if not exact:
                raise AssertionError(f"{c['name']}: kernel disagrees with its plain version")
            row = results.setdefault(c["name"], {
                "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": by, "library_ms": None, "single_ms": single_ms,
            })
            row["max_abs_err"] = max(row["max_abs_err"], err)
        compare_generic(ctx, log_n)
    k10_rounds(device_field(cfg8), info)
    return results


def k10_rounds(ctx, info: dict) -> None:
    """fold_round_eval's device-only time at each round shape of paths A and
    B (bench_kernels.k10_rounds), with the sums over the rounds, beside the
    bounds and their sums."""
    from zinc_tpu_torch.benches import bench_kernels as bk

    for path, rows in bk.k10_rounds(ctx, "cuda").items():
        times = [bk.device_ms(row["kernel"]) for row in rows]
        bounds = [bk.bound_ms(ctx.n32, row["bytes"], row["full"], row["lazy"], info["max_sm_mhz"])[0]
                  for row in rows]
        floors = (sum(issue_floor_ms(row["full"], row["lazy"], info["per_product"], info["max_sm_mhz"])
                      for row in rows) if info["per_product"] else float("nan"))
        log(f"[k10-rounds] path {path}, {len(rows)} rounds from 2^{rows[0]['b'].bit_length() - 1} "
            f"to 2^{rows[-1]['b'].bit_length() - 1} entries, {ctx.n32} words: device-only (ms) "
            f"{' '.join(f'{t:.4f}' for t in times)}; sum {sum(times):.4f} ms; bounds sum "
            f"{sum(bounds):.4f} ms; issue-slot floors sum {floors:.4f} ms; sum of time - bound "
            f"{sum(times) - sum(bounds):.4f} ms")


def compare_generic(ctx, log_n: int) -> None:
    """round_eval_generic at K3's shape (2 x 2^log_n, terms (0,1), 3 points)
    and at K4's (the three tables and E as a fourth table with E[p] at 2p
    and 2p+1, terms (0,1,3) and (2,3), 4 points): equal sums mod q, and the
    device-only times of both kernels."""
    import numpy as np
    import torch

    from zinc_tpu_torch.benches import bench_kernels as bk
    from zinc_tpu_torch.sumcheck import kernels as sk

    rng = np.random.default_rng(21)
    n = 1 << log_n
    sc2 = bk.random_residues(rng, ctx, (2, n), "cuda")
    sc1 = bk.random_residues(rng, ctx, (3, n), "cuda")
    e_lvl = bk.random_residues(rng, ctx, (n // 2,), "cuda")
    sc1e = torch.cat([sc1, e_lvl.repeat_interleave(2, dim=0)[None]]).contiguous()
    pairs = [
        ("K3", f"2 x 2^{log_n}, 1 term of 2, 3 points",
         lambda: sk.round_eval(ctx, sc2, [(0, 1)], 3),
         lambda: sk.round_eval_generic(ctx, sc2, [(0, 1)], 3)),
        ("K4", f"3 x 2^{log_n} + E, terms of 2 and 1, 4 points",
         lambda: sk.round_eval_gruen(ctx, sc1, e_lvl, [(0, 1), (2,)], 4),
         lambda: sk.round_eval_generic(ctx, sc1e, [(0, 1, 3), (2, 3)], 4)),
    ]
    for what, shape, own, generic in pairs:
        a, b = sk.sums_to_ints(ctx, own()), sk.sums_to_ints(ctx, generic())
        if not (a == b).all():
            raise AssertionError(f"round_eval_generic disagrees with {what} at its shape")
        log(f"[compare] {what}'s shape, {shape}, {ctx.n32} words: {what} {bk.device_ms(own):.4f} ms, "
            f"round_eval_generic {bk.device_ms(generic):.4f} ms device-only (equal sums)")


# ---------------------------------------------------------------------------
# phases 2 and 3: the main path
# ---------------------------------------------------------------------------


def prove_verify(ccs, statement, wit, device: str, n64: int = 4, mesh=None):
    """One prove (on ``device``, or on ``mesh``) and one verify (on
    ``device``, or on the mesh's first device)."""
    import zinc_tpu_torch as zt

    ztypes = zt.ZipTypes(1)
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, ztypes.n_words, n64)
    t0 = time.perf_counter()
    proof = zt.ZincProver(ztypes, device=device, mesh=mesh).prove(statement, wit, t, ccs, cfg)
    prove_s = time.perf_counter() - t0
    verifier = zt.ZincVerifier(ztypes, device=device if mesh is None else mesh.first)
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

    # a 192-bit field: 6-word kernels (8-byte vector loads)
    n, seed = N64_3_CASE
    ccs, statement, wit, _, _ = setup(n, seed, 3)
    _cuda.reset_launches()
    proof, cfg, _, _, _ = prove_verify(ccs, statement, wit, device, n64=3)
    launches = dict(_cuda.LAUNCHES)
    digest = hashlib.sha256(zt.serialize_proof(proof, cfg)).hexdigest()
    log(f"[2^8, n64 = 3] proof sha256 {digest}, verifier accepted; launches {launches}")
    if digest != N64_3_SHA256:
        raise AssertionError(f"the n64 = 3 proof hashes to {digest}, not {N64_3_SHA256}")
    check_launches(launches, R1CS_KERNELS, GENERIC_KERNELS, "the 2^8 dummy R1CS at n64 = 3")


def check_launches(launches: dict, must: tuple, must_not: tuple, what: str) -> None:
    missing = [k for k in must if launches[k] == 0]
    stray = [k for k in must_not if launches[k] != 0]
    if missing or stray:
        raise AssertionError(f"{what}: kernels not launched {missing}, launched off the path "
                             f"{stray}: {launches}")


def prove_verify_large(label: str, fixture, must: tuple, must_not: tuple, mesh=None) -> dict:
    """One prove (on the card, or on ``mesh``) and one verify on the card
    with the launch counts of that run, the stage walls, the proof size and
    the peak device memory; then the V_s[0] + 1 tamper, which must be
    rejected.  Returns the launches, the proof's sha256 and its roots."""
    import torch

    import zinc_tpu_torch as zt
    from zinc_tpu_torch.ops import _cuda
    from zinc_tpu_torch.timing import STAGES

    ccs, statement, wit = fixture
    torch.cuda.reset_peak_memory_stats()
    STAGES.clear()
    _cuda.reset_launches()
    proof, cfg, (_, verifier), prove_s, verify_s = prove_verify(ccs, statement, wit, "cuda",
                                                                mesh=mesh)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    blob = zt.serialize_proof(proof, cfg)
    size = len(blob)
    walls = {k: round(v, 4) for k, v in STAGES.items()}
    log(f"[{label}] prove {prove_s:.3f} s, verify {verify_s:.3f} s (accepted), "
        f"proof {size} bytes, peak device memory {peak / 2**30:.3f} GiB")
    log(f"[{label}] stage walls (s): {json.dumps(walls)}")
    log(f"[{label}] launches: {launches}")
    check_launches(launches, must, must_not, label)

    def bad_vs():
        proof.spartan_proof.V_s[0] = proof.spartan_proof.V_s[0] + cfg.one()
        verifier.verify(statement, proof, zt.KeccakTranscript(), ccs, cfg)

    digest = hashlib.sha256(blob).hexdigest()
    log(f"[{label}] proof sha256 {digest}")
    expect_reject(bad_vs, f"{label}: V_s[0] + 1")
    return {"launches": launches, "sha256": digest, "roots": proof.zip_proof.z_comm.roots}


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
                              ("round_eval_gruen",))["launches"]


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


def _prove_on_mesh(label: str, fixture, mesh) -> dict:
    """One prove on ``mesh`` (no verify): its wall, sha256 and roots."""
    import zinc_tpu_torch as zt

    ccs, statement, wit = fixture
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, 1, 4)
    t0 = time.perf_counter()
    proof = zt.ZincProver(zt.ZipTypes(1), mesh=mesh).prove(statement, wit, t, ccs, cfg)
    wall = time.perf_counter() - t0
    digest = hashlib.sha256(zt.serialize_proof(proof, cfg)).hexdigest()
    log(f"[{label}] prove {wall:.3f} s, proof sha256 {digest}, {mesh.stats}")
    return {"sha256": digest, "roots": proof.zip_proof.z_comm.roots}


def check_sharded(label: str, mesh, log_n: int, commit: str) -> None:
    """Both sumchecks ran their rounds down to HOST_TAIL entries a shard on
    the shards, and the commit ran in the layout ``commit``."""
    from zinc_tpu_torch.sumcheck.executor import HOST_TAIL

    d = mesh.size
    want = 0 if (1 << log_n) % d else log_n - (d.bit_length() - 1) - (HOST_TAIL.bit_length() - 1)
    rounds = mesh.stats.get("sharded_rounds")
    log(f"[{label}] sharded rounds per sumcheck {rounds} of {log_n} (want {want} each); "
        f"commit {mesh.stats.get('commit')}")
    if rounds != [want, want] or mesh.stats.get("commit") != [commit]:
        raise AssertionError(f"{label}: the mesh was not used as expected: {mesh.stats}")


def phase7(log_n: int, single: dict, card="cuda:0") -> dict:
    """The sharded prove on the card: (a) the 2^log_n R1CS (seed 5) on four
    shards of cuda:0, its proof byte-identical to phase 3's, verified, the
    tamper rejected, 12 of 20 rounds of each sumcheck on the shards and the
    commit in 4 row blocks; (b) path A at 2^10 on four shards, hashed to
    PATH_A_SHA256_2P10; (c) a 2 x 2 mesh of cuda:0 at 2^log_n, roots and
    proof equal (a)'s; (d) where there are two cards or more, (a) on
    ``local_mesh()`` over the real cards.  Returns (a)'s launches.  ``card``
    is the device the shards repeat (a CPU rehearsal passes "cpu")."""
    import torch

    import zinc_tpu_torch as zt
    from zinc_tpu_torch.parallel import Mesh, local_mesh

    card = torch.device(card)
    ccs, statement, wit, _, _ = setup(1 << log_n, 5)
    mesh = Mesh([card] * 4)
    label = f"mesh 4 x {card} 2^{log_n}"
    a = prove_verify_large(label, (ccs, statement, wit), R1CS_KERNELS, GENERIC_KERNELS, mesh=mesh)
    check_sharded(label, mesh, log_n, "4 row blocks")
    if a["sha256"] != single["sha256"]:
        raise AssertionError(f"{label}: proof differs from the single-device proof")
    log(f"[{label}] proof identical to the single-device proof of phase 3")

    mesh_a = Mesh([card] * 4)
    proof, cfg, _, _, _ = prove_verify(*degree4_fixture(1 << 10, 1234), "cuda", mesh=mesh_a)
    digest = hashlib.sha256(zt.serialize_proof(proof, cfg)).hexdigest()
    log(f"[mesh 4 x {card} path A 2^10] proof sha256 {digest}, verifier accepted")
    if digest != PATH_A_SHA256_2P10:
        raise AssertionError(f"path A 2^10 on 4 shards hashes to {digest}, not {PATH_A_SHA256_2P10}")
    check_sharded(f"mesh 4 x {card} path A 2^10", mesh_a, 10, "4 row blocks")

    mesh_2d = Mesh([[card, card], [card, card]], ("r", "c"))
    c = _prove_on_mesh(f"mesh 2 x 2 x {card} 2^{log_n}", (ccs, statement, wit), mesh_2d)
    check_sharded(f"mesh 2 x 2 x {card} 2^{log_n}", mesh_2d, log_n, "2 row blocks x 2 column blocks")
    if c["sha256"] != a["sha256"] or c["roots"] != a["roots"]:
        raise AssertionError("the 2 x 2 mesh's roots or proof differ from the 1-D mesh's")
    log(f"[mesh 2 x 2 x {card} 2^{log_n}] roots and proof identical to the 4-shard mesh's")

    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        cards = local_mesh()
        label = f"mesh of {n_cards} cards 2^{log_n}"
        d = prove_verify_large(label, (ccs, statement, wit), R1CS_KERNELS, GENERIC_KERNELS,
                               mesh=cards)
        even = n_cards & (n_cards - 1) == 0  # splits the rows and the hypercube
        check_sharded(label, cards, log_n, f"{n_cards} row blocks" if even else "one device")
        if d["sha256"] != single["sha256"]:
            raise AssertionError(f"{label}: proof differs from the single-device proof")
    else:
        log(f"[mesh of cards] (d) not run: torch.cuda.device_count() is {n_cards}, and a mesh of "
            f"separate cards needs two or more")
    return a["launches"]


# ---------------------------------------------------------------------------
# phase 8: the host backend as the oracle
# ---------------------------------------------------------------------------

PIN_2P14 = ROOT / "tests" / "golden" / "proof_2p14.sha256"
N14_CASE = (1 << 14, 4321)  # tests/golden/gen.py: N14, SEED14 (the JAX host prover's proof)


def _prove_timed(fixture, n64: int, **prover_args):
    """One prove of ``fixture`` with these ZincProver arguments: (proof,
    cfg, bytes, wall)."""
    import zinc_tpu_torch as zt

    ccs, statement, wit = fixture
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, 1, n64)
    t0 = time.perf_counter()
    proof = zt.ZincProver(zt.ZipTypes(1), **prover_args).prove(statement, wit, t, ccs, cfg)
    wall = time.perf_counter() - t0
    return proof, cfg, zt.serialize_proof(proof, cfg), wall


def _check_device_launches(device, launches: dict, must: tuple, must_not: tuple, what: str) -> None:
    import torch

    if torch.device(device).type == "cuda":  # a CPU rehearsal launches no kernel
        check_launches(launches, must, must_not, what)


def phase8(device="cuda") -> list[dict]:
    """The port's host backend (pure Python, no kernel) as the oracle of the
    device path: (a) the 2^14 R1CS of tests/golden/gen.py (seed 4321): the
    host proof hashes to tests/golden/proof_2p14.sha256, the device proof
    on ``device`` has the same bytes, the host verifier accepts the device
    proof and the device verifier the host proof; (b) a seed drawn now: the
    device prover's bytes equal the host prover's for the 2^12 R1CS at n64
    = 4 and = 3 and for path A at 2^12.  Returns the launches of each device
    run, each counted from 0."""
    import zinc_tpu_torch as zt
    from zinc_tpu_torch.ops import _cuda

    runs = []
    want_digest, want_len = PIN_2P14.read_text().split()
    n, seed = N14_CASE
    ccs, statement, wit, _, _ = setup(n, seed)
    fixture = (ccs, statement, wit)
    host, cfg, blob, host_s = _prove_timed(fixture, 4, backend="host")
    digest = hashlib.sha256(blob).hexdigest()
    log(f"[oracle 2^14] host prove {host_s:.3f} s, {len(blob)} bytes, sha256 {digest}")
    if (digest, len(blob)) != (want_digest, int(want_len)):
        raise AssertionError(f"the host 2^14 proof is not {PIN_2P14.name}'s {want_digest} "
                             f"({want_len} bytes)")
    _cuda.reset_launches()
    dev, _, dev_blob, dev_s = _prove_timed(fixture, 4, device=device)
    launches = dict(_cuda.LAUNCHES)
    if dev_blob != blob:
        raise AssertionError("the device 2^14 proof differs from the host oracle's")
    _check_device_launches(device, launches, R1CS_KERNELS, GENERIC_KERNELS, "the 2^14 device prove")
    runs.append(launches)
    t0 = time.perf_counter()
    zt.ZincVerifier(zt.ZipTypes(1), backend="host").verify(statement, dev, zt.KeccakTranscript(),
                                                           ccs, cfg)
    host_verify_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    zt.ZincVerifier(zt.ZipTypes(1), device=device).verify(statement, host, zt.KeccakTranscript(),
                                                          ccs, cfg)
    dev_verify_s = time.perf_counter() - t0
    log(f"[oracle 2^14] device prove {dev_s:.3f} s on {device}: the same bytes; the host verifier "
        f"accepted the device proof ({host_verify_s:.3f} s), the device verifier the host proof "
        f"({dev_verify_s:.3f} s); launches {launches}")

    live = random.SystemRandom().randrange(1 << 31)
    log(f"[oracle live] seed {live}")
    cases = [
        ("R1CS 2^12, n64 = 4", setup(1 << 12, live)[:3], 4, R1CS_KERNELS, GENERIC_KERNELS),
        ("R1CS 2^12, n64 = 3", setup(1 << 12, live, 3)[:3], 3, R1CS_KERNELS, GENERIC_KERNELS),
        ("path A 2^12", degree4_fixture(1 << 12, live), 4, PATH_A_KERNELS, ("round_eval_gruen",)),
    ]
    for label, fixture, n64, must, must_not in cases:
        _, _, blob, host_s = _prove_timed(fixture, n64, backend="host")
        _cuda.reset_launches()
        _, _, dev_blob, dev_s = _prove_timed(fixture, n64, device=device)
        launches = dict(_cuda.LAUNCHES)
        digest = hashlib.sha256(dev_blob).hexdigest()
        log(f"[oracle live] {label}, seed {live}: host prove {host_s:.3f} s, device prove "
            f"{dev_s:.3f} s, {len(dev_blob)} bytes, sha256 {digest}; launches {launches}")
        if dev_blob != blob:
            raise AssertionError(f"{label}, seed {live}: the device proof differs from the host's")
        _check_device_launches(device, launches, must, must_not, f"{label} (oracle)")
        runs.append(launches)
    log(f"[oracle live] seed {live}: device bytes equal the host oracle's in all three cases")
    return runs


# ---------------------------------------------------------------------------
# phase 9: a mesh over two processes
# ---------------------------------------------------------------------------

RANK_TIMEOUT_S = 600  # a rank's whole run: start, fixture, prove, verify


def rank_main(argv: list[str]) -> int:
    """One rank of phase 9 (``chip_smoke.py --rank R ...``): join the group,
    prove the 2^log_n R1CS (seed 5) on ``hierarchical_mesh`` over the ranks
    and print its result as one ``[rank-result]`` JSON line; rank 0 also
    verifies the proof and checks that the V_s[0] + 1 tamper is rejected."""
    import argparse

    import torch
    import torch.distributed as dist

    import zinc_tpu_torch as zt
    from zinc_tpu_torch.ops import _cuda
    from zinc_tpu_torch.parallel import hierarchical_mesh, init_distributed
    from zinc_tpu_torch.timing import STAGES

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--log-n", type=int, required=True)
    ap.add_argument("--devices", required=True, help="the local devices, comma-separated, or 'own'")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    if not init_distributed(init_method=f"tcp://127.0.0.1:{args.port}", world_size=args.world,
                            rank=args.rank, backend=args.backend, timeout_s=RANK_TIMEOUT_S / 2):
        raise SystemExit("init_distributed started no process group")
    devices = None if args.devices == "own" else args.devices.split(",")
    mesh = hierarchical_mesh(args.world, None if devices is None else len(devices), devices=devices)
    ccs, statement, wit, ztypes, _ = setup(1 << args.log_n, 5)
    dev = mesh.first
    on_card = dev.type == "cuda"  # a fresh process: its peak memory is the prove's
    STAGES.clear()
    _cuda.reset_launches()
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, ztypes.n_words, 4)
    t0 = time.perf_counter()
    proof = zt.ZincProver(ztypes, mesh=mesh).prove(statement, wit, t, ccs, cfg)
    prove_s = time.perf_counter() - t0
    res = {
        "rank": args.rank, "backend": mesh.group.backend, "mesh": repr(mesh), "shards": mesh.size,
        "sha256": hashlib.sha256(zt.serialize_proof(proof, cfg)).hexdigest(),
        "prove_s": prove_s, "walls": {k: round(v, 4) for k, v in STAGES.items()},
        "launches": dict(_cuda.LAUNCHES), "stats": mesh.stats,
        "collective_calls": mesh.group.calls, "collective_bytes": mesh.group.bytes,
        "on_card": on_card,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None,
    }
    if args.rank == 0:
        verifier = zt.ZincVerifier(ztypes, device=dev)
        t0 = time.perf_counter()
        verifier.verify(statement, proof, zt.KeccakTranscript(), ccs, cfg)
        res["verify_s"] = time.perf_counter() - t0
        proof.spartan_proof.V_s[0] = proof.spartan_proof.V_s[0] + cfg.one()
        try:
            verifier.verify(statement, proof, zt.KeccakTranscript(), ccs, cfg)
        except zt.ZincError as e:
            res["tamper"] = f"V_s[0] + 1 rejected ({type(e).__name__})"
        else:
            raise AssertionError("the two-process proof's V_s[0] + 1 tamper was accepted")
    print("[rank-result] " + json.dumps(res), flush=True)
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(label: str, log_n: int, devices: str, backend: str | None, world: int = 2) -> list[dict]:
    """``world`` ranks of ``rank_main``, each a child process with its output
    in a temporary file; a rank that exits non-zero or is still running
    after RANK_TIMEOUT_S fails the phase, and every child is stopped."""
    import os
    import tempfile

    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")}
    extra = [] if backend is None else ["--backend", backend]
    outs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--rank", str(r),
                               "--world", str(world), "--port", str(port), "--log-n", str(log_n),
                               "--devices", devices, *extra],
                              stdout=outs[r], stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"[{label}] rank {r} still running after {RANK_TIMEOUT_S} s") \
                    from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for f in outs:
            f.seek(0)
            texts.append(f.read())
            f.close()
        for r, text in enumerate(texts):
            for line in text.splitlines()[-40:]:
                if not line.startswith("[rank-result]"):
                    log(f"[{label}] [rank {r}] {line}")
    results = []
    for r, (p, text) in enumerate(zip(procs, texts)):
        found = [ln for ln in text.splitlines() if ln.startswith("[rank-result] ")]
        if p.returncode != 0 or not found:
            raise AssertionError(f"[{label}] rank {r} exited {p.returncode} without a result")
        results.append(json.loads(found[-1][len("[rank-result] "):]))
    return results


def check_ranks(label: str, results: list[dict], single: dict, log_n: int, commit: str) -> None:
    """Every rank's proof hashes to ``single``'s sha256, rank 0 verified it
    and saw the tamper rejected, both sumchecks ran sharded down to
    HOST_TAIL entries a shard, the commit ran in ``commit``, and (on the
    card) every kernel of the R1CS path launched on every rank."""
    from zinc_tpu_torch.sumcheck.executor import HOST_TAIL

    shards = results[0]["shards"]
    want = log_n - (shards.bit_length() - 1) - (HOST_TAIL.bit_length() - 1)
    for res in results:
        log(f"[{label}] rank {res['rank']} ({res['backend']}): prove {res['prove_s']:.3f} s, sha256 "
            f"{res['sha256']}, collectives {res['collective_calls']} all-gathers, "
            f"{res['collective_bytes']} bytes in from the other ranks, peak device memory "
            f"{res['peak_gib'] if res['peak_gib'] is None else round(res['peak_gib'], 3)} GiB, "
            f"{res['stats']}")
        log(f"[{label}] rank {res['rank']} stage walls (s): {json.dumps(res['walls'])}")
        log(f"[{label}] rank {res['rank']} launches: {res['launches']}")
        if res["sha256"] != single["sha256"]:
            raise AssertionError(f"[{label}] rank {res['rank']}'s proof differs from phase 3's")
        if res["stats"] != {"sharded_rounds": [want, want], "commit": [commit]}:
            raise AssertionError(f"[{label}] rank {res['rank']}: the mesh was not used as "
                                 f"expected: {res['stats']}")
        if res["on_card"]:
            check_launches(res["launches"], R1CS_KERNELS, GENERIC_KERNELS,
                           f"{label} rank {res['rank']}")
    log(f"[{label}] rank 0 verified in {results[0]['verify_s']:.3f} s, {results[0]['tamper']}; "
        f"every rank's proof is phase 3's")


def phase9(single: dict, log_n: int = 20, devices: str = "cuda:0,cuda:0") -> list[dict]:
    """A mesh over two processes: (a) two ranks on this one card, each with
    the local devices ``devices`` on ``hierarchical_mesh(2, 2)``, over gloo
    (NCCL refuses two ranks on one card): the 2^log_n R1CS (seed 5) hashes
    to phase 3's sha256 on both ranks, rank 0 verifies it and rejects the
    tamper, 12 of 20 rounds of each sumcheck run on the 4 shards and the
    commit in 2 row blocks x 2 column blocks; (b) with two cards or more,
    one rank per card over NCCL.  Returns each rank's launches."""
    import torch

    results = run_ranks("2 processes", log_n, devices, "gloo")
    check_ranks("2 processes", results, single, log_n, "2 row blocks x 2 column blocks")
    launches = [r["launches"] for r in results]
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards >= 2:
        results = run_ranks("2 processes, NCCL", log_n, "own", "nccl")
        check_ranks("2 processes, NCCL", results, single, log_n, "2 row blocks x 1 column blocks")
        launches += [r["launches"] for r in results]
    else:
        log(f"[2 processes, NCCL] not run: torch.cuda.device_count() is {n_cards}, and one rank "
            f"per card needs two cards or more")
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

    info = phase0()
    _, _, _, _, cfg8 = setup(1 << 10, 1234)  # any field of the main path's width
    _, _, _, _, cfg6 = setup(*N64_3_CASE, 3)
    kernels = phase1(cfg8, cfg6, info)
    phase2("cuda")
    single = phase3(20)
    profile_prove(20)
    runs = [single["launches"], phase5(20), phase6(20), phase7(20, single)]
    runs += phase8()
    runs += phase9(single)
    # the main paths' launches: the four 2^20 runs, the oracle's device runs
    # and the two-process ranks (each counted from 0)
    launches = {name: sum(r[name] for r in runs) for name in KERNELS}
    if not all(launches.values()):
        raise AssertionError(f"a kernel launched in none of the main paths' runs: {launches}")
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
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        sys.exit(rank_main(sys.argv[1:]))
    sys.exit(main())
