"""Drive the PyTorch/CUDA port of Zinc on one GPU and check it end to end.

    python3 chip_smoke.py            # every phase, as the quick proof that the port runs
    python3 chip_smoke.py --cards    # phases 7(d) and 9(b) alone, on two cards or more, and
                                     # the 2^22 R1CS on one card and on local_mesh()
    python3 chip_smoke.py --rank R --world W --port P --log-n L --devices D
                                     # one rank of phase 9 (started by phase 9 itself)

Phases (any failure exits non-zero; there is no CPU fallback):

0. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
   kernels' build: the 6-, 8- and 16-word libraries (n64 = 3, 4, 8) and
   the BLAKE3 library, every nvcc process at once, with each kernel's
   registers and spills, and the instruction mix (IMAD, IADD3.X, other)
   in the SASS of mont_mul_kernel (one product), of the generic kernels,
   of eq_table_kernel and of blake3_leaves_kernel (its largest block: a
   leaf's compression), whole and in their largest basic blocks (a pass's
   products), and how many clusters of 8 and of 16 leaves blocks the card
   holds at once;
1. each CUDA kernel against its plain PyTorch version at the shapes the
   paths below give it (2^20 tables, path B's last fold at 7 × 128) at
   n64 = 4 and n64 = 3: exactly equal (every value is an integer residue),
   with its device-only time (CUDA events around 20 back-to-back wrapper
   calls), its single-launch time (median of 7), the plain time (median of
   3) and its bound (zinc_tpu_torch/benches/bench_kernels.py); then the
   generic eval against K3 and K4 at their shapes, equal sums and both
   device-only times; then fold_round_eval at each of the 13 round shapes of
   paths A and B, with the sums over the rounds; fold and fold_round_eval
   also with r on the card (the device-resident Fiat-Shamir loop's form);
   the eq table of 2^20 entries (eq_table, one launch: every level, and
   level 0 alone) at 8, 6 and 16 words and of 2^10 and 2^11 entries (one
   block, two blocks) at 8 words, and the BLAKE3 Merkle tree of the 2^20
   commit (1024 rows of 2048 codewords of 8 words in int64 lanes): the
   leaves launch with its cluster tail (the whole tree, one launch), the
   leaves launch without it, the merge launch of a row deeper than a
   cluster (64 rows of 2^14 codewords) and of 9 levels, and the whole tree;
   and the Zip open's column records (zip_records, one launch) of 1000
   columns at the 2^14 and 2^20 opens (128 x 256 codewords, depth 8; 1024 x
   2048, depth 11);
1b. fs_round (the device-resident Fiat-Shamir round, csrc/fs.cu) against
   its plain version, equal in every word it writes, at the shapes the
   paths give it (bench_kernels.fs_cases: the R1CS sumchecks on one block
   and on four, path A's generic comb, sponge positions that cross a
   block, and shapes again at other positions) at 8, 6 and 16 words, with
   its device-only time and Keccak-f permutations beside the launch floor
   and each width's fit of time to permutations; fold and fold_round_eval
   with r on the card equal to their host-word forms;
2. 2^10: the port's prove reproduces tests/golden/proof_2p10.bin byte for
   byte through the kernels, its verifier accepts it, and both tamper
   probes are rejected; every kernel of the dummy-R1CS path launched, and
   none of the generic tier.  Then the 2^8 dummy R1CS over a 192-bit field
   (n64 = 3) through the kernels: the proof hashes to N64_3_SHA256 (the JAX
   host prover's bytes, pinned by tests/test_torch_e2e.py) and verifies;
3. 2^20 (seed 5, the production configuration): one prove and one verify
   through ZincProver/ZincVerifier, with the launch counts of that run,
   the stage walls, the proof size and the peak device memory; the proof
   hashes to R1CS_SHA256_2P20, each sumcheck ran the device-FS driver and
   fetched from the card once, and the V_s[0] + 1 tamper is rejected;
3b. both sumcheck drivers on the same device tables (compare_drivers):
   Spartan's sumchecks of the R1CS at 2^12, 2^14, 2^16 and 2^20 and of
   path A at 2^20, from clones of one transcript, in turns: equal proofs
   and transcript states, each driver call's wall (synced at both ends),
   the host fetches of each sumcheck (1 for device FS) and the device-FS
   driver's steps; its enqueue loop runs under
   torch.cuda.set_sync_debug_mode("error");
4. none: the benchmark's traced runs (benchmark/) read the device's busy
   share and the kernels that take the most device time;
5. path A, a degree-4 CCS outside K3's scope (z⁴ − z³·z = 0, five
   matrices, sumcheck 1 on the generic tier): the 2^10 proof hashes to
   PATH_A_SHA256_2P10 (the JAX host prover's proof, pinned by
   tests/test_torch_generic.py), and at 2^20 (seed 5) one prove and one
   verify, with walls, launches and peak memory, the proof hashed to
   PATH_A_SHA256_2P20, one fetch a sumcheck; the V_s tamper is rejected;
6. path B, zinc_tpu_torch.benches.bench_sumcheck at 2^20 (7 factors,
   degree 7), on the per-round executor as its JAX namesake: prove and
   verify times, accepted by the host verifier;
7. the sharded prove (zinc_tpu_torch.parallel) on the card: (a) the 2^20
   R1CS on Mesh([cuda:0] * 4), byte-identical to phase 3's proof, verified,
   the tamper rejected, with walls, launches, peak memory, 12 of the 20
   rounds of each sumcheck on the shards (the sharded device-FS driver,
   one fetch a sumcheck) and the commit in 4 row blocks;
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
   with a timeout), every rank on the device-FS driver, running fs_round
   over the all-gathered sums of every shard: (a) two ranks on this card
   over gloo, each with the local devices [cuda:0, cuda:0] on
   hierarchical_mesh(2, 2); each rank first runs Spartan's two 2^20
   sumchecks under both sharded drivers on the same tables
   (compare_drivers: equal proofs, r and transcripts, both drivers'
   walls), then proves the 2^20 R1CS of phase 3 to its sha256 with both
   sumchecks on the device-FS driver (12 sharded rounds each, one fetch
   and 13 gathers staged through the host, since gloo gathers only
   there), both ranks' transcripts ending equal; rank 0 verifies and
   rejects the tamper; every rank's stage walls, launches (fs_round once a
   device round), sumchecks and the bytes its all-gathers brought in;
   (b) with two cards or more, one rank per card over NCCL: one fetch a
   sumcheck, no gather through the host, and the enqueue loops, the
   rank's first collective among them, clean under sync debug "error";
10. the bench mirrors (zinc_tpu_torch/benches/) on the card, each through
   its ``main``: bench_round (a 2^20 round of bench.py's metric, K4 then
   K2 as native/cpu_baseline.cpp runs it, held exactly equal to its plain
   versions before it is timed, with vs_baseline from
   native/cpu_baseline.cpp built and run on this host), bench_field at 2^20,
   bench_prime, bench_spartan and bench_zip at 2^12, 2^14 and 2^16; their
   JSON lines print on lines of their own, and each must print every metric
   it owes.  bench_round's launches are logged on their own line.

The native runtime runs at its default thread count.  The line before the
last is a JSON object with one entry per kernel: its launches summed over
the four 2^20 runs (phase 3, path A at 2^20, path B's timed prove, phase
7's (a)), phase 8's device proves and phase 9's ranks, each counted from 0,
and the numbers of its first phase-1 case (fs_round's: its first phase-1b
case, whose bound is written beside the launch floor); phase 9's ranks
count their proves only, fs_round among them.  The 2^10 runs', phase 3b's
and phase 10's launches are logged on their own lines; phase 9's driver
comparisons' are not counted.  The last line is the JSON result object.
"""

from __future__ import annotations

import functools
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
    "fs_round": ("cuda", "zinc_tpu_torch/csrc/fs.cu",
                 "zinc_tpu/sumcheck/device_fs.py:85 (_make_fs_step, the XLA Fiat-Shamir step); "
                 "zinc_tpu/ops/keccak_kernel.py:64 (keccak_f1600_device), :183 (absorb_dyn), "
                 ":206 (digest_dyn)"),
    "blake3_leaves": ("cuda", "zinc_tpu_torch/csrc/blake3.cu",
                      "zinc_tpu/ops/blake3_kernel.py:160 (merkle_tree_device, XLA, not Pallas): "
                      ":48 (compress_batch), :98 (hash_single_chunk_batch), :129 "
                      "(limbs16_to_msg_words), and its first merges"),
    "blake3_merge": ("cuda", "zinc_tpu_torch/csrc/blake3.cu",
                     "zinc_tpu/ops/blake3_kernel.py:117 (merge_pairs_batch, XLA, not Pallas), "
                     ":48 (compress_batch), in merkle_tree_device's level loop (:171)"),
    "eq_table": ("cuda", "zinc_tpu_torch/csrc/eq.cu",
                 "zinc_tpu/poly/device.py:70 (_eq_table_device, XLA, not Pallas); "
                 "zinc_tpu/sumcheck/mxu_exec.py:835 (build_eq_suffix_flat, XLA, not Pallas)"),
    "zip_records": ("cuda", "zinc_tpu_torch/csrc/zip_records.cu",
                    "zinc_tpu/zip/device.py:261 (dispatch_column_gathers, XLA, not Pallas), "
                    ":289 (write_column_records, numpy)"),
}
# the kernels each path must launch (and the dummy R1CS none of the generic tier),
# on one device, on a mesh and on every rank of a mesh over processes: every
# prove builds eq tables, commits and opens; blake3_merge launches only where the
# commit's rows are deeper than a leaves launch merges or are split over
# devices (tree_kernels)
EQ_ZIP_KERNELS = ("eq_table", "blake3_leaves", "zip_records")
R1CS_KERNELS = ("mont_mul", "fold", "round_eval", "round_eval_gruen", "fs_round") + EQ_ZIP_KERNELS
GENERIC_KERNELS = ("round_eval_generic", "fold_round_eval")
PATH_A_KERNELS = ("mont_mul", "fold", "round_eval", "fs_round") + GENERIC_KERNELS + EQ_ZIP_KERNELS
PATH_B_KERNELS = ("fold",) + GENERIC_KERNELS  # path B's bench keeps the per-round executor
GENERIC_ROWS = GENERIC_KERNELS  # the phase-1 rows that also report an issue-slot floor

# sha256 of the path A proof at 2^10 (seed 1234): the JAX package's host
# prover gives these bytes (tests/test_torch_generic.py holds the two equal)
PATH_A_SHA256_2P10 = "39ecc9b919b83f83f3831af319fa005ee7a7fcd766535b59caa0a115c79e0505"
# (n, seed) of the dummy R1CS proved over a 192-bit field (n64 = 3), and the
# sha256 of the JAX host prover's proof (tests/test_torch_e2e.py holds the two equal)
N64_3_CASE = (1 << 8, 1234)
N64_3_SHA256 = "facb3c5b1a8356f5f60363993fc196150c9ceecfeedf8cf32fe1dc4a5551bf8a"
# sha256 of the 2^20 proofs (seed 5) of phase 3 and of path A: the per-round
# driver's bytes on the card, which every mesh and process rank reproduced
# (phases 7 and 9); the device-resident Fiat-Shamir driver must keep them
R1CS_SHA256_2P20 = "1c247053da5882809f4b39de2c551898e14cb0cff20f504233db6ea9df253a2a"
PATH_A_SHA256_2P20 = "6f4609087fe5211bfef31dc0e5bb085adf31ab652146ea218bf1c510020244a0"
# sha256 of the 2^22 R1CS proof (seed 5) on one card, which local_mesh()
# over four cards reproduces (``--cards``)
R1CS_SHA256_2P22 = "ffbdd5dad3c00a8af611ddb0f87524060cab2d8d3b6e3e73fac0375858333be2"


def log(msg: str) -> None:
    print(msg, flush=True)


def commit_merges(log_n: int, columns: int = 1) -> int:
    """blake3_merge launches of one row block's commit of a 2^log_n CCS, its
    rows of 2^(log_n/2 + 1) codewords split over ``columns`` devices: each
    column block's tree, then the merge of their roots
    (ops/blake3.tree_plan, merge_plan)."""
    from zinc_tpu_torch.ops.blake3 import merge_plan, tree_plan

    n = 1 << (log_n // 2 + 1)
    return columns * len(tree_plan(n // columns)[1]) + len(merge_plan(columns.bit_length() - 1))


def tree_kernels(kernels: tuple, must_not: tuple, log_n: int, columns: int = 1) -> tuple:
    """(must, must_not) of a run: blake3_merge joins ``kernels`` where the
    commit merges (commit_merges) and ``must_not`` where the leaves launch's
    cluster tail takes the whole row."""
    merge = ("blake3_merge",)
    if commit_merges(log_n, columns):
        return kernels + merge, must_not
    return kernels, must_not + merge


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

    from zinc_tpu_torch.benches.bench_kernels import card, smi_row
    from zinc_tpu_torch.ops import _cuda
    from zinc_tpu_torch.ops.blake3 import max_active_clusters

    log(smi_row("cuda:0", "name,power.limit"))
    info = card()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}, "
        f"max SM clock {info['max_sm_mhz']:.0f} MHz")
    t0 = time.perf_counter()
    targets = BUILD_WIDTHS + (_cuda.BLAKE3,)
    _cuda.build(targets)
    log(f"kernel build {time.perf_counter() - t0:.1f} s, widths {list(BUILD_WIDTHS)} and "
        f"{_cuda.BLAKE3} (cached {[_cuda.BUILD[t]['cached'] for t in targets]})")
    for t in targets:
        for line in ptxas_summary(_cuda.BUILD[t]["ptxas"]):
            log(f"[ptxas] {line}")
    for line in sass_mix(_cuda.BUILD[8]["path"]) + sass_mix(_cuda.BUILD[_cuda.BLAKE3]["path"]):
        log(f"[sass] {line}")
    log("[cluster] blake3_leaves_cluster_kernel: cudaOccupancyMaxActiveClusters "
        + ", ".join(f"{1 << c} blocks a cluster: {max_active_clusters(c)}" for c in (3, 4)))
    from zinc_tpu_torch.sumcheck.kernels import GENERIC_LIMITS

    info["per_product"] = product_instructions(_cuda.BUILD[8]["path"], GENERIC_LIMITS["ZT_GEN_PASS"])
    log(f"[sass] instructions a Montgomery product, an unreduced product and its sum "
        f"(generic_round_kernel<8,0>): {info['per_product']}")
    return info


SASS_KERNELS = ("mont_mul_kernel", "generic_round_kernel", "eq_table_kernel",
                "blake3_leaves_kernel", "blake3_leaves_cluster_kernel")


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
    """Every case of bench_kernels at 2^20 at 256 and 192 bits, the eq table
    also at 512 bits and at 2^10 and 2^11 entries, against its plain
    version; returns the kernels-line numbers of each kernel (its first
    256-bit case; max_abs_err over all its cases)."""
    import torch

    from zinc_tpu_torch.benches import bench_kernels as bk
    from zinc_tpu_torch.fields.montgomery import device_field
    from zinc_tpu_torch.ops.field_kernels import eq_block_levels

    floor_ms = bk.launch_floor_ms()
    results = {"_launch_floor_ms": floor_ms}
    log(f"[launch] an empty kernel (torch.cuda._sleep(0)) takes {floor_ms:.4f} ms device-only: "
        f"the launch floor")
    for cfg, log_n in ((cfg8, 20), (cfg6, 20)):
        ctx = device_field(cfg)
        for c in bk.cases(ctx, "cuda", log_n):
            _check_case(c, ctx.n32, info, floor_ms, results)
        compare_generic(ctx, log_n)
    for c in bk.eq_cases(device_field(bk.field_of_words(16)), "cuda"):
        _check_case(c, 16, info, floor_ms, results)
    ctx8 = device_field(cfg8)
    e = eq_block_levels(ctx8.n32, 20)
    for log_n in (e, e + 1):  # one block, two blocks
        _check_case(bk.eq_cases(ctx8, "cuda", log_n)[0], 8, info, floor_ms, results)
    for c in bk.merkle_cases("cuda") + bk.zip_records_cases("cuda"):
        _check_case(c, 0, info, floor_ms, results)
    k10_rounds(device_field(cfg8), info)
    return results


def _check_case(c: dict, n32: int, info: dict, floor_ms: float, results: dict) -> None:
    """One bench_kernels case: the kernel exactly equal to its plain version,
    its device-only, single-launch and plain times and its bound, logged;
    the first case of each kernel fills its kernels-line row in
    ``results``.  ``n32`` is the field's words (0: a kernel of no field)."""
    import torch

    from zinc_tpu_torch.benches import bench_kernels as bk

    got, want = _flat(c["kernel"]()), _flat(c["plain"]())
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item())
              for g, w in zip(got, want))
    exact = len(got) == len(want) and err == 0 and all(torch.equal(g, w) for g, w in zip(got, want))
    ms, single_ms = bk.device_ms(c["kernel"]), _time_ms(c["kernel"])
    plain_ms = _time_ms(c["plain"], 3)
    bound, by = bk.bound_ms(n32, c["bytes"], c["full"], c["lazy"], info["max_sm_mhz"], c["int_ops"])
    floor = ""
    if n32 == 8 and c["name"] in GENERIC_ROWS and info["per_product"]:
        floor = (f" issue-slot floor "
                 f"{issue_floor_ms(c['full'], c['lazy'], info['per_product'], info['max_sm_mhz']):.4f} ms")
    if c["launch_bound"]:
        launches = bk.launches_of(c["kernel"])
        floor += (f" bound with the launch floor of {launches} launches "
                  f"{max(bound, launches * floor_ms):.4f} ms")
    work = (f"{c['int_ops'][0]} ALU-only of {c['int_ops'][1]} integer instructions"
            if c["int_ops"][1] else f"{c['full']} + {c['lazy']} unreduced products")
    shapes = [tuple(g.shape) for g in got]
    log(f"[kernel] {c['name']} ({c['shape']}{f', {n32} words' if n32 else ''}): shapes "
        f"{shapes if len(shapes) <= 4 else f'{shapes[:2]} ... {shapes[-1]} ({len(shapes)} tensors)'} "
        f"max_abs_err {err} device-only {ms:.4f} ms single {single_ms:.4f} ms plain "
        f"{plain_ms:.4f} ms bound {bound:.4f} ms ({by}; {work}, {c['bytes']} bytes) "
        f"share {bound / ms:.3f}{floor}")
    if not exact:
        raise AssertionError(f"{c['name']}: kernel disagrees with its plain version")
    row = results.setdefault(c["name"], {
        "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": by, "library_ms": None, "single_ms": single_ms,
    })
    row["max_abs_err"] = max(row["max_abs_err"], err)


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
# phase 1b: fs_round, and the two sumcheck drivers
# ---------------------------------------------------------------------------

def phase_fs(info: dict, floor_ms: float) -> dict:
    """(a) fs_round against its plain version, exactly equal in every word it
    writes (sponge, s(t), r, pref), at each shape of
    bench_kernels.fs_cases and 8, 6 and 16 words, with its device-only time
    and Keccak-f permutations beside the launch floor, and each width's fit
    of time to permutations (bench_kernels.fit_permutations: the time a
    permutation, and of the rest of each shape); (b) fold and fold_round_eval with r on the card
    equal to their host-word forms at 2^20.  Returns fs_round's
    kernels-line row (its first case)."""
    import numpy as np
    import torch

    from zinc_tpu_torch.benches import bench_kernels as bk
    from zinc_tpu_torch.fields import montgomery as fm
    from zinc_tpu_torch.fields.montgomery import device_field
    from zinc_tpu_torch.sumcheck import kernels as sk
    from zinc_tpu_torch.sumcheck.device_fs import fs_round, fs_round_plain

    row = None
    for n32 in bk.FS_WORDS:
        ctx = device_field(bk.field_of_words(n32))
        fit = []
        for c in bk.fs_cases(ctx, "cuda"):
            got, want = c["inputs"](), c["inputs"]()
            fs_round(ctx, *got)
            fs_round_plain(ctx, *want)
            torch.cuda.synchronize()
            outs = [(g, w) for g, w in zip(got, want) if isinstance(g, torch.Tensor)]
            err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item())
                      for g, w in outs)
            exact = all(torch.equal(g, w) for g, w in outs)
            args = c["inputs"]()
            ms = bk.device_ms(lambda: fs_round(ctx, *args))
            plain_args = c["inputs"]()
            plain_ms = _time_ms(lambda: fs_round_plain(ctx, *plain_args), 3)
            bound, by = bk.bound_ms(n32, c["bytes"], c["full"], 0, info["max_sm_mhz"])
            fit.append((c["group"], c["permutations"], ms))
            log(f"[fs_round] {c['shape']}: max_abs_err {err} device-only {ms:.4f} ms, "
                f"{c['permutations']} permutations, plain {plain_ms:.4f} ms bound {bound:.6f} ms "
                f"({by}; {c['full']} products, {c['bytes']} bytes) launch floor {floor_ms:.4f} "
                f"ms, time / floor {ms / floor_ms:.2f}")
            if not exact:
                raise AssertionError(f"fs_round disagrees with its plain version: {c['shape']}")
            if row is None:
                row = {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by, "library_ms": None, "launch_floor_ms": floor_ms}
            row["max_abs_err"] = max(row["max_abs_err"], err)
        rest, per = bk.fit_permutations(fit)
        log(f"[fs_round fit] {n32} words: {per:.5f} ms a permutation; the rest by shape (ms): "
            + json.dumps({g: round(a, 5) for g, a in rest.items()}))

    ctx = device_field(bk.field_of_words(8))
    rng = np.random.default_rng(24)
    tabs = bk.random_residues(rng, ctx, (6, 1 << 20), "cuda")
    r = bk.random_residues(rng, ctx, (1,), "cpu")[0].numpy().view(np.uint32)
    r_dev = fm.to_tensor(r, "cuda")
    terms = [(0, 1, 2, 3, 5), (4, 5)]
    same_fold = torch.equal(sk.fold(ctx, tabs, r_dev), sk.fold(ctx, tabs, r))
    (f_dev, s_dev), (f_host, s_host) = (sk.fold_round_eval(ctx, tabs, x, terms, 6)
                                        for x in (r_dev, r))
    same_k10 = torch.equal(f_dev, f_host) and torch.equal(s_dev, s_host)
    log(f"[r on the card] 6 x 2^20, 8 words: fold equal to its host-word form: {same_fold}; "
        f"fold_round_eval (path A's terms, 6 points) equal: {same_k10}")
    if not (same_fold and same_k10):
        raise AssertionError("a kernel's r_dev form differs from its host-word form")
    return row


FS_SPLITS: list[dict] = []  # _fs_checked's times of each sumcheck's steps


def _recording(fn):
    """``fn`` with ``ZINC_TPU_TRACE`` set while it runs, so that the port
    records its spans' walls in ``zinc_tpu_torch.timing.STAGES``."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        was = os.environ.get("ZINC_TPU_TRACE")
        os.environ["ZINC_TPU_TRACE"] = "1"
        try:
            return fn(*args, **kwargs)
        finally:
            if was is None:
                del os.environ["ZINC_TPU_TRACE"]
            else:
                os.environ["ZINC_TPU_TRACE"] = was

    return run


def stages_through_host(mesh, device) -> bool:
    """True when a mesh over processes gathers the sumcheck's tensors on
    ``device`` through the host (``ProcessGroup.stages``)."""
    return mesh is not None and mesh.group is not None and mesh.group.stages(device)


def fs_fetches(rec: dict, staged: bool) -> int:
    """The host fetches a device-FS sumcheck (its SUMCHECKS record) owes:
    the one fetch, and where the group stages through the host, one staged
    copy for each sharded round's sums and one for the hand-over."""
    return 1 + (rec["sharded_rounds"] + 1 if staged else 0)


def _fs_checked(transcript, cfg, tables, nvars, degree, comb, eq_beta=None, mesh=None):
    """sumcheck.device_fs.prove_as_subprotocol_device_fs (with a ``mesh``:
    over its shards) with its enqueue loop under
    torch.cuda.set_sync_debug_mode("error"): any host sync in the loop
    raises (not checked where the mesh's gloo group stages the round's
    sums through the host).  Records in FS_SPLITS the host time of the
    start (sponge export, constants), of the enqueue loop, the wait for the
    device after it (a sync added for this split only) and of the finish
    (the one fetch and the host tail).  Returns finals like the per-round
    driver."""
    import torch

    from zinc_tpu_torch.sumcheck import device_fs
    from zinc_tpu_torch.sumcheck.executor import make_executor

    # a CPU rehearsal has no CUDA sync to catch, and a staged gather syncs
    cuda = tables.is_cuda and not stages_through_host(mesh, tables.device)
    t0 = time.perf_counter()
    ex = make_executor(cfg, tables, degree, comb, eq_beta, mesh)
    run = device_fs.start_fs(transcript, ex, nvars, degree)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    t1 = time.perf_counter()
    try:
        device_fs.enqueue_fs_rounds(run)
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode("default")
    t2 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    proof, randomness, mles = device_fs.finish_fs(transcript, run)
    t4 = time.perf_counter()
    FS_SPLITS.append({"start_ms": (t1 - t0) * 1e3, "enqueue_ms": (t2 - t1) * 1e3,
                      "device_wait_ms": (t3 - t2) * 1e3, "finish_ms": (t4 - t3) * 1e3})
    return proof, randomness, [m[0] for m in mles]


def _sync_cards() -> None:
    """Wait for every card's queued work (nothing where there is no card)."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def compare_drivers(label: str, fixture, turns: int = 2, device: str = "cuda", mesh=None) -> dict:
    """Spartan's two sumchecks of ``fixture`` (2^20 entries) through both
    drivers on the same device tables, from clones of one transcript, in
    turns (device FS, per-round, per-round, device FS, ...): equal proofs,
    r_y, v and transcript states; the wall of each driver call (sumcheck
    1 and 2 of each run), synced before and after so that it holds the
    call's device work and none queued before it, and each sumcheck's host
    fetches.  The device-FS runs enqueue under
    set_sync_debug_mode("error").  With a ``mesh`` (in one process or over
    several) both drivers are the sharded ones on its shards, the tables on
    its first device.  Returns the walls by driver."""
    import zinc_tpu_torch as zt
    from zinc_tpu_torch.fields.integers import int_vector
    from zinc_tpu_torch.ops.field_map import vector_to_field
    from zinc_tpu_torch.spartan_dev import DeviceStatement, spartan_prove_device
    from zinc_tpu_torch.sumcheck.device import prove_as_subprotocol_device
    from zinc_tpu_torch.sumcheck.executor import SUMCHECKS
    from zinc_tpu_torch.zinc import _z_vector

    ccs, statement, wit = fixture
    if mesh is not None:
        device = mesh.first
    staged = stages_through_host(mesh, device)
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, 1, 4)
    dstatement = DeviceStatement.upload(cfg, statement, device)
    z_f = vector_to_field(cfg, int_vector(_z_vector(statement, wit, ccs)), device)
    drivers = {"device_fs": _fs_checked, "per_round": prove_as_subprotocol_device}
    order = [name for i in range(turns) for name in
             (("device_fs", "per_round") if i % 2 == 0 else ("per_round", "device_fs"))]
    walls, results = {name: [] for name in drivers}, {}

    def synced(driver, w: list):
        def call(*args, **kwargs):
            _sync_cards()
            t0 = time.perf_counter()
            out = driver(*args, **kwargs)
            _sync_cards()
            w.append(time.perf_counter() - t0)
            return out

        return call

    for name in order:
        tt = t.clone()
        SUMCHECKS.clear()
        FS_SPLITS.clear()
        w: list[float] = []
        proof, r_y, v = spartan_prove_device(dstatement, z_f, ccs, tt, cfg, mesh,
                                             sumcheck=synced(drivers[name], w))
        if len(w) != 2:
            raise AssertionError(f"{label}: the {name} run called its driver {len(w)} times")
        walls[name].append(w)
        splits = "; device-FS steps (ms): " + json.dumps(
            [{k: round(v, 3) for k, v in sp.items()} for sp in FS_SPLITS]) if FS_SPLITS else ""
        log(f"[drivers] {label}, {name}: sumcheck 1 {w[0]:.4f} s, sumcheck 2 {w[1]:.4f} s "
            f"(synced driver calls); per sumcheck: {list(SUMCHECKS)}{splits}")
        if any(rec["driver"] != name for rec in SUMCHECKS) or len(SUMCHECKS) != 2:
            raise AssertionError(f"{label}: the {name} run recorded {list(SUMCHECKS)}")
        if name == "device_fs" and any(rec["fetches"] != fs_fetches(rec, staged)
                                       for rec in SUMCHECKS):
            raise AssertionError(f"{label}: a device-FS sumcheck fetched other than "
                                 f"{'once and its staged gathers' if staged else 'once'}")
        results.setdefault(name, (proof, r_y, v, tt.h.digest(), tt.get_challenge(cfg)))
    same = results["device_fs"] == results["per_round"]
    med = {name: [sorted(w[i] for w in ws)[len(ws) // 2] for i in (0, 1)]
           for name, ws in walls.items()}
    log(f"[drivers] {label}: proofs, r_y, v and transcript states equal under both drivers: "
        f"{same}; median sumcheck 1 / 2 over {turns} runs each (s): {json.dumps(med)}")
    if not same:
        raise AssertionError(f"{label}: the two drivers disagree")
    return walls


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


@_recording
def prove_verify_large(label: str, fixture, must: tuple, must_not: tuple, mesh=None) -> dict:
    """One prove (on the card, or on ``mesh``) and one verify on the card
    with the launch counts of that run, the stage walls, the proof size and
    the peak device memory; then the V_s[0] + 1 tamper, which must be
    rejected.  Returns the launches, the proof's sha256 and its roots."""
    import torch

    import zinc_tpu_torch as zt
    from zinc_tpu_torch.ops import _cuda
    from zinc_tpu_torch.sumcheck.executor import SUMCHECKS
    from zinc_tpu_torch.timing import STAGES

    ccs, statement, wit = fixture
    torch.cuda.reset_peak_memory_stats()
    STAGES.clear()
    SUMCHECKS.clear()
    _cuda.reset_launches()
    proof, cfg, (_, verifier), prove_s, verify_s = prove_verify(ccs, statement, wit, "cuda",
                                                                mesh=mesh)
    launches = dict(_cuda.LAUNCHES)
    log(f"[{label}] sumchecks: {list(SUMCHECKS)}")
    if [(r["driver"], r["fetches"]) for r in SUMCHECKS] != [("device_fs", 1)] * 2:
        raise AssertionError(f"{label}: not two device-FS sumchecks of one fetch each: "
                             f"{list(SUMCHECKS)}")
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


def _pinned(label: str, digest: str, want: str) -> None:
    if digest != want:
        raise AssertionError(f"{label}: proof hashes to {digest}, not {want}")
    log(f"[{label}] proof sha256 is the pinned {want[:8]}…")


def phase3(log_n: int) -> dict:
    ccs, statement, wit, _, _ = setup(1 << log_n, 5)
    res = prove_verify_large(f"2^{log_n}", (ccs, statement, wit),
                             *tree_kernels(R1CS_KERNELS, GENERIC_KERNELS, log_n))
    if log_n == 20:
        _pinned(f"2^{log_n}", res["sha256"], R1CS_SHA256_2P20)
    return res


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
    res = prove_verify_large(f"path A 2^{log_n}", degree4_fixture(1 << log_n, 5),
                             *tree_kernels(PATH_A_KERNELS, ("round_eval_gruen",), log_n))
    if log_n == 20:
        _pinned(f"path A 2^{log_n}", res["sha256"], PATH_A_SHA256_2P20)
    return res["launches"]


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
    check_launches(launches, PATH_B_KERNELS,
                   ("mont_mul", "round_eval", "round_eval_gruen", "fs_round"), "path B")
    return launches


def _prove_on_mesh(label: str, fixture, mesh) -> dict:
    """One prove on ``mesh`` (no verify): its wall, sha256 and roots."""
    import zinc_tpu_torch as zt
    from zinc_tpu_torch.sumcheck.executor import SUMCHECKS

    ccs, statement, wit = fixture
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, 1, 4)
    t0 = time.perf_counter()
    proof = zt.ZincProver(zt.ZipTypes(1), mesh=mesh).prove(statement, wit, t, ccs, cfg)
    wall = time.perf_counter() - t0
    digest = hashlib.sha256(zt.serialize_proof(proof, cfg)).hexdigest()
    log(f"[{label}] prove {wall:.3f} s, proof sha256 {digest}, {mesh.stats}, sumchecks "
        f"{list(SUMCHECKS)[-2:]}")
    return {"sha256": digest, "roots": proof.zip_proof.z_comm.roots}


def check_sharded(label: str, mesh, log_n: int, commit: str) -> None:
    """Both sumchecks ran their rounds down to HOST_TAIL entries a shard on
    the shards, and the commit ran in the layout ``commit``."""
    from zinc_tpu_torch.sumcheck.executor import HOST_TAIL, SUMCHECKS

    d = mesh.size
    want = 0 if (1 << log_n) % d else log_n - (d.bit_length() - 1) - (HOST_TAIL.bit_length() - 1)
    rounds = [r["sharded_rounds"] for r in list(SUMCHECKS)[-2:]]
    log(f"[{label}] sharded rounds per sumcheck {rounds} of {log_n} (want {want} each); "
        f"commit {mesh.stats.get('commit')}")
    if rounds != [want, want] or mesh.stats.get("commit") != [commit]:
        raise AssertionError(f"{label}: the mesh was not used as expected: {rounds}, "
                             f"{mesh.stats}")


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
    from zinc_tpu_torch.parallel import Mesh

    card = torch.device(card)
    ccs, statement, wit, _, _ = setup(1 << log_n, 5)
    mesh = Mesh([card] * 4)
    label = f"mesh 4 x {card} 2^{log_n}"
    a = prove_verify_large(label, (ccs, statement, wit),
                           *tree_kernels(R1CS_KERNELS, GENERIC_KERNELS, log_n), mesh=mesh)
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

    mesh_of_cards(log_n, single, (ccs, statement, wit))
    return a["launches"]


def mesh_of_cards(log_n: int, single: dict, fixture) -> None:
    """Phase 7(d): where there are two cards or more, the 2^log_n R1CS
    (``fixture``) on ``local_mesh()`` over every card, its proof
    ``single``'s, verified, the tamper rejected."""
    import torch

    from zinc_tpu_torch.parallel import local_mesh

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"[mesh of cards] (d) not run: torch.cuda.device_count() is {n_cards}, and a mesh of "
            f"separate cards needs two or more")
        return
    cards = local_mesh()
    label = f"mesh of {n_cards} cards 2^{log_n}"
    d = prove_verify_large(label, fixture, *tree_kernels(R1CS_KERNELS, GENERIC_KERNELS, log_n),
                           mesh=cards)
    even = n_cards & (n_cards - 1) == 0  # splits the rows and the hypercube
    check_sharded(label, cards, log_n, f"{n_cards} row blocks" if even else "one device")
    if d["sha256"] != single["sha256"]:
        raise AssertionError(f"{label}: proof differs from the single-device proof")


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


@_recording
def rank_main(argv: list[str]) -> int:
    """One rank of phase 9 (``chip_smoke.py --rank R ...``): join the group;
    run Spartan's two sumchecks of the 2^log_n R1CS (seed 5) under both
    sharded drivers on ``hierarchical_mesh`` over the ranks
    (compare_drivers: equal proofs and transcripts; the device-FS enqueue
    loop under sync debug "error" where the group does not stage through
    the host, so under NCCL the process's first collective falls inside a
    checked loop); then prove it on that mesh and print the result as one
    ``[rank-result]`` JSON line; rank 0 also verifies the proof and checks
    that the V_s[0] + 1 tamper is rejected."""
    import argparse

    import torch
    import torch.distributed as dist

    import zinc_tpu_torch as zt
    from zinc_tpu_torch.ops import _cuda
    from zinc_tpu_torch.parallel import hierarchical_mesh, init_distributed
    from zinc_tpu_torch.sumcheck.executor import SUMCHECKS
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
    on_card = dev.type == "cuda"
    group = mesh.group
    driver_walls = compare_drivers(f"rank {args.rank}", (ccs, statement, wit), mesh=mesh)
    mesh.stats.clear()
    group.calls = group.bytes = group.staged = 0
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    STAGES.clear()
    SUMCHECKS.clear()
    _cuda.reset_launches()
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, ztypes.n_words, 4)
    t0 = time.perf_counter()
    proof = zt.ZincProver(ztypes, mesh=mesh).prove(statement, wit, t, ccs, cfg)
    prove_s = time.perf_counter() - t0
    res = {
        "rank": args.rank, "backend": group.backend, "mesh": repr(mesh), "shards": mesh.size,
        "sha256": hashlib.sha256(zt.serialize_proof(proof, cfg)).hexdigest(),
        "transcript": t.h.digest().hex(),
        "prove_s": prove_s, "walls": {k: round(v, 4) for k, v in STAGES.items()},
        "launches": dict(_cuda.LAUNCHES), "stats": mesh.stats, "sumchecks": list(SUMCHECKS),
        "staged": stages_through_host(mesh, dev),
        "collective_calls": group.calls, "collective_bytes": group.bytes,
        "staged_copies": group.staged, "driver_walls": driver_walls, "on_card": on_card,
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


def check_ranks(label: str, results: list[dict], single: dict, log_n: int, commit: str,
                columns: int) -> None:
    """Every rank's proof hashes to ``single``'s sha256 and every rank's
    transcript ends in the same state, rank 0 verified the proof and saw
    the tamper rejected, both sumchecks ran the device-FS driver sharded
    down to HOST_TAIL entries a shard, with one fetch each and (where the
    group stages through the host) a staged copy for each sharded round
    and the hand-over, the commit ran in ``commit`` (its rows split over
    ``columns`` devices of a rank), and (on the card) every kernel of the
    R1CS path launched on every rank, fs_round once a device round and
    blake3_merge as commit_merges plans it."""
    from zinc_tpu_torch.sumcheck.executor import HOST_TAIL

    shards = results[0]["shards"]
    want = log_n - (shards.bit_length() - 1) - (HOST_TAIL.bit_length() - 1)
    for res in results:
        who = f"[{label}] rank {res['rank']}"
        log(f"{who} ({res['backend']}): prove {res['prove_s']:.3f} s, sha256 "
            f"{res['sha256']}, collectives {res['collective_calls']} all-gathers, "
            f"{res['collective_bytes']} bytes in from the other ranks, {res['staged_copies']} "
            f"staged through the host, peak device memory "
            f"{res['peak_gib'] if res['peak_gib'] is None else round(res['peak_gib'], 3)} GiB, "
            f"{res['stats']}")
        log(f"{who} stage walls (s): {json.dumps(res['walls'])}")
        log(f"{who} sumchecks: {res['sumchecks']}")
        log(f"{who} launches: {res['launches']}")
        log(f"{who} sumcheck 1 / 2 by driver, synced calls (s): "
            f"{json.dumps(res['driver_walls'])}")
        if res["sha256"] != single["sha256"]:
            raise AssertionError(f"{who}'s proof differs from phase 3's")
        if res["transcript"] != results[0]["transcript"]:
            raise AssertionError(f"{who}'s transcript differs from rank 0's")
        recs = res["sumchecks"]
        if res["stats"] != {"commit": [commit]} or [r["sharded_rounds"] for r in recs] != [want] * 2:
            raise AssertionError(f"{who}: the mesh was not used as expected: {res['stats']}, {recs}")
        if ([r["driver"] for r in recs] != ["device_fs"] * 2
                or any(r["fetches"] != fs_fetches(r, res["staged"]) for r in recs)):
            raise AssertionError(f"{who}: not two device-FS sumchecks of the owed fetches: {recs}")
        if not res["staged"] and res["staged_copies"]:
            raise AssertionError(f"{who}: {res['staged_copies']} gathers went through the host")
        if res["on_card"]:
            check_launches(res["launches"], *tree_kernels(R1CS_KERNELS, GENERIC_KERNELS, log_n,
                                                          columns), who)
            if res["launches"]["blake3_merge"] != commit_merges(log_n, columns):
                raise AssertionError(f"{who}: blake3_merge launched {res['launches']['blake3_merge']} "
                                     f"times, not {commit_merges(log_n, columns)}")
            if res["launches"]["fs_round"] != sum(r["device_rounds"] for r in recs):
                raise AssertionError(f"{who}: fs_round launched {res['launches']['fs_round']} "
                                     f"times for {[r['device_rounds'] for r in recs]} rounds")
    log(f"[{label}] rank 0 verified in {results[0]['verify_s']:.3f} s, {results[0]['tamper']}; "
        f"every rank's proof is phase 3's")


def phase9(single: dict, log_n: int = 20, devices: str = "cuda:0,cuda:0") -> list[dict]:
    """A mesh over two processes, each rank on the device-FS driver
    (check_ranks): (a) two ranks on this one card, each with the local
    devices ``devices`` on ``hierarchical_mesh(2, 2)``, over gloo (NCCL
    refuses two ranks on one card), which stages the round's sums through
    the host: the 2^log_n R1CS (seed 5) hashes to phase 3's sha256 on both
    ranks, rank 0 verifies it and rejects the tamper, 12 of 20 rounds of
    each sumcheck run on the 4 shards and the commit in 2 row blocks x 2
    column blocks; (b) with two cards or more, one rank per card over
    NCCL, the round's sums gathered card to card: one fetch a sumcheck,
    and the enqueue loops clean under sync debug "error".  Returns each
    rank's launches."""
    results = run_ranks("2 processes", log_n, devices, "gloo")
    check_ranks("2 processes", results, single, log_n, "2 row blocks x 2 column blocks", 2)
    return [r["launches"] for r in results] + nccl_ranks(single, log_n)


def nccl_ranks(single: dict, log_n: int) -> list[dict]:
    """Phase 9(b): where there are two cards or more, two ranks over NCCL,
    one a card (check_ranks); returns each rank's launches."""
    import torch

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        log(f"[2 processes, NCCL] not run: torch.cuda.device_count() is {n_cards}, and one rank "
            f"per card needs two cards or more")
        return []
    results = run_ranks("2 processes, NCCL", log_n, "own", "nccl")
    check_ranks("2 processes, NCCL", results, single, log_n, "2 row blocks x 1 column blocks", 1)
    log("[2 processes, NCCL] no byte of a round's sums reached the host before a sumcheck's "
        "one fetch, and each rank's first collective (NCCL's communicator started by "
        "init_process_group) ran inside a device-FS enqueue loop under sync debug \"error\"")
    return [r["launches"] for r in results]


# ---------------------------------------------------------------------------
# phase 10: the bench mirrors
# ---------------------------------------------------------------------------

ZIP_STAGES = ("encode_rows", "merkle_root", "commit_no_merkle", "commit", "open", "verify",
              "proof_bytes")


def bench_runs(device: str, round_log_n: int = 20, field_log_n: int = 20,
               sizes=(12, 14, 16)) -> list[tuple[str, list[str], list[str]]]:
    """(mirror, arguments, the metric names it owes) of each bench mirror:
    the JAX benches' names at these sizes (tests/test_torch_coverage.py holds
    them to the JAX benches' sources); K1's row, on the card only, says
    ``cuda`` where the JAX one says ``pallas``."""
    k1 = ("mont_mul_cuda",) if device.startswith("cuda") else ()
    return [
        ("bench_round", [str(round_log_n), device], ["spartan_sumcheck_round_2p20_256bit"]),
        ("bench_field", [str(field_log_n), device],
         [f"host_fp_{op}_128bit" for op in ("mul", "add", "div", "neg")]
         + [f"device_{op}_2p{field_log_n}" for op in ("mont_add", "mont_mul") + k1]),
        ("bench_prime", [], ["prime_gen_256bit"]),
        ("bench_spartan", [*map(str, sizes), device],
         [f"spartan_{what}_2p{n}" for n in sizes for what in ("prove", "verify")]),
        ("bench_zip", [*map(str, sizes), device],
         [f"zip_{stage}_2p{n}" for n in sizes for stage in ZIP_STAGES]),
    ]


def phase10(device: str = "cuda", **sizes) -> None:
    """Each bench mirror through its ``main`` (which prints the device line
    and its JSON lines); each must print every metric it owes, and
    bench_round's round (held equal to its plain versions inside the bench)
    must have launched K2 and K4 on the card."""
    import importlib

    for name, argv, owed in bench_runs(device, **sizes):
        mod = importlib.import_module(f"zinc_tpu_torch.benches.{name}")
        t0 = time.perf_counter()
        records = mod.main([name, *argv])
        missing = sorted(set(owed) - {r["metric"] for r in records})
        log(f"[bench] {name} {' '.join(argv)}: {len(records)} metric lines in "
            f"{time.perf_counter() - t0:.1f} s")
        if missing:
            raise AssertionError(f"{name} did not print {missing}")
        if name == "bench_round":
            rec = records[0]
            log(f"[bench_round] launches of the checked and timed rounds {rec['launches']}")
            if device.startswith("cuda") and not (rec["launches"].get("fold")
                                                  and rec["launches"].get("round_eval_gruen")):
                raise AssertionError(f"bench_round launched {rec['launches']}, not fold and "
                                     "round_eval_gruen")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is false")

    info = phase0()
    _, _, _, _, cfg8 = setup(1 << 10, 1234)  # any field of the main path's width
    _, _, _, _, cfg6 = setup(*N64_3_CASE, 3)
    kernels = phase1(cfg8, cfg6, info)
    kernels["fs_round"] = phase_fs(info, kernels.pop("_launch_floor_ms"))
    phase2("cuda")
    single = phase3(20)
    for log_n in (12, 14, 16):
        compare_drivers(f"R1CS 2^{log_n}", setup(1 << log_n, 5)[:3])
    compare_drivers("R1CS 2^20", setup(1 << 20, 5)[:3], turns=4)
    compare_drivers("path A 2^20", degree4_fixture(1 << 20, 5))
    runs = [single["launches"], phase5(20), phase6(20), phase7(20, single)]
    runs += phase8()
    runs += phase9(single)
    phase10()
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


def cards_2p22(log_n: int = 22) -> None:
    """The 2^log_n R1CS (seed 5) proved and verified on one card, then on
    ``local_mesh()`` over every card (phase 7(d) at this size: the same
    bytes, the sharded rounds and row blocks), the tamper rejected on each;
    the one card's proof hashes to R1CS_SHA256_2P22."""
    fixture = setup(1 << log_n, 5)[:3]
    one = prove_verify_large(f"2^{log_n}", fixture,
                             *tree_kernels(R1CS_KERNELS, GENERIC_KERNELS, log_n))
    mesh_of_cards(log_n, one, fixture)
    log(f"[mesh of cards 2^{log_n}] proof identical to the one card's")
    _pinned(f"2^{log_n}", one["sha256"], R1CS_SHA256_2P22)


def cards_main() -> int:
    """``--cards``: only what needs two cards or more, phase 7(d) and
    phase 9(b), each held to the pinned 2^20 proof (R1CS_SHA256_2P20, which
    phase 3 checks on one card), then the 2^22 R1CS on one card and on
    ``local_mesh()`` (:func:`cards_2p22`)."""
    import torch

    from zinc_tpu_torch.ops import _cuda

    if torch.cuda.device_count() < 2:
        raise SystemExit("chip_smoke.py --cards needs two cards or more")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True).stdout.strip())
    _cuda.build(BUILD_WIDTHS + (_cuda.BLAKE3,))
    single = {"sha256": R1CS_SHA256_2P20}
    mesh_of_cards(20, single, setup(1 << 20, 5)[:3])
    nccl_ranks(single, 20)
    cards_2p22()
    log("[cards] phase 7(d), 9(b) and the 2^22 mesh passed")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        sys.exit(rank_main(sys.argv[1:]))
    sys.exit(cards_main() if sys.argv[1:] == ["--cards"] else main())
