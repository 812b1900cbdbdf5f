"""Device-only times of the port's kernels at the shapes its paths give them.

    python3 zinc_tpu_torch/benches/bench_kernels.py [--root DIR]

Each case times 20 back-to-back calls of a kernel's wrapper between two
CUDA events, after one warm-up call, and divides by 20; a
sleeping kernel holds the stream while the host queues the calls, so the
number is the device's alone (:func:`device_ms`).  Beside each time stands
its bound, the least time the card could take for the same work: the larger
of the bytes the call must move (each input read once, each output written
once) over 3.35 TB/s, and its integer multiply-add slots over 132 SMs × 64
slots a clock × the SM clock (``nvidia-smi`` clocks.max.sm).  A Montgomery
product of N-word residues takes 2N² + N 32×32→64-bit multiply-adds of two
slots each, 4N² + 2N; a product summed unreduced (a term's last factor:
the round sums are only needed mod q) takes the N² of the product alone,
2N².  Every round kernel is held to the same count of products, the least
its round needs (:func:`round_products`), whatever its own scheme forms.
The BLAKE3 kernels form no product: their bound counts a compression's
integer instructions at their fewest, per pipe.  Its xors and rotations
(``COMPRESS_ALU``) have only the ALU pipe, 64 lanes a clock an SM; its adds
may also issue as IMAD on the FMA pipe, so all its instructions
(``COMPRESS_OPS``) share the SM's issue rate, 128 lanes a clock.

A call so small that its launches bound it (the eq table, fs_round, path
B's last fold) also reports its launches, counted in ``_cuda.LAUNCHES``
over one call (:func:`launches_of`), times the launch floor.  fs_round's
cases carry their Keccak-f permutations (:func:`fs_permutations`), and
each width's times are fitted to them (:func:`fit_permutations`: the time
a permutation, and of the rest of each shape); the host wall of one 2^20
``eq_levels`` call is timed with a sync after it (:func:`eq_host_ms`).

``--root`` times the kernels of another checkout of the port with the same
cases (its ``zinc_tpu_torch`` is imported instead of this one's; the cases
call only wrappers every checkout since the eq kernels has, and the Merkle
cases follow that checkout's plan of launches: :func:`tree_plan`), so that two
versions can be compared in one call on one card.  The field is q = 2^255
+ 95 (n64 = 4), and 2^(32·n32 − 1) plus a small offset at the other widths
(:func:`field_of_words`), the tables random residues from a seed.  Prints
the card, then one JSON line per case.  ``chip_smoke.py`` takes its cases,
its timer and its bounds from here.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
SMS = 132
IMAD_SLOTS_PER_CLOCK = 64  # per SM, compute capability 9.0
ALU_LANES_PER_CLOCK = 64  # per SM: logic ops, shifts and permutes
SM_LANES_PER_CLOCK = 128  # per SM: 4 warp instructions a clock, on the ALU and FMA pipes
# one BLAKE3 compression (csrc/blake3.cu): 56 G steps of 4 xors and 4
# rotations (ALU only) and 2 three-input adds and 2 adds, and the 8 xors of
# the output
COMPRESS_ALU = 56 * 8 + 8
COMPRESS_OPS = 56 * 12 + 8


def smi_row(device, query: str, units: bool = True) -> str:
    """The torch device's row of ``nvidia-smi --query-gpu=<query>``, chosen
    by the card's UUID: nvidia-smi lists every card of the host, whatever
    ``CUDA_VISIBLE_DEVICES`` hides, so a list position may name another."""
    import torch

    uuid = torch.cuda.get_device_properties(torch.device(device)).uuid
    return subprocess.run(
        ["nvidia-smi", f"--id=GPU-{uuid}", f"--query-gpu={query}",
         "--format=csv,noheader" + ("" if units else ",nounits")],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def card(device="cuda") -> dict:
    """Name, power limit and maximum SM clock of the torch device's card
    (nvidia-smi)."""
    out = smi_row(device, "name,power.limit,clocks.max.sm", units=False)
    name, power, clock = (x.strip() for x in out.split(","))
    return {"name": name, "power_limit_w": float(power), "max_sm_mhz": float(clock)}


def bound_ms(n32: int, n_bytes: int, full: int, lazy: int, max_sm_mhz: float,
             int_ops: tuple[int, int] = (0, 0)) -> tuple[float, str]:
    """(bound in ms, "bytes" or "operations") of a call that moves n_bytes and
    forms ``full`` Montgomery products and ``lazy`` unreduced ones, or does
    ``int_ops`` = (ALU-only, all) other 32-bit integer instructions: the
    slowest of the bytes, the products' IMAD slots, the ALU pipe and the
    issue rate."""
    clock = SMS * max_sm_mhz * 1e6 / 1e3  # SM clocks a ms
    mem = n_bytes / HBM_BYTES_PER_S * 1e3
    alu, every = int_ops
    ops = max((full * (4 * n32 * n32 + 2 * n32) + lazy * 2 * n32 * n32)
              / (IMAD_SLOTS_PER_CLOCK * clock),
              alu / (ALU_LANES_PER_CLOCK * clock), every / (SM_LANES_PER_CLOCK * clock))
    return (mem, "bytes") if mem >= ops else (ops, "operations")


HOLD_CYCLES = 100_000_000  # ≈ 50 ms of the card's clock


def device_ms(fn, calls: int = 20) -> float:
    """CUDA events around ``calls`` back-to-back calls, over ``calls``.  The
    stream is first held by a sleeping kernel (``HOLD_CYCLES``), so that the
    host has queued every call before the first one runs: the events then
    bracket device work only, not the wrappers' host side.  Raises if the
    host took longer to queue the calls than the hold lasted."""
    import time

    import torch

    fn()  # warm-up (and the build, for a width's first kernel)
    torch.cuda.synchronize()
    hold, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    hold.record()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    if host_ms >= hold.elapsed_time(start):
        raise RuntimeError(f"queueing {calls} calls took {host_ms:.1f} ms, longer than the hold")
    return start.elapsed_time(end) / calls


def launch_floor_ms() -> float:
    """Device-only time of an empty launch (``torch.cuda._sleep(0)``, a
    kernel that returns at once), timed as :func:`device_ms` times a kernel:
    no launch on this card takes less, so a call this small is bound by it."""
    import torch

    return device_ms(lambda: torch.cuda._sleep(0))


def random_residues(rng, ctx, shape, device):
    """Uniform-ish residues < q: random words with the top word below q's."""
    import numpy as np

    from zinc_tpu_torch.fields import montgomery as fm

    words = rng.integers(0, 1 << 32, size=shape + (ctx.n32,), dtype=np.uint64).astype(np.uint32)
    words[..., -1] = rng.integers(0, int(ctx.q[-1]), size=shape, dtype=np.uint64).astype(np.uint32)
    return fm.to_tensor(words, device)


def round_products(pairs: int, terms, n_pts: int, gruen: bool = False) -> tuple[int, int]:
    """(Montgomery, unreduced) products that a round evaluation needs, one
    rule for every round kernel: a term of k factors is a polynomial of
    degree k in t, so min(k + 1, n_pts) evaluations fix it, each with k − 2
    Montgomery products and one unreduced product for the last factor (the
    sums are only needed mod q).  With an eq weight E (K4) a term of k ≥ 2
    factors first takes E into its first factor's two entries (two more
    Montgomery products a pair), and a term of one factor is multiplied by E
    unreduced; a term of one factor without E needs no product."""
    full = lazy = 0
    for t in terms:
        k, pts = len(t), min(len(t) + 1, n_pts)
        if k == 1:
            lazy += pts if gruen else 0
            continue
        lazy += pts
        full += pts * (k - 2) + (2 if gruen else 0)
    return pairs * full, pairs * lazy


def cases(ctx, device, log_n: int = 20, seed: int = 20) -> list[dict]:
    """The kernels' calls at the paths' shapes, 2^log_n entries a table:
    dicts of kernel name, shape label, ``kernel`` and ``plain`` (argument-free
    calls), Montgomery and unreduced products (``full``, ``lazy``,
    :func:`round_products`) and bytes moved.  The first case of each kernel
    is the one its kernels-line row reports.  ``launch_bound`` marks the
    case so small that the launch floor (:func:`launch_floor_ms`) times its
    launches (:func:`launches_of`), not its bytes, bounds it: path B's last
    fold, K6's shape, and the eq tables (:func:`eq_cases`, the last two)."""
    import numpy as np

    from zinc_tpu_torch.fields import montgomery as fm
    from zinc_tpu_torch.ops import field_kernels as fk
    from zinc_tpu_torch.sumcheck import kernels as sk

    rng = np.random.default_rng(seed)
    n = 1 << log_n
    h = n // 2
    eb = 4 * ctx.n32  # bytes of a residue
    a = random_residues(rng, ctx, (n,), device)
    b = random_residues(rng, ctx, (n,), device)
    sc1 = random_residues(rng, ctx, (3, n), device)  # Mz tables of sumcheck 1 (Gruen)
    sc2 = random_residues(rng, ctx, (2, n), device)  # (γ-table, z) of sumcheck 2
    e_lvl = random_residues(rng, ctx, (h,), device)  # suffix-eq level of round 1
    r = random_residues(rng, ctx, (1,), "cpu")[0].numpy().view(np.uint32)
    r_dev = fm.to_tensor(r, device)  # the same r on the device (device-resident Fiat-Shamir)
    sc7 = random_residues(rng, ctx, (7, n), device)  # path B's 7 factors
    sc6 = random_residues(rng, ctx, (6, n), device)  # path A's 5 Mz tables + eq
    tail7 = sc7[:, :128].contiguous()  # path B's last device fold (2·HOST_TAIL entries)
    gruen_terms, classic_terms = [(0, 1), (2,)], [(0, 1)]
    t7, t_a = [tuple(range(7))], [(0, 1, 2, 3, 5), (4, 5)]
    sz = f"2^{log_n}"

    case = _case

    def folded_round(n_fold, terms, n_pts):
        # K10: one Montgomery product per folded entry, then the round
        full, lazy = round_products(h // 2, terms, n_pts)
        return n_fold + full, lazy

    return [
        case("mont_mul", sz, lambda: fk.mont_mul(ctx, a, b), lambda: fk.mont_mul_plain(ctx, a, b),
             n, 3 * n * eb),
        case("fold", f"3 x {sz}", lambda: sk.fold(ctx, sc1, r), lambda: sk.fold_plain(ctx, sc1, r),
             3 * h, 3 * (n + h) * eb),
        case("round_eval", f"2 x {sz}, 1 term, 3 points",
             lambda: sk.round_eval(ctx, sc2, classic_terms, 3),
             lambda: sk.round_eval_plain(ctx, sc2, classic_terms, 3),
             round_products(h, classic_terms, 3), 2 * n * eb),
        case("round_eval_gruen", f"3 x {sz} + E, 2 terms, 4 points",
             lambda: sk.round_eval_gruen(ctx, sc1, e_lvl, gruen_terms, 4),
             lambda: sk.round_eval_gruen_plain(ctx, sc1, e_lvl, gruen_terms, 4),
             round_products(h, gruen_terms, 4, gruen=True), (3 * n + h) * eb),
        case("round_eval_generic", f"path B: 7 x {sz}, 1 term of 7, 8 points",
             lambda: sk.round_eval_generic(ctx, sc7, t7, 8),
             lambda: sk.round_eval_generic_plain(ctx, sc7, t7, 8),
             round_products(h, t7, 8), 7 * n * eb),
        case("round_eval_generic", f"path A: 6 x {sz}, terms of 5 and 2, 6 points",
             lambda: sk.round_eval_generic(ctx, sc6, t_a, 6),
             lambda: sk.round_eval_generic_plain(ctx, sc6, t_a, 6),
             round_products(h, t_a, 6), 6 * n * eb),
        case("fold_round_eval", f"path A: 6 x {sz} -> 2^{log_n - 1}, terms of 5 and 2, 6 points",
             lambda: sk.fold_round_eval(ctx, sc6, r, t_a, 6),
             lambda: sk.fold_round_eval_plain(ctx, sc6, r, t_a, 6),
             folded_round(6 * h, t_a, 6), 6 * (n + h) * eb),
        case("fold_round_eval", f"path B: 7 x {sz} -> 2^{log_n - 1}, 1 term of 7, 8 points",
             lambda: sk.fold_round_eval(ctx, sc7, r, t7, 8),
             lambda: sk.fold_round_eval_plain(ctx, sc7, r, t7, 8),
             folded_round(7 * h, t7, 8), 7 * (n + h) * eb),
        case("fold", "path B's last: 7 x 128 -> 64", lambda: sk.fold(ctx, tail7, r),
             lambda: sk.fold_plain(ctx, tail7, r), 7 * 64, 7 * (128 + 64) * eb, launch_bound=True),
        # the r_dev forms, held against the host-word forms' plain versions
        case("fold", f"3 x {sz}, r on the device", lambda: sk.fold(ctx, sc1, r_dev),
             lambda: sk.fold_plain(ctx, sc1, r), 3 * h, 3 * (n + h) * eb),
        case("fold_round_eval", f"path A: 6 x {sz} -> 2^{log_n - 1}, r on the device",
             lambda: sk.fold_round_eval(ctx, sc6, r_dev, t_a, 6),
             lambda: sk.fold_round_eval_plain(ctx, sc6, r, t_a, 6),
             folded_round(6 * h, t_a, 6), 6 * (n + h) * eb),
    ] + eq_cases(ctx, device, log_n)


def _case(name, shape, kernel, plain, products, n_bytes, launch_bound=False, int_ops=(0, 0)):
    full, lazy = products if isinstance(products, tuple) else (products, 0)
    return {"name": name, "shape": shape, "kernel": kernel, "plain": plain, "full": full,
            "lazy": lazy, "bytes": n_bytes, "launch_bound": launch_bound, "int_ops": int_ops}


def launches_of(fn) -> int:
    """The kernel launches one call of ``fn`` makes (``_cuda.LAUNCHES``,
    every kernel), whatever the checkout's design: the launch floor bounds a
    small call by its launches."""
    from zinc_tpu_torch.ops import _cuda

    before = sum(_cuda.LAUNCHES.values())
    fn()
    return sum(_cuda.LAUNCHES.values()) - before


def eq_cases(ctx, device, log_n: int = 20, seed: int = 25) -> list[dict]:
    """The eq table of a random point of log_n variables: all its levels, as
    the executor's Gruen levels build it (``poly/device.eq_levels``), and its
    level 0 alone, as Spartan's, the open's and the verifier's tables take it
    (``_eq_table_device``).  Either needs 2^log_n − 1 Montgomery products
    (one a pair of entries, the other entry a subtraction); its bytes are
    the point read once and every level it returns written once:
    2^(log_n+1) − 1 residues for all levels, 2^log_n for level 0.  Both
    calls exist in every checkout since the eq kernels were ported, so
    ``--root`` times an older one with the same cases."""
    import numpy as np

    from zinc_tpu_torch.poly.device import _eq_table_device, eq_levels, eq_levels_plain

    r = random_residues(np.random.default_rng(seed), ctx, (log_n,), device)
    n, eb = 1 << log_n, 4 * ctx.n32
    return [
        _case("eq_table", f"2^{log_n} eq table, all {log_n + 1} levels",
              lambda: eq_levels(ctx, r), lambda: eq_levels_plain(ctx, r),
              n - 1, (log_n + 2 * n - 1) * eb, launch_bound=True),
        _case("eq_table", f"2^{log_n} eq table, level 0 only",
              lambda: _eq_table_device(ctx, r), lambda: eq_levels_plain(ctx, r)[0],
              n - 1, (log_n + n) * eb, launch_bound=True),
    ]


def tree_plan(b3, n: int) -> tuple[int, list[int]]:
    """``b3.tree_plan(n)`` (``ops/blake3.py``), or for a checkout from before
    it the plan its ``merkle_tree_device`` followed: the leaves launch's
    levels, then merge launches of up to ``MERGE_LEVELS`` levels."""
    if hasattr(b3, "tree_plan"):
        return b3.tree_plan(n)
    depth = n.bit_length() - 1
    leaf = min(b3.LEAF_LEVELS, depth)
    return leaf, [min(b3.MERGE_LEVELS, depth - i) for i in range(leaf, depth, b3.MERGE_LEVELS)]


def merkle_cases(device, rows: int = 1024, n: int = 2048, k_words: int = 4, seed: int = 26,
                 deep: tuple[int, int] = (64, 1 << 14)) -> list[dict]:
    """The BLAKE3 kernels at the main path's commit (the 2^20 R1CS: 1024 rows
    of 2048 codewords of 8 canonical u32 words in int64 lanes, as
    ``zip/device.py:encode_rows`` gives them), launched as the checkout's
    :func:`tree_plan` plans the tree: the leaves launch with every level it
    merges (the whole tree, where a cluster covers the row), the leaves
    launch of ``LOG_BLOCK`` levels (no cluster), the merge launch of a row
    deeper than a cluster (``deep`` = rows, codewords: 64 rows of 2^14,
    the levels left after its leaves launch), a merge launch of 9 levels
    over the leaves, and the whole tree.  Bytes: the codeword words read
    once, every digest written once (8 int64 lanes a node) and a merge's
    input level read once.  Instructions: each compression's
    (``COMPRESS_ALU``, ``COMPRESS_OPS``) and a leaf's byte swaps, one
    permute a word, counted in both."""
    import numpy as np
    import torch

    from zinc_tpu_torch.ops import blake3 as b3

    rng = np.random.default_rng(seed)

    def words(r, m):
        return torch.from_numpy(rng.integers(0, 1 << 32, size=(r, m, 2 * k_words),
                                             dtype=np.int64)).to(device)

    enc = words(rows, n)
    leaves = rows * n
    depth = n.bit_length() - 1
    leaf, merges = tree_plan(b3, n)
    full_tree = b3.hash_leaves_plain(enc, k_words, 0)[0]
    d_rows, d_n = deep
    d_leaf, d_merges = tree_plan(b3, d_n)
    top = b3.hash_leaves_plain(words(d_rows, d_n), k_words, d_leaf)[-1]  # the merge launch's input
    d_count = d_merges[0]

    def nodes(r, m, first, count):  # nodes of levels first+1 .. first+count of r rows of m leaves
        return sum(r * (m >> lvl) for lvl in range(first + 1, first + count + 1))

    digest, word_ops = 64, 2 * k_words  # bytes of a node; a leaf's byte swaps

    def instructions(compressions, leaves=0):  # (ALU-only, all)
        return (compressions * COMPRESS_ALU + leaves * word_ops,
                compressions * COMPRESS_OPS + leaves * word_ops)

    def leaves_case(lv, label):
        m = nodes(rows, n, 0, lv)
        return _case("blake3_leaves", f"{rows} x {n} x {2 * k_words} words (int64), leaves + {lv} "
                     f"levels{label}",
                     lambda: b3.hash_leaves(enc, k_words, lv),
                     lambda: b3.hash_leaves_plain(enc, k_words, lv), 0,
                     enc.numel() * 8 + (leaves + m) * digest,
                     int_ops=instructions(leaves + m, leaves))

    m_top = nodes(d_rows, top.shape[1], 0, d_count)
    m_wide = nodes(rows, n, 0, b3.MERGE_LEVELS)
    return [
        leaves_case(leaf, " (the whole tree)" if not merges else ""),
        leaves_case(b3.LOG_BLOCK, ", no cluster"),
        _case("blake3_merge", f"{d_rows} x {top.shape[1]} digests, {d_count} levels (rows of "
              f"{d_n} codewords)",
              lambda: b3.merge_levels(top, d_count),
              lambda: b3.merge_levels_plain(top, d_count), 0,
              (top.shape[0] * top.shape[1] + m_top) * digest, launch_bound=True,
              int_ops=instructions(m_top)),
        _case("blake3_merge", f"{rows} x {n} digests, {b3.MERGE_LEVELS} levels",
              lambda: b3.merge_levels(full_tree, b3.MERGE_LEVELS),
              lambda: b3.merge_levels_plain(full_tree, b3.MERGE_LEVELS), 0,
              (leaves + m_wide) * digest, int_ops=instructions(m_wide)),
        _case("merkle_tree_device", f"{rows} x {n} x {2 * k_words} words (int64), whole tree, "
              f"{1 + len(merges)} launch{'es' if merges else ''}",
              lambda: b3.merkle_tree_device(enc, k_words),
              lambda: b3.hash_leaves_plain(enc, k_words, depth), 0,
              enc.numel() * 8 + (leaves + nodes(rows, n, 0, depth)) * digest,
              int_ops=instructions(leaves + nodes(rows, n, 0, depth), leaves)),
    ]


def zip_records_cases(device, n_open: int = 1000, seed: int = 28) -> list[dict]:
    """The Zip open's column records at the 2^14 and 2^20 R1CS opens (128
    rows of 256 codewords, depth 8; 1024 rows of 2048, depth 11; 8 words a
    codeword, ``n_open`` columns), random words and digest lanes.  Bytes:
    the distinct opened columns' values (4·kw32 a row) and the distinct
    siblings' lanes (64 a node) read once, the columns read, the records
    written once; the records repeat a sibling many times (every node of the
    top levels), and those repeats are the cache's, not the bound's.  None in
    a checkout before the kernel."""
    import numpy as np
    import torch

    try:
        from zinc_tpu_torch.ops import zip_records as zr
    except ImportError:
        return []
    rng = np.random.default_rng(seed)
    out = []
    for rows, n in ((128, 256), (1024, 2048)):
        depth = n.bit_length() - 1
        enc = torch.from_numpy(rng.integers(0, 1 << 32, size=(rows, n, 8), dtype=np.uint64)
                               .astype(np.uint32).view(np.int32)).to(device)
        layers = [torch.from_numpy(rng.integers(0, 1 << 32, size=(rows, n >> lvl, 8),
                                                dtype=np.int64)).to(device)
                  for lvl in range(depth)]
        cols = torch.from_numpy(rng.integers(0, n, size=n_open)).to(device)
        host = cols.cpu().numpy()
        nodes = sum(len(np.unique((host >> lvl) ^ 1)) for lvl in range(depth))
        read = len(np.unique(host)) * rows * 4 * 8 + nodes * rows * 64 + n_open * 8
        out.append(_case(
            "zip_records", f"{n_open} columns of {rows} x {n} x 8 words, depth {depth}",
            lambda a=(enc, layers, cols, depth): zr.pack_records(*a),
            lambda a=(enc, layers, cols, depth): zr.pack_records_plain(*a), 0,
            read + n_open * sum(zr.record_bytes(rows, 8, depth))))
    return out


FS_WORDS = (8, 6, 16)  # n64 = 4 (every path), 3 and 8 (the widest field)


def field_of_words(n32: int):
    """A field of n32 words for fs_round's and the eq table's cases: q =
    2^(32·n32 − 1) plus a small odd offset (2^255 + 95 at 8 words), so that
    the challenge masks of 8, 6 and 16 words take the regimes under 2^256,
    under 2^256 with a masked top half, and from 2^256 on.  Only the words
    matter to a case, so q need not be prime."""
    import zinc_tpu_torch as zt

    q = (1 << (32 * n32 - 1)) + (95 if n32 == 8 else 2 * n32 + 1)
    return zt.FieldConfig(q, n32 // 2)


def fs_permutations(n32: int, n_pts: int, pos: int) -> int:
    """Keccak-f permutations of one fs_round: the blocks its n_pts frames
    (8·n32 + 4 bytes each) fill from sponge position pos, the digest's, and
    the blocks the 34-byte ratchet and r's frame fill after them."""
    from zinc_tpu_torch.ops.keccak_kernel import RATE

    frame = 8 * n32 + 4
    first = pos + n_pts * frame
    return first // RATE + 1 + (first % RATE + 34 + frame) // RATE


def fs_cases(ctx, device, seed: int = 23) -> list[dict]:
    """fs_round at the shapes the device-FS paths give it, on random inputs:
    dicts of a shape label, ``group`` (the label without the sponge
    position), ``inputs()`` (a fresh copy of the arguments after ``ctx``:
    the call writes in place), the round's Montgomery products (``full``),
    bytes moved and Keccak-f permutations (:func:`fs_permutations`).  The
    R1CS sumcheck 1 (Gruen: 2 terms, 4 points) on one block and on four,
    sumcheck 2 (1 term, 3 points), path A's generic sumcheck 1 (2 terms, 6
    points) and path B's 8 points, at sponge positions from 0 to 135, so
    that a round's absorbs start anywhere in a block and cross one or
    several (a 16-word round at 8 points absorbs 1,222 bytes); then the
    first and the last shape again at other positions, cases that differ
    only in their permutations (:func:`fit_permutations`).  The field's
    width is ``ctx``'s."""
    import numpy as np

    from zinc_tpu_torch.fields import montgomery as fm
    from zinc_tpu_torch.ops.keccak_kernel import STATE_WORDS

    rng = np.random.default_rng(seed)
    n = ctx.n32
    shapes = [  # (label, blocks, terms, points, Gruen, round, sponge position)
        ("R1CS sumcheck 1 (Gruen), 1 block", 1, 2, 4, True, 3, 0),
        ("R1CS sumcheck 1 (Gruen), 4 blocks", 4, 2, 4, True, 5, 101),
        ("R1CS sumcheck 2, 1 block", 1, 1, 3, False, 0, 135),
        ("path A sumcheck 1 (generic), 1 block", 1, 2, 6, False, 7, 67),
        ("path B (generic), 8 points", 1, 1, 8, False, 2, 131),
    ]
    shapes += [shapes[0][:-1] + (pos,) for pos in (1, 67, 128, 135)]
    shapes += [shapes[4][:-1] + (0,)]
    out = []
    for label, d, terms, pts, gruen, rnd, pos in shapes:
        rows = rnd + 2
        base = {
            "state": fm.to_tensor(rng.integers(0, 1 << 32, STATE_WORDS, dtype=np.uint64)
                                  .astype(np.uint32), device),
            "sums": random_residues(rng, ctx, (d, terms, pts), device),
            "coeffs": random_residues(rng, ctx, (terms,), device),
            "evals": random_residues(rng, ctx, (rows, pts), device),
            "rs": random_residues(rng, ctx, (rows,), device),
            "beta": random_residues(rng, ctx, (rows,), device) if gruen else None,
            "pref": random_residues(rng, ctx, (1,), device)[0] if gruen else None,
        }

        def inputs(base=base, pos=pos, rnd=rnd):
            c = {k: None if v is None else v.clone() for k, v in base.items()}
            return (c["state"], pos, c["sums"], c["coeffs"], c["evals"], c["rs"], rnd, c["beta"],
                    c["pref"])

        # s(t) = Σ_k coeff_k·res_k(t): a product a term and point, and one
        # for r's conversion; Gruen adds the ratchet's 3 and 4 a point (the
        # eq factor's two, then pref·c·s); the sponge's permutations are not
        # counted.  Bytes: the sums, coefficients, s and r, Gruen's β_{j−1},
        # β_j, r_{j−1} and pref (read and written), the sponge read and written
        full = pts * terms + 1 + (3 + 4 * pts if gruen else 0)
        n_bytes = 4 * n * (d * terms * pts + terms + pts + 1 + (5 if gruen else 0)) \
            + 2 * 4 * STATE_WORDS
        group = f"{label}, {terms} terms x {pts} points, {n} words"
        out.append({"shape": f"{group}, sponge at {pos}", "group": group, "inputs": inputs,
                    "full": full, "bytes": n_bytes, "permutations": fs_permutations(n, pts, pos)})
    return out


def fit_permutations(rows: list[tuple[str, int, float]]) -> tuple[dict[str, float], float]:
    """Least squares time = a_group + b·permutations over (group, permutations,
    ms) rows: a slope b common to every group (the time of a permutation)
    and an intercept a for each group (what its products, loads and stores
    take), so that cases of one shape at other sponge positions separate
    the two.  Returns ({group: a}, b)."""
    groups: dict[str, list[tuple[int, float]]] = {}
    for g, p, ms in rows:
        groups.setdefault(g, []).append((p, ms))
    mean = {g: (sum(p for p, _ in v) / len(v), sum(t for _, t in v) / len(v))
            for g, v in groups.items()}
    num = sum((p - mean[g][0]) * (t - mean[g][1]) for g, v in groups.items() for p, t in v)
    den = sum((p - mean[g][0]) ** 2 for g, v in groups.items() for p, _ in v)
    b = num / den if den else float("nan")
    return {g: mean[g][1] - b * mean[g][0] for g in groups}, b


def k10_rounds(ctx, device, log_n: int = 20, seed: int = 22) -> dict[str, list[dict]]:
    """K10 at every round shape of paths A and B: the executor fuses the fold
    into the round's evaluation while a table keeps more than HOST_TAIL
    entries after the fold, so from 2^log_n entries down to 2^8 (13 launches
    at 2^20).  Per path, dicts of the input entries ``b``, ``kernel`` (an
    argument-free call), products and bytes, as :func:`cases`."""
    import numpy as np

    from zinc_tpu_torch.sumcheck import kernels as sk
    from zinc_tpu_torch.sumcheck.executor import HOST_TAIL

    rng = np.random.default_rng(seed)
    r = random_residues(rng, ctx, (1,), "cpu")[0].numpy().view(np.uint32)
    eb = 4 * ctx.n32
    paths = {"A": (6, [(0, 1, 2, 3, 5), (4, 5)], 6), "B": (7, [tuple(range(7))], 8)}
    out = {}
    for label, (n_tab, terms, n_pts) in paths.items():
        full_tabs = random_residues(rng, ctx, (n_tab, 1 << log_n), device)
        rows, b = [], 1 << log_n
        while b // 2 > HOST_TAIL:
            tabs = full_tabs[:, :b].contiguous()
            full, lazy = round_products(b // 4, terms, n_pts)
            rows.append({"b": b, "full": n_tab * b // 2 + full, "lazy": lazy,
                         "bytes": n_tab * (b + b // 2) * eb,
                         "kernel": lambda tabs=tabs, terms=terms, n_pts=n_pts:
                             sk.fold_round_eval(ctx, tabs, r, terms, n_pts)})
            b //= 2
        out[label] = rows
    return out


def eq_host_ms(ctx, log_n: int = 20, calls: int = 20, seed: int = 27) -> float:
    """Host wall of one ``eq_levels`` call of log_n variables: the host clock
    around ``calls`` calls, each followed by a sync, over ``calls`` (the
    wrappers' host side and the device's time together)."""
    import time

    import numpy as np
    import torch

    from zinc_tpu_torch.poly.device import eq_levels

    r = random_residues(np.random.default_rng(seed), ctx, (log_n,), "cuda")
    eq_levels(ctx, r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        eq_levels(ctx, r)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose zinc_tpu_torch is timed")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels needs a CUDA device")
    import zinc_tpu_torch as zt
    from zinc_tpu_torch.fields.montgomery import device_field
    from zinc_tpu_torch.ops import _cuda
    from zinc_tpu_torch.sumcheck.device_fs import fs_round

    from zinc_tpu_torch.ops import blake3 as b3

    _cuda.build(FS_WORDS + (_cuda.BLAKE3,))
    info = card()
    floor = launch_floor_ms()
    print(json.dumps({"card": info, "root": str(Path(args.root).resolve()),
                      "package": str(Path(zt.__file__).parent), "launch_floor_ms": floor}),
          flush=True)
    # the BLAKE3 kernels' registers and spills, and (where the leaves launch
    # has its cluster tail) the clusters of 8 and 16 blocks the card holds
    ptxas = [ln.strip() for ln in _cuda.BUILD[_cuda.BLAKE3]["ptxas"].splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    clusters = ({1 << c: b3.max_active_clusters(c) for c in (3, 4)}
                if hasattr(b3, "max_active_clusters") else None)
    print(json.dumps({"name": "blake3 build", "ptxas": ptxas, "max_active_clusters": clusters}),
          flush=True)
    ctx = device_field(zt.FieldConfig((1 << 255) + 95, 4))
    todo = [(ctx.n32, c) for c in cases(ctx, "cuda")]
    todo += [(n32, c) for n32 in FS_WORDS[1:]
             for c in eq_cases(device_field(field_of_words(n32)), "cuda")]
    todo += [(0, c) for c in merkle_cases("cuda")]
    todo += [(0, c) for c in zip_records_cases("cuda")]
    for n32, c in todo:
        ms = device_ms(c["kernel"])
        bound, by = bound_ms(n32, c["bytes"], c["full"], c["lazy"], info["max_sm_mhz"],
                             c["int_ops"])
        row = {"name": c["name"], "shape": c["shape"], "words": n32, "ms": ms, "bound_ms": bound,
               "bound_by": by, "share_of_bound": bound / ms}
        if c["launch_bound"]:
            row["launches"] = launches_of(c["kernel"])
            row["bound_with_launch_floor_ms"] = max(bound, row["launches"] * floor)
        print(json.dumps(row), flush=True)
    for n32 in FS_WORDS:
        fctx = device_field(field_of_words(n32))
        fit = []
        for c in fs_cases(fctx, "cuda"):
            args_ = c["inputs"]()
            ms = device_ms(lambda: fs_round(fctx, *args_))
            bound = bound_ms(n32, c["bytes"], c["full"], 0, info["max_sm_mhz"])[0]
            fit.append((c["group"], c["permutations"], ms))
            print(json.dumps({"name": "fs_round", "shape": c["shape"],
                              "permutations": c["permutations"], "ms": ms, "bound_ms": bound,
                              "bound_with_launch_floor_ms": max(bound, floor)}), flush=True)
        a, b = fit_permutations(fit)
        print(json.dumps({"name": "fs_round fit", "words": n32, "ms_per_permutation": b,
                          "ms_besides_permutations": a}), flush=True)
    for n32 in FS_WORDS:
        print(json.dumps({"name": "eq_levels host wall", "shape": f"2^20, {n32} words",
                          "ms": eq_host_ms(device_field(field_of_words(n32)))}), flush=True)
    for path, rows in k10_rounds(ctx, "cuda").items():
        times = [device_ms(row["kernel"]) for row in rows]
        bounds = [bound_ms(ctx.n32, row["bytes"], row["full"], row["lazy"], info["max_sm_mhz"])[0]
                  for row in rows]
        print(json.dumps({"name": "fold_round_eval", "shape": f"path {path}, {len(rows)} rounds",
                          "entries": [row["b"] for row in rows], "ms": times, "sum_ms": sum(times),
                          "bound_ms": bounds, "sum_bound_ms": sum(bounds)}), flush=True)


if __name__ == "__main__":
    main()
