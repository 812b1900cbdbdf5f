"""The sumcheck round kernels, with their plain PyTorch versions.

* :func:`fold` replaces ``zinc_tpu/sumcheck/mxu_exec.py:_fold_lm`` (K2), and
  at other shapes ``zinc_tpu/ops/pallas_field.py:mont_fold_pallas`` (K6) and
  ``zinc_tpu/sumcheck/pallas_exec.py:_fold_fixed`` (K8).
* :func:`round_eval` replaces ``mxu_exec.py:_eval_lm`` (K3, classic rounds).
* :func:`round_eval_gruen` replaces ``mxu_exec.py:_eval_lm_gruen`` (K4,
  eq-factorized rounds).
* :func:`round_eval_generic` replaces ``pallas_field.py:round_eval_pallas``
  (K7) and ``pallas_exec.py:_eval_fixed`` (K9): any combination, the
  generic tier.
* :func:`fold_round_eval` replaces ``pallas_exec.py:_fold_eval_fixed``
  (K10): the fold and the generic evaluation in one launch.

The CUDA sources are ``csrc/sumcheck.cu`` (fold, K3, K4) and
``csrc/generic.cu``, built per field width (``ops/_cuda.py``); their header
notes say what bounds each kernel on the
H100 and what the design does about it.  Tables are (n_tables, B, n32)
int32 tensors in natural order: a round pairs entries (2p, 2p+1).  A fold
writes a fresh (n_tables, B/2, n32) output.

Every round kernel returns, per term and point t, the round sums reduced
mod q: (n_terms, n_pts, n32) int32 canonical residues, from one launch per
round for the whole combination.  They are linear in the products, so the
term's coefficient and, for K4, the Gruen factor pref·c_j(t) are applied
afterwards, where the Fiat-Shamir transcript takes the round values: on the
host (``sumcheck/executor.py:round_values``) or on the card, by
``fs_round`` (``sumcheck/device_fs.py``).  :func:`fold` and
:func:`fold_round_eval` take the challenge r as host words or as a tensor
on the tables' device (the device-resident loop's r, which ``fs_round``
writes there).

Wrapper rule: a CPU tensor goes to the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import re

import numpy as np
import torch

from ..fields import montgomery as fm
from ..fields.montgomery import DeviceField
from ..ops import _cuda

MAX_WORDS = 16  # ≤ 512-bit fields, as mxu_exec.mxu_supported


def _header_defines(name: str) -> dict[str, int]:
    """The integer ``#define``s of a header in ``csrc/``."""
    text = (_cuda.SRC_DIR / name).read_text()
    return {k: int(v) for k, v in re.findall(r"^#define (\w+) (\d+)$", text, re.M)}


# the kernels' scope, as csrc/generic.cuh and csrc/round_eval.cuh state it
# for both sides
GENERIC_LIMITS = _header_defines("generic.cuh")
EVAL_LIMITS = _header_defines("round_eval.cuh")
MAX_FACTORS = EVAL_LIMITS["ZT_EVAL_MAX_FACTORS"]  # factors per term of K3 (K4: one fewer, plus E)
MAX_POINTS = EVAL_LIMITS["ZT_EVAL_MAX_POINTS"]  # evaluation points per round (degree ≤ 4)


def eval_slots(terms) -> int:
    """Running sums of a K3/K4 launch: a term of k factors is a polynomial of
    degree k in t, so k + 1 sums fix it (its values at t = 0..k−1 and its
    leading coefficient) and the points follow from those
    (``sumcheck.cu:extend_points``)."""
    return sum(len(t) + 1 for t in terms)


def eval_block(n_slots: int, n32: int) -> int:
    """Threads of a K3/K4 block with ``n_slots`` running sums of 2·n32 + 1
    words each, the one place this is decided (the launch takes it): the
    largest power of two from ZT_EVAL_BLOCK down to ZT_EVAL_MIN_BLOCK whose
    shared memory fits, 0 if none does."""
    lim = EVAL_LIMITS

    def smem(t):
        return n_slots * (2 * n32 + 1) * lim["ZT_EVAL_ACC_BYTES"] * t

    t = lim["ZT_EVAL_BLOCK"]
    while t > lim["ZT_EVAL_MIN_BLOCK"] and smem(t) > GENERIC_LIMITS["ZT_SMEM_LIMIT"]:
        t //= 2
    return t if smem(t) <= GENERIC_LIMITS["ZT_SMEM_LIMIT"] else 0


def _eval_fits(terms, n32: int) -> bool:
    return (n32 <= MAX_WORDS and 1 <= len(terms) <= EVAL_LIMITS["ZT_EVAL_MAX_TERMS"]
            and eval_block(eval_slots(terms), n32) > 0)


def classic_supported(idx_terms, n32: int, n_pts: int = MAX_POINTS) -> bool:
    """What K3 takes: terms of 2-4 factors over ≤ 512-bit fields
    (``mxu_exec.py:mxu_supported``), as many as its launch holds, at more
    points than any term has factors (a round's degree bounds its terms')."""
    return all(2 <= len(t) <= 4 and len(t) < n_pts for t in idx_terms) and _eval_fits(idx_terms, n32)


def gruen_supported(idx_terms, eq_idx: int, n32: int, n_pts: int = MAX_POINTS) -> bool:
    """What K4 takes: every term ends with the eq index and has 1-3 other
    factors (``mxu_exec.py:gruen_supported``), fewer than the points."""
    return all(
        len(t) >= 2 and t[-1] == eq_idx and 1 <= len(t) - 1 <= 3 and len(t) - 1 < n_pts
        for t in idx_terms
    ) and _eval_fits([t[:-1] for t in idx_terms], n32)


def _check_tables(ctx: DeviceField, tables: torch.Tensor) -> None:
    _cuda.require_field_tensor("tables", tables, ctx.n32, 3)
    if tables.shape[1] % 2:
        raise ValueError(f"tables: odd length {tables.shape[1]}")
    if tables.shape[1] // 2 >= 1 << 31:
        raise ValueError("tables: the kernels' running sums are exact below 2^31 pairs")


def _check_terms(terms, n_tables: int, max_len: int, n_pts: int) -> None:
    for t in terms:
        if not 1 <= len(t) <= max_len or any(not 0 <= i < n_tables for i in t):
            raise ValueError(f"bad term {t} for {n_tables} tables")
    if not 1 <= n_pts <= MAX_POINTS:
        raise ValueError(f"n_pts {n_pts} outside 1..{MAX_POINTS}")


def generic_term_slots(k: int, n_pts: int) -> int:
    """Running sums of a term of k factors (``generic.cu:gen_term_slots``):
    a term of k ≥ 2 factors is a polynomial of degree k in t, fixed by its
    values at t = 0..k−1 and its leading coefficient, from which the points
    follow; where n_pts ≤ k its n_pts points are evaluated directly.  A term
    of one factor: its values at t = 0 and 1."""
    return min(k + 1 if k >= 2 else 2, n_pts)


def _has_lead(k: int, n_pts: int) -> bool:
    return k >= 2 and n_pts > k


def generic_slots(terms, n_pts: int) -> int:
    return sum(generic_term_slots(len(t), n_pts) for t in terms)


def _pass_len(n32: int) -> int:
    lim = GENERIC_LIMITS
    return lim["ZT_GEN_PASS"] if n32 <= 8 else lim["ZT_GEN_PASS_WIDE"]


def generic_passes(terms, n_pts: int, n32: int) -> int:
    """Passes of a generic launch (``generic.cu:make_comb``): each term's
    evaluations in runs of ZT_GEN_PASS (ZT_GEN_PASS_WIDE above 8 words), one
    warp each."""
    return sum(-(-generic_term_slots(len(t), n_pts) // _pass_len(n32)) for t in terms)


def generic_warps(terms, n_pts: int, n32: int) -> int:
    """Warps of a generic block, the passes it runs at once: as many as the
    term with the most passes has (up to ZT_GEN_BLOCK / 32), so that a
    block's warps carry passes of equal cost, those of one term, and the
    passes of lighter terms follow in later sweeps over the pairs."""
    most = max(-(-generic_term_slots(len(t), n_pts) // _pass_len(n32)) for t in terms)
    return min(most, GENERIC_LIMITS["ZT_GEN_BLOCK"] // 32)


def generic_stage_bytes(n32: int, n_tab: int) -> int:
    """Shared memory of K10's stage: both folded entries of 32 pairs of every
    table (``generic.cu:gen_smem``)."""
    return n_tab * 2 * n32 * 32 * 4


def generic_layout(n32: int, warps: int, n_tab: int, fold: bool) -> tuple[int, bool]:
    """(block, staged) of a generic launch: ``warps`` (:func:`generic_warps`)
    warps, a pass each (the other passes take further sweeps over the
    pairs), and for K10 a stage when every table's 32 folded pairs fit the
    shared memory."""
    return (32 * warps,
            fold and generic_stage_bytes(n32, n_tab) <= GENERIC_LIMITS["ZT_SMEM_LIMIT"])


def generic_supported(idx_terms, n_pts: int, n32: int) -> bool:
    """What the generic kernels take: any terms of ≥ 1 factor over ≤ 512-bit
    fields, as many as the launch's parameter block holds, at up to
    ZT_GEN_MAX_POINTS points.  Shared memory bounds no combination: a block
    without room for its stage reads the tables in device memory
    (:func:`generic_layout`)."""
    lim = GENERIC_LIMITS
    return (
        n32 <= MAX_WORDS
        and 1 <= len(idx_terms) <= lim["ZT_GEN_MAX_TERMS"]
        and all(len(t) >= 1 for t in idx_terms)
        and sum(map(len, idx_terms)) <= lim["ZT_GEN_MAX_ENTRIES"]
        and 1 <= n_pts <= lim["ZT_GEN_MAX_POINTS"]
    )


def _check_generic(ctx: DeviceField, tables: torch.Tensor, terms, n_pts: int) -> None:
    if not generic_supported(terms, n_pts, ctx.n32):
        raise ValueError(
            f"terms {terms} at {n_pts} points and {ctx.n32} words are outside the generic kernels' scope"
        )
    if any(not 0 <= i < tables.shape[0] for t in terms for i in t):
        raise ValueError(f"bad terms {terms} for {tables.shape[0]} tables")


# ---------------------------------------------------------------------------
# K2 fold
# ---------------------------------------------------------------------------


def _check_r(ctx: DeviceField, tables: torch.Tensor, r) -> None:
    """r as host words (n32,), or as an int32 (n32,) tensor on the tables'
    device (the device-resident Fiat-Shamir loop's challenge)."""
    if isinstance(r, torch.Tensor):
        _cuda.require_field_tensor("r", r, ctx.n32, 1)
        if r.device != tables.device:
            raise ValueError(f"r: on {r.device}, the tables on {tables.device}")
    elif np.asarray(r).shape != (ctx.n32,):
        raise ValueError(f"r: expected {ctx.n32} words, got shape {np.asarray(r).shape}")


def _r_args(r) -> tuple:
    """(host words, device pointer) of a launch's r: one of them None."""
    if isinstance(r, torch.Tensor):
        return None, r.data_ptr()
    return _cuda.host_words(r).ctypes.data, None


def fold_plain(ctx: DeviceField, tables: torch.Tensor, r) -> torch.Tensor:
    if not isinstance(r, torch.Tensor):
        r = fm.to_tensor(np.asarray(r, dtype=np.uint32), tables.device)
    v0, v1 = tables[:, 0::2], tables[:, 1::2]
    return fm.mont_add(ctx, v0, fm.mont_mul(ctx, fm.mont_sub(ctx, v1, v0), r))


def fold(ctx: DeviceField, tables: torch.Tensor, r) -> torch.Tensor:
    """v0 + r·(v1 − v0) over pairs (2p, 2p+1) of every table; r as (n32,)
    uint32 host words (a host-side Fiat-Shamir challenge, in the launch's
    parameters), or as an int32 (n32,) tensor on the tables' device, which
    the kernel reads there (the device-resident loop's challenge)."""
    _check_tables(ctx, tables)
    _check_r(ctx, tables, r)
    if not tables.is_cuda:
        return fold_plain(ctx, tables, r)
    _cuda.require_kernel_words(ctx.n32)
    n_tab, b, n = tables.shape
    out = torch.empty((n_tab, b // 2, n), dtype=torch.int32, device=tables.device)
    if out.numel() == 0:
        return out
    q = _cuda.modulus_words(ctx)
    with _cuda.on_device(tables):
        rc = _cuda.lib(n).zt_fold(
            out.data_ptr(), tables.data_ptr(), n_tab * (b // 2), n, *_r_args(r),
            q.ctypes.data, ctx.nprime32, _cuda.stream_ptr(tables.device),
        )
    _cuda.check(rc, "fold")
    _cuda.LAUNCHES["fold"] += 1
    return out


# ---------------------------------------------------------------------------
# K3 / K4 round evaluation
# ---------------------------------------------------------------------------


def _term_sums_plain(ctx, tables, term, n_pts, weight=None) -> torch.Tensor:
    """(n_pts, n32) int64 exact word sums of Π_k M_k(t, p) [· weight[p]] over p."""
    vals = [tables[i, 0::2] for i in term]
    steps = [fm.mont_sub(ctx, tables[i, 1::2], tables[i, 0::2]) for i in term]
    out = []
    for _ in range(n_pts):
        prod = vals[0]
        for v in vals[1:]:
            prod = fm.mont_mul(ctx, prod, v)
        if weight is not None:
            prod = fm.mont_mul(ctx, prod, weight)
        out.append(fm.widen(prod).sum(dim=0))
        vals = [fm.mont_add(ctx, v, s) for v, s in zip(vals, steps)]
    return torch.stack(out)


def _reduced(ctx, tables, sums) -> torch.Tensor:
    """Exact sums over the tables' pairs → canonical residues mod q."""
    return fm.reduce_lazy(ctx, sums, tables.shape[1] // 2)


def round_eval_plain(ctx, tables, terms, n_pts) -> torch.Tensor:
    """K3's plain version: (n_terms, n_pts, n32) residues of the round sums."""
    return _reduced(ctx, tables, torch.stack([_term_sums_plain(ctx, tables, t, n_pts) for t in terms]))


def round_eval_gruen_plain(ctx, tables, e_level, terms, n_pts) -> torch.Tensor:
    """K4's plain version: (n_terms, n_pts, n32) residues of the round sums."""
    return _reduced(ctx, tables, torch.stack([_term_sums_plain(ctx, tables, t, n_pts, e_level)
                                              for t in terms]))


# (device, n32, gruen, n_slots, block) -> the most blocks resident at once
_EVAL_GRID: dict[tuple, int] = {}


def _eval_max_grid(lib, dev, n32: int, gruen: bool, n_slots: int, block: int) -> int:
    """The most K3/K4 blocks resident at once on ``dev``; the caller has made
    ``dev`` current (:func:`_cuda.on_device`), so the probe reads that card."""
    key = (dev, n32, gruen, n_slots, block)
    if key not in _EVAL_GRID:
        max_grid = ctypes.c_int(0)
        _cuda.check(lib.zt_eval_max_grid(int(gruen), n_slots, n32, block,
                                          ctypes.addressof(max_grid)), "zt_eval_max_grid")
        _EVAL_GRID[key] = max_grid.value
    return _EVAL_GRID[key]


@functools.lru_cache(maxsize=64)
def _eval_comb(terms: tuple) -> tuple[np.ndarray, np.ndarray]:
    """(factor counts, factor indices padded to MAX_FACTORS) of a combination."""
    n_fac = np.asarray([len(t) for t in terms], dtype=np.int32)
    fac = np.zeros((len(terms), MAX_FACTORS), dtype=np.int32)
    for j, t in enumerate(terms):
        fac[j, : len(t)] = t
    return n_fac, fac


def _eval_launch(fn_name, ctx, tables, terms, n_pts, e_level=None) -> torch.Tensor:
    """One K3/K4 launch for the whole combination: one buffer holds the
    output (its first row), the blocks' rows and, in its last word, the
    launch's own count of finished blocks (zeroed on the launch's stream)."""
    n = ctx.n32
    _cuda.require_kernel_words(n)
    lib = _cuda.lib(n)
    dev = tables.device
    b = tables.shape[1]
    pairs = b // 2
    n_slots = len(terms) * n_pts  # output residues (a block's row needs at most as many)
    n_fac, fac = _eval_comb(tuple(map(tuple, terms)))
    wide_slots = eval_slots(terms)
    block = eval_block(wide_slots, n)
    with _cuda.on_device(tables):
        max_grid = _eval_max_grid(lib, dev, n, e_level is not None, wide_slots, block)
        grid = max(1, min(-(-pairs // block), max_grid))
        rows = (grid + 1) * n_slots * n
        buf = torch.empty(rows + 1, dtype=torch.int32, device=dev)
        ptr = buf.data_ptr()
        rc = lib.zt_round_eval(
            ptr, ptr + 4 * n_slots * n, ptr + 4 * rows, tables.data_ptr(), b, pairs,
            None if e_level is None else e_level.data_ptr(), n_fac.ctypes.data, fac.ctypes.data,
            len(terms), n_pts, block, grid, n, _cuda.modulus_words(ctx).ctypes.data, ctx.nprime32,
            _cuda.stream_ptr(dev),
        )
    _cuda.check(rc, fn_name)
    _cuda.LAUNCHES[fn_name] += 1
    return buf[: n_slots * n].view(len(terms), n_pts, n)


def round_eval(ctx: DeviceField, tables: torch.Tensor, terms, n_pts: int) -> torch.Tensor:
    """Classic round sums: (n_terms, n_pts, n32) residues of
    Σ_p Π_{k∈term} M_k(t, p) mod q, t = 0..n_pts−1."""
    _check_tables(ctx, tables)
    _check_terms(terms, tables.shape[0], MAX_FACTORS, n_pts)
    if not classic_supported(terms, ctx.n32, n_pts):
        raise ValueError(f"round_eval: terms {terms} at {n_pts} points and {ctx.n32} words are "
                         "outside K3's scope")
    if not tables.is_cuda:
        return round_eval_plain(ctx, tables, terms, n_pts)
    return _eval_launch("round_eval", ctx, tables, terms, n_pts)


def round_eval_gruen(
    ctx: DeviceField, tables: torch.Tensor, e_level: torch.Tensor, terms, n_pts: int
) -> torch.Tensor:
    """Gruen round sums: (n_terms, n_pts, n32) residues of
    Σ_p E[p]·Π_{k∈term} M_k(t, p) mod q; ``terms`` exclude the eq index and
    ``e_level`` is the suffix-eq level aligned with the pairs."""
    _check_tables(ctx, tables)
    _check_terms(terms, tables.shape[0], MAX_FACTORS - 1, n_pts)
    _cuda.require_field_tensor("e_level", e_level, ctx.n32, 2)
    if e_level.shape[0] != tables.shape[1] // 2 or e_level.device != tables.device:
        raise ValueError(f"e_level: expected {tables.shape[1] // 2} entries on {tables.device}")
    if not _eval_fits(terms, ctx.n32) or any(len(t) >= n_pts for t in terms):
        raise ValueError(f"round_eval_gruen: terms {terms} at {n_pts} points and {ctx.n32} words "
                         "are outside K4's scope")
    if not tables.is_cuda:
        return round_eval_gruen_plain(ctx, tables, e_level, terms, n_pts)
    return _eval_launch("round_eval_gruen", ctx, tables, terms, n_pts, e_level)


# ---------------------------------------------------------------------------
# the generic tier: K7/K9 round_eval_generic, K10 fold_round_eval
# ---------------------------------------------------------------------------


def _term_evals_plain(ctx, tables, term, n_pts) -> torch.Tensor:
    """(h, n32) int64 exact word sums over the pairs of a term's evaluations,
    as the generic kernels form them: its values at t = 0..h−1 or, where it
    has one, at t = 0..h−2 and last its leading coefficient
    Π_k (v1_k − v0_k)."""
    h = generic_term_slots(len(term), n_pts)
    v0 = [tables[i, 0::2] for i in term]
    v1 = [tables[i, 1::2] for i in term]
    steps = [fm.mont_sub(ctx, b, a) for a, b in zip(v0, v1)]
    xs, out = v0, []
    for e in range(h):
        factors = steps if _has_lead(len(term), n_pts) and e == h - 1 else xs
        prod = factors[0]
        for x in factors[1:]:
            prod = fm.mont_mul(ctx, prod, x)
        out.append(fm.widen(prod).sum(dim=0))
        xs = v1 if e == 0 else [fm.mont_add(ctx, x, s) for x, s in zip(xs, steps)]
    return torch.stack(out)


def _extend_plain(ctx, vals: torch.Tensor, lead, n_pts: int) -> torch.Tensor:
    """(n_pts, n32) residues: the values at t = 0..n_pts−1 of the polynomial
    whose values at t = 0..h−1 are ``vals`` (h, n32), of degree h with
    leading coefficient ``lead``, or of degree h − 1 when ``lead`` is None
    (``round_sums.cuh:extend_points``): its forward differences at 0, the
    top one (D!·lead) held constant, summed back up."""
    if lead is None and len(vals) >= n_pts:
        return vals[:n_pts]
    row, diffs = list(vals), []
    while row:
        diffs.append(row[0])
        row = [fm.mont_sub(ctx, b, a) for a, b in zip(row, row[1:])]
    if lead is not None:
        top = lead
        for m in range(2, len(vals) + 1):  # D!·lead
            base = top
            for _ in range(m - 1):
                top = fm.mont_add(ctx, top, base)
        diffs.append(top)
    out = []
    for _ in range(n_pts):
        out.append(diffs[0])
        diffs = [fm.mont_add(ctx, a, b) for a, b in zip(diffs, diffs[1:])] + diffs[-1:]
    return torch.stack(out)


def round_eval_generic_plain(ctx, tables, terms, n_pts) -> torch.Tensor:
    """The generic kernels' plain version: (n_terms, n_pts, n32) residues.
    Each term's evaluations are summed over the pairs and reduced mod q,
    then extended to every point, as the kernels do."""
    out = []
    for t in terms:
        ev = _reduced(ctx, tables, _term_evals_plain(ctx, tables, t, n_pts))
        lead = _has_lead(len(t), n_pts)
        out.append(_extend_plain(ctx, ev[:-1] if lead else ev, ev[-1] if lead else None, n_pts))
    return torch.stack(out)


def fold_round_eval_plain(ctx, tables, r, terms, n_pts):
    folded = fold_plain(ctx, tables, r)
    return folded, round_eval_generic_plain(ctx, folded, terms, n_pts)


@functools.lru_cache(maxsize=64)
def _comb_arrays(terms: tuple) -> tuple[np.ndarray, np.ndarray]:
    """(start, factor indices) of a combination: term j is
    fac[start[j] .. start[j+1])."""
    start = np.cumsum([0] + [len(t) for t in terms]).astype(np.int32)
    return start, np.asarray([i for t in terms for i in t], dtype=np.int32)


# (device, n32, warps, n_tab, fold) -> (block, staged, max grid)
_GEN_PLAN: dict[tuple, tuple[int, bool, int]] = {}


def generic_plan(lib, dev, n32: int, warps: int, n_tab: int, fold: bool) -> tuple[int, bool, int]:
    """(block, staged, max grid) of a generic launch, the one place this is
    decided (the launch takes it): :func:`generic_layout`, and the most
    blocks resident at once on ``dev`` (``zt_gen_max_grid``), which the
    caller has made current (:func:`_cuda.on_device`)."""
    key = (dev, n32, warps, n_tab, fold)
    if key not in _GEN_PLAN:
        block, staged = generic_layout(n32, warps, n_tab, fold)
        max_grid = ctypes.c_int(0)
        smem = generic_stage_bytes(n32, n_tab) if staged else 0
        _cuda.check(lib.zt_gen_max_grid(int(fold), block, smem, n32, ctypes.addressof(max_grid)),
                    "zt_gen_max_grid")
        _GEN_PLAN[key] = (block, staged, max_grid.value)
    return _GEN_PLAN[key]


def _generic_launch(name, ctx, tables, terms, n_pts, folded=None, r=None) -> torch.Tensor:
    """One launch of ``zt_<name>`` for the whole combination: one buffer
    holds the output (its first rows), the grid's slot sums, the 64-bit
    column sums the blocks add their slots into and, in its last word, the
    launch's own count of finished blocks (the last two zeroed on the
    launch's stream).  K10 also fills ``folded``."""
    n = ctx.n32
    _cuda.require_kernel_words(n)
    lib = _cuda.lib(n)
    n_tab, b = tables.shape[0], tables.shape[1]
    fold = folded is not None
    pairs = b // 4 if fold else b // 2
    dev = tables.device
    n_out, n_sums = len(terms) * n_pts * n, generic_slots(terms, n_pts) * n
    start, fac = _comb_arrays(tuple(map(tuple, terms)))
    with _cuda.on_device(tables):
        block, staged, max_grid = generic_plan(lib, dev, n, generic_warps(terms, n_pts, n), n_tab,
                                               fold)
        grid = max(1, min(-(-pairs // 32), max_grid))
        buf = torch.empty(n_out + 3 * n_sums + 1, dtype=torch.int32, device=dev)
        ptr = buf.data_ptr()
        bufs = (ptr, ptr + 4 * n_out, ptr + 4 * (n_out + n_sums))
        comb = (start.ctypes.data, fac.ctypes.data, len(terms), n_pts, block, grid, int(staged))
        field = (n, _cuda.modulus_words(ctx).ctypes.data, ctx.nprime32, _cuda.stream_ptr(dev))
        if fold:
            rc = lib.zt_fold_round_eval(*bufs, folded.data_ptr(), tables.data_ptr(), n_tab, b,
                                        *_r_args(r), *comb, *field)
        else:
            rc = lib.zt_round_eval_generic(*bufs, tables.data_ptr(), n_tab, b, *comb, *field)
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return buf[:n_out].view(len(terms), n_pts, n)


def round_eval_generic(ctx: DeviceField, tables: torch.Tensor, terms, n_pts: int) -> torch.Tensor:
    """Round sums of any combination: (n_terms, n_pts, n32) residues of
    Σ_p Π_{k∈term} M_k(t, p) mod q, t = 0..n_pts−1 (the function of
    :func:`round_eval`, for terms of any length, in one launch)."""
    _check_tables(ctx, tables)
    _check_generic(ctx, tables, terms, n_pts)
    if not tables.is_cuda:
        return round_eval_generic_plain(ctx, tables, terms, n_pts)
    return _generic_launch("round_eval_generic", ctx, tables, terms, n_pts)


def fold_round_eval(ctx: DeviceField, tables: torch.Tensor, r, terms, n_pts: int):
    """Fold every table by r (as :func:`fold`: host words or a tensor on the
    tables' device) and evaluate the combination over the folded pairs (as
    :func:`round_eval_generic`) in one launch.  Returns (folded (n_tables,
    B/2, n32), sums (n_terms, n_pts, n32))."""
    _check_tables(ctx, tables)
    _check_r(ctx, tables, r)
    _check_generic(ctx, tables, terms, n_pts)
    if tables.shape[1] % 4:
        raise ValueError(f"tables: length {tables.shape[1]} is not a multiple of 4")
    if not tables.is_cuda:
        return fold_round_eval_plain(ctx, tables, r, terms, n_pts)
    n_tab, b, n = tables.shape
    folded = torch.empty((n_tab, b // 2, n), dtype=torch.int32, device=tables.device)
    return folded, _generic_launch("fold_round_eval", ctx, tables, terms, n_pts, folded, r)


def sums_to_ints(ctx: DeviceField, sums: torch.Tensor) -> np.ndarray:
    """Round sums (..., n32) int32 residues → object array of ints."""
    arr = fm.to_numpy(sums)
    flat = arr.reshape(-1, arr.shape[-1])
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in flat]
    return np.array(vals, dtype=object).reshape(arr.shape[:-1])
