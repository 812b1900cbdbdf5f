"""Device sparse-matrix products (CSR on tensors + segment sums).

The port of ``zinc_tpu/ops/sparse.py``.  M·z (sumcheck 1 setup) and eqᵀ·M
(sumcheck 2's table) become gather → K1 → int64 prefix sums → boundary
differences → one mod-q reduction per segment.  Entries are sorted by output
index once, at upload, so the products scatter nothing.

The prefix sums run over int64 lanes holding one u32 word each, so a
segment's word sums stay exact up to 2^31 entries in all: the reference's
bound of 2^15 nonzeros per segment (its u32 lanes) does not apply here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields.config import FieldConfig
from ..sparse import SparseMatrix
from ..fields import montgomery as fm
from ..fields.montgomery import DeviceField, device_field
from ..poly.device import build_eq_table_device, limbs_to_fp
from .field_kernels import mont_mul
from .field_map import vector_to_field


@dataclass
class DeviceCsr:
    """One sparse matrix uploaded for device products (both orientations)."""

    rows_idx: torch.Tensor  # (nnz,) int64, sorted
    cols_idx: torch.Tensor  # (nnz,) int64 (row-major order)
    vals: torch.Tensor  # (nnz, n32) Montgomery residues
    row_ends: torch.Tensor  # (n_rows+1,) int64 prefix boundaries
    vals_by_col: torch.Tensor | None  # (nnz, n32) column-sorted copy
    rows_by_col: torch.Tensor | None  # (nnz,) int64 row index, column-sorted
    col_ends: torch.Tensor | None  # (n_cols+1,) int64
    n_rows: int
    n_cols: int
    max_row_nnz: int
    max_col_nnz: int


def upload_matrix(cfg: FieldConfig, m: SparseMatrix, device, with_col_views: bool = True) -> DeviceCsr:
    """Project an integer sparse matrix into the field and upload it.

    ``with_col_views=False`` skips the column-sorted copy, which only the
    prover's transposed products read."""
    rows_np, cols_np, vals = m.packed_coo()
    return make_csr(rows_np, cols_np, vector_to_field(cfg, vals, device), m.n_rows, m.n_cols,
                    device, with_col_views)


def _ends(sorted_idx: np.ndarray, n: int) -> np.ndarray:
    return np.searchsorted(sorted_idx, np.arange(n + 1), side="left").astype(np.int64)


def make_csr(rows_np, cols_np, vals_f, n_rows, n_cols, device, with_col_views=True) -> DeviceCsr:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)

    row_ends = _ends(rows_np, n_rows)
    max_row = int(np.diff(row_ends).max()) if n_rows else 0
    vals_by_col = rows_by_col = col_ends_t = None
    max_col = 0
    if with_col_views:
        perm = np.argsort(cols_np, kind="stable")
        col_ends = _ends(cols_np[perm], n_cols)
        max_col = int(np.diff(col_ends).max()) if n_cols else 0
        vals_by_col = vals_f[t(perm)]
        rows_by_col = t(rows_np[perm])
        col_ends_t = t(col_ends)
    return DeviceCsr(
        rows_idx=t(rows_np), cols_idx=t(cols_np), vals=vals_f, row_ends=t(row_ends),
        vals_by_col=vals_by_col, rows_by_col=rows_by_col, col_ends=col_ends_t,
        n_rows=n_rows, n_cols=n_cols, max_row_nnz=max_row, max_col_nnz=max_col,
    )


def _segmented_matvec(
    ctx: DeviceField,
    vals: torch.Tensor,  # (nnz, n32), sorted by output segment
    gather_idx: torch.Tensor,  # (nnz,) into vec
    ends: torch.Tensor,  # (num_segments+1,) prefix boundaries
    vec: torch.Tensor,  # (N, n32)
    max_seg: int,
) -> torch.Tensor:
    """Sorted-segment sums Σ vals·vec[idx] as prefix-sum boundary differences."""
    prod = mont_mul(ctx, vals, vec[gather_idx])  # (nnz, n32) canonical, K1
    # one 1-D scan per word column: torch scans a (nnz, n32) tensor along
    # dim 0 with one thread per column on CUDA (~0.3 s at 2^20 on an H100)
    words = fm.widen(prod).T.contiguous()
    cs = torch.stack([torch.cumsum(w, dim=0) for w in words])  # exact below 2^31 entries
    padded = torch.cat([cs.new_zeros((ctx.n32, 1)), cs], dim=1)
    lazy = (padded[:, ends[1:]] - padded[:, ends[:-1]]).T
    return fm.reduce_lazy(ctx, lazy, max_seg)


def mat_vec_mul_device(cfg: FieldConfig, m: DeviceCsr, z: torch.Tensor) -> torch.Tensor:
    """M·z over the field: (n_rows, n32)."""
    return _segmented_matvec(device_field(cfg), m.vals, m.cols_idx, m.row_ends, z, m.max_row_nnz)


def eval_table_device(cfg: FieldConfig, m: DeviceCsr, rx: torch.Tensor) -> torch.Tensor:
    """rxᵀ·M over the field: (n_cols, n32)."""
    return _segmented_matvec(
        device_field(cfg), m.vals_by_col, m.rows_by_col, m.col_ends, rx, m.max_col_nnz
    )


def _mle_eval(ctx: DeviceField, m: DeviceCsr, eq_rx: torch.Tensor, eq_ry: torch.Tensor) -> torch.Tensor:
    prod = mont_mul(ctx, m.vals, eq_rx[m.rows_idx])  # K1
    prod = mont_mul(ctx, prod, eq_ry[m.cols_idx])  # K1
    return fm.mod_reduce_wide(ctx, fm.lazy_sum(ctx, prod, dim=0))


def dispatch_mle_evals(cfg: FieldConfig, ms, r_row: list, r_col: list) -> list:
    """Enqueue M̃ⱼ(r_row ‖ r_col) for several matrices (sharing the eq
    tables) and return device handles without waiting for them."""
    ctx = device_field(cfg)
    device = ms[0].vals.device
    eq_rx = build_eq_table_device(cfg, r_row, device)
    eq_ry = build_eq_table_device(cfg, r_col, device)
    return [_mle_eval(ctx, m, eq_rx, eq_ry) for m in ms]


def fetch_mle_evals(cfg: FieldConfig, handles) -> list:
    """Block on :func:`dispatch_mle_evals` handles → field elements."""
    return [limbs_to_fp(h, cfg) for h in handles]


def evaluate_mles_device(cfg: FieldConfig, ms, r_row: list, r_col: list) -> list:
    return fetch_mle_evals(cfg, dispatch_mle_evals(cfg, ms, r_row, r_col))
