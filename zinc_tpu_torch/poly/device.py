"""Device MLE operations: packing, eq tables, fold and evaluation.

A table is a (B, n32) int32 tensor of Montgomery residues, B = 2^num_vars,
with the first variable as the fastest index bit (entries 2i and 2i+1 pair
up), as in ``zinc_tpu/poly/device.py``.  Large products go through the K1
wrapper and eq tables through the eq-table wrapper, so they run CUDA
kernels on a CUDA tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.config import FieldConfig, Fp
from ..fields import montgomery as fm
from ..fields.montgomery import DeviceField, device_field
# eq_levels_plain is re-exported: the plain levels the eq kernel is held to
from ..ops.field_kernels import eq_levels_plain, eq_table, mont_mul  # noqa: F401


def fps_to_limbs(fes: list[Fp], cfg: FieldConfig) -> np.ndarray:
    """Field elements → (B, n32) uint32 words of their Montgomery residues."""
    return fm.ints_to_words([fe.m for fe in fes], 2 * cfg.n64)


def fps_to_tensor(fes: list[Fp], cfg: FieldConfig, device) -> torch.Tensor:
    return fm.to_tensor(fps_to_limbs(fes, cfg), device)


def limbs_to_fp(words, cfg: FieldConfig) -> Fp:
    """(n32,) words (numpy or tensor) → the field element."""
    if isinstance(words, torch.Tensor):
        words = fm.to_numpy(words)
    return cfg.fp_from_mont(fm.words_to_ints(np.asarray(words).reshape(1, -1))[0])


def limbs_to_fps(words, cfg: FieldConfig) -> list[Fp]:
    """(B, n32) uint32 words of Montgomery residues → field elements."""
    return [cfg.fp_from_mont(v) for v in fm.words_to_ints(words)]


def tensor_to_fps(table: torch.Tensor, cfg: FieldConfig) -> list[Fp]:
    return limbs_to_fps(fm.to_numpy(table), cfg)


def fold_once(ctx: DeviceField, table: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """One fold of a (..., B, n32) table by r (n32,) → (..., B/2, n32)."""
    b = table.shape[-2]
    pairs = table.reshape(table.shape[:-2] + (b // 2, 2, table.shape[-1]))
    left, right = pairs[..., 0, :], pairs[..., 1, :]
    return fm.mont_add(ctx, left, mont_mul(ctx, fm.mont_sub(ctx, right, left), r))


def evaluate_mle_device(cfg: FieldConfig, table: torch.Tensor, point: list[Fp]) -> Fp:
    """Full MLE evaluation of a device table at a host point."""
    ctx = device_field(cfg)
    assert table.shape[0] == 1 << len(point)
    pt = fps_to_tensor(point, cfg, table.device)
    for i in range(len(point)):
        table = fold_once(ctx, table, pt[i])
    return limbs_to_fp(table[0], cfg)


def eq_levels(ctx: DeviceField, r: torch.Tensor) -> list[torch.Tensor]:
    """All levels of the eq recurrence for r (s, n32) on its device: element
    k is the eq table of r[k:] (2^(s−k) entries, bit j ↔ r[k+j]); element s
    is [1̂].  The levels are views of one ``eq_table`` buffer, level 0 first:
    one launch on a CUDA tensor."""
    s = r.shape[0]
    buf = eq_table(ctx, r)
    return [buf[(2 << s) - (2 << (s - k)) : (2 << s) - (1 << (s - k))] for k in range(s + 1)]


def _eq_table_device(ctx: DeviceField, r: torch.Tensor) -> torch.Tensor:
    return eq_table(ctx, r, all_levels=False)


def build_eq_table_device(cfg: FieldConfig, r: list[Fp], device) -> torch.Tensor:
    """eq(x, r) table: (2^s, n32), index bit j ↔ r[j]."""
    ctx = device_field(cfg)
    return _eq_table_device(ctx, fps_to_tensor(r, cfg, device))
