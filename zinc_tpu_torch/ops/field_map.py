"""ℤ → Z_q projection on device (the port of ``zinc_tpu/ops/field_map.py``).

For q > 2^64 a signed 64-bit value v = u − 2^64·s (u its two's-complement
u64 view, s the sign bit) satisfies v ≡ u + s·((−2^64) mod q) (mod q), and
the right side is < 2q: one conditional subtraction and one Montgomery
product by R² finish the map.  Wider integers, and every integer when
q ≤ 2^64, go through the generic signed-magnitude path
(``mod_reduce_wide``).  :func:`vector_to_field` takes an
``fields.integers.int_vector`` and picks the path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.config import FieldConfig
from ..fields import montgomery as fm
from ..fields.montgomery import DeviceField, device_field
from .field_kernels import mont_mul


def _i64_to_field(ctx: DeviceField, values: torch.Tensor) -> torch.Tensor:
    """values: (B,) int64 tensor → (B, n32) Montgomery residues."""
    n = ctx.n32
    u = torch.stack([values & fm.M32, (values >> 32) & fm.M32], dim=-1)  # u64 view
    u = torch.cat([u, u.new_zeros(u.shape[:-1] + (n - 2,))], dim=-1)
    corr = torch.from_numpy(
        fm.int_to_words((-(1 << 64)) % ctx.modulus, n).astype(np.int64)
    ).to(values.device)
    sign = (values < 0).to(torch.int64).unsqueeze(-1)
    v = fm.carry(u + corr * sign, n + 1)
    v = fm.cond_sub(v, ctx.const("q_wide", values.device))[..., :n]
    return mont_mul(ctx, fm.narrow(v), fm.narrow(ctx.const("r2", values.device)).expand_as(v))


def _wide_to_field(ctx: DeviceField, mag: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """|v| as canonical int64 words (B, W) and sign (B,) 0/1 → residues."""
    w = mag.shape[-1]
    if 32 * w < ctx.modulus.bit_length():
        mag = torch.cat([mag, mag.new_zeros(mag.shape[:-1] + (ctx.n32 - w,))], dim=-1)
    v = fm.mod_reduce_wide(ctx, mag)
    m = mont_mul(ctx, v, fm.narrow(ctx.const("r2", v.device)).expand_as(v))
    return torch.where(neg.bool().unsqueeze(-1), fm.mont_neg(ctx, m), m)


def vector_to_field(cfg: FieldConfig, values: np.ndarray, device) -> torch.Tensor:
    """An ``int_vector`` (B,) → (B, n32) Montgomery residues on ``device``:
    int64 values by the two's-complement map where q > 2^64, any others
    by their magnitudes (host packing + device map)."""
    ctx = device_field(cfg)
    if values.dtype == np.int64 and cfg.q > 1 << 64:
        return _i64_to_field(ctx, torch.from_numpy(np.ascontiguousarray(values)).to(device))
    ints = values.tolist()
    mags = [abs(v) for v in ints]
    width = max(ctx.n32, fm.words_for(max(mags).bit_length()) if mags else 1)
    mag = torch.from_numpy(fm.ints_to_words(mags, width).astype(np.int64)).to(device)
    neg = torch.tensor([1 if v < 0 else 0 for v in ints], dtype=torch.int64, device=device)
    return _wide_to_field(ctx, mag, neg)
