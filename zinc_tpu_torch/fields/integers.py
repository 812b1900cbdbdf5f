"""Signed big-integer ops for the Zip PCS, on u32-word tensors.

The port of ``zinc_tpu/fields/integers.py``.  A two's-complement integer of
W words is a (..., W) int64 tensor of canonical u32 words (each in
[0, 2^32)), little-endian.

* The RAA accumulate is a per-word prefix sum: prefix sums are linear, so
  summing each word column in int64 and carrying once afterwards
  (``montgomery.carry``, the port of ``_carry_limbs_lastaxis``) equals the
  sequential big-integer accumulation, wrap-around included.
* The proximity combination Σᵣ coeffᵣ·evalᵣ,c is a signed 8-bit-limb product
  in float64: each limb product is < 2^16, a sum over R rows stays below
  2^53 for R < 2^37, so the contraction is exact in any summation order
  (float64 has no TF32 mode).  torch has no integer matmul on CUDA.

A vector of integers on the host is one :func:`int_vector`: int64 when every
value fits, else an object array of Python ints.  The converters take it and
pick their int64 or wide path by its dtype (:func:`vector_to_words`,
:func:`vector_to_mag8`, ``ops/field_map.vector_to_field``), so no caller
decides which one it holds.
"""

from __future__ import annotations

import numpy as np
import torch

from .montgomery import M32, carry, ints_to_words


def sign_extend(words: torch.Tensor, out_w: int) -> torch.Tensor:
    """Two's-complement sign extension (..., W) → (..., out_w)."""
    w = words.shape[-1]
    assert out_w >= w
    fill = ((words[..., -1:] >> 31) & 1) * M32
    return torch.cat([words, fill.expand(words.shape[:-1] + (out_w - w,))], dim=-1)


def cumsum_wrap(words: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-word prefix sum along ``dim`` with carry normalization (wrap at
    the width).  int64 columns are exact up to 2^31 entries."""
    assert words.shape[dim] < 1 << 31
    # scan along the innermost axis: torch's CUDA scan over an outer axis
    # runs one thread per column
    scanned = torch.cumsum(words.movedim(dim, -1).contiguous(), dim=-1).movedim(-1, dim)
    return carry(scanned, words.shape[-1])


def int_vector(values) -> np.ndarray:
    """A sequence of integers as one host vector: int64 when every value
    fits (``np.fromiter``'s OverflowError is the range check), else an
    object array of the values themselves (wide ints; field elements, which
    ``np.fromiter`` refuses with a TypeError)."""
    try:
        return np.fromiter(values, np.int64, len(values))
    except (OverflowError, TypeError):
        out = np.empty(len(values), object)
        out[:] = values
        return out


def vector_to_words(values: np.ndarray, n_words: int, device) -> torch.Tensor:
    """An :func:`int_vector` → (B, n_words) two's-complement canonical words
    (int64) on ``device``."""
    if values.dtype == np.int64:
        v = torch.from_numpy(np.ascontiguousarray(values)).to(device)
        return sign_extend(torch.stack([v & M32, (v >> 32) & M32], dim=-1), n_words)
    mod = 1 << (32 * n_words)
    words = ints_to_words([v % mod for v in values.tolist()], n_words)
    return torch.from_numpy(words.astype(np.int64)).to(device)


# ---------------------------------------------------------------------------
# signed-magnitude 8-bit decomposition (host packing)
# ---------------------------------------------------------------------------


def vector_to_mag8(values: np.ndarray, n8: int) -> tuple[np.ndarray, np.ndarray]:
    """An :func:`int_vector` (any shape for int64) → (|v| in 8-bit limbs
    uint8, sign int8 ±1): 8 limbs for int64 values, else ``n8``."""
    if values.dtype == np.int64:
        signs = np.where(values < 0, np.int8(-1), np.int8(1))
        mags = np.abs(values).astype(np.uint64)  # |−2^63| wraps to 2^63
        return mags.astype("<u8").view(np.uint8).reshape(values.shape + (8,)), signs
    ints = values.tolist()
    mags = np.frombuffer(b"".join(abs(v).to_bytes(n8, "little") for v in ints), np.uint8)
    signs = np.array([-1 if v < 0 else 1 for v in ints], np.int8)
    return mags.reshape(len(ints), n8).copy(), signs


def combine_rows_acc(
    coeff_mag8: torch.Tensor,  # (R, Lc8) 8-bit limbs
    coeff_sign: torch.Tensor,  # (R,) ±1
    eval_mag8: torch.Tensor,  # (R, C, Le8)
    eval_sign: torch.Tensor,  # (R, C) ±1
) -> torch.Tensor:
    """(C, Lc8, Le8) int64 limb-product sums Σᵣ ±coeffᵣ[i]·evalᵣ,c[j]: linear
    in the rows, so the accumulators of row blocks add exactly
    (``zinc_tpu/fields/integers.py:combine_rows_acc``)."""
    assert eval_mag8.shape[0] < 1 << 37
    cm = coeff_mag8.to(torch.float64) * coeff_sign.to(torch.float64).unsqueeze(-1)
    em = eval_mag8.to(torch.float64) * eval_sign.to(torch.float64).unsqueeze(-1)
    return torch.einsum("ri,rcj->cij", cm, em).to(torch.int64)  # |g| ≤ R·255²


def combine_acc_to_words(g: torch.Tensor, out_words: int) -> torch.Tensor:
    """A (C, Lc8, Le8) accumulator → (C, out_words) two's-complement
    canonical words of the combined integers (one carry)."""
    c, lc, le = g.shape
    n8 = 4 * out_words
    cols = torch.zeros((c, max(n8, lc + le)), dtype=torch.int64, device=g.device)
    for i in range(lc):
        cols[:, i : i + le] += g[:, i, :]
    cols = cols[:, :n8]
    # 8-bit columns → lazy 32-bit word columns (|x| < 2^62)
    lazy = cols[:, 0::4] + (cols[:, 1::4] << 8) + (cols[:, 2::4] << 16) + (cols[:, 3::4] << 24)
    return carry(lazy, out_words)


def combine_rows_signed(coeff_mag8, coeff_sign, eval_mag8, eval_sign, out_words: int) -> torch.Tensor:
    """Σᵣ coeffᵣ·evalᵣ,c → (C, out_words) two's-complement canonical words."""
    return combine_acc_to_words(combine_rows_acc(coeff_mag8, coeff_sign, eval_mag8, eval_sign),
                                out_words)
