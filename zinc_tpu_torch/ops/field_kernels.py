"""K1, the batched Montgomery product, and the eq table, as CUDA kernels and
their plain versions.

Replaces ``zinc_tpu/ops/pallas_field.py:mont_mul_pallas_t`` (the Pallas
kernel ``ops/sparse.py:_mont_mul_best`` calls on the TPU).  The kernel is
``csrc/mont_mul.cu``: one thread per element, CIOS over 32-bit words.  At
256 bits a product moves 96 B for 128 32-bit multiply-adds, close to the
H100's ridge; the kernel keeps the chain in registers and its loads
coalesced (see the note in the source).

:func:`eq_table` is a whole eq table, every level or level 0 alone, in
one launch of ``csrc/eq.cu`` (the jitted eq programs
``zinc_tpu/poly/device.py:69-77`` and ``zinc_tpu/sumcheck/mxu_exec.py:835``
in the reference, XLA, not Pallas); its plain version is the level
recurrence, :func:`eq_level_plain` a variable.

Wrapper rule: a CPU tensor goes to the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..fields import montgomery as fm
from . import _cuda


def mont_mul_plain(ctx: fm.DeviceField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K1 (any device)."""
    return fm.mont_mul(ctx, a, b)


def mont_mul(ctx: fm.DeviceField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b·R⁻¹ mod q for int32 word tensors with broadcastable batches."""
    n = ctx.n32
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"mont_mul: expected torch.int32 words, got {a.dtype}, {b.dtype}")
    if a.shape[-1] != n or b.shape[-1] != n:
        raise ValueError(f"mont_mul: last dim must be {n}, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"mont_mul: operands on {a.device} and {b.device}")
    if not a.is_cuda:
        return mont_mul_plain(ctx, a, b)
    _cuda.require_kernel_words(n)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    av = a.expand(shape).reshape(-1, n).contiguous()
    bv = b.expand(shape).reshape(-1, n).contiguous()
    out = torch.empty_like(av)
    q = _cuda.modulus_words(ctx)
    with _cuda.on_device(out):
        rc = _cuda.lib(n).zt_mont_mul(
            out.data_ptr(), av.data_ptr(), bv.data_ptr(), av.shape[0], n,
            q.ctypes.data, ctx.nprime32, _cuda.stream_ptr(out.device),
        )
    _cuda.check(rc, "mont_mul")
    _cuda.LAUNCHES["mont_mul"] += 1
    return out.reshape(shape)


def eq_level_plain(ctx: fm.DeviceField, buf: torch.Tensor, r_j: torch.Tensor) -> torch.Tensor:
    """One level of the eq recurrence in plain PyTorch (any device): from the
    (B, n32) table ``buf`` and r_j (n32,), the (2B, n32) table with out[2i] =
    buf[i]·(1 − r_j) and out[2i+1] = buf[i]·r_j (r_j on the lowest index
    bit), canonical Montgomery residues."""
    t = fm.mont_mul(ctx, buf, r_j)
    lo = fm.mont_sub(ctx, buf, t)
    return torch.stack([lo, t], dim=1).reshape(-1, ctx.n32)


def eq_levels_plain(ctx: fm.DeviceField, r: torch.Tensor) -> list[torch.Tensor]:
    """Every level of the eq table of r (s, n32), one ``eq_level_plain`` a
    variable from [1̂]: element k is the eq table of r[k:] (2^(s−k) entries,
    bit j ↔ r[k+j]), element s is [1̂]."""
    buf = fm.narrow(ctx.const("one", r.device))[None, :]  # cached on the device: no host copy
    levels = [buf]
    for j in range(r.shape[0] - 1, -1, -1):
        buf = eq_level_plain(ctx, buf, r[j])
        levels.append(buf)
    return levels[::-1]


def eq_table_plain(ctx: fm.DeviceField, r: torch.Tensor, all_levels: bool = True) -> torch.Tensor:
    """The plain PyTorch version of :func:`eq_table` (any device): the
    levels of :func:`eq_levels_plain`, level 0 first, in one tensor (or level
    0 alone)."""
    levels = eq_levels_plain(ctx, r)
    return torch.cat(levels) if all_levels else levels[0]


EQ_MAX_VARS = 30  # 2^30 entries a level: more than a card holds at 8 words
EQ_SMEM_BYTES = 48 * 1024  # csrc/eq.cu: ZT_EQ_SMEM_LIMIT


def eq_block_levels(n32: int, s: int) -> int:
    """Levels each block of ``eq_table_kernel`` doubles its entry (e): the
    most whose two shared buffers (1.5·2^e entries of 4·n32 bytes) fit 48
    KB, at most 10 and at most s.  The table's top s − e levels come from
    each block's own scan, so a table of s variables is 2^(s−e) blocks
    (csrc/eq.cu)."""
    e = 0
    while e < min(s, 10) and 6 * n32 << (e + 1) <= EQ_SMEM_BYTES:
        e += 1
    return e


def eq_table(ctx: fm.DeviceField, r: torch.Tensor, all_levels: bool = True) -> torch.Tensor:
    """The eq table of r (s, n32) on its device, in one launch on a CUDA
    tensor (csrc/eq.cu): all s + 1 levels of the eq recurrence in one (2^(s+1) − 1, n32)
    tensor, level 0 first (level k, the table of r[k:], is rows
    2^(s+1) − 2^(s−k+1) up to 2^(s+1) − 2^(s−k)), or with ``all_levels``
    false level 0 alone, (2^s, n32), and no other level written.  Canonical
    Montgomery residues, equal word for word to :func:`eq_table_plain`."""
    n = ctx.n32
    _cuda.require_field_tensor("eq_table r", r, n, 2)
    s = r.shape[0]
    if s > EQ_MAX_VARS:
        raise ValueError(f"eq_table: {s} variables, at most {EQ_MAX_VARS}")
    if not r.is_cuda:
        return eq_table_plain(ctx, r, all_levels)
    _cuda.require_kernel_words(n)
    out = r.new_empty(((2 << s) - 1 if all_levels else 1 << s, n))
    with _cuda.on_device(out):
        rc = _cuda.lib(n).zt_eq_table(
            out.data_ptr(), r.data_ptr(), s, eq_block_levels(n, s), int(all_levels), n,
            _cuda.modulus_words(ctx).ctypes.data, ctx.nprime32, _cuda.one_words(ctx).ctypes.data,
            _cuda.stream_ptr(out.device),
        )
    _cuda.check(rc, "eq_table")
    _cuda.LAUNCHES["eq_table"] += 1
    return out
