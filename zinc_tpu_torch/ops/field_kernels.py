"""K1, the batched Montgomery product, and one level of the eq recurrence,
as CUDA kernels and their plain versions.

Replaces ``zinc_tpu/ops/pallas_field.py:mont_mul_pallas_t`` (the Pallas
kernel ``ops/sparse.py:_mont_mul_best`` calls on the TPU).  The kernel is
``csrc/mont_mul.cu``: one thread per element, CIOS over 32-bit words.  At
256 bits a product moves 96 B for 128 32-bit multiply-adds, close to the
H100's ridge; the kernel keeps the chain in registers and its loads
coalesced (see the note in the source).

:func:`eq_level` is one step of ``poly/device.py:eq_levels`` (the jitted
eq programs ``zinc_tpu/poly/device.py:69-77`` and
``zinc_tpu/sumcheck/mxu_exec.py:835`` in the reference, XLA, not Pallas):
K1's product and a subtraction an entry, in ``csrc/mont_mul.cu`` too.

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
    """The plain PyTorch version of :func:`eq_level` (any device)."""
    t = fm.mont_mul(ctx, buf, r_j)
    lo = fm.mont_sub(ctx, buf, t)
    return torch.stack([lo, t], dim=1).reshape(-1, ctx.n32)


def eq_level(ctx: fm.DeviceField, buf: torch.Tensor, r_j: torch.Tensor) -> torch.Tensor:
    """One level of the eq recurrence: from the (B, n32) table ``buf`` and
    r_j (n32,), the (2B, n32) table with out[2i] = buf[i]·(1 − r_j) and
    out[2i+1] = buf[i]·r_j (r_j on the lowest index bit), canonical
    Montgomery residues."""
    n = ctx.n32
    _cuda.require_field_tensor("eq_level buf", buf, n, 2)
    _cuda.require_field_tensor("eq_level r_j", r_j, n, 1)
    if buf.device != r_j.device:
        raise ValueError(f"eq_level: operands on {buf.device} and {r_j.device}")
    if not buf.is_cuda:
        return eq_level_plain(ctx, buf, r_j)
    _cuda.require_kernel_words(n)
    out = buf.new_empty((2 * buf.shape[0], n))
    q = _cuda.modulus_words(ctx)
    with _cuda.on_device(out):
        rc = _cuda.lib(n).zt_eq_level(
            out.data_ptr(), buf.data_ptr(), r_j.data_ptr(), buf.shape[0], n, q.ctypes.data,
            ctx.nprime32, _cuda.stream_ptr(out.device),
        )
    _cuda.check(rc, "eq_level")
    _cuda.LAUNCHES["eq_level"] += 1
    return out
