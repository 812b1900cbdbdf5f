"""Montgomery field arithmetic on word tensors (plain PyTorch).

A field element is a ``(..., n32)`` ``torch.int32`` tensor holding the
little-endian u32 words of its Montgomery residue.  The radix
R = 2^(64·n64) is wire-visible (``zinc_tpu/fields/montgomery.py:3-5``), so
these words hold exactly the residues of the JAX package's 16-bit limbs;
``to_jax_limbs``/``from_jax_limbs`` convert at the boundary.

The functions here are the plain versions: they run on any device with
torch ops only.  torch's CPU ``uint32`` has no add and no ``>>``, so every
op widens to ``int64`` lanes holding one u32 word each (``& 0xFFFFFFFF``);
products split the words into 16-bit limbs so that a limb product and its
column sums stay exact in int64.  REDC is the big-factor form of the
reference: m = (T mod R)·N' mod R, result = (T + m·q)/R, one conditional
subtraction.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..fields.config import FieldConfig

M32 = 0xFFFFFFFF
M16 = 0xFFFF


@dataclass(frozen=True)
class DeviceField:
    """Constants of one field, as numpy u32 words (little-endian)."""

    modulus: int
    n32: int
    q: np.ndarray  # (n32,)
    nprime: np.ndarray  # (n32,) −q⁻¹ mod R
    nprime32: int  # −q⁻¹ mod 2^32 (the CIOS constant of the kernels)
    r2: np.ndarray  # (n32,) R² mod q
    one: np.ndarray  # (n32,) R mod q, the Montgomery one

    def __hash__(self):
        return hash((self.modulus, self.n32))

    def __eq__(self, other):
        return (
            isinstance(other, DeviceField)
            and self.modulus == other.modulus
            and self.n32 == other.n32
        )

    def const(self, name: str, device) -> torch.Tensor:
        """Constant ``name`` as an int64 word tensor on ``device`` (cached)."""
        return _const(self, name, str(torch.device(device)))


@lru_cache(maxsize=32)
def _device_field(modulus: int, n64: int) -> DeviceField:
    n32 = 2 * n64
    radix = 1 << (32 * n32)
    return DeviceField(
        modulus=modulus,
        n32=n32,
        q=int_to_words(modulus, n32),
        nprime=int_to_words((-pow(modulus, -1, radix)) % radix, n32),
        nprime32=(-pow(modulus, -1, 1 << 32)) % (1 << 32),
        r2=int_to_words(pow(radix % modulus, 2, modulus), n32),
        one=int_to_words(radix % modulus, n32),
    )


def device_field(cfg: FieldConfig) -> DeviceField:
    return _device_field(cfg.q, cfg.n64)


@lru_cache(maxsize=256)
def _const(ctx: DeviceField, name: str, device: str) -> torch.Tensor:
    n = ctx.n32
    if name == "q_wide":  # q in n32+1 words, for the conditional subtractions
        words = int_to_words(ctx.modulus, n + 1)
    elif name == "unit":  # the integer 1 (from_mont multiplies by it)
        words = int_to_words(1, n)
    elif name in ("q16", "nprime16"):
        words = getattr(ctx, name[:-2])
        return _split16(torch.from_numpy(words.astype(np.int64))).to(device)
    else:
        words = getattr(ctx, name)
    return torch.from_numpy(np.asarray(words).astype(np.int64)).to(device)


# ---------------------------------------------------------------------------
# host packing (numpy)
# ---------------------------------------------------------------------------


def ints_to_words(values, n32: int) -> np.ndarray:
    """Non-negative Python ints → (B, n32) uint32 little-endian words."""
    nb = 4 * n32
    raw = b"".join(int(v).to_bytes(nb, "little") for v in values)
    return np.frombuffer(raw, dtype="<u4").reshape(len(values), n32).astype(np.uint32)


def int_to_words(value: int, n32: int) -> np.ndarray:
    return ints_to_words([value], n32)[0]


def words_to_ints(words) -> list[int]:
    """(B, n) uint32 words → Python ints."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    arr = arr.reshape(-1, arr.shape[-1])
    return [int.from_bytes(row.astype("<u4").tobytes(), "little") for row in arr]


def to_jax_limbs(words) -> np.ndarray:
    """u32 words (..., n32) → the JAX package's (..., 2·n32) 16-bit limbs."""
    w = np.asarray(words, dtype=np.uint32)
    return np.stack([w & M16, w >> 16], axis=-1).reshape(w.shape[:-1] + (2 * w.shape[-1],))


def from_jax_limbs(limbs) -> np.ndarray:
    """The JAX package's (..., 2·n32) 16-bit limbs → u32 words (..., n32)."""
    l = np.asarray(limbs, dtype=np.uint32)
    return (l[..., 0::2] | (l[..., 1::2] << 16)).astype(np.uint32)


def to_tensor(words: np.ndarray, device="cpu") -> torch.Tensor:
    """uint32 numpy words → int32 field tensor on ``device``."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """int32 field tensor → uint32 numpy words (copies to the host)."""
    return x.detach().cpu().contiguous().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# int64-lane helpers: canonical words are int64 values in [0, 2^32)
# ---------------------------------------------------------------------------


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 words → int64 lanes holding the unsigned word."""
    return x.to(torch.int64) & M32


def narrow(w: torch.Tensor) -> torch.Tensor:
    """int64 lanes in [0, 2^32) → int32 words (two's-complement view)."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def _split16(w: torch.Tensor) -> torch.Tensor:
    """(..., n) words → (..., 2n) 16-bit limbs, little-endian."""
    return torch.stack([w & M16, w >> 16], dim=-1).flatten(-2)


def _mul_cols(a16: torch.Tensor, b16: torch.Tensor, ncols: int) -> torch.Tensor:
    """Lazy column sums Σ_{i+j=k} a_i·b_j of two 16-bit limb vectors (exact:
    each product < 2^32 and a column holds at most 32 of them)."""
    la = a16.shape[-1]
    batch = torch.broadcast_shapes(a16.shape[:-1], b16.shape[:-1])
    acc = torch.zeros(batch + (ncols,), dtype=torch.int64, device=a16.device)
    for j in range(min(b16.shape[-1], ncols)):
        w = min(la, ncols - j)
        acc[..., j : j + w] += a16[..., :w] * b16[..., j : j + 1]
    return acc


def _cols_to_words(cols: torch.Tensor) -> torch.Tensor:
    """Lazy 16-bit columns (..., 2k) → lazy 32-bit word columns (..., k)."""
    return cols[..., 0::2] + (cols[..., 1::2] << 16)


def carry(lazy: torch.Tensor, n_out: int) -> torch.Tensor:
    """Lazy int64 word columns (any sign, |x| < 2^62) → canonical words,
    truncated mod 2^(32·n_out) (two's-complement wrap)."""
    x = lazy.movedim(-1, 0)
    out = torch.empty((n_out,) + x.shape[1:], dtype=torch.int64, device=lazy.device)
    c = torch.zeros(x.shape[1:], dtype=torch.int64, device=lazy.device)
    for k in range(n_out):
        v = x[k] + c if k < x.shape[0] else c
        out[k] = v & M32
        c = v >> 32
    return out.movedim(0, -1)


def sub_words(a: torch.Tensor, b: torch.Tensor):
    """a − b over canonical words: (difference mod 2^(32n), borrow 0/1)."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    x = a.expand(shape).movedim(-1, 0)
    y = b.expand(shape).movedim(-1, 0)
    out = torch.empty(x.shape, dtype=torch.int64, device=a.device)
    br = torch.zeros(x.shape[1:], dtype=torch.int64, device=a.device)
    for k in range(x.shape[0]):
        v = x[k] - y[k] - br
        out[k] = v & M32
        br = (v < 0).to(torch.int64)
    return out.movedim(0, -1), br


def cond_sub(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a − m where a ≥ m, else a (canonical words, equal widths)."""
    d, br = sub_words(a, m)
    return torch.where((br == 0).unsqueeze(-1), d, a)


# ---------------------------------------------------------------------------
# field ops on int32 word tensors (broadcastable batches)
# ---------------------------------------------------------------------------


def mont_mul(ctx: DeviceField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b·R⁻¹ mod q for canonical residues."""
    n = ctx.n32
    dev = a.device
    t = carry(_cols_to_words(_mul_cols(_split16(widen(a)), _split16(widen(b)), 4 * n)), 2 * n)
    m = carry(_cols_to_words(_mul_cols(_split16(t[..., :n]), ctx.const("nprime16", dev), 2 * n)), n)
    s = _cols_to_words(_mul_cols(_split16(m), ctx.const("q16", dev), 4 * n)) + t
    res = carry(s, 2 * n + 1)[..., n:]  # (T + m·q)/R < 2q, in n+1 words
    return narrow(cond_sub(res, ctx.const("q_wide", dev))[..., :n])


def mont_add(ctx: DeviceField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = ctx.n32
    s = carry(widen(a) + widen(b), n + 1)
    return narrow(cond_sub(s, ctx.const("q_wide", a.device))[..., :n])


def mont_sub(ctx: DeviceField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d, br = sub_words(widen(a), widen(b))
    dq = carry(d + ctx.const("q", a.device), ctx.n32)  # wraps mod 2^(32n)
    return narrow(torch.where(br.bool().unsqueeze(-1), dq, d))


def mont_neg(ctx: DeviceField, a: torch.Tensor) -> torch.Tensor:
    d, _ = sub_words(ctx.const("q", a.device), widen(a))
    zero = (a == 0).all(dim=-1, keepdim=True)
    return narrow(torch.where(zero, torch.zeros_like(d), d))


def to_mont(ctx: DeviceField, v: torch.Tensor) -> torch.Tensor:
    """Canonical residue (< q) → Montgomery form (×R)."""
    return mont_mul(ctx, v, narrow(ctx.const("r2", v.device)))


def from_mont(ctx: DeviceField, a: torch.Tensor) -> torch.Tensor:
    """Montgomery form → canonical residue (×R⁻¹)."""
    return mont_mul(ctx, a, narrow(ctx.const("unit", a.device)))


def words_for(bits: int) -> int:
    return max(1, (bits + 31) // 32)


def lazy_sum(ctx: DeviceField, a: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Exact (non-modular) sum of residues along ``dim``: canonical int64
    words wide enough for the whole sum (reduce with ``mod_reduce_wide``)."""
    count = a.shape[dim]
    lazy = widen(a).sum(dim=dim)  # each word column < count·2^32 < 2^63
    return carry(lazy, max(ctx.n32, words_for((count * ctx.modulus - 1).bit_length())))


def reduce_lazy(ctx: DeviceField, lazy: torch.Tensor, count: int) -> torch.Tensor:
    """Lazy word sums of at most ``count`` residues → residues mod q.  The
    sum is below count·q, so its width, and with it k_max, follows from that
    bound (one conditional subtraction when count is 1)."""
    w = max(ctx.n32, words_for((max(count, 1) * ctx.modulus - 1).bit_length()))
    return mod_reduce_wide(ctx, carry(lazy, w))


def mod_reduce_wide(ctx: DeviceField, wide: torch.Tensor) -> torch.Tensor:
    """Canonical int64 words of any width W (< 2^(32W)) → residues mod q.

    The reference's k_max rule (``zinc_tpu/fields/montgomery.py:156-173``)
    in 32-bit words: k_max = 32·W − bits(q) puts q·2^k_max in
    [2^(32W−1), 2^(32W)), which fits the width and dominates every input, so
    the chain of conditional subtractions keeps x < 2·q·2^k at each k.
    """
    w = wide.shape[-1]
    k_max = 32 * w - ctx.modulus.bit_length()
    assert k_max >= 0, "wide input narrower than the modulus"
    x = wide
    for k in range(k_max, -1, -1):
        qs = torch.from_numpy(int_to_words(ctx.modulus << k, w).astype(np.int64)).to(wide.device)
        x = cond_sub(x, qs)
    if w < ctx.n32:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (ctx.n32 - w,))], dim=-1)
    return narrow(x[..., : ctx.n32])
