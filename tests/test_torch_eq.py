"""The port's eq tables (``zinc_tpu_torch/poly/device.py:eq_levels`` and
``_eq_table_device``, views of one ``ops/field_kernels.eq_table`` buffer)
against the JAX package's jitted eq programs on the CPU: the full table
against ``poly/device.py:_eq_table_device`` and every level against the
Gruen suffix levels of ``sumcheck/mxu_exec.py:build_eq_suffix_flat``, at 0
to 11 variables over 192-, 256- and 512-bit fields (11 is one more than a
block of ``csrc/eq.cu`` doubles its entry).  Exact equality of the
residues' words; the buffer's layout and the wrapper's refusals.  The
kernel itself is held against the plain levels on the card in
``tests/test_torch_kernels.py``."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zinc_tpu.fields.config import FieldConfig as JFieldConfig
from zinc_tpu.fields.montgomery import device_field as j_device_field
from zinc_tpu.poly.device import build_eq_table_device as j_build_eq_table_device
from zinc_tpu.poly.device import fps_to_limbs as j_fps_to_limbs
from zinc_tpu.sumcheck.mxu_exec import build_eq_suffix_flat, suffix_offsets
from zinc_tpu_torch.fields import montgomery as fm
from zinc_tpu_torch.fields.config import FieldConfig
from zinc_tpu_torch.ops import _cuda
from zinc_tpu_torch.ops import field_kernels as fk
from zinc_tpu_torch.poly.device import (_eq_table_device, build_eq_table_device, eq_levels,
                                        eq_levels_plain, fps_to_tensor)

MODULI = {3: (1 << 191) + 5, 4: (1 << 255) + 95, 8: (1 << 511) + 187}


def _point(n64: int, s: int):
    q = MODULI[n64]
    rng = random.Random(100 * n64 + s)
    vals = [rng.randrange(q) for _ in range(s)]
    vals[0] = q - 1  # the top of the field: 1 − r wraps
    return FieldConfig(q, n64), JFieldConfig(q, n64), vals


def _ints(table: torch.Tensor) -> list[int]:
    return fm.words_to_ints(fm.to_numpy(table))


def _jax_ints(limbs) -> list[int]:
    """(B, L) or limb-major (L, B) JAX 16-bit limbs → the residues."""
    return fm.words_to_ints(fm.from_jax_limbs(np.asarray(limbs)))


def _bit_reversed(vals: list[int], bits: int) -> list[int]:
    return [vals[int(format(i, f"0{bits}b")[::-1], 2) if bits else 0] for i in range(len(vals))]


@pytest.mark.parametrize("n64", [3, 4, 8])
@pytest.mark.parametrize("s", range(1, 12))
def test_eq_levels_match_jax(n64, s):
    cfg, jcfg, vals = _point(n64, s)
    r = [cfg.fp(v) for v in vals]
    levels = eq_levels(fm.device_field(cfg), fps_to_tensor(r, cfg, "cpu"))
    assert [tuple(x.shape) for x in levels] == [(1 << (s - k), 2 * n64) for k in range(s + 1)]

    jr = [jcfg.fp(v) for v in vals]
    want = _jax_ints(j_build_eq_table_device(jcfg, jr))
    assert _ints(levels[0]) == want
    assert _ints(build_eq_table_device(cfg, r, "cpu")) == want

    # E_j = eq of β_{j+1..s}, β_{j+1} on the top lane bit: level j bit-reversed
    flat = np.asarray(build_eq_suffix_flat(j_device_field(jcfg),
                                           jnp.asarray(j_fps_to_limbs(jr, jcfg)), s))
    offs = suffix_offsets(s)
    for j in range(1, s + 1):
        e_j = _jax_ints(flat[:, offs[j - 1] : offs[j - 1] + (1 << (s - j))].T)
        assert _bit_reversed(_ints(levels[j]), s - j) == e_j


def test_eq_level_cpu_tensors_take_the_plain_version():
    cfg, _, vals = _point(4, 6)
    ctx = fm.device_field(cfg)
    r = fps_to_tensor([cfg.fp(v) for v in vals], cfg, "cpu")
    _cuda.reset_launches()
    assert torch.equal(fk.eq_table(ctx, r), fk.eq_table_plain(ctx, r))
    assert torch.equal(fk.eq_table(ctx, r, all_levels=False), fk.eq_table_plain(ctx, r, False))
    assert all(torch.equal(x, y) for x, y in zip(eq_levels(ctx, r), eq_levels_plain(ctx, r)))
    assert all(v == 0 for v in _cuda.LAUNCHES.values())
    assert _cuda._libs == {}  # nothing was built for CPU tensors


def test_eq_level_rejects_bad_inputs():
    cfg, _, vals = _point(4, 2)
    ctx = fm.device_field(cfg)
    r = fps_to_tensor([cfg.fp(v) for v in vals], cfg, "cpu")
    with pytest.raises(TypeError):
        fk.eq_table(ctx, r.to(torch.int64))
    with pytest.raises(ValueError):
        fk.eq_table(ctx, r[:, :6])  # 6 words in an 8-word field
    with pytest.raises(ValueError):
        fk.eq_table(ctx, r[0])  # r is a list of points
    with pytest.raises(ValueError):
        fk.eq_table(ctx, r[None])
    with pytest.raises(ValueError):  # more variables than the kernel takes
        fk.eq_table(ctx, r[:1].expand(fk.EQ_MAX_VARS + 1, -1))


@pytest.mark.parametrize("s", [0, 1, 10, 11])
def test_eq_levels_are_views_of_one_buffer(s):
    """Level k of ``eq_levels`` is rows 2^(s+1) − 2^(s−k+1) .. 2^(s+1) −
    2^(s−k) of one (2^(s+1) − 1, n32) tensor, level 0 first; the level-0
    form is that buffer's first 2^s rows, alone."""
    cfg, _, vals = _point(4, max(s, 1))
    ctx = fm.device_field(cfg)
    r = fps_to_tensor([cfg.fp(v) for v in vals[:s]], cfg, "cpu")
    levels = eq_levels(ctx, r)
    buf = fk.eq_table(ctx, r)
    assert tuple(buf.shape) == ((2 << s) - 1, 8)
    assert len(levels) == s + 1
    base = levels[0].untyped_storage().data_ptr()
    for k, x in enumerate(levels):
        assert tuple(x.shape) == (1 << (s - k), 8) and x.is_contiguous()
        assert x.untyped_storage().data_ptr() == base
        assert x.storage_offset() == ((2 << s) - (2 << (s - k))) * 8
    assert torch.equal(torch.cat(levels), buf)
    assert torch.equal(torch.cat(levels), torch.cat(eq_levels_plain(ctx, r)))
    assert _ints(levels[s]) == [cfg.one().m]
    first = _eq_table_device(ctx, r)
    assert tuple(first.shape) == (1 << s, 8) and first.storage_offset() == 0
    assert torch.equal(first, levels[0])


@pytest.mark.parametrize("n64", [3, 8])
def test_eq_table_of_no_variables_is_one(n64):
    cfg, jcfg, _ = _point(n64, 1)
    ctx = fm.device_field(cfg)
    r = fps_to_tensor([], cfg, "cpu").reshape(0, 2 * n64)
    assert _ints(fk.eq_table(ctx, r)) == _ints(fk.eq_table(ctx, r, False)) == [cfg.one().m]
    assert _ints(build_eq_table_device(cfg, [], "cpu")) == _jax_ints(
        j_build_eq_table_device(jcfg, []))
