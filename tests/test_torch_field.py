"""The port's field layer (zinc_tpu_torch.fields) against the JAX package
and the host ``Fp`` oracle.  Every value is an integer: equality is exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zinc_tpu.fields import montgomery as jm
from zinc_tpu.fields.config import FieldConfig as JFieldConfig
from zinc_tpu.fields.limbs import ints_to_limbs, limbs_to_ints
from zinc_tpu_torch.fields.config import FieldConfig
from zinc_tpu_torch.fields import montgomery as fm

# (q, n64): the small-q cases of tests/test_device_field.py, one field with
# q < R/2 and one with q > R/2 (the largest 256-bit prime), and 384 bits
FIELDS = [
    (312829638388039969874974628075306023441, 3),
    (57316695564490278656402085503, 4),
    ((1 << 255) + 95, 4),
    ((1 << 256) - 189, 4),
    ((1 << 383) + 369, 6),
]
IDS = ["128bit-n3", "96bit-n4", "q<R/2", "q>R/2", "384bit"]


def _cases(q: int, n: int, seed: int) -> list[int]:
    rng = random.Random(seed)
    return [0, 1, q - 1, q - 2, 2, q // 2] + [rng.randrange(q) for _ in range(n)]


def _port(values, n32):
    return fm.to_tensor(fm.ints_to_words(values, n32))


def _ints(t):
    return fm.words_to_ints(fm.to_numpy(t))


@pytest.mark.parametrize("q,n64", FIELDS, ids=IDS)
def test_mont_ops_match_jax_and_host(q, n64):
    cfg = FieldConfig(q, n64)
    ctx = fm.device_field(cfg)
    a_vals = _cases(q, 40, 0)
    b_vals = list(reversed(_cases(q, 40, 1)))
    a, b = _port(a_vals, ctx.n32), _port(b_vals, ctx.n32)

    jcfg = JFieldConfig(q, n64)
    jctx = jm.device_field(jcfg)
    ja = jnp.asarray(ints_to_limbs(a_vals, jctx.n16))
    jb = jnp.asarray(ints_to_limbs(b_vals, jctx.n16))

    for port_op, jax_op, host_op in [
        (fm.mont_mul, jm.mont_mul, cfg.mont_mul),
        (fm.mont_add, jm.mont_add, cfg.add),
        (fm.mont_sub, jm.mont_sub, cfg.sub),
    ]:
        got = _ints(port_op(ctx, a, b))
        assert got == limbs_to_ints(np.asarray(jax_op(jctx, ja, jb)))
        assert got == [host_op(x, y) for x, y in zip(a_vals, b_vals)]
    got_neg = _ints(fm.mont_neg(ctx, a))
    assert got_neg == limbs_to_ints(np.asarray(jm.mont_neg(jctx, ja)))
    assert got_neg == [cfg.neg(x) for x in a_vals]


@pytest.mark.parametrize("q,n64", FIELDS, ids=IDS)
def test_to_from_mont(q, n64):
    cfg = FieldConfig(q, n64)
    ctx = fm.device_field(cfg)
    vals = _cases(q, 30, 2)
    m = fm.to_mont(ctx, _port(vals, ctx.n32))
    assert _ints(m) == [cfg.to_mont(v) for v in vals]
    assert _ints(fm.from_mont(ctx, m)) == vals


@pytest.mark.parametrize("q,n64", FIELDS, ids=IDS)
def test_lazy_sum_and_mod_reduce_wide(q, n64):
    cfg = FieldConfig(q, n64)
    ctx = fm.device_field(cfg)
    vals = _cases(q, 200, 3) + [q - 1] * 50
    wide = fm.lazy_sum(ctx, _port(vals, ctx.n32), dim=0)
    assert fm.words_to_ints(wide.numpy().astype(np.uint32))[0] == sum(vals)
    assert _ints(fm.mod_reduce_wide(ctx, wide[None]))[0] == sum(vals) % q

    # the k_max rule at the edges of the width, against the JAX package
    w = ctx.n32 + 1
    edge = [0, q - 1, q, (1 << (32 * w)) - 1, q << (32 * w - q.bit_length()),
            (q << (32 * w - q.bit_length())) - 1]
    jctx = jm.device_field(JFieldConfig(q, n64))
    jwide = jnp.asarray(ints_to_limbs(edge, 2 * w))
    want = limbs_to_ints(np.asarray(jm.mod_reduce_wide(jctx, jwide)))
    got = _ints(fm.mod_reduce_wide(ctx, torch.from_numpy(fm.ints_to_words(edge, w).astype(np.int64))))
    assert got == want == [v % q for v in edge]


def test_jax_limb_converters_roundtrip():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 32, size=(17, 8), dtype=np.uint64).astype(np.uint32)
    limbs = fm.to_jax_limbs(words)
    assert limbs.shape == (17, 16) and limbs.max() <= 0xFFFF
    assert np.array_equal(fm.from_jax_limbs(limbs), words)
    vals = fm.words_to_ints(words)
    assert limbs_to_ints(limbs) == vals
    assert np.array_equal(limbs, ints_to_limbs(vals, 16))


def test_field_tensor_boundary_dtypes():
    words = np.array([[0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0]], np.uint32)
    t = fm.to_tensor(words)
    assert t.dtype == torch.int32
    assert np.array_equal(fm.to_numpy(t), words)
    assert fm.widen(t).tolist() == [[0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0]]
    assert torch.equal(fm.narrow(fm.widen(t)), t)
