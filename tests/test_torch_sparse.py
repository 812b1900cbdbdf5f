"""The port's sparse products (zinc_tpu_torch.ops.sparse, field_map and the
eq tables) against ``zinc_tpu.ops.sparse`` on the CPU, at ~2^10 nonzeros.
Exact equality throughout."""

import random

import numpy as np
import pytest

from zinc_tpu.ccs import dummy_ccs_of_size as j_dummy
from zinc_tpu.fields.config import FieldConfig as JFieldConfig
from zinc_tpu.ops import sparse as js
from zinc_tpu.ops.field_map import i64_to_field_device as j_i64
from zinc_tpu.ops.field_map import ints_to_field_device as j_ints
from zinc_tpu.poly.device import build_eq_table_device as j_eq
from zinc_tpu.poly.device import fps_to_limbs as j_fps_to_limbs
from zinc_tpu.sparse import SparseMatrix as JSparseMatrix
from zinc_tpu_torch.ccs import dummy_ccs_of_size
from zinc_tpu_torch.fields.config import FieldConfig
from zinc_tpu_torch.sparse import PACKS, SparseMatrix
from zinc_tpu_torch.fields import montgomery as fm
from zinc_tpu_torch.ops import sparse as ps
from zinc_tpu_torch.fields.integers import int_vector
from zinc_tpu_torch.ops.field_map import vector_to_field
from zinc_tpu_torch.poly.device import build_eq_table_device, fps_to_tensor

Q = (1 << 255) + 95
CFG, JCFG = FieldConfig(Q, 4), JFieldConfig(Q, 4)
N = 1 << 10


def _random_rows(n: int, seed: int):
    """A non-diagonal matrix: 0-5 nonzeros per row, signed 62-bit values."""
    rng = random.Random(seed)
    return [
        [(rng.randrange(-(1 << 62), 1 << 62), rng.randrange(n)) for _ in range(rng.randrange(6))]
        for _ in range(n)
    ]


def _pair(kind: str):
    if kind == "dummy":
        _, _, st, _ = dummy_ccs_of_size(N, random.Random(7), int_bits=62)
        _, _, jst, _ = j_dummy(N, random.Random(7), int_bits=62)
        return st.constraints[2], jst.constraints[2]
    rows = _random_rows(N, 8)
    return SparseMatrix(N, N, rows), JSparseMatrix(N, N, rows)


def _words(jarr) -> np.ndarray:
    return fm.from_jax_limbs(np.asarray(jarr))


def _coo_rows(kind: str):
    """The rows of each packing case, and the path ``packed_coo`` must take."""
    if kind == "dummy":
        _, _, st, _ = dummy_ccs_of_size(N, random.Random(7), int_bits=62)
        return st.constraints[2].rows, "flat"
    if kind == "random":
        return _random_rows(N, 8), "flat"
    if kind == "empty":
        return [[] for _ in range(8)], "flat"
    if kind == "int64_ends":
        return [[(-(1 << 63), 3)], [], [((1 << 63) - 1, 0), (5, 7)], [(0, 1)]] * 2, "flat"
    if kind == "wide":
        return [[(1, 3)], [], [(1 << 63, 0), (-5, 7)], [(0, 1)]] * 2, "fallback"
    return _random_rows(N, 9), "fallback"  # "field": mapped to Fp below


@pytest.mark.parametrize("kind", ["dummy", "random", "empty", "int64_ends", "wide", "field"])
def test_packed_coo_matches_jax(kind):
    rows, path = _coo_rows(kind)
    n = len(rows)
    m, jm_ = SparseMatrix(n, n, rows), JSparseMatrix(n, n, rows)
    if kind == "field":
        m, jm_ = m.map_to_field(CFG), jm_.map_to_field(JCFG)
    before = dict(PACKS)
    got, want = m.packed_coo(), jm_.packed_coo()
    assert {k: PACKS[k] - before[k] for k in PACKS} == {p: int(p == path) for p in PACKS}
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    if path == "flat":
        assert got[2].dtype == want[2].dtype == np.int64 and np.array_equal(got[2], want[2])
    elif kind == "field":
        assert got[2].dtype == object and [x.m for x in got[2]] == [x.m for x in want[2]]
    else:
        assert got[2].dtype == object and got[2].tolist() == want[2]


@pytest.mark.parametrize("kind", ["dummy", "wide"])
def test_packed_coo_memo_holds(kind):
    rows, _ = _coo_rows(kind)
    m = SparseMatrix(len(rows), len(rows), rows)
    first = m.packed_coo()
    before = dict(PACKS)
    second = m.packed_coo()
    assert second is first and all(a is b for a, b in zip(second, first))
    assert PACKS == before


@pytest.mark.parametrize("kind", ["dummy", "random"])
def test_upload_matrix_carries_over(kind):
    m, jm_ = _pair(kind)
    got = ps.upload_matrix(CFG, m, "cpu")
    want = js.upload_matrix(JCFG, jm_)
    assert np.array_equal(fm.to_numpy(got.vals), _words(want.vals))
    assert np.array_equal(fm.to_numpy(got.vals_by_col), _words(want.vals_by_col))
    for a, b in [(got.rows_idx, want.rows_idx), (got.cols_idx, want.cols_idx),
                 (got.row_ends, want.row_ends), (got.rows_by_col, want.rows_by_col),
                 (got.col_ends, want.col_ends)]:
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", ["dummy", "random"])
def test_mat_vec_and_eval_table_match_jax(kind):
    m, jm_ = _pair(kind)
    rng = random.Random(9)
    z = [rng.randrange(-(1 << 62), 1 << 62) for _ in range(N)]
    rx = [CFG.fp(rng.randrange(Q)) for _ in range(10)]
    got_m, want_m = ps.upload_matrix(CFG, m, "cpu"), js.upload_matrix(JCFG, jm_)

    z_f = vector_to_field(CFG, int_vector(z), "cpu")
    jz = j_i64(JCFG, np.array(z, np.int64))
    assert np.array_equal(fm.to_numpy(z_f), _words(jz))

    mz = ps.mat_vec_mul_device(CFG, got_m, z_f)
    assert np.array_equal(fm.to_numpy(mz), _words(js.mat_vec_mul_device(JCFG, want_m, jz)))

    eq = build_eq_table_device(CFG, rx, "cpu")
    jeq = j_eq(JCFG, [JCFG.fp_from_mont(x.m) for x in rx])
    assert np.array_equal(fm.to_numpy(eq), _words(jeq))
    tab = ps.eval_table_device(CFG, got_m, eq)
    assert np.array_equal(fm.to_numpy(tab), _words(js.eval_table_device(JCFG, want_m, jeq, N)))


def test_final_mle_evals_match_jax():
    _, _, st, _ = dummy_ccs_of_size(N, random.Random(10), int_bits=62)
    _, _, jst, _ = j_dummy(N, random.Random(10), int_bits=62)
    rng = random.Random(11)
    r_row = [CFG.fp(rng.randrange(Q)) for _ in range(10)]
    r_col = [CFG.fp(rng.randrange(Q)) for _ in range(10)]
    ms = [ps.upload_matrix(CFG, m, "cpu", with_col_views=False) for m in st.constraints]
    got = ps.evaluate_mles_device(CFG, ms, r_row, r_col)
    jms = [js.upload_matrix(JCFG, m, with_col_views=False) for m in jst.constraints]
    want = js.evaluate_mles_device(
        JCFG, jms, [JCFG.fp_from_mont(x.m) for x in r_row], [JCFG.fp_from_mont(x.m) for x in r_col]
    )
    assert [x.m for x in got] == [x.m for x in want]


def test_wide_integers_to_field():
    rng = random.Random(12)
    vals = [0, 1, -1, Q, -Q, Q - 1] + [rng.randrange(-(1 << 300), 1 << 300) for _ in range(30)]
    got = fm.words_to_ints(fm.to_numpy(vector_to_field(CFG, int_vector(vals), "cpu")))
    assert got == [CFG.to_mont(v) for v in vals]
    want = fm.words_to_ints(_words(j_ints(JCFG, vals)))
    assert got == want
    # the matrix values of the reference field map, through fps_to_tensor too
    fe = [CFG.fp(v) for v in vals]
    assert np.array_equal(fm.to_numpy(fps_to_tensor(fe, CFG, "cpu")),
                          fm.from_jax_limbs(j_fps_to_limbs([JCFG.fp(v) for v in vals], JCFG)))


# name: (q, n64, values): int64 values above and at or below 2^64, and wide ones
FIELD_ENTRY_CASES = {
    "int64": (Q, 4, [0, 1, -1, -(1 << 63), (1 << 63) - 1, 5, -7]),
    "int64_q_below_2^64": ((1 << 61) - 1, 1, [0, 1, -1, -(1 << 63), (1 << 63) - 1, (1 << 61) - 1]),
    "wide": (Q, 4, [0, 1, -1, 1 << 63, -(1 << 63) - 1, Q + 3, -(1 << 300)]),
}


@pytest.mark.parametrize("name", sorted(FIELD_ENTRY_CASES))
def test_vector_to_field_matches_jax(name):
    """``vector_to_field`` on an ``int_vector``: int64 values take the
    two's-complement map where q > 2^64 (the JAX package's
    ``i64_to_field_device``) and the wide path where q ≤ 2^64, which the
    JAX package's int64 map refuses; wide values take the wide path (its
    ``ints_to_field_device``).  The residues equal the JAX package's and
    each value's own Montgomery form."""
    q, n64, vals = FIELD_ENTRY_CASES[name]
    cfg, jcfg = FieldConfig(q, n64), JFieldConfig(q, n64)
    vec = int_vector(vals)
    assert vec.dtype == (object if name == "wide" else np.int64)
    got = fm.to_numpy(vector_to_field(cfg, vec, "cpu"))
    want = j_i64(jcfg, vec) if vec.dtype == np.int64 and q > 1 << 64 else j_ints(jcfg, vals)
    assert np.array_equal(got, _words(want))
    assert fm.words_to_ints(got) == [cfg.to_mont(v) for v in vals]


def test_evaluate_mle_device_matches_jax():
    from zinc_tpu.poly.device import evaluate_mle_device as j_eval
    from zinc_tpu.poly.device import mle_to_device
    from zinc_tpu_torch.poly.device import evaluate_mle_device

    rng = random.Random(13)
    vals = [rng.randrange(Q) for _ in range(1 << 8)]
    point = [rng.randrange(Q) for _ in range(8)]
    got = evaluate_mle_device(
        CFG, fps_to_tensor([CFG.fp_from_mont(v) for v in vals], CFG, "cpu"),
        [CFG.fp_from_mont(x) for x in point],
    )
    want = j_eval(JCFG, mle_to_device(JCFG, [JCFG.fp_from_mont(v) for v in vals]),
                  [JCFG.fp_from_mont(x) for x in point])
    assert got.m == want.m
