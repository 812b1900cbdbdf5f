"""The port's polynomial layer and host helpers held against the JAX package:
the dense MLEs' ring ops, relabel and integer eq tables
(tests/test_mle_ops.py), the sparse MLEs, index utils and virtual-polynomial
kits over the field and over ℤ (tests/test_poly_extras.py,
tests/test_sparse_mle_ops.py), the NAF and BigInt helpers of
``fields/limbs.py`` (tests/test_limbs_edge.py) and ``ccs/utils.py``
(tests/test_serialize.py).  Each test runs its JAX namesake's cases through
the port's copy and through ``zinc_tpu`` from the same seeds, and compares
ints: ``Fp``/``FieldConfig`` equality checks ``isinstance``, so no object
crosses the packages."""

import random

import pytest

import zinc_tpu.ccs.utils as jutils
import zinc_tpu.fields.limbs as jlimbs
import zinc_tpu.poly as jpoly
from zinc_tpu import ccs as jccs
from zinc_tpu.ccs import Statement as JStatement
from zinc_tpu.fields.config import FieldConfig as JFieldConfig
from zinc_tpu_torch import ccs, poly
from zinc_tpu_torch.ccs import InstanceZ, Statement
from zinc_tpu_torch.ccs import utils
from zinc_tpu_torch.fields import limbs
from zinc_tpu_torch.fields.config import FieldConfig

Q2 = 57316695564490278656402085503  # the reference's 2-word test prime
Q4 = (1 << 255) + 95
CFG2, JCFG2 = FieldConfig(Q2, 2), JFieldConfig(Q2, 2)
CFG4, JCFG4 = FieldConfig(Q4, 4), JFieldConfig(Q4, 4)


def _ints(values) -> list[int]:
    """Field elements (a list or an MLE's evaluations) as ints."""
    values = getattr(values, "evaluations", values)
    return [v.to_int() for v in values]


def _entries(sparse) -> dict[int, int]:
    return {i: v.to_int() for i, v in sparse.entries.items()}


def _pt(cfg, rng, n):
    return [cfg.fp(rng.randrange(cfg.q)) for _ in range(n)]


def _both(fn, seed):
    """fn(package, cfg, rng) for the port and for the JAX package, each with
    its own Random(seed)."""
    return (fn(poly, CFG2, random.Random(seed)), fn(jpoly, JCFG2, random.Random(seed)))


# ---------------------------------------------------------------------------
# dense MLEs (tests/test_mle_ops.py)
# ---------------------------------------------------------------------------


def test_ring_ops_pointwise():
    def ops(pkg, cfg, rng):
        a, b = pkg.DenseMleF.rand(4, cfg, rng), pkg.DenseMleF.rand(4, cfg, rng)
        r = cfg.fp(rng.randrange(cfg.q))
        outs = [a + b, a - b, -a, a * r, a.add_scaled(r, b), a + r]
        assert (outs[-1] - r) == a
        for i in range(16):
            assert outs[0][i] == a[i] + b[i] and outs[4][i] == a[i] + r * b[i]
        return [_ints(m) for m in outs]

    got, want = _both(ops, 0)
    assert got == want


def test_zero_identity():
    def ops(pkg, cfg, rng):
        a = pkg.DenseMleF.rand(3, cfg, rng)
        z = pkg.DenseMleF.zero(cfg)
        assert z.is_zero() and (a + z) == a and (z + a) == a
        assert z.add_scaled(cfg.fp(5), a) == a * cfg.fp(5)
        with pytest.raises(ValueError):
            _ = a + pkg.DenseMleF.rand(4, cfg, rng)
        return _ints(z.add_scaled(cfg.fp(5), a))

    got, want = _both(ops, 1)
    assert got == want


def test_index_assignment_and_to_evaluations():
    def ops(pkg, cfg, rng):
        a = pkg.DenseMleF.rand(2, cfg, rng)
        a[3] = cfg.fp(7)
        assert a[3] == cfg.fp(7)
        evs = a.to_evaluations()
        evs[0] = cfg.fp(1)  # a copy, not a view
        return _ints(a), _ints(evs)

    got, want = _both(ops, 2)
    assert got == want and got[0][0] == want[0][0]


def test_relabel_swaps_variables():
    def ops(pkg, cfg, rng):
        m = pkg.DenseMleF.rand(3, cfg, rng)
        rl = m.relabel(0, 2, 1)
        pt = _pt(cfg, rng, 3)
        assert rl.evaluate(pt) == m.evaluate([pt[2], pt[1], pt[0]])
        assert m.relabel(1, 1, 1) == m and m.relabel(0, 2, 0) == m
        for bad in ((0, 1, 2), (0, 3, 1)):  # overlapped window, out of range
            with pytest.raises(ValueError):
                m.relabel(*bad)
        return _ints(rl), rl.evaluate(pt).to_int()

    got, want = _both(ops, 3)
    assert got == want


def test_z_ring_ops_and_relabel():
    def ops(pkg, cfg, rng):
        a = pkg.DenseMleZ(3, [rng.randrange(-100, 100) for _ in range(8)])
        b = pkg.DenseMleZ(3, [rng.randrange(-100, 100) for _ in range(8)])
        assert a + pkg.DenseMleZ.zero() == a
        rl = a.relabel(0, 2, 1)
        pz = [rng.randrange(-5, 5) for _ in range(3)]
        assert rl.evaluate(pz) == a.evaluate([pz[2], pz[1], pz[0]])
        assert (a + b).evaluations == [x + y for x, y in zip(a.evaluations, b.evaluations)]
        return [m.evaluations for m in (a + b, a - b, -a, a * 3, rl)] + [rl.evaluate(pz)]

    got, want = _both(ops, 4)
    assert got == want


def test_integer_eq_table_matches_field_eq_table():
    r_int = [random.Random(5).randrange(0, 50) for _ in range(4)]
    tbl_z = poly.build_eq_x_r_vec_z(r_int)
    assert tbl_z == jpoly.build_eq_x_r_vec_z(r_int)
    tbl_f = poly.build_eq_x_r_vec([CFG2.fp(v) for v in r_int])
    assert [CFG2.fp(v) for v in tbl_z] == tbl_f
    assert _ints(tbl_f) == _ints(jpoly.build_eq_x_r_vec([JCFG2.fp(v) for v in r_int]))
    for i, v in enumerate(tbl_z):
        expect = 1
        for j, rj in enumerate(r_int):
            expect *= rj if (i >> j) & 1 else 1 - rj
        assert v == expect
    mle = poly.build_eq_x_r_z(r_int)
    assert mle.num_vars == 4 and mle.evaluations == tbl_z


def test_rand_and_map_roundtrip():
    def ops(pkg, cfg, rng):
        m = pkg.DenseMleF.rand(3, cfg, rng)
        z = pkg.DenseMleZ(3, [rng.randrange(-10, 10) for _ in range(8)])
        f = z.map_to_field(cfg)
        assert len(m.evaluations) == 8 and f.num_vars == 3
        return _ints(m), _ints(f)

    got, want = _both(ops, 6)
    assert got == want


# ---------------------------------------------------------------------------
# sparse MLEs, index utils, virtual polynomials (tests/test_poly_extras.py)
# ---------------------------------------------------------------------------


def test_sparse_mle_matches_dense():
    def ops(pkg, cfg, rng):
        nv = 6
        entries = {rng.randrange(1 << nv): cfg.fp(rng.randrange(cfg.q)) for _ in range(10)}
        sp = pkg.SparseMleF(nv, entries, cfg)
        dn = sp.to_dense()
        pt, partial = _pt(cfg, rng, nv), _pt(cfg, rng, 3)
        assert sp.evaluate(pt) == dn.evaluate(pt)
        fixed = sp.fix_variables(partial).to_dense()
        assert fixed.evaluations == dn.fix_variables(partial).evaluations
        return sp.evaluate(pt).to_int(), _ints(fixed)

    assert ops(poly, CFG4, random.Random(0)) == ops(jpoly, JCFG4, random.Random(0))
    # a matrix's column-major flattening (the Vitalik R1CS's A over the field)
    m = ccs.vitalik_fixture(3)[1].map_to_field(CFG4).constraints[0]
    jm = jccs.vitalik_fixture(3)[1].map_to_field(JCFG4).constraints[0]
    sp = poly.SparseMleF.from_matrix(m, CFG4)
    assert sp.to_dense() == poly.DenseMleF.from_matrix(m, CFG4)
    assert (sp.num_vars, _entries(sp)) == (6, _entries(jpoly.SparseMleF.from_matrix(jm, JCFG4)))


def test_sparse_mle_z_projection():
    def ops(pkg, cfg, rng):
        nv = 5
        spz = pkg.SparseMleZ(nv, {rng.randrange(1 << nv): rng.randrange(-1000, 1000)
                                  for _ in range(8)})
        pt_int = [rng.randrange(100) for _ in range(nv)]
        ev = spz.map_to_field(cfg).evaluate([cfg.fp(v) for v in pt_int])
        assert cfg.fp(spz.evaluate(pt_int)) == ev
        return spz.evaluate(pt_int), ev.to_int()

    assert ops(poly, CFG4, random.Random(1)) == ops(jpoly, JCFG4, random.Random(1))


def test_random_mle_list_sum():
    def ops(pkg, cfg, rng):
        mles, total = pkg.random_mle_list(4, 3, rng, cfg)
        acc = cfg.zero()
        for b in range(1 << 4):
            prod = cfg.one()
            for m in mles:
                prod = prod * m.evaluations[b]
            acc = acc + prod
        assert acc == total
        zeros = pkg.random_zero_mle_list(4, 3, rng, cfg)
        for b in range(1 << 4):
            prod = cfg.one()
            for m in zeros:
                prod = prod * m.evaluations[b]
            assert prod.is_zero()
        return [_ints(m) for m in mles + zeros], total.to_int()

    assert ops(poly, CFG4, random.Random(2)) == ops(jpoly, JCFG4, random.Random(2))


def test_fix_last_variables_against_full_eval():
    def ops(pkg, cfg, rng):
        nv = 5
        p = pkg.DenseMleF(nv, _pt(cfg, rng, 1 << nv), cfg)
        pt = _pt(cfg, rng, nv)
        out = []
        for k in range(nv + 1):
            partial = pkg.fix_last_variables(p, pt[nv - k :])
            assert partial.num_vars == nv - k
            assert pkg.evaluate_opt(partial, pt[: nv - k]) == p.evaluate(pt)
            out.append(_ints(partial))
        assert pkg.fix_variables(p, pt[:2]).evaluations == p.fix_variables(pt[:2]).evaluations
        return out

    assert ops(poly, CFG4, random.Random(3)) == ops(jpoly, JCFG4, random.Random(3))


def test_merge_and_batched_nv():
    def ops(pkg, cfg, rng):
        nv = 3
        polys = [pkg.DenseMleF(nv, _pt(cfg, rng, 1 << nv), cfg) for _ in range(3)]
        merged = pkg.merge_polynomials(polys, cfg)
        assert merged.num_vars == pkg.get_batched_nv(nv, 3) == nv + 2
        for i, p in enumerate(polys):
            assert merged.evaluations[i * (1 << nv) : (i + 1) * (1 << nv)] == p.evaluations
        with pytest.raises(ValueError):
            pkg.merge_polynomials(polys + [pkg.DenseMleF(2, _pt(cfg, rng, 4), cfg)], cfg)
        return _ints(merged)

    assert ops(poly, CFG4, random.Random(4)) == ops(jpoly, JCFG4, random.Random(4))


def test_index_utils():
    assert poly.bit_decompose(0b1011, 4) == [True, True, False, True]
    assert poly.project(poly.bit_decompose(0b1011, 4)) == 0b1011
    assert poly.get_index(0b101, 3) == (0b010, 0b011, True)
    for i in range(64):
        assert poly.get_index(i, 6) == jpoly.get_index(i, 6)
        assert poly.bit_decompose(i, 7) == jpoly.bit_decompose(i, 7)
    for n in range(1, 40):
        assert poly.get_batched_nv(5, n) == jpoly.get_batched_nv(5, n)
    pt = [CFG4.fp(3), CFG4.fp(9)]
    got = poly.gen_eval_point(0b110, 3, pt, CFG4)
    assert _ints(got) == _ints(jpoly.gen_eval_point(0b110, 3, [JCFG4.fp(3), JCFG4.fp(9)], JCFG4))
    assert _ints(got) == [3, 9, 0, 1, 1]


def test_identity_permutation_mles():
    mles = poly.identity_permutation_mles(2, 2, CFG4)
    assert _ints(mles[0]) == [0, 1, 2, 3] and _ints(mles[1]) == [4, 5, 6, 7]
    assert _ints(poly.identity_permutation(2, 2, CFG4)) == list(range(8))
    perm = poly.random_permutation(2, 2, random.Random(5), CFG4)
    assert sorted(_ints(perm)) == list(range(8))
    assert _ints(perm) == _ints(jpoly.random_permutation(2, 2, random.Random(5), JCFG4))
    pm = poly.random_permutation_mles(3, 2, random.Random(6), CFG4)
    assert [_ints(m) for m in pm] == [
        _ints(m) for m in jpoly.random_permutation_mles(3, 2, random.Random(6), JCFG4)]


def test_random_mle_list_z_sum():
    def ops(pkg, rng):
        mles, total = pkg.random_mle_list_z(4, 3, rng, bits=32)
        acc = 0
        for b in range(1 << 4):
            prod = 1
            for m in mles:
                prod *= m.evaluations[b]
            acc += prod
        assert acc == total
        zeros = pkg.random_zero_mle_list_z(4, 3, rng, bits=32)
        for b in range(1 << 4):
            assert zeros[0].evaluations[b] * zeros[1].evaluations[b] == 0
        return [m.evaluations for m in mles + zeros], total

    assert ops(poly, random.Random(11)) == ops(jpoly, random.Random(11))


def test_fix_last_variables_z_matches_field_side():
    """ℤ fix-last projected into the field equals the field fix-last of the
    projected polynomial, and both equal the JAX package's."""
    rng = random.Random(12)
    nv = 5
    evals = [rng.randrange(-(1 << 40), 1 << 40) for _ in range(1 << nv)]
    pt_int = [rng.randrange(-(1 << 20), 1 << 20) for _ in range(3)]
    fixed_z = poly.fix_last_variables_z(poly.DenseMleZ(nv, evals), pt_int)
    fixed_f = poly.fix_last_variables(poly.DenseMleZ(nv, evals).map_to_field(CFG4),
                                      [CFG4.fp(v) for v in pt_int])
    assert fixed_z.num_vars == fixed_f.num_vars == nv - 3
    assert [CFG4.fp(v) for v in fixed_z.evaluations] == fixed_f.evaluations
    assert fixed_z.evaluations == jpoly.fix_last_variables_z(jpoly.DenseMleZ(nv, evals),
                                                             pt_int).evaluations
    assert poly.fix_variables_z(poly.DenseMleZ(nv, evals), pt_int).evaluations == \
        jpoly.fix_variables_z(jpoly.DenseMleZ(nv, evals), pt_int).evaluations


def test_merge_and_permutations_z():
    def ops(pkg, rng):
        nv = 3
        polys = [pkg.DenseMleZ(nv, [rng.randrange(-100, 100) for _ in range(1 << nv)])
                 for _ in range(3)]
        merged = pkg.merge_polynomials_z(polys)
        assert merged.num_vars == pkg.get_batched_nv(nv, 3)
        assert merged.evaluations[3 * (1 << nv) :] == [0] * ((1 << merged.num_vars) - 3 * (1 << nv))
        mles = pkg.identity_permutation_mles_z(2, 2)
        assert [m.evaluations for m in mles] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert pkg.identity_permutation_z(2, 2) == list(range(8))
        perm = pkg.random_permutation_z(2, 2, rng)
        assert sorted(perm) == list(range(8))
        return (merged.evaluations, perm,
                [m.evaluations for m in pkg.random_permutation_mles_z(2, 3, rng)])

    assert ops(poly, random.Random(13)) == ops(jpoly, random.Random(13))


def test_evaluate_opt_z_matches_field():
    rng = random.Random(14)
    nv = 4
    evals = [rng.randrange(-(1 << 30), 1 << 30) for _ in range(1 << nv)]
    pt = [rng.randrange(-(1 << 10), 1 << 10) for _ in range(nv)]
    got = poly.evaluate_opt_z(poly.DenseMleZ(nv, evals), pt)
    assert got == jpoly.evaluate_opt_z(jpoly.DenseMleZ(nv, evals), pt)
    assert CFG4.fp(got) == poly.DenseMleZ(nv, evals).map_to_field(CFG4).evaluate(
        [CFG4.fp(v) for v in pt])


def test_instance_z_trait_and_bigint_serializer():
    st = Statement(constraints=[], public_input=[7, 9])
    assert isinstance(st, InstanceZ)
    assert st.get_z_vector([3, 4]) == [7, 9, 1, 3, 4] == \
        JStatement(constraints=[], public_input=[7, 9]).get_z_vector([3, 4])
    rng = random.Random(15)
    for v in [(1 << 200) + 12345, 0, (1 << 256) - 1] + [rng.getrandbits(256) for _ in range(20)]:
        blob = limbs.bigint_serialize(v, 4)
        assert blob == jlimbs.bigint_serialize(v, 4) and len(blob) == 32
        assert limbs.bigint_deserialize(blob, 4) == v
    assert limbs.bigint_serialize((1 << 200) + 12345, 4)[:8] == (12345).to_bytes(8, "little")
    with pytest.raises(ValueError):
        limbs.bigint_serialize(1 << 256, 4)
    with pytest.raises(ValueError):
        limbs.bigint_serialize(-1, 4)
    with pytest.raises(ValueError):
        limbs.bigint_deserialize(bytes(31), 4)


# ---------------------------------------------------------------------------
# sparse-MLE trait completions (tests/test_sparse_mle_ops.py)
# ---------------------------------------------------------------------------


def test_rand_with_config_counts_and_range():
    def ops(pkg, cfg, rng):
        m = pkg.SparseMleF.rand_with_config(6, 9, cfg, rng)
        assert m.num_vars == 6 and len(m.entries) == 9 and all(i < 64 for i in m.entries)
        d = pkg.SparseMleF.rand(8, cfg, rng)
        assert len(d.entries) == 16  # sqrt(2^8)
        with pytest.raises(ValueError):
            pkg.SparseMleF.rand_with_config(2, 5, cfg, rng)
        return _entries(m), _entries(d)

    got, want = _both(ops, 42)
    assert got == want


def test_sparse_relabel_matches_dense():
    def ops(pkg, cfg, rng):
        m = pkg.SparseMleF.rand_with_config(5, 7, cfg, rng)
        rl = m.relabel(0, 3, 2)
        assert rl.to_dense() == m.to_dense().relabel(0, 3, 2)
        pt = _pt(cfg, rng, 5)
        assert rl.evaluate(pt) == m.evaluate([pt[3], pt[4], pt[2], pt[0], pt[1]])
        with pytest.raises(ValueError):
            m.relabel(0, 2, 3)
        return _entries(rl), rl.evaluate(pt).to_int()

    got, want = _both(ops, 43)
    assert got == want


def test_sparse_ring_ops_match_dense():
    def ops(pkg, cfg, rng):
        a = pkg.SparseMleF.rand_with_config(4, 5, cfg, rng)
        b = pkg.SparseMleF.rand_with_config(4, 5, cfg, rng)
        r = cfg.fp(rng.randrange(cfg.q))
        outs = [a + b, a - b, -a, a * r]
        dense = [a.to_dense() + b.to_dense(), a.to_dense() - b.to_dense(), -(a.to_dense()),
                 a.to_dense() * r]
        assert all(o.to_dense() == d for o, d in zip(outs, dense))
        assert a.to_evaluations() == a.to_dense().evaluations
        with pytest.raises(ValueError):
            _ = a + pkg.SparseMleF.rand_with_config(3, 2, cfg, rng)
        return [_entries(o) for o in outs]

    got, want = _both(ops, 44)
    assert got == want


def test_sparse_z_ops():
    for pkg in (poly, jpoly):
        a = pkg.SparseMleZ(3, {1: 4, 6: -2})
        b = pkg.SparseMleZ(3, {1: -4, 3: 9})
        assert (a + b).entries == {3: 9, 6: -2}  # the index-1 entries cancel to zero
        assert (a - a).entries == {}
        assert (a * 3).entries == {1: 12, 6: -6}
        assert a.relabel(0, 1, 1).entries == {2: 4, 5: -2}
        assert a.to_evaluations() == [0, 4, 0, 0, 0, 0, -2, 0]
        assert a.fix_variables([2]).entries == {0: 8, 3: 2}  # (1 - 2)·(-2) at index 3


# ---------------------------------------------------------------------------
# the host helpers of fields/limbs.py and ccs/utils.py
# ---------------------------------------------------------------------------


def test_find_naf_usefulness_and_correctness():
    """12 has NAF length 5 and relaxed length 4; both recodings sum back to
    the input and equal the JAX package's for random 256-bit values."""
    assert len(limbs.find_naf(12)) == 5 and len(limbs.find_relaxed_naf(12)) == 4
    rng = random.Random(9)
    for num in [0, 1, 7, 12] + [rng.getrandbits(256) for _ in range(10)]:
        naf, relaxed = limbs.find_naf(num), limbs.find_relaxed_naf(num)
        assert naf == jlimbs.find_naf(num) and relaxed == jlimbs.find_relaxed_naf(num)
        for digits in (naf, relaxed):
            assert all(d in (-1, 0, 1) for d in digits)
            assert sum(d << i for i, d in enumerate(digits)) == num
        assert all(not (naf[i] and naf[i + 1]) for i in range(len(naf) - 1))
    with pytest.raises(ValueError):
        limbs.find_naf(-1)


def test_vec_utils():
    assert utils.vec_add([1, 2], [3, 4]) == [4, 6]
    assert utils.vec_scalar_mul([1, 2, 3], 5) == [5, 10, 15]
    assert utils.hadamard([2, 3], [4, 5]) == [8, 15]
    for bad in (utils.vec_add, utils.hadamard):
        with pytest.raises(ValueError):
            bad([1], [1, 2])
    rng = random.Random(16)
    a = [CFG2.fp(rng.randrange(Q2)) for _ in range(8)]
    b = [CFG2.fp(rng.randrange(Q2)) for _ in range(8)]
    ja, jb = [JCFG2.fp(v.to_int()) for v in a], [JCFG2.fp(v.to_int()) for v in b]
    assert _ints(utils.hadamard(a, b)) == _ints(jutils.hadamard(ja, jb))
    assert _ints(utils.vec_add(a, b)) == _ints(jutils.vec_add(ja, jb))
    assert _ints(utils.vec_scalar_mul(a, b[0])) == _ints(jutils.vec_scalar_mul(ja, jb[0]))
    m = utils.SparseMatrix(2, 3, [[(5, 0), (-1, 2)], [(7, 1)]])
    assert utils.mat_vec_mul(m, [1, 2, 3]) == jutils.mat_vec_mul(
        jutils.SparseMatrix(2, 3, [[(5, 0), (-1, 2)], [(7, 1)]]), [1, 2, 3]) == [2, 14]
