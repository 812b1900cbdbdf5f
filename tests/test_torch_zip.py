"""The port's Zip PCS (zinc_tpu_torch.zip) against the JAX package's host
``zip.pcs`` at 2^10: commitment roots and Merkle layers, opening bytes, and
the port's verifier; the column records' packer against the host
``open_poly``.  Exact equality throughout."""

import random

import numpy as np
import pytest
import torch

from zinc_tpu.fields.config import FieldConfig as JFieldConfig
from zinc_tpu.fields.integers import combine_rows_signed as j_combine
from zinc_tpu.fields.integers import i64_to_mag8 as j_i64_to_mag8
from zinc_tpu.fields.integers import ints_to_mag8 as j_ints_to_mag8
from zinc_tpu.poly.mle import DenseMleZ as JDenseMleZ
from zinc_tpu.zip import pcs as jpcs
from zinc_tpu.zip.code import DefaultLinearCodeSpec as JSpec
from zinc_tpu.zip.code import RaaCode as JRaaCode
from zinc_tpu.zip.code import ZipTypes as JZipTypes
from zinc_tpu.zip.merkle import MerkleTree as JMerkleTree
from zinc_tpu.zip.merkle import int_to_leaf_bytes as j_int_to_leaf_bytes
from zinc_tpu.zip.transcript import PcsTranscript as JPcsTranscript
from zinc_tpu_torch.fields.config import FieldConfig
from zinc_tpu_torch.poly.mle import DenseMleZ
from zinc_tpu_torch.zip.code import DefaultLinearCodeSpec, RaaCode, ZipTypes
from zinc_tpu_torch.zip.transcript import PcsTranscript
from zinc_tpu_torch.fields import montgomery as fm
from zinc_tpu_torch.fields.integers import (combine_rows_signed, int_vector, vector_to_mag8,
                                            vector_to_words)
from zinc_tpu_torch.ops.field_map import vector_to_field
from zinc_tpu_torch.zip import pcs
from zinc_tpu_torch.ops import _cuda
from zinc_tpu_torch.ops.blake3 import merkle_tree_device
from zinc_tpu_torch.ops.zip_records import pack_records, pack_records_plain, record_bytes
from zinc_tpu_torch.zip.device import (RECORDS, DeviceZipData, _column_records, commit_device,
                                       open_device, reset_records)

Q = (1 << 255) + 95
NV = 10


class _Seeds:
    """Fixed permutation seeds for the RAA code (no transcript needed)."""

    def __init__(self):
        self.counter = 0

    def get_u64(self):
        self.counter += 1
        return self.counter


def _params(mod, spec, code_cls, zt_cls):
    code = code_cls(spec(), 1 << NV, _Seeds(), zt_cls(1))
    return mod.setup(1 << NV, code, zt_cls(1))


def _poly(seed):
    rng = random.Random(seed)
    return [rng.randrange(-(1 << 62), 1 << 62) for _ in range(1 << NV)]


def test_commit_roots_and_layers_match_host():
    vals = _poly(1)
    jpp = _params(jpcs, JSpec, JRaaCode, JZipTypes)
    jdata, jcomm = jpcs.commit(jpp, JDenseMleZ(NV, vals))
    pp = _params(pcs, DefaultLinearCodeSpec, RaaCode, ZipTypes)
    data, comm = commit_device(pp, np.array(vals, np.int64), FieldConfig(Q, 4), "cpu")
    assert comm.roots == jcomm.roots
    enc = data.enc.numpy().view(np.uint32)  # (R, cw, 8) words
    cw = pp.code.codeword_len()
    width = 1 << 256
    assert [int.from_bytes(enc[r, c].astype("<u4").tobytes(), "little")
            for r in range(2) for c in range(cw)] == [v % width for v in jdata.rows[: 2 * cw]]
    for r, tree in enumerate(jdata.trees):
        flat = b"".join(
            layer[r].numpy().astype("<u4").tobytes() for layer in data.layers[:-1]
        )
        assert flat == b"".join(tree.layers)


def test_open_bytes_match_host_and_verify():
    vals = _poly(2)
    rng = random.Random(3)
    point_ints = [rng.randrange(Q) for _ in range(NV)]

    jcfg = JFieldConfig(Q, 4)
    jpp = _params(jpcs, JSpec, JRaaCode, JZipTypes)
    jpoly = JDenseMleZ(NV, vals)
    jdata, _ = jpcs.commit(jpp, jpoly)
    jt = JPcsTranscript()
    jpcs.open_poly(jpp, jpoly, jdata, [jcfg.fp_from_mont(x) for x in point_ints], jcfg, jt)

    cfg = FieldConfig(Q, 4)
    pp = _params(pcs, DefaultLinearCodeSpec, RaaCode, ZipTypes)
    z = np.array(vals, np.int64)
    data, comm = commit_device(pp, z, cfg, "cpu")
    t = PcsTranscript()
    point = [cfg.fp_from_mont(x) for x in point_ints]
    reset_records()
    open_device(pp, z, vector_to_field(cfg, int_vector(vals), "cpu"), data, point, cfg, t)
    proof = t.into_proof()
    assert proof == jt.into_proof()
    assert RECORDS == {"card": 0, "plain": 1, "bytes": 0, "staging": 0}

    v = DenseMleZ(NV, vals).map_to_field(cfg).evaluate(point)
    pcs.verify_poly(pp, comm, point, v, PcsTranscript.from_proof(proof), cfg, "cpu")
    with pytest.raises(pcs.PcsError):
        pcs.verify_poly(pp, comm, point, v + cfg.one(), PcsTranscript.from_proof(proof), cfg, "cpu")
    bad = bytearray(proof)
    bad[len(bad) // 3] ^= 0x10  # inside the column records
    with pytest.raises(pcs.PcsError):
        pcs.verify_poly(pp, comm, point, v, PcsTranscript.from_proof(bytes(bad)), cfg, "cpu")


def test_combine_rows_signed_matches_jax():
    import jax.numpy as jnp

    rng = random.Random(4)
    r, c = 64, 16
    coeffs = [rng.randrange(-(1 << 63), 1 << 63) for _ in range(r)]
    evals = np.array([[rng.randrange(-(1 << 62), 1 << 62) for _ in range(c)] for _ in range(r)],
                     np.int64)
    evals[0, 0], evals[1, 1] = -(1 << 63), (1 << 63) - 1
    c8, cs = vector_to_mag8(int_vector(coeffs), 8)
    e8, es = vector_to_mag8(evals, 8)
    got = combine_rows_signed(torch.from_numpy(c8), torch.from_numpy(cs),
                              torch.from_numpy(e8), torch.from_numpy(es), 16).numpy()
    jc8, jcs = j_ints_to_mag8(coeffs, 8)
    je8, jes = j_i64_to_mag8(evals)
    want = np.asarray(j_combine(jnp.asarray(jc8), jnp.asarray(jcs), jnp.asarray(je8),
                                jnp.asarray(jes), 32))
    width = 1 << 512
    for col in range(c):
        exact = sum(coeffs[i] * int(evals[i, col]) for i in range(r)) % width
        assert int.from_bytes(got[col].astype("<u4").tobytes(), "little") == exact
        assert int.from_bytes(want[col].astype("<u2").tobytes(), "little") == exact


@pytest.mark.parametrize("kind", ["int64", "wide"])
def test_integer_entries_match_jax(kind):
    """``vector_to_words`` and ``vector_to_mag8`` on an ``int_vector`` of
    int64 values and of wide ones against the JAX package's pairs
    (``i64_to_limbs``/``ints_to_limbs``, ``i64_to_mag8``/``ints_to_mag8``):
    the same two's-complement words, magnitudes and signs."""
    from zinc_tpu.fields.limbs import i64_to_limbs as j_i64_to_limbs
    from zinc_tpu.fields.limbs import ints_to_limbs as j_ints_to_limbs

    rng = random.Random(5)
    bits = 62 if kind == "int64" else 200
    vals = [0, 1, -1] + [rng.randrange(-(1 << bits), 1 << bits) for _ in range(29)]
    vals += [-(1 << 63), (1 << 63) - 1] if kind == "int64" else [1 << 63, -(1 << 255)]
    vec = int_vector(vals)
    assert vec.dtype == (np.int64 if kind == "int64" else object)
    n_words, n8 = 8, 32
    words = vector_to_words(vec, n_words, "cpu").numpy().astype(np.uint32)
    want = j_i64_to_limbs(vec, 2 * n_words) if kind == "int64" else j_ints_to_limbs(vals, 2 * n_words)
    assert np.array_equal(words, fm.from_jax_limbs(want))
    mags, signs = vector_to_mag8(vec, n8)
    jmags, jsigns = j_i64_to_mag8(vec) if kind == "int64" else j_ints_to_mag8(vals, n8)
    assert mags.dtype == np.uint8 and np.array_equal(mags, jmags)
    assert np.array_equal(signs, jsigns)


def _zlc_pair(n):
    """The JAX package's and the port's ZipLinearCode over n entries, from
    the same transcript (tests/test_zip_device.py:124's case)."""
    from zinc_tpu.transcript import KeccakTranscript as JKeccakTranscript
    from zinc_tpu.zip.code import ZipLinearCode as JZipLinearCode
    from zinc_tpu_torch.transcript import KeccakTranscript
    from zinc_tpu_torch.zip.code import ZipLinearCode

    jt, t = JKeccakTranscript(), KeccakTranscript()
    jt.absorb(b"zlc-dev")
    t.absorb(b"zlc-dev")
    jpp = jpcs.setup(n, JZipLinearCode(JSpec(), n, jt, JZipTypes(1)), JZipTypes(1))
    return jpp, pcs.setup(n, ZipLinearCode(DefaultLinearCodeSpec(), n, t, ZipTypes(1)), ZipTypes(1))


def test_zip_linear_code_commit_and_open_match_host():
    """The ZipLinearCode on the device (one exact float64 product with its
    dense 0/1 matrix): codewords, roots and opening bytes equal the JAX
    package's host commit and ``open_poly``; the verifier (whose encode is
    host code for either code) accepts and rejects a flipped byte."""
    nv = 6
    jpp, pp = _zlc_pair(1 << nv)
    rng = random.Random(31)
    vals = [rng.randrange(-(1 << 60), 1 << 60) for _ in range(1 << nv)]
    point_ints = [rng.randrange(Q) for _ in range(nv)]
    jcfg, cfg = JFieldConfig(Q, 4), FieldConfig(Q, 4)
    jdata, jcomm = jpcs.commit(jpp, JDenseMleZ(nv, vals))
    jt = JPcsTranscript()
    jpcs.open_poly(jpp, JDenseMleZ(nv, vals), jdata, [jcfg.fp_from_mont(x) for x in point_ints],
                   jcfg, jt)

    z = np.array(vals, np.int64)
    data, comm = commit_device(pp, z, cfg, "cpu")
    assert comm.roots == jcomm.roots
    enc = data.enc.numpy().view(np.uint32)
    width = 1 << (64 * pp.zt.k_words)
    assert [int.from_bytes(enc[r, c].astype("<u4").tobytes(), "little")
            for r in range(pp.num_rows) for c in range(pp.code.codeword_len())] == \
        [v % width for v in jdata.rows]
    t = PcsTranscript()
    point = [cfg.fp_from_mont(x) for x in point_ints]
    open_device(pp, z, vector_to_field(cfg, int_vector(vals), "cpu"), data, point, cfg, t)
    proof = t.into_proof()
    assert proof == jt.into_proof()
    v = DenseMleZ(nv, vals).map_to_field(cfg).evaluate(point)
    pcs.verify_poly(pp, comm, point, v, PcsTranscript.from_proof(proof), cfg, "cpu")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 0x01
    with pytest.raises(pcs.PcsError):
        pcs.verify_poly(pp, comm, point, v, PcsTranscript.from_proof(bytes(bad)), cfg, "cpu")


def test_single_row_layout_verifies():
    """``setup`` gives one row when the code's row_len covers the whole
    polynomial (a code built for 16 entries, row_len 4, over 4 entries).  A
    proof of the JAX host PCS in that layout (no proximity rows; the field
    phase checks each opened value against the re-encoded row, ``zip/pcs.py:
    467-475``) is accepted by the port's verifier and a flipped byte is
    rejected; the port's device commit and open give the same bytes."""
    seeds = _Seeds()
    jpp = jpcs.setup(4, JRaaCode(JSpec(), 16, seeds, JZipTypes(1)), JZipTypes(1))
    pp = pcs.setup(4, RaaCode(DefaultLinearCodeSpec(), 16, _Seeds(), ZipTypes(1)), ZipTypes(1))
    assert jpp.num_rows == pp.num_rows == 1 and pp.code.row_len == 4
    rng = random.Random(8)
    vals = [rng.randrange(-(1 << 62), 1 << 62) for _ in range(4)]
    point_ints = [rng.randrange(Q) for _ in range(2)]
    jcfg, cfg = JFieldConfig(Q, 4), FieldConfig(Q, 4)
    jdata, jcomm = jpcs.commit(jpp, JDenseMleZ(2, vals))
    jt = JPcsTranscript()
    jpcs.open_poly(jpp, JDenseMleZ(2, vals), jdata, [jcfg.fp_from_mont(x) for x in point_ints],
                   jcfg, jt)
    proof = jt.into_proof()

    point = [cfg.fp_from_mont(x) for x in point_ints]
    v = DenseMleZ(2, vals).map_to_field(cfg).evaluate(point)
    comm = pcs.ZipCommitment(jcomm.roots)
    pcs.verify_poly(pp, comm, point, v, PcsTranscript.from_proof(proof), cfg, "cpu")
    for pos in (10, len(proof) - 5):  # a column record; the evaluation row
        bad = bytearray(proof)
        bad[pos] ^= 0x01
        with pytest.raises(pcs.PcsError):
            pcs.verify_poly(pp, comm, point, v, PcsTranscript.from_proof(bytes(bad)), cfg, "cpu")

    z = np.array(vals, np.int64)
    data, dcomm = commit_device(pp, z, cfg, "cpu")
    t = PcsTranscript()
    open_device(pp, z, vector_to_field(cfg, int_vector(vals), "cpu"), data, point, cfg, t)
    assert dcomm.roots == jcomm.roots and t.into_proof() == proof


class _ColumnsOnly:
    """A code for ``open_poly`` whose opening is its column records and a
    field row of one entry a row: rows of one entry, no proximity rows,
    ``n_open`` columns of ``cw`` codewords."""

    row_len = 1

    def __init__(self, cw: int, n_open: int):
        self.cw, self.n_open = cw, n_open

    def codeword_len(self) -> int:
        return self.cw

    def num_proximity_testing(self) -> int:
        return 0

    def num_column_opening(self) -> int:
        return self.n_open


@pytest.mark.parametrize("kw32", [8, 16])
@pytest.mark.parametrize("depth", [0, 1, 8])
@pytest.mark.parametrize("rows", [1, 2, 128])
def test_column_records_match_open_poly(rows, depth, kw32):
    """The plain packer's records of R random codeword rows and their
    Merkle layers equal the bytes the JAX package's host ``open_poly``
    writes for the same rows and trees; the same rows cut into row blocks
    give the same records, each block's segment laid at its rows' offsets;
    each CPU open counts as ``plain`` and fetches nothing."""
    cw, n_open = 1 << depth, 40
    jzt = JZipTypes(kw32 // 8)
    rng = np.random.default_rng(1000 * rows + 10 * depth + kw32)
    words = rng.integers(0, 1 << 32, size=(rows, cw, kw32), dtype=np.uint64).astype(np.uint32)
    values = [int.from_bytes(words[r, c].astype("<u4").tobytes(), "little")
              for r in range(rows) for c in range(cw)]
    trees = [JMerkleTree.from_leaves(depth, [j_int_to_leaf_bytes(v, jzt.k_words)
                                             for v in values[r * cw : (r + 1) * cw]])
             for r in range(rows)]
    nv = rows.bit_length() - 1
    jcfg = JFieldConfig(Q, 4)
    jpp = jpcs.ZipParams(nv, rows, _ColumnsOnly(cw, n_open), jzt)
    jt = JPcsTranscript()
    jpcs.open_poly(jpp, JDenseMleZ(nv, list(range(rows))), jpcs.ZipCommitmentData(values, trees),
                   [jcfg.fp_from_mont(i + 2) for i in range(nv)], jcfg, jt)
    want = jt.into_proof()[: n_open * sum(record_bytes(rows, kw32, depth))]

    squeezes = JPcsTranscript()  # the columns open_poly squeezed: writes are not absorbed
    cols = np.array([squeezes.squeeze_challenge_idx(jcfg, cw) for _ in range(n_open)])
    enc = torch.from_numpy(words.view(np.int32))
    layers = merkle_tree_device(enc, jzt.k_words)
    reset_records()
    one = _column_records([DeviceZipData(enc, layers)], cols, depth)
    assert one.shape == (n_open, len(want) // n_open) and one.tobytes() == want
    assert torch.equal(pack_records_plain(enc, layers, torch.from_numpy(cols), depth),
                       torch.from_numpy(one))
    n_blocks = min(rows, 4)
    rb = rows // n_blocks
    blocks = [DeviceZipData(enc[i * rb : (i + 1) * rb], [x[i * rb : (i + 1) * rb] for x in layers])
              for i in range(n_blocks)]
    assert _column_records(blocks, cols, depth).tobytes() == want
    assert RECORDS == {"card": 0, "plain": 2, "bytes": 0, "staging": 0}


def test_records_wrapper_takes_the_plain_version_and_rejects_bad_inputs():
    enc = torch.zeros((2, 8, 8), dtype=torch.int32)
    layers = merkle_tree_device(enc, 4)
    cols = torch.tensor([0, 5, 7])
    _cuda.reset_launches()
    got = pack_records(enc, layers, cols, 3)
    assert torch.equal(got, pack_records_plain(enc, layers, cols, 3))
    assert got.shape == (3, sum(record_bytes(2, 8, 3))) and _cuda.LAUNCHES["zip_records"] == 0
    with pytest.raises(TypeError):
        pack_records(enc.to(torch.int64), layers, cols, 3)
    with pytest.raises(TypeError):
        pack_records(enc, layers, cols.to(torch.int32), 3)
    with pytest.raises(ValueError):
        pack_records(enc, layers, cols, 2)  # 8 codewords a row have paths of depth 3
    with pytest.raises(ValueError):
        pack_records(enc[:, :, :7], layers, cols, 3)  # an odd word count
    with pytest.raises(ValueError):
        pack_records(enc, [layers[0], layers[2], layers[1]], cols, 3)  # levels out of order
    with pytest.raises(ValueError):
        pack_records(enc, layers[:2], cols, 3)
