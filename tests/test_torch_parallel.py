"""The port's sharded prover (zinc_tpu_torch.parallel) against one device and
against the JAX package's ``parallel/``: meshes of CPU shards (an entry may
repeat a device), the JAX side on its 8 virtual CPU devices, as
tests/test_parallel.py runs it.  Every shard runs its own launches, sums,
gathers and hand-over, so the bytes are checked on every path the sharding
creates.  Exact equality throughout (residues and bytes)."""

import hashlib
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import zinc_tpu_torch as zt
from tests.golden.gen import N, SEED
from zinc_tpu.fields.config import FieldConfig as JFieldConfig
from zinc_tpu.parallel import local_mesh as j_local_mesh
from zinc_tpu.parallel import local_mesh_2d as j_local_mesh_2d
from zinc_tpu.parallel.sumcheck import ShardedSumcheckExecutor as JShardedExecutor
from zinc_tpu.parallel.zip import commit_device_sharded as j_commit_sharded
from zinc_tpu.parallel.zip import commit_device_sharded_2d as j_commit_sharded_2d
from zinc_tpu.poly.device import fps_to_limbs as j_fps_to_limbs
from zinc_tpu.sumcheck.device import prove_as_subprotocol_device as j_prove_with_executor
from zinc_tpu.transcript import KeccakTranscript as JKeccakTranscript
from zinc_tpu.zip.code import DefaultLinearCodeSpec as JSpec
from zinc_tpu.zip.code import RaaCode as JRaaCode
from zinc_tpu.zip.code import ZipTypes as JZipTypes
from zinc_tpu.zip import pcs as jpcs
from zinc_tpu_torch.fields import montgomery as fm
from zinc_tpu_torch.fields.config import FieldConfig
from zinc_tpu_torch.parallel import (
    Mesh,
    ShardedSumcheckExecutor,
    commit_device_sharded,
    commit_device_sharded_2d,
    local_mesh,
)
from zinc_tpu_torch.spartan_dev import z_to_device
from zinc_tpu_torch.sumcheck.executor import HOST_TAIL, make_executor, prove_with_executor
from zinc_tpu_torch.zip import pcs
from zinc_tpu_torch.zip.code import DefaultLinearCodeSpec, RaaCode, ZipTypes
from zinc_tpu_torch.zip.device import commit_device, open_device
from zinc_tpu_torch.zip.transcript import PcsTranscript

GOLDEN = Path(__file__).resolve().parent / "golden" / "proof_2p10.bin"
Q = (1 << 255) + 95
CPU = torch.device("cpu")


def cpu_mesh(d: int) -> Mesh:
    return Mesh([CPU] * d)


def cpu_mesh_2d(r: int, c: int) -> Mesh:
    return Mesh(np.array([CPU] * (r * c), dtype=object).reshape(r, c), ("r", "c"))


def _prove(ccs, statement, wit, mesh, n64=4):
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, 1, n64)
    proof = zt.ZincProver(zt.ZipTypes(1), mesh=mesh).prove(statement, wit, t, ccs, cfg)
    return proof, cfg


# (mesh shape, the commit's layout at 2^10: 16 rows of a 128-entry codeword)
MESH_SHAPES = {
    "4-shards": ((4,), "4 row blocks"),
    "8-shards": ((8,), "8 row blocks"),
    "2x2": ((2, 2), "2 row blocks x 2 column blocks"),
    "2-shards": ((2,), "2 row blocks"),
    "6-shards": ((6,), "one device"),
    "16-shards": ((16,), "16 row blocks"),
    "1x4": ((1, 4), "1 row blocks x 4 column blocks"),
    "4x1": ((4, 1), "4 row blocks x 1 column blocks"),
    "2x4": ((2, 4), "2 row blocks x 4 column blocks"),
    "4x2": ((4, 2), "4 row blocks x 2 column blocks"),
    "3x2": ((3, 2), "one device"),
    "2x3": ((2, 3), "one device"),
}


@pytest.mark.parametrize("name", list(MESH_SHAPES))
def test_mesh_prove_reproduces_golden_2p10(name):
    """The 2^10 golden proof (the JAX host prover's bytes, which its own
    sharded prove reproduces: tests/test_parallel.py) from 1-D meshes of 2
    to 16 shards and 2-D meshes of 1 × 4 to 4 × 2; each sumcheck ran its
    rounds on the shards down to HOST_TAIL entries a shard (2 rounds each on
    4 shards: blocks of 256 and 128 entries, then the hand-over at 64; none
    where the shards do not divide 2^10), the commit ran in row blocks, or
    on one device where the rows or the codeword do not split; the verifier
    accepts."""
    shape, commit = MESH_SHAPES[name]
    mesh = cpu_mesh(shape[0]) if len(shape) == 1 else cpu_mesh_2d(*shape)
    _, ccs, statement, wit = zt.dummy_ccs_of_size(N, random.Random(SEED), int_bits=62)
    proof, cfg = _prove(ccs, statement, wit, mesh)
    assert zt.serialize_proof(proof, cfg) == GOLDEN.read_bytes()
    d = mesh.size
    rounds = 0 if N % d else max(0, N.bit_length() - d.bit_length() - HOST_TAIL.bit_length() + 1)
    assert mesh.stats["sharded_rounds"] == [rounds, rounds]
    assert mesh.stats["commit"] == [commit]
    zt.ZincVerifier(zt.ZipTypes(1), device="cpu").verify(statement, proof, zt.KeccakTranscript(),
                                                         ccs, cfg)


def test_mesh_path_a_hashes_to_the_pinned_digest():
    """Path A (sumcheck 1 on the generic tier: K7, then K10 on the shards)
    on 4 shards: the proof hashes to PATH_A_SHA256_2P10, the JAX host
    prover's bytes."""
    mesh = cpu_mesh(4)
    ccs, statement, wit = chip_smoke.degree4_fixture(1 << 10, 1234)
    proof, cfg = _prove(ccs, statement, wit, mesh)
    assert hashlib.sha256(zt.serialize_proof(proof, cfg)).hexdigest() == chip_smoke.PATH_A_SHA256_2P10
    assert mesh.stats["sharded_rounds"] == [2, 2]


def _tables(cfg, nv, n_tab, seed):
    rng = random.Random(seed)
    return [[rng.randrange(cfg.q) for _ in range(1 << nv)] for _ in range(n_tab)]


def _port_tables(cfg, vals):
    return torch.stack([fm.to_tensor(fm.ints_to_words(v, 2 * cfg.n64)) for v in vals])


def _drive(ex, nv, degree, cfg):
    proof, rnd = prove_with_executor(zt.KeccakTranscript(), ex, nv, degree, cfg)
    return ([[x.m for x in e] for e in proof], [x.m for x in rnd], [x.m for x in ex.final_values()])


def test_sharded_executor_matches_jax_sharded_executor():
    """A 3-factor combination over 2^10 entries (the classic tier: K2 + K3 on
    each shard) on 4 CPU shards against the JAX ``ShardedSumcheckExecutor``
    on ``local_mesh(4)``, each through its own per-round loop: the same
    round evaluations, randomness and final values."""
    nv, degree = 10, 3
    cfg, jcfg = FieldConfig(Q, 4), JFieldConfig(Q, 4)
    vals = _tables(cfg, nv, 3, 7)
    spec = [(1, (0, 1, 2)), (5, (1, 2))]
    ex = ShardedSumcheckExecutor(cfg, _port_tables(cfg, vals), degree,
                                 [(cfg.fp(c), t) for c, t in spec], cpu_mesh(4))
    assert ex.tier == "classic" and len(ex.blocks) == 4
    port = _drive(ex, nv, degree, cfg)
    assert ex.sharded_rounds == 2  # blocks of 256 and 128 entries; at 64 the hand-over

    jtabs = jnp.stack([jnp.asarray(j_fps_to_limbs([jcfg.fp_from_mont(x) for x in v], jcfg))
                       for v in vals])
    jex = JShardedExecutor(jcfg, jtabs, degree, [(jcfg.fp(c), t) for c, t in spec], j_local_mesh(4))
    jproof, jrnd = j_prove_with_executor(JKeccakTranscript(), jex, nv, degree, jcfg)
    jax_side = ([[x.m for x in e] for e in jproof], [x.m for x in jrnd],
                [x.m for x in jex.final_values()])
    assert port == jax_side


def test_sharded_gruen_matches_single_device_gruen():
    """Sumcheck 1's shape (A·B·eq − C·eq, Gruen, K4 against the slices of the
    eq levels) on 4 CPU shards against the same rounds on one device:
    identical round evaluations, randomness and final values (eq last)."""
    nv, degree = 10, 3
    cfg = FieldConfig(Q, 4)
    vals = _tables(cfg, nv, 3, 9)
    rng = random.Random(10)
    beta = [cfg.fp(rng.randrange(cfg.q)) for _ in range(nv)]
    comb = [(cfg.one(), (0, 1, 3)), (-cfg.one(), (2, 3))]
    sharded = ShardedSumcheckExecutor(cfg, _port_tables(cfg, vals), degree, comb, cpu_mesh(4),
                                      eq_beta=beta)
    single = make_executor(cfg, _port_tables(cfg, vals), degree, comb, eq_beta=beta)
    assert sharded.tier == single.tier == "gruen"
    assert _drive(sharded, nv, degree, cfg) == _drive(single, nv, degree, cfg)
    assert sharded.sharded_rounds == 2 and single.sharded_rounds == 0


def _raa_params(n, seed, mod, spec, code_cls, zt_cls):
    class Seeds:
        counter = seed

        def get_u64(self):
            self.counter += 1
            return self.counter

    return mod.setup(n, code_cls(spec(), n, Seeds(), zt_cls(1)), zt_cls(1))


def _joined(data):
    blocks = data if isinstance(data, list) else [data]
    enc = torch.cat([b.enc for b in blocks]).numpy().view(np.uint32)
    layers = [torch.cat([b.layers[lvl] for b in blocks]).numpy().astype(np.uint32)
              for lvl in range(len(blocks[0].layers))]
    return enc, layers


@pytest.mark.parametrize("two_d", [False, True], ids=["rows", "rows x cols"])
def test_sharded_commit_matches_jax_sharded_commit(two_d):
    """The 1-D commit on 4 shards and the 2-D commit on 2 × 2 shards against
    the JAX package's ``commit_device_sharded`` on ``local_mesh(4)`` and
    ``commit_device_sharded_2d`` on ``local_mesh_2d(2, 2)`` at 2^10: equal
    codewords, Merkle layers and roots."""
    n = 1 << 10
    rng = random.Random(5)
    vals = [rng.randrange(-(1 << 62), 1 << 62) for _ in range(n)]
    jpp = _raa_params(n, 0, jpcs, JSpec, JRaaCode, JZipTypes)
    pp = _raa_params(n, 0, pcs, DefaultLinearCodeSpec, RaaCode, ZipTypes)
    jcfg, cfg = JFieldConfig(Q, 4), FieldConfig(Q, 4)
    z = np.array(vals, np.int64)
    if two_d:
        jdata, jcomm = j_commit_sharded_2d(jpp, z, jcfg, j_local_mesh_2d(2, 2))
        data, comm = commit_device_sharded_2d(pp, z, cfg, cpu_mesh_2d(2, 2))
    else:
        jdata, jcomm = j_commit_sharded(jpp, z, jcfg, j_local_mesh(4))
        data, comm = commit_device_sharded(pp, z, cfg, cpu_mesh(4))
    assert isinstance(data, list) and len(data) == (2 if two_d else 4)
    assert comm.roots == jcomm.roots
    enc, layers = _joined(data)
    assert np.array_equal(enc, fm.from_jax_limbs(jdata.enc_limbs))
    assert len(layers) == len(jdata.layers)
    for a, b in zip(layers, jdata.layers):
        assert np.array_equal(a, np.asarray(b, np.uint32))


@pytest.mark.parametrize("mesh", [cpu_mesh(4), cpu_mesh_2d(2, 2)], ids=["rows", "rows x cols"])
def test_sharded_zip_linear_code_commit(mesh):
    """The ZipLinearCode's commit on 4 row blocks and on 2 × 2 (each c shard
    takes its rows of the 0/1 matrix): the codewords, layers and roots of
    the one-device commit, which tests/test_torch_zip.py holds to JAX's."""
    from tests.test_torch_zip import _zlc_pair

    _, pp = _zlc_pair(1 << 8)
    rng = random.Random(12)
    z = np.array([rng.randrange(-(1 << 60), 1 << 60) for _ in range(1 << 8)], np.int64)
    cfg = FieldConfig(Q, 4)
    commit = commit_device_sharded_2d if len(mesh.axis_names) == 2 else commit_device_sharded
    want, want_comm = commit_device(pp, z, cfg, CPU)
    data, comm = commit(pp, z, cfg, mesh)
    assert "row blocks" in mesh.stats["commit"][0] and comm.roots == want_comm.roots
    enc, layers = _joined(data)
    want_enc, want_layers = _joined(want)
    assert np.array_equal(enc, want_enc)
    assert all(np.array_equal(a, b) for a, b in zip(layers, want_layers))


@pytest.mark.parametrize("mesh", [cpu_mesh(4), cpu_mesh_2d(2, 2)], ids=["rows", "rows x cols"])
def test_sharded_open_matches_one_device(mesh):
    """The open of a sharded commit (each row block's proximity accumulator
    and q₀-weighted sum added before one carry and one reduction; the
    column records gathered per block) writes the bytes of the one-device
    open, which the port's verifier accepts."""
    n, nv = 1 << 10, 10
    rng = random.Random(6)
    vals = [rng.randrange(-(1 << 62), 1 << 62) for _ in range(n)]
    z = np.array(vals, np.int64)
    cfg = FieldConfig(Q, 4)
    point = [cfg.fp(rng.randrange(Q)) for _ in range(nv)]
    pp = _raa_params(n, 3, pcs, DefaultLinearCodeSpec, RaaCode, ZipTypes)
    commit = commit_device_sharded_2d if len(mesh.axis_names) == 2 else commit_device_sharded
    proofs = []
    for data, comm in (commit_device(pp, z, cfg, CPU), commit(pp, z, cfg, mesh)):
        t = PcsTranscript()
        open_device(pp, z, z_to_device(cfg, vals, CPU), data, point, cfg, t)
        proofs.append((comm.roots, t.into_proof()))
    assert proofs[0] == proofs[1]
    from zinc_tpu_torch.poly.mle import DenseMleZ

    v = DenseMleZ(nv, vals).map_to_field(cfg).evaluate(point)
    pcs.verify_poly(pp, pcs.ZipCommitment(proofs[1][0]), point, v,
                    PcsTranscript.from_proof(proofs[1][1]), cfg, "cpu")


def test_uneven_meshes_run_on_the_first_device():
    """Rows that do not split over the mesh commit on its first device, as
    the reference's does, and a hypercube the mesh does not divide stays
    whole; the bytes stay the golden proof's."""
    mesh = cpu_mesh(3)
    _, ccs, statement, wit = zt.dummy_ccs_of_size(N, random.Random(SEED), int_bits=62)
    proof, cfg = _prove(ccs, statement, wit, mesh)
    assert zt.serialize_proof(proof, cfg) == GOLDEN.read_bytes()
    assert mesh.stats == {"sharded_rounds": [0, 0], "commit": ["one device"]}


def test_mesh_shapes_and_local_meshes():
    """A mesh holds devices along named axes; the prover refuses more than
    two axes; the card meshes raise without enough cards, as JAX's do."""
    m = cpu_mesh_2d(2, 2)
    assert m.shape == {"r": 2, "c": 2} and m.size == 4 and m.first == CPU
    with pytest.raises(ValueError):
        Mesh([CPU] * 4, ("a", "b"))
    with pytest.raises(ValueError):
        zt.ZincProver(zt.ZipTypes(1), mesh=Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 2, 2),
                                                ("a", "b", "c")))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="need"):
        local_mesh(have + 1)
