"""The port's device-resident Fiat-Shamir: its sponge (``ops/keccak_kernel.py``),
the round step ``fs_round`` (``sumcheck/device_fs.py``), and the drivers
on one device and on a mesh, against the JAX package's device sponge and
device-FS sumcheck, its host prover, and the port's host transcript.
Every comparison is exact.  The card's cases (``fs_round`` and the
kernels' r-on-the-card forms against their plain versions, the enqueue loop
under ``torch.cuda.set_sync_debug_mode("error")``) are in
``tests/test_torch_kernels.py``, which imports no jax, as the card's
machine has none.
"""

import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zinc_tpu.fields.config import FieldConfig as JFieldConfig
from zinc_tpu.ops import keccak_kernel as jkk
from zinc_tpu.poly.device import fps_to_limbs as j_fps_to_limbs
from zinc_tpu.poly.mle import DenseMleF as JDenseMleF
from zinc_tpu.poly.mle import build_eq_x_r as j_build_eq_x_r
from zinc_tpu.sumcheck.device_fs import prove_as_subprotocol_device_fs as j_prove_fs
from zinc_tpu.sumcheck.prover import prove_as_subprotocol as j_prove
from zinc_tpu.transcript import KeccakTranscript as JKeccakTranscript
from zinc_tpu_torch.fields import montgomery as fm
from zinc_tpu_torch.fields.config import FieldConfig
from zinc_tpu_torch.hashing import keccak
from zinc_tpu_torch.ops import keccak_kernel as kk
from zinc_tpu_torch.parallel import Mesh
from zinc_tpu_torch.sumcheck import device_fs as dfs
from zinc_tpu_torch.sumcheck.device import prove_as_subprotocol_device
from zinc_tpu_torch.sumcheck.executor import SUMCHECKS, make_executor
from zinc_tpu_torch.transcript import KeccakTranscript

Q = (1 << 255) + 95
CFG, JCFG = FieldConfig(Q, 4), JFieldConfig(Q, 4)
# every regime of get_challenge: n64 = 1; q under 2^128 (127 and 128 bits);
# under 2^256 (192 bits, and 2^255 + 95); from 2^256 on (n64 = 8)
REGIMES = [((1 << 61) - 1, 1), ((1 << 127) - 1, 2), ((1 << 128) - 159, 2), ((1 << 191) + 5, 3),
           (Q, 4), ((1 << 511) + 187, 8)]


def _bytes(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8)


def _sponge_after(prefix: bytes, impl=keccak.Keccak256Py):
    h = impl()
    h.update(prefix)
    return h, kk.DeviceSponge.from_host(h)


# ---------------------------------------------------------------------------
# the sponge
# ---------------------------------------------------------------------------

LENGTHS = (0, 1, 135, 136, 137, 700)  # no block, one byte, and one to six blocks crossed


@pytest.mark.parametrize("n", LENGTHS)
def test_sponge_absorb_and_digest_at_every_position_match_the_host(n):
    """From each fill level 0..135, absorbing n bytes leaves the host
    hasher's state and digest."""
    data = _bytes(n, n)
    for pos in range(kk.RATE):
        h, sp = _sponge_after(bytes(_bytes(1000 + pos, pos)))
        assert sp.pos == pos
        out = sp.absorb(torch.from_numpy(data.astype(np.int64)))
        h.update(data.tobytes())
        assert out.pos == len(h._buf)
        assert bytes(out.digest().tolist()) == h.digest()
        back = keccak.Keccak256Py()
        out.export_to_host(back)
        assert back._state == h._state and back._buf == h._buf


@pytest.mark.parametrize("n", LENGTHS)
def test_sponge_matches_the_jax_device_sponge(n):
    """absorb and digest against the reference's absorb_dyn / digest_dyn
    (its dynamic-position sponge) at start positions across a block, and the
    permutation against keccak_f1600_device."""
    data = _bytes(2 * n + 1, n)
    jabsorb = jax.jit(jkk.absorb_dyn)
    jdigest = jax.jit(jkk.digest_dyn)
    for pos in (0, 1, 7, 8, 67, 128, 134, 135):
        _, sp = _sponge_after(bytes(_bytes(2000 + pos, 136 + pos)))
        lanes, buf = kk.unpack_state(sp.state)
        jl = jnp.asarray(lanes.numpy().astype(np.uint32))
        jb = jnp.asarray(buf.numpy().astype(np.uint8))
        jl, jb, jpos = jabsorb(jl, jb, jnp.int32(pos), jnp.asarray(data))
        lanes, buf, p = kk.absorb(lanes, buf, pos, torch.from_numpy(data.astype(np.int64)))
        assert p == int(jpos)
        assert np.array_equal(lanes.numpy(), np.asarray(jl).astype(np.int64))
        assert np.array_equal(buf[:p].numpy(), np.asarray(jb)[:p].astype(np.int64))
        assert np.array_equal(kk.digest(lanes, buf, p).numpy(),
                              np.asarray(jdigest(jl, jb, jpos)).astype(np.int64))
    lanes = torch.from_numpy(np.random.default_rng(n).integers(0, 1 << 32, (25, 2)))
    want = jkk.keccak_f1600_device(jnp.asarray(lanes.numpy().astype(np.uint32)))
    assert np.array_equal(kk.keccak_f1600(lanes).numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("impl", ["native", "python"])
def test_device_sponge_moves_both_host_backends(impl):
    """DeviceSponge.from_host / export_to_host for the native-backed hasher
    (ctypes lanes) and the pure-Python one (a list), at several fill levels;
    the exported hasher goes on as the original does."""
    cls = keccak.Keccak256 if impl == "native" else keccak.Keccak256Py
    for n in (0, 5, 135, 136, 400):
        h, sp = _sponge_after(bytes(_bytes(n, n)), cls)
        back = cls()
        sp.export_to_host(back, kk.pack_state(*kk.unpack_state(sp.state), sp.pos).numpy()
                          .view(np.uint32))
        assert type(back._state) is type(h._state)
        assert list(back._state) == list(h._state) and back._buf == h._buf
        back.update(b"more")
        h.update(b"more")
        assert back.digest() == h.digest()


# ---------------------------------------------------------------------------
# fs_round against the host transcript
# ---------------------------------------------------------------------------


def _rand_fps(cfg, rng, n):
    return [cfg.fp(rng.randrange(cfg.q)) for _ in range(n)]


def _words(cfg, fps):
    return fm.to_tensor(fm.ints_to_words([x.m for x in fps], 2 * cfg.n64))


@pytest.mark.parametrize("q,n64", REGIMES)
@pytest.mark.parametrize("blocks,gruen", [(1, False), (4, False), (1, True), (4, True)])
def test_fs_round_matches_the_host_transcript(q, n64, blocks, gruen):
    """One device round in plain torch against the host: Σ_D residues,
    s(t) = Σ coeff·res (Gruen: pref ratcheted by eq(β_{j−1}, r_{j−1}),
    times pref·c_j(t)), absorb_field_slice, get_challenge, absorb_field."""
    cfg = FieldConfig(q, n64)
    ctx = fm.device_field(cfg)
    rng = random.Random(q % 1000 + 10 * blocks + gruen)
    n_terms, n_pts, rnd = 2, 4, 2
    sums = [[_rand_fps(cfg, rng, n_pts) for _ in range(n_terms)] for _ in range(blocks)]
    coeffs = _rand_fps(cfg, rng, n_terms)
    beta, rs = _rand_fps(cfg, rng, rnd + 1), _rand_fps(cfg, rng, rnd + 1)
    pref = cfg.fp(rng.randrange(q))
    t = KeccakTranscript()
    t.absorb(bytes(_bytes(q % 97, 57 + q % 50)))

    state = kk.DeviceSponge.from_host(t.h)
    sums_t = torch.stack([torch.stack([_words(cfg, pts) for pts in blk]) for blk in sums])
    evals = torch.zeros((rnd + 1, n_pts, ctx.n32), dtype=torch.int32)
    rs_t = _words(cfg, rs)
    beta_t, pref_t = (_words(cfg, beta), _words(cfg, [pref])[0]) if gruen else (None, None)
    dfs.fs_round(ctx, state.state, state.pos, sums_t, _words(cfg, coeffs), evals, rs_t, rnd,
                 beta_t, pref_t)

    one = cfg.one()
    if gruen:
        pref = pref * ((one - beta[rnd - 1]) * (one - rs[rnd - 1]) + beta[rnd - 1] * rs[rnd - 1])
    want = []
    for p in range(n_pts):
        acc = cfg.zero()
        for k in range(n_terms):
            res = cfg.zero()
            for blk in sums:
                res = res + blk[k][p]
            acc = acc + coeffs[k] * res
        if gruen:
            tf = cfg.fp(p)
            acc = pref * ((one - beta[rnd]) * (one - tf) + beta[rnd] * tf) * acc
        want.append(acc)
    t.absorb_field_slice(want)
    r = t.get_challenge(cfg)
    t.absorb_field(r)
    assert torch.equal(evals[rnd], _words(cfg, want))
    assert torch.equal(rs_t[rnd], _words(cfg, [r])[0])
    assert torch.equal(rs_t[:rnd], _words(cfg, rs[:rnd]))  # only row rnd is written
    if gruen:
        assert torch.equal(pref_t, _words(cfg, [pref])[0])
    state.pos = (state.pos + dfs.round_absorb_bytes(cfg, n_pts - 1)) % kk.RATE
    assert state.pos == len(t.h._buf)
    assert torch.equal(state.state, kk.DeviceSponge.from_host(t.h).state)


def test_fs_round_rejects_bad_inputs():
    ctx = fm.device_field(CFG)
    sp = kk.DeviceSponge.from_host(keccak.Keccak256Py())
    sums = torch.zeros((1, 1, 3, 8), dtype=torch.int32)
    coeffs, evals, rs = (torch.zeros(s, dtype=torch.int32) for s in ((1, 8), (2, 3, 8), (2, 8)))
    with pytest.raises(ValueError):
        dfs.fs_round(ctx, sp.state, 136, sums, coeffs, evals, rs, 0)  # fill level past the rate
    with pytest.raises(ValueError):
        dfs.fs_round(ctx, sp.state, 0, sums, coeffs, evals, rs, 2)  # no row 2
    with pytest.raises(ValueError):
        dfs.fs_round(ctx, sp.state, 0, sums, coeffs[:, :4], evals, rs, 0)
    with pytest.raises(ValueError):
        dfs.fs_round(ctx, sp.state, 0, sums, coeffs, evals, rs, 0, beta=rs)  # beta without pref
    with pytest.raises(ValueError):
        dfs.fs_round(ctx, sp.state[:50], 0, sums, coeffs, evals, rs, 0)
    with pytest.raises(ValueError):  # more terms than the kernel's lanes
        dfs.fs_round(ctx, sp.state, 0, sums.expand(1, 33, 3, 8), coeffs.expand(33, 8), evals, rs,
                     0)


# ---------------------------------------------------------------------------
# the warp-spread permutation of csrc/keccak.cuh, modelled on the CPU
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def _cuh_table(name: str) -> np.ndarray:
    """The per-lane table ``name`` of csrc/keccak.cuh, as the kernel reads it."""
    src = (Path(kk.__file__).resolve().parent.parent / "csrc" / "keccak.cuh").read_text()
    body = re.search(rf"\b{name}\[\d+\] = \{{([^}}]*)\}}", src).group(1)
    return np.array([int(x.strip().rstrip("u"), 0) for x in body.split(",") if x.strip()],
                    dtype=np.uint64)


def _funnel_l(lo: np.ndarray, hi: np.ndarray, n) -> np.ndarray:
    """__funnelshift_l(lo, hi, n): the top 32 bits of (hi:lo) << (n mod 32)."""
    n = np.asarray(n, dtype=np.uint64) & np.uint64(31)
    return (((hi << np.uint64(32) | lo) << n) >> np.uint64(32)) & np.uint64(M32)


def _warp_f1600(lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """keccak_f1600_warp on the 32 lanes' (lo, hi) registers, a shuffle from
    lane k being an index by k, with keccak_lanes' sources and the ρ, π and
    ι tables parsed out of the header."""
    rho, pi, rc = (_cuh_table(n) for n in ("keccak_rho", "keccak_pi_src", "keccak_rc"))
    lane = np.arange(32)
    l = np.where(lane < 25, lane, lane - 25)
    x, y = l % 5, l // 5
    cols = [x + 5 * ((y + 1 + i) % 5) for i in range(4)]
    src = pi[l].astype(np.int64)
    rot = rho[src]
    chi1, chi2 = (x + 1) % 5 + 5 * y, (x + 2) % 5 + 5 * y
    first = lane == 0
    for rnd in range(24):
        cl, ch = lo.copy(), hi.copy()
        for c in cols:
            cl, ch = cl ^ lo[c], ch ^ hi[c]
        pl, ph = cl[(x + 1) % 5], ch[(x + 1) % 5]
        lo = lo ^ cl[(x + 4) % 5] ^ _funnel_l(ph, pl, 1)
        hi = hi ^ ch[(x + 4) % 5] ^ _funnel_l(pl, ph, 1)
        bl, bh = lo[src], hi[src]
        swap = (rot & np.uint64(32)) != 0
        sl, sh = np.where(swap, bh, bl), np.where(swap, bl, bh)
        bl, bh = _funnel_l(sh, sl, rot), _funnel_l(sl, sh, rot)
        lo = bl ^ (~bl[chi1] & bl[chi2] & np.uint64(M32)) ^ np.where(first, rc[2 * rnd], 0)
        hi = bh ^ (~bh[chi1] & bh[chi2] & np.uint64(M32)) ^ np.where(first, rc[2 * rnd + 1], 0)
    return lo, hi


def test_warp_keccak_schedule_matches_the_permutation():
    """The lane tables of csrc/keccak.cuh and the warp's round schedule give
    Keccak-f[1600] (hashing/keccak.py) on random states; lanes 25-31 hold
    what lanes 0-6 held and are never read by a real lane."""
    rng = np.random.default_rng(60)
    for _ in range(4):
        state = [int(v) for v in rng.integers(0, 1 << 64, 25, dtype=np.uint64)]
        want = list(state)
        keccak.keccak_f1600(want)
        lo = np.array([v & M32 for v in state] + [0xDEADBEEF] * 7, dtype=np.uint64)
        hi = np.array([v >> 32 for v in state] + [0x01234567] * 7, dtype=np.uint64)
        glo, ghi = _warp_f1600(lo, hi)
        assert [int(a) | int(b) << 32 for a, b in zip(glo[:25], ghi[:25])] == want


def test_keccak_tables_follow_fips_202():
    """ρ offsets from the (t+1)(t+2)/2 walk, π sources as the inverse of
    x + 5y → y + 5·((2x + 3y) mod 5), ι as the reference's round constants."""
    rho = [0] * 25
    x, y = 1, 0
    for t in range(24):
        rho[x + 5 * y] = (t + 1) * (t + 2) // 2 % 64
        x, y = y, (2 * x + 3 * y) % 5
    assert _cuh_table("keccak_rho").tolist() == rho
    src = [0] * 25
    for x in range(5):
        for y in range(5):
            src[y + 5 * ((2 * x + 3 * y) % 5)] = x + 5 * y
    assert _cuh_table("keccak_pi_src").tolist() == src
    rc = _cuh_table("keccak_rc").tolist()
    assert [lo | hi << 32 for lo, hi in zip(rc[::2], rc[1::2])] == list(keccak._RC)


@pytest.mark.parametrize("n64", [3, 4, 8])
def test_fs_permutations_count_the_sponges_blocks(n64, monkeypatch):
    """bench_kernels.fs_permutations is the number of Keccak-f calls the
    plain round makes, in every case of fs_cases and at every fill level."""
    from zinc_tpu_torch.benches.bench_kernels import field_of_words, fs_cases, fs_permutations

    calls = []
    real = kk.keccak_f1600
    monkeypatch.setattr(kk, "keccak_f1600", lambda lanes: calls.append(1) or real(lanes))
    ctx = fm.device_field(field_of_words(2 * n64))
    cases = fs_cases(ctx, "cpu")
    for c in cases:
        calls.clear()
        dfs.fs_round_plain(ctx, *c["inputs"]())
        assert len(calls) == c["permutations"], c["shape"]
    args = list(cases[0]["inputs"]())
    for pos in range(0, kk.RATE, 7):
        calls.clear()
        dfs.fs_round_plain(ctx, *(args[:1] + [pos] + args[2:]))
        assert len(calls) == fs_permutations(2 * n64, 4, pos)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------


def _tables(cfg, nv, n, seed):
    """n tables of 2^nv Montgomery residues (as ints)."""
    rng = random.Random(seed)
    return [[rng.randrange(cfg.q) for _ in range(1 << nv)] for _ in range(n)]


def _port_tables(cfg, vals):
    return torch.stack([fm.to_tensor(fm.ints_to_words(v, 2 * cfg.n64)) for v in vals])


def _ints(proof, rnd, finals, t, cfg):
    return ([[x.m for x in e] for e in proof], [x.m for x in rnd],
            [(m[0] if isinstance(m, list) else m).m for m in finals], t.h.digest(),
            t.get_challenge(cfg).m)


def _port_fs(cfg, vals, nv, degree, comb, beta=None, mesh=None, prefix=b"device-fs"):
    t = KeccakTranscript()
    t.absorb(prefix)
    SUMCHECKS.clear()
    tabs = _port_tables(cfg, vals)
    out = dfs.prove_as_subprotocol_device_fs(t, cfg, tabs, nv, degree, comb, eq_beta=beta, mesh=mesh)
    assert [(r["driver"], r["fetches"]) for r in SUMCHECKS] == [("device_fs", 1)]
    return _ints(*out, t, cfg)


def test_classic_fs_sumcheck_matches_the_jax_device_fs():
    """The classic tier at nv = 10 against the reference's own device-FS
    driver (its XLA round body on the CPU): the same proof, randomness,
    final values and transcript state."""
    nv = 10
    vals = _tables(CFG, nv, 3, 10)
    comb_spec = [(1, (0, 1)), (-1, (2, 0)), (9, (0, 2))]
    port = _port_fs(CFG, vals, nv, 2, [(CFG.fp(c), t) for c, t in comb_spec])
    jt = JKeccakTranscript()
    jt.absorb(b"device-fs")
    stacked = jnp.stack([jnp.asarray(j_fps_to_limbs([JCFG.fp_from_mont(v) for v in tab], JCFG))
                         for tab in vals])
    jcomb = [(JCFG.fp(c), t) for c, t in comb_spec]
    jproof, jrs, jmles = j_prove_fs(jt, JCFG, stacked, nv, 2, jcomb)
    assert port == _ints(jproof, jrs, jmles, jt, JCFG)


def _host_prover(jcfg, vals, nv, degree, comb_spec, beta=None, prefix=b"device-fs"):
    jt = JKeccakTranscript()
    jt.absorb(prefix)
    jmles = [JDenseMleF(nv, [jcfg.fp_from_mont(v) for v in tab], jcfg) for tab in vals]
    if beta is not None:
        jmles.append(j_build_eq_x_r([jcfg.fp(b) for b in beta], jcfg))
    jproof, state = j_prove(jt, jmles, nv, degree, [(jcfg.fp(c), t) for c, t in comb_spec], jcfg)
    return _ints(jproof, state.randomness, [m.evaluations[0] for m in state.mles], jt, jcfg)


CASES = {
    # name: (q, n64, nv, tables, degree, comb, Gruen)
    "gruen": (Q, 4, 10, 3, 3, [(1, (0, 1, 3)), (-1, (2, 3))], True),
    "generic": (Q, 4, 10, 5, 5, [(1, (0, 1, 2, 3, 4)), (-1, (3, 4))], False),
    "classic_128bit": ((1 << 128) - 159, 2, 11, 2, 2, [(1, (0, 1))], False),
    "gruen_128bit": ((1 << 128) - 159, 2, 11, 3, 3, [(1, (0, 1, 3)), (-1, (2, 3))], True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fs_sumcheck_matches_the_jax_host_prover(name):
    """Gruen (eq factored out, pref ratcheted on the device), the generic
    tier (K7/K9, then K10 fused with the fold) and 128-bit fields against
    the JAX host prover; then the per-round driver on the same tables."""
    q, n64, nv, n_tab, degree, comb_spec, gruen = CASES[name]
    cfg, jcfg = FieldConfig(q, n64), JFieldConfig(q, n64)
    vals = _tables(cfg, nv, n_tab, nv + n_tab)
    beta = [random.Random(7).randrange(q) for _ in range(nv)] if gruen else None
    comb = [(cfg.fp(c), t) for c, t in comb_spec]
    eq_beta = [cfg.fp(b) for b in beta] if gruen else None
    port = _port_fs(cfg, vals, nv, degree, comb, eq_beta)
    assert port == _host_prover(jcfg, vals, nv, degree, comb_spec, beta)
    t = KeccakTranscript()
    t.absorb(b"device-fs")
    assert port == _ints(*prove_as_subprotocol_device(t, cfg, _port_tables(cfg, vals), nv, degree,
                                                      comb, eq_beta=eq_beta), t, cfg)


@pytest.mark.parametrize("shape", ["4", "2x2"])
@pytest.mark.parametrize("gruen", [False, True])
def test_sharded_fs_driver_gives_the_single_device_bytes(shape, gruen):
    """Mesh(["cpu"] * 4) and a 2 × 2 mesh: the same proof, randomness,
    finals and transcript as one device; two rounds on the shards (blocks of
    256 and 128 entries), then the hand-over and two rounds on the first
    device, one fetch."""
    nv = 10
    mesh = Mesh(["cpu"] * 4) if shape == "4" else Mesh([["cpu"] * 2] * 2, ("r", "c"))
    vals = _tables(CFG, nv, 3, 30 + gruen)
    if gruen:
        comb_spec, degree = [(1, (0, 1, 3)), (-1, (2, 3))], 3
        beta = [CFG.fp(random.Random(8).randrange(Q)) for _ in range(nv)]
    else:
        comb_spec, degree, beta = [(1, (0, 1)), (5, (2,))], 2, None
    comb = [(CFG.fp(c), t) for c, t in comb_spec]
    sharded = _port_fs(CFG, vals, nv, degree, comb, beta, mesh)
    assert SUMCHECKS[-1]["sharded_rounds"] == 2
    assert SUMCHECKS[-1]["device_rounds"] == 4
    assert sharded == _port_fs(CFG, vals, nv, degree, comb, beta)


@pytest.mark.parametrize("k,blocks", [(4, 4), (3, 1)])
def test_make_executor_shards_where_the_mesh_divides(k, blocks):
    """``make_executor(..., mesh=)`` builds the executor over the mesh's
    shards: 4 blocks on 4 shards at 2^10; on 3 shards, which do not divide
    2^10, one block, whole, on the first device."""
    tables = torch.zeros((2, 1 << 10, 2 * CFG.n64), dtype=torch.int32)
    ex = make_executor(CFG, tables, 2, [(CFG.one(), (0, 1))], mesh=Mesh(["cpu"] * k))
    assert ex.n_blocks == len(ex.blocks) == blocks and ex.size == 1 << 10
    assert sum(b.shape[1] for b in ex.blocks) == 1 << 10


def test_golden_2p10_through_the_fs_driver():
    """ZincProver on the CPU reproduces tests/golden/proof_2p10.bin, and each
    of its sumchecks took the device-FS driver and fetched once."""
    import zinc_tpu_torch as zt
    from pathlib import Path

    _, ccs, st, wit = zt.dummy_ccs_of_size(1 << 10, random.Random(1234), int_bits=62)
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(st.public_input, t, 1, 4)
    SUMCHECKS.clear()
    proof = zt.ZincProver(zt.ZipTypes(1), device="cpu").prove(st, wit, t, ccs, cfg)
    golden = Path(__file__).resolve().parent / "golden" / "proof_2p10.bin"
    assert zt.serialize_proof(proof, cfg) == golden.read_bytes()
    assert [(r["driver"], r["device_rounds"], r["fetches"]) for r in SUMCHECKS] == \
        [("device_fs", 4, 1)] * 2


def test_golden_2p10_on_a_mesh_the_shards_do_not_divide():
    """ZincProver on 3 CPU shards, which do not divide 2^10, reproduces
    tests/golden/proof_2p10.bin, both sumchecks on the device-FS driver
    with one fetch and no sharded round (the tables stay whole on the
    first device)."""
    import zinc_tpu_torch as zt

    _, ccs, st, wit = zt.dummy_ccs_of_size(1 << 10, random.Random(1234), int_bits=62)
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(st.public_input, t, 1, 4)
    SUMCHECKS.clear()
    proof = zt.ZincProver(zt.ZipTypes(1), mesh=Mesh(["cpu"] * 3)).prove(st, wit, t, ccs, cfg)
    golden = Path(__file__).resolve().parent / "golden" / "proof_2p10.bin"
    assert zt.serialize_proof(proof, cfg) == golden.read_bytes()
    assert [(r["driver"], r["fetches"], r["sharded_rounds"]) for r in SUMCHECKS] == \
        [("device_fs", 1, 0)] * 2


def test_tables_at_most_host_tail_need_no_device_round():
    """nv = 6 (64 entries): no device round, the one fetch, the host rounds."""
    vals = _tables(CFG, 6, 2, 40)
    comb_spec = [(1, (0, 1))]
    port = _port_fs(CFG, vals, 6, 2, [(CFG.fp(c), t) for c, t in comb_spec])
    assert SUMCHECKS[-1]["device_rounds"] == 0
    assert port == _host_prover(JCFG, vals, 6, 2, comb_spec)
