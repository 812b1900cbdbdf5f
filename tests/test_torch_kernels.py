"""The wrappers of the port's CUDA kernels (K1-K4, the generic tier,
fs_round, the BLAKE3 Merkle tree, the eq level and the Zip open's column
records), and the port's native host runtime.

On the CPU a wrapper takes the plain version, and only because its tensor
lies on the CPU; bad dtypes, shapes and combinations raise.  The cases
marked ``cuda`` hold each kernel against its plain version on the card
(fs_round in every challenge regime, fold and fold_round_eval with r on
the card against their host-word forms, the Merkle layers and eq levels at
the shapes that split them into launches), run the device-resident
Fiat-Shamir driver's enqueue loop under
``torch.cuda.set_sync_debug_mode("error")``, and skip without a card:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from zinc_tpu_torch import native
from zinc_tpu_torch.fields import montgomery as fm
from zinc_tpu_torch.fields.config import FieldConfig
from zinc_tpu_torch.ops import _cuda
from zinc_tpu_torch.ops import field_kernels as fk
from zinc_tpu_torch.sumcheck import kernels as sk

Q = (1 << 255) + 95


def _residues(ctx, shape, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=shape + (ctx.n32,), dtype=np.uint64).astype(np.uint32)
    words[..., -1] = rng.integers(0, int(ctx.q[-1]), size=shape, dtype=np.uint64).astype(np.uint32)
    return fm.to_tensor(words, device)


@pytest.fixture
def ctx():
    return fm.device_field(FieldConfig(Q, 4))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _cuda.build(_cuda.KERNEL_WORDS + (_cuda.BLAKE3,))  # every library at once (no-op once built)
    return "cuda"


def test_cpu_tensors_take_the_plain_versions(ctx):
    a, b = _residues(ctx, (64,), 0), _residues(ctx, (64,), 1)
    tabs = _residues(ctx, (3, 64), 2)
    e = _residues(ctx, (32,), 3)
    r = fm.to_numpy(_residues(ctx, (1,), 4))[0]
    _cuda.reset_launches()
    assert torch.equal(fk.mont_mul(ctx, a, b), fk.mont_mul_plain(ctx, a, b))
    assert torch.equal(sk.fold(ctx, tabs, r), sk.fold_plain(ctx, tabs, r))
    assert torch.equal(sk.round_eval(ctx, tabs, [(0, 1), (2, 1)], 3),
                       sk.round_eval_plain(ctx, tabs, [(0, 1), (2, 1)], 3))
    assert torch.equal(sk.round_eval_gruen(ctx, tabs, e, [(0, 1), (2,)], 4),
                       sk.round_eval_gruen_plain(ctx, tabs, e, [(0, 1), (2,)], 4))
    assert all(v == 0 for v in _cuda.LAUNCHES.values())
    assert _cuda._libs == {}  # nothing was built for CPU tensors


def test_wrappers_reject_bad_inputs(ctx):
    a = _residues(ctx, (8,), 5)
    tabs = _residues(ctx, (2, 8), 6)
    with pytest.raises(TypeError):
        fk.mont_mul(ctx, a.to(torch.int64), a)
    with pytest.raises(ValueError):
        fk.mont_mul(ctx, a[:, :4], a[:, :4])
    with pytest.raises(TypeError):
        sk.fold(ctx, tabs.to(torch.int64), fm.int_to_words(1, 8))
    with pytest.raises(ValueError):
        sk.fold(ctx, tabs[:, :7], fm.int_to_words(1, 8))  # odd length
    with pytest.raises(ValueError):
        sk.round_eval(ctx, tabs, [(0,)], 3)  # K3 takes 2-4 factors
    with pytest.raises(ValueError):
        sk.round_eval(ctx, tabs, [(0, 5)], 3)  # no table 5
    with pytest.raises(ValueError):
        sk.round_eval(ctx, tabs, [(0, 1)], 6)  # at most 5 points
    with pytest.raises(ValueError):
        sk.round_eval_gruen(ctx, tabs, a, [(0, 1)], 4)  # E level of the wrong length
    with pytest.raises(ValueError):
        sk.round_eval_gruen(ctx, tabs, a[:4], [(0, 1, 0, 1)], 4)  # K4 takes 1-3 factors


def test_generic_wrappers_take_the_plain_versions_on_cpu(ctx):
    tabs = _residues(ctx, (4, 64), 20)
    r = fm.to_numpy(_residues(ctx, (1,), 21))[0]
    terms = [(0, 1, 2, 3, 0, 1, 2), (3,)]
    _cuda.reset_launches()
    assert torch.equal(sk.round_eval_generic(ctx, tabs, terms, 9),
                       sk.round_eval_generic_plain(ctx, tabs, terms, 9))
    folded, sums = sk.fold_round_eval(ctx, tabs, r, terms, 8)
    assert torch.equal(folded, sk.fold_plain(ctx, tabs, r))
    assert torch.equal(sums, sk.round_eval_generic_plain(ctx, folded, terms, 8))
    assert all(v == 0 for v in _cuda.LAUNCHES.values())
    assert _cuda._libs == {}


def test_generic_wrappers_reject_bad_inputs(ctx):
    tabs = _residues(ctx, (2, 8), 22)
    r = fm.int_to_words(1, 8)
    with pytest.raises(ValueError):
        sk.round_eval_generic(ctx, tabs, [(0, 2)], 3)  # no table 2
    with pytest.raises(ValueError):
        sk.round_eval_generic(ctx, tabs, [(0,), ()], 3)  # an empty term
    with pytest.raises(ValueError):
        sk.round_eval_generic(ctx, tabs, [(0,)], 0)
    with pytest.raises(ValueError):
        sk.round_eval_generic(ctx, tabs, [(0,)] * 33, 2)  # over the launch's term slots
    with pytest.raises(ValueError):
        sk.fold_round_eval(ctx, tabs[:, :6], r, [(0,)], 2)  # not a multiple of 4
    with pytest.raises(TypeError):
        sk.fold_round_eval(ctx, tabs.to(torch.int64), r, [(0,)], 2)
    big = fm.device_field(FieldConfig((1 << 575) + 1515, 9))  # 18 words: no kernel width
    with pytest.raises(ValueError):
        sk.round_eval_generic(big, _residues(big, (1, 4), 23), [(0,)], 2)


def test_generic_scope():
    """The generic kernels take every combination their launch's parameter
    block holds, at up to ZT_GEN_MAX_POINTS points: shared memory bounds
    none (a block without room for its stage reads device memory)."""
    assert sk.generic_supported([tuple(range(8))], 9, 16)
    assert sk.generic_supported([(0,), (0, 1, 2, 3, 4)], 6, 8)
    assert sk.generic_supported([(0, 1)] * 32, 56, 8)
    assert sk.generic_supported([(0, 1)] * 32, 57, 8)
    assert sk.generic_supported([(0,)], 1024, 2) and not sk.generic_supported([(0,)], 1025, 2)
    assert not sk.generic_supported([(0,)], 2, 18)
    assert not sk.generic_supported([(0,) * 129, (1,) * 128], 2, 8)  # 257 factor slots
    # the limits come from the header generic.cu includes
    assert sk.GENERIC_LIMITS == {"ZT_GEN_BLOCK": 256, "ZT_GEN_PASS": 2, "ZT_GEN_PASS_WIDE": 1,
                                 "ZT_GEN_MAX_TERMS": 32, "ZT_GEN_MAX_ENTRIES": 256,
                                 "ZT_GEN_MAX_POINTS": 1024, "ZT_SMEM_LIMIT": 232_448}


@pytest.mark.parametrize(
    "k,n_pts,slots",
    [(7, 8, 8),  # path B: k + 1 == n_pts, values at t = 0..6 and the leading coefficient
     (5, 6, 6), (2, 6, 3),  # path A's terms: extended to 6 points
     (5, 3, 3), (3, 3, 3),  # n_pts ≤ k: the points themselves
     (1, 6, 2), (1, 2, 2), (1, 1, 1)],  # one factor: t = 0 and 1
)
def test_generic_term_slots(k, n_pts, slots):
    assert sk.generic_term_slots(k, n_pts) == slots


@pytest.mark.parametrize(
    "terms,n_pts,n32,n_tab,fold,passes,layout",
    [([(0, 1, 2, 3, 5), (4, 5)], 6, 8, 6, False, 5, (96, False)),  # path A: 3 + 2 passes, 2 sweeps
     ([(0, 1, 2, 3, 5), (4, 5)], 6, 8, 6, True, 5, (96, True)),  # K10 stages its fold
     ([tuple(range(7))], 8, 8, 7, True, 4, (128, True)),  # path B
     ([tuple(range(7))], 8, 16, 7, True, 8, (256, True)),  # passes of one above 8 words
     ([(0, 1)], 3, 8, 113, True, 2, (64, True)), ([(0, 1)], 3, 8, 114, True, 2, (64, False)),
     ([tuple(range(8))] * 32, 9, 8, 8, False, 160, (160, False))],  # 32 sweeps of 5 warps
)
def test_generic_layout_takes_a_warp_per_pass(terms, n_pts, n32, n_tab, fold, passes, layout):
    """A launch's block is a warp per pass of (up to) two evaluations, one
    above 8 words, as many warps as the term with the most passes has (the
    rest in later sweeps), and K10 stages its folded entries of 32 pairs of
    every table when they fit."""
    assert sk.generic_passes(terms, n_pts, n32) == passes
    assert sk.generic_layout(n32, sk.generic_warps(terms, n_pts, n32), n_tab, fold) == layout
    assert sk.generic_stage_bytes(8, 113) == 113 * 2 * 8 * 32 * 4 <= 232_448


def test_support_predicates_follow_the_reference():
    assert sk.classic_supported([(0, 3), (1, 2, 3)], 8)
    assert not sk.classic_supported([(0,)], 8) and not sk.classic_supported([(0, 1)], 18)
    assert sk.gruen_supported([(0, 1, 3), (2, 3)], 3, 8)
    assert not sk.gruen_supported([(0, 1, 2, 4, 3)], 3, 8)
    assert not sk.gruen_supported([(3, 0)], 3, 8)


def test_round_eval_scope_counts_the_launchs_slots():
    """K3/K4's scope and block come from one rule: a term of k factors takes
    k + 1 running sums of a block's shared memory, whatever the points."""
    assert sk.eval_slots([(0, 1)] * 32) == 96
    assert sk.eval_block(96, 8) == 32 and sk.eval_block(3, 8) == 256
    assert sk.eval_block(160, 8) == 0
    assert sk.classic_supported([(0, 1)] * 32, 8, 5)  # 96 slots, not 32 · 5
    assert not sk.classic_supported([(0, 1, 2, 3)] * 32, 8, 5)  # 160 slots
    assert sk.gruen_supported([(0, 3)] * 32, 3, 8, 5)
    assert not sk.classic_supported([(0, 1)] * 32, 16, 5)


@pytest.mark.parametrize(
    "terms,n_pts,gruen,per_pair",
    [([(0, 1)], 3, False, (0, 3)),  # K3 at the R1CS shape
     ([(0, 1), (2,)], 4, True, (2, 5)),  # K4 at the R1CS shape
     ([(0, 1, 2, 3, 5), (4, 5)], 6, False, (18, 9)),  # path A's combination
     ([tuple(range(7))], 8, False, (40, 8)),  # path B's
     ([(0,), (1, 2)], 4, False, (0, 3))],  # a lone factor needs no product
)
def test_bounds_count_what_the_round_needs(terms, n_pts, gruen, per_pair):
    """Every round kernel's bound counts the same products: a term of k
    factors at min(k + 1, n_pts) points, k − 2 Montgomery products and one
    unreduced product at each."""
    from zinc_tpu_torch.benches import bench_kernels as bk

    assert bk.round_products(1, terms, n_pts, gruen) == per_pair
    assert bk.round_products(1 << 19, terms, n_pts, gruen) == tuple(x << 19 for x in per_pair)


@pytest.mark.parametrize(
    "n,threads",
    [(513, 2), (16_000, 27), (32_000, 37), (32_000, 256), (1_024_000, 39), (1_024_000, 249),
     (1_024_000, 256)],
)
def test_native_batches_cover_their_tails(monkeypatch, n, threads):
    """The port's native runtime splits a batch over ``threads`` threads in
    16-aligned chunks (``csrc/zinc_native.cpp:zn_parallel_16aligned``).  With
    floor-division chunks the JAX package's copy left the tail of these
    batches to no thread; here every digest, the tail's included, equals the
    single-thread result."""
    rng = np.random.default_rng(n + threads)
    depth = 2
    leaves = rng.integers(0, 256, size=32 * n, dtype=np.uint8).tobytes()
    siblings = rng.integers(0, 256, size=32 * n * depth, dtype=np.uint8).tobytes()
    indices = rng.integers(0, 1 << depth, size=n).tolist()

    def run(nt):
        monkeypatch.setenv("ZINC_TPU_NATIVE_THREADS", str(nt))
        return (native.blake3_batch(leaves, n, 32),
                native.merkle_fold_batch(leaves, siblings, indices, depth))

    got, want = run(threads), run(1)
    assert got[0] is not None and got == want
    tail = [h[-32 * 16:] for h in got]  # the last 16-lane block
    assert all(t != bytes(len(t)) for t in tail)


def test_native_runtime_is_the_ports_own():
    """The port builds its own copy of the runtime, from its own source."""
    from pathlib import Path

    pkg = Path(native.__file__).parent
    assert Path(native._SRC) == pkg / "csrc" / "zinc_native.cpp"
    assert Path(native._lib_path()).parent == pkg / "_build"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


# one field per width the kernels take (n64 = 1..8), and a second 256-bit one
FIELDS = [((1 << 63) + 29, 1), ((1 << 127) - 1, 2), ((1 << 191) + 5, 3), ((1 << 255) + 95, 4),
          ((1 << 256) - 189, 4), ((1 << 319) + 9, 5), ((1 << 383) + 369, 6),
          ((1 << 447) + 99, 7), ((1 << 511) + 187, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,n64", FIELDS)
def test_kernels_match_plain_on_cuda(cuda_device, q, n64):
    c = fm.device_field(FieldConfig(q, n64))
    a, b = _residues(c, (4096,), 7, cuda_device), _residues(c, (4096,), 8, cuda_device)
    tabs = _residues(c, (4, 2048), 9, cuda_device)
    e = _residues(c, (1024,), 10, cuda_device)
    r = fm.to_numpy(_residues(c, (1,), 11))[0]
    assert torch.equal(fk.mont_mul(c, a, b), fk.mont_mul_plain(c, a, b))
    assert torch.equal(sk.fold(c, tabs, r), sk.fold_plain(c, tabs, r))
    for terms, pts in [([(0, 1)], 3), ([(0, 3), (1, 2, 3), (0, 1, 2, 3)], 5)]:
        assert torch.equal(sk.round_eval(c, tabs, terms, pts), sk.round_eval_plain(c, tabs, terms, pts))
    for terms, pts in [([(0, 1), (2,)], 4), ([(0, 1, 2)], 5)]:
        assert torch.equal(sk.round_eval_gruen(c, tabs, e, terms, pts),
                           sk.round_eval_gruen_plain(c, tabs, e, terms, pts))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_tensors_launch_the_kernels(cuda_device, ctx):
    a = _residues(ctx, (300,), 12, cuda_device)
    tabs = _residues(ctx, (2, 64), 13, cuda_device)
    _cuda.reset_launches()
    fk.mont_mul(ctx, a, a)
    sk.fold(ctx, tabs, fm.int_to_words(3, 8))
    sk.round_eval(ctx, tabs, [(0, 1)], 3)
    sk.round_eval_gruen(ctx, tabs, a[:32].contiguous(), [(0,), (1,)], 3)
    assert _cuda.LAUNCHES == {"mont_mul": 1, "fold": 1, "round_eval": 1, "round_eval_gruen": 1,
                              "round_eval_generic": 0, "fold_round_eval": 0, "fs_round": 0,
                              "blake3_leaves": 0, "blake3_merge": 0, "eq_table": 0,
                              "zip_records": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("n64", [3, 4])
@pytest.mark.parametrize("n_pairs", [1, 197, 4096, 135_169])
def test_round_evals_launch_once_per_round_on_cuda(cuda_device, n64, n_pairs):
    """K3 and K4 at 6 and 8 words, at the R1CS combinations and at wider
    ones: one launch for the whole combination and sums exactly equal to the
    plain versions'.  The pair counts leave lanes and blocks idle and give a
    thread several grid strides."""
    c = fm.device_field(FieldConfig({3: (1 << 191) + 5, 4: (1 << 255) + 95}[n64], n64))
    tabs = _residues(c, (4, 2 * n_pairs), 30, cuda_device)
    e = _residues(c, (n_pairs,), 31, cuda_device)
    for terms, pts in [([(0, 1)], 3), ([(0, 3), (1, 2, 3), (0, 1, 2, 3), (3, 3)], 5)]:
        _cuda.reset_launches()
        got = sk.round_eval(c, tabs, terms, pts)
        assert _cuda.LAUNCHES["round_eval"] == 1
        assert torch.equal(got, sk.round_eval_plain(c, tabs, terms, pts))
    for terms, pts in [([(0, 1), (2,)], 4), ([(0, 1, 2), (3,), (1, 1)], 5)]:
        _cuda.reset_launches()
        got = sk.round_eval_gruen(c, tabs, e, terms, pts)
        assert _cuda.LAUNCHES["round_eval_gruen"] == 1
        assert torch.equal(got, sk.round_eval_gruen_plain(c, tabs, e, terms, pts))


@pytest.mark.cuda
def test_round_evals_on_two_streams_on_cuda(cuda_device, ctx):
    """K3 and K4 launches in flight on two streams at once each count their
    own finished blocks, so every launch sums all of its blocks' rows."""
    tabs = _residues(ctx, (3, 1 << 16), 40, cuda_device)
    e = _residues(ctx, (1 << 15,), 41, cuda_device)
    want3 = sk.round_eval_plain(ctx, tabs, [(0, 1)], 3)
    want4 = sk.round_eval_gruen_plain(ctx, tabs, e, [(0, 1), (2,)], 4)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    s1.wait_stream(torch.cuda.current_stream())
    s2.wait_stream(torch.cuda.current_stream())
    got3, got4 = [], []
    for _ in range(16):
        with torch.cuda.stream(s1):
            got3.append(sk.round_eval(ctx, tabs, [(0, 1)], 3))
        with torch.cuda.stream(s2):
            got4.append(sk.round_eval_gruen(ctx, tabs, e, [(0, 1), (2,)], 4))
    torch.cuda.synchronize()
    assert all(torch.equal(g, want3) for g in got3)
    assert all(torch.equal(g, want4) for g in got4)


@pytest.mark.cuda
@pytest.mark.parametrize("q,n64", FIELDS)
@pytest.mark.parametrize("n_pairs", [1, 197, 4096, 135_169])
def test_generic_kernels_match_plain_on_cuda(cuda_device, q, n64, n_pairs):
    """Every factor count 1-8, 9 points, repeated factors, several terms, and
    pair counts that leave lanes and blocks idle; the last one is one pair
    more than a grid's threads, so a thread takes a second grid stride."""
    c = fm.device_field(FieldConfig(q, n64))
    tabs = _residues(c, (7, 4 * n_pairs), 24, cuda_device)
    r = fm.to_numpy(_residues(c, (1,), 25))[0]
    combs = [([tuple(range(7))], 8), ([(0, 1, 2, 3, 5), (4, 5)], 6), ([(2,)], 2),
             ([(6,), (0, 0), (1, 2, 3), (0, 1, 2, 3), (4, 5, 6, 0, 1), (1,) * 6,
               (2, 3, 4, 5, 6, 0, 1), tuple(range(7)) + (3,)], 9)]
    for terms, pts in combs:
        assert torch.equal(sk.round_eval_generic(c, tabs, terms, pts),
                           sk.round_eval_generic_plain(c, tabs, terms, pts))
        folded, sums = sk.fold_round_eval(c, tabs, r, terms, pts)
        want_f, want_s = sk.fold_round_eval_plain(c, tabs, r, terms, pts)
        assert torch.equal(folded, want_f) and torch.equal(sums, want_s)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n_pairs", [197, 4096])
def test_generic_kernels_in_sweeps_on_cuda(cuda_device, ctx, n_pairs):
    """Combinations of many sweeps: 160 passes in sweeps of 5 warps (K10's
    later sweeps read its folded entries back from its output), and K10 over
    200 tables with no stage (its output read back after the block's
    barrier)."""
    tabs = _residues(ctx, (8, 4 * n_pairs), 42, cuda_device)
    wide = [tuple((i + j) % 8 for i in range(8)) for j in range(32)]
    r = fm.to_numpy(_residues(ctx, (1,), 43))[0]
    assert sk.generic_passes(wide, 9, 8) == 160
    assert torch.equal(sk.round_eval_generic(ctx, tabs, wide, 9),
                       sk.round_eval_generic_plain(ctx, tabs, wide, 9))
    folded, sums = sk.fold_round_eval(ctx, tabs, r, wide, 9)
    want_f, want_s = sk.fold_round_eval_plain(ctx, tabs, r, wide, 9)
    assert torch.equal(folded, want_f) and torch.equal(sums, want_s)
    many = _residues(ctx, (200, 4 * n_pairs), 44, cuda_device)
    terms = [(0, 199), (7,), (3, 150, 9)]
    assert not sk.generic_layout(8, sk.generic_warps(terms, 4, 8), 200, True)[1]
    folded, sums = sk.fold_round_eval(ctx, many, r, terms, 4)
    want_f, want_s = sk.fold_round_eval_plain(ctx, many, r, terms, 4)
    assert torch.equal(folded, want_f) and torch.equal(sums, want_s)


@pytest.mark.cuda
def test_generic_kernels_on_two_streams_on_cuda(cuda_device, ctx):
    """round_eval_generic and fold_round_eval launches in flight on two
    streams at once each count their own finished blocks."""
    tabs = _residues(ctx, (7, 1 << 16), 45, cuda_device)
    r = fm.to_numpy(_residues(ctx, (1,), 46))[0]
    t7, t_a = [tuple(range(7))], [(0, 1, 2, 3, 5), (4, 5)]
    want_e = sk.round_eval_generic_plain(ctx, tabs, t7, 8)
    want_f = sk.fold_round_eval_plain(ctx, tabs, r, t_a, 6)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    s1.wait_stream(torch.cuda.current_stream())
    s2.wait_stream(torch.cuda.current_stream())
    got_e, got_f = [], []
    for _ in range(16):
        with torch.cuda.stream(s1):
            got_e.append(sk.round_eval_generic(ctx, tabs, t7, 8))
        with torch.cuda.stream(s2):
            got_f.append(sk.fold_round_eval(ctx, tabs, r, t_a, 6))
    torch.cuda.synchronize()
    assert all(torch.equal(g, want_e) for g in got_e)
    assert all(torch.equal(f, want_f[0]) and torch.equal(s, want_f[1]) for f, s in got_f)


@pytest.mark.cuda
def test_cuda_tensors_launch_the_generic_kernels(cuda_device, ctx):
    tabs = _residues(ctx, (3, 256), 26, cuda_device)
    _cuda.reset_launches()
    sk.round_eval_generic(ctx, tabs, [(0, 1, 2, 0, 1), (2,)], 6)
    sk.fold_round_eval(ctx, tabs, fm.int_to_words(3, 8), [(0, 1, 2, 0, 1), (2,)], 6)
    assert _cuda.LAUNCHES["round_eval_generic"] == 1 and _cuda.LAUNCHES["fold_round_eval"] == 1


@pytest.mark.cuda
def test_wrappers_launch_on_their_tensors_card_on_cuda(cuda_device, ctx):
    """Every wrapper on tensors of cuda:1 while cuda:0 is current launches on
    cuda:1 (its card made current, its current stream; the grid probes read
    that card) and equals its plain version; operands on two cards raise."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    other = torch.device("cuda", 1)
    a, b = _residues(ctx, (4096,), 40), _residues(ctx, (4096,), 41)
    tabs = _residues(ctx, (4, 2048), 42)
    e = _residues(ctx, (1024,), 43)
    r = fm.to_numpy(_residues(ctx, (1,), 44))[0]
    generic = [(0, 1, 2, 3, 0), (2,)]
    cases = [
        (lambda x, y, t, l: fk.mont_mul(ctx, x, y), fk.mont_mul_plain(ctx, a, b)),
        (lambda x, y, t, l: sk.fold(ctx, t, r), sk.fold_plain(ctx, tabs, r)),
        (lambda x, y, t, l: sk.round_eval(ctx, t, [(0, 1), (1, 2, 3)], 4),
         sk.round_eval_plain(ctx, tabs, [(0, 1), (1, 2, 3)], 4)),
        (lambda x, y, t, l: sk.round_eval_gruen(ctx, t, l, [(0, 1), (2,)], 4),
         sk.round_eval_gruen_plain(ctx, tabs, e, [(0, 1), (2,)], 4)),
        (lambda x, y, t, l: sk.round_eval_generic(ctx, t, generic, 6),
         sk.round_eval_generic_plain(ctx, tabs, generic, 6)),
        (lambda x, y, t, l: sk.fold_round_eval(ctx, t, r, generic, 6),
         sk.fold_round_eval_plain(ctx, tabs, r, generic, 6)),
    ]
    ins = [x.to(other) for x in (a, b, tabs, e)]
    with torch.cuda.device(0):
        for fn, want in cases:
            got = fn(*ins)
            torch.cuda.synchronize(other)
            for g, w in zip(_flat(got), _flat(want)):
                assert g.device == other and torch.equal(g.cpu(), w)
        with pytest.raises(ValueError):
            fk.mont_mul(ctx, a.to(cuda_device), ins[1])
        with pytest.raises(ValueError):
            sk.round_eval_gruen(ctx, ins[2], e.to("cuda:0"), [(0, 1)], 4)
    assert any(key[0] == other for key in sk._EVAL_GRID)
    assert any(key[0] == other for key in sk._GEN_PLAN)


def _flat(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.cuda
@pytest.mark.parametrize("spec,degree,gruen", [
    ([(1, (0, 1))], 2, False),  # sumcheck 2: K2 + K3
    ([(1, (0, 1, 3)), (-1, (2, 3))], 3, True),  # sumcheck 1: K2 + K4
    ([(1, (0, 1, 2, 3, 5)), (-1, (4, 5))], 5, False),  # path A: K7, K10
], ids=["classic", "gruen", "generic"])
def test_sharded_executor_on_one_card_on_cuda(cuda_device, spec, degree, gruen):
    """Four shards of one card (Mesh([cuda:0] * 4)) at 2^12: the sharded
    rounds (each shard's launches, the hand-over at 64 entries a shard)
    equal the single-device rounds: evaluations, randomness, final values."""
    from zinc_tpu_torch.parallel import Mesh, ShardedSumcheckExecutor
    from zinc_tpu_torch.sumcheck.executor import make_executor, prove_with_executor
    from zinc_tpu_torch.transcript import KeccakTranscript

    cfg = FieldConfig(Q, 4)
    c = fm.device_field(cfg)
    nv = 12
    n_tab = 1 + max(i for _, t in spec for i in t) - (1 if gruen else 0)
    tabs = _residues(c, (n_tab, 1 << nv), 45, cuda_device)
    rng = np.random.default_rng(46)
    beta = [cfg.fp(int(x)) for x in rng.integers(0, 1 << 62, nv)] if gruen else None
    comb = [(cfg.fp(k), t) for k, t in spec]

    def drive(ex):
        proof, rnd = prove_with_executor(KeccakTranscript(), ex, nv, degree, cfg)
        return [[x.m for x in e] for e in proof], [x.m for x in rnd], [x.m for x in ex.final_values()]

    sharded = ShardedSumcheckExecutor(cfg, tabs, degree, comb, Mesh([cuda_device] * 4), beta)
    assert drive(sharded) == drive(make_executor(cfg, tabs, degree, comb, beta))
    assert sharded.sharded_rounds == 4  # blocks of 1024 down to 128 entries


# ---------------------------------------------------------------------------
# device-resident Fiat-Shamir on the card (the CPU cases: test_torch_device_fs.py)
# ---------------------------------------------------------------------------

# every regime of get_challenge: n64 = 1; q under 2^128; under 2^256; from 2^256 on
FS_FIELDS = [((1 << 61) - 1, 1), ((1 << 127) - 1, 2), ((1 << 191) + 5, 3), (Q, 4),
             ((1 << 511) + 187, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("q,n64", FS_FIELDS)
def test_fs_round_matches_plain_on_cuda(cuda_device, q, n64):
    from zinc_tpu_torch.benches.bench_kernels import fs_cases
    from zinc_tpu_torch.sumcheck import device_fs as dfs

    c = fm.device_field(FieldConfig(q, n64))
    for case in fs_cases(c, cuda_device):
        got, want = case["inputs"](), case["inputs"]()
        _cuda.reset_launches()
        dfs.fs_round(c, *got)
        assert _cuda.LAUNCHES["fs_round"] == 1
        dfs.fs_round_plain(c, *want)
        for g, w in zip(got, want):
            if isinstance(g, torch.Tensor):
                assert torch.equal(g, w), case["shape"]


def _fs_equal(c, inputs) -> None:
    """fs_round on the card and its plain version on copies of ``inputs``:
    one launch, every tensor written equal word for word."""
    from zinc_tpu_torch.sumcheck import device_fs as dfs

    got, want = inputs(), inputs()
    _cuda.reset_launches()
    dfs.fs_round(c, *got)
    assert _cuda.LAUNCHES["fs_round"] == 1
    dfs.fs_round_plain(c, *want)
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("gruen", [False, True])
def test_fs_round_at_every_sponge_position_on_cuda(cuda_device, gruen):
    """The R1CS sumcheck-1 shape (2 terms, 4 points) at 8 words from every
    fill level 0..135 of the sponge, with and without Gruen's ratchet."""
    from zinc_tpu_torch.ops.keccak_kernel import RATE, STATE_WORDS

    c = fm.device_field(FieldConfig(Q, 4))
    rng = np.random.default_rng(90)
    state = fm.to_tensor(rng.integers(0, 1 << 32, STATE_WORDS, dtype=np.uint64).astype(np.uint32),
                         cuda_device)
    t = {k: _residues(c, shape, 91 + i, cuda_device) for i, (k, shape) in
         enumerate([("sums", (1, 2, 4)), ("coeffs", (2,)), ("evals", (3, 4)), ("rs", (3,)),
                    ("beta", (3,)), ("pref", (1,))])}
    for pos in range(RATE):
        def inputs(pos=pos):
            x = {k: v.clone() for k, v in t.items()}
            return (state.clone(), pos, x["sums"], x["coeffs"], x["evals"], x["rs"], 1,
                    x["beta"] if gruen else None, x["pref"][0] if gruen else None)

        _fs_equal(c, inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("terms,pts,blocks", [(32, 3, 1), (31, 4, 2), (1, 40, 1), (3, 33, 4)])
@pytest.mark.parametrize("n64", [3, 8])
def test_fs_round_at_many_terms_and_points_on_cuda(cuda_device, terms, pts, blocks, n64):
    """Gruen rounds whose terms fill the warp (32 terms: the ratchet takes a
    step of its own) and whose points take more than one group."""
    from zinc_tpu_torch.ops.keccak_kernel import STATE_WORDS

    c = fm.device_field(FieldConfig(*next(f for f in FS_FIELDS if f[1] == n64)))
    rng = np.random.default_rng(terms + pts)
    state = fm.to_tensor(rng.integers(0, 1 << 32, STATE_WORDS, dtype=np.uint64).astype(np.uint32),
                         cuda_device)
    base = [_residues(c, shape, 95 + i, cuda_device) for i, shape in
            enumerate([(blocks, terms, pts), (terms,), (4, pts), (4,), (4,), (1,)])]
    for rnd in (0, 2):
        def inputs(rnd=rnd):
            sums, coeffs, evals, rs, beta, pref = (x.clone() for x in base)
            return (state.clone(), 77, sums, coeffs, evals, rs, rnd, beta, pref[0])

        _fs_equal(c, inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("q,n64", FS_FIELDS)
def test_r_on_the_card_equals_host_words_on_cuda(cuda_device, q, n64):
    c = fm.device_field(FieldConfig(q, n64))
    tabs = _residues(c, (6, 4096), 40, cuda_device)
    r = fm.to_numpy(_residues(c, (1,), 41))[0]
    r_dev = fm.to_tensor(r, cuda_device)
    assert torch.equal(sk.fold(c, tabs, r_dev), sk.fold(c, tabs, r))
    terms = [(0, 1, 2, 3, 5), (4, 5)]
    (f1, s1), (f2, s2) = (sk.fold_round_eval(c, tabs, x, terms, 6) for x in (r_dev, r))
    assert torch.equal(f1, f2) and torch.equal(s1, s2)
    assert torch.equal(f1, sk.fold_plain(c, tabs, r))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["classic", "gruen", "generic"])
def test_fs_enqueue_loop_syncs_nothing_on_cuda(cuda_device, tier):
    """The device rounds queue with no host sync (set_sync_debug_mode
    "error" raises on one), one fetch follows, and the proof, randomness,
    finals and transcript equal the same driver's on the CPU."""
    import random

    from zinc_tpu_torch.sumcheck import device_fs as dfs
    from zinc_tpu_torch.sumcheck.executor import make_executor
    from zinc_tpu_torch.transcript import KeccakTranscript

    cfg, nv = FieldConfig(Q, 4), 11
    rng = random.Random(50)
    n_tab, degree, comb = {"classic": (2, 2, [(1, (0, 1))]),
                           "gruen": (3, 3, [(1, (0, 1, 3)), (-1, (2, 3))]),
                           "generic": (5, 5, [(1, (0, 1, 2, 3, 4)), (-1, (3, 4))])}[tier]
    comb = [(cfg.fp(k), t) for k, t in comb]
    eq_beta = [cfg.fp(rng.randrange(Q)) for _ in range(nv)] if tier == "gruen" else None
    tabs = _residues(fm.device_field(cfg), (n_tab, 1 << nv), 51)

    def prove(tables, check_sync):
        t = KeccakTranscript()
        t.absorb(b"device-fs")
        run = dfs.start_fs(t, make_executor(cfg, tables, degree, comb, eq_beta), nv, degree)
        if check_sync:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            dfs.enqueue_fs_rounds(run)
        finally:
            if check_sync:
                torch.cuda.set_sync_debug_mode("default")
        proof, rnd, mles = dfs.finish_fs(t, run)
        return ([[x.m for x in e] for e in proof], [x.m for x in rnd], [m[0].m for m in mles],
                t.h.digest())

    _cuda.reset_launches()
    got = prove(tabs.to(cuda_device), True)
    assert _cuda.LAUNCHES["fs_round"] == nv - 6  # rounds of more than 64 entries
    assert got == prove(tabs, False)


# ---------------------------------------------------------------------------
# the BLAKE3 Merkle tree and the eq table on the card (the CPU cases, against
# the JAX package: test_torch_merkle.py, test_torch_eq.py)
# ---------------------------------------------------------------------------


def _codewords(shape, dtype, seed, device):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    lanes = words.view(np.int32) if dtype == torch.int32 else words.astype(np.int64)
    return torch.from_numpy(lanes).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,k_words,dtype", [
    (1, 1, 1, torch.int32),  # a row of one leaf: no merge
    (3, 64, 4, torch.int32),  # fewer leaves than a block
    (3, 128, 2, torch.int64),  # a half-filled second block
    (2, 256, 1, torch.int64),  # a row of one block: no cluster
    (5, 512, 2, torch.int32),  # clusters of 2
    (3, 1024, 4, torch.int64),  # clusters of 4
    (4, 2048, 8, torch.int64),  # a row of one cluster of 8, 64-byte leaves
    (1024, 2048, 4, torch.int64),  # the 2^20 commit (the main path)
    (4096, 2048, 1, torch.int32),  # more clusters than the card holds at once
    (2, 4096, 4, torch.int32),  # a cluster and a merge launch
    (1, 1 << 18, 1, torch.int32),  # a cluster and a merge launch of 7 levels
])
def test_merkle_kernels_match_plain_on_cuda(cuda_device, rows, n, k_words, dtype):
    from zinc_tpu_torch.ops import blake3 as b3

    enc = _codewords((rows, n, 2 * k_words), dtype, rows + n + k_words, cuda_device)
    depth = n.bit_length() - 1
    _cuda.reset_launches()
    layers = b3.merkle_tree_device(enc, k_words)
    merges = len(b3.tree_plan(n)[1])
    assert (_cuda.LAUNCHES["blake3_leaves"], _cuda.LAUNCHES["blake3_merge"]) == (1, merges)
    want = b3.hash_leaves_plain(enc, k_words, 0)
    want += b3.merge_levels_plain(want[0], depth)
    assert len(layers) == depth + 1
    assert all(torch.equal(g, w) for g, w in zip(layers, want))


@pytest.mark.cuda
def test_leaves_cluster_launch_limits_on_cuda(cuda_device):
    """The card holds clusters of 2^LOG_CLUSTER leaves blocks, and the C entry
    refuses more levels than a cluster covers (cudaErrorInvalidValue), as
    the wrapper does before it."""
    from zinc_tpu_torch.ops import blake3 as b3

    assert b3.max_active_clusters(b3.LOG_CLUSTER, cuda_device) >= 1
    enc = _codewords((1, 1 << (b3.LEAF_LEVELS + 1), 2), torch.int32, 90, cuda_device)
    buf = torch.empty(8 * 4 * enc.shape[1], dtype=torch.int64, device=cuda_device)
    with _cuda.on_device(enc):
        rc = _cuda.blake3_lib().zt_blake3_leaves(buf.data_ptr(), enc.data_ptr(), enc.shape[1], 2, 1,
                                                 b3.LEAF_LEVELS + 1, _cuda.stream_ptr(enc.device))
    assert rc == 1  # cudaErrorInvalidValue
    with pytest.raises(ValueError):
        b3.hash_leaves(enc, 1, b3.LEAF_LEVELS + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,count", [(5, 2, 1), (3, 1024, 9), (2, 64, 4)])
def test_merge_levels_match_plain_on_cuda(cuda_device, rows, n, count):
    from zinc_tpu_torch.ops import blake3 as b3

    level = _codewords((rows, n, 8), torch.int64, 60 + count, cuda_device)
    _cuda.reset_launches()
    got = b3.merge_levels(level, count)
    one = b3.merge_levels(level.transpose(0, 1).contiguous().transpose(0, 1), 1)[0]
    assert _cuda.LAUNCHES["blake3_merge"] == 2
    want = b3.merge_levels_plain(level, count)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(one, want[0])  # a non-contiguous level


@pytest.mark.cuda
@pytest.mark.parametrize("q,n64", FIELDS)
def test_eq_levels_match_plain_on_cuda(cuda_device, q, n64):
    """Every level, and level 0 alone, in one launch, at 0 to 2 variables,
    at the most a block doubles its entry (e) and one more (two blocks), at
    14 and at 22 (a scan of 12 factors)."""
    from zinc_tpu_torch.poly.device import _eq_table_device, eq_levels, eq_levels_plain

    c = fm.device_field(FieldConfig(q, n64))
    e = fk.eq_block_levels(c.n32, 30)
    for s in (0, 1, 2, e, e + 1, 14, 22):
        r = _residues(c, (s,), 70 + s, cuda_device)
        _cuda.reset_launches()
        got = eq_levels(c, r)
        first = _eq_table_device(c, r)
        assert _cuda.LAUNCHES["eq_table"] == 2 and _cuda.LAUNCHES["mont_mul"] == 0
        want = eq_levels_plain(c, r)
        assert len(got) == s + 1
        assert all(torch.equal(g, w) for g, w in zip(got, want)), s
        assert torch.equal(first, want[0]) and first.shape[0] == 1 << s


@pytest.mark.cuda
@pytest.mark.parametrize("n64", [3, 4, 8])
def test_eq_table_of_2p20_matches_plain_on_cuda(cuda_device, n64):
    c = fm.device_field(FieldConfig(*next(f for f in FIELDS if f[1] == n64)))
    r = _residues(c, (20,), 77, cuda_device)
    want = fk.eq_table_plain(c, r)
    assert torch.equal(fk.eq_table(c, r), want)
    assert torch.equal(fk.eq_table(c, r, all_levels=False), want[: 1 << 20])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,depth", [(128, 256, 8), (1024, 2048, 11)])
def test_zip_records_match_plain_on_cuda(cuda_device, rows, n, depth):
    """The column records' kernel equals its plain version at the 2^14 and
    2^20 opens' shapes (1000 columns of 8-word codewords), in one launch an
    open; two opens of one size make one pinned staging buffer, and each
    fetches the records once."""
    from zinc_tpu_torch.ops.zip_records import pack_records, pack_records_plain
    from zinc_tpu_torch.zip import device as zd

    enc = _codewords((rows, n, 8), torch.int32, rows + depth, cuda_device)
    layers = [_codewords((rows, n >> lvl, 8), torch.int64, 70 + lvl, cuda_device)
              for lvl in range(depth)]
    cols = np.random.default_rng(depth).integers(0, n, size=1000)
    idx = torch.from_numpy(cols).to(cuda_device)
    _cuda.reset_launches()
    got = pack_records(enc, layers, idx, depth)
    assert _cuda.LAUNCHES["zip_records"] == 1
    assert torch.equal(got, pack_records_plain(enc, layers, idx, depth))
    zd._STAGING.clear()
    zd.reset_records()
    data = zd.DeviceZipData(enc, layers)
    first = zd._column_records([data], cols, depth).copy()
    second = zd._column_records([data], cols, depth)
    assert np.array_equal(first, got.cpu().numpy()) and np.array_equal(second, first)
    assert zd.RECORDS == {"card": 2, "plain": 0, "bytes": 2 * got.numel(), "staging": 1}
    assert _cuda.LAUNCHES["zip_records"] == 3


@pytest.mark.cuda
def test_merkle_and_eq_wrappers_refuse_on_cuda(cuda_device, ctx):
    from zinc_tpu_torch.ops import blake3 as b3

    r = _residues(ctx, (4,), 81, cuda_device)
    with pytest.raises(ValueError):
        fk.eq_table(ctx, r.reshape(-1)[2:26].reshape(3, 8))  # off its 16-byte alignment
    with pytest.raises(ValueError):
        fk.eq_table(ctx, r[::2])  # not contiguous
    big = fm.device_field(FieldConfig((1 << 575) + 1515, 9))  # 18 words: no kernel width
    with pytest.raises(ValueError):
        fk.eq_table(big, _residues(big, (4,), 82, cuda_device))
    enc = _codewords((2, 8, 4), torch.int32, 84, cuda_device)
    with pytest.raises(TypeError):
        b3.merkle_tree_device(enc.to(torch.float32), 2)
    with pytest.raises(ValueError):
        b3.merkle_tree_device(enc[:, :6], 2)
    with pytest.raises(TypeError):
        b3.merge_levels(enc.reshape(2, 4, 8), 1)  # int32 digests


@pytest.mark.cuda
def test_merkle_and_eq_launch_on_their_tensors_card_on_cuda(cuda_device, ctx):
    """The Merkle and eq-level wrappers on tensors of cuda:1 while cuda:0 is
    current launch on cuda:1 and equal their plain versions."""
    from zinc_tpu_torch.ops import blake3 as b3
    from zinc_tpu_torch.poly.device import eq_levels

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    other = torch.device("cuda", 1)
    enc = _codewords((2, 1024, 8), torch.int32, 90, "cpu")  # k_words = 4
    r = _residues(ctx, (6,), 91)
    with torch.cuda.device(0):
        layers = b3.merkle_tree_device(enc.to(other), 4)
        levels = eq_levels(ctx, r.to(other))
        torch.cuda.synchronize(other)
    assert all(x.device == other for x in layers + levels)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(layers, b3.merkle_tree_device(enc, 4)))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(levels, eq_levels(ctx, r)))
