"""The port's host layer held module by module against the JAX package: the
transcript and Keccak (tests/test_transcript.py), prime generation, the
ChaCha12 stack of the RAA permutations (tests/test_rng_external.py), the
field constants and host arithmetic (tests/test_field_config.py) and the
proof's wire form (tests/test_serialize.py).  Each test runs that test's
cases through the port's own copy (``zinc_tpu_torch/transcript.py``,
``hashing/keccak.py``, ``prime.py``, ``rng.py``, ``fields/config.py``,
``serialize.py``) and through ``zinc_tpu`` on the same inputs, and compares
ints and bytes: ``Fp``/``FieldConfig`` equality checks ``isinstance``, so no
object crosses the packages."""

import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

import zinc_tpu_torch as zt
from zinc_tpu import ccs as jccs
from zinc_tpu import prime as jprime
from zinc_tpu import rng as jrng
from zinc_tpu.fields.config import FieldConfig as JFieldConfig
from zinc_tpu.hashing import keccak as jkeccak
from zinc_tpu.serialize import serialize_proof as j_serialize_proof
from zinc_tpu.transcript import KeccakTranscript as JKeccakTranscript
from zinc_tpu.zinc import ZincProver as JZincProver
from zinc_tpu.zip.code import ZipTypes as JZipTypes
from zinc_tpu_torch import ccs, prime, rng
from zinc_tpu_torch.fields.config import FieldConfig
from zinc_tpu_torch.hashing import keccak
from zinc_tpu_torch.serialize import deserialize_proof, serialize_proof
from zinc_tpu_torch.transcript import KeccakTranscript

ROOT = Path(__file__).resolve().parents[1]
STARK_PRIME = 3618502788666131213697322783095070105623107215331596699973092056135872020481
Q128 = 312829638388039969874974628075306023441


def _both(label: bytes | None = None):
    """A port transcript and a JAX one, each after absorbing ``label``."""
    t, jt = KeccakTranscript(), JKeccakTranscript()
    if label is not None:
        t.absorb(label)
        jt.absorb(label)
    return t, jt


# ---------------------------------------------------------------------------
# Keccak and the transcript (tests/test_transcript.py)
# ---------------------------------------------------------------------------


def test_keccak256_empty():
    want = "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    assert keccak.keccak256(b"").hex() == want == jkeccak.keccak256(b"").hex()


@pytest.mark.parametrize("impl", ["native", "python"])
def test_keccak256_abc_and_incremental(impl):
    """The fox vector, and absorption in 37-byte pieces across the rate
    boundary, for the native-backed class and the pure-Python one."""
    cls = keccak.Keccak256 if impl == "native" else keccak.Keccak256Py
    fox = b"The quick brown fox jumps over the lazy dog"
    assert keccak.keccak256(fox).hex() == (
        "4d741b6f1eb29cb2a9b9911c82f56fa8d73b04959d3d9d222895df6c0b28aa15"
    )
    data = bytes(range(256)) * 3
    one_shot = jkeccak.keccak256(data)
    inc = cls()
    for i in range(0, len(data), 37):
        inc.update(data[i : i + 37])
    assert inc.digest() == one_shot
    assert inc.digest() == one_shot  # digest() does not consume the state


def test_transcript_known_answer():
    expected = 693058076479703886486101269644733982722902192016595549603371045888466087870
    t, jt = _both(b"This is a test string!")
    got = t.get_challenge(FieldConfig(STARK_PRIME, 32)).to_int()
    assert got == expected == jt.get_challenge(JFieldConfig(STARK_PRIME, 32)).to_int()


def test_get_random_bytes_does_not_advance_state():
    t, jt = _both(b"abc")
    a = t.get_random_bytes(8)
    assert t.get_random_bytes(8) == a == jt.get_random_bytes(8)
    long = t.get_random_bytes(70)
    assert long[:8] == a and len(long) == 70 and long == jt.get_random_bytes(70)


def test_integer_challenge_framing_and_sign():
    t, jt = _both(b"seed")
    v1, v2 = t.get_integer_challenge(1), t.get_integer_challenge(1)
    assert (v1, v2) == (jt.get_integer_challenge(1), jt.get_integer_challenge(1))
    assert v1 != v2 and -(1 << 63) <= v1 < (1 << 63)
    t2, _ = _both(b"seed")
    assert t2.get_u64() == v1 % (1 << 64)
    # the signed framing at several widths, and the draws after them
    t, jt = _both(b"widths")
    for n64 in (1, 2, 4):
        assert t.get_integer_challenges(5, n64) == jt.get_integer_challenges(5, n64)
    assert t.get_random_bytes(32) == jt.get_random_bytes(32)


def test_sample_unique_columns():
    t, jt = _both(b"columns")
    cols, jcols = set(), set()
    added = t.sample_unique_columns(0, 16, cols, 10)
    assert added == 10 == jt.sample_unique_columns(0, 16, jcols, 10)
    assert cols == jcols and all(0 <= c < 16 for c in cols)


@pytest.mark.parametrize("q,n64", [((1 << 61) - 1, 1), ((1 << 127) - 1, 2),
                                   ((1 << 256) + 0x129, 5)])
def test_challenge_regimes(q, n64):
    """The 64-bit, <128-bit and ≥256-bit masking regimes, each in range and
    equal to the JAX package's challenge."""
    assert prime.miller_rabin_base2(q) and jprime.miller_rabin_base2(q)
    t, jt = _both()
    c = t.get_challenge(FieldConfig(q, n64)).to_int()
    assert 0 <= c < q and c == jt.get_challenge(JFieldConfig(q, n64)).to_int()


@pytest.mark.parametrize("n64", [1, 3, 4])
def test_prime_generation_deterministic(n64):
    """get_prime's rejection loop: the same prime and the same transcript
    state after it as the JAX package's, for several widths (each draws
    several candidates before one passes)."""
    t, jt = _both(b"prime seed")
    p = prime.get_prime(t, n64)
    assert p == jprime.get_prime(jt, n64)
    assert p % 2 == 1 and prime.miller_rabin_base2(p) and p.bit_length() <= 64 * n64
    assert t.get_random_bytes(4) == jt.get_random_bytes(4)
    cfg = prime.draw_random_field([3, -5, 1 << 40], KeccakTranscript(), 1, n64)
    jcfg = jprime.draw_random_field([3, -5, 1 << 40], JKeccakTranscript(), 1, n64)
    assert (cfg.q, cfg.n64) == (jcfg.q, jcfg.n64)


def test_miller_rabin_matches_on_a_range():
    """miller_rabin_base2 on every odd number below 5001 and on Fermat
    pseudoprimes to base 2 (2047, a strong one, passes in both packages)."""
    nums = list(range(3, 5001, 2)) + [341, 561, 645, 1105, 1387, 1729, 1905, 2047]
    assert [prime.miller_rabin_base2(n) for n in nums] == \
        [jprime.miller_rabin_base2(n) for n in nums]


# ---------------------------------------------------------------------------
# the ChaCha12 stack (tests/test_rng_external.py)
# ---------------------------------------------------------------------------


def _core_keystream(mod, key: bytes, counter: int, nblocks: int, rounds: int) -> bytes:
    key_words = [int.from_bytes(key[4 * i : 4 * i + 4], "little") for i in range(8)]
    out = bytearray()
    for b in range(nblocks):
        for w in mod.chacha_block_words(key_words, counter + b, rounds):
            out += w.to_bytes(4, "little")
    return bytes(out)


def _openssl_chacha20_keystream(key: bytes, counter: int, nblocks: int) -> bytes:
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms

    full_nonce = counter.to_bytes(4, "little") + b"\x00" * 12
    enc = Cipher(algorithms.ChaCha20(key, full_nonce), mode=None).encryptor()
    return enc.update(b"\x00" * (64 * nblocks))


@pytest.mark.parametrize(
    "key,counter",
    [
        (b"\x00" * 32, 0),
        (bytes(range(32)), 0),
        (bytes(range(32)), 7),
        (b"\xff" * 32, 1),
        (bytes((i * 37 + 11) % 256 for i in range(32)), 1234567),
    ],
)
def test_chacha_core_matches_openssl_at_20_rounds(key, counter):
    """The port's block function at 20 rounds reproduces OpenSSL's ChaCha20,
    and at 12 rounds (StdRng's) the JAX package's keystream."""
    assert _core_keystream(rng, key, counter, 3, 20) == _openssl_chacha20_keystream(key, counter, 3)
    assert _core_keystream(rng, key, counter, 3, 12) == _core_keystream(jrng, key, counter, 3, 12)


def test_chacha12_differs_from_chacha20():
    key = bytes(range(32))
    assert _core_keystream(rng, key, 0, 1, 12) != _core_keystream(rng, key, 0, 1, 20)


def test_chacha12_class_uses_12_round_core():
    """ChaCha12.next_u32 consumes the 12-round keystream in word order,
    across a block boundary, as the JAX package's class does."""
    key = bytes(range(32))
    a, b = rng.ChaCha12(key), jrng.ChaCha12(key)
    words = [a.next_u32() for _ in range(20)]
    assert words == [b.next_u32() for _ in range(20)]
    stream = _core_keystream(rng, key, 0, 2, 12)
    assert words == [int.from_bytes(stream[4 * i : 4 * i + 4], "little") for i in range(20)]
    assert rng.splitmix64_seed(2**63 + 11) == jrng.splitmix64_seed(2**63 + 11)


_CASES = [(0, 16), (12345, 16), (1, 1), (7, 2), (987654321, 2048), (2**63 + 11, 2048),
          (0xDEADBEEFCAFEF00D, 4096)] + [(seed, 101) for seed in range(20)]


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_shuffle_matches_independent_cpp_mirror(tmp_path):
    """The port's permutation_from_seed against native/rand09_mirror.cpp
    (an independent C++ mirror of the shuffle's layers) and against the
    JAX package's, at the production codeword sizes and edge shapes."""
    exe = tmp_path / "rand09_mirror"
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(exe),
                    str(ROOT / "native" / "rand09_mirror.cpp")],
                   check=True, capture_output=True, timeout=120)
    for seed, n in _CASES:
        out = subprocess.run([str(exe), str(seed), str(n)], check=True, capture_output=True,
                             timeout=60, text=True).stdout.split()
        cpp = np.array([int(x) for x in out], dtype=np.int64)
        got = rng.permutation_from_seed(seed, n)
        assert np.array_equal(cpp, got), f"divergence at seed={seed} n={n}"
        assert np.array_equal(got, jrng.permutation_from_seed(seed, n))


# ---------------------------------------------------------------------------
# the field's constants and host arithmetic (tests/test_field_config.py)
# ---------------------------------------------------------------------------


def test_montgomery_mul_reference_vector():
    q = 695962179703626800597079116051991347
    got = FieldConfig(q, 4).mont_mul(423024736033, 246308734)
    assert got == 504579159360957705315139767875358506 == JFieldConfig(q, 4).mont_mul(
        423024736033, 246308734)


@pytest.mark.parametrize("q,n64", [(695962179703626800597079116051991347, 2), (Q128, 3),
                                   ((1 << 255) + 95, 4), ((1 << 61) - 1, 1)])
def test_montgomery_constants(q, n64):
    cfg, jcfg = FieldConfig(q, n64), JFieldConfig(q, n64)
    names = ("r", "r2", "r_inv", "inv64", "inv16", "n16", "nbytes")
    assert [getattr(cfg, k) for k in names] == [getattr(jcfg, k) for k in names]
    assert cfg.r == (1 << (64 * n64)) % q and (cfg.inv64 * q) % (1 << 64) == (1 << 64) - 1
    assert (cfg.inv16 * q) % (1 << 16) == (1 << 16) - 1 and (cfg.r * cfg.r_inv) % q == 1
    assert cfg.modulus_bytes_be() == jcfg.modulus_bytes_be()


def test_fp_arithmetic_roundtrip():
    cfg, jcfg = FieldConfig(Q128, 3), JFieldConfig(Q128, 3)
    r = random.Random(0)
    for _ in range(200):
        a, b = r.randrange(-(1 << 200), 1 << 200), r.randrange(-(1 << 200), 1 << 200)
        fa, fb, ja, jb = cfg.fp(a), cfg.fp(b), jcfg.fp(a), jcfg.fp(b)
        got = [(fa + fb).to_int(), (fa - fb).to_int(), (fa * fb).to_int(), (-fa).to_int(),
               (fa / fb).to_int(), cfg.value_bytes_be(fa.m), (fa ** 5).m]
        want = [(ja + jb).to_int(), (ja - jb).to_int(), (ja * jb).to_int(), (-ja).to_int(),
                (ja / jb).to_int(), jcfg.value_bytes_be(ja.m), (ja ** 5).m]
        assert got == want
        assert got[:4] == [(a + b) % Q128, (a - b) % Q128, (a * b) % Q128, (-a) % Q128]
        assert (fa / fb) * fb == fa
    assert cfg.one().to_int() == 1 and cfg.zero().is_zero()


def test_fp_division_by_zero_raises():
    with pytest.raises(ZeroDivisionError):
        _ = FieldConfig(23, 1).fp(5) / FieldConfig(23, 1).fp(0)


def test_signed_mapping_matches_reference_semantics():
    cfg, jcfg = FieldConfig(23, 1), JFieldConfig(23, 1)
    for v in range(-100, 100):
        expected = (abs(v) % 23) if v >= 0 else (23 - (abs(v) % 23)) % 23
        assert cfg.fp(v).to_int() == expected == jcfg.fp(v).to_int()


def test_exhaustive_8_and_16_bit_conversions():
    cfg, jcfg = FieldConfig((1 << 61) - 1, 1), JFieldConfig((1 << 61) - 1, 1)
    values = list(range(-(1 << 8), 1 << 9)) + list(range(-(1 << 15), -(1 << 15) + 256)) \
        + list(range((1 << 15) - 256, 1 << 16))
    got = [cfg.fp(v).to_int() for v in values]
    assert got == [v % cfg.q for v in values] == [jcfg.fp(v).to_int() for v in values]
    small, jsmall = FieldConfig(251, 1), JFieldConfig(251, 1)
    vals = range(-(1 << 16), 1 << 16, 97)
    assert [small.fp(v).to_int() for v in vals] == [jsmall.fp(v).to_int() for v in vals] \
        == [v % 251 for v in vals]


# ---------------------------------------------------------------------------
# the wire form (tests/test_serialize.py)
# ---------------------------------------------------------------------------


def test_proof_roundtrip_and_verify():
    """The Vitalik R1CS proved by the port's host backend: the JAX host
    prover's bytes; deserialized, every part equal, and the port's verifiers
    accept it; a corrupt magic or a cut stream is refused."""
    c, statement, wit = ccs.vitalik_fixture(3)
    t = zt.KeccakTranscript()
    cfg = zt.draw_random_field(statement.public_input, t, 1, 4)
    proof = zt.ZincProver(zt.ZipTypes(1), backend="host").prove(statement, wit, t, c, cfg)
    blob = serialize_proof(proof, cfg)

    jc, jst, jwit = jccs.vitalik_fixture(3)
    jt = JKeccakTranscript()
    jcfg = jprime.draw_random_field(jst.public_input, jt, 1, 4)
    assert blob == j_serialize_proof(JZincProver(JZipTypes(1)).prove(jst, jwit, jt, jc, jcfg), jcfg)

    restored = deserialize_proof(blob, cfg)
    sp, rp = proof.spartan_proof, restored.spartan_proof
    assert rp.linearization_sumcheck == sp.linearization_sumcheck
    assert rp.second_sumcheck == sp.second_sumcheck and rp.V_s == sp.V_s
    assert restored.zip_proof.z_comm.roots == proof.zip_proof.z_comm.roots
    assert restored.zip_proof.v == proof.zip_proof.v
    assert restored.zip_proof.pcs_proof == proof.zip_proof.pcs_proof
    assert serialize_proof(restored, cfg) == blob
    for backend in ("host", "device"):
        zt.ZincVerifier(zt.ZipTypes(1), backend=backend, device="cpu").verify(
            statement, restored, zt.KeccakTranscript(), c, cfg)
    with pytest.raises(ValueError):
        deserialize_proof(b"NOTMAGIC" + blob[8:], cfg)
    with pytest.raises(ValueError):
        deserialize_proof(blob[: len(blob) // 3], cfg)
