"""The Fiat-Shamir transcript of Zinc over Keccak-256, and the drawing of
the prime field from it, in plain Python.

Challenges come out as canonical integers mod q; a field element is
absorbed as its Montgomery form (R = 2^(64·n64)), big-endian, framed
``0x03 ‖ q ‖ 0x05 ‖ 0x01 ‖ value ‖ 0x03``.
"""

from __future__ import annotations

import struct

import numpy as np

from .keccak import Keccak256, Keccak256Batch

M64 = (1 << 64) - 1


class Field:
    """Z_q with the Montgomery radix R = 2^(64·n64) that the wire uses."""

    def __init__(self, q: int, n64: int):
        self.q, self.n64, self.nbytes = q, n64, 8 * n64
        self.r = (1 << (64 * n64)) % q
        self.r_inv = pow(self.r, -1, q)

    def mont(self, a: int) -> int:
        return a % self.q * self.r % self.q

    def canon(self, m: int) -> int:
        return m * self.r_inv % self.q


def field_bytes(f: Field, mont: int) -> bytes:
    return (b"\x03" + f.q.to_bytes(f.nbytes, "big") + b"\x05\x01" + mont.to_bytes(f.nbytes, "big")
            + b"\x03")


def challenge_of(digest: bytes, f: Field) -> int:
    """A field challenge, canonical: the digest's two big-endian 128-bit
    halves, masked to q's bit length less one."""
    lo, hi = int.from_bytes(digest[:16], "big"), int.from_bytes(digest[16:], "big")
    bits = f.q.bit_length() - 1
    if f.n64 == 1:
        v = lo & M64 & ((1 << bits) - 1)
    elif bits < 128:
        v = lo & ((1 << bits) - 1)
    elif bits >= 256:
        v = lo + (hi << 128)
    else:
        v = lo + ((hi & ((1 << (bits - 128)) - 1)) << 128)
    return v % f.q


class Transcript:
    def __init__(self) -> None:
        self.h = Keccak256()

    def absorb(self, data: bytes) -> None:
        self.h.update(data)

    def absorb_field(self, f: Field, mont: int) -> None:
        self.h.update(field_bytes(f, mont))

    def random_bytes(self, n: int) -> bytes:
        out = b""
        counter = 0
        while len(out) < n:
            t = self.h.copy()
            t.update(struct.pack(">i", counter))
            out += t.digest()
            counter += 1
        return out[:n]

    def _ratchet(self, left: bytes, right: bytes) -> bytes:
        digest = self.h.digest()
        self.h.update(left + digest + right)
        return digest

    def challenge(self, f: Field) -> int:
        return challenge_of(self._ratchet(b"\x00", b"\x01"), f)

    def integer_challenge(self, nwords: int) -> int:
        """A signed integer of ``nwords`` 64-bit words, drawn 8 bytes at a time."""
        value = 0
        for i in range(nwords):
            chunk = self.random_bytes(8)
            self.h.update(b"\x12" + chunk + b"\x34")
            value |= int.from_bytes(chunk, "little") << (64 * i)
        if value >> (64 * nwords - 1):
            value -= 1 << (64 * nwords)
        return value

    def u64(self) -> int:
        return self.integer_challenge(1) & M64


class TranscriptBatch:
    """``Transcript`` over B transcripts that absorb the same lengths in the
    same order: each call takes one value (or byte string) a transcript."""

    def __init__(self, batch: int) -> None:
        self.h = Keccak256Batch(batch)

    def absorb(self, data: list[bytes]) -> None:
        self.h.update(np.frombuffer(b"".join(data), dtype=np.uint8).reshape(len(data), -1))

    def absorb_field(self, f: Field, monts: list[int]) -> None:
        self.absorb([field_bytes(f, m) for m in monts])

    def challenge(self, f: Field) -> list[int]:
        digests = self.h.digest()
        self.h.update(np.concatenate([np.zeros((len(digests), 1), np.uint8), digests,
                                      np.ones((len(digests), 1), np.uint8)], axis=1))
        return [challenge_of(d.tobytes(), f) for d in digests]


def _miller_rabin_base2(n: int) -> bool:
    if n < 2 or n % 2 == 0:
        return n == 2
    if n == 3:
        return True
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    x = pow(2, d, n)
    if x in (1, n - 1):
        return True
    for _ in range(s - 1):
        x = x * x % n
        if x == n - 1:
            return True
    return False


def draw_field(public_input: list[int], t: Transcript, int_nwords: int, n64: int) -> Field:
    """Absorb each public integer as its little-endian two's-complement
    words, then draw 8·n64 bytes until their big-endian value, made odd,
    passes Miller-Rabin to base 2 (each draw absorbed back)."""
    for v in public_input:
        t.absorb((v % (1 << (64 * int_nwords))).to_bytes(8 * int_nwords, "little"))
    while True:
        chunk = t.random_bytes(8 * n64)
        t.absorb(chunk)
        cand = int.from_bytes(chunk, "big")
        if cand % 2 == 0:
            cand -= 1
        if cand > 0 and _miller_rabin_base2(cand):
            return Field(cand, n64)
