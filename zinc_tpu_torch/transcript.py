"""Fiat-Shamir transcript over Keccak-256.

Byte-exact reimplementation of the reference transcript semantics
(zinc/src/transcript.rs):

* the transcript state is an incremental Keccak-256 hasher;
* ``get_random_bytes`` clones the state, appends a big-endian i32 counter per
  32-byte block, and does NOT advance the running state;
* ``get_challenge`` reads a 32-byte digest as two big-endian u128 halves
  (lo = bytes 0..16, hi = bytes 16..32), ratchets the state with the framing
  ``0x00 || digest || 0x01`` and masks the halves according to the modulus
  bit-width regime (transcript.rs:88-132);
* integer challenges are drawn 8 bytes at a time with ``0x12 || bytes || 0x34``
  framing, little-endian words (transcript.rs:142-160);
* column sampling uses ``0x88 || digest || 0x11`` framing and a little-endian
  u64 modulo the range length (transcript.rs:162-201);
* field elements are absorbed in Montgomery form with the tag framing of
  zinc/src/field.rs:360-379.

The known-answer test pinned at transcript.rs:213-234 is reproduced in
tests/test_transcript.py.
"""

from __future__ import annotations

import struct

from .fields.config import FieldConfig, Fp
from .hashing.keccak import Keccak256

_U64 = (1 << 64) - 1


class KeccakTranscript:
    def __init__(self) -> None:
        self.h = Keccak256()

    def clone(self) -> "KeccakTranscript":
        t = KeccakTranscript.__new__(KeccakTranscript)
        t.h = self.h.copy()
        return t

    # -- absorption ---------------------------------------------------------

    def absorb(self, data: bytes) -> None:
        self.h.update(data)

    def absorb_field(self, fe: Fp) -> None:
        """Absorb an initialized field element: modulus + Montgomery value."""
        cfg = fe.cfg
        self.h.update(b"\x03")
        self.h.update(cfg.modulus_bytes_be())
        self.h.update(b"\x05")
        self.h.update(b"\x01")
        self.h.update(cfg.value_bytes_be(fe.m))
        self.h.update(b"\x03")

    def absorb_raw(self, value: int, nbytes: int) -> None:
        """Absorb a config-less ('Raw') big integer value."""
        self.h.update(b"\x01")
        self.h.update(value.to_bytes(nbytes, "big"))
        self.h.update(b"\x03")

    def absorb_field_slice(self, fes: list[Fp]) -> None:
        for fe in fes:
            self.absorb_field(fe)

    # -- randomness derivation ---------------------------------------------

    def get_random_bytes(self, length: int) -> bytes:
        out = bytearray()
        counter = 0
        while len(out) < length:
            t = self.h.copy()
            t.update(struct.pack(">i", counter))
            out += t.digest()
            counter += 1
        return bytes(out[:length])

    def _get_challenge_limbs(self) -> tuple[int, int]:
        digest = self.h.digest()
        lo = int.from_bytes(digest[0:16], "big")
        hi = int.from_bytes(digest[16:32], "big")
        self.h.update(b"\x00")
        self.h.update(digest)
        self.h.update(b"\x01")
        return lo, hi

    def get_challenge(self, cfg: FieldConfig) -> Fp:
        lo, hi = self._get_challenge_limbs()
        bits = cfg.q.bit_length() - 1
        if cfg.n64 == 1:
            mask = (1 << bits) - 1
            return cfg.fp((lo & _U64) & mask)
        if bits < 128:
            return cfg.fp(lo & ((1 << bits) - 1))
        if bits >= 256:
            return cfg.fp(lo + (hi << 128))
        hi_keep = bits - 128
        return cfg.fp(lo + ((hi & ((1 << hi_keep) - 1)) << 128))

    def get_challenges(self, n: int, cfg: FieldConfig) -> list[Fp]:
        return [self.get_challenge(cfg) for _ in range(n)]

    def get_integer_challenge(self, nwords: int) -> int:
        """Signed integer challenge: nwords 64-bit LE words, two's complement."""
        value = 0
        for i in range(nwords):
            chunk = self.get_random_bytes(8)
            self.h.update(b"\x12")
            self.h.update(chunk)
            self.h.update(b"\x34")
            value |= int.from_bytes(chunk, "little") << (64 * i)
        # interpret as two's complement
        if value >> (64 * nwords - 1):
            value -= 1 << (64 * nwords)
        return value

    def get_integer_challenges(self, n: int, nwords: int) -> list[int]:
        return [self.get_integer_challenge(nwords) for _ in range(n)]

    def _get_usize_in_range(self, start: int, end: int) -> int:
        digest = self.h.digest()
        self.h.update(b"\x88")
        self.h.update(digest)
        self.h.update(b"\x11")
        num = int.from_bytes(digest[:8], "little")
        return start + num % (end - start)

    # -- ZipTranscript interface (code sampling) ----------------------------

    def get_encoding_element(self) -> int:
        byte = self.get_random_bytes(1)[0]
        return byte & 1

    def get_u64(self) -> int:
        return self.get_integer_challenge(1) & _U64

    def sample_unique_columns(self, start: int, end: int, columns: set, count: int) -> int:
        added = 0
        while added < count:
            candidate = self._get_usize_in_range(start, end)
            if candidate not in columns:
                columns.add(candidate)
                added += 1
        return added
