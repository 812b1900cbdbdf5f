"""PCS transcript: Fiat-Shamir state + proof byte stream in one object.

Mirrors zinc/src/zip/pcs_transcript.rs: a Keccak transcript (fresh,
independent of the outer protocol transcript) plus a cursor over the proof
bytes.  Wire formats:

* field elements: Montgomery-form value, big-endian, 8·n64 bytes; absorbed
  into the FS state on both write and read;
* integers: two's complement, little-endian 64-bit words, LE bytes (i.e.
  plain little-endian), NOT absorbed;
* commitments (BLAKE3 digests): raw 32 bytes, not absorbed;
* Merkle paths: u64 big-endian length prefix + digests;
* ``squeeze_challenge_idx``: field challenge → low 4 LE bytes of the
  Montgomery value → u32 mod cap.
"""

from __future__ import annotations

from ..fields.config import FieldConfig, Fp
from ..transcript import KeccakTranscript


class PcsStreamError(Exception):
    pass


class PcsTranscript:
    def __init__(self, proof: bytes | None = None):
        self.fs = KeccakTranscript()
        self._buf = bytearray() if proof is None else None
        self._view = proof
        self._pos = 0

    @staticmethod
    def from_proof(proof: bytes) -> "PcsTranscript":
        return PcsTranscript(proof)

    def into_proof(self) -> bytes:
        return bytes(self._buf)

    # -- raw stream ---------------------------------------------------------

    def _write(self, data: bytes) -> None:
        self._buf += data

    def _read(self, n: int) -> bytes:
        if self._view is None or self._pos + n > len(self._view):
            raise PcsStreamError("proof stream exhausted")
        out = self._view[self._pos : self._pos + n]
        self._pos += n
        return out

    # -- field elements (absorbed) ------------------------------------------

    def write_field_element(self, fe: Fp) -> None:
        self.fs.absorb_field(fe)
        self._write(fe.cfg.value_bytes_be(fe.m))

    def write_field_elements(self, fes) -> None:
        for fe in fes:
            self.write_field_element(fe)

    def read_field_element(self, cfg: FieldConfig) -> Fp:
        data = self._read(cfg.nbytes)
        fe = cfg.fp_from_mont(int.from_bytes(data, "big"))
        self.fs.absorb_field(fe)
        return fe

    def read_field_elements(self, n: int, cfg: FieldConfig) -> list[Fp]:
        return [self.read_field_element(cfg) for _ in range(n)]

    # -- integers (not absorbed) --------------------------------------------

    def write_integer(self, value: int, nwords: int) -> None:
        self._write((value % (1 << (64 * nwords))).to_bytes(8 * nwords, "little"))

    def write_integers(self, values, nwords: int) -> None:
        for v in values:
            self.write_integer(v, nwords)

    def read_integer(self, nwords: int) -> int:
        u = int.from_bytes(self._read(8 * nwords), "little")
        if u >> (64 * nwords - 1):
            u -= 1 << (64 * nwords)
        return u

    def read_integers(self, n: int, nwords: int) -> list[int]:
        return [self.read_integer(nwords) for _ in range(n)]

    # -- commitments / Merkle paths -----------------------------------------

    def write_commitment(self, digest: bytes) -> None:
        assert len(digest) == 32
        self._write(digest)

    def read_commitment(self) -> bytes:
        return self._read(32)

    def write_merkle_path(self, path: list[bytes]) -> None:
        self._write(len(path).to_bytes(8, "big"))
        for h in path:
            self.write_commitment(h)

    def read_merkle_path(self) -> list[bytes]:
        n = int.from_bytes(self._read(8), "big")
        return [self.read_commitment() for _ in range(n)]

    # -- challenges ---------------------------------------------------------

    def squeeze_challenge_idx(self, cfg: FieldConfig, cap: int) -> int:
        challenge = self.fs.get_challenge(cfg)
        le = cfg.value_bytes_le(challenge.m)
        return int.from_bytes(le[:4], "little") % cap
