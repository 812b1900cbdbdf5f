"""Keccak-256 (legacy padding 0x01) — the Fiat-Shamir hash of the framework.

The transcript layer of the reference system uses the ``sha3`` crate's
``Keccak256`` (see zinc/src/transcript.rs:15-18), i.e. the original
Keccak with 0x01 domain padding, NOT NIST SHA3 (0x06).  Python's hashlib only
exposes the NIST variant, so we carry our own implementation.

The implementation is a plain sponge over Keccak-f[1600] with rate 136 bytes.
It supports the incremental ``update`` / ``copy`` / ``digest`` pattern the
transcript relies on (the transcript repeatedly clones its hasher state to
derive challenges without consuming the running state).

Host-side hashing is inherently sequential (Fiat-Shamir chaining), so this
lives on the host; the bulk data-parallel hashing of the framework (Merkle
leaves/levels) uses BLAKE3 on device instead (see hashing/blake3.py and
ops/blake3.py).
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets r[x][y] indexed by lane (x + 5*y).
_ROT = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]


def _rotl(v: int, n: int) -> int:
    if n == 0:
        return v
    return ((v << n) | (v >> (64 - n))) & _MASK64


def keccak_f1600(s: list[int]) -> None:
    """In-place Keccak-f[1600] permutation on 25 64-bit lanes (lane = x + 5y)."""
    for rc in _RC:
        # theta
        c0 = s[0] ^ s[5] ^ s[10] ^ s[15] ^ s[20]
        c1 = s[1] ^ s[6] ^ s[11] ^ s[16] ^ s[21]
        c2 = s[2] ^ s[7] ^ s[12] ^ s[17] ^ s[22]
        c3 = s[3] ^ s[8] ^ s[13] ^ s[18] ^ s[23]
        c4 = s[4] ^ s[9] ^ s[14] ^ s[19] ^ s[24]
        d0 = c4 ^ _rotl(c1, 1)
        d1 = c0 ^ _rotl(c2, 1)
        d2 = c1 ^ _rotl(c3, 1)
        d3 = c2 ^ _rotl(c4, 1)
        d4 = c3 ^ _rotl(c0, 1)
        for y in range(0, 25, 5):
            s[y] ^= d0
            s[y + 1] ^= d1
            s[y + 2] ^= d2
            s[y + 3] ^= d3
            s[y + 4] ^= d4
        # rho + pi: B[y][(2x+3y)%5] = rotl(s[x][y], r[x][y]) with lane index x+5y
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(s[x + 5 * y], _ROT[x + 5 * y])
        # chi
        for y in range(0, 25, 5):
            b0, b1, b2, b3, b4 = b[y], b[y + 1], b[y + 2], b[y + 3], b[y + 4]
            s[y] = b0 ^ ((~b1) & b2 & _MASK64)
            s[y + 1] = b1 ^ ((~b2) & b3 & _MASK64)
            s[y + 2] = b2 ^ ((~b3) & b4 & _MASK64)
            s[y + 3] = b3 ^ ((~b4) & b0 & _MASK64)
            s[y + 4] = b4 ^ ((~b0) & b1 & _MASK64)
        # iota
        s[0] ^= rc


class Keccak256Py:
    """Incremental Keccak-256 hasher (rate 136, output 32 bytes, pad 0x01/0x80)."""

    RATE = 136
    DIGEST_SIZE = 32

    __slots__ = ("_state", "_buf")

    def __init__(self) -> None:
        self._state: list[int] = [0] * 25
        self._buf = bytearray()

    def copy(self) -> "Keccak256Py":
        h = Keccak256Py.__new__(Keccak256Py)
        h._state = list(self._state)
        h._buf = bytearray(self._buf)
        return h

    def update(self, data: bytes) -> "Keccak256":
        self._buf += data
        if len(self._buf) >= self.RATE:
            n_blocks = len(self._buf) // self.RATE
            self._absorb_blocks(bytes(self._buf[: n_blocks * self.RATE]))
            del self._buf[: n_blocks * self.RATE]
        return self

    def _absorb_blocks(self, blocks: bytes) -> None:
        s = self._state
        rate_lanes = self.RATE // 8
        for off in range(0, len(blocks), self.RATE):
            for i in range(rate_lanes):
                s[i] ^= int.from_bytes(blocks[off + 8 * i: off + 8 * i + 8], "little")
            keccak_f1600(s)

    def digest(self) -> bytes:
        # Finalize on a copy so the running state stays usable.
        s = list(self._state)
        block = bytes(self._buf) + b"\x01" + b"\x00" * (self.RATE - len(self._buf) - 2) + b"\x80"
        if len(self._buf) == self.RATE - 1:
            block = bytes(self._buf) + b"\x81"
        for i in range(self.RATE // 8):
            s[i] ^= int.from_bytes(block[8 * i: 8 * i + 8], "little")
        keccak_f1600(s)
        out = b"".join(s[i].to_bytes(8, "little") for i in range(4))
        return out

    def hexdigest(self) -> str:
        return self.digest().hex()


def _make_native_class(lib):
    import ctypes

    class Keccak256Native:
        """Keccak-256 backed by the native runtime (csrc/zinc_native.cpp)."""

        RATE = 136
        DIGEST_SIZE = 32

        __slots__ = ("_state", "_buf")

        def __init__(self) -> None:
            self._state = (ctypes.c_uint64 * 25)()
            self._buf = bytearray()

        def copy(self) -> "Keccak256Native":
            h = Keccak256Native.__new__(Keccak256Native)
            h._state = (ctypes.c_uint64 * 25)(*self._state)
            h._buf = bytearray(self._buf)
            return h

        def update(self, data: bytes) -> "Keccak256Native":
            self._buf += data
            if len(self._buf) >= self.RATE:
                n_blocks = len(self._buf) // self.RATE
                lib.zn_keccak_absorb_blocks(
                    self._state, bytes(self._buf[: n_blocks * self.RATE]), n_blocks
                )
                del self._buf[: n_blocks * self.RATE]
            return self

        def digest(self) -> bytes:
            out = (ctypes.c_uint8 * 32)()
            lib.zn_keccak_finalize(self._state, bytes(self._buf), len(self._buf), out)
            return bytes(out)

        def hexdigest(self) -> str:
            return self.digest().hex()

    return Keccak256Native


def _pick_impl():
    from ..native import get_lib

    lib = get_lib()
    if lib is not None:
        return _make_native_class(lib)
    return Keccak256Py


Keccak256 = _pick_impl()


def keccak256(data: bytes) -> bytes:
    h = Keccak256()
    h.update(data)
    return h.digest()
