"""Keccak-256 with the original 0x01 padding (not NIST SHA3's 0x06), in
plain Python: a frozen copy of the sponge the Zinc transcript runs on,
and the same sponge over a batch of messages of one length in numpy.
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets by lane x + 5y
_ROT = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]


def _rotl(v: int, n: int) -> int:
    return v if n == 0 else ((v << n) | (v >> (64 - n))) & _MASK64


def keccak_f1600(s: list[int]) -> None:
    """Keccak-f[1600] in place on 25 lanes (lane x + 5y)."""
    for rc in _RC:
        c = [s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for i in range(25):
            s[i] ^= d[i % 5]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(s[x + 5 * y], _ROT[x + 5 * y])
        for y in range(0, 25, 5):
            row = b[y:y + 5]
            for x in range(5):
                s[y + x] = row[x] ^ ((~row[(x + 1) % 5]) & row[(x + 2) % 5] & _MASK64)
        s[0] ^= rc


class Keccak256:
    """Incremental Keccak-256 (rate 136 bytes, 32-byte digest); ``digest``
    leaves the running state usable, as the transcript needs."""

    RATE = 136

    def __init__(self) -> None:
        self._state = [0] * 25
        self._buf = bytearray()

    def copy(self) -> "Keccak256":
        h = Keccak256()
        h._state = list(self._state)
        h._buf = bytearray(self._buf)
        return h

    def update(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= self.RATE:
            self._absorb(self._state, bytes(self._buf[:self.RATE]))
            del self._buf[:self.RATE]

    @staticmethod
    def _absorb(s: list[int], block: bytes) -> None:
        for i in range(len(block) // 8):
            s[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        keccak_f1600(s)

    def digest(self) -> bytes:
        pad = bytearray(self.RATE - len(self._buf))
        pad[0] ^= 0x01
        pad[-1] ^= 0x80
        s = list(self._state)
        self._absorb(s, bytes(self._buf) + bytes(pad))
        return b"".join(s[i].to_bytes(8, "little") for i in range(4))


# the batch's ρ and π as gathers: lane x + 5y of the next state comes from
# lane _PI_SRC[i] of this one, rotated by _PI_ROT[i]
_PI_SRC = np.zeros(25, dtype=np.intp)
_PI_ROT = np.zeros((25, 1), dtype=np.uint64)
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        _PI_ROT[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _ROT[_x + 5 * _y]
_PI_BACK = (64 - _PI_ROT) % 64  # a rotation by 0 ORs the lane with itself
_RC_U64 = np.array(_RC, dtype=np.uint64)
_ONE = np.uint64(1)
_SIXTY_THREE = np.uint64(63)


def keccak_f1600_batch(s: np.ndarray) -> np.ndarray:
    """Keccak-f[1600] of each column of ``s``, (25, B) uint64 lanes (lane
    x + 5y), as a new array."""
    s = s.copy()
    for rc in _RC_U64:
        c = s[0:5] ^ s[5:10] ^ s[10:15] ^ s[15:20] ^ s[20:25]
        c1 = np.roll(c, -1, axis=0)
        d = np.roll(c, 1, axis=0) ^ ((c1 << _ONE) | (c1 >> _SIXTY_THREE))
        s ^= np.tile(d, (5, 1))
        b = s[_PI_SRC]
        b = (b << _PI_ROT) | (b >> _PI_BACK)
        rows = b.reshape(5, 5, -1)
        s = (rows ^ (~np.roll(rows, -1, axis=1) & np.roll(rows, -2, axis=1))).reshape(25, -1)
        s[0] ^= rc
    return s


class Keccak256Batch:
    """``Keccak256`` over B messages at once, each update the same number of
    bytes for every message: (B, L) uint8."""

    RATE = Keccak256.RATE

    def __init__(self, batch: int) -> None:
        self._state = np.zeros((25, batch), dtype=np.uint64)
        self._buf = np.zeros((batch, 0), dtype=np.uint8)

    def update(self, data: np.ndarray) -> None:
        self._buf = np.concatenate([self._buf, data], axis=1)
        while self._buf.shape[1] >= self.RATE:
            self._state = self._absorb(self._state, self._buf[:, :self.RATE])
            self._buf = self._buf[:, self.RATE:]

    @staticmethod
    def _absorb(s: np.ndarray, block: np.ndarray) -> np.ndarray:
        lanes = np.ascontiguousarray(block).view("<u8").T  # (17, B)
        s = s.copy()
        s[:lanes.shape[0]] ^= lanes
        return keccak_f1600_batch(s)

    def digest(self) -> np.ndarray:
        """(B, 32) uint8 digests; the running state stays usable."""
        b, n = self._buf.shape
        pad = np.zeros((b, self.RATE - n), dtype=np.uint8)
        pad[:, 0] ^= 0x01
        pad[:, -1] ^= 0x80
        s = self._absorb(self._state, np.concatenate([self._buf, pad], axis=1))
        return np.ascontiguousarray(s[:4].T).view(np.uint8)
