"""The Keccak-256 sponge on tensors, and its state moved between host and device.

The port of ``zinc_tpu/ops/keccak_kernel.py``: the plain PyTorch sponge of
the device-resident Fiat-Shamir loop (``sumcheck/device_fs.py``), whose
hand-written kernel is ``csrc/keccak.cuh`` inside ``fs_round``
(``csrc/fs.cu``).  Byte layouts match ``hashing/keccak.py`` bit for bit.

torch's CPU has no uint64 shifts, and ``>>`` on int64 is arithmetic, so a
lane is a (lo, hi) pair of u32 values held in int64 tensors, (25, 2) for
the state, as the reference carries its (25, 2) uint32 lanes.  The
permutation is vectorised over the 25 lanes: theta's column parities and
rotations, rho's per-lane rotations (shift tensors), pi's lane gather and
chi's row rolls are a dozen tensor ops a round.

The fill level of the buffer (``pos``) is a host int: every absorb of the
sumcheck loop has a size known on the host, so block boundaries resolve
there, as the reference's static-position sponge resolves them at trace
time.

On the device the sponge is one int32 tensor of ``STATE_WORDS`` words: the
25 lanes as little-endian u32 pairs (lo, hi), then the ``RATE`` buffered
bytes packed little-endian; only the first ``pos`` bytes are meaningful.
:class:`DeviceSponge` carries it with its ``pos``, and moves it in and out
of the host hashers of ``hashing/keccak.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hashing.keccak import _RC, _ROT

RATE = 136
RATE_LANES = RATE // 8
STATE_WORDS = 50 + RATE // 4  # 25 lanes of two words, then the buffered bytes

M32 = 0xFFFFFFFF

# pi: lane x + 5y moves to lane y + 5·((2x + 3y) mod 5); _PI_SRC[d] is the
# lane that lands in d
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_RC_PAIRS = np.array([[rc & M32, rc >> 32] for rc in _RC], dtype=np.int64)


def _tables(device) -> dict:
    """Per-lane constants of the permutation on ``device``."""
    rot = torch.tensor(_ROT, dtype=torch.int64)
    return {
        "swap": (rot >= 32).to(device),
        "shift": (rot % 32).to(device),
        "pi": torch.tensor(_PI_SRC, dtype=torch.int64, device=device),
        "rc": torch.from_numpy(_RC_PAIRS).to(device),
    }


_TABLES: dict[str, dict] = {}


def _consts(device) -> dict:
    key = str(torch.device(device))
    if key not in _TABLES:
        _TABLES[key] = _tables(device)
    return _TABLES[key]


def _rotl(lo: torch.Tensor, hi: torch.Tensor, n) -> tuple[torch.Tensor, torch.Tensor]:
    """Left rotation of 64-bit lanes (lo, hi) by n < 32 (an int or a tensor of
    per-lane counts); a shift by 32 − 0 = 32 of a u32 value gives 0."""
    return ((lo << n) | (hi >> (32 - n))) & M32, ((hi << n) | (lo >> (32 - n))) & M32


def keccak_f1600(lanes: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] of (25, 2) int64 lanes (lo, hi), lane x + 5y; returns
    the permuted lanes."""
    c = _consts(lanes.device)
    lo, hi = lanes[:, 0], lanes[:, 1]
    for rnd in range(24):
        # theta: column parities C[x], then D[x] = C[x−1] ^ rotl(C[x+1], 1)
        clo = lo.view(5, 5)
        chi_ = hi.view(5, 5)
        plo = clo[0] ^ clo[1] ^ clo[2] ^ clo[3] ^ clo[4]
        phi = chi_[0] ^ chi_[1] ^ chi_[2] ^ chi_[3] ^ chi_[4]
        rlo, rhi = _rotl(plo.roll(-1), phi.roll(-1), 1)
        lo = (clo ^ (plo.roll(1) ^ rlo)).reshape(25)
        hi = (chi_ ^ (phi.roll(1) ^ rhi)).reshape(25)
        # rho (per-lane rotation: a swap of the halves for counts ≥ 32) and pi
        a = torch.where(c["swap"], hi, lo)
        b = torch.where(c["swap"], lo, hi)
        lo, hi = _rotl(a, b, c["shift"])
        lo, hi = lo[c["pi"]].view(5, 5), hi[c["pi"]].view(5, 5)
        # chi along each row y: b[x] ^ (~b[x+1] & b[x+2])
        lo = (lo ^ ((lo.roll(-1, 1) ^ M32) & lo.roll(-2, 1))).reshape(25)
        hi = (hi ^ ((hi.roll(-1, 1) ^ M32) & hi.roll(-2, 1))).reshape(25)
        # iota
        lo = torch.cat([lo[:1] ^ c["rc"][rnd, 0], lo[1:]])
        hi = torch.cat([hi[:1] ^ c["rc"][rnd, 1], hi[1:]])
    return torch.stack([lo, hi], dim=1)


def bytes_to_lanes(data: torch.Tensor) -> torch.Tensor:
    """(8k,) int64 bytes → (k, 2) little-endian lanes (lo, hi)."""
    b = data.view(-1, 2, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def lanes_to_bytes(lanes: torch.Tensor) -> torch.Tensor:
    """(k, 2) lanes → (8k,) int64 bytes, little-endian."""
    shifts = torch.arange(0, 32, 8, device=lanes.device)
    return ((lanes[..., None] >> shifts) & 0xFF).reshape(-1)


def _xor_block(lanes: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    return torch.cat([lanes[:RATE_LANES] ^ bytes_to_lanes(block), lanes[RATE_LANES:]])


def absorb(lanes: torch.Tensor, buf: torch.Tensor, pos: int, data: torch.Tensor):
    """Absorb (n,) int64 bytes at fill level ``pos``: (lanes, buf, pos).  buf
    holds the pending bytes in [0, pos); the bytes after them are never
    read."""
    n, off = data.shape[0], 0
    while n - off + pos >= RATE:
        take = RATE - pos
        block = torch.cat([buf[:pos], data[off : off + take]])
        lanes = keccak_f1600(_xor_block(lanes, block))
        off += take
        pos = 0
    rem = n - off
    if rem:
        buf = torch.cat([buf[:pos], data[off:], buf[pos + rem :]])
        pos += rem
    return lanes, buf, pos


def digest(lanes: torch.Tensor, buf: torch.Tensor, pos: int) -> torch.Tensor:
    """(32,) int64 bytes: the Keccak-256 digest of the stream so far (pad
    0x01 … 0x80); the state is left as it is."""
    block = torch.cat([buf[:pos], buf.new_zeros(RATE - pos)])
    pad = torch.zeros(RATE, dtype=torch.int64, device=buf.device)
    pad[pos] ^= 0x01
    pad[RATE - 1] ^= 0x80
    return lanes_to_bytes(keccak_f1600(_xor_block(lanes, block ^ pad))[:4])


# ---------------------------------------------------------------------------
# the sponge state as one int32 tensor
# ---------------------------------------------------------------------------


def pack_state(lanes: torch.Tensor, buf: torch.Tensor, pos: int) -> torch.Tensor:
    """(25, 2) lanes and (RATE,) bytes, ``pos`` of them pending → the
    (STATE_WORDS,) int32 state, whose bytes past ``pos`` are 0 (as the
    kernel writes them)."""
    buf = torch.where(torch.arange(RATE, device=buf.device) < pos, buf, 0)
    words = torch.cat([lanes.reshape(-1), bytes_to_lanes(buf).reshape(-1)])
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_state(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The (STATE_WORDS,) int32 state → (25, 2) int64 lanes, (RATE,) int64
    bytes."""
    w = state.to(torch.int64) & M32
    return w[:50].view(25, 2), lanes_to_bytes(w[50:].view(-1, 2))


class DeviceSponge:
    """A Keccak-256 sponge whose state lies in a tensor (``state``, see the
    module notes) at the host-known fill level ``pos``.  Mirrors
    ``hashing/keccak.py`` bit for bit."""

    def __init__(self, state: torch.Tensor, pos: int):
        self.state = state
        self.pos = pos

    @staticmethod
    def from_host(h, device="cpu") -> "DeviceSponge":
        """The running state of a host hasher (``Keccak256Py``, whose
        ``_state`` is a list, or ``Keccak256Native``, a ctypes array of 25
        c_uint64), on ``device``."""
        pending = bytes(h._buf)
        words = np.zeros(STATE_WORDS, np.uint32)
        lanes = np.array([int(w) for w in h._state], dtype=np.uint64)
        words[:50:2] = (lanes & M32).astype(np.uint32)
        words[1:50:2] = (lanes >> np.uint64(32)).astype(np.uint32)
        raw = np.zeros(RATE, np.uint8)
        raw[: len(pending)] = np.frombuffer(pending, np.uint8)
        words[50:] = raw.view("<u4")
        state = torch.from_numpy(words.view(np.int32)).to(device)
        return DeviceSponge(state, len(pending))

    def export_to_host(self, h, words: np.ndarray | None = None) -> None:
        """Write the state back into a host hasher of the same class, from
        ``words`` (the state fetched as uint32 words) or from ``state``."""
        if words is None:
            words = self.state.cpu().numpy().view(np.uint32)
        words = np.asarray(words, dtype=np.uint32)
        lanes = [int(words[2 * i]) | (int(words[2 * i + 1]) << 32) for i in range(25)]
        if isinstance(h._state, list):  # Keccak256Py
            h._state = lanes
        else:  # Keccak256Native: ctypes c_uint64 * 25
            h._state = type(h._state)(*lanes)
        h._buf = bytearray(words[50:].astype("<u4").tobytes()[: self.pos])

    def _parts(self):
        return unpack_state(self.state)

    def absorb(self, data: torch.Tensor) -> "DeviceSponge":
        """A new sponge that has absorbed (n,) bytes (any integer dtype)."""
        lanes, buf = self._parts()
        lanes, buf, pos = absorb(lanes, buf, self.pos, data.to(torch.int64))
        return DeviceSponge(pack_state(lanes, buf, pos), pos)

    def digest(self) -> torch.Tensor:
        """(32,) int64 bytes of the digest; the state is left as it is."""
        lanes, buf = self._parts()
        return digest(lanes, buf, self.pos)
