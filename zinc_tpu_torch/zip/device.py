"""Device Zip PCS: encoding, Merkle hashing and opening.

The port of ``zinc_tpu/zip/device.py``.  The commit runs on the device:

    witness ints → K-width words → repeat → gather(σ₁) → prefix sum
    → gather(σ₂) → prefix sum → BLAKE3 leaves → level merges

(the RAA code; the ZipLinearCode encodes by one exact float64 product with
its dense 0/1 matrix).

The open computes the proximity rows (signed float64 limb products) and the
q₀-weighted field row (K1 + exact sums), and packs the 1000 column records
in their wire layout on the device (``ops/zip_records.pack_records``, one
launch on a card), fetched in one copy into a pinned host buffer kept
across opens (:func:`_column_records`): the byte stream equals
``zip.pcs.open_poly``'s.  ``RECORDS`` counts the opens by path and what
they fetched.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields.config import FieldConfig
from ..zip.transcript import PcsTranscript
from ..fields import montgomery as fm
from ..fields.integers import (
    combine_acc_to_words,
    combine_rows_acc,
    cumsum_wrap,
    int_vector,
    sign_extend,
    vector_to_mag8,
    vector_to_words,
)
from ..fields.montgomery import carry, device_field
from ..ops.blake3 import merkle_tree_device
from ..ops.field_kernels import mont_mul
from ..ops.zip_records import pack_records, record_bytes
from ..poly.device import build_eq_table_device
from ..timing import timed
from .pcs import ZipCommitment, ZipParams


# opens whose records the kernel packed ("card") or the plain version
# ("plain"), the record bytes fetched from cards, and the pinned staging
# buffers allocated ("staging": one a card, grown only for a larger stream)
RECORDS = {"card": 0, "plain": 0, "bytes": 0, "staging": 0}
_STAGING: dict = {}  # device -> pinned uint8 tensor, reused by every open on it


def reset_records() -> None:
    for k in RECORDS:
        RECORDS[k] = 0


@dataclass
class DeviceZipData:
    """Prover-side commitment data, resident on the device."""

    enc: torch.Tensor  # (R, cw, 2·k_words) int32 codeword words
    layers: list  # [(R, n_level, 8) int64 digest words], leaves first


def _raa_encode_rows(z_words: torch.Tensor, row_len: int, rep: int, kw32: int, p1, p2):
    """(R·row_len, W) words → (R, cw, kw32) encoded rows."""
    r = z_words.shape[0] // row_len
    rows = sign_extend(z_words, kw32).reshape(r, row_len, kw32)
    vec = torch.cat([rows] * rep, dim=1)
    vec = cumsum_wrap(vec[:, p1], dim=1)
    return cumsum_wrap(vec[:, p2], dim=1)


def _zlc_dense_matrix(code) -> np.ndarray:
    """The ZipLinearCode's [A ‖ B] as one dense (cw, row_len) 0/1 float64
    matrix (``zinc_tpu/zip/device.py:_zlc_dense_matrix``)."""
    cw, row_len = code.codeword_len(), code.row_len
    m = np.zeros((cw, row_len), np.float64)
    half = cw // 2
    for base, cells in ((0, code.a), (half, code.b)):
        for r, row in enumerate(cells):
            for col, coeff in row:
                m[base + r, col] = float(coeff)
    return m


def _zlc_encode_rows(z_words: torch.Tensor, mat: torch.Tensor, kw32: int) -> torch.Tensor:
    """ZipLinearCode encode (the port of ``zinc_tpu/zip/device.py:
    _zlc_encode_rows``): (R·row_len, W) words → (R, cw, kw32) rows of
    [A·row ‖ B·row].  One float64 product of the 0/1 matrix with the rows'
    two's-complement u32 words: every partial sum is an integer below
    row_len·2^32 < 2^53, so it is exact in any order (float64 has no TF32
    mode), and one carry wraps the word sums to width K."""
    row_len = mat.shape[1]
    assert row_len < 1 << 21, "float64 word sums are exact below 2^53"
    rows = sign_extend(z_words, kw32).reshape(-1, row_len, kw32)
    lazy = torch.matmul(mat, rows.to(torch.float64)).to(torch.int64)  # (R, cw, kw32)
    return carry(lazy, kw32)


def encode_rows(pp: ZipParams, z_words: torch.Tensor) -> torch.Tensor:
    """(R·row_len, W) witness words → (R, cw, 2·k_words) codeword rows, by
    the RAA code or the ZipLinearCode (``zinc_tpu/zip/device.py:146-147``)."""
    device = z_words.device
    kw32 = 2 * pp.zt.k_words
    if hasattr(pp.code, "permutations"):  # RAA
        p1, p2 = (torch.from_numpy(np.asarray(p, np.int64)).to(device)
                  for p in pp.code.permutations())
        return _raa_encode_rows(z_words, pp.code.row_len, pp.code.repetition_factor, kw32, p1, p2)
    mat = torch.from_numpy(_zlc_dense_matrix(pp.code)).to(device)
    return _zlc_encode_rows(z_words, mat, kw32)


def roots_of(layers) -> list[bytes]:
    """The rows' 32-byte Merkle roots from the top layer (R, 1, 8)."""
    top = layers[-1][:, 0, :].cpu().numpy().astype("<u4")
    return [top[r].tobytes() for r in range(top.shape[0])]


def commit_device(pp: ZipParams, z_values: np.ndarray, cfg: FieldConfig, device):
    """Device commit of the ``int_vector`` z_values; trees and roots
    byte-identical to ``zip.pcs.commit``."""
    z_words = vector_to_words(z_values, 2 * pp.zt.n_words, device)
    assert z_words.shape[0] == pp.num_rows * pp.code.row_len
    enc = encode_rows(pp, z_words)
    layers = merkle_tree_device(enc, pp.zt.k_words)
    return DeviceZipData(fm.narrow(enc), layers), ZipCommitment(roots_of(layers))


def _field_row_bytes(words: np.ndarray) -> bytes:
    """(C, n32) Montgomery words → concatenated big-endian element bytes."""
    return np.ascontiguousarray(words[:, ::-1]).astype(">u4").tobytes()


def _row_blocks(x, devices, group=None) -> list[torch.Tensor]:
    """A (R, ...) host array or tensor cut into one row block per shard, of
    every process when a ``group`` is given; this process's len(devices)
    blocks, block s on devices[s].  Over several shards this is the span
    ``mesh.scatter``, and a tensor's blocks (it lies on devices[0]) that
    leave it count in ``parallel.mesh.MESH``; a host array's are uploads."""
    from_host = not isinstance(x, torch.Tensor)
    x = torch.from_numpy(x) if from_host else x
    world, rank = (1, 0) if group is None else (group.world, group.rank)
    mine = x.chunk(len(devices) * world)[rank * len(devices) : (rank + 1) * len(devices)]
    if len(devices) == world == 1:
        return [mine[0].to(devices[0]).contiguous()]
    from ..parallel.mesh import scattered

    with timed("mesh.scatter"):
        return scattered(mine, devices, None if from_host else 0)


def _summed(parts, home, group) -> torch.Tensor:
    """Σ of integer tensors, on ``home``: the local parts, then (with a
    group) every process's sum, exactly, as int64.  Over several shards this
    is the span ``mesh.gather``, and each part after the first (which lies
    on ``home``) counts in ``parallel.mesh.MESH``."""
    if len(parts) == 1 and group is None:
        return sum(p.to(home) for p in parts)
    from ..parallel.mesh import moved

    with timed("mesh.gather"):
        local = sum(p if s == 0 else moved(p, home, "gather") for s, p in enumerate(parts))
        return local if group is None else sum(group.all_gather(local)).to(home)


def open_device(
    pp: ZipParams,
    z_values: np.ndarray,  # the polynomial's integer evaluations (an int_vector)
    z_f: torch.Tensor,  # (m, n32) field projection of z (Montgomery)
    data,  # DeviceZipData, or a list of them: the codeword's row blocks, one per shard
    point: list,
    cfg: FieldConfig,
    transcript: PcsTranscript,
    group=None,  # parallel.mesh.ProcessGroup when the row blocks are spread over processes
) -> None:
    """Device open; proof bytes identical to ``zip.pcs.open_poly``.

    ``data`` as D row blocks (``parallel/zip.py``) opens them where they
    lie: each block's proximity accumulator and q₀-weighted row sum are
    formed on its device and added, exactly, on ``z_f``'s device before the
    one carry and the one reduction mod q; each block's records segment
    is packed on its device and laid in row order.  With a
    ``group`` the blocks are this process's share of every process's: the
    challenges are all squeezed before any write, so every process opens
    the same columns; the int64 accumulators and row sums and the column
    records are all-gathered in rank order, and every process writes the
    same bytes."""
    blocks = data if isinstance(data, (list, tuple)) else [data]
    devices = [b.enc.device for b in blocks]
    row_len = pp.code.row_len
    cw = pp.code.codeword_len()
    num_rows = pp.num_rows
    home = z_f.device
    ctx = device_field(cfg)

    # integer writes are not absorbed, so every challenge of the testing
    # phase depends only on the state entering the open: squeeze them first
    prox_coeffs = []
    if num_rows > 1:
        prox_coeffs = [
            transcript.fs.get_integer_challenges(num_rows, pp.zt.n_words)
            for _ in range(pp.code.num_proximity_testing())
        ]
    depth = (cw - 1).bit_length() if cw > 1 else 0
    n_open = pp.code.num_column_opening()
    cols = np.array([transcript.squeeze_challenge_idx(cfg, cw) for _ in range(n_open)])

    with timed("prove.zip_open.combine"):
        combined_rows = []
        if prox_coeffs:
            e_mag8, e_sign = vector_to_mag8(z_values, 8 * pp.zt.n_words)
            e_mag8 = _row_blocks(e_mag8.reshape(num_rows, row_len, -1), devices, group)
            e_sign = _row_blocks(e_sign.reshape(num_rows, row_len), devices, group)
            for coeffs in prox_coeffs:
                c_mag8, c_sign = vector_to_mag8(int_vector(coeffs), 8 * pp.zt.n_words)
                accs = [combine_rows_acc(cm, cs, em, es) for cm, cs, em, es in zip(
                    _row_blocks(c_mag8, devices, group), _row_blocks(c_sign, devices, group),
                    e_mag8, e_sign)]
                combined_rows.append(combine_acc_to_words(_summed(accs, home, group),
                                                          2 * pp.zt.m_words))

        log_rows = num_rows.bit_length() - 1
        lo = point[len(point) - log_rows :]
        if lo:
            q0 = _row_blocks(build_eq_table_device(cfg, lo, home), devices, group)  # (R, n32)
            e_f = _row_blocks(z_f.reshape(num_rows, row_len, -1), devices, group)
            # K1 on each block, then exact word sums over its rows
            parts = [fm.widen(mont_mul(ctx, q[:, None, :], e)).sum(dim=0) for q, e in zip(q0, e_f)]
            combined_f = fm.reduce_lazy(ctx, _summed(parts, home, group), num_rows)
        else:
            combined_f = z_f

        for combined in combined_rows:
            transcript._write(combined.cpu().numpy().astype("<u4").tobytes())
        eval_row = fm.to_numpy(combined_f)
    with timed("prove.zip_open.fetch"):
        records = _column_records(blocks, cols, depth, group)
    with timed("prove.zip_open.write"):
        transcript._write(memoryview(records.reshape(-1)))
        write_eval_row(cfg, eval_row, transcript)


def _fetch(x: torch.Tensor) -> np.ndarray:
    """A card's uint8 tensor in host memory, in one copy into the card's
    pinned staging buffer (valid until the next fetch on that card); a CPU
    tensor as it is."""
    if not x.is_cuda:
        return x.numpy()
    n = x.numel()
    buf = _STAGING.get(x.device)
    if buf is None or buf.numel() < n:
        buf = _STAGING[x.device] = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        RECORDS["staging"] += 1
    out = buf[:n]
    out.copy_(x.reshape(-1), non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    RECORDS["bytes"] += n
    return out.numpy().reshape(x.shape)


def _column_records(blocks, cols: np.ndarray, depth: int, group=None) -> np.ndarray:
    """The opening's column records, (n_open, rec_bytes) uint8 on the host.

    One block and no ``group``: the records as the packer wrote them, in
    one fetch (on a card: the staging buffer, valid until the next open on
    that card).  Several row blocks, or a ``group``: each block's segment
    (its rows' values, then their paths) packed on its device, every
    process's gathered in rank order, and each laid at its rows' offsets
    in both sections."""
    RECORDS["card" if blocks[0].enc.is_cuda else "plain"] += 1
    cols = np.asarray(cols, np.int64)
    segs = [pack_records(b.enc, b.layers, torch.from_numpy(cols).to(b.enc.device), depth)
            for b in blocks]
    if len(segs) == 1 and group is None:
        return _fetch(segs[0])
    if group is not None:  # every process's blocks, in row order
        parts = np.empty((len(segs), *segs[0].shape), np.uint8)
        for part, seg in zip(parts, segs):
            part[...] = _fetch(seg)
        segs = np.concatenate(group.all_gather_array(parts))
    vb, pb = record_bytes(blocks[0].enc.shape[0], blocks[0].enc.shape[2], depth)
    nb = len(segs)
    out = np.empty((len(cols), nb * (vb + pb)), np.uint8)
    for i, seg in enumerate(segs):
        p = _fetch(seg) if isinstance(seg, torch.Tensor) else seg
        out[:, i * vb : (i + 1) * vb] = p[:, :vb]
        out[:, nb * vb + i * pb : nb * vb + (i + 1) * pb] = p[:, vb:]
    return out


def write_eval_row(cfg: FieldConfig, combined_f: np.ndarray, transcript: PcsTranscript) -> None:
    """Absorb and write the evaluation phase's combined field row."""
    raw = _field_row_bytes(combined_f)
    step = cfg.nbytes
    for i in range(combined_f.shape[0]):
        eb = raw[i * step : (i + 1) * step]
        # absorbed exactly as write_field_element (modulus framing + value)
        transcript.fs.h.update(b"\x03")
        transcript.fs.h.update(cfg.modulus_bytes_be())
        transcript.fs.h.update(b"\x05")
        transcript.fs.h.update(b"\x01")
        transcript.fs.h.update(eb)
        transcript.fs.h.update(b"\x03")
        transcript._write(eb)
