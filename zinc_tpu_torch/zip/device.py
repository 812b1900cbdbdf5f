"""Device Zip PCS: encoding, Merkle hashing and opening.

The port of ``zinc_tpu/zip/device.py``.  The commit runs on the device:

    witness ints → K-width words → repeat → gather(σ₁) → prefix sum
    → gather(σ₂) → prefix sum → BLAKE3 leaves → level merges

(the RAA code; the ZipLinearCode encodes by one exact float64 product with
its dense 0/1 matrix).

The open computes the proximity rows (signed float64 limb products), the
q₀-weighted field row (K1 + exact sums) and gathers the opened columns and
Merkle siblings on the device, then writes the 1000 column records with
bulk numpy serialization: the byte stream equals ``zip.pcs.open_poly``'s.
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
    i64_to_mag8,
    i64_to_words,
    ints_to_mag8,
    ints_to_words_signed,
    sign_extend,
)
from ..fields.montgomery import carry, device_field
from ..ops.blake3 import merkle_tree_device
from ..ops.field_kernels import mont_mul
from ..poly.device import build_eq_table_device
from .pcs import ZipCommitment, ZipParams


@dataclass
class DeviceZipData:
    """Prover-side commitment data, resident on the device."""

    enc: torch.Tensor  # (R, cw, 2·k_words) int32 codeword words
    layers: list  # [(R, n_level, 8) int64 digest words], leaves first


def _z_words(z_values, n_words64: int, device) -> torch.Tensor:
    nw = 2 * n_words64
    if isinstance(z_values, np.ndarray) and z_values.dtype == np.int64:
        return i64_to_words(torch.from_numpy(z_values).to(device), nw)
    words = ints_to_words_signed(list(z_values), nw)
    return torch.from_numpy(words.astype(np.int64)).to(device)


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


def commit_device(pp: ZipParams, z_values, cfg: FieldConfig, device):
    """Device commit; trees and roots byte-identical to ``zip.pcs.commit``."""
    z_words = _z_words(z_values, pp.zt.n_words, device)
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
    blocks, block s on devices[s]."""
    x = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    world, rank = (1, 0) if group is None else (group.world, group.rank)
    mine = x.chunk(len(devices) * world)[rank * len(devices) : (rank + 1) * len(devices)]
    return [blk.to(dev).contiguous() for blk, dev in zip(mine, devices)]


def _summed(parts, home, group) -> torch.Tensor:
    """Σ of integer tensors, on ``home``: the local parts, then (with a
    group) every process's sum, exactly, as int64."""
    local = sum(p.to(home) for p in parts)
    return local if group is None else sum(group.all_gather(local)).to(home)


def open_device(
    pp: ZipParams,
    z_values: np.ndarray,  # the polynomial's integer evaluations
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
    one carry and the one reduction mod q; each block's opened columns and
    siblings are gathered on its device and written in row order.  With a
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

    combined_rows = []
    if prox_coeffs:
        if isinstance(z_values, np.ndarray) and z_values.dtype == np.int64:
            e_mag8, e_sign = i64_to_mag8(z_values)
        else:
            e_mag8, e_sign = ints_to_mag8(list(z_values), 8 * pp.zt.n_words)
        e_mag8 = _row_blocks(e_mag8.reshape(num_rows, row_len, -1), devices, group)
        e_sign = _row_blocks(e_sign.reshape(num_rows, row_len), devices, group)
        for coeffs in prox_coeffs:
            c_mag8, c_sign = ints_to_mag8(coeffs, 8 * pp.zt.n_words)
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
    gathers = [dispatch_column_gathers(b, cols, depth) for b in blocks]
    vals, sibs = fetch_column_gathers(gathers)
    if group is not None:  # every process's rows, in row order
        vals = np.concatenate(group.all_gather_array(vals), axis=1)
        if depth:
            sibs = list(np.concatenate(group.all_gather_array(np.stack(sibs)), axis=2))
    write_column_records(vals, sibs, depth, transcript)
    write_eval_row(cfg, fm.to_numpy(combined_f), transcript)


def dispatch_column_gathers(data: DeviceZipData, cols: np.ndarray, depth: int):
    """Gather the opened columns and every level's Merkle siblings on the
    device: (vals (n_open, R, kw32) int32, [sib (n_open, R, 8) per level])."""
    idx = torch.from_numpy(np.asarray(cols, np.int64)).to(data.enc.device)
    vals = data.enc[:, idx, :].transpose(0, 1)
    sibs = []
    for lvl in range(depth):
        sibs.append(data.layers[lvl][:, idx ^ 1, :].transpose(0, 1))
        idx = idx >> 1
    return vals, sibs


def fetch_column_gathers(gathers) -> tuple[np.ndarray, list[np.ndarray]]:
    """The gathers of one or more row blocks, fetched and joined in row
    order: (vals (n_open, R, kw32) uint32, [sib (n_open, R, 8) uint32])."""
    fetched = [(v.contiguous().cpu().numpy().view(np.uint32),
                [s.contiguous().cpu().numpy().astype(np.uint32) for s in sibs])
               for v, sibs in gathers]
    vals = np.concatenate([v for v, _ in fetched], axis=1)
    sibs = [np.concatenate([s[lvl] for _, s in fetched], axis=1)
            for lvl in range(len(fetched[0][1]))]
    return vals, sibs


def write_column_records(vals: np.ndarray, sibs: list[np.ndarray], depth: int,
                         transcript: PcsTranscript) -> None:
    """Write the per-column opening records: values, then one path per row."""
    n_open, num_rows = vals.shape[:2]
    val_bytes = 4 * vals.shape[-1] * num_rows
    rec_bytes = val_bytes + num_rows * (8 + depth * 32)
    records = np.empty((n_open, rec_bytes), dtype=np.uint8)
    records[:, :val_bytes] = vals.astype("<u4").view(np.uint8).reshape(n_open, val_bytes)
    paths = records[:, val_bytes:].reshape(n_open, num_rows, 8 + depth * 32)
    paths[:, :, :8] = np.frombuffer(depth.to_bytes(8, "big"), np.uint8)
    for lvl, sib in enumerate(sibs):
        paths[:, :, 8 + lvl * 32 : 8 + (lvl + 1) * 32] = sib.astype("<u4").view(np.uint8).reshape(
            n_open, num_rows, 32
        )
    transcript._write(records.tobytes())


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
