"""Device Zip PCS: RAA encoding, Merkle hashing and opening.

The port of ``zinc_tpu/zip/device.py``.  The commit runs on the device:

    witness ints → K-width words → repeat → gather(σ₁) → prefix sum
    → gather(σ₂) → prefix sum → BLAKE3 leaves → level merges

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
    combine_rows_signed,
    cumsum_wrap,
    i64_to_mag8,
    i64_to_words,
    ints_to_mag8,
    ints_to_words_signed,
    sign_extend,
)
from ..fields.montgomery import device_field
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


def commit_device(pp: ZipParams, z_values, cfg: FieldConfig, device):
    """Device commit; trees and roots byte-identical to ``zip.pcs.commit``."""
    if not hasattr(pp.code, "permutations"):
        raise NotImplementedError("the port's device commit covers the RAA code only")
    row_len = pp.code.row_len
    kw32 = 2 * pp.zt.k_words
    z_words = _z_words(z_values, pp.zt.n_words, device)
    assert z_words.shape[0] == pp.num_rows * row_len
    p1, p2 = (torch.from_numpy(np.asarray(p, np.int64)).to(device) for p in pp.code.permutations())
    enc = _raa_encode_rows(z_words, row_len, pp.code.repetition_factor, kw32, p1, p2)
    layers = merkle_tree_device(enc, pp.zt.k_words)
    top = layers[-1][:, 0, :].cpu().numpy().astype("<u4")
    roots = [top[r].tobytes() for r in range(top.shape[0])]
    return DeviceZipData(fm.narrow(enc), layers), ZipCommitment(roots)


def _field_row_bytes(words: np.ndarray) -> bytes:
    """(C, n32) Montgomery words → concatenated big-endian element bytes."""
    return np.ascontiguousarray(words[:, ::-1]).astype(">u4").tobytes()


def open_device(
    pp: ZipParams,
    z_values: np.ndarray,  # the polynomial's integer evaluations
    z_f: torch.Tensor,  # (m, n32) field projection of z (Montgomery)
    data: DeviceZipData,
    point: list,
    cfg: FieldConfig,
    transcript: PcsTranscript,
) -> None:
    """Device open; proof bytes identical to ``zip.pcs.open_poly``."""
    row_len = pp.code.row_len
    cw = pp.code.codeword_len()
    num_rows = pp.num_rows
    device = z_f.device
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
        e_mag8 = torch.from_numpy(e_mag8.reshape(num_rows, row_len, -1)).to(device)
        e_sign = torch.from_numpy(e_sign.reshape(num_rows, row_len)).to(device)
        for coeffs in prox_coeffs:
            c_mag8, c_sign = ints_to_mag8(coeffs, 8 * pp.zt.n_words)
            combined_rows.append(combine_rows_signed(
                torch.from_numpy(c_mag8).to(device), torch.from_numpy(c_sign).to(device),
                e_mag8, e_sign, 2 * pp.zt.m_words,
            ))

    log_rows = num_rows.bit_length() - 1
    lo = point[len(point) - log_rows :]
    if lo:
        q0 = build_eq_table_device(cfg, lo, device)  # (R, n32)
        e_f = z_f.reshape(num_rows, row_len, -1)
        prod = mont_mul(ctx, q0[:, None, :], e_f)  # (R, C, n32), K1
        combined_f = fm.mod_reduce_wide(ctx, fm.lazy_sum(ctx, prod, dim=0))
    else:
        combined_f = z_f

    for combined in combined_rows:
        transcript._write(combined.cpu().numpy().astype("<u4").tobytes())
    write_column_records(data, cols, depth, num_rows, transcript)
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


def write_column_records(
    data: DeviceZipData, cols: np.ndarray, depth: int, num_rows: int, transcript: PcsTranscript
) -> None:
    """Write the per-column opening records: values, then one path per row."""
    n_open = cols.shape[0]
    vals_d, sibs_d = dispatch_column_gathers(data, cols, depth)
    vals = vals_d.contiguous().cpu().numpy().view(np.uint32)  # (n_open, R, kw32)
    val_bytes = 4 * vals.shape[-1] * num_rows
    rec_bytes = val_bytes + num_rows * (8 + depth * 32)
    records = np.empty((n_open, rec_bytes), dtype=np.uint8)
    records[:, :val_bytes] = vals.astype("<u4").view(np.uint8).reshape(n_open, val_bytes)
    paths = records[:, val_bytes:].reshape(n_open, num_rows, 8 + depth * 32)
    paths[:, :, :8] = np.frombuffer(depth.to_bytes(8, "big"), np.uint8)
    for lvl, sib_d in enumerate(sibs_d):
        sib = sib_d.contiguous().cpu().numpy().astype("<u4")  # (n_open, R, 8)
        paths[:, :, 8 + lvl * 32 : 8 + (lvl + 1) * 32] = sib.view(np.uint8).reshape(
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
