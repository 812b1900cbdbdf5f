"""Zip PCS: parameters, the host commit and open, and the verifier.

The port of ``zinc_tpu/zip/pcs.py``.  ``commit``, ``commit_no_merkle``,
``batch_commit``, ``open_poly`` and ``batch_open`` are the host backend's
PCS in Python ints (``zinc_tpu/zip/pcs.py:53-189``): the oracle that the
device commit and open (``zip/device.py``) are held to.  The verifier
squeezes every column index first, parses all opened records in one numpy
pass, folds the Merkle paths with the port's native runtime
(``csrc/zinc_native.cpp``, loaded by ``native.py``) and runs the two
proximity checks on ``device``, in a background thread that the host joins
before it raises.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..fields.config import FieldConfig, Fp
from ..hashing.blake3 import blake3
from ..native import blake3_batch, merkle_fold_batch_strided
from ..poly.mle import DenseMleZ, build_eq_x_r_vec
from ..zip.merkle import MerkleTree, int_to_leaf_bytes, verify_merkle_path
from ..zip.transcript import PcsTranscript
from ..fields import montgomery as fm
from ..fields.integers import combine_rows_signed, ints_to_mag8, ints_to_words_signed
from ..ops._cuda import target_device
from ..ops.field_kernels import mont_mul
from ..ops.field_map import _wide_to_field
from ..poly.device import fps_to_tensor
from ..timing import timed


class PcsError(Exception):
    pass


class MerkleError(PcsError):
    """Merkle-layer failure (bad path depth, root mismatch)."""


@dataclass
class ZipParams:
    num_vars: int
    num_rows: int
    code: object  # RaaCode
    zt: object  # ZipTypes


@dataclass
class ZipCommitmentData:
    """Prover-side data of the host commit: encoded rows (flat, row-major)
    and one Merkle tree per row."""

    rows: list  # list[int], num_rows * codeword_len entries (width K)
    trees: list  # list[MerkleTree]

    def roots(self) -> list[bytes]:
        return [t.root for t in self.trees]


@dataclass
class ZipCommitment:
    roots: list  # list[bytes]


def setup(poly_size: int, code, zt) -> ZipParams:
    assert poly_size & (poly_size - 1) == 0
    num_vars = poly_size.bit_length() - 1
    num_rows = (1 << num_vars) // code.row_len
    num_rows = 1 if num_rows <= 1 else 1 << (num_rows - 1).bit_length()
    return ZipParams(num_vars=num_vars, num_rows=num_rows, code=code, zt=zt)


def _validate(tag: str, pp: ZipParams, poly: DenseMleZ | None, points: list) -> None:
    if poly is not None and pp.num_vars < poly.num_vars:
        raise PcsError(f"too many variates to {tag} ({pp.num_vars} < {poly.num_vars})")
    nv = poly.num_vars if poly is not None else (len(points[0]) if points else 0)
    for p in points:
        if len(p) != nv:
            raise PcsError(f"invalid point length {len(p)} != {nv}")


def commit(pp: ZipParams, poly: DenseMleZ) -> tuple[ZipCommitmentData, ZipCommitment]:
    """The host commit: each row RAA-encoded (or by the ZipLinearCode) and
    one BLAKE3 Merkle tree per row; the commitment is the rows' roots."""
    _validate("commit", pp, poly, [])
    row_len = pp.code.row_len
    codeword_len = pp.code.codeword_len()
    expected = pp.num_rows * row_len
    assert len(poly.evaluations) == expected, (
        f"polynomial has {len(poly.evaluations)} evaluations, expected {expected}"
    )
    depth = max((codeword_len - 1).bit_length(), 0)

    rows: list[int] = []
    trees: list[MerkleTree] = []
    kw = pp.zt.k_words
    for r in range(pp.num_rows):
        codeword = pp.code.encode(poly.evaluations[r * row_len : (r + 1) * row_len])
        rows.extend(codeword)
        trees.append(MerkleTree.from_leaves(depth, [int_to_leaf_bytes(v, kw) for v in codeword]))
    return ZipCommitmentData(rows, trees), ZipCommitment([t.root for t in trees])


def commit_no_merkle(pp: ZipParams, poly: DenseMleZ) -> tuple[ZipCommitmentData, ZipCommitment]:
    """Encode-only commit: the rows, no trees and no roots (the reference's
    benchmark variant)."""
    _validate("commit", pp, poly, [])
    row_len = pp.code.row_len
    rows: list[int] = []
    for r in range(pp.num_rows):
        rows.extend(pp.code.encode(poly.evaluations[r * row_len : (r + 1) * row_len]))
    return ZipCommitmentData(rows, []), ZipCommitment([])


def batch_commit(pp: ZipParams, polys: list[DenseMleZ]):
    return [commit(pp, p) for p in polys]


def _left_tensor(num_rows: int, point: list[Fp], cfg: FieldConfig) -> list[Fp]:
    """q_0: the eq table of the point's last log2(num_rows) coordinates, the
    row variables; [1] for one row."""
    log_rows = num_rows.bit_length() - 1
    lo = point[len(point) - log_rows :]
    return build_eq_x_r_vec(lo) if lo else [cfg.one()]


def _point_to_tensor(num_rows: int, point: list[Fp], cfg: FieldConfig):
    """(q_0, q_1): the eq tables of the point's row and column variables.
    One row has no row variables, and q_0 is [1]: the field phase then
    checks f(v_c) == encode_f(row)[c] for each opened column, the single-row
    check of ``zinc_tpu/zip/pcs.py:467-475``."""
    log_rows = num_rows.bit_length() - 1
    hi = point[: len(point) - log_rows]
    return _left_tensor(num_rows, point, cfg), (build_eq_x_r_vec(hi) if hi else [])


def open_poly(
    pp: ZipParams,
    poly: DenseMleZ,
    data: ZipCommitmentData,
    point: list[Fp],
    cfg: FieldConfig,
    transcript: PcsTranscript,
) -> None:
    """The host open: the proximity rows, the 1000 column records, then the
    q_0-weighted field row; the bytes ``zip/device.py:open_device`` writes."""
    _validate("open", pp, poly, [point])
    row_len = pp.code.row_len
    codeword_len = pp.code.codeword_len()

    # ---- testing phase ----------------------------------------------------
    if pp.num_rows > 1:
        for _ in range(pp.code.num_proximity_testing()):
            coeffs = transcript.fs.get_integer_challenges(pp.num_rows, pp.zt.n_words)
            combined = [
                sum(coeffs[r] * poly.evaluations[r * row_len + c] for r in range(pp.num_rows))
                for c in range(row_len)
            ]
            transcript.write_integers(combined, pp.zt.m_words)

    for _ in range(pp.code.num_column_opening()):
        column = transcript.squeeze_challenge_idx(cfg, codeword_len)
        transcript.write_integers(
            [data.rows[r * codeword_len + column] for r in range(pp.num_rows)], pp.zt.k_words
        )
        for tree in data.trees:
            transcript.write_merkle_path(tree.path(column))

    # ---- evaluation phase -------------------------------------------------
    q_0 = _left_tensor(pp.num_rows, point, cfg)
    evaluations_f = [cfg.fp(v) for v in poly.evaluations]
    if pp.num_rows > 1:
        combined_row = []
        for c in range(row_len):
            acc = cfg.zero()
            for r in range(pp.num_rows):
                acc = acc + q_0[r] * evaluations_f[r * row_len + c]
            combined_row.append(acc)
    else:
        combined_row = evaluations_f
    transcript.write_field_elements(combined_row)


def batch_open(pp, polys, datas, points, cfg, transcript):
    for poly, data, point in zip(polys, datas, points):
        open_poly(pp, poly, data, point, cfg, transcript)


def _device_checks(pp, cfg, device, mag32, neg, prox, cols, q_0, encoded_f) -> list:
    """The proximity checks on the device: [(ok, message)]."""
    n_open, num_rows, w32 = mag32.shape
    out = []
    mag_d = torch.from_numpy(mag32.astype(np.int64)).to(device)  # (C, R, W) words
    neg_d = torch.from_numpy(neg.astype(np.int64)).to(device)  # (C, R)
    # integer phase: Σ_r coeff_r·v_{r,c} against the re-encoded claimed rows
    mag8 = mag32.astype("<u4").view(np.uint8).reshape(n_open, num_rows, 4 * w32)
    eval_mag8 = torch.from_numpy(np.ascontiguousarray(mag8.transpose(1, 0, 2))).to(device)
    eval_sign = (1 - 2 * neg_d).transpose(0, 1)
    out_words = 2 * pp.zt.m_words
    for coeffs, encoded in prox:
        c_mag8, c_sign = ints_to_mag8(coeffs, 8 * pp.zt.n_words)
        combined = combine_rows_signed(
            torch.from_numpy(c_mag8).to(device), torch.from_numpy(c_sign).to(device),
            eval_mag8, eval_sign, out_words,
        )
        expected = ints_to_words_signed([encoded[c] for c in cols.tolist()], out_words)
        ok = torch.equal(combined, torch.from_numpy(expected.astype(np.int64)).to(device))
        out.append((ok, "proximity failure (integer phase)"))
    # field phase: Σ_r q0_r·f(v_{r,c}) against the field re-encode
    ctx = fm.device_field(cfg)
    vals_f = _wide_to_field(ctx, mag_d.reshape(-1, w32), neg_d.reshape(-1))
    prod = mont_mul(ctx, fps_to_tensor(q_0, cfg, device)[None], vals_f.reshape(n_open, num_rows, -1))
    combined_f = fm.mod_reduce_wide(ctx, fm.lazy_sum(ctx, prod, dim=1))
    expected_f = fps_to_tensor([encoded_f[c] for c in cols.tolist()], cfg, device)
    out.append((torch.equal(combined_f, expected_f), "proximity failure (field phase)"))
    return out


def verify_poly(
    pp: ZipParams,
    comm: ZipCommitment,
    point: list[Fp],
    eval_claim: Fp,
    transcript: PcsTranscript,
    cfg: FieldConfig,
    device="cuda",
) -> None:
    device = target_device(device)
    row_len = pp.code.row_len
    cw = pp.code.codeword_len()
    kw = pp.zt.k_words
    num_rows = pp.num_rows

    # ---- testing phase (one row: no proximity rows, as open_poly writes) ---
    prox = []
    with timed("verify.prox_read_encode"):
        for _ in range(pp.code.num_proximity_testing() if num_rows > 1 else 0):
            coeffs = transcript.fs.get_integer_challenges(num_rows, pp.zt.n_words)
            combined_row = transcript.read_integers(row_len, pp.zt.m_words)
            prox.append((coeffs, pp.code.encode(combined_row)))

    n_open = pp.code.num_column_opening()
    depth = (cw - 1).bit_length() if cw > 1 else 0
    cols = np.array(
        [transcript.squeeze_challenge_idx(cfg, cw) for _ in range(n_open)], dtype=np.int64
    )
    with timed("verify.parse_records"):
        val_bytes = num_rows * kw * 8
        rec_bytes = val_bytes + num_rows * (8 + depth * 32)
        raw = transcript._read(n_open * rec_bytes)
        rec = np.frombuffer(raw, np.uint8).reshape(n_open, rec_bytes)
        words = np.ascontiguousarray(rec[:, :val_bytes]).view("<u8").reshape(n_open, num_rows, kw)
        pathsec = rec[:, val_bytes:].reshape(n_open, num_rows, 8 + depth * 32)
        # sign/magnitude of the opened two's-complement values
        neg = (words[:, :, kw - 1] >> np.uint64(63)).astype(bool)
        mag = words.copy()
        if neg.any():
            inv = ~words[neg]
            c = np.ones(inv.shape[:-1], np.uint64)
            for w in range(kw):
                s = inv[..., w] + c
                inv[..., w] = s
                c = (s < c).astype(np.uint64)
            mag[neg] = inv
        mag32 = mag.view("<u4").reshape(n_open, num_rows, 2 * kw)

    # ---- evaluation phase reads -------------------------------------------
    with timed("verify.eval_read_tensor"):
        q_0_combined_row = transcript.read_field_elements(row_len, cfg)
        q_0, q_1 = _point_to_tensor(num_rows, point, cfg)
    with timed("verify.field_reencode"):
        encoded_f = pp.code.encode_f(q_0_combined_row, cfg)
        acc = cfg.zero()
        for a, b in zip(q_0_combined_row, q_1):
            acc = acc + a * b
        if not acc == eval_claim:
            raise PcsError("evaluation consistency failure")

    # ---- device checks in the background, Merkle folds on the host --------
    done: dict = {}

    def _run_device_checks():
        try:
            done["checks"] = _device_checks(pp, cfg, device, mag32, neg, prox, cols, q_0, encoded_f)
        except BaseException as e:  # re-raised after the join
            done["error"] = e

    worker = threading.Thread(target=_run_device_checks, daemon=True)
    worker.start()
    try:
        if not (pathsec[:, :, :8] == np.frombuffer(depth.to_bytes(8, "big"), np.uint8)).all():
            raise MerkleError("inconsistent Merkle path depth")
        leaves = words.astype(">u8").tobytes()  # LE word order, BE bytes per word
        n_paths = n_open * num_rows
        with timed("verify.leaf_hash"):
            hashed = blake3_batch(leaves, n_paths, kw * 8)
        if hashed is None:
            hashed = b"".join(blake3(leaves[i * kw * 8 : (i + 1) * kw * 8]) for i in range(n_paths))
        indices = np.repeat(cols, num_rows)
        with timed("verify.merkle_fold"):
            folded = merkle_fold_batch_strided(
                hashed, raw, val_bytes + 8, rec_bytes, num_rows, 8 + depth * 32, indices, depth,
            )
        if folded is not None:
            folded_arr = np.frombuffer(folded, np.uint8).reshape(n_open, num_rows, 32)
            roots = np.frombuffer(b"".join(comm.roots), np.uint8).reshape(num_rows, 32)
            if not np.array_equal(folded_arr, np.broadcast_to(roots, folded_arr.shape)):
                raise MerkleError("Merkle path verification failed")
        else:
            sib_bytes = np.ascontiguousarray(pathsec[:, :, 8:]).tobytes()
            for i in range(n_paths):
                lb = leaves[i * kw * 8 : (i + 1) * kw * 8]
                pb = sib_bytes[i * depth * 32 : (i + 1) * depth * 32]
                path = [pb[32 * d : 32 * d + 32] for d in range(depth)]
                if not verify_merkle_path(comm.roots[i % num_rows], lb, int(indices[i]), path):
                    raise MerkleError("Merkle path verification failed")
    finally:
        worker.join()  # never leave a thread inside device work behind a raise

    with timed("verify.fetch_device"):
        if "error" in done:
            raise done["error"]
        for ok, msg in done["checks"]:
            if not ok:
                raise PcsError(msg)


def batch_verify(pp, comms, points, evals, transcript, cfg, device="cuda"):
    for comm, point, ev in zip(comms, points, evals):
        verify_poly(pp, comm, point, ev, transcript, cfg, device)
