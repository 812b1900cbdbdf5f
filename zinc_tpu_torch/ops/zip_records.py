"""The Zip open's column records: the CUDA kernel and its plain version.

The port of the gathers and the record assembly of ``zinc_tpu/zip/
device.py:261-346`` (XLA and numpy in the reference, not Pallas).  A record
opens one column of the committed codeword rows: each row's value as its
kw32 little-endian u32 words, then one Merkle path a row, its depth as 8
big-endian bytes and each level's sibling ((col >> l) ^ 1 at level l) as 8
little-endian u32, the bytes ``zip/pcs.py:open_poly`` writes.  Of R rows of
cw = 2^depth codewords a record is ``record_bytes(R, kw32, depth)`` bytes:
``R·4·kw32`` of values, then ``R·(8 + 32·depth)`` of paths.

On a CUDA tensor :func:`pack_records` writes every record in one launch of
``csrc/zip_records.cu``, built into the BLAKE3 target's library (it takes no
field).  The plain version (:func:`pack_records_plain`, torch gathers of
every level at once) serves CPU tensors and the tests, and is what the card
tests and ``chip_smoke.py`` hold the kernel against.

Wrapper rule: a CPU tensor goes to the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.montgomery import narrow
from . import _cuda

M32 = 0xFFFFFFFF
MAX_DEPTH = 32  # csrc/zip_records.cu's ZR_MAX_DEPTH


def record_bytes(rows: int, kw32: int, depth: int) -> tuple[int, int]:
    """(value bytes, path bytes) of one record of ``rows`` rows."""
    return rows * 4 * kw32, rows * (8 + 32 * depth)


def _check(enc: torch.Tensor, layers, cols: torch.Tensor, depth: int) -> None:
    if enc.dtype != torch.int32 or cols.dtype != torch.int64:
        raise TypeError(f"pack_records: expected int32 words and int64 columns, got {enc.dtype} "
                        f"and {cols.dtype}")
    if enc.dim() != 3 or enc.shape[2] % 2 or cols.dim() != 1:
        raise ValueError(f"pack_records: expected (R, cw, kw32) words, kw32 even, and a vector of "
                         f"columns, got {tuple(enc.shape)} and {tuple(cols.shape)}")
    rows, cw, _ = enc.shape
    if not 0 <= depth <= MAX_DEPTH or cw != 1 << depth or len(layers) < depth:
        raise ValueError(f"pack_records: {cw} codewords a row and {len(layers)} levels for a "
                         f"path of depth {depth}")
    for lvl in range(depth):
        x = layers[lvl]
        if x.dtype != torch.int64 or tuple(x.shape) != (rows, cw >> lvl, 8):
            raise ValueError(f"pack_records: level {lvl} is {x.dtype} {tuple(x.shape)}, not int64 "
                             f"{(rows, cw >> lvl, 8)}")
    devices = {enc.device, cols.device} | {layers[lvl].device for lvl in range(depth)}
    if len(devices) > 1:
        raise ValueError(f"pack_records: tensors on different devices {sorted(map(str, devices))}")


def pack_records_plain(enc: torch.Tensor, layers, cols: torch.Tensor, depth: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`pack_records` (any device)."""
    rows, cw, _ = enc.shape
    n = cols.shape[0]
    vals = enc[:, cols, :].transpose(0, 1).contiguous().view(torch.uint8).reshape(n, rows, -1)
    header = torch.tensor(list(depth.to_bytes(8, "big")), dtype=torch.uint8, device=enc.device)
    paths = header.expand(n, rows, 8)
    if depth:
        # every level side by side, and each record's siblings gathered at once
        starts = torch.tensor([sum(cw >> k for k in range(lvl)) for lvl in range(depth)],
                              dtype=torch.int64, device=enc.device)
        lvl = torch.arange(depth, device=enc.device)
        sib = starts + ((cols[:, None] >> lvl) ^ 1)  # (n, depth)
        flat = torch.cat([layers[k] for k in range(depth)], dim=1)
        digests = narrow(flat[:, sib.reshape(-1), :] & M32)  # (R, n·depth, 8) int32
        body = digests.reshape(rows, n, depth * 8).transpose(0, 1).contiguous().view(torch.uint8)
        paths = torch.cat([paths, body], dim=2)
    return torch.cat([vals.reshape(n, -1), paths.reshape(n, -1)], dim=1)


def pack_records(enc: torch.Tensor, layers, cols: torch.Tensor, depth: int) -> torch.Tensor:
    """The records of the columns ``cols`` as one (n_open, rec_bytes) uint8
    tensor on ``enc``'s device.

    enc: (R, cw, kw32) int32 words of the codeword rows, cw = 2^depth, kw32
    even; layers: the rows' Merkle levels, leaves first, level l (R, cw >> l,
    8) int64 digest lanes (at least ``depth`` of them); cols: (n_open,) int64
    column indices below cw, on the same device."""
    _check(enc, layers, cols, depth)
    if not enc.is_cuda:
        return pack_records_plain(enc, layers, cols, depth)
    rows, cw, kw32 = enc.shape
    enc, cols = enc.contiguous(), cols.contiguous()
    if enc.data_ptr() % 8:
        raise ValueError("pack_records: CUDA words must be 8-byte aligned (a pair a load)")
    levels = [layers[lvl].contiguous() for lvl in range(depth)]
    ptrs = np.array([x.data_ptr() for x in levels] or [0], dtype=np.int64)
    out = torch.empty((cols.shape[0], sum(record_bytes(rows, kw32, depth))), dtype=torch.uint8,
                      device=enc.device)
    with _cuda.on_device(enc):
        rc = _cuda.blake3_lib().zt_zip_records(
            out.data_ptr(), enc.data_ptr(), cols.data_ptr(), ptrs.ctypes.data, cols.shape[0], rows,
            cw, kw32, depth, _cuda.stream_ptr(enc.device))
    _cuda.check(rc, "zip_records")
    _cuda.LAUNCHES["zip_records"] += 1
    return out
