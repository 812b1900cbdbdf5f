"""The Zip PCS commit and open with the codeword matrix sharded over a mesh.

The port of ``zinc_tpu/parallel/zip.py``.  Encoding, leaf hashing and every
Merkle level are row-independent, so the 1-D commit gives each shard a
contiguous block of rows: it encodes them (RAA, or the ZipLinearCode's
exact float64 product) and hashes them on its own device, and only the
32-byte roots come back.  The 2-D commit ("r" × "c") shards rows over "r"
and each row's interior over "c": the RAA code's two prefix sums become
distributed scans (a local ``cumsum_wrap``, an exclusive scan of the c
blocks' totals and an add, all mod 2^(64·k_words)), the permutations read
the row gathered over "c", and each c block hashes its own subtree, whose
roots are merged on the row block's first device.  The open is
``zip/device.py:open_device`` given the row blocks (the reference's
``open_device_sharded``): it sums each block's proximity accumulator and
q₀-weighted row before the one carry and the one reduction mod q, and writes
the blocks' column records in row order.

On a mesh over several processes (``mesh.group``, a ("host", "chip") mesh)
each process commits its own "host" rows, with the column split on its own
"chip" devices, so the distributed prefix sums never cross processes; the
row roots are all-gathered in row order.  The open all-gathers its integer
accumulators and column records (``zip/device.py``).

When the rows (or, in 2-D, the codeword) do not split evenly, the commit
runs on the mesh's first device, as the reference's does; ``mesh.stats
["commit"]`` notes the layout that ran.  Roots, layers and proof bytes
equal the single-device commit's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import montgomery as fm
from ..fields.config import FieldConfig
from ..fields.integers import cumsum_wrap, sign_extend
from ..fields.montgomery import carry
from ..ops.blake3 import merge_level, merkle_tree_device
from ..zip.device import (
    DeviceZipData,
    _z_words,
    _zlc_dense_matrix,
    _zlc_encode_rows,
    commit_device,
    encode_rows,
    roots_of,
)
from ..zip.pcs import ZipCommitment, ZipParams
from .mesh import Mesh, fetch_global


def _row_values(z_values, n_blocks: int) -> list:
    """The witness values cut into n_blocks equal row blocks."""
    if isinstance(z_values, np.ndarray):
        return list(z_values.reshape(n_blocks, -1))
    step = len(z_values) // n_blocks
    return [z_values[s * step : (s + 1) * step] for s in range(n_blocks)]


def _all_roots(datas, mesh: Mesh) -> ZipCommitment:
    """The commitment: the local row blocks' roots and, over several
    processes, every process's, in row order."""
    roots = [root for data in datas for root in roots_of(data.layers)]
    if mesh.group is not None:
        parts = mesh.group.all_gather_array(np.frombuffer(b"".join(roots), np.uint8))
        roots = [bytes(p[i : i + 32]) for p in parts for i in range(0, len(p), 32)]
    return ZipCommitment(roots)


def commit_device_sharded(pp: ZipParams, z_values, cfg: FieldConfig, mesh: Mesh):
    """Row-sharded commit over the mesh's shards: (a DeviceZipData per row
    block, the commitment); roots and layers equal ``commit_device``'s."""
    d = mesh.size
    if pp.num_rows % d:
        mesh.note("commit", "one device")
        return commit_device(pp, z_values, cfg, mesh.first)
    datas = []
    mine = _row_values(z_values, d)[mesh.shard_offset :]
    for vals, dev in zip(mine, mesh.local_flat):  # every shard queued first
        enc = encode_rows(pp, _z_words(vals, pp.zt.n_words, dev))
        datas.append(DeviceZipData(fm.narrow(enc), merkle_tree_device(enc, pp.zt.k_words)))
    mesh.note("commit", f"{d} row blocks")
    return datas, _all_roots(datas, mesh)


def _dist_cumsum(locals_: list[torch.Tensor], kw32: int) -> list[torch.Tensor]:
    """The prefix sum along dim 1 of a row split into c blocks, block j on
    its device: a local ``cumsum_wrap``, plus the exclusive scan of the
    preceding blocks' totals, mod 2^(32·kw32) as ``cumsum_wrap`` wraps."""
    scanned = [cumsum_wrap(x, dim=1) for x in locals_]
    out = []
    for j, cs in enumerate(scanned):
        if j == 0:
            out.append(cs)
            continue
        lazy_off = sum(scanned[k][:, -1, :].to(cs.device) for k in range(j))  # < j·2^32
        out.append(carry(cs + carry(lazy_off, kw32)[:, None, :], kw32))
    return out


def _encode_2d(pp: ZipParams, rows: list[torch.Tensor], chunk: int) -> list[torch.Tensor]:
    """One row block's codeword split over "c": rows[j] holds the block's
    witness words on c shard j; returns the (R_loc, chunk, kw32) blocks."""
    kw32 = 2 * pp.zt.k_words
    row_len = pp.code.row_len
    cuts = [slice(j * chunk, (j + 1) * chunk) for j in range(len(rows))]
    if not hasattr(pp.code, "permutations"):  # ZipLinearCode: the matrix's rows split over "c"
        mat = _zlc_dense_matrix(pp.code)
        return [_zlc_encode_rows(x, torch.from_numpy(mat[cut]).to(x.device), kw32)
                for x, cut in zip(rows, cuts)]
    p1, p2 = (torch.from_numpy(np.asarray(p, np.int64)) for p in pp.code.permutations())
    full = [torch.cat([sign_extend(x, kw32).reshape(-1, row_len, kw32)] * pp.code.repetition_factor,
                      dim=1) for x in rows]
    local = _dist_cumsum([f[:, p1[cut].to(f.device)] for f, cut in zip(full, cuts)], kw32)
    regathered = [fetch_global(local, 1, x.device) for x in rows]
    return _dist_cumsum([g[:, p2[cut].to(g.device)] for g, cut in zip(regathered, cuts)], kw32)


def commit_device_sharded_2d(pp: ZipParams, z_values, cfg: FieldConfig, mesh: Mesh):
    """Commit over an ("r", "c") mesh: rows over "r", each row's codeword
    over "c".  Returns (a DeviceZipData per local "r" block, on that block's
    first device, the commitment); roots and layers equal
    ``commit_device``'s."""
    r_size, c_size = mesh.devices.shape
    cw = pp.code.codeword_len()
    chunk = cw // c_size
    if (pp.num_rows % r_size or cw % c_size or chunk & (chunk - 1) or c_size & (c_size - 1)):
        mesh.note("commit", "one device")
        return commit_device(pp, z_values, cfg, mesh.first)
    row_vals = _row_values(z_values, r_size)
    local = [(row_vals[r], mesh.devices[r]) for r in mesh.local_rows]
    subtrees = []
    for vals, devs in local:  # every shard queued first
        enc = _encode_2d(pp, [_z_words(vals, pp.zt.n_words, dev) for dev in devs], chunk)
        subtrees.append([(e, merkle_tree_device(e, pp.zt.k_words)) for e in enc])
    datas = []
    for subs, (_, devs) in zip(subtrees, local):
        home = devs[0]
        joined = [fetch_global([layers[lvl] for _, layers in subs], 1, home)
                  for lvl in range(len(subs[0][1]))]
        level = joined[-1]  # (R_loc, c, 8): the subtrees' roots
        while level.shape[1] > 1:
            level = merge_level(level)
            joined.append(level)
        enc = fetch_global([e for e, _ in subs], 1, home)
        datas.append(DeviceZipData(fm.narrow(enc), joined))
    mesh.note("commit", f"{r_size} row blocks x {c_size} column blocks")
    return datas, _all_roots(datas, mesh)

