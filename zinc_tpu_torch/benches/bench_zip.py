"""Zip PCS benchmark of the port: the mirror of ``benches/bench_zip.py``
(itself the mirror of the Rust ``zip_benches.rs:225-268``).

    python -m zinc_tpu_torch.benches.bench_zip [log_n ...] [device]   # 12 14 16, cuda

A polynomial of 2^log_n 62-bit integers (seed 7), the RAA code with
``DefaultLinearCodeSpec`` and ``ZipTypes(1)``, q = 2^255 + 95.  Stages, each
run once warm and then timed on the host clock (the device synced):

- ``encode_rows``: the device RAA encode (``zip/device._raa_encode_rows``,
  the permutations uploaded once, as the JAX bench does);
- ``merkle_root``: the device BLAKE3 trees over those rows
  (``ops/blake3.merkle_tree_device``: on the card one ``blake3_leaves``
  launch, rows of up to 2^11 codewords being one launch);
- ``commit_no_merkle``: the host PCS's encode-only commit
  (``zip/pcs.commit_no_merkle``);
- ``commit``, ``open``: the device commit and open
  (``zip/device.commit_device``, ``open_device``);
- ``verify``: ``zip/pcs.verify_poly`` on the device, which must accept;
- the proof's bytes.

On the CPU the sizes default to 2^8.
"""

from __future__ import annotations

import random
import sys

import numpy as np
import torch

from ..fields.config import FieldConfig
from ..fields.integers import vector_to_words
from ..ops.blake3 import merkle_tree_device
from ..ops.field_map import vector_to_field
from ..poly.mle import DenseMleZ
from ..transcript import KeccakTranscript
from ..zip.code import DefaultLinearCodeSpec, RaaCode, ZipTypes
from ..zip.device import _raa_encode_rows, commit_device, open_device
from ..zip.pcs import commit_no_merkle, setup, verify_poly
from ..zip.transcript import PcsTranscript
from ._common import device_line, emit, parse, wall_s

ZT = ZipTypes(1)
Q = (1 << 255) + 95


def _warm_then_timed(fn, device):
    """(result, seconds) of the second of two calls."""
    wall_s(fn, device)
    return wall_s(fn, device)


def run(log_n: int, device) -> list[dict]:
    cfg = FieldConfig(Q, 4)
    n = 1 << log_n
    rng = random.Random(7)
    z_vals = np.array([rng.randrange(-(1 << 62), 1 << 62) for _ in range(n)], np.int64)
    t = KeccakTranscript()
    t.absorb(b"bench")
    pp = setup(n, RaaCode(DefaultLinearCodeSpec(), n, t, ZT), ZT)

    z_words = vector_to_words(z_vals, 2 * ZT.n_words, device)
    p1, p2 = (torch.from_numpy(np.asarray(p, np.int64)).to(device) for p in pp.code.permutations())
    enc, encode_s = _warm_then_timed(lambda: _raa_encode_rows(
        z_words, pp.code.row_len, pp.code.repetition_factor, 2 * ZT.k_words, p1, p2), device)
    _, merkle_s = _warm_then_timed(lambda: merkle_tree_device(enc, ZT.k_words), device)
    poly = DenseMleZ(log_n, z_vals.tolist())
    _, commit_nm_s = _warm_then_timed(lambda: commit_no_merkle(pp, poly), device)
    (data, comm), commit_s = _warm_then_timed(lambda: commit_device(pp, z_vals, cfg, device), device)

    point = [cfg.fp(rng.randrange(cfg.q)) for _ in range(log_n)]
    z_f = vector_to_field(cfg, z_vals, device)

    def open_():
        pt = PcsTranscript()
        open_device(pp, z_vals, z_f, data, point, cfg, pt)
        return pt.into_proof()

    proof, open_s = _warm_then_timed(open_, device)
    v = poly.map_to_field(cfg).evaluate(point)
    _, verify_s = _warm_then_timed(
        lambda: verify_poly(pp, comm, point, v, PcsTranscript.from_proof(proof), cfg, device), device)

    return [
        emit(f"zip_encode_rows_2p{log_n}", encode_s * 1e3, "ms"),
        emit(f"zip_merkle_root_2p{log_n}", merkle_s * 1e3, "ms"),
        emit(f"zip_commit_no_merkle_2p{log_n}", commit_nm_s * 1e3, "ms"),
        emit(f"zip_commit_2p{log_n}", commit_s * 1e3, "ms"),
        emit(f"zip_open_2p{log_n}", open_s * 1e3, "ms"),
        emit(f"zip_verify_2p{log_n}", verify_s * 1e3, "ms"),
        emit(f"zip_proof_bytes_2p{log_n}", len(proof), "bytes"),
    ]


def main(argv: list[str]) -> list[dict]:
    sizes, device = parse(argv[1:], [12, 14, 16], [8])
    print(device_line(device), flush=True)
    return [rec for log_n in sizes for rec in run(log_n, device)]


if __name__ == "__main__":
    main(sys.argv)
