"""ZincProof (de)serialization, in the wire format of ``zinc_tpu/serialize.py``:

    magic | u32 n64 | sumcheck 1 | sumcheck 2 | V_s | roots | v | pcs bytes

Field elements are their Montgomery residues, big-endian, 8·n64 bytes.
"""

from __future__ import annotations

import struct

from .fields.config import FieldConfig, Fp
from .spartan import SpartanProof
from .zinc import ZincProof, ZipProof
from .zip.pcs import ZipCommitment

_MAGIC = b"ZINCTPU1"


def _w_fp(out: bytearray, fe: Fp, cfg: FieldConfig) -> None:
    out += cfg.value_bytes_be(fe.m)


def _r_fp(data: memoryview, pos: int, cfg: FieldConfig) -> tuple[Fp, int]:
    n = 8 * cfg.n64
    if pos + n > len(data):
        raise ValueError("truncated proof")
    return cfg.fp_from_mont(int.from_bytes(bytes(data[pos : pos + n]), "big")), pos + n


def _w_rounds(out: bytearray, rounds: list, cfg: FieldConfig) -> None:
    out += struct.pack("<II", len(rounds), len(rounds[0]) if rounds else 0)
    for evals in rounds:
        for fe in evals:
            _w_fp(out, fe, cfg)


def _r_rounds(data: memoryview, pos: int, cfg: FieldConfig) -> tuple[list, int]:
    n_rounds, per = struct.unpack_from("<II", data, pos)
    pos += 8
    rounds = []
    for _ in range(n_rounds):
        evals = []
        for _ in range(per):
            fe, pos = _r_fp(data, pos, cfg)
            evals.append(fe)
        rounds.append(evals)
    return rounds, pos


def serialize_proof(proof: ZincProof, cfg: FieldConfig) -> bytes:
    out = bytearray(_MAGIC)
    out += struct.pack("<I", cfg.n64)
    _w_rounds(out, proof.spartan_proof.linearization_sumcheck, cfg)
    _w_rounds(out, proof.spartan_proof.second_sumcheck, cfg)
    out += struct.pack("<I", len(proof.spartan_proof.V_s))
    for fe in proof.spartan_proof.V_s:
        _w_fp(out, fe, cfg)
    roots = proof.zip_proof.z_comm.roots
    out += struct.pack("<I", len(roots))
    for r in roots:
        assert len(r) == 32
        out += r
    _w_fp(out, proof.zip_proof.v, cfg)
    out += struct.pack("<Q", len(proof.zip_proof.pcs_proof))
    out += proof.zip_proof.pcs_proof
    return bytes(out)


def deserialize_proof(data: bytes, cfg: FieldConfig) -> ZincProof:
    view = memoryview(data)
    if bytes(view[:8]) != _MAGIC:
        raise ValueError("bad proof magic")
    (n64,) = struct.unpack_from("<I", view, 8)
    if n64 != cfg.n64:
        raise ValueError(f"proof field width {n64} != config {cfg.n64}")
    pos = 12
    sc1, pos = _r_rounds(view, pos, cfg)
    sc2, pos = _r_rounds(view, pos, cfg)
    (n_vs,) = struct.unpack_from("<I", view, pos)
    pos += 4
    v_s = []
    for _ in range(n_vs):
        fe, pos = _r_fp(view, pos, cfg)
        v_s.append(fe)
    (n_roots,) = struct.unpack_from("<I", view, pos)
    pos += 4
    roots = []
    for _ in range(n_roots):
        roots.append(bytes(view[pos : pos + 32]))
        pos += 32
    v, pos = _r_fp(view, pos, cfg)
    (pcs_len,) = struct.unpack_from("<Q", view, pos)
    pos += 8
    pcs = bytes(view[pos : pos + pcs_len])
    if len(pcs) != pcs_len:
        raise ValueError("truncated PCS stream")
    return ZincProof(
        spartan_proof=SpartanProof(sc1, sc2, v_s),
        zip_proof=ZipProof(z_comm=ZipCommitment(roots), v=v, pcs_proof=pcs),
    )
