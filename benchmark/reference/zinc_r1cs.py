"""What a Zinc proof of the dummy R1CS must say, from z alone.

The circuit is A = B = I, C = diag(z) over z = (z_0 ‖ 1 ‖ w), the public
input z_0 (the upstream ``test_utils.rs`` dummy).  ``check`` replays the
verifier's transcript over the proof's messages and holds every part of
the proof against values worked out here from z:

* the field q drawn from the public input;
* sumcheck 1 (Σ_x eq(β, x)·(Az·Bz − Cz)(x) = 0): each round's
  p(0) + p(1), and its last claim against eq(β, r_x)·(V_A·V_B − V_C);
* V_s, the three M̃z(r_x), exactly;
* sumcheck 2: each round, and its last claim against
  (Σ_j γ^j·M̃_j(r_x, r_y))·z̃(r_y);
* v = z̃(r_y), exactly;
* the Zip commitment's Merkle roots (RAA-encoded rows, BLAKE3 trees), and
  every byte of the PCS proof: the proximity row, the 1000 column records
  with their paths, the q₀-weighted field row.

A sumcheck message is judged by the verifier's rule against the true
oracle values: a round that differs from the honest one changes the claim
carried on, and the last check then fails but with probability about
degree / q.
"""

from __future__ import annotations

from math import isqrt

import numpy as np

from . import field as fl
from .blake3 import merkle_levels
from .raa import encode_rows, permutation, words_of
from .sumcheck import replay
from .transcript import Field, Transcript, draw_field

NUMBERS = ("field", "sc1_rounds", "sc1_final", "v_s", "sc2_rounds", "sc2_final", "v",
           "roots", "pcs_bytes")


def matrices(z: np.ndarray) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(rows, cols, values) of A, B and C."""
    idx = np.arange(len(z))
    ones = np.ones(len(z), np.int64)
    return [(idx, idx, ones), (idx, idx, ones), (idx, idx, z)]


def _mat_vec(m, zq, q):
    rows, cols, vals = m
    out = np.zeros(len(zq), dtype=object)
    np.add.at(out, rows, fl.as_ints(vals, q) * zq[cols])
    return out % q


def _bilinear(m, eq_rx, eq_ry, q):
    rows, cols, vals = m
    return fl.dot(fl.as_ints(vals, q), eq_rx[rows] * eq_ry[cols] % q, q)


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _mont_bytes(f: Field, values) -> bytes:
    return b"".join(f.mont(int(v)).to_bytes(f.nbytes, "big") for v in values)


def _int_bytes(values, nwords: int) -> bytes:
    return b"".join((int(v) % (1 << (64 * nwords))).to_bytes(8 * nwords, "little") for v in values)


def pcs_proof(z: np.ndarray, f: Field, r_y: list[int], seeds: tuple[int, int], cfg: dict):
    """(Merkle roots, PCS proof bytes) of the commitment to z opened at r_y."""
    n = len(z)
    num_vars = n.bit_length() - 1
    row_len = _next_pow2(isqrt(n))
    num_rows = _next_pow2(n // row_len)
    cw_len = row_len * cfg["repetition"]
    depth = (cw_len - 1).bit_length()
    nw = cfg["int_words"]
    rows = z.reshape(num_rows, row_len)

    p1, p2 = permutation(seeds[0], cw_len), permutation(seeds[1], cw_len)
    words = words_of(encode_rows(rows, p1, p2), 4 * nw)  # (R, cw, K words)
    leaves = words.astype(">u8").view(np.uint8).reshape(num_rows, cw_len, 32 * nw)
    levels = merkle_levels(leaves)
    roots = [bytes(levels[-1][r, 0]) for r in range(num_rows)]

    pcs = Transcript()
    parts = []
    rows_obj = rows.astype(object)
    for _ in range(cfg["proximity_tests"] if num_rows > 1 else 0):
        coeffs = np.array([pcs.integer_challenge(nw) for _ in range(num_rows)], dtype=object)
        parts.append(_int_bytes((coeffs[:, None] * rows_obj).sum(axis=0), 8 * nw))
    cols = np.array([f.mont(pcs.challenge(f)) % (1 << 32) % cw_len
                     for _ in range(cfg["openings"])], np.int64)
    values = words[:, cols].transpose(1, 0, 2).astype("<u8").view(np.uint8)
    paths = np.empty((len(cols), num_rows, 8 + 32 * depth), np.uint8)
    paths[:, :, :8] = np.frombuffer(depth.to_bytes(8, "big"), np.uint8)
    for d in range(depth):
        sib = levels[d][:, (cols >> d) ^ 1]  # (R, C, 32)
        paths[:, :, 8 + 32 * d:40 + 32 * d] = sib.transpose(1, 0, 2)
    records = np.concatenate([values.reshape(len(cols), -1), paths.reshape(len(cols), -1)], axis=1)
    parts.append(records.tobytes())
    log_rows = num_rows.bit_length() - 1
    q0 = fl.eq_table(r_y[num_vars - log_rows:], f.q) if log_rows else np.array([1], dtype=object)
    combined = (q0[:, None] * (rows_obj % f.q)).sum(axis=0) % f.q
    parts.append(_mont_bytes(f, combined))
    return roots, b"".join(parts)


def count_bytes_differing(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    x = np.frombuffer(a, np.uint8, n)
    y = np.frombuffer(b, np.uint8, n)
    return int(np.count_nonzero(x != y)) + abs(len(a) - len(b))


def check(z: np.ndarray, proof: dict, cfg: dict) -> dict[str, int]:
    """The count of disagreements of each kind (``NUMBERS``): all 0 for a
    right proof.  ``proof`` holds the program's proof as plain data: ``q``,
    ``sc1`` and ``sc2`` (each round's evaluations), ``v_s`` and ``v`` in
    Montgomery form, ``roots`` (bytes each) and ``pcs`` (bytes)."""
    out = dict.fromkeys(NUMBERS, 0)
    n = len(z)
    s = n.bit_length() - 1
    t = Transcript()
    f = draw_field([int(z[0])], t, cfg["int_words"], cfg["field_n64"])
    q = f.q
    out["field"] = int(proof["q"] != q)

    t.absorb(b"beta_s")
    beta = [t.challenge(f) for _ in range(s)]
    r_x, e1, out["sc1_rounds"] = replay(t, f, s, 3, 0, proof["sc1"])
    zq = fl.as_ints(z, q)
    mats = matrices(z)
    if len(r_x) == s:
        eq_rx = fl.eq_table(r_x, q)
        v_ref = [fl.dot(_mat_vec(m, zq, q), eq_rx, q) for m in mats]
        out["sc1_final"] = int(fl.eq_eval(beta, r_x, q) * (v_ref[0] * v_ref[1] - v_ref[2]) % q != e1)
        out["v_s"] = sum(int(f.mont(v) != m) for v, m in zip(v_ref, proof["v_s"]))
        out["v_s"] += abs(len(v_ref) - len(proof["v_s"]))
    else:
        out["sc1_final"], out["v_s"] = 1, len(mats)
        v_ref, eq_rx = [0] * len(mats), None

    t.absorb(b"gamma")
    gamma = t.challenge(f)
    v_s = [f.canon(m) for m in proof["v_s"]]
    claim2 = sum(v * pow(gamma, j, q) for j, v in enumerate(v_s)) % q
    r_y, e2, out["sc2_rounds"] = replay(t, f, s, 2, claim2, proof["sc2"])
    if len(r_y) == s and eq_rx is not None:
        eq_ry = fl.eq_table(r_y, q)
        m_xy = sum(pow(gamma, j, q) * _bilinear(m, eq_rx, eq_ry, q) for j, m in enumerate(mats))
        z_ry = fl.dot(zq, eq_ry, q)
        out["sc2_final"] = int(m_xy * z_ry % q != e2)
        out["v"] = int(f.mont(z_ry) != proof["v"])
    else:
        out["sc2_final"] = out["v"] = 1
        r_y = r_y if len(r_y) == s else [0] * s

    seeds = (t.u64(), t.u64())
    roots, pcs = pcs_proof(z, f, r_y, seeds, cfg)
    out["roots"] = sum(a != b for a, b in zip(roots, proof["roots"]))
    out["roots"] += abs(len(roots) - len(proof["roots"]))
    out["pcs_bytes"] = count_bytes_differing(pcs, proof["pcs"])
    return out
