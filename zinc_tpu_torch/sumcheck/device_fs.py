"""The sumcheck with device-resident Fiat-Shamir: one host sync a sumcheck.

The port of ``zinc_tpu/sumcheck/device_fs.py``.  The per-round executor
(``executor.py``) fetches every round's sums and squeezes on the host, one
sync a round.  Here the host absorbs nvars and the degree, exports its
Keccak sponge once (``ops/keccak_kernel.py:DeviceSponge``), and then only
queues work: every round that keeps more than ``HOST_TAIL`` entries runs
the executor's launches (``DeviceSumcheckExecutor.launch_round``: fold by
the challenge that lies on the card, then evaluate, on any of its three
tiers) and :func:`fs_round`, which turns the round's sums into s(0..d),
absorbs them, squeezes r and writes it where the next fold reads it.
After the last device round ONE fetch brings the evaluations, the
challenges, the sponge and the remaining tables (for Gruen with the folded
eq row pref·E) to the host, which writes the sponge back into the
transcript and finishes the tail (:func:`_host_tail`, as
``device_fs.py:506-537``).  Transcripts, proofs and final values are those
of the host prover, bit for bit.

**On a mesh** (``mesh=``) the executor's blocks are the mesh's shards
(``parallel/sumcheck.py``).  Each shard folds its block by the challenge on
the card and evaluates it, launching on its own device; the round's D sum
buffers go to the mesh's first device by device-to-device copies, where
``fs_round`` adds them mod q, forms the round's values and squeezes; and r
goes back to every shard the same way before the shard's next fold reads
it.  None of this passes through the host, and torch orders every
cross-device copy after the producing stream's work and before the
consuming stream's.  In one process the sponge runs once, on the first
device, and its r is copied out (the reference replicates it on every
device after a psum).  Once a shard's block has at most ``HOST_TAIL``
entries the blocks are joined on the first device (a ``torch.cat`` on the
card), and its device rounds go on there until the one fetch.  Where the
shards do not divide the hypercube the tables stay whole on the first
device, and the rounds are one device's.

Over processes (``mesh.group``) each process does this for its own shards,
and each round all-gathers the processes' stacked sums in rank order onto
its first device (``ProcessGroup.all_gather_stacked``) before
``fs_round``; every process then runs the same sponge on the same sums, as
the reference replicates it after its psum, so r needs no broadcast.  The
hand-over all-gathers the blocks the same way.  Under NCCL all of it stays
on the cards; gloo stages a card's tensors through the host, and each
staged copy counts as a fetch in ``executor.SUMCHECKS``.

The sponge's fill level needs no device state: every absorb has a size the
host knows, so it follows the sizes (a frame is 2·nbytes + 4 bytes, a
round absorbs (d+1) frames, the 34-byte ratchet and r's frame).

:func:`fs_round` is the wrapper of the CUDA kernel ``csrc/fs.cu``; a CPU
tensor takes :func:`fs_round_plain`, the same round in plain torch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import montgomery as fm
from ..fields.config import FieldConfig, Fp
from ..fields.montgomery import DeviceField
from ..ops import _cuda
from ..ops.keccak_kernel import (
    RATE,
    STATE_WORDS,
    DeviceSponge,
    absorb,
    digest,
    pack_state,
    unpack_state,
)
from ..poly.device import fps_to_tensor, limbs_to_fps
from ..timing import timed
from ..transcript import KeccakTranscript
from .executor import HOST_TAIL, SUMCHECKS, DeviceSumcheckExecutor, make_executor
from .prover import _absorb_nvars_degree, _fold, _round_evals

FS_MAX_TERMS = 32  # terms of a round's combination: a lane each in fs.cu (the round kernels' most)


def round_absorb_bytes(cfg: FieldConfig, degree: int) -> int:
    """Bytes a round absorbs: d+1 evaluations and r, each a frame of
    2·nbytes + 4 bytes (``transcript.py:absorb_field``), and the 34-byte
    ratchet 0x00 ‖ digest ‖ 0x01."""
    return (degree + 2) * (2 * cfg.nbytes + 4) + 34


def device_rounds(size: int, nvars: int) -> int:
    """Rounds that run on the device: those whose tables keep more than
    HOST_TAIL entries (round k evaluates size / 2^k entries)."""
    n = 0
    while n < nvars and size >> n > HOST_TAIL:
        n += 1
    return n


# ---------------------------------------------------------------------------
# fs_round and its plain version
# ---------------------------------------------------------------------------


def _words_be_bytes(w: torch.Tensor) -> torch.Tensor:
    """(k, n32) int32 words → (k, 4·n32) int64 big-endian bytes."""
    shifts = torch.tensor([24, 16, 8, 0], device=w.device)
    return ((fm.widen(w).flip(-1)[..., None] >> shifts) & 0xFF).reshape(w.shape[0], -1)


def _field_frames(ctx: DeviceField, vals: torch.Tensor) -> torch.Tensor:
    """absorb_field's bytes for each of (k, n32) Montgomery residues, in
    order: 0x03 ‖ q_be ‖ 0x05 0x01 ‖ mont_be ‖ 0x03."""
    k, dev = vals.shape[0], vals.device
    q_be = _words_be_bytes(fm.to_tensor(ctx.q[None], dev))

    def col(*b):
        return torch.tensor([list(b)] * k, dtype=torch.int64, device=dev)

    return torch.cat([col(3), q_be.expand(k, -1), col(5, 1), _words_be_bytes(vals), col(3)],
                     dim=1).reshape(-1)


def _challenge_value(ctx: DeviceField, d: torch.Tensor) -> torch.Tensor:
    """(n32,) int32 words of get_challenge's value from the digest d (32,):
    lo + hi·2^128 (big-endian halves) masked to min(bits(q) − 1, 256) bits,
    which is every regime of ``transcript.py:get_challenge``."""
    g = d.view(2, 4, 4)
    words = ((g[..., 0] << 24) | (g[..., 1] << 16) | (g[..., 2] << 8) | g[..., 3]).flip(1)
    keep = min(ctx.modulus.bit_length() - 1, 256)
    mask = fm.int_to_words((1 << keep) - 1, 8).astype(np.int64)
    x = words.reshape(8) & torch.from_numpy(mask).to(d.device)
    x = x[: ctx.n32] if ctx.n32 <= 8 else torch.cat([x, x.new_zeros(ctx.n32 - 8)])
    return fm.narrow(x)


def _eq_factor_t(ctx: DeviceField, one, b, x):
    """(1 − b)(1 − x) + b·x on word tensors."""
    return fm.mont_add(ctx, fm.mont_mul(ctx, fm.mont_sub(ctx, one, b), fm.mont_sub(ctx, one, x)),
                       fm.mont_mul(ctx, b, x))


def fs_round_plain(ctx: DeviceField, state, pos, sums, coeffs, evals, rs, rnd, beta=None,
                   pref=None):
    """:func:`fs_round` in plain torch (any device): the same round, the same
    in-place writes."""
    dev = sums.device
    one, r2 = fm.to_tensor(ctx.one, dev), fm.to_tensor(ctx.r2, dev)
    res = sums[0]
    for d in range(1, sums.shape[0]):
        res = fm.mont_add(ctx, res, sums[d])
    if beta is not None and rnd > 0:
        pref.copy_(fm.mont_mul(ctx, pref, _eq_factor_t(ctx, one, beta[rnd - 1], rs[rnd - 1])))
    acc = fm.mont_mul(ctx, coeffs[0][None], res[0])
    for k in range(1, res.shape[0]):
        acc = fm.mont_add(ctx, acc, fm.mont_mul(ctx, coeffs[k][None], res[k]))
    if beta is not None:
        n_pts = res.shape[1]
        t = torch.zeros((n_pts, ctx.n32), dtype=torch.int32, device=dev)
        t[:, 0] = torch.arange(n_pts, dtype=torch.int32, device=dev)
        c = _eq_factor_t(ctx, one, beta[rnd][None], fm.mont_mul(ctx, t, r2))
        acc = fm.mont_mul(ctx, fm.mont_mul(ctx, pref[None], c), acc)
    evals[rnd].copy_(acc)
    lanes, buf = unpack_state(state)
    lanes, buf, p = absorb(lanes, buf, pos, _field_frames(ctx, acc))
    d = digest(lanes, buf, p)
    ratchet = torch.cat([d.new_zeros(1), d, d.new_ones(1)])
    lanes, buf, p = absorb(lanes, buf, p, ratchet)
    r = fm.mont_mul(ctx, _challenge_value(ctx, d), r2)
    lanes, buf, p = absorb(lanes, buf, p, _field_frames(ctx, r[None]))
    rs[rnd].copy_(r)
    state.copy_(pack_state(lanes, buf, p))


def _check_fs(ctx, state, pos, sums, coeffs, evals, rs, rnd, beta, pref) -> None:
    n, dev = ctx.n32, state.device
    if (state.dtype != torch.int32 or tuple(state.shape) != (STATE_WORDS,)
            or not state.is_contiguous()):
        raise ValueError(f"state: expected a contiguous int32 ({STATE_WORDS},) tensor")
    if not 0 <= pos < RATE:
        raise ValueError(f"pos {pos} outside 0..{RATE - 1}")
    for name, x, ndim in (("sums", sums, 4), ("coeffs", coeffs, 2), ("evals", evals, 3),
                          ("rs", rs, 2)):
        _cuda.require_field_tensor(name, x, n, ndim)
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor on {dev}")
    n_pts = sums.shape[2]
    if not 1 <= sums.shape[1] <= FS_MAX_TERMS:
        raise ValueError(f"sums: {sums.shape[1]} terms, outside 1..{FS_MAX_TERMS}")
    if coeffs.shape[0] != sums.shape[1] or evals.shape[1] != n_pts:
        raise ValueError(f"sums {tuple(sums.shape)}, coeffs {tuple(coeffs.shape)} and evals "
                         f"{tuple(evals.shape)} disagree")
    if not 0 <= rnd < min(evals.shape[0], rs.shape[0]):
        raise ValueError(f"round {rnd} outside evals {tuple(evals.shape)} / rs {tuple(rs.shape)}")
    if (beta is None) != (pref is None):
        raise ValueError("beta and pref go together (Gruen)")
    if beta is not None:
        _cuda.require_field_tensor("beta", beta, n, 2)
        _cuda.require_field_tensor("pref", pref, n, 1)
        if beta.shape[0] <= rnd or beta.device != dev or pref.device != dev:
            raise ValueError(f"beta {tuple(beta.shape)} / pref on {pref.device} for round {rnd}")


def fs_round(ctx: DeviceField, state: torch.Tensor, pos: int, sums: torch.Tensor,
             coeffs: torch.Tensor, evals: torch.Tensor, rs: torch.Tensor, rnd: int,
             beta: torch.Tensor | None = None, pref: torch.Tensor | None = None) -> None:
    """Round ``rnd`` of the device-resident transcript, in place: from the
    round's sums (D, n_terms, n_pts, n32), one residue block per shard,
    s(t) = Σ_k coeffs[k]·Σ_D sums (Gruen: times pref·((1−β_j)(1−t) + β_j·t),
    pref first ratcheted by eq(β_{j−1}, rs[j−1]) for j ≥ 1) into evals[rnd];
    the sponge ``state`` (at fill level ``pos``) absorbs them, squeezes r
    and absorbs it; r into rs[rnd].  All tensors on one device."""
    _check_fs(ctx, state, pos, sums, coeffs, evals, rs, rnd, beta, pref)
    if not state.is_cuda:
        return fs_round_plain(ctx, state, pos, sums, coeffs, evals, rs, rnd, beta, pref)
    n = ctx.n32
    _cuda.require_kernel_words(n)
    d, n_terms, n_pts = sums.shape[:3]
    with _cuda.on_device(state):
        rc = _cuda.lib(n).zt_fs_round(
            state.data_ptr(), pos, sums.data_ptr(), d, n_terms, n_pts, coeffs.data_ptr(),
            None if beta is None else beta.data_ptr(), None if pref is None else pref.data_ptr(),
            rnd, evals.data_ptr(), rs.data_ptr(), n, _cuda.modulus_words(ctx).ctypes.data,
            ctx.nprime32, _cuda.r2_words(ctx).ctypes.data, _cuda.one_words(ctx).ctypes.data,
            ctx.modulus.bit_length(), _cuda.stream_ptr(state.device),
        )
    _cuda.check(rc, "fs_round")
    _cuda.LAUNCHES["fs_round"] += 1


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------


def _on_home(ex: DeviceSumcheckExecutor, sums: list[torch.Tensor]) -> torch.Tensor:
    """The round's sums of every block as one (D, n_terms, n_pts, n32) tensor
    on the first block's device: the local blocks' by device-to-device
    copies, and, while the blocks are spread over processes, every
    process's, all-gathered in rank order."""
    home = ex.home
    if len(sums) == 1 and sums[0].device == home:
        local = sums[0].contiguous()[None]
    else:
        local = torch.stack([ex._to(x, s, home, "rounds") for s, x in enumerate(sums)])
    if ex.group is None:
        return local
    return ex.gather_stacked(local).flatten(0, 1)


@dataclass
class FsRun:
    """A device-FS sumcheck between its three steps (:func:`start_fs`,
    :func:`enqueue_fs_rounds`, :func:`finish_fs`): the executor, the sponge
    on the first block's device, and the buffers the rounds write there."""

    ex: DeviceSumcheckExecutor
    nvars: int
    degree: int
    n_dev: int  # device rounds
    sponge: DeviceSponge
    coeffs: torch.Tensor  # (n_terms, n32)
    evals: torch.Tensor  # (n_dev, degree + 1, n32)
    rs: torch.Tensor  # (n_dev, n32)
    beta: torch.Tensor | None = None  # Gruen: (nvars, n32)
    pref: torch.Tensor | None = None  # Gruen: (n32,), ratcheted on the device


def start_fs(transcript: KeccakTranscript, ex: DeviceSumcheckExecutor, nvars: int,
             degree: int) -> FsRun:
    """Absorb nvars and the degree on the host, export the sponge to the
    first block's device and upload the round's constants."""
    cfg, ctx, home = ex.cfg, ex.ctx, ex.home
    _absorb_nvars_degree(transcript, nvars, degree, cfg)
    n_dev = device_rounds(ex.size, nvars)
    gruen = ex.tier == "gruen"
    return FsRun(
        ex=ex, nvars=nvars, degree=degree, n_dev=n_dev,
        sponge=DeviceSponge.from_host(transcript.h, home),
        coeffs=fps_to_tensor(ex.coeffs, cfg, home),
        evals=torch.empty((n_dev, degree + 1, ctx.n32), dtype=torch.int32, device=home),
        rs=torch.empty((n_dev, ctx.n32), dtype=torch.int32, device=home),
        beta=fps_to_tensor(ex.beta, cfg, home) if gruen else None,
        pref=fm.to_tensor(ctx.one, home).clone() if gruen else None,
    )


def enqueue_fs_rounds(run: FsRun) -> None:
    """Queue every device round: the executor's fold (by the challenge in
    ``run.rs``) and evaluation, then :func:`fs_round` over every block's
    sums.  Nothing here waits for the device or copies from it, except a
    gloo group's all-gather of sums on a card, which is staged through the
    host (and counted as a fetch).  Over processes every rank runs the same
    sponge on the same gathered sums, so r needs no broadcast; the gather
    returns before ``fs_round`` is queued, so no rank squeezes without
    every shard's sums."""
    ex, cfg = run.ex, run.ex.cfg
    pos = run.sponge.pos
    for rnd in range(run.n_dev):
        sums = ex.launch_round(run.rs[rnd - 1] if rnd else None)
        fs_round(ex.ctx, run.sponge.state, pos, _on_home(ex, sums), run.coeffs, run.evals,
                 run.rs, rnd, run.beta, run.pref)
        pos = (pos + round_absorb_bytes(cfg, run.degree)) % RATE
    run.sponge.pos = pos


def finish_fs(transcript: KeccakTranscript, run: FsRun):
    """The one fetch (evaluations, challenges, sponge, remaining tables with
    Gruen's folded eq row), the sponge written back into ``transcript``, and
    the host tail: (proof, randomness, folded host MLEs)."""
    ex, cfg, n32 = run.ex, run.ex.cfg, run.ex.ctx.n32
    rest = ex.remainder(run.pref)
    parts = (run.evals, run.rs, run.sponge.state, rest)
    words = fm.to_numpy(torch.cat([x.reshape(-1) for x in parts]))
    SUMCHECKS.append({"driver": "device_fs", "device_rounds": run.n_dev,
                      "fetches": 1 + ex.fetches, "sharded_rounds": ex.sharded_rounds})
    ev, rw, st, arr = np.split(words, np.cumsum([x.numel() for x in parts])[:-1])
    run.sponge.export_to_host(transcript.h, st)
    ev = ev.reshape(run.n_dev, run.degree + 1, n32)
    proof = [limbs_to_fps(ev[k], cfg) for k in range(run.n_dev)]
    randomness = limbs_to_fps(rw.reshape(run.n_dev, n32), cfg)
    with timed("sumcheck.host_tail"):
        return _host_tail(transcript, cfg, arr.reshape(rest.shape), proof, randomness, run.n_dev,
                          run.nvars, run.degree, ex.comb)


def prove_as_subprotocol_device_fs(
    transcript: KeccakTranscript,
    cfg: FieldConfig,
    tables: torch.Tensor,  # (n_mles, 2^nvars, n32) Montgomery residues
    nvars: int,
    degree: int,
    comb,
    eq_beta: list[Fp] | None = None,  # Gruen: tables EXCLUDE eq (index n_mles)
    mesh=None,  # parallel.Mesh: the executor's blocks are its shards
):
    """Transcript-identical sumcheck with device-resident Fiat-Shamir on the
    tables' device, or over ``mesh`` (``executor.make_executor``), and
    leaves ``transcript`` as the host prover would.  Returns (proof,
    randomness, finals) like the per-round driver: finals are the fully
    folded values of every MLE, the eq MLE last for Gruen (the reference
    returns the folded MLEs)."""
    ex = make_executor(cfg, tables, degree, comb, eq_beta, mesh)
    assert ex.size == 1 << nvars, (ex.size, nvars)
    with timed("sumcheck.fs.start"):
        run = start_fs(transcript, ex, nvars, degree)
    with timed("sumcheck.fs.enqueue"):
        enqueue_fs_rounds(run)
    with timed("sumcheck.fs.finish"):
        proof, randomness, mles = finish_fs(transcript, run)
    return proof, randomness, [m[0] for m in mles]


def _host_tail(
    transcript: KeccakTranscript,
    cfg: FieldConfig,
    arr: np.ndarray,  # (n_mles, active, n32) fetched remainder
    proof: list,
    randomness: list,
    n_done: int,
    nvars: int,
    degree: int,
    comb,
):
    """Finish a device-FS sumcheck on the host, bit for bit: fold the last
    device challenge, then run the remaining rounds through the host
    prover.  Shared by the single-device and sharded drivers."""
    mles_host = [limbs_to_fps(arr[i], cfg) for i in range(arr.shape[0])]
    if n_done == nvars:
        return proof, randomness, _fold(mles_host, randomness[-1])
    for rnd in range(n_done, nvars):
        if rnd > 0:
            mles_host = _fold(mles_host, randomness[-1])
        evals = _round_evals(mles_host, degree, comb, cfg)
        transcript.absorb_field_slice(evals)
        proof.append(evals)
        r = transcript.get_challenge(cfg)
        transcript.absorb_field(r)
        randomness.append(r)
    return proof, randomness, _fold(mles_host, randomness[-1])
