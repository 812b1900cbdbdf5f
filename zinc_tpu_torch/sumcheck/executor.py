"""The per-round sumcheck executor and its round loop, on one device or on
the blocks of a mesh.

The port of ``zinc_tpu/sumcheck/device.py:157-227``,
``zinc_tpu/sumcheck/pallas_exec.py:212-301`` and the round logic of
``zinc_tpu/sumcheck/device_fs.py``.  The tables stay on their devices; each
round runs its kernels and sends only the round's sums to the host, which
reduces them mod q, applies the coefficients and feeds the transcript.  The
executor takes one of three tiers, by the combination:

* **classic** (K3's scope): rounds ≥ 1 ``fold`` (K2), every round
  ``round_eval`` (K3);
* **Gruen** (eq factored out, ``eq_beta`` given): ``fold`` and
  ``round_eval_gruen`` (K4) against the suffix-eq level of the round;
* **generic** (any other combination, ``device_fs.py:284,332-351``): round 0
  ``round_eval_generic`` (K7/K9), rounds ≥ 1 ``fold_round_eval`` (K10), fold
  and evaluation in one launch, into a fresh buffer.

Once a table has at most ``HOST_TAIL`` entries, the last device fold and
the remaining rounds run on the host with the reference's host prover
(Gruen hands the folded eq row pref·E over with the tables, so the host
sees the classic combination).  Transcripts do not depend on the split.

**Blocks.**  The tables may come as D contiguous blocks of their hypercube
axis, block s holding entries [s·b/D, (s+1)·b/D) on its own device (a
mesh's shards, ``parallel/sumcheck.py``).  A fold pairs (2p, 2p+1), so each
block folds on its own, with no data movement, and the folded blocks are
again the folded table's blocks in natural order.  A round queues every
block's launches before it fetches any sums, then adds the D residues of
each sum mod q on the host (exact, in any order).  Gruen's block s weighs
its pairs with the s-th contiguous slice of the round's eq level: pairs sit
in natural order, so the slice is that block's.  Once a block has at most
``HOST_TAIL`` entries, the blocks are joined on the first block's device
(at most HOST_TAIL·D entries a table) and the rounds go on there, the pref
ratchet unchanged.  With one block, this is the single-device sumcheck.

**Processes.**  With a ``group`` (``parallel.mesh.ProcessGroup``) the
blocks are this process's, blocks [rank·n, (rank+1)·n) of the D = n·world
blocks of every process.  Each round all-gathers the blocks' residues as
CPU int tensors, in rank order, so every process adds the same D residues
before the host squeezes; the hand-over and the final values all-gather the
blocks themselves, after which every process runs the same rounds on its
whole table, with no more collectives.

The kernels run on the tables' device: a CPU tensor takes their plain
versions, so there is one executor for every platform.
"""

from __future__ import annotations

import torch

from ..fields.config import FieldConfig, Fp
from ..sumcheck.prover import _absorb_nvars_degree, _fold, _round_evals
from ..transcript import KeccakTranscript
from ..fields.montgomery import device_field
from ..ops.field_kernels import mont_mul
from ..poly.device import eq_levels, fps_to_limbs, fps_to_tensor, tensor_to_fps
from . import kernels

HOST_TAIL = 64  # tables of at most this many entries finish on the host


def wants_gruen(cfg: FieldConfig, comb, eq_idx: int, b: int) -> bool:
    """True when the Gruen kernel drives this shape: every term carries eq
    last with 1-3 other factors, ≤ 512-bit field, and at least two device
    rounds (so the ratchet and the fold both run)."""
    idx_terms = [tuple(idxs) for _, idxs in comb]
    return kernels.gruen_supported(idx_terms, eq_idx, 2 * cfg.n64) and b > 2 * HOST_TAIL


def uses_generic(cfg: FieldConfig, comb, degree: int) -> bool:
    """True when the classic rounds send this comb to the generic tier:
    some term is outside K3's scope (``device_fs.py:284``), or the degree
    needs more points than K3 takes."""
    idx_terms = [tuple(idxs) for _, idxs in comb]
    return degree + 1 > kernels.MAX_POINTS or not kernels.classic_supported(
        idx_terms, 2 * cfg.n64, degree + 1)


def _eq_factor(beta: Fp, r: Fp) -> Fp:
    one = beta.cfg.one()
    return (one - beta) * (one - r) + beta * r


def round_values(cfg: FieldConfig, sums, coeffs, gruen_factor=None) -> list[Fp]:
    """Round evaluations s(0..d) from the kernels' per-term sums
    (n_terms, d+1, n32), or from a list of them, one per block, whose
    residues add mod q: Σ_k coeff_k·(sum mod q), times pref·c_j(t) with
    c_j(t) = (1−β_j)(1−t) + β_j·t when ``gruen_factor`` = (pref, β_j)."""
    ctx = device_field(cfg)
    parts = sums if isinstance(sums, (list, tuple)) else [sums]
    res = sum(kernels.sums_to_ints(ctx, s) for s in parts) % cfg.q
    one = cfg.one()
    evals = []
    for t in range(res.shape[1]):
        acc = cfg.zero()
        for k, c in enumerate(coeffs):
            acc = acc + c * cfg.fp_from_mont(res[k, t])
        if gruen_factor is not None:
            pref, bj = gruen_factor
            tf = cfg.fp(t)
            acc = pref * ((one - bj) * (one - tf) + bj * tf) * acc
        evals.append(acc)
    return evals


class DeviceSumcheckExecutor:
    """Runs the rounds of one sumcheck over stacked tables (n_mles, 2^nvars,
    n32) of Montgomery residues, or over their D blocks (a list, see the
    module notes); comb a CombSpec.  With ``eq_beta`` the tables exclude the
    eq MLE, which the combination names as index n_mles (Gruen)."""

    def __init__(self, cfg: FieldConfig, tables, degree: int, comb, eq_beta=None, group=None):
        self.cfg = cfg
        self.ctx = device_field(cfg)
        if self.ctx.n32 > kernels.MAX_WORDS:
            raise ValueError(f"no round kernels for {self.ctx.n32}-word fields "
                             f"(at most {kernels.MAX_WORDS})")
        self.degree = degree
        self.comb = comb
        self.coeffs = [c for c, _ in comb]
        self.idx_terms = [tuple(idxs) for _, idxs in comb]
        blocks = list(tables) if isinstance(tables, (list, tuple)) else [tables]
        self.blocks = [b.contiguous() for b in blocks]
        self.home = self.blocks[0].device
        self.group = group  # the processes the blocks are spread over, or None
        world = 1 if group is None else group.world
        self.n_blocks = len(self.blocks) * world  # blocks over every process
        self.size = sum(b.shape[1] for b in self.blocks) * world  # entries a table
        self.folds = 0
        self.sharded_rounds = 0  # rounds evaluated on more than one block
        self._host_mles: list[list[Fp]] | None = None
        if eq_beta is not None:
            if not wants_gruen(cfg, comb, self.blocks[0].shape[0], self.size):
                raise ValueError("the Gruen rounds need wants_gruen(); use the classic rounds")
            self.tier = "gruen"
            self.beta = list(eq_beta)
            self.pref = cfg.one()
            self.rests = [t[:-1] for t in self.idx_terms]
            self.levels = eq_levels(self.ctx, fps_to_tensor(self.beta, cfg, self.home))
        else:
            self.tier = "generic" if uses_generic(cfg, comb, degree) else "classic"

    # -- the host tail -------------------------------------------------------

    def _joined(self) -> torch.Tensor:
        """The whole tables on the first block's device (every process's
        blocks, in rank order); the blocks are no longer spread after it."""
        if self.n_blocks == 1:
            return self.blocks[0]
        local = torch.cat([b.to(self.home) for b in self.blocks], dim=1)
        if self.group is not None:
            local = torch.cat(self.group.all_gather(local), dim=1).to(self.home)
            self.group = None
        self.n_blocks = 1
        return local

    def _demote_to_host(self) -> None:
        buf = self._joined()
        mles = [tensor_to_fps(buf[i], self.cfg) for i in range(buf.shape[0])]
        if self.tier == "gruen":
            pref = fps_to_tensor([self.pref], self.cfg, self.home)[0]
            mles.append(tensor_to_fps(mont_mul(self.ctx, self.levels[self.folds], pref), self.cfg))
        self._host_mles = mles
        self.blocks = None

    def _host_round(self) -> list[Fp]:
        return _round_evals(self._host_mles, self.degree, self.comb, self.cfg)

    # -- device rounds -------------------------------------------------------

    def _bound(self, r_prev: Fp) -> None:
        """Book one fold by r_prev: the size and, for Gruen, the pref ratchet."""
        if self.tier == "gruen":
            self.pref = self.pref * _eq_factor(self.beta[self.folds], r_prev)
        self.folds += 1
        self.size //= 2

    def _values(self, sums: list, gruen_factor=None) -> list[Fp]:
        """The round's evaluations from the local blocks' sums and, with a
        group, every other process's, gathered in rank order."""
        if self.group is not None:
            local = torch.stack([s.to(self.home) for s in sums])
            sums = [s for part in self.group.all_gather(local) for s in part]
        if len(sums) > 1:
            self.sharded_rounds += 1
        return round_values(self.cfg, sums, self.coeffs, gruen_factor)

    def _evaluate(self) -> list[Fp]:
        ctx, n_pts = self.ctx, self.degree + 1
        if self.tier == "gruen":
            first = 0 if self.group is None else self.group.rank * len(self.blocks)
            parts = self.levels[self.folds + 1].chunk(self.n_blocks)[first : first + len(self.blocks)]
            sums = [kernels.round_eval_gruen(ctx, b, e.to(b.device), self.rests, n_pts)
                    for b, e in zip(self.blocks, parts)]
            return self._values(sums, (self.pref, self.beta[self.folds]))
        if self.tier == "classic":
            return self._values([kernels.round_eval(ctx, b, self.idx_terms, n_pts)
                                 for b in self.blocks])
        return self._values([kernels.round_eval_generic(ctx, b, self.idx_terms, n_pts)
                             for b in self.blocks])

    def round(self, r_prev: Fp | None) -> list[Fp]:
        """The round's evaluations at 0..degree, after folding r_prev (None
        in round 0)."""
        if self._host_mles is not None:
            self._host_mles = _fold(self._host_mles, r_prev)
            return self._host_round()
        if r_prev is not None:
            r = fps_to_limbs([r_prev], self.cfg)[0]
            if self.tier == "generic" and self.blocks[0].shape[1] // 2 > HOST_TAIL:
                out = [kernels.fold_round_eval(self.ctx, b, r, self.idx_terms, self.degree + 1)
                       for b in self.blocks]
                self.blocks = [folded for folded, _ in out]
                self._bound(r_prev)
                return self._values([sums for _, sums in out])
            self.blocks = [kernels.fold(self.ctx, b, r) for b in self.blocks]
            self._bound(r_prev)
        if self.size <= HOST_TAIL:
            self._demote_to_host()
            return self._host_round()
        if self.n_blocks > 1 and self.blocks[0].shape[1] <= HOST_TAIL:
            self.blocks = [self._joined()]  # the hand-over to the first block's device
        return self._evaluate()

    def final_fold(self, r: Fp) -> None:
        if self._host_mles is not None:
            self._host_mles = _fold(self._host_mles, r)
        else:
            rw = fps_to_limbs([r], self.cfg)[0]
            self.blocks = [kernels.fold(self.ctx, b, rw) for b in self.blocks]
            self._bound(r)

    def final_values(self) -> list[Fp]:
        """The fully folded value of every MLE (the eq MLE last for Gruen)."""
        if self._host_mles is None:
            self._demote_to_host()
        assert all(len(m) == 1 for m in self._host_mles)
        return [m[0] for m in self._host_mles]


def make_executor(cfg: FieldConfig, tables, degree: int, comb, eq_beta=None) -> DeviceSumcheckExecutor:
    """The executor for these tables.  The reference picks its Pallas or XLA
    executor by platform; here the kernels' wrappers pick by the tables'
    device, so there is one executor."""
    return DeviceSumcheckExecutor(cfg, tables, degree, comb, eq_beta)


def prove_with_executor(
    transcript: KeccakTranscript,
    executor: DeviceSumcheckExecutor,
    nvars: int,
    degree: int,
    cfg: FieldConfig,
):
    """Transcript-identical sumcheck through ``executor``; returns (proof,
    randomness) and leaves the final values in ``executor.final_values()``.

    The reference's ``prove_as_subprotocol_device(transcript, executor, …)``
    (``zinc_tpu/sumcheck/device.py:206-227``) under another name: in this
    port that name is the table-level entry of ``sumcheck/device.py``."""
    _absorb_nvars_degree(transcript, nvars, degree, cfg)
    randomness: list[Fp] = []
    proof = []
    for rnd in range(nvars):
        evals = executor.round(randomness[-1] if rnd > 0 else None)
        transcript.absorb_field_slice(evals)
        proof.append(evals)
        r = transcript.get_challenge(cfg)
        transcript.absorb_field(r)
        randomness.append(r)
    executor.final_fold(randomness[-1])
    return proof, randomness
