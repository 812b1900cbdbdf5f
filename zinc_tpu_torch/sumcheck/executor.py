"""The per-round sumcheck executor and its round loop: the generic tier.

The port of ``zinc_tpu/sumcheck/device.py:157-227`` and
``zinc_tpu/sumcheck/pallas_exec.py:212-301``.  The tables stay on their
device; each round runs one kernel and sends only the round's sums to the
host, which reduces them mod q, applies the coefficients and feeds the
transcript.  Rounds follow ``PallasSumcheckExecutor``:

* round 0: ``round_eval_generic`` (K7/K9);
* rounds ≥ 1: ``fold_round_eval`` (K10), fold and evaluation in one launch,
  into a fresh buffer;
* once a table has at most ``HOST_TAIL`` entries: the last device fold
  (``fold``, K2/K8) and the remaining rounds on the host, with the
  reference's host prover.  Transcripts do not depend on the split.

The kernels run on the tables' device: a CPU tensor takes their plain
versions, so there is one executor for every platform.
"""

from __future__ import annotations

import torch

from ..fields.config import FieldConfig, Fp
from ..sumcheck.prover import _absorb_nvars_degree, _fold, _round_evals
from ..transcript import KeccakTranscript
from ..fields.montgomery import device_field
from ..poly.device import fps_to_limbs, tensor_to_fps
from . import kernels

HOST_TAIL = 64  # tables of at most this many entries finish on the host


def round_values(cfg: FieldConfig, sums: torch.Tensor, coeffs, gruen_factor=None) -> list[Fp]:
    """Round evaluations s(0..d) from the kernels' per-term sums
    (n_terms, d+1, n32): Σ_k coeff_k·(sum mod q), times pref·c_j(t) with
    c_j(t) = (1−β_j)(1−t) + β_j·t when ``gruen_factor`` = (pref, β_j)."""
    res = kernels.sums_to_ints(device_field(cfg), sums)
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
    """Runs the rounds of one sumcheck over stacked tables
    (n_mles, 2^nvars, n32) of Montgomery residues, comb a CombSpec."""

    def __init__(self, cfg: FieldConfig, tables: torch.Tensor, degree: int, comb):
        self.cfg = cfg
        self.ctx = device_field(cfg)
        self.degree = degree
        self.comb = comb
        self.coeffs = [c for c, _ in comb]
        self.idx_terms = [tuple(idxs) for _, idxs in comb]
        self.buf = tables.contiguous()
        self._host_mles: list[list[Fp]] | None = None

    def _demote_to_host(self) -> None:
        self._host_mles = [tensor_to_fps(self.buf[i], self.cfg) for i in range(self.buf.shape[0])]
        self.buf = None

    def _host_round(self) -> list[Fp]:
        return _round_evals(self._host_mles, self.degree, self.comb, self.cfg)

    def round(self, r_prev: Fp | None) -> list[Fp]:
        """The round's evaluations at 0..degree, after folding r_prev (None
        in round 0)."""
        if self._host_mles is not None:
            self._host_mles = _fold(self._host_mles, r_prev)
            return self._host_round()
        n_pts = self.degree + 1
        if r_prev is None:
            if self.buf.shape[1] <= HOST_TAIL:
                self._demote_to_host()
                return self._host_round()
            sums = kernels.round_eval_generic(self.ctx, self.buf, self.idx_terms, n_pts)
            return round_values(self.cfg, sums, self.coeffs)
        r = fps_to_limbs([r_prev], self.cfg)[0]
        if self.buf.shape[1] // 2 <= HOST_TAIL:
            self.buf = kernels.fold(self.ctx, self.buf, r)
            self._demote_to_host()
            return self._host_round()
        self.buf, sums = kernels.fold_round_eval(self.ctx, self.buf, r, self.idx_terms, n_pts)
        return round_values(self.cfg, sums, self.coeffs)

    def final_fold(self, r: Fp) -> None:
        if self._host_mles is not None:
            self._host_mles = _fold(self._host_mles, r)
        else:
            self.buf = kernels.fold(self.ctx, self.buf, fps_to_limbs([r], self.cfg)[0])

    def final_values(self) -> list[Fp]:
        """The fully folded value of every MLE."""
        if self._host_mles is not None:
            assert all(len(m) == 1 for m in self._host_mles)
            return [m[0] for m in self._host_mles]
        assert self.buf.shape[1] == 1
        return tensor_to_fps(self.buf[:, 0], self.cfg)


def make_executor(cfg: FieldConfig, tables: torch.Tensor, degree: int, comb) -> DeviceSumcheckExecutor:
    """The executor for these tables.  The reference picks its Pallas or XLA
    executor by platform; here the kernels' wrappers pick by the tables'
    device, so there is one executor."""
    return DeviceSumcheckExecutor(cfg, tables, degree, comb)


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
    port that name is the table-level round loop of ``sumcheck/device.py``."""
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
