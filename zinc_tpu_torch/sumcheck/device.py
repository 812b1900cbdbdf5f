"""Device sumcheck with Fiat-Shamir on the host: the per-round driver.

The port of ``zinc_tpu/sumcheck/device.py``'s table-level entry.  Each
round runs the fold (K2) and the round evaluation (K3, or K4 for Gruen) on
the device, fetches the round's sums (the one sync of the round), and lets
the host ``KeccakTranscript`` absorb the d+1 evaluations and squeeze r,
exactly as ``zinc_tpu/sumcheck/prover.py:87-118`` does.  It drives the
benchmark's sumcheck cell.  The prover takes ``device_fs.py`` instead (the
sponge on the device, one sync a sumcheck, the same bytes, on meshes over
processes too); the tests and ``chip_smoke.compare_drivers`` hold the two
drivers equal, on one device and on a mesh.

Gruen (sumcheck 1): the eq MLE never enters the fold.  Round j evaluates
s_j(t) = pref_j · c_j(t) · Σ_i coeff_i · Σ_p E_j[p] · Π_{m∈S_i} M_m(t, p)
with c_j(t) = (1−β_j)(1−t) + β_j·t, pref ratcheted by eq(β_j, r_j), and
E_j the eq table of the unbound suffix β_{j+1..n} in natural order, so
that E_j[p] weighs pair p (the reference builds it bit-reversed for its
layout).  The tail gets the folded eq row pref·E back, so the final values
are those of the classic sumcheck.

A combination outside K3's scope (a term of 1 or more than 4 factors, more
than 5 points, or more terms than its launch holds), when Gruen does not
apply, goes to the generic tier.  The rounds themselves, all three tiers
and the host tail, are ``executor.py``'s.
"""

from __future__ import annotations

import torch

from ..fields.config import FieldConfig, Fp
from ..transcript import KeccakTranscript
from .executor import (  # noqa: F401  (wants_gruen, uses_generic, round_values: this module's API)
    make_executor,
    prove_with_executor,
    round_values,
    uses_generic,
    wants_gruen,
)


def prove_as_subprotocol_device(
    transcript: KeccakTranscript,
    cfg: FieldConfig,
    tables: torch.Tensor,  # (n_mles, 2^nvars, n32) Montgomery residues
    nvars: int,
    degree: int,
    comb,
    eq_beta: list[Fp] | None = None,  # Gruen: tables EXCLUDE eq (index n_mles)
    mesh=None,  # parallel.Mesh: the executor's blocks are its shards
):
    """Transcript-identical sumcheck on the tables' device, or over ``mesh``
    (``executor.make_executor``).  Returns (proof, randomness, finals):
    finals are the fully folded values of every MLE (the eq MLE last when
    ``eq_beta`` is given)."""
    ex = make_executor(cfg, tables, degree, comb, eq_beta, mesh)
    assert ex.size == 1 << nvars, (ex.size, nvars)
    proof, randomness = prove_with_executor(transcript, ex, nvars, degree, cfg)
    return proof, randomness, ex.final_values()
