"""The sharded sumcheck with device-resident Fiat-Shamir: one sync a sumcheck
on a mesh.

The port of ``zinc_tpu/parallel/fs.py``.  The tables are split into the
mesh's D contiguous blocks as for the per-round sharded sumcheck
(``parallel/sumcheck.py:shard_tables``), and the rounds run on
``sumcheck/device_fs.py``'s driver over those blocks: each shard folds its
block by the challenge on the card and evaluates it, launching on its own
device; the round's D sum buffers go to the mesh's first device by
device-to-device copies, where ``fs_round`` adds them mod q, forms the
round's values and squeezes; and r goes back to every shard the same way
before the shard's next fold reads it.  None of this passes through the
host, and torch orders every cross-device copy after the producing stream's
work and before the consuming stream's.  In one process the sponge runs
once, on the first device, and its r is copied out (the reference
replicates it on every device after a psum).  Once a shard's block has at most
``HOST_TAIL`` entries the blocks are joined on the first device (a
``torch.cat`` on the card), and its device rounds go on there until the
one fetch.

On a mesh over processes (``mesh.group``) each process does this for its
own shards, and each round all-gathers the processes' stacked sums in rank
order onto its first device (``ProcessGroup.all_gather_stacked``) before
``fs_round``; every process then runs the same sponge on the same sums, as
the reference replicates it after its psum, so r needs no broadcast.  The
hand-over all-gathers the blocks the same way.  Under NCCL all of it stays
on the cards; gloo stages a card's tensors through the host, and each
staged copy counts as a fetch in ``executor.SUMCHECKS``.  The per-round
driver stays reachable through ``spartan_prove_device(...,
sumcheck=prove_sharded)``.
"""

from __future__ import annotations

from ..fields.config import FieldConfig, Fp
from ..sumcheck.device_fs import prove_fs_with_executor
from ..sumcheck.executor import wants_gruen
from ..transcript import KeccakTranscript
from .mesh import Mesh
from .sumcheck import ShardedSumcheckExecutor


def wants_fs_sharded(cfg: FieldConfig, comb, b: int, mesh: Mesh, eq_idx: int | None = None) -> bool:
    """True when the one-sync sharded driver takes this shape: a mesh, in one
    process or over several, whose D shards divide the 2^nvars entries (else
    the tables stay whole on the first device, and ``prove_sharded`` runs
    them there), and, with ``eq_idx``, a combination the Gruen rounds take.
    As in the reference, only the shape decides."""
    if b % mesh.size:
        return False
    return eq_idx is None or wants_gruen(cfg, comb, eq_idx, b)


def prove_as_subprotocol_device_fs_sharded(
    transcript: KeccakTranscript,
    cfg: FieldConfig,
    tables,  # (n_tabs, 2^nvars, n32) Montgomery residues
    nvars: int,
    degree: int,
    comb,
    mesh: Mesh,
    eq_beta: list[Fp] | None = None,  # Gruen: tables EXCLUDE the eq MLE
):
    """Transcript-identical sharded sumcheck with device Fiat-Shamir; callers
    gate on :func:`wants_fs_sharded`.  Returns (proof, randomness, folded
    MLEs) like the single-device driver, and notes the rounds run on the
    shards in ``mesh.stats["sharded_rounds"]``."""
    if not wants_fs_sharded(cfg, comb, tables.shape[1], mesh,
                            None if eq_beta is None else tables.shape[0]):
        raise ValueError("the sharded device-FS driver needs wants_fs_sharded()")
    ex = ShardedSumcheckExecutor(cfg, tables, degree, comb, mesh, eq_beta)
    assert ex.size == 1 << nvars, (ex.size, nvars)
    out = prove_fs_with_executor(transcript, ex, nvars, degree)
    mesh.note("sharded_rounds", ex.sharded_rounds)
    return out
