"""The sumcheck with its hypercube axis block-sharded over a mesh.

The port of ``zinc_tpu/parallel/sumcheck.py``.  The tables are split into D
contiguous blocks along the hypercube axis, one per shard (a 2-D mesh is
flattened to D = r·c shards), and the rounds run on
``sumcheck/executor.py``'s executor over those blocks: each shard folds its
own block (K2, or K10 fused with the generic evaluation) with no data
movement and evaluates it (K3, K4 or K7); every shard's launches are queued
before the round's sums are fetched, and the D residues of each sum are
added mod q on the host.  Once a shard's block has at most ``HOST_TAIL``
entries, the blocks are joined on the mesh's first device, where the
single-device rounds and the host tail finish.  At 2^20 on 4 shards that is
12 of the 20 rounds of each sumcheck on the shards.

On a mesh over several processes (``mesh.group``) every process holds the
whole tables (its setups ran on its first device) and keeps only its own
shards' blocks; the executor all-gathers each round's residues, and the
blocks at the hand-over, in rank order, so every process holds the same
sums before it squeezes.

One executor stands for the reference's tiers: ``ShardedSumcheckExecutor``
(XLA body), ``ShardedLmSumcheckExecutor`` and
``ShardedGruenSumcheckExecutor`` (limb-major MXU layout, Gruen's
pre-scaled suffix buffers from ``build_sharded_suffix``) and their chooser
``make_sharded_executor``; its Gruen shards take the contiguous slices of
the single-device eq levels, and Gruen applies on a mesh wherever it applies
on one device (``executor.wants_gruen``), so ``wants_gruen_sharded`` has no
counterpart.  ``zinc_tpu/parallel/fs.py`` (the sharded rounds inside the
device-resident Fiat-Shamir loop) has none either: the port keeps
Fiat-Shamir on the host, and this module is its sharded loop, as
``sumcheck/device.py`` is ``device_fs.py``'s.
"""

from __future__ import annotations

from ..fields.config import FieldConfig, Fp
from ..sumcheck.executor import DeviceSumcheckExecutor, prove_with_executor
from ..transcript import KeccakTranscript
from .mesh import Mesh


def shard_tables(mesh: Mesh, tables):
    """(this process's hypercube blocks on their shards, the mesh's process
    group), or (the whole tables on the mesh's first device, None) when the
    mesh's D shards do not divide the axis."""
    if tables.shape[1] % mesh.size:
        return [tables.to(mesh.first)], None
    mine = tables.chunk(mesh.size, dim=1)[mesh.shard_offset :]
    return [b.to(dev).contiguous() for b, dev in zip(mine, mesh.local_flat)], mesh.group


class ShardedSumcheckExecutor(DeviceSumcheckExecutor):
    """The executor over the mesh's blocks of ``tables`` (n_mles, 2^nvars,
    n32); ``sharded_rounds`` counts the rounds evaluated on the shards."""

    def __init__(self, cfg: FieldConfig, tables, degree: int, comb, mesh: Mesh,
                 eq_beta: list[Fp] | None = None):
        blocks, group = shard_tables(mesh, tables)
        super().__init__(cfg, blocks, degree, comb, eq_beta, group)


def prove_sharded(
    transcript: KeccakTranscript,
    cfg: FieldConfig,
    tables,
    nvars: int,
    degree: int,
    comb,
    mesh: Mesh,
    eq_beta: list[Fp] | None = None,
):
    """``sumcheck.device.prove_as_subprotocol_device`` on the mesh: the same
    (proof, randomness, finals), transcript-identical; notes the sharded
    rounds in ``mesh.stats["sharded_rounds"]``."""
    ex = ShardedSumcheckExecutor(cfg, tables, degree, comb, mesh, eq_beta)
    assert ex.size == 1 << nvars, (ex.size, nvars)
    proof, randomness = prove_with_executor(transcript, ex, nvars, degree, cfg)
    mesh.note("sharded_rounds", ex.sharded_rounds)
    return proof, randomness, ex.final_values()
