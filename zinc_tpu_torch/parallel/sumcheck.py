"""The sumcheck with its hypercube axis block-sharded over a mesh.

The port of ``zinc_tpu/parallel/sumcheck.py``.  The tables are split into D
contiguous blocks along the hypercube axis, one per shard (a 2-D mesh is
flattened to D = r·c shards), and the rounds run on
``sumcheck/executor.py``'s executor over those blocks: each shard folds its
own block (K2, or K10 fused with the generic evaluation) with no data
movement and evaluates it (K3, K4 or K7); every shard's launches are queued
before the round's sums are read, and the D residues of each sum are
added mod q (by ``fs_round`` on the first device under device-resident
Fiat-Shamir, on the host under the per-round driver).  Once a shard's block has at most ``HOST_TAIL``
entries, the blocks are joined on the mesh's first device, where the
single-device rounds and the host tail finish.  At 2^20 on 4 shards that is
12 of the 20 rounds of each sumcheck on the shards.

On a mesh over several processes (``mesh.group``) every process holds the
whole tables (its setups ran on its first device) and keeps only its own
shards' blocks; each round's residues are all-gathered (onto the first
device, or to the host under the per-round driver), and the blocks at the
hand-over where they lie, in rank order, so every process holds the same
sums before it squeezes.

One executor stands for the reference's tiers: ``ShardedSumcheckExecutor``
(XLA body), ``ShardedLmSumcheckExecutor`` and
``ShardedGruenSumcheckExecutor`` (limb-major MXU layout, Gruen's
pre-scaled suffix buffers from ``build_sharded_suffix``) and their chooser
``make_sharded_executor``; its Gruen shards take the contiguous slices of
the single-device eq levels, and Gruen applies on a mesh wherever it applies
on one device (``executor.wants_gruen``), so ``wants_gruen_sharded`` has no
counterpart.  ``executor.make_executor(..., mesh=)`` builds it, and both
sumcheck drivers take it through their ``mesh=``: the prover's
device-resident Fiat-Shamir (``sumcheck/device_fs.py``), one sync a
sumcheck, and the per-round driver (``sumcheck/device.py``), one a round.
The reference's one-sync sharded driver and its shape gate have no
counterpart here: where the shards do not divide the hypercube the
executor holds one block, on which the device-FS driver runs as on one
device.

The scatter of the tables onto the shards and the hand-over are the spans
``mesh.scatter`` and ``mesh.handover``; they, each round's sums sent to
the first shard and r and Gruen's eq slices sent out count in
``mesh.MESH``.
"""

from __future__ import annotations

from ..fields.config import FieldConfig, Fp
from ..sumcheck.executor import DeviceSumcheckExecutor
from ..timing import timed
from .mesh import Mesh, moved, scattered


def shard_tables(mesh: Mesh, tables):
    """(this process's hypercube blocks on their shards, the mesh's process
    group), or (the whole tables on the mesh's first device, None) when the
    mesh's D shards do not divide the axis."""
    if tables.shape[1] % mesh.size:
        return [tables.to(mesh.first)], None
    mine = tables.chunk(mesh.size, dim=1)[mesh.shard_offset :][: len(mesh.local_flat)]
    with timed("mesh.scatter"):
        home = 0 if tables.device == mesh.first else None
        return scattered(mine, mesh.local_flat, home), mesh.group


class ShardedSumcheckExecutor(DeviceSumcheckExecutor):
    """The executor over the mesh's blocks of ``tables`` (n_mles, 2^nvars,
    n32); ``sharded_rounds`` counts the rounds evaluated on the shards.
    ``shard_tables`` is looked up at each build, so a test can alter the
    blocks it returns."""

    def __init__(self, cfg: FieldConfig, tables, degree: int, comb, mesh: Mesh,
                 eq_beta: list[Fp] | None = None):
        blocks, group = shard_tables(mesh, tables)
        super().__init__(cfg, blocks, degree, comb, eq_beta, group)

    def _to(self, x, s, device, kind):
        return x.to(device) if s == 0 else moved(x, device, kind)

    def _joined(self):
        if self.n_blocks == 1:
            return self.blocks[0]
        with timed("mesh.handover"):
            return super()._joined()

