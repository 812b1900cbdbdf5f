"""The Zinc prover on a mesh of cards, then the verifier on one, on the
dummy R1CS, closed loop.

The step of ``zinc_r1cs.Cell`` (a fresh z from (seed, step), A and B fixed,
the prove wall and then the verify wall), with the prover sharded over the
configuration's ``mesh``: ``local_mesh(cards)`` on the cards, one process,
or ``Mesh([device] * cards)`` elsewhere (the CPU's tests).  The verifier
takes no mesh and runs on the first card.  Every card is synced at both
ends of the prove wall, and each step keeps the program's count of the
copies between the mesh's cards (``zinc_tpu_torch.parallel.mesh.MESH``,
None where the program has no such count).  The peak memory counters of
every card restart after the warm-up.
"""

from __future__ import annotations

import torch

import zinc_tpu_torch as zt
from zinc_tpu_torch.parallel import Mesh, local_mesh
from zinc_tpu_torch.parallel import mesh as mesh_module

from benchmark.drivers.zinc_r1cs import Cell as OneCardCell


class _SyncedProver:
    """The mesh's prover, with every card of the mesh synced before and
    after each prove (the harness syncs the current card only)."""

    def __init__(self, prover, cards: list[torch.device]):
        self.prover, self.cards = prover, cards

    def sync(self) -> None:
        for card in self.cards:
            torch.cuda.synchronize(card)

    def prove(self, *args):
        self.sync()
        proof = self.prover.prove(*args)
        self.sync()
        return proof


class Cell(OneCardCell):
    def __init__(self, config: dict, traffic: dict, seed: int, device: str, control: bool = False):
        super().__init__(config, traffic, seed, device, control)
        cards = config["mesh"]["cards"]
        self.mesh = local_mesh(cards) if device.startswith("cuda") else Mesh([device] * cards)
        self.cards = [d for d in self.mesh.devices.flat if d.type == "cuda"]  # none on the CPU
        self.prover = _SyncedProver(zt.ZincProver(self.types, mesh=self.mesh), self.cards)

    def warm(self) -> None:
        super().warm()
        for card in self.cards:
            torch.cuda.reset_peak_memory_stats(card)

    def step(self, step: int, inputs) -> dict:
        rec = super().step(step, inputs)
        counted = getattr(mesh_module, "MESH", None)
        rec["mesh"] = None if counted is None else dict(counted)
        return rec

    def close(self) -> None:
        super().close()
        for card in self.cards:
            with torch.cuda.device(card):
                torch.cuda.empty_cache()
