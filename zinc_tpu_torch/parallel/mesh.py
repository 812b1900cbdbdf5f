"""A mesh of torch devices for the sharded prover.

The port of ``zinc_tpu/parallel/mesh.py:134-175``.  A :class:`Mesh` is the
counterpart of ``jax.sharding.Mesh(np.array(devs), axes)``: a numpy object
array of ``torch.device`` of shape (D,) or (r, c) with one name per axis.
An entry may repeat, so ``Mesh([cuda:0] * 4)`` runs four shards on one card
and ``Mesh([cpu] * 8)`` eight on the CPU; every shard still runs its own
launches, sums, gathers and hand-overs.  A tensor is split into per-shard
blocks on their devices (:func:`shard_on_axis`) and gathered back
(:func:`fetch_global`); nothing here uses ``torch.distributed``, so the mesh
lives in one process.  The multi-process meshes of the reference
(``init_distributed``, ``hierarchical_mesh``) are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

AXIS = "hc"


class Mesh:
    """Devices laid out along named axes; ``devices.flat`` is the shard order
    (row-major, as JAX orders a 2-D mesh's blocks of a flattened axis).

    ``stats`` records what the sharded paths did with the mesh, so a caller
    can show that the mesh was used: ``"sharded_rounds"`` gets each
    sumcheck's count of rounds evaluated on more than one shard, ``"commit"``
    the layout each commit ran in."""

    def __init__(self, devices, axis_names=(AXIS,)):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = torch.device(src[idx])
        if arr.ndim != len(axis_names) or arr.size == 0:
            raise ValueError(f"devices of shape {arr.shape} for axes {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.stats: dict[str, list] = {}

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def flat(self) -> list[torch.device]:
        """The shards' devices in shard order."""
        return list(self.devices.flat)

    @property
    def first(self) -> torch.device:
        """The device that runs what is not sharded (setups, hand-overs)."""
        return self.devices.flat[0]

    def note(self, key: str, value) -> None:
        self.stats.setdefault(key, []).append(value)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat]})"


def _cuda_devices(n: int) -> list[torch.device]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(f"need {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def local_mesh(n_devices: int | None = None, axis: str = AXIS) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` cards (all by default)."""
    if n_devices is None:
        n_devices = max(1, torch.cuda.device_count() if torch.cuda.is_available() else 0)
    return Mesh(_cuda_devices(n_devices), (axis,))


def local_mesh_2d(rows: int, cols: int, axes: tuple[str, str] = ("r", "c")) -> Mesh:
    """A 2-D (rows × cols) mesh over the first rows·cols cards: "r" shards the
    codeword matrix's rows, "c" each row's interior; the sumcheck flattens it
    to rows·cols shards."""
    devs = _cuda_devices(rows * cols)
    return Mesh(np.array(devs, dtype=object).reshape(rows, cols), axes)


def shard_on_axis(devices, x: torch.Tensor, dim: int) -> list[torch.Tensor]:
    """``x`` cut into len(devices) equal contiguous blocks along ``dim``,
    block s on devices[s] (a contiguous copy where the cut is not one)."""
    d = len(devices)
    if x.shape[dim] % d:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split into {d} blocks")
    return [blk.to(dev).contiguous() for blk, dev in zip(x.chunk(d, dim=dim), devices)]


def fetch_global(blocks: list[torch.Tensor], dim: int, device="cpu") -> torch.Tensor:
    """The blocks joined along ``dim`` in shard order, on ``device``."""
    return torch.cat([b.to(device) for b in blocks], dim=dim)
