"""A mesh of torch devices for the sharded prover, in one process or over
several.

The port of ``zinc_tpu/parallel/mesh.py``.  A :class:`Mesh` is the
counterpart of ``jax.sharding.Mesh(np.array(devs), axes)``: a numpy object
array of ``torch.device`` of shape (D,) or (r, c) with one name per axis.
An entry may repeat, so ``Mesh([cuda:0] * 4)`` runs four shards on one card
and ``Mesh([cpu] * 8)`` eight on the CPU; every shard still runs its own
launches, sums, gathers and hand-overs.  A tensor is split into per-shard
blocks on their devices (:func:`shard_on_axis`) and gathered back
(:func:`fetch_global`).

Several processes (the reference's DCN meshes): :func:`init_distributed`
starts ``torch.distributed`` from explicit coordinates or torch's own
variables, and :func:`hierarchical_mesh` builds a ("host", "chip") mesh
whose row r is rank r's local devices.  Such a mesh carries a
:class:`ProcessGroup`; a process holds only its own row's shards, and
every step that crosses shards all-gathers, in rank order, host tensors
(gloo) or tensors on the rank's card (NCCL, where every rank has a card of
its own): the sumcheck's round residues and its hand-over blocks, the
commit's row roots, the open's integer accumulators and column records.
Importing this module starts no process group.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

AXIS = "hc"
HIERARCHICAL_AXES = ("host", "chip")


class ProcessGroup:
    """The processes of a mesh: this process's ``rank`` of ``world``, the
    torch.distributed ``backend`` and the device its collectives run on (the
    CPU for gloo, the rank's card for NCCL).  ``calls`` and ``bytes`` count
    the all-gathers and the bytes each brought from the other processes."""

    def __init__(self, rank: int, world: int, backend: str, device):
        self.rank = rank
        self.world = world
        self.backend = backend
        self.device = torch.device(device)
        self.calls = 0
        self.bytes = 0

    def all_gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` of every process (each the same shape and dtype), in rank
        order, on the CPU."""
        import torch.distributed as dist

        x = x.to(self.device).contiguous()
        out = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(out, x)
        self.calls += 1
        self.bytes += x.numel() * x.element_size() * (self.world - 1)
        return [t.cpu() for t in out]

    def all_gather_array(self, a: np.ndarray) -> list[np.ndarray]:
        """A numpy array of every process, in rank order (sent as bytes)."""
        a = np.ascontiguousarray(a)
        parts = self.all_gather(torch.from_numpy(a.reshape(-1).view(np.uint8).copy()))
        return [p.numpy().view(a.dtype).reshape(a.shape) for p in parts]

    def __repr__(self) -> str:
        return f"ProcessGroup(rank {self.rank} of {self.world}, {self.backend})"


class Mesh:
    """Devices laid out along named axes; ``devices.flat`` is the shard order
    (row-major, as JAX orders a 2-D mesh's blocks of a flattened axis).

    With a ``group`` (:class:`ProcessGroup`) the rows of the first axis are
    processes: row ``group.rank`` holds this process's devices and the
    other rows None, and the process runs only its own shards
    (``local_flat``, from flat index ``shard_offset``).

    ``stats`` records what the sharded paths did with the mesh, so a caller
    can show that the mesh was used: ``"sharded_rounds"`` gets each
    sumcheck's count of rounds evaluated on more than one shard, ``"commit"``
    the layout each commit ran in."""

    def __init__(self, devices, axis_names=(AXIS,), group: ProcessGroup | None = None):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = None if src[idx] is None else torch.device(src[idx])
        if arr.ndim != len(axis_names) or arr.size == 0:
            raise ValueError(f"devices of shape {arr.shape} for axes {tuple(axis_names)}")
        if group is not None and not 0 <= group.rank < arr.shape[0]:
            raise ValueError(f"rank {group.rank} has no row in a mesh of {arr.shape[0]} rows")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.group = group
        per_row = arr.size // arr.shape[0]
        self.shard_offset = 0 if group is None else group.rank * per_row
        n_local = arr.size if group is None else per_row
        self.local_flat = list(arr.flat)[self.shard_offset : self.shard_offset + n_local]
        if any(d is None for d in self.local_flat):
            raise ValueError("every local entry of a mesh must be a device")
        self.stats: dict[str, list] = {}

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def local_rows(self) -> range:
        """The rows of the first axis this process holds."""
        rows = self.devices.shape[0]
        return range(rows) if self.group is None else range(self.group.rank, self.group.rank + 1)

    @property
    def first(self) -> torch.device:
        """The device that runs what is not sharded (setups, hand-overs): the
        first of this process's devices."""
        return self.local_flat[0]

    def note(self, key: str, value) -> None:
        self.stats.setdefault(key, []).append(value)

    def __repr__(self) -> str:
        procs = "" if self.group is None else f", {self.group}"
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]}{procs})"


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def init_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    master_addr: str | None = None,
    master_port: int | None = None,
    timeout_s: float = 300.0,
) -> bool:
    """Start ``torch.distributed`` for a mesh over several processes
    (``zinc_tpu/parallel/mesh.py:36-82``).

    Explicit arguments win: ``init_method`` (``"tcp://host:port"``) or
    ``master_addr`` and ``master_port``, ``world_size``, ``rank`` and
    ``backend``; otherwise torch's own variables ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` are read.  Returns True
    when more than one process is active, False otherwise; with no
    coordinates at all, or a world of one, it starts no group.  A second
    call is a no-op.  A dead coordinator or a port conflict raises (after
    ``timeout_s`` at most, which also bounds every collective): no process
    is left quietly proving alone.  The backend is NCCL only where every
    process of this host has a card of its own (``LOCAL_RANK`` of
    ``LOCAL_WORLD_SIZE``, by default the rank of the world), gloo
    otherwise."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    addr = master_addr or os.environ.get("MASTER_ADDR")
    port = master_port or _env_int("MASTER_PORT")
    world = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if init_method is None and addr is not None and port is not None:
        init_method = f"tcp://{addr}:{port}"
    if init_method is None and world is None:
        return False
    if init_method is None or world is None:
        raise ValueError("init_distributed needs both an address (init_method, or master_addr "
                         "and master_port) and world_size")
    if world <= 1:
        return False
    rank = rank if rank is not None else _env_int("RANK")
    if rank is None:
        raise ValueError("init_distributed needs this process's rank (rank= or RANK)")
    card = _own_card(rank, world)
    if backend is None:
        backend = "gloo" if card is None else "nccl"
    if backend == "nccl":
        if card is None:
            raise ValueError("NCCL needs a card of its own for every process of the host")
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1


def _own_card(rank: int, world: int) -> int | None:
    """This process's card when every process of the host has one of its
    own: LOCAL_RANK (default ``rank``) when the host has at least
    LOCAL_WORLD_SIZE (default ``world``) cards; else None."""
    local_rank = _env_int("LOCAL_RANK")
    local_world = _env_int("LOCAL_WORLD_SIZE")
    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return local_rank if have >= local_world else None


def _process_group() -> ProcessGroup | None:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return None
    backend = dist.get_backend()
    device = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else "cpu"
    return ProcessGroup(dist.get_rank(), dist.get_world_size(), backend, device)


def hierarchical_mesh(
    hosts: int | None = None,
    chips_per_host: int | None = None,
    axes: tuple[str, str] = HIERARCHICAL_AXES,
    devices=None,
) -> Mesh:
    """A ("host", "chip") mesh whose first axis crosses processes
    (``zinc_tpu/parallel/mesh.py:85-132``).

    With ``torch.distributed`` started (:func:`init_distributed`), row r is
    rank r's ``devices`` (by default its cards: its own card under NCCL,
    else every card of the host; given explicitly, two ranks may share
    ``cuda:0``, and a CPU run passes ``"cpu"``), ``hosts`` defaults to the
    world size and must equal it, and ``chips_per_host`` to the number of
    local devices.  In one process the local devices (every card by
    default) are reshaped to (hosts, chips_per_host), which must both be
    given."""
    group = _process_group()
    if devices is None:
        devices = _default_local_devices(group)
    devices = [torch.device(d) for d in devices]
    if group is None:
        if hosts is None or chips_per_host is None:
            raise ValueError("single-process hierarchical_mesh needs an explicit shape")
        if len(devices) < hosts * chips_per_host:
            raise ValueError(f"need {hosts * chips_per_host} devices, have {len(devices)}")
        arr = np.empty(hosts * chips_per_host, dtype=object)
        arr[:] = devices[: hosts * chips_per_host]
        return Mesh(arr.reshape(hosts, chips_per_host), axes)
    hosts = group.world if hosts is None else hosts
    chips_per_host = len(devices) if chips_per_host is None else chips_per_host
    if hosts != group.world:
        raise ValueError(f"a mesh of {hosts} host rows over {group.world} processes")
    if len(devices) != chips_per_host:
        raise ValueError(f"{chips_per_host} chips a host, but {len(devices)} local devices")
    arr = np.empty((hosts, chips_per_host), dtype=object)
    arr[group.rank] = devices
    return Mesh(arr, axes, group)


def _default_local_devices(group: ProcessGroup | None) -> list[torch.device]:
    """The rank's own card under NCCL, else every card of the host."""
    if group is not None and group.backend == "nccl":
        return [group.device]
    return _cuda_devices(max(1, torch.cuda.device_count() if torch.cuda.is_available() else 0))


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


def fetch_global(blocks: list[torch.Tensor], dim: int, device="cpu",
                 group: ProcessGroup | None = None) -> torch.Tensor:
    """The blocks joined along ``dim`` in shard order, on ``device``; with a
    ``group``, this process's blocks joined with every other process's, in
    rank order (``zinc_tpu/parallel/mesh.py:150-160``)."""
    local = torch.cat([b.to(device) for b in blocks], dim=dim)
    if group is None:
        return local
    return torch.cat(group.all_gather(local), dim=dim).to(device)
