"""The session's shard mesh and the bootstrap of a multi-process job.

Counterpart of ``hyperspace_tpu/parallel/mesh.py``. The reference's mesh
is a 1-D ``jax.sharding.Mesh`` over every addressable device; here it is
a list of torch devices, one a shard. A list may name one device more
than once: that is how the CPU tests run D shards on one CPU and how one
GPU runs D shards, as the reference's tests run 8 virtual devices of one
CPU. The shards of one process exchange rows by copies between their
devices (``parallel/shuffle.py``).

A job of several processes joins through ``torch.distributed``
(:func:`initialize_distributed`). Its mesh is process-major: process p
holds shards ``[p * L, (p + 1) * L)``, its own L local devices, and the
shard count is ``P * L``. The backend is the caller's: ``nccl`` for one
rank a GPU, ``gloo`` on the CPU and for ranks that share a card. NCCL
asked for with more ranks on a host than it has GPUs raises; nothing
switches the backend.
"""

from __future__ import annotations

from datetime import timedelta
from typing import List, Optional, Sequence

import torch

from hyperspace_tpu_torch.exceptions import HyperspaceException

_DISTRIBUTED_INITIALIZED = False


def _dist():
    import torch.distributed as dist

    return dist


def process_count() -> int:
    """The world size of the joined ``torch.distributed`` group, 1 when
    none is initialized (the reference's ``jax.process_count()``)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank, 0 when no group is initialized."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def backend() -> Optional[str]:
    """The joined group's backend (``gloo`` / ``nccl``), None outside a
    group."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return str(dist.get_backend())
    return None


def comm_device() -> torch.device:
    """The device of the tensors the group's collectives take: the
    current CUDA device under NCCL, the CPU under gloo."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize_distributed(
    init_method: str,
    world_size: int,
    rank: int,
    backend: str,
    timeout_s: float = 120.0,
    local_world_size: Optional[int] = None,
) -> None:
    """Join a multi-process job (a second call is a no-op). Call it before
    creating a session on every process.

    ``init_method`` is a ``file://`` path every process can reach or
    ``tcp://host:port``; ``backend`` is explicit: ``nccl`` needs one GPU a
    rank (rank r of a host takes ``cuda:r % local_world_size``, and a host
    with fewer GPUs than ranks raises); ``gloo`` runs on the CPU and for
    ranks that share a card (its collectives stage CUDA tensors through
    host memory). ``local_world_size`` is the ranks on this host
    (default: all of them). ``timeout_s`` bounds every collective, so a
    peer that never arrives fails the job instead of hanging it.

    Registered in ``COLLECTIVE_SITES`` (``parallel/collectives.py``)."""
    global _DISTRIBUTED_INITIALIZED
    dist = _dist()
    if _DISTRIBUTED_INITIALIZED or (dist.is_available() and dist.is_initialized()):
        _DISTRIBUTED_INITIALIZED = True
        return
    if backend not in ("gloo", "nccl"):
        raise HyperspaceException(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if not 0 <= rank < world_size:
        raise HyperspaceException(f"rank {rank} outside a world of {world_size}")
    if backend == "nccl":
        local = world_size if local_world_size is None else int(local_world_size)
        gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not dist.is_nccl_available() or gpus < local:
            raise HyperspaceException(
                f"nccl needs one GPU a rank: {local} ranks on this host, {gpus} GPUs "
                "(ranks that share a card take backend='gloo')"
            )
        torch.cuda.set_device(rank % local)
    dist.init_process_group(
        backend=backend,
        init_method=init_method,
        world_size=world_size,
        rank=rank,
        timeout=timedelta(seconds=timeout_s),
    )
    _DISTRIBUTED_INITIALIZED = True


def shutdown_distributed() -> None:
    """Leave the joined group (the end of a worker)."""
    global _DISTRIBUTED_INITIALIZED
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _DISTRIBUTED_INITIALIZED = False


def bucket_owner_groups(bucket_ids: Sequence[int], num_shards: int, min_tasks: int = 1):
    """Index groups of ``bucket_ids`` by owner shard (``bucket %
    num_shards``, the routing the build exchange uses), one list of
    positions an occupied shard, ascending shard id. ``min_tasks`` splits
    large groups within a shard (never across one) until at least that
    many exist. Callers collect results per bucket position, so any
    grouping gives the same output; only scheduling changes."""
    groups: dict = {}
    for i, b in enumerate(bucket_ids):
        groups.setdefault(int(b) % num_shards, []).append(i)
    ordered = [groups[s] for s in sorted(groups)]
    if min_tasks <= len(ordered):
        return ordered
    chunks_per = -(-min_tasks // len(ordered))
    out = []
    for g in ordered:
        size = -(-len(g) // chunks_per)
        out.extend(g[i : i + size] for i in range(0, len(g), size))
    return out


class Mesh:
    """A 1-D shard mesh: ``local_devices`` are this process's shards (a
    device may repeat); on a job of P processes the mesh has ``P * L``
    shards, process-major, and this process owns ``[p * L, (p + 1) * L)``.
    """

    def __init__(self, local_devices: Sequence, processes: int = 1, index: int = 0):
        devs = [torch.device(d) for d in local_devices]
        if not devs:
            raise HyperspaceException("a mesh needs at least one device")
        self.local_devices: List[torch.device] = devs
        self.processes = int(processes)
        self.process_index = int(index)

    @property
    def local_size(self) -> int:
        return len(self.local_devices)

    @property
    def size(self) -> int:
        return self.processes * self.local_size

    @property
    def platform(self) -> str:
        return self.local_devices[0].type

    def device(self, shard: int) -> torch.device:
        """The device of global shard ``shard`` (one of this process's)."""
        p, lane = divmod(int(shard), self.local_size)
        if p != self.process_index:
            raise HyperspaceException(
                f"shard {shard} belongs to process {p}, not {self.process_index}"
            )
        return self.local_devices[lane]

    def __repr__(self) -> str:
        return (
            f"Mesh({[str(d) for d in self.local_devices]}, processes={self.processes}, "
            f"index={self.process_index})"
        )


def default_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The flat data-plane mesh: one shard a listed device (default: the
    current CUDA device), times the processes of a joined job."""
    if devices is None:
        devices = [torch.device("cuda", torch.cuda.current_device())]
    return Mesh(devices, process_count(), process_index())


def hierarchical_mesh(mesh: Optional[Mesh] = None):
    """The ``(processes, local shards)`` view of a mesh, as ``(H, L)``:
    the layout of the two-stage exchange (the cross-process leg once a
    peer process, the local leg in host memory)."""
    mesh = mesh if mesh is not None else default_mesh()
    return mesh.processes, mesh.local_size


class MeshRuntime:
    """The mesh a session owns, built on first use from its devices."""

    def __init__(self, devices: Optional[Sequence] = None):
        self._devices = None if devices is None else list(devices)
        self._mesh: Optional[Mesh] = None

    @property
    def mesh(self) -> Mesh:
        if self._mesh is None:
            self._mesh = default_mesh(self._devices)
        return self._mesh

    @property
    def num_shards(self) -> int:
        return self.mesh.size

    @property
    def process_index(self) -> int:
        return process_index()

    @property
    def is_coordinator(self) -> bool:
        """Rank 0 owns the metadata plane (the action protocol's log
        writes) on a multi-process job."""
        return process_index() == 0

