"""Device meshes over telemetry rows: one process over several devices,
or one process per device through ``torch.distributed``.

Counterpart of ``muse_psfr_tpu/parallel/mesh.py``.  The workload's only
parallel axis is data parallelism over telemetry rows: a chunk of ``c``
rows is cut into ``mesh.size`` equal shards, shard ``i`` runs on
``mesh.devices[i]``, and the batch layer gathers the shards' results so
that every process holds the whole chunk (``parallel/batch.py``).

* With no process group, one process drives every device of the mesh and
  runs their shards one after the other on the host (the devices overlap
  as far as their queues allow).
* With a process group (:func:`init_multihost`, or ``torchrun``), each
  rank drives its own devices; the mesh is the concatenation of every
  rank's devices in rank order.

A device may appear more than once (``["cpu"] * 8``, ``["cuda:0",
"cuda:0"]``): its shards then run one after the other.  That is how the
CPU tests and a one-card machine exercise the split.
"""

import dataclasses
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

ROWS = "rows"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over rows.  ``devices`` is the global shard order, one
    entry per shard; ``owners[i]`` is the rank that runs shard ``i``;
    ``rank``/``world`` are the process group's (0 and 1 with no group) and
    ``backend`` its backend (None with no group)."""
    devices: tuple
    owners: tuple
    rank: int = 0
    world: int = 1
    backend: str = None

    axis_names = (ROWS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> tuple:
        """The devices this process drives, in shard order."""
        return tuple(d for d, r in zip(self.devices, self.owners)
                     if r == self.rank)

    def local_shards(self) -> tuple:
        """``(shard index, device)`` of every shard this process runs."""
        return tuple((i, d) for i, (d, r)
                     in enumerate(zip(self.devices, self.owners))
                     if r == self.rank)


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """The split of a chunk's rows over a mesh: shard ``i`` of a chunk of
    ``c`` rows holds rows ``[i*c/n, (i+1)*c/n)``."""
    mesh: Mesh

    def local_slices(self, c: int) -> tuple:
        """``(shard index, device, row slice)`` of this process's shards
        of a chunk of ``c`` rows (``c`` a multiple of the mesh size)."""
        n = self.mesh.size
        if c % n:
            raise ValueError(f"a chunk of {c} rows does not split over a "
                             f"{n}-device mesh")
        k = c // n
        return tuple((i, d, slice(i * k, (i + 1) * k))
                     for i, d in self.mesh.local_shards())


def rows_sharding(mesh: Mesh) -> RowSharding:
    """The split of a chunk's leading (row) axis over ``mesh``."""
    return RowSharding(mesh)


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def _placed(device) -> torch.device:
    """``device`` resolved (raises for CUDA without a card), a CUDA device
    with its index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_mesh(devices=None) -> Mesh:
    """1-D mesh over ``devices`` (an entry may repeat).

    With no process group, ``devices=None`` means every local CUDA device;
    with one, each rank contributes its devices (``None``: its current
    CUDA device, which :func:`init_multihost` set) and the mesh is their
    concatenation in rank order, so every rank must drive as many.  There
    is no CPU fallback: asking for CUDA without a card raises."""
    if devices is None:
        resolve_device("cuda")
        local = ([_placed("cuda")] if _grouped() else
                 [torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())])
    else:
        local = [_placed(d) for d in devices]
    if not local:
        raise ValueError("a mesh needs at least one device")
    if not _grouped():
        return _checked(Mesh(tuple(local), (0,) * len(local)))
    world = dist.get_world_size()
    per_rank = [None] * world
    dist.all_gather_object(per_rank, [str(d) for d in local])
    if len({len(p) for p in per_rank}) != 1:
        raise ValueError("every rank must drive as many mesh devices: "
                         f"{per_rank}")
    return _checked(Mesh(
        tuple(torch.device(s) for p in per_rank for s in p),
        tuple(r for r, p in enumerate(per_rank) for _ in p),
        dist.get_rank(), world, dist.get_backend()))


def _checked(mesh: Mesh) -> Mesh:
    if len({d.type for d in mesh.devices}) != 1:
        raise ValueError(f"a mesh runs on one device type: {mesh.devices}")
    return mesh


def host_coordinator(num_processes, host="localhost"):
    """A rendezvous store for ``num_processes`` ranks on a port that the
    OS picks, held by the calling process, which takes no rank.  Start
    each rank with ``init_multihost(f"{host}:{store.port}", ...,
    hosted=True)`` and keep the store alive until they have joined.  The
    port is bound before any rank starts, so no other process can take it
    in between, as it can a port found free and let go."""
    return dist.TCPStore(host, 0, num_processes, is_master=True,
                         wait_for_workers=False)


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, *, device="cuda", backend=None,
                   hosted=False) -> Mesh:
    """Join the process group (one process per device) and return this
    rank's share of the global mesh (:func:`default_mesh` over its
    device).

    With ``coordinator_address`` (``host:port``) the group meets there,
    ``num_processes`` ranks, this one ``process_id``: rank 0 serves the
    rendezvous there, or, with ``hosted=True``, every rank joins the store
    of :func:`host_coordinator`.  Without it the ``env://`` variables that
    ``torchrun`` sets are read.  ``backend=None`` is ``"nccl"`` for CUDA
    and ``"gloo"`` for the CPU.  NCCL refuses two ranks on one card; such
    a layout needs ``backend="gloo"``.  A CUDA rank's device is
    ``cuda:{LOCAL_RANK}``, else ``cuda:{rank % device count}``.  Call it
    once per process, before the first night, and
    :func:`shutdown_multihost` after the last."""
    kind = torch.device(device).type
    if kind == "cuda":
        resolve_device("cuda")
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    if coordinator_address is not None and hosted:
        host, port = coordinator_address.split("://")[-1].rsplit(":", 1)
        store = dist.TCPStore(host, int(port), num_processes,
                              is_master=False)
        dist.init_process_group(backend, store=store,
                                world_size=num_processes, rank=process_id)
    elif coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else "tcp://" + coordinator_address)
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    dev = torch.device(kind)
    if kind == "cuda":
        local_rank = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    return default_mesh([dev])


def shutdown_multihost():
    """Leave the process group that :func:`init_multihost` joined, after a
    barrier, so that every rank tears it down and none while another still
    uses it; nothing when no group is up.  A rank that exits with its
    group up can abort in gloo's teardown after its work is done."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
