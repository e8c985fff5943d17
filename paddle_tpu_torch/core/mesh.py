"""The device mesh: `paddle_tpu/core/mesh.py` on torch.distributed.

A `Mesh` names the axes of a world of ranks and their sizes, row-major
over the ranks as the JAX mesh lays devices out (`np.reshape` of the
device list). With a process group it holds one group per axis, built
by `torch.distributed.device_mesh.init_device_mesh`; with only a shape
it serves the spec logic (`parallel/sharding.py`) and the one-rank
default.

Canonical axis names:
  data  — data parallel (batch split, gradients averaged)
  model — tensor/model parallel (weight shards)
  seq   — sequence parallel (ring attention / all-to-all)
  pipe  — pipeline stages (`parallel/pipeline.py`)

Backends: NCCL on the card with one rank per card; gloo for the CPU,
and for several ranks sharing one card (NCCL refuses two ranks on one
device, and asking for it raises here with that reason). A rank's
tensors live on `cuda:(local_rank % device_count)`.

Ported: `make_mesh` (the same `-1` rule and `ValueError`s),
`set_mesh` / `get_mesh` (with no process group: the one-rank mesh),
`distributed_init` (an explicit store: a `FileStore` in the tests, or
`tcp://host:port`). Left out: the JAX `shard_map` shim (the port's
collectives are `parallel/collectives.py`), a prefix sub-mesh over a
world of processes (every rank must be in the mesh; a shape-only mesh
keeps JAX's warning).
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
from typing import Optional

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"

_log = logging.getLogger(__name__)


class Mesh:
    """Axis names and sizes over a world of ranks, and this rank's place
    in it. `groups` maps an axis to its process group (None: a mesh with
    only a shape). `backend` is the process groups' ("nccl" or "gloo"),
    `device` the device this rank's tensors live on."""

    def __init__(self, shape: dict, rank: int = 0, groups=None,
                 backend: Optional[str] = None, device=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        coords, r = {}, rank
        for name in reversed(self.axis_names):
            coords[name] = r % self.shape[name]
            r //= self.shape[name]
        self.coords = {n: coords[n] for n in self.axis_names}
        self.groups = dict(groups or {})
        self.backend = backend
        self.device = torch.device(device) if device is not None else None
        # collectives run over the mesh's process groups, and the bytes
        # staged through pinned host memory by gloo collectives of CUDA
        # tensors (parallel/collectives.py)
        self.calls = 0
        self.host_bytes = 0

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend})")

    @property
    def distributed(self) -> bool:
        """Whether the mesh has process groups (collectives run)."""
        return bool(self.groups)

    def axis_size(self, axis: str) -> int:
        """The axis' size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (0 for an absent axis)."""
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of `axis`."""
        if axis not in self.groups:
            raise ValueError(
                f"{self!r} has no process group for axis {axis!r}")
        return self.groups[axis]

    def axis_ranks(self, axis: str) -> list:
        """The global ranks along `axis` through this rank, in axis
        order."""
        strides, s = {}, 1
        for name in reversed(self.axis_names):
            strides[name] = s
            s *= self.shape[name]
        base = self.rank - self.coords[axis] * strides[axis]
        return [base + i * strides[axis] for i in range(self.shape[axis])]


def _world() -> tuple:
    """(world size, rank, whether there is a process group)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), True
    return 1, 0, False


def _sizes(shape: Optional[dict], n: int) -> dict:
    """The JAX rule: no shape puts every rank on `data`; a -1 takes the
    remaining ranks."""
    if not shape:
        return {DATA_AXIS: n}
    names = list(shape.keys())
    sizes = list(shape.values())
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known != 0:
            raise ValueError(
                f"mesh shape {dict(zip(names, sizes))}: -1 cannot take the "
                f"remaining devices ({known} does not divide {n})"
            )
        sizes[sizes.index(-1)] = n // known
    prod = math.prod(sizes)
    if prod > n:
        raise ValueError(f"mesh shape {dict(zip(names, sizes))} > {n} devices")
    return dict(zip(names, sizes))


def make_mesh(shape: Optional[dict] = None, devices=None) -> Mesh:
    """Build a mesh. `shape` maps axis name -> size; a size of -1 takes
    every remaining rank. Default: all ranks on the `data` axis.
    `devices` is the number of ranks the shape is laid over (default:
    the world's size, 1 without a process group); a world of processes
    gets one process group per axis."""
    world, rank, grouped = _world()
    n = world if devices is None else (
        devices if isinstance(devices, int) else len(devices))
    sizes = _sizes(shape, n)
    prod = math.prod(sizes.values())
    if not grouped or devices is not None and n != world:
        if prod < n:
            _log.warning("mesh shape %s uses %d of %d devices "
                         "(prefix sub-mesh)", sizes, prod, n)
        return Mesh(sizes)
    if prod < world:
        raise ValueError(
            f"mesh shape {sizes} covers {prod} of {world} ranks; every "
            f"rank of the world must be in the mesh")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    backend = dist.get_backend()
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          tuple(sizes.values()),
                          mesh_dim_names=tuple(sizes))
    groups = {name: dm.get_group(name) for name in sizes}
    return Mesh(sizes, rank=rank, groups=groups, backend=backend,
                device=_rank_device)


_current_mesh: Optional[Mesh] = None
# this rank's device, set by distributed_init
_rank_device = None


def set_mesh(mesh: Mesh) -> None:
    global _current_mesh
    _current_mesh = mesh


def get_mesh() -> Mesh:
    """The mesh set by `set_mesh`; else every rank of the world on
    `data` (the one-rank mesh without a process group)."""
    global _current_mesh
    if _current_mesh is None:
        _current_mesh = make_mesh()
    return _current_mesh


def rank_device(device=None, local_rank: Optional[int] = None):
    """The device of this rank: `cuda:(local_rank % device_count)` for
    a CUDA device (raises without a card), the CPU for "cpu"."""
    from paddle_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def distributed_init(coordinator_address=None, num_processes=None,
                     process_id=None, *, store=None, backend=None,
                     device=None, local_rank: Optional[int] = None):
    """Join a world of `num_processes` ranks as rank `process_id`.

    The rendezvous is explicit: `store` (a `torch.distributed.Store`,
    e.g. a `FileStore`) or `coordinator_address` ("host:port" or
    "tcp://host:port", rank 0 listens). `device` is where this rank
    computes (the card unless "cpu"); `backend` defaults to NCCL when
    each rank of the world has a card of its own and to gloo otherwise
    (the CPU, or ranks sharing a card). NCCL with two ranks on one
    device raises. Returns this rank's device."""
    import torch.distributed as dist

    global _rank_device
    if store is None and coordinator_address is None:
        return None
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", process_id or 0))
    dev = rank_device(device, local_rank)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    # ranks on one host share its cards; local ranks past the card count
    # land on a card another rank already has
    shared = dev.type == "cuda" and num_processes > cards
    if backend is None:
        backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend needs ranks on CUDA devices")
        if shared:
            raise ValueError(
                f"NCCL cannot run {num_processes} ranks on {cards} "
                f"card(s): NCCL refuses two ranks on one device; use "
                f"backend='gloo' for ranks that share a card")
        torch.cuda.set_device(dev)
    kw = {}
    if store is not None:
        kw["store"] = store
    else:
        addr = coordinator_address
        kw["init_method"] = addr if "://" in addr else f"tcp://{addr}"
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, rank=process_id,
                            world_size=num_processes, **kw)
    _rank_device = dev
    return dev


# ---- the batch shard a step runs on ----------------------------------

_batch_mesh: Optional[Mesh] = None


@contextlib.contextmanager
def batch_context(mesh: Optional[Mesh]):
    """Within the body: the network runs on this rank's slice of a
    global batch split over `mesh`'s data axis. Layers that read the
    whole batch (BN's statistics, the MoE balance loss) reduce over the
    axis, and random layers draw the global mask and take their rows
    (`batch_rows`)."""
    global _batch_mesh
    prev, _batch_mesh = _batch_mesh, mesh
    try:
        yield
    finally:
        _batch_mesh = prev


def batch_mesh() -> Optional[Mesh]:
    """The mesh of the running step's batch split (None: one rank's
    whole batch)."""
    return _batch_mesh


def batch_rows(local_rows: int) -> tuple:
    """(first row, global rows) of this rank's slice of the batch."""
    m = _batch_mesh
    if m is None:
        return 0, local_rows
    return (m.axis_index(DATA_AXIS) * local_rows,
            m.axis_size(DATA_AXIS) * local_rows)
