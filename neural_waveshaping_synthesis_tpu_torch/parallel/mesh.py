"""Meshes: the data axis over processes, the time axis over devices
(counterpart of the JAX ``parallel/mesh.py``).

JAX builds one ``Mesh`` over every visible device in one process: batches
sharded on its ``data`` axis, parameters replicated, and GSPMD inserting
the collectives. PyTorch runs one process per card, so the port's
:class:`Mesh` holds two things:

* the data axis: the rank and world size of the initialised
  ``torch.distributed`` process group (``torchrun``, or ranks the caller
  spawns), one rank when none is initialised. Each rank holds its
  contiguous rows of the global batch, as ``P("data")`` gives each device
  (:func:`shard_batch`). The gradient and the loss's partial sums are summed
  across the ranks explicitly (:func:`all_reduce_sum_`, by
  ``training/trainer.py`` and ``training/loss.py``), where GSPMD inserts a
  ``psum``;
* a device list, the time axis of the one-process time-sharded renderer
  (:mod:`.time_shard`). It may repeat a device: ``[cuda:0] * 8`` renders 8
  chunks in turn on one card, as JAX's virtual CPU devices share one host.

No ``model`` axis: JAX reserves one of size 1 and never uses it.
"""
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"

DeviceLike = Union[str, torch.device]


@dataclass(frozen=True)
class Mesh:
    """``devices`` for time sharding; ``rank`` of ``world_size`` in
    ``group``, the process group (None when no group is initialised: one
    rank, nothing to reduce)."""

    devices: Tuple[torch.device, ...]
    rank: int = 0
    world_size: int = 1
    group: Optional[object] = None

    @property
    def distributed(self) -> bool:
        """True when a process group is initialised, at any world size:
        the gradient is then summed through it (at world size 1 a no-op
        that keeps the group's backend on the path)."""
        return self.group is not None


def create_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence[DeviceLike]] = None
) -> Mesh:
    """The mesh of this process: the visible cards (the CPU where there is
    none), or ``devices`` as given, the first ``n_devices`` of them (JAX's
    ``devices[:n]``); the rank and world size of the initialised process
    group, or one rank."""
    if devices is None:
        n_cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i) for i in range(n_cards)] or [torch.device("cpu")]
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if dist.is_available() and dist.is_initialized():
        return Mesh(devices, dist.get_rank(), dist.get_world_size(), dist.group.WORLD)
    return Mesh(devices)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """The rows one rank holds of a global batch; raises ValueError when
    the batch does not divide by the world size."""
    if global_batch % mesh.world_size:
        raise ValueError(
            f"batch size {global_batch} is not divisible by the data-parallel "
            f"degree {mesh.world_size}; adjust batch_size or run fewer ranks "
            f"(torchrun --nproc_per_node)"
        )
    return global_batch // mesh.world_size


@dataclass(frozen=True)
class Sharding:
    """Which rows of a leading axis this rank holds: the contiguous block
    ``rank`` of ``world_size`` for ``P("data")`` (:func:`batch_sharding`),
    all of them for ``P()`` (:func:`replicated_sharding`)."""

    mesh: Mesh
    spec: Tuple[str, ...]

    def rows(self, n: int) -> slice:
        if not self.spec:
            return slice(0, n)
        k = local_batch_size(n, self.mesh)
        return slice(self.mesh.rank * k, (self.mesh.rank + 1) * k)

    def __call__(self, x):
        """This rank's rows of an array or tensor."""
        return x[self.rows(x.shape[0])]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis (batch) sharding over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of each leaf of a global batch dict (arrays or
    tensors; index arrays too, so a lazy loader reads only its rows)."""
    shard = batch_sharding(mesh)
    return {k: shard(v) for k, v in batch.items()}


def all_reduce_sum_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Sum each tensor over the mesh's ranks, in place, through one flat
    bucket: one collective for all of them. Every rank gets the same bits.
    Nothing to do without a process group."""
    if not mesh.distributed or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    _unflatten_into(flat, tensors)


def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Copy rank 0's tensors to every rank, in place, through one flat
    bucket."""
    if not mesh.distributed or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, 0, group=mesh.group)
    _unflatten_into(flat, tensors)


def _unflatten_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset : offset + n].view_as(t))
        offset += n
