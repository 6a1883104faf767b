"""Parallelism of the port (counterpart of the JAX ``parallel/``).

The reference's only distribution strategy is single-node DataParallel
(PL ``accelerator='dp'``, gin/train/train_newt.gin:13). JAX meshes every
device in one process; PyTorch runs a process per card. Here the data axis
is a ``torch.distributed`` process group (``torchrun``): each rank holds its
rows of the global batch, and the Trainer sums the gradient and the loss's
partial sums across the ranks (:mod:`.mesh`). One long clip renders in time
chunks over a device list instead (:mod:`.time_shard`).
"""
from .mesh import (
    Mesh,
    all_reduce_sum_,
    batch_sharding,
    broadcast_,
    create_mesh,
    local_batch_size,
    replicated_sharding,
    shard_batch,
)
from .time_shard import make_time_sharded_renderer

__all__ = [
    "Mesh",
    "all_reduce_sum_",
    "batch_sharding",
    "broadcast_",
    "create_mesh",
    "local_batch_size",
    "replicated_sharding",
    "shard_batch",
    "make_time_sharded_renderer",
]
