"""Parallelism layer: the data-parallel mesh over ``torch.distributed`` and its helpers."""

from .mesh import Mesh, data_parallel_mesh, gather_rows, maybe_shard_batch, replicate

__all__ = ["Mesh", "data_parallel_mesh", "maybe_shard_batch", "replicate", "gather_rows"]
