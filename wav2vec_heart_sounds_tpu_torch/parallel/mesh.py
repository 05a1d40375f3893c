"""Data parallelism over cards with ``torch.distributed`` (port of ``parallel/mesh.py``).

The JAX package drives every device from one process: ``maybe_shard_batch`` splits the
leading axis of each batch array over a 1-D ``dp`` mesh, ``replicate`` copies parameters and
optimizer state to every device, and XLA inserts the gradient ``psum``, so the loss is the
global batch's. Here each card has its own process (launched by ``torchrun``), and the
processes form one process group. The semantics stay:

* every rank builds the same global batch (the same ``Batcher`` seed), and
  :func:`maybe_shard_batch` keeps rank r's rows ``[r*b, (r+1)*b)``, so only those cross to
  its card;
* :func:`replicate` broadcasts parameters from rank 0;
* :func:`gather_rows` concatenates every rank's rows in rank order; its backward is the
  exact transpose (the incoming gradients summed over the ranks, cut to the rank's rows),
  so a trainer computes the global batch's loss on every rank;
* :class:`..train.optim.MasterOptimizer` takes the mean all-reduce of the gradients
  (:func:`all_reduce_mean`) before its clip, in place of the ``psum``: with the gather's sum,
  that is exactly the gradient of the global loss.

As in the JAX package there is no tensor, pipeline or sequence parallelism: wav2vec2-base and
both vocoders fit on one card, so data parallelism is the whole story at this scale.
``batch_sharding`` and ``replicated`` have no counterpart: they build JAX ``NamedSharding``s,
the placement a jitted program reads, and a torch rank holds plain tensors on its own card.

A mesh on the card runs on NCCL, a mesh on the CPU on gloo, and nothing falls back from one
to the other: a group that cannot form raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D data-parallel mesh (the default process group): its rank,
    the world size and its device."""
    rank: int
    world_size: int
    device: torch.device


def _backend(device: torch.device) -> str:
    return "gloo" if device.type == "cpu" else "nccl"


def data_parallel_mesh(device=None) -> Mesh:
    """The mesh of this process. With a default process group already initialised (a
    ``file://`` or ``tcp://`` store), it uses that group; otherwise it initialises one from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous
    address). ``device`` defaults to ``cuda:LOCAL_RANK`` (NCCL); pass ``"cpu"`` for gloo."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        raise RuntimeError("no process group: launch under torchrun (RANK, WORLD_SIZE, "
                           "LOCAL_RANK) or call torch.distributed.init_process_group first")
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device("cuda", local) if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local)
    backend = _backend(device)
    if dist.is_initialized():
        if backend not in dist.get_backend():
            raise RuntimeError(f"a mesh on {device} needs the {backend} backend; the process "
                               f"group runs {dist.get_backend()}")
    else:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                device_id=device if device.type == "cuda" else None)
    return Mesh(rank, world, device)


def mesh_device(mesh: Mesh | None, device) -> torch.device:
    """The device an entry point builds on: ``device`` without a mesh, else the mesh's,
    which a ``device`` of another type or index contradicts."""
    if mesh is None:
        return torch.device(device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (data_parallel_mesh()), not "
                        f"{type(mesh).__name__}")
    asked = torch.device(device)
    if asked.type != mesh.device.type or asked.index not in (None, mesh.device.index):
        raise ValueError(f"device={device} contradicts the mesh's device {mesh.device}")
    return mesh.device


def is_main(mesh: Mesh | None) -> bool:
    """Whether this process writes files and logs: rank 0, or the only process."""
    return mesh is None or mesh.rank == 0


def rank_seed(seed: int, mesh: Mesh | None) -> int:
    """The seed of this rank's own random stream: ``seed`` itself on rank 0 (and without a
    mesh), another stream derived from ``(seed, rank)`` on the others."""
    if mesh is None or mesh.rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, mesh.rank]).generate_state(1)[0])


def _to(array: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(array))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _rank_rows(n: int, mesh: Mesh | None) -> slice:
    if mesh is None:
        return slice(None)
    w = mesh.world_size
    if n % w:
        raise ValueError(
            f"batch size {n} is not divisible by the {w}-device dp mesh; "
            f"pick a batch size that is a multiple of {w} (the Batcher pads partial "
            "batches, so any multiple works)")
    rows = n // w
    return slice(mesh.rank * rows, (mesh.rank + 1) * rows)


def maybe_shard_batch(array, mesh: Mesh | None, device="cuda") -> torch.Tensor:
    """This rank's rows of the batch ``array`` (leading axis split evenly over the mesh) on
    the mesh's device; without a mesh, the whole array on ``device``. A host array crosses
    from pinned memory; a tensor may lie on any device."""
    target = torch.device(device) if mesh is None else mesh.device
    if isinstance(array, torch.Tensor):
        return array[_rank_rows(array.shape[0], mesh)].to(target)
    a = np.asarray(array)
    return _to(a[_rank_rows(a.shape[0], mesh)], target)


@torch.no_grad()
def replicate(tensors, mesh: Mesh | None):
    """Broadcast a module's parameters and buffers, a dict's values or a list of tensors
    from rank 0, in place; returns its argument (unchanged without a mesh)."""
    if mesh is None:
        return tensors
    if isinstance(tensors, torch.nn.Module):
        items = [*tensors.parameters(), *tensors.buffers()]
    elif isinstance(tensors, dict):
        items = list(tensors.values())
    else:
        items = list(tensors)
    for t in items:
        dist.broadcast(t.detach(), src=0)
    return tensors


# torch 2.13 renames all_gather_into_tensor (and warns on the old name); older releases
# have only the old one.
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        out = x.new_empty((mesh.world_size * x.shape[0], *x.shape[1:]))
        _all_gather_single(out, x.contiguous())
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh = ctx.mesh
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        rows = grad.shape[0] // mesh.world_size
        return grad[mesh.rank * rows:(mesh.rank + 1) * rows], None


def gather_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Every rank's rows of ``x``, concatenated in rank order (``x`` itself without a mesh).
    The backward sums the incoming gradient over the ranks and returns this rank's rows."""
    return x if mesh is None else _GatherRows.apply(x, mesh)


@torch.no_grad()
def all_reduce_mean(tensors: list[torch.Tensor], mesh: Mesh) -> None:
    """Replace each tensor by its mean over the ranks, through one flat buffer (the tensors
    share one dtype and device)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(mesh.world_size)
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])


def barrier(mesh: Mesh | None) -> None:
    """Wait, on the host, for every rank to reach this call (an all-reduce on the mesh's
    device, read back, so NCCL needs no device hint); nothing without a mesh."""
    if mesh is not None:
        token = torch.zeros(1, device=mesh.device)
        dist.all_reduce(token)
        token.item()


def save_from_rank0(payload: dict, path: str, mesh: Mesh | None) -> str:
    """``torch.save`` of ``payload`` to ``path`` by rank 0 (by the one process without a
    mesh); every rank returns once the file is written."""
    if is_main(mesh):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(payload, path)
    barrier(mesh)
    return path
