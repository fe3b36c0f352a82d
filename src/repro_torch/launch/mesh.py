"""Meshes (port of ``repro.launch.mesh``): the local and process-group
meshes the sharded store and split-sequence decode run on, and the
shape-only production mesh the dry-run accounts on.

A mesh says how many slot partitions (``n_shards``) the store is split
into, which of them this process runs (``shards``), on which device, and
how the shards' partial outputs are summed (``psum``) — the counterpart of
``jax.lax.psum`` over the ``data`` axis of a ``shard_map``.

* :func:`make_local_mesh` — every shard a partition in this process, on
  one device; ``psum`` sums the partials of a field in one reduction.  One
  GPU runs a whole n-way store this way (NCCL refuses two ranks on one
  card), as JAX runs its n-way CPU mesh in one process.
* :func:`make_process_group_mesh` — one shard per rank of an initialized
  ``torch.distributed`` group; ``psum`` is one ``all_reduce(SUM)`` per
  field (gloo on CPU tensors, NCCL on one card per rank).

``psum`` takes one dataclass of tensors per local shard and returns their
field-wise sum; each field costs exactly one call of ``reduce``.

Every mesh has the reference's ``.shape``, a mapping of axis names to
sizes, which ``dist.ctx``, ``dist.sharding`` and ``dist.decode_attn`` read:
``{"data": n_shards, "model": 1}``, where a local mesh may also take a
``model`` axis of its own (the split of a decode cache's sequence, all of
its parts in this process).  :func:`make_production_mesh` returns an
``AbstractMesh``, the shape and axis names of the 256- or 512-chip
production mesh and nothing else: it touches no device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.types import as_device

__all__ = ["Mesh", "LocalMesh", "ProcessGroupMesh", "AbstractMesh",
           "make_local_mesh", "make_process_group_mesh",
           "make_production_mesh"]


class Mesh:
    """``n_shards`` slot partitions; this process runs ``shards``."""

    n_shards: int
    shards: tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_shards, "model": 1}

    def reduce(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The sum over every shard of one field (``parts``: this
        process's shards' partials, in ``shards`` order)."""
        raise NotImplementedError

    def psum(self, trees: list) -> Any:
        """Field-wise sum over every shard of one dataclass of tensors
        (``trees``: one per local shard) — one ``reduce`` per field."""
        cls = type(trees[0])
        return cls(*(self.reduce([getattr(t, f.name) for t in trees])
                     for f in dataclasses.fields(cls)))


@dataclasses.dataclass(frozen=True)
class LocalMesh(Mesh):
    """All shards as partitions in this process, on one device; ``model``
    parts of that axis too, all of them here."""
    n_shards: int
    device: torch.device
    model: int = 1

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.n_shards, "model": self.model}

    @property
    def shards(self) -> tuple[int, ...]:
        return tuple(range(self.n_shards))

    def reduce(self, parts: list[torch.Tensor]) -> torch.Tensor:
        return torch.stack(parts).sum(0, dtype=parts[0].dtype)


@dataclasses.dataclass(frozen=True)
class ProcessGroupMesh(Mesh):
    """One shard per rank of the default ``torch.distributed`` group."""
    n_shards: int
    rank: int
    device: torch.device

    @property
    def shards(self) -> tuple[int, ...]:
        return (self.rank,)

    def reduce(self, parts: list[torch.Tensor]) -> torch.Tensor:
        import torch.distributed as dist
        out = parts[0].clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes only, as ``jax.sharding.AbstractMesh``."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def make_local_mesh(data: int = 1, device: str | torch.device = "cuda", *,
                    model: int = 1) -> LocalMesh:
    """A ``data``-way store run as ``data`` partitions on ``device``; a
    ``model`` axis of that many parts, also all on ``device``."""
    if data < 1 or model < 1:
        raise ValueError(f"a mesh needs at least one part an axis, got data "
                         f"{data}, model {model}")
    return LocalMesh(n_shards=data, device=as_device(device), model=model)


def make_production_mesh(multi_pod: bool = False) -> AbstractMesh:
    """16 x 16 = 256 chips a pod, axes ``("data", "model")``; ``multi_pod``
    adds a leading ``pod`` axis of 2 (512 chips), which composes with
    ``data`` for every batch and FSDP axis.  Shape only."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_process_group_mesh(device: str | torch.device | None = None
                            ) -> ProcessGroupMesh:
    """A mesh of the initialized default process group: shard ``rank`` of
    ``world_size``.  ``device`` defaults to the CPU under gloo and to
    ``cuda:<rank>`` otherwise."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_process_group_mesh: call "
                           "torch.distributed.init_process_group first")
    rank, world = dist.get_rank(), dist.get_world_size()
    if device is None:
        device = "cpu" if dist.get_backend() == "gloo" else f"cuda:{rank}"
    return ProcessGroupMesh(n_shards=world, rank=rank,
                            device=as_device(device))
