"""Logical-axis sharding rules (port of ``repro.dist.sharding``).

One table maps every logical axis name the models use to an ordered list
of candidate mesh-axis tuples.  ``spec_for`` walks a shape's logical axes
left to right and assigns the first candidate whose mesh axes are all
present, unused so far, and whose product divides the dimension (and is
above 1); otherwise the dimension is replicated.  That gives FSDP
("embed" over ``data``), tensor parallelism ("heads", "mlp", "experts",
"vocab" over ``model``) and data parallelism (batch axes over ``("pod",
"data")``) on any mesh shape.

A spec is a ``P``: one entry per dimension, each None (replicated), a mesh
axis name or a tuple of names, as the reference's ``PartitionSpec`` holds
them.  Where the reference's ``NamedSharding`` carries the spec and the
mesh, the port's ``Sharding`` carries the spec, the global shape and each
device's local shape (the dimension divided by the product of its mesh
axes' sizes, ``NamedSharding.shard_shape``).  ``to_placements`` turns a
spec into ``torch.distributed.tensor`` placements on a ``DeviceMesh`` with
the same axis names.  A mesh is anything with a ``.shape`` mapping of axis
names to sizes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = ["P", "Sharding", "LOGICAL_RULES", "spec_for", "param_shardings",
           "batch_shardings", "decode_state_shardings", "to_placements"]

# logical axis -> ordered candidate mesh-axis tuples (first fit wins)
_DP = (("pod", "data"), ("data",))
LOGICAL_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    # data-parallel axes (batch / token / per-row dispatch)
    "batch": _DP, "act_batch": _DP, "act_tokens": _DP, "act_rows": _DP,
    # FSDP: the embedding dim of weights shards over the data axis
    "embed": (("data",),),
    # tensor-parallel axes
    "heads": (("model",),), "kv": (("model",),), "mlp": (("model",),),
    "experts": (("model",),), "vocab": (("model",),),
    "act_heads": (("model",),), "act_kv": (("model",),),
    "act_mlp": (("model",),), "act_vocab": (("model",),),
    "act_experts": (("model",),),
    # decode KV-cache sequence axis (dist.decode_attn splits it)
    "act_cache_seq": (("model",),),
    # sharded CIDER dataplane: store slots / heap partition over data
    "slots": (("data",),), "heap": (("data",),),
    # replicated-only axes get no entry: layers, head_dim, conv, front, ...
}


class P(tuple):
    """A partition spec: one entry per dimension, None, a mesh axis name or
    a tuple of names."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's spec, its global shape and each device's local shape."""
    spec: P
    shape: tuple[int, ...]
    local_shape: tuple[int, ...]


def _mesh_shape(mesh: Any) -> dict[str, int]:
    return dict(mesh.shape)


def spec_for(shape, logical_axes, mesh: Any) -> P:
    """Map a shape's logical axes to a spec on ``mesh``: each mesh axis is
    assigned at most once; a dimension that cannot be sharded (unknown
    name, missing mesh axis, or not divisible by the mesh axes' product)
    is replicated."""
    sizes = _mesh_shape(mesh)
    logical_axes = tuple(logical_axes or ())
    if len(logical_axes) < len(shape):
        logical_axes = logical_axes + (None,) * (len(shape) - len(logical_axes))
    used: set[str] = set()
    out: list = []
    for dim, name in zip(shape, logical_axes):
        assigned = None
        for cand in LOGICAL_RULES.get(name, ()):
            if any(a not in sizes or a in used for a in cand):
                continue
            prod = math.prod(sizes[a] for a in cand)
            if prod > 1 and dim % prod == 0:
                assigned = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
        out.append(assigned)
    return P(*out)


def _local_shape(shape, spec: P, mesh: Any) -> tuple[int, ...]:
    """Each device's block of a ``shape`` array laid out by ``spec``."""
    sizes = _mesh_shape(mesh)
    out = []
    for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        names = () if part is None else (part,) if isinstance(part, str) \
            else part
        n = math.prod(sizes[a] for a in names)
        if dim % n:
            raise ValueError(f"dimension {dim} does not split {n} ways "
                             f"({spec} on {sizes})")
        out.append(dim // n)
    return tuple(out)


def _sharding(shape, axes, mesh) -> Sharding:
    shape = tuple(int(x) for x in shape)
    spec = spec_for(shape, axes, mesh)
    return Sharding(spec, shape, _local_shape(shape, spec, mesh))


def _tree_map(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over a nested dict, keeping its
    structure; ``path`` is the tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def param_shardings(params: Any, axes: Any, mesh) -> Any:
    """``Sharding`` of every parameter: ``params`` a tree of tensors (meta
    tensors from ``Model.init_abstract()`` will do), ``axes`` the tree of
    their logical axes (``Model.param_axes()``)."""
    return _tree_map(lambda _, p, a: _sharding(p.shape, a, mesh), params,
                     axes)


def batch_shardings(bspec: Any, mesh) -> Any:
    """Input-batch shardings: the leading axis is the global batch, the
    rest local."""
    return _tree_map(lambda _, x: _sharding(
        x.shape, ("batch",) + (None,) * (len(x.shape) - 1), mesh), bspec)


def decode_state_shardings(state_spec: Any, mesh) -> Any:
    """Decode-state shardings: axis 0 is the stacked layers axis, axis 1 the
    batch; the KV caches (``k``, ``v``) also shard their heads axis (-2)
    over ``model``."""
    def one(path, leaf):
        nd = len(leaf.shape)
        axes: list = [None] * nd
        if nd >= 2:
            axes[1] = "batch"
        if path and path[-1] in ("k", "v") and nd >= 4:
            axes[-2] = "kv"
        return _sharding(leaf.shape, tuple(axes), mesh)
    return _tree_map(one, state_spec)


def to_placements(spec: P, device_mesh) -> list:
    """``torch.distributed.tensor`` placements of ``spec`` on
    ``device_mesh`` (anything with ``mesh_dim_names``, as a ``DeviceMesh``
    has): mesh dimension i is ``Shard(d)`` when the spec shards tensor
    dimension d over it, else ``Replicate()``.  Mesh axes that shard one
    dimension together split it in the mesh's axis order, major first, as
    the spec's tuple does."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    owner: dict[str, int] = {}
    for d, part in enumerate(spec):
        for a in (() if part is None else (part,) if isinstance(part, str)
                  else part):
            if a not in names:
                raise ValueError(f"{spec}: mesh axis {a!r} not in {names}")
            owner[a] = d
    for d, part in enumerate(spec):
        if isinstance(part, tuple):
            order = [names.index(a) for a in part]
            if order != sorted(order):
                raise ValueError(f"{spec}: axes {part} of dimension {d} are "
                                 f"not in the mesh's order {names}")
    return [Shard(owner[a]) if a in owner else Replicate() for a in names]
