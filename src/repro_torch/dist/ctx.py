"""Mesh context and activation sharding annotations (port of
``repro.dist.ctx``).

``use_mesh`` installs a mesh for the duration of a ``with`` block and
``current_mesh`` returns the innermost one; a mesh is anything with a
``.shape`` mapping of axis names to sizes (``repro_torch.launch.mesh``'s
``LocalMesh``, ``ProcessGroupMesh``, ``AbstractMesh`` and
``PlacedMesh``).  The models read it where the reference does: the MoE
layer groups its dispatch per data shard (``rows = pod x data``) under a
mesh.

``shard(x, logical_axes)`` is the reference's annotation point, which
lowers to ``with_sharding_constraint``: the values stay as they are and the
partitioner is told the layout ``dist.sharding.spec_for`` gives.  The
port's counterpart of the partitioner is ``torch.distributed.tensor``: when
``x`` is a ``DTensor`` and the ambient mesh carries a ``DeviceMesh`` (a
``PlacedMesh``), ``shard`` redistributes ``x`` to that layout, and
DTensor's backward of the redistribution moves the cotangent back to
``x``'s own layout.  On a plain tensor, or under a mesh with no
``DeviceMesh``, it returns ``x`` itself.
"""
from __future__ import annotations

import contextlib

__all__ = ["use_mesh", "current_mesh", "shard"]

_MESH_STACK: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as the ambient mesh inside the block."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def current_mesh():
    """The innermost installed mesh, or None outside any ``use_mesh``."""
    return _MESH_STACK[-1] if _MESH_STACK else None


def shard(x, logical_axes):
    """``x`` laid out as ``logical_axes`` say on the ambient mesh's
    ``DeviceMesh`` when ``x`` is a ``DTensor``; else ``x`` itself."""
    device_mesh = getattr(current_mesh(), "device_mesh", None)
    if device_mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.dist.sharding import spec_for, to_placements
    spec = spec_for(x.shape, logical_axes, current_mesh())
    return x.redistribute(device_mesh, to_placements(spec, device_mesh))
