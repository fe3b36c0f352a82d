"""Mesh context and activation sharding annotations (port of
``repro.dist.ctx``).

``use_mesh`` installs a mesh for the duration of a ``with`` block and
``current_mesh`` returns the innermost one; a mesh is anything with a
``.shape`` mapping of axis names to sizes (``repro_torch.launch.mesh``'s
``LocalMesh``, ``ProcessGroupMesh`` and ``AbstractMesh``).  The models read
it where the reference does: the MoE layer groups its dispatch per data
shard (``rows = pod x data``) under a mesh.

``shard(x, logical_axes)`` is the reference's annotation point.  There it
lowers to ``with_sharding_constraint``, which leaves the values unchanged
and tells XLA's partitioner the layout; the port runs each process's
tensors whole and has no partitioner to tell, so ``shard`` returns ``x``
itself, under a mesh or not.  ``repro_torch.dist.sharding.spec_for`` gives
the layout the reference would ask for.
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
    """``x`` unchanged: the values ``with_sharding_constraint`` keeps."""
    del logical_axes
    return x
