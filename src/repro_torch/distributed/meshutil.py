"""Device meshes with named axes, and the mesh facts the sharding rules read.

The rules only read axis sizes by name, so they take either a
``torch.distributed`` ``DeviceMesh`` (``mesh_dim_names`` and a tuple
``shape``) or a shape-only stand-in whose ``shape`` is a dict of axis sizes:
a 512-rank mesh can be reasoned about without a process group.

``set_mesh(mesh)`` makes a mesh ambient for the code it wraps and
``get_mesh()`` reads it (``None``: no mesh), the reference's
``compat.set_mesh``/``get_mesh``; ``constraints.constrain`` resolves its
tags against it.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (or ``None``: no mesh) the ambient mesh inside the
    ``with`` block."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def get_mesh():
    """The ambient mesh set by :func:`set_mesh`, or ``None``."""
    return _AMBIENT.get()


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the whole world, its dims named
    ``axes``. Starts no process group: the caller has started the default
    one, and its world size must be the mesh's size."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ in length")
    world = world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def world_size() -> int:
    """The default process group's size; raises when none was started."""
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group before making a mesh")
    return dist.get_world_size()


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in the mesh's axis order."""
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("the sharding rules need a mesh with named dims")
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes: every mesh axis that is not the model axis."""
    return tuple(a for a in axis_sizes(mesh) if a != "model")
