"""Production and host meshes (functions, not module constants: importing
this module touches no device and starts no process group).

Both build a ``DeviceMesh`` over the default process group, which the
caller has started with the mesh's size as its world size; ``device_type``
is the card's unless the caller asks for the CPU.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed.meshutil import make_mesh, world_size


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16 x 16 over ``("data", "model")``, or 2 x 16 x 16 over
    ``("pod", "data", "model")``: a world of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(n: int | None = None, axes=("data", "model"),
                   device_type: str = "cuda") -> DeviceMesh:
    """``(n, 1)`` over two axes (``(n,)`` over one), ``n`` the world's size
    when None."""
    n = world_size() if n is None else n
    shape = (n, 1) if len(axes) == 2 else (n,)
    return make_mesh(shape, axes, device_type)
