"""Device meshes (the port's ``launch/mesh.py``).

Functions, not module constants, so importing this module touches no
process group.  A mesh past one device is a ``torch.distributed``
``DeviceMesh`` over the ranks of the default process group, one device
a rank, with the reference's axis names: ``("data", "model")``, and
``("pod", "data", "model")`` multi-pod ('pod' extends the data axis).
The group comes from the caller (``torch.distributed.
init_process_group`` with its address, world size and rank).

The reference's target is 256 TPU v5e chips a pod as a 16 x 16 data x
model torus, 2 pods multi-pod.  The port places storage on such a mesh
by the reference's specs, splits the batch over the data axes and, for
the dense and encdec families, the heads, ``d_ff`` and vocabulary over
``model`` (``launch/steps.py``).  Without a process group the local 1 x 1
mesh is the one-device mesh ``(device,)``, the tuple
``parallel/sharding.py`` uses for the case batch.
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device


def _group_size(what: str, shape: tuple) -> int:
    import torch.distributed as dist
    n = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"{what} needs a process group of {n} ranks and none is "
            "initialised (torch.distributed.init_process_group with its "
            "address, world size and rank)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"{what} needs a process group of exactly {n} "
                         f"ranks; the default group has {world}")
    return n


def _group_device_type() -> str:
    """The device type of the default group's backend: ``cuda`` under
    NCCL, else ``cpu`` (gloo, the fake group of a dry run)."""
    import torch.distributed as dist
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh, (16, 16) over ``("data",
    "model")`` or (2, 16, 16) over ``("pod", "data", "model")``, on the
    default process group (256 or 512 ranks) and its device type."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _group_size("the production mesh", shape)
    return init_device_mesh(_group_device_type(), shape,
                            mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """A ``data`` x ``model`` mesh of ``device`` 's type.

    Past 1 x 1: a ``DeviceMesh`` over a default process group of exactly
    ``data * model`` ranks; ``ValueError`` without one.  At 1 x 1: the
    one-device mesh ``(device,)`` unless a process group is initialised,
    and then a 1 x 1 ``DeviceMesh`` (the group must have one rank).
    Every step builder takes either.
    """
    import torch.distributed as dist
    dev = resolve_device(device)
    grouped = dist.is_available() and dist.is_initialized()
    if (data, model) == (1, 1) and not grouped:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return (dev,)
    from torch.distributed.device_mesh import init_device_mesh
    _group_size(f"a {data} x {model} mesh", (data, model))
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


__all__ = ["make_local_mesh", "make_production_mesh"]
