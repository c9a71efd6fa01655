"""Device meshes (the port's ``launch/mesh.py``).

A mesh is a tuple of ``torch.device`` s, as ``parallel/sharding.py``
defines it.  Only the one-device mesh exists until the model half of
``parallel/`` is ported: the reference's production mesh (``pod`` x
``data`` x ``model``) and any local mesh past one device raise.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device="cuda") -> tuple[torch.device, ...]:
    """The one-device mesh ``(device,)`` for ``data = model = 1``."""
    if (data, model) != (1, 1):
        raise NotImplementedError(
            f"a {data} x {model} mesh waits for the model half of "
            "repro_torch.parallel; only make_local_mesh(1, 1) exists")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return (dev,)


__all__ = ["make_local_mesh"]
