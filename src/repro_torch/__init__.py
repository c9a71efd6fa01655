"""PyTorch/CUDA port of the 3D associative-processor thermal reproduction.

The package mirrors the reference package ``repro`` module for module
(``core/``, ``stack/``, ``policy/``, ``workloads/``, ``kernels/``) and
keeps its own copy of everything it needs: it imports ``torch`` and
NumPy, never ``jax`` and never ``repro``.

Every entry point takes the reference's parameters in the reference's
positions, and an explicit keyword-only ``device`` that defaults to
``"cuda"``.  Without a card such a call raises; only an explicit
``device="cpu"`` runs on the host, where each hand-written kernel's
wrapper takes its plain PyTorch version instead.  The reference's kernel
switches are accepted and change nothing, since the tensor's device picks
each kernel: ``use_pallas`` is ignored, every ``backend`` name of
``APEngine.BACKENDS`` runs bit-identical passes, and the kernel wrappers
ignore the Pallas options ``block_y``, ``block_lanes``, ``interpret`` and
``backend``.  ``n_shards`` (and the megakernel's ``mesh``) spread a case
batch or the AP lanes over local devices of the call's device type
(``repro_torch.parallel``), with the same bits as one device.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Raises ``RuntimeError`` when a CUDA device is asked for and none is
    present: the port never falls back to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; expected cuda "
                         "or cpu")
    return dev
