"""The sweep-case batch and AP lane sharding (PyTorch port of the
bottom half of ``repro.parallel.sharding``).

A sweep batch is embarrassingly parallel over its leading (case) axis:
every case is an independent closed-loop replay.
:func:`shard_case_batch` runs a batched function on equal slices of the
batch, each slice on its own device, so every device runs the identical
per-case program — per-case results are bitwise what the unsharded batch
gives, which keeps the content-hashed sweep cache independent of the
device count.  The AP lane sharding (:func:`ap_mesh`) splits the packed
word-lane axis of the bitplanes instead
(``kernels.ap_megakernel.ops.run_group(mesh=)``).

Port notes: a "mesh" is a tuple of ``torch.device`` s, one a shard, and
the device type is the caller's: ``cuda:0`` .. ``cuda:n-1`` on a card,
the one CPU device for ``device="cpu"``.  :func:`local_devices` is the
one place that counts them.  The model half of the reference module
(``make_sharder``, ``param_specs``, ``cache_specs``) is not ported.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import leaves as _leaves
from repro_torch.tree import map_ as _map


def local_devices(device="cuda") -> tuple[torch.device, ...]:
    """The local devices of ``device`` 's type: every card for a CUDA
    device, the one CPU device for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device("cpu"),)


def _mesh(n_shards: int | None, device) -> tuple[torch.device, ...]:
    devices = local_devices(device)
    n = len(devices) if n_shards is None else n_shards
    if not 1 <= n <= len(devices):
        raise ValueError(
            f"n_shards={n} out of range for {len(devices)} local "
            f"device(s)")
    return tuple(devices[:n])


def sweep_mesh(n_shards: int | None = None, *,
               device="cuda") -> tuple[torch.device, ...]:
    """``n_shards`` local devices for the case batch.

    ``None`` uses every local device.  Raises if more shards are
    requested than devices exist (sharding is an execution detail; it
    must never silently change what runs).
    """
    return _mesh(n_shards, device)


def ap_mesh(n_shards: int | None = None, *,
            device="cuda") -> tuple[torch.device, ...]:
    """``n_shards`` local devices for the AP bitplane lanes (megakernel
    backend): plane columns and the TAG register split over the packed
    word-lane axis, responder counts summed over the shards.
    Validation matches :func:`sweep_mesh`: over-subscription raises."""
    return _mesh(n_shards, device)


def pad_case_batch(batch: Any, n_shards: int) -> tuple[Any, int]:
    """Pad every leaf's leading axis to a multiple of ``n_shards`` by
    repeating the last case (dropped again by :func:`unpad_case_batch`).
    ``batch`` is a tensor or nested tuples, lists and dicts of them.
    Returns ``(padded_batch, original_count)``."""
    counts = {leaf.shape[0] for leaf in _leaves(batch)}
    if len(counts) != 1:
        raise ValueError(f"inconsistent case counts {sorted(counts)}")
    (n,) = counts
    pad = (-n) % n_shards
    if pad == 0:
        return batch, n
    padded = _map(lambda x: torch.cat([x] + [x[-1:]] * pad, dim=0), batch)
    return padded, n


def unpad_case_batch(out: Any, n: int) -> Any:
    """Drop the padding rows added by :func:`pad_case_batch`."""
    return _map(lambda x: x[:n], out)


def shard_case_batch(fn: Callable, devices) -> Callable:
    """Run a batched function shard by shard over the case axis.

    ``fn`` takes ONE tree whose leaves all carry the case axis first and
    returns a tree of case-major tensors; the leading axis must already
    be a multiple of ``len(devices)`` (:func:`pad_case_batch`).  Shard s
    gets the s-th equal slice, moved to ``devices[s]``; every shard's
    work is issued before any output is gathered, and the outputs are
    concatenated on the device of the first input leaf.
    """
    devices = tuple(devices)

    def run(batch):
        n = {leaf.shape[0] for leaf in _leaves(batch)}
        if len(n) != 1 or next(iter(n)) % len(devices):
            raise ValueError(f"case counts {sorted(n)} are not one multiple "
                             f"of {len(devices)} shards")
        per = next(iter(n)) // len(devices)
        home = _leaves(batch)[0].device
        outs = [fn(_map(lambda x, s=s, d=d: x[s * per:(s + 1) * per].to(d),
                        batch))
                for s, d in enumerate(devices)]
        flat = [_leaves(o) for o in outs]
        gathered = iter([torch.cat([f[i].to(home) for f in flat], dim=0)
                         for i in range(len(flat[0]))])
        return _map(lambda _: next(gathered), outs[0])

    return run


__all__ = ["ap_mesh", "local_devices", "pad_case_batch", "shard_case_batch",
           "sweep_mesh", "unpad_case_batch"]
