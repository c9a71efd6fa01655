"""Atomic, asynchronous checkpointing with keep-last-k (the port of the
reference's ``checkpoint/manager.py``).

Layout:  <dir>/step_000123/
            manifest.json     — step, leaf paths, shapes, dtypes
            host00.npz        — every leaf of this host (flattened)

Write protocol: stage into ``step_XXX.tmp`` then ``os.rename`` (atomic on
POSIX) — a crash mid-save never corrupts the newest complete checkpoint;
``latest_step`` only trusts directories with a manifest.  Saves can run on
a background thread with an explicit ``wait()`` barrier.  The port's train
step updates its tensors in place, so :meth:`CheckpointManager.save`
copies the tree to host memory before it returns, and only the file write
runs in the background (the reference does the same for its donated
buffers).

Leaf keys are the ``/``-joined dict keys and list indices of the port's
tree (``layers/3/attn/wq``).  A bfloat16 leaf is stored widened to
float32 (NumPy has no bfloat16), which restores exactly.

Sharded trees: a tree holding ``DTensor`` s is saved whole.  Every rank
gathers each such leaf (``full_tensor()``, a collective), rank 0 writes
``host00.npz`` in the format above, and the ranks meet at a barrier
before ``save`` returns (:class:`CheckpointManager` writes on rank 0
alone, in the background).  The elastic re-mesh restore places each
leaf on a TARGET ``DeviceMesh`` by its spec (``restore(mesh=, specs=)``),
so a checkpoint saved on one mesh restores onto any other, or onto one
device; a file the reference wrote restores the same way.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device, tree


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _host(leaf) -> tuple[np.ndarray, str]:
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    t = torch.as_tensor(leaf).detach()
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy(), dtype


def _flatten(state: Any) -> dict[str, tuple[np.ndarray, str]]:
    return {key: _host(leaf) for key, leaf in tree.paths(state)}


def _sharded(state: Any) -> bool:
    return state is not None and any(_is_dtensor(x)
                                     for x in tree.leaves(state))


def _not_writer() -> bool:
    """True on a rank other than 0 of an initialised process group."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() \
        and dist.get_rank() != 0


def save(ckpt_dir: str | pathlib.Path, step: int, state: Any,
         extra: Optional[dict] = None, host_index: int = 0,
         flat: Optional[dict] = None) -> pathlib.Path:
    """Write ``state`` (or its ``flat`` host copy) as ``step_XXXXXXXX``.
    A ``state`` holding ``DTensor`` s is called on every rank of its
    mesh: each gathers, rank 0 writes, and all return after the write."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    if _sharded(state):
        import torch.distributed as dist
        flat = _flatten(state)
        if not _not_writer():
            save(ckpt_dir, step, None, extra, host_index, flat)
        dist.barrier()
        return final
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    if flat is None:
        flat = _flatten(state)
    np.savez(tmp / f"host{host_index:02d}.npz",
             **{k: arr for k, (arr, _) in flat.items()})
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(arr.shape), "dtype": dtype}
                   for k, (arr, dtype) in flat.items()},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _complete_steps(ckpt_dir: pathlib.Path) -> list[int]:
    return sorted(int(d.name[5:]) for d in ckpt_dir.iterdir()
                  if d.name.startswith("step_") and not d.name.endswith(".tmp")
                  and (d / "manifest.json").exists())


def latest_step(ckpt_dir: str | pathlib.Path) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str | pathlib.Path, step: int, target: Any,
            mesh=None, specs: Any = None, host_index: int = 0, *,
            device=None) -> Any:
    """Restore into the structure of ``target`` (a tree of tensors; on
    ``"meta"`` for shapes and dtypes alone): new tensors of each target
    leaf's shape and dtype, on ``device``, or by default on the target
    leaf's device (the card for a ``"meta"`` leaf).  Raises
    ``ValueError`` where a stored shape differs from the target's.

    With ``mesh`` a ``DeviceMesh`` and ``specs`` a spec tree of
    ``target`` 's structure (``parallel.sharding.P`` leaves), this is the
    elastic re-mesh path: every rank of the mesh reads the file and each
    leaf becomes a ``DTensor`` placed by its spec on that mesh, whatever
    mesh the checkpoint was saved from.  ``mesh`` may also be the
    one-device mesh ``(device,)``, which restores onto that device.
    """
    from repro_torch.parallel.sharding import (is_device_mesh, mesh_device,
                                               placements, spec_paths)
    if mesh is not None and not is_device_mesh(mesh):
        one = isinstance(mesh, tuple) and len(mesh) == 1 \
            and isinstance(mesh[0], torch.device)
        if not one:
            raise TypeError(
                "mesh must be a torch.distributed DeviceMesh or the "
                "one-device mesh (device,) of launch.mesh.make_local_mesh; "
                f"got {type(mesh).__name__}")
        device, mesh = mesh[0], None
    if mesh is not None and specs is None:
        raise TypeError("restore onto a DeviceMesh needs specs=, a spec "
                        "tree of the target's structure")
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    data = np.load(d / f"host{host_index:02d}.npz")
    dev = None if device is None else resolve_device(device)
    leaves = dict(tree.paths(target))
    if mesh is not None:
        from torch.distributed.tensor import distribute_tensor
        flat = spec_paths(specs)
        on_mesh = mesh_device(mesh)

    def rebuild(key):
        leaf = leaves[key]
        arr = data[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: ckpt {arr.shape} != target "
                             f"{tuple(leaf.shape)}")
        if mesh is not None:
            t = torch.from_numpy(arr).to(device=on_mesh, dtype=leaf.dtype)
            return distribute_tensor(t, mesh, placements(mesh, flat[key]))
        to = dev or (leaf.device if leaf.device.type != "meta"
                     else resolve_device("cuda"))
        return torch.from_numpy(arr).to(device=to, dtype=leaf.dtype)

    keys = iter(leaves)
    return tree.map_(lambda _: rebuild(next(keys)), target)


class CheckpointManager:
    """Keep-last-k manager with optional async saves."""

    def __init__(self, ckpt_dir: str | pathlib.Path, keep: int = 3,
                 async_save: bool = True):
        self.dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        self.wait()
        # copy to host memory now: the next train step updates these
        # tensors in place, so the background thread must never read them
        flat = _flatten(state)
        if _sharded(state) and _not_writer():
            return              # gathered here; rank 0 writes
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(step, flat, extra),
                daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, flat, extra)

    def _save_and_gc(self, step, flat, extra):
        save(self.dir, step, None, extra, flat=flat)
        for s in _complete_steps(self.dir)[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest_step(self) -> Optional[int]:
        self.wait()
        return latest_step(self.dir)

    def restore(self, step: int, target: Any, mesh=None, specs=None, *,
                device=None) -> Any:
        return restore(self.dir, step, target, mesh, specs, device=device)
