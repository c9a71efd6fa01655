"""Parameter and cache partition specs, their placement on a
``DeviceMesh`` (the model half, top of file), and the sweep-case batch
and AP lane sharding (bottom of file): the PyTorch port of
``repro.parallel.sharding``.

The spec rules are the reference's Megatron-style 2D scheme:

  column-parallel in-projections  [d, out]   -> P(data, model)
  row-parallel out-projections    [out, d]   -> P(model, data)
  experts                         [E, d, f]  -> P(model, data, None)  (EP)
  embeddings                      [V, d]     -> P(model, data)
  norms / scalars                            -> replicated

with 'pod' extending the data axis multi-pod, and KV caches sharding
batch over 'data' and sequence over 'model'.  A spec (:class:`P`) is a
plain tuple with one entry per tensor dimension, so the port's spec
trees compare entry for entry with the reference's ``PartitionSpec`` s.
:func:`to_named` turns a spec into ``DTensor`` placements on a
``torch.distributed`` ``DeviceMesh``: a tensor dimension sharded over
several mesh axes gets ``Shard(d)`` on each of them (the first named the
major), and a mesh axis the spec does not name gets ``Replicate()``.
The specs decide storage.  The step builders (``launch/steps.py``)
split the batch over the data axes and gather each weight over them
(:func:`gather` with ``keep="model"``): a step keeps its ``model``
shard and computes tensor-parallel (``parallel/tensor_parallel.py``);
under ``fsdp`` it gathers the weights whole and runs the model
replicated over ``model``.

The port keeps a layer stack as a list of per-layer dicts where the
reference stacks it on a leading axis (``tree.py``): the reference's
stacked-layer prefix, a leading ``None``, is that list, so a per-layer
leaf's spec is the reference's without it.  A tree with stacked leaves
(a layer-stack key and no list index on the path) gets the prefix as in
the reference.

Bottom half: a sweep batch is embarrassingly parallel over its leading
(case) axis: every case is an independent closed-loop replay.
:func:`shard_case_batch` runs a batched function on equal slices of the
batch, each slice on its own device, so every device runs the identical
per-case program — per-case results are bitwise what the unsharded batch
gives, which keeps the content-hashed sweep cache independent of the
device count.  The AP lane sharding (:func:`ap_mesh`) splits the packed
word-lane axis of the bitplanes instead
(``kernels.ap_megakernel.ops.run_group(mesh=)``).  There a "mesh" is a
tuple of ``torch.device`` s, one a shard, and the device type is the
caller's: ``cuda:0`` .. ``cuda:n-1`` on a card, the one CPU device for
``device="cpu"``.  :func:`local_devices` is the one place that counts
them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.tree import leaves as _leaves
from repro_torch.tree import map_ as _map

STACK_KEYS = ("layers", "enc_layers", "dense_layers")


class P(tuple):
    """A partition spec: one entry per tensor dimension, each ``None``
    (not sharded), a mesh axis name, or a tuple of names (sharded over
    their product, the first the major): ``P("data", None)``,
    ``P(("pod", "data"), "model")``.  A tuple, equal to the tuple of the
    reference's ``PartitionSpec`` entries."""
    __slots__ = ()

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self))})"


def map_specs(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(keys, leaf, *rest_leaves)`` over a tree of dicts and lists
    whose leaves are tensors or specs (:class:`P` is a leaf, not a
    tuple), ``keys`` the path's dict keys and list indices as strings."""
    def go(t, keys, rs):
        if isinstance(t, dict):
            return {k: go(v, keys + (str(k),), [r[k] for r in rs])
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)) and not isinstance(t, P):
            return type(t)(go(v, keys + (str(i),), [r[i] for r in rs])
                           for i, v in enumerate(t))
        return fn(keys, t, *rs)
    return go(tree, (), list(rest))


def spec_paths(tree: Any) -> dict:
    """``{"a/b/0/c": leaf}`` of a tree whose leaves may be specs."""
    out = {}
    map_specs(lambda keys, leaf: out.__setitem__("/".join(keys), leaf), tree)
    return out


def make_sharder(mesh, multi_pod: bool = False):
    from repro_torch.models.layers import Sharder
    data_axes = ("pod", "data") if multi_pod else "data"
    return Sharder(mesh=mesh, data_axes=data_axes, model_axes="model")


def _rule(path_keys, ndim: int, data) -> P:
    """PartitionSpec for one param, BEFORE the stacked-layer prefix."""
    name = path_keys[-1]
    in_experts = "experts" in path_keys

    if in_experts:                       # [E, d, f] / [E, f, d]
        if name in ("w_gate", "w_up"):
            return P("model", data, None)
        if name == "w_down":
            return P("model", None, data)
    col = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj_x", "in_proj_z",
           "wq_b", "wkv_b", "dt_proj"}
    row = {"wo", "w_down", "out_proj"}
    if name == "embed":
        return P("model", data)
    if name == "lm_head":
        return P(data, "model")
    if name in col:
        return P(data, "model") if ndim == 2 else P("model")
    if name in row:
        return P("model", data)
    if name in ("bq", "bk", "bv", "b_up", "conv_b", "norm_w"):
        return P("model")
    if name == "conv_w":                 # [K, din]
        return P(None, "model")
    if name in ("x_proj", "A_log"):      # [din, *]
        return P("model", None)
    if name == "D" and ndim == 1:
        return P("model")
    if name == "dt_bias":
        return P("model")
    if name in ("router", "wq_a", "wkv_a", "in_proj_bc", "in_proj_dt"):
        return P(data, None)
    # norms, small vectors, scalars -> replicated
    return P(*([None] * ndim))


def param_specs(cfg: ArchConfig, params_shape: Any, multi_pod: bool = False
                ) -> Any:
    """A spec tree matching a params tree (tensors, ``"meta"`` ones
    included).  A leaf of one layer of a stack (a list index on its
    path) has its own rank; a stacked leaf carries the layer axis first
    and gets the reference's leading ``None``."""
    data = ("pod", "data") if multi_pod else "data"

    def one(keys, leaf):
        stacked = any(k in STACK_KEYS for k in keys)
        per_layer = stacked and any(k.isdigit() for k in keys)
        ndim = len(leaf.shape)
        base_ndim = ndim - 1 if stacked and not per_layer else ndim
        spec = _rule(keys, base_ndim, data)
        # mamba2 dt_bias/A_log/D are [H] per-head (small): replicate
        if keys[-1] in ("dt_bias", "A_log", "D") and cfg.ssm is not None \
                and cfg.ssm.version == 2:
            spec = P(*([None] * base_ndim))
        if stacked and not per_layer:
            spec = P(None, *spec)
        return spec

    return map_specs(one, params_shape)


def cache_specs(cfg: ArchConfig, cache_shape: Any, multi_pod: bool = False
                ) -> Any:
    """Specs for serve caches (stacked layer axis leading)."""
    data = ("pod", "data") if multi_pod else "data"

    def one(keys, leaf):
        name = keys[-1]
        ndim = len(leaf.shape)
        if name in ("k", "v", "k_q", "v_q"):   # [L, B, W, hkv, dh]
            return P(None, data, "model", None, None)
        if name in ("k_s", "v_s"):       # [L, B, W, hkv] quant scales
            return P(None, data, "model", None)
        if name in ("cross_k", "cross_v"):  # [L, B, F, hkv, dh]
            return P(None, data, None, "model", None)
        if name in ("c_kv", "k_rope"):   # [L, B, S, lora]
            return P(None, data, "model", None)
        if name == "conv":               # [L, B, K-1, din]
            return P(None, data, None, "model")
        if name == "h":                  # [L, B, din, N]
            return P(None, data, "model", None)
        return P(*([None] * ndim))       # slot_pos, len, step

    return map_specs(one, cache_shape)


# ---------------------------------------------------------------------------
# specs on a DeviceMesh
# ---------------------------------------------------------------------------

def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``torch.distributed`` ``DeviceMesh`` (and
    not the port's one-device mesh, a tuple of one ``torch.device``)."""
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def _axis_names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: P) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(d)``
    on every mesh dimension that tensor dimension d names, in the order
    the spec names them (the mesh's, major first), and ``Replicate()``
    on the rest."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    out: list = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        axes = _axis_names(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec!r} names mesh axes {missing} that "
                             f"the mesh {names} lacks")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r} names axes {axes} out of the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec!r} names axis {names[i]!r} "
                                 "twice")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def to_named(mesh, spec_tree: Any) -> Any:
    """A :class:`NamedSharding` for every spec of ``spec_tree``."""
    return map_specs(lambda _, s: NamedSharding(mesh, s), spec_tree)


def axis_index(mesh, axes) -> tuple[int, int]:
    """(this rank's index, the count) over the mesh axes ``axes`` (a
    name, a tuple of names, the first the major, or ``None``)."""
    index, count = 0, 1
    coord = mesh.get_coordinate()
    names = tuple(mesh.mesh_dim_names)
    for a in _axis_names(axes):
        i = names.index(a)
        index = index * mesh.size(i) + coord[i]
        count *= mesh.size(i)
    return index, count


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def place(tree: Any, shardings: Any) -> Any:
    """Every leaf of ``tree`` as a ``DTensor`` with the placements of its
    :class:`NamedSharding` in ``shardings``: a tensor (the same full
    value on every rank) is distributed, a ``DTensor`` redistributed
    where its placements differ."""
    from torch.distributed.tensor import distribute_tensor

    def one(_, x, ns):
        want = ns.placements
        if _is_dtensor(x):
            return x if tuple(x.placements) == want else \
                x.redistribute(ns.mesh, want)
        dev = mesh_device(ns.mesh)
        return distribute_tensor(torch.as_tensor(x).to(dev), ns.mesh, want)
    return map_specs(one, tree, shardings)


def gather(tree: Any, keep: str | None = None, layout: Any = None) -> Any:
    """Every ``DTensor`` leaf of ``tree`` as this rank's tensor, other
    leaves as they are.  With no ``keep``: the full tensor.  With the
    mesh axis ``keep`` (``"model"``): gathered over every other mesh axis
    and left sharded over ``keep``, the rank's shard of ``keep``; a leaf
    that ``layout`` (a tree of ``tensor_parallel.layout`` 's kinds)
    names ``"whole"`` is gathered over ``keep`` too, the rule for a
    shard that does not line up with the ranks' heads."""
    from torch.distributed.tensor import Replicate

    def one(_, x, kind=None):
        if not _is_dtensor(x):
            return x
        if keep is None or kind == "whole":
            return x.full_tensor()
        mesh = x.device_mesh
        i = mesh.mesh_dim_names.index(keep)
        want = [Replicate()] * mesh.ndim
        want[i] = x.placements[i]
        return x.redistribute(mesh, want).to_local()
    if layout is None:
        return map_specs(one, tree)
    return map_specs(one, tree, layout)


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh`` (the current card on CUDA)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


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


__all__ = ["NamedSharding", "P", "STACK_KEYS", "ap_mesh", "axis_index",
           "cache_specs", "gather", "is_device_mesh", "local_devices",
           "make_sharder", "map_specs", "mesh_device", "pad_case_batch",
           "param_specs", "place", "placements", "shard_case_batch",
           "spec_paths", "sweep_mesh", "to_named", "unpad_case_batch"]
