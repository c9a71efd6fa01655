"""Step builders (the port's ``launch/steps.py``): train, prefill and
decode steps with explicit placements, and the shape-only parameter tree
``params_sds``.

Each builder returns ``(fn, example_args)``, the example arguments on the
``"meta"`` device: shapes and dtypes, no storage (the reference's
``ShapeDtypeStruct`` s; ``init_params`` builds the same tree on
``"meta"``, so the largest configs cost nothing to count).

``mesh`` is either the one-device mesh ``(device,)`` (``launch.mesh.
make_local_mesh(1, 1)`` without a process group), on which each step is
the model's own function on that device, or a ``DeviceMesh``.  On a
``DeviceMesh`` PyTorch has no partitioner to derive a program from
shardings, so the step makes three things explicit:

- storage: parameters, optimizer moments and caches are ``DTensor`` s
  placed by the reference's spec trees (``parallel.sharding``);
- compute: each rank gathers the weights with ``full_tensor()`` and runs
  the whole model on the batch rows of its coordinate on the batch's
  data axes, replicated over the other mesh axes (``model``); there is
  no tensor-parallel split of activations;
- results: logits and caches are placed back by the reference's output
  specs; gradients reach their shards by ``Partial`` -> ``Shard``
  (a reduce-scatter), averaged over the data ranks.

A MoE config routes within each rank's rows, so its ``moe_groups`` must
be a multiple of the number of data ranks: each rank takes its share of
the groups, and every group holds the tokens (and capacity) it holds on
one device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.profiler

from repro_torch import resolve_device, tree
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import model as M
from repro_torch.models import serve as SV
from repro_torch.models.layers import NOSHARD, Sharder, f32_matmul
from repro_torch.models.model import PerfConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import global_norm
from repro_torch.parallel.sharding import (NamedSharding, P, axis_index,
                                           cache_specs, gather,
                                           is_device_mesh, map_specs,
                                           mesh_device,
                                           param_specs, place, to_named)


def _axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


def make_sharder(mesh, multi_pod: bool, tiny_batch: bool = False,
                 parallelism: str = "2d") -> Sharder:
    data = _axes(multi_pod)
    if tiny_batch:
        # B < data width: shard sequence/state over the whole mesh instead
        seq = (("pod", "data", "model") if multi_pod else ("data", "model"))
        return Sharder(mesh=mesh, data_axes=None, model_axes="model",
                       seq_axes=seq)
    if parallelism == "fsdp":
        # pure ZeRO-3: batch over the whole mesh, activations unsharded on
        # features (weights stay sharded over both axes via param_specs)
        whole = (("pod", "data", "model") if multi_pod
                 else ("data", "model"))
        return Sharder(mesh=mesh, data_axes=whole, model_axes=None)
    return Sharder(mesh=mesh, data_axes=data, model_axes="model")


def params_sds(cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    """The port's parameter tree of ``cfg`` with every leaf on
    ``"meta"``: shapes and dtypes, no storage."""
    return M.init_params(cfg, torch.Generator(), dtype, device="meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_extras_sds(cfg: ArchConfig, lead: tuple, dtype, data
                      ) -> tuple[dict, dict]:
    """The batch's inputs besides tokens: (tensors on ``"meta"``, specs),
    the batch dimension the last of ``lead``, sharded over ``data``."""
    sds, specs = {}, {}
    if cfg.family == "encdec":
        sds["audio_embeds"] = _meta(lead + (cfg.enc_seq, cfg.d_model),
                                    dtype)
        specs["audio_embeds"] = P(*([None] * (len(lead) - 1)), data,
                                  None, None)
    if cfg.n_prefix_embeds:
        sds["prefix_embeds"] = _meta(
            lead + (cfg.n_prefix_embeds, cfg.d_model), dtype)
        specs["prefix_embeds"] = P(*([None] * (len(lead) - 1)), data,
                                   None, None)
    return sds, specs


def _retarget_cache_specs(cspecs, shd: Sharder):
    """Rewrite cache specs onto the sharder's (data_axes, seq_axes)."""
    def one(keys, spec):
        name = keys[-1]
        if name in ("k", "v", "k_q", "v_q"):
            return P(None, shd.data_axes, shd.seq_axes, None, None)
        if name in ("k_s", "v_s"):
            return P(None, shd.data_axes, shd.seq_axes, None)
        if name in ("cross_k", "cross_v"):
            return P(None, shd.data_axes, None, None, None)
        if name in ("c_kv", "k_rope"):
            return P(None, shd.data_axes, shd.seq_axes, None)
        if name == "conv":
            return P(None, shd.data_axes, None, shd.seq_axes)
        if name == "h":
            return P(None, shd.data_axes, shd.seq_axes, None)
        return spec

    return map_specs(one, cspecs)


# ---------------------------------------------------------------------------
# helpers of the DeviceMesh steps
# ---------------------------------------------------------------------------

def _to(x, dev: torch.device) -> torch.Tensor:
    """A NumPy array or tensor as a tensor on ``dev``."""
    return torch.as_tensor(np.asarray(x) if not isinstance(
        x, torch.Tensor) else x).to(dev)


def _one_device(mesh, multi_pod: bool) -> None:
    if multi_pod or len(tuple(mesh)) != 1:
        raise ValueError(
            "a mesh of several devices is a DeviceMesh over a process "
            "group (launch.mesh.make_local_mesh, make_production_mesh); "
            f"got {mesh!r} with multi_pod={multi_pod}")


def _mesh_device(mesh, dev: torch.device) -> torch.device:
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r} devices and "
                         f"the step on {dev.type!r}")
    return mesh_device(mesh)


def _batch_dim(spec: P, data_axes):
    """The dimension of ``spec`` that ``data_axes`` shards, or None."""
    if data_axes is None:
        return None
    for d, entry in enumerate(spec):
        if entry == data_axes:
            return d
    return None


def _rows(x: torch.Tensor, mesh, spec: P, data_axes) -> torch.Tensor:
    """This rank's equal share of ``x`` 's batch dimension (the one
    ``spec`` shards over ``data_axes``); all of ``x`` if none."""
    d = _batch_dim(spec, data_axes)
    if d is None:
        return x
    i, n = axis_index(mesh, data_axes)
    if x.shape[d] % n:
        raise ValueError(f"batch dimension {x.shape[d]} does not split "
                         f"into {n} equal data shards")
    per = x.shape[d] // n
    return x.narrow(d, i * per, per)


def _rows_spec(ns: NamedSharding, data_axes) -> NamedSharding:
    """``ns`` with every entry but the batch dimension's replicated: the
    placement of a tensor each rank holds its batch rows of in full."""
    d = _batch_dim(ns.spec, data_axes)
    return NamedSharding(ns.mesh, P(*(e if i == d else None
                                      for i, e in enumerate(ns.spec))))


def _placed_rows(local: torch.Tensor, ns: NamedSharding, data_axes):
    """The tensor whose batch rows this rank holds in full (``local``),
    placed by ``ns``."""
    from torch.distributed.tensor import DTensor
    rows = _rows_spec(ns, data_axes)
    return DTensor.from_local(local, ns.mesh, rows.placements,
                              run_check=False).redistribute(
                                  ns.mesh, ns.placements)


def _local_rows(x, ns: NamedSharding, data_axes, dev) -> torch.Tensor:
    """This rank's batch rows of ``x`` (a ``DTensor`` placed by ``ns``, or
    the full tensor) with every other dimension whole."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        rows = _rows_spec(ns, data_axes)
        return x.redistribute(ns.mesh, rows.placements).to_local()
    return _rows(_to(x, dev), ns.mesh, ns.spec, data_axes).clone()


def _replicated(mesh, x: torch.Tensor):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _local_perf(cfg: ArchConfig, perf: PerfConfig, n_data: int
                ) -> PerfConfig:
    """``perf`` for one data rank's rows: a MoE config's groups split
    over the data ranks."""
    if cfg.moe is None or n_data == 1:
        return perf
    if perf.moe_groups % n_data:
        raise ValueError(f"moe_groups={perf.moe_groups} does not split "
                         f"over {n_data} data ranks")
    return dataclasses.replace(perf, moe_groups=perf.moe_groups // n_data)


# ===========================================================================
# train
# ===========================================================================

def _micro_grads(params, leaves, batch: dict, accum: int, cfg, shd, perf):
    """``loss_fn`` 's gradient of each of the ``accum`` microbatches of
    ``batch``, summed in float32 in microbatch order over ``leaves``
    (the tensors of ``params``): (sums, losses)."""
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves]
    losses = []
    with f32_matmul():
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()}
            # grad-carrying aliases of the parameters' storage: the
            # update writes the tensors themselves in place
            live = [p.detach().requires_grad_(True) for p in leaves]
            it = iter(live)
            tp = tree.map_(lambda _: next(it), params)
            with torch.enable_grad():
                loss, _ = M.loss_fn(tp, mb, cfg, shd, perf)
                grads = torch.autograd.grad(loss, live, allow_unused=True)
            for s, g in zip(gsum, grads):
                if g is not None:
                    s.add_(g.float())
            losses.append(loss.detach())
            del loss, grads, live, tp
    return gsum, losses


def make_train_step(cfg: ArchConfig, cell: ShapeCell, mesh, *,
                    perf: PerfConfig = PerfConfig(),
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    multi_pod: bool = False, dtype=torch.bfloat16,
                    device="cuda"):
    """-> (train_step, (params_sds, opt_sds, batch_sds)), the example
    arguments on ``"meta"``.

    ``train_step(params, opt, batch)`` is the reference's: the
    ``perf.accum_steps`` microbatches of ``batch`` (arrays [accum, B/accum,
    ...], NumPy or tensors) each give ``loss_fn``'s gradient, summed in
    float32 in microbatch order; the sum over ``accum`` feeds
    ``adamw_update``.  It returns (params, opt, metrics {"loss": the mean
    over microbatches, "grad_norm", "lr"}), params and moments updated in
    place.  Forward and backward run without TF32 (``f32_matmul``).

    On the one-device mesh that is all.  On a ``DeviceMesh`` params and
    moments are ``DTensor`` s placed by ``param_specs`` (tensors given
    whole are placed first), ``batch`` is the global batch, the same on
    every rank, of which each rank runs the rows of its data
    coordinate; the gradient sums are averaged over the data ranks on
    their way to the shards, and ``adamw_update`` runs on the shards
    with the global gradient norm.  Metrics are replicated ``DTensor`` s.
    """
    dev = resolve_device(device)
    if perf.opt_moments == "bf16":
        opt_cfg = dataclasses.replace(opt_cfg, moments_dtype=torch.bfloat16)
    accum = perf.accum_steps
    psds = params_sds(cfg, dtype)
    osds = adamw_init(psds, opt_cfg)
    lead = (accum, cell.global_batch // accum)
    batch_sds = {"tokens": _meta(lead + (cell.seq_len,), torch.int32),
                 "labels": _meta(lead + (cell.seq_len,), torch.int32)}
    if is_device_mesh(mesh):
        return _mesh_train_step(cfg, mesh, perf, opt_cfg, multi_pod, dtype,
                                _mesh_device(mesh, dev), psds, osds,
                                batch_sds)
    _one_device(mesh, multi_pod)
    batch_sds.update(_batch_extras_sds(cfg, lead, dtype, "data")[0])

    def train_step(params, opt, batch):
        batch = {k: _to(v, dev) for k, v in batch.items()}
        leaves = tree.leaves(params)
        gsum, losses = _micro_grads(params, leaves, batch, accum, cfg,
                                    NOSHARD, perf)
        # the span names the optimizer's kernels in a profile
        with torch.no_grad(), torch.profiler.record_function("adamw_update"):
            for s in gsum:
                s.div_(accum)
            it = iter(gsum)
            grads = tree.map_(lambda _: next(it), params)
            del gsum, it
            params, opt, metrics = adamw_update(params, grads, opt, opt_cfg)
            metrics["loss"] = torch.stack(losses).mean()
        return params, opt, metrics

    return train_step, (psds, osds, batch_sds)


def _mesh_train_step(cfg, mesh, perf, opt_cfg, multi_pod, dtype, dev,
                     psds, osds, batch_sds):
    from torch.distributed.tensor import DTensor, Partial, Replicate
    shd = make_sharder(mesh, multi_pod, parallelism=perf.parallelism)
    data = shd.data_axes
    accum = perf.accum_steps
    pspecs = param_specs(cfg, psds, multi_pod)
    pnamed = to_named(mesh, pspecs)
    onamed = {"m": pnamed, "v": pnamed, "step": NamedSharding(mesh, P())}
    batch_specs = {"tokens": P(None, data, None),
                   "labels": P(None, data, None)}
    ex_sds, ex_specs = _batch_extras_sds(cfg, batch_sds["tokens"].shape[:2],
                                         dtype, data)
    batch_sds.update(ex_sds)
    batch_specs.update(ex_specs)
    _, n_data = axis_index(mesh, data)
    lperf = _local_perf(cfg, perf, n_data)
    # the mesh axes the batch splits over hold partial gradient sums
    names = tuple(mesh.mesh_dim_names)
    data_dims = {names.index(a) for a in
                 ((data,) if isinstance(data, str) else data)}
    partial_pl = [Partial() if i in data_dims else Replicate()
                  for i in range(mesh.ndim)]

    def train_step(params, opt, batch):
        params = place(params, pnamed)
        opt = place(opt, onamed)
        batch = {k: _rows(_to(v, dev), mesh, batch_specs[k], data)
                 for k, v in batch.items()}
        full = gather(params)
        gsum, losses = _micro_grads(full, tree.leaves(full), batch, accum,
                                    cfg, shd, lperf)
        del full
        with torch.no_grad(), torch.profiler.record_function("adamw_update"):
            shards = []
            for s, p in zip(gsum, tree.leaves(params)):
                s.div_(accum)
                g = DTensor.from_local(s, mesh, partial_pl, run_check=False)
                shards.append(g.redistribute(mesh, p.placements))
            del gsum
            # the mean over the data ranks, in the shards themselves
            grads = [g.to_local().div_(n_data) for g in shards]
            gnorm = global_norm(shards).full_tensor()
            it = iter(grads)
            grads = tree.map_(lambda _: next(it), params)
            del shards, it
            local = tree.map_(lambda x: x.to_local(), params)
            lopt = {"m": tree.map_(lambda x: x.to_local(), opt["m"]),
                    "v": tree.map_(lambda x: x.to_local(), opt["v"]),
                    "step": opt["step"].to_local()}
            _, lopt, metrics = adamw_update(local, grads, lopt, opt_cfg,
                                            grad_norm=gnorm)
            loss = DTensor.from_local(torch.stack(losses).mean(), mesh,
                                      partial_pl, run_check=False)
            metrics["loss"] = loss.full_tensor() / n_data
        opt = {"m": opt["m"], "v": opt["v"],
               "step": _replicated(mesh, lopt["step"])}
        return params, opt, {k: _replicated(mesh, v)
                             for k, v in metrics.items()}

    return train_step, (psds, osds, batch_sds)


# ===========================================================================
# prefill
# ===========================================================================

def make_prefill_step(cfg: ArchConfig, cell: ShapeCell, mesh, *,
                      perf: PerfConfig = PerfConfig(),
                      multi_pod: bool = False, dtype=torch.bfloat16,
                      device="cuda"):
    """-> (prefill_step, (params_sds, batch_sds)), on ``"meta"``.

    ``prefill_step(params, batch)`` is ``models.serve.prefill`` of the
    cell's batch (``tokens`` [B, S] and the family's embeddings) with
    caches of the cell's sequence length: (last-position logits
    [B, vocab_p], caches).  A cell of fewer than 16 sequences is a tiny
    batch (``make_sharder``): its caches shard the sequence over the
    whole mesh and every rank runs the whole batch.  On a ``DeviceMesh``
    the logits are placed by ``P(data_axes, "model")`` and the caches by
    the retargeted ``cache_specs``.
    """
    dev = resolve_device(device)
    tiny = cell.global_batch < 16
    shd = make_sharder(mesh, multi_pod, tiny_batch=tiny)
    psds = params_sds(cfg, dtype)
    B, S = cell.global_batch, cell.seq_len
    batch_sds = {"tokens": _meta((B, S), torch.int32)}
    batch_specs = {"tokens": P(shd.data_axes, None)}
    ex_sds, ex_specs = _batch_extras_sds(cfg, (B,), dtype, shd.data_axes)
    batch_sds.update(ex_sds)
    batch_specs.update(ex_specs)

    if not is_device_mesh(mesh):
        _one_device(mesh, multi_pod)

        def prefill_step(params, batch):
            batch = {k: _to(v, dev) for k, v in batch.items()}
            return SV.prefill(params, batch, cfg, shd, perf, max_seq=S)
        return prefill_step, (psds, batch_sds)

    dev = _mesh_device(mesh, dev)
    data = shd.data_axes
    csds = SV.init_caches(cfg, B, S, dtype, kv_quant=perf.kv_quant,
                          device="meta")
    cnamed = to_named(mesh, _retarget_cache_specs(
        cache_specs(cfg, csds, multi_pod), shd))
    lnamed = NamedSharding(mesh, P(data, "model"))
    lperf = _local_perf(cfg, perf, axis_index(mesh, data)[1])

    def prefill_step(params, batch):
        batch = {k: _rows(_to(v, dev), mesh, batch_specs[k], data)
                 for k, v in batch.items()}
        logits, caches = SV.prefill(gather(params), batch, cfg, shd, lperf,
                                    max_seq=S)
        return (_placed_rows(logits, lnamed, data),
                map_specs(lambda _, c, ns: _placed_rows(c, ns, data),
                          caches, cnamed))

    return prefill_step, (psds, batch_sds)


# ===========================================================================
# decode
# ===========================================================================

def make_decode_step(cfg: ArchConfig, cell: ShapeCell, mesh, *,
                     perf: PerfConfig = PerfConfig(),
                     multi_pod: bool = False, dtype=torch.bfloat16,
                     device="cuda"):
    """-> (decode_step, (params_sds, tokens_sds, caches_sds, pos_sds)),
    on ``"meta"``.

    ``decode_step(params, tokens, caches, pos)`` is ``models.serve.
    decode_step`` of tokens [B, 1] at position ``pos`` (an int or a
    0-d tensor): (logits [B, vocab_p], caches).  On the one-device mesh
    it updates ``caches`` in place; on a ``DeviceMesh`` ``caches`` are
    placed by the retargeted ``cache_specs`` (as ``make_prefill_step``
    returns them), each rank gathers the sequence of its batch rows, and
    the step returns new caches placed as they came, and the logits by
    ``P(data_axes, "model")``.
    """
    dev = resolve_device(device)
    tiny = cell.global_batch < 16
    shd = make_sharder(mesh, multi_pod, tiny_batch=tiny)
    psds = params_sds(cfg, dtype)
    B, S = cell.global_batch, cell.seq_len
    csds = SV.init_caches(cfg, B, S, dtype, kv_quant=perf.kv_quant,
                          device="meta")
    tok_sds = _meta((B, 1), torch.int32)
    pos_sds = _meta((), torch.int32)
    example = (psds, tok_sds, csds, pos_sds)

    if not is_device_mesh(mesh):
        _one_device(mesh, multi_pod)

        def decode_step(params, tokens, caches, pos):
            return SV.decode_step(params, _to(tokens, dev), caches,
                                  int(pos), cfg, shd,
                                  unroll=not perf.scan_layers,
                                  moe_groups=perf.moe_groups)
        return decode_step, example

    dev = _mesh_device(mesh, dev)
    data = shd.data_axes
    cnamed = to_named(mesh, _retarget_cache_specs(
        cache_specs(cfg, csds, multi_pod), shd))
    lnamed = NamedSharding(mesh, P(data, "model"))
    tnamed = NamedSharding(mesh, P(data, None))
    groups = _local_perf(cfg, perf, axis_index(mesh, data)[1]).moe_groups

    def decode_step(params, tokens, caches, pos):
        tokens = _local_rows(tokens, tnamed, data, dev)
        local = map_specs(lambda _, c, ns: _local_rows(c, ns, data, dev),
                          caches, cnamed)
        logits, local = SV.decode_step(gather(params), tokens, local,
                                       int(pos), cfg, shd,
                                       unroll=not perf.scan_layers,
                                       moe_groups=groups)
        return (_placed_rows(logits, lnamed, data),
                map_specs(lambda _, c, ns: _placed_rows(c, ns, data),
                          local, cnamed))

    return decode_step, example


__all__ = ["make_decode_step", "make_prefill_step", "make_sharder",
           "make_train_step", "params_sds"]
