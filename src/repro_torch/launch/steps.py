"""Step functions (the port's ``launch/steps.py``): the shape-only
parameter tree ``params_sds`` and the train step ``make_train_step``.

The reference's ``params_sds`` is ``jax.eval_shape`` of ``init_params``;
here ``init_params`` builds the same tree on the ``"meta"`` device, so
every leaf has its shape and dtype and no memory, and the largest
configs (``deepseek-v2-236b``, ``qwen2-vl-72b``) cost nothing to count.
``make_train_step`` returns its example arguments the same way.  The
prefill and decode steps wait for the model half of ``parallel/``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.profiler

from repro_torch import resolve_device, tree
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.models import model as M
from repro_torch.models.layers import NOSHARD, f32_matmul
from repro_torch.models.model import PerfConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def params_sds(cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    """The port's parameter tree of ``cfg`` with every leaf on
    ``"meta"``: shapes and dtypes, no storage."""
    return M.init_params(cfg, torch.Generator(), dtype, device="meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_sds(cfg: ArchConfig, cell: ShapeCell, accum: int, dtype) -> dict:
    lead = (accum, cell.global_batch // accum)
    sds = {"tokens": _meta(lead + (cell.seq_len,), torch.int32),
           "labels": _meta(lead + (cell.seq_len,), torch.int32)}
    if cfg.family == "encdec":
        sds["audio_embeds"] = _meta(lead + (cfg.enc_seq, cfg.d_model), dtype)
    if cfg.n_prefix_embeds:
        sds["prefix_embeds"] = _meta(
            lead + (cfg.n_prefix_embeds, cfg.d_model), dtype)
    return sds


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
    ``mesh`` is the port's one-device mesh (``launch.mesh.
    make_local_mesh``); ``multi_pod`` is accepted for the reference's
    signature and must be False.
    """
    dev = resolve_device(device)
    if multi_pod or len(tuple(mesh)) != 1:
        raise NotImplementedError(
            "a train step over several devices waits for the model half of "
            "repro_torch.parallel; use launch.mesh.make_local_mesh(1, 1)")
    if perf.opt_moments == "bf16":
        opt_cfg = dataclasses.replace(opt_cfg, moments_dtype=torch.bfloat16)
    accum = perf.accum_steps
    psds = params_sds(cfg, dtype)
    osds = adamw_init(psds, opt_cfg)
    batch_sds = _batch_sds(cfg, cell, accum, dtype)

    def to_device(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(dev)

    def train_step(params, opt, batch):
        batch = {k: to_device(v) for k, v in batch.items()}
        leaves = tree.leaves(params)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        losses = []
        with f32_matmul():
            for i in range(accum):
                mb = {k: v[i] for k, v in batch.items()}
                # grad-carrying aliases of the parameters' storage: the
                # update below writes the tensors themselves in place
                live = [p.detach().requires_grad_(True) for p in leaves]
                it = iter(live)
                tp = tree.map_(lambda _: next(it), params)
                with torch.enable_grad():
                    loss, _ = M.loss_fn(tp, mb, cfg, NOSHARD, perf)
                    grads = torch.autograd.grad(loss, live,
                                                allow_unused=True)
                for s, g in zip(gsum, grads):
                    if g is not None:
                        s.add_(g.float())
                losses.append(loss.detach())
                del loss, grads, live, tp
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


__all__ = ["make_train_step", "params_sds"]
