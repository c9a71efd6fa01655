"""Per-rank cost of the port's steps, counted as they run (the port's
``launch/costing.py``).

The reference compiles each step with XLA and reads
``HloCostAnalysis``, which visits a ``lax.scan`` body once whatever its
trip count; its ``ComponentCoster`` therefore compiles each block apart
and multiplies by the true trip counts.  The port has no scans: every
layer, microbatch and optimizer leaf runs in Python.  So here

- :class:`CostCounter`, a ``TorchDispatchMode``, counts every aten op a
  callable executes, on fake tensors (``FakeTensorMode``: shapes only,
  no storage, no device) or on real ones;
- :func:`cost_of` runs a callable under it on fake tensors made from
  ``"meta"`` example arguments, the counterpart of the reference's
  ``_cost_of``;
- :class:`ComponentCoster` keeps the reference's API and record:
  ``bodies()`` costs each block as the step runs it, and
  ``reconstruct(full_cost, full_wire)`` splits the full step's direct
  count.  Every layer is traced, so ``traced == true`` for every
  component (the reference sets the same when ``scan_layers`` is off);
  the direct count already holds the ``accum_steps`` microbatches and
  the optimizer, so ``total`` is that count and the embedding and head
  are what it leaves: ``embed_head = (full - optimizer) / A
  - sum(true * body)``, clamped at 0 as the reference clamps.

What a count means, per rank:

- ``flops`` counts as XLA's ``HloCostAnalysis`` does, which is what the
  reference's figures mean: ``torch.utils.flop_counter`` 's formulas for
  the matrix products (2 a multiply-add) and for the flash-attention
  operator (``kernels/flash_attention/ops.py``: every (query, key) pair,
  PyTorch's SDPA convention, no mask discount), one flop an output
  element for a pointwise op and a dtype cast, one an input element for
  a reduction, a few an element for the softmax family, and nothing for
  views, copies, gathers, scatters and allocations.  ``matmul_flops`` is
  the tensor-core part alone (the products and attention).
- ``bytes`` sums the input and output bytes of every op but views and
  allocations.  Nothing is fused here, so it is an upper bound on what a
  fused program moves, not XLA's "bytes accessed".
- ``wire`` applies the ring formulas of ``launch/roofline.py``
  (``ring_wire_bytes``) to the functional collectives that ``DTensor``
  issues (``_c10d_functional.all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``):
  their result bytes over the group size.  A collective that ``DTensor``
  runs inside its own op dispatch (the scalar norm of a sharded
  gradient) is not seen.

On a ``DeviceMesh`` a step runs on each rank its data rows
(``launch/steps.py``) and splits the rest over ``model`` (tensor and
expert parallelism), so the blocks are costed on one rank's rows with
its ``model`` shards of the weights (caches and Mamba states its
shards), the block's collectives over ``model`` (and a decode's over
the cache's sequence ranks) counted in its wire; under ``fsdp`` the
weights are whole and so is each block's compute.  The weight gathers
over the data axes and the gradient reduce-scatters are step-level, so
their wire lands in ``embed_head``.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import tree
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.launch import roofline as RF
from repro_torch.launch.steps import (_local_perf, _retarget_cache_specs,
                                      make_sharder, params_sds, tp_sharder)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import serve as SV
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import gelu_mlp, swiglu
from repro_torch.models.model import (PerfConfig, _cross_attn, _cross_kv,
                                      _dec_block, _dense_block,
                                      _mla_dense_block, _moe_block, _norm,
                                      _remat, _ssm_block, n_segments,
                                      positions_for)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel import tensor_parallel as TP
from repro_torch.parallel.sharding import (P, axis_index, cache_specs,
                                           is_device_mesh, map_specs,
                                           param_specs, placements)

_aten = torch.ops.aten

#: flops an element of the op's (first) input, for ops outside the tags
_PER_ELEMENT = {
    # max, subtract, sum, divide (the exponential is a transcendental)
    _aten._softmax: 4, _aten._log_softmax: 4,
    _aten._softmax_backward_data: 4, _aten._log_softmax_backward_data: 4,
    _aten.cumsum: 1, _aten.logsumexp: 3,
}

#: ops that accumulate their updates: one flop an update element
_ACCUMULATE = (_aten.index_add, _aten.scatter_add, _aten.index_put,
               _aten._index_put_impl, _aten.embedding_dense_backward)

#: copies (``clone`` is tagged pointwise): a convert where the dtype
#: changes, else free
_COPY = (_aten.clone, _aten._to_copy, _aten.copy_, _aten.copy)

#: ops that only allocate: no flops, no bytes
_ALLOCATE = (_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided)

#: the functional collectives by the reference's names
_COLLECTIVE = (("all_gather_into_tensor", "all-gather"),
               ("reduce_scatter_tensor", "reduce-scatter"),
               ("all_to_all_single", "all-to-all"),
               ("all_reduce", "all-reduce"))


_DTENSOR: list = []


def _local(x):
    """A ``DTensor`` 's local shard (what this rank holds); else ``x``."""
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return x._local_tensor if isinstance(x, _DTENSOR[0]) else x


def _tensors(x, out=None) -> list:
    """The tensors of ``x`` (nested lists, tuples and dicts), each
    ``DTensor`` as its local shard."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(_local(x))
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@functools.lru_cache(maxsize=None)
def _rule(func) -> tuple:
    """How op ``func`` counts: (what, detail, moves bytes)."""
    packet = func.overloadpacket
    # an op whose result aliases an input without writing it is a view
    moves = not any(r.alias_info is not None and not r.alias_info.is_write
                    for r in func._schema.returns)
    name = func._schema.name.split("::")[-1]
    for stem, kind in _COLLECTIVE:
        if name.startswith(stem):
            return "collective", kind, moves
    if packet in _ALLOCATE:
        return "allocate", None, False
    if packet in flop_registry:
        return "formula", flop_registry[packet], moves
    if packet in _PER_ELEMENT:
        return "per_element", _PER_ELEMENT[packet], moves
    if packet in _COPY:
        return "copy", None, moves
    if torch.Tag.pointwise in func.tags:
        return "pointwise", None, moves
    if torch.Tag.reduction in func.tags:
        return "reduction", None, moves
    if packet in _ACCUMULATE:
        return "accumulate", packet, moves
    return "free", None, moves


def _group_size(func, args, kwargs) -> int:
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    if "group_size" in named:
        return int(named["group_size"])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(named["group_name"]).size()


class CostCounter(TorchDispatchMode):
    """Counts the ops run under it: ``flops``, ``matmul_flops``,
    ``bytes`` and ``wire`` (module docstring), the collectives by kind
    (``collectives``: wire bytes; ``counts``: calls), and with
    ``track_memory`` the peak of the bytes of live storages made under
    it (``peak_bytes``) and those still live at the end
    (``live_bytes``).  ``DTensor`` s count as their local shards."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.flops = 0.0
        self.matmul_flops = 0.0
        self.bytes = 0.0
        self.wire = 0.0
        self.collectives = {k: 0.0 for k in RF.COLLECTIVES}
        self.counts = {k: 0 for k in RF.COLLECTIVES}
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = weakref.WeakSet() if track_memory else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        if self.track_memory:
            for t in _tensors(out):
                self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        n = st.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, n)

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def _count(self, func, args, kwargs, out) -> None:
        what, detail, moves = _rule(func)
        if what == "allocate":
            return
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if what == "collective":
            n = _group_size(func, args, kwargs)
            wire = RF.ring_wire_bytes(detail, sum(map(_nbytes, outs)), n)
            self.wire += wire
            self.collectives[detail] += wire
            self.counts[detail] += 1
        elif what == "formula":
            local_args, local_kwargs = torch.utils._pytree.tree_map(
                _local, (args, kwargs))
            f = float(detail(*local_args, **local_kwargs,
                             out_val=torch.utils._pytree.tree_map(_local,
                                                                  out)))
            self.flops += f
            self.matmul_flops += f
        elif what == "per_element":
            self.flops += detail * ins[0].numel()
        elif what == "copy":
            # a copy is free; one that changes the dtype is a convert
            if outs and ins and ins[-1].dtype != outs[0].dtype:
                self.flops += outs[0].numel()
        elif what == "pointwise":
            self.flops += sum(t.numel() for t in outs)
        elif what == "reduction":
            self.flops += ins[0].numel() if ins else 0
        elif what == "accumulate" and _accumulates(detail, args, kwargs):
            self.flops += _updates(detail, ins)
        if moves:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))

    def result(self) -> dict:
        return {"flops": self.flops, "matmul_flops": self.matmul_flops,
                "bytes": self.bytes, "wire": self.wire}


def _accumulates(packet, args, kwargs) -> bool:
    if packet in (_aten.index_put, _aten._index_put_impl):
        return bool(args[3] if len(args) > 3 else kwargs.get("accumulate"))
    return True


def _updates(packet, ins) -> int:
    """The update elements of an accumulating op: its last tensor
    argument (``source``, ``src``, ``values``), an embedding gradient's
    first (the rows' gradients)."""
    return ins[0 if packet is _aten.embedding_dense_backward else -1].numel()


# ---------------------------------------------------------------------------
# fake tensors
# ---------------------------------------------------------------------------

def fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def fake_like(x, device="cpu"):
    """A tree of ``"meta"`` tensors as fake tensors on ``device``, made
    under the caller's ``FakeTensorMode``."""
    return tree.map_(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                           device=device), x)


def cost_of(fn: Callable, *args, device="cpu") -> dict:
    """``fn(*args)`` on fake tensors shaped as ``args`` (trees of
    ``"meta"`` tensors), counted: the counterpart of the reference's
    ``_cost_of``."""
    with fake_mode():
        fargs = [fake_like(a, device) for a in args]
        with CostCounter() as c:
            fn(*fargs)
    return c.result()


def _zero():
    return {"flops": 0.0, "bytes": 0.0, "wire": 0.0}


def _sub_clamped(a, b, k=1.0):
    return {key: max(a[key] - k * b[key], 0.0) for key in a}


def _three(c: dict) -> dict:
    return {k: float(c[k]) for k in ("flops", "bytes", "wire")}


def _model_shape(shape, spec, mesh, kind: str) -> tuple:
    """The shape of rank 0's tensor of a weight placed by ``spec`` as a
    tensor-parallel step computes with it: its ``model`` shard where
    ``kind`` (``tensor_parallel.layout``) is ``"shard"``, else whole."""
    out = list(shape)
    if kind == "shard":
        i = mesh.mesh_dim_names.index("model")
        pl = placements(mesh, spec)[i]
        out[pl.dim] = -(-out[pl.dim] // mesh.size(i))
    return tuple(out)


def _local_shape(shape, spec, mesh) -> tuple:
    """The shape of rank 0's shard of a tensor placed by ``spec`` on
    ``mesh`` (``torch.chunk`` sizes: the first shard the largest)."""
    out = list(shape)
    for i, pl in enumerate(placements(mesh, spec)):
        if pl.is_shard():
            out[pl.dim] = -(-out[pl.dim] // mesh.size(i))
    return tuple(out)


# ---------------------------------------------------------------------------
# ComponentCoster
# ---------------------------------------------------------------------------

class ComponentCoster:
    """Costs each block of one (cfg, cell, mesh) under a perf config, on
    fake tensors, as the port's step runs it (module docstring)."""

    def __init__(self, cfg: ArchConfig, cell: ShapeCell, mesh,
                 perf: PerfConfig, multi_pod: bool = False,
                 dtype=torch.bfloat16, pspecs=None, psds=None):
        self.cfg = cfg
        self.cell = cell
        self.mesh = mesh
        self.perf = perf
        self.multi_pod = multi_pod
        self.dtype = dtype
        tiny = cell.kind != "train" and cell.global_batch < 16
        self.shd = tp_sharder(cfg, mesh, make_sharder(
            mesh, multi_pod, tiny_batch=tiny, parallelism=perf.parallelism))
        self.psds = psds if psds is not None else params_sds(cfg, dtype)
        self.pspecs = pspecs if pspecs is not None \
            else param_specs(cfg, self.psds, multi_pod)
        # what a rank computes with: its model shards under tensor
        # parallelism, else the whole weights
        self.compute_sds = self.psds
        if self.shd.tp is not None:
            layout = TP.layout(cfg, self.psds, self.pspecs, self.shd.tp)
            self.compute_sds = map_specs(
                lambda _, p, s, k: _meta(_model_shape(p.shape, s, mesh, k),
                                         p.dtype),
                self.psds, self.pspecs, layout)
        # the data ranks split the batch: one rank costs its rows
        self.n_data = 1
        if is_device_mesh(mesh) and self.shd.data_axes is not None:
            self.n_data = axis_index(mesh, self.shd.data_axes)[1]
        self.local_perf = _local_perf(cfg, perf, self.n_data)
        B = cell.global_batch // perf.accum_steps \
            if cell.kind == "train" else cell.global_batch
        if B % self.n_data:
            raise ValueError(f"batch {B} does not split into {self.n_data} "
                             "data shards")
        self.Bm = B // self.n_data
        self.S = cell.seq_len if cell.kind != "decode" else 1
        self.x_sds = _meta((self.Bm, self.S, cfg.d_model), dtype)

    # ------------------------------------------------------------ helpers
    def _layer(self, key: str):
        """One layer's parameters of stack ``key`` as a rank computes
        with them (on ``"meta"``)."""
        return self.compute_sds[key][0]

    def _count(self, fn: Callable, *args) -> dict:
        return _three(cost_of(fn, *args))

    # ---------------------------------------------------- train-block costs
    def _train_block_cost(self, block_fn: Callable, lp_sds,
                          has_aux: bool = False, extra_sds=(), S=None,
                          x_sds=None):
        perf = self.perf
        S = self.S if S is None else S

        def fwd(lp, x, *extra):
            return block_fn(lp, x, positions_for(x.shape[0], S, x.device),
                            *extra)
        blk = _remat(fwd, perf.remat)

        def cost_fn(lp, x, *extra):
            leaves = tree.leaves(lp) + [x, *extra]
            for t in leaves:
                t.requires_grad_(True)
            with torch.enable_grad():
                y = blk(lp, x, *extra)
                if has_aux:
                    outs = y
                    cts = (y[0], torch.ones((), dtype=torch.float32))
                else:
                    outs, cts = (y,), (y,)
                torch.autograd.grad(outs, leaves, cts, allow_unused=True)
        return self._count(cost_fn, lp_sds,
                           self.x_sds if x_sds is None else x_sds,
                           *extra_sds)

    def _opt_cost(self) -> dict:
        """``adamw_update`` on what one rank holds: the parameters'
        shards by their specs (whole on the one-device mesh), float32
        gradients of the same shapes."""
        ocfg = AdamWConfig(moments_dtype=torch.bfloat16
                           if self.perf.opt_moments == "bf16"
                           else torch.float32)
        sharded = is_device_mesh(self.mesh)
        local = map_specs(lambda _, p, s: _meta(
            _local_shape(p.shape, s, self.mesh), p.dtype),
            self.psds, self.pspecs) if sharded else self.psds
        grads = tree.map_(lambda p: _meta(p.shape, torch.float32), local)
        opt = adamw_init(local, ocfg)

        def opt_fn(params, grads, opt):
            # a sharded step gives the clip the global norm
            adamw_update(params, grads, opt, ocfg,
                         grad_norm=torch.ones(()) if sharded else None)
        return self._count(opt_fn, local, grads, opt)

    # ---------------------------------------------------------- public API
    def bodies(self) -> dict[str, tuple[dict, int, int]]:
        """-> {name: (cost, count_in_traced_program, true_count_per_micro)};
        every layer runs in Python, so the two counts are equal."""
        if self.cell.kind != "train":
            return self._serve_bodies()
        cfg, shd, chunk = self.cfg, self.shd, self.perf.attn_chunk
        mk = self._train_block_cost
        out = {}
        if cfg.family == "dense":
            fn = functools.partial(_dense_block, cfg=cfg, shd=shd,
                                   chunk=chunk)
            out["block"] = (mk(fn, self._layer("layers")), cfg.n_layers,
                            cfg.n_layers)
        elif cfg.family == "moe":
            nd = cfg.moe.first_dense
            fd = functools.partial(_mla_dense_block, cfg=cfg, shd=shd,
                                   chunk=chunk)
            fm = functools.partial(_moe_block, cfg=cfg, shd=shd, chunk=chunk,
                                   groups=self.local_perf.moe_groups)
            out["dense_block"] = (mk(fd, self._layer("dense_layers")), nd, nd)
            n = cfg.n_layers - nd
            out["moe_block"] = (mk(fm, self._layer("layers"), has_aux=True),
                                n, n)
        elif cfg.family == "ssm":
            fn = functools.partial(_ssm_block, cfg=cfg, shd=shd)
            out["block"] = (mk(lambda lp, x, pos: fn(lp, x),
                               self._layer("layers")), cfg.n_layers,
                            cfg.n_layers)
        elif cfg.family == "hybrid":
            n_seg = n_segments(cfg)
            fs = functools.partial(_dense_block, cfg=cfg, shd=shd,
                                   chunk=chunk)
            fn = functools.partial(_ssm_block, cfg=cfg, shd=shd)
            out["shared_block"] = (mk(fs, self.compute_sds["shared_block"]),
                                   n_seg, n_seg)
            out["mamba_block"] = (mk(lambda lp, x, pos: fn(lp, x),
                                     self._layer("layers")),
                                  cfg.n_layers, cfg.n_layers)
        elif cfg.family == "encdec":
            enc_sds = _meta((self.Bm, cfg.enc_seq, cfg.d_model), self.dtype)

            def enc_fn(lp, x, pos):
                h = attn_mod.attn_train(lp["attn"], _norm(x, lp["ln1"], cfg),
                                        pos, cfg, shd, causal=False)
                x = x + h
                return x + gelu_mlp(lp["mlp"], _norm(x, lp["ln2"], cfg), shd)

            def dec_fn(lp, x, pos, enc_out):
                enc_pos = positions_for(x.shape[0], enc_out.shape[1],
                                        x.device)
                return _dec_block(lp, x, enc_out, pos, enc_pos, cfg, shd,
                                  chunk)
            # encoder blocks see enc_seq-long x
            out["enc_block"] = (mk(enc_fn, self._layer("enc_layers"),
                                   S=cfg.enc_seq, x_sds=enc_sds),
                                cfg.n_enc_layers, cfg.n_enc_layers)
            out["dec_block"] = (mk(dec_fn, self._layer("layers"),
                                   extra_sds=(enc_sds,)),
                                cfg.n_layers, cfg.n_layers)
        else:
            raise ValueError(cfg.family)
        return out

    # ------------------------------------------------------- serve bodies
    def _serve_bodies(self):
        cfg, shd, cell = self.cfg, self.shd, self.cell
        B, S = self.Bm, cell.seq_len
        decode = cell.kind == "decode"
        chunk = self.perf.attn_chunk
        groups = self.local_perf.moe_groups
        pos = S - 1          # the decode position: any int below S
        csds = SV.init_caches(cfg, B, S, self.dtype,
                              kv_quant=self.perf.kv_quant, device="meta",
                              shd=shd)
        x_sds = _meta((B, 1 if decode else S, cfg.d_model), self.dtype)
        out = {}

        def one(ckey):
            return {k: v[0] for k, v in csds[ckey].items()}

        def ffn(lp, x, with_moe):
            if with_moe:
                return x + moe_mod.moe_ffn(lp["moe"], _norm(x, lp["ln2"], cfg),
                                           cfg, shd, groups=groups)[0]
            return x + swiglu(lp["mlp"], _norm(x, lp["ln2"], cfg), shd)

        def attn_layer(lp_sds, ckey, mla=False, with_moe=False):
            if decode:
                step = mla_mod.mla_decode if mla else attn_mod.attn_decode

                @torch.no_grad()
                def fn(lp, x, cache):
                    h, _ = step(lp["attn"], _norm(x, lp["ln1"], cfg), cache,
                                pos, cfg, shd)
                    return ffn(lp, x + h, with_moe)
            else:
                step = mla_mod.mla_prefill if mla \
                    else attn_mod.prefill_into_cache

                @torch.no_grad()
                def fn(lp, x, cache):
                    positions = positions_for(B, S, x.device)
                    h, _ = step(lp["attn"], _norm(x, lp["ln1"], cfg),
                                positions, cfg, shd, cache, chunk=chunk)
                    return ffn(lp, x + h, with_moe)
            return self._count(fn, lp_sds, x_sds, one(ckey))

        if cfg.family == "dense":
            out["block"] = (attn_layer(self._layer("layers"), "layers"),
                            cfg.n_layers, cfg.n_layers)
        elif cfg.family == "moe":
            nd = cfg.moe.first_dense
            out["dense_block"] = (attn_layer(self._layer("dense_layers"),
                                             "dense_layers", mla=True),
                                  nd, nd)
            n = cfg.n_layers - nd
            out["moe_block"] = (attn_layer(self._layer("layers"), "layers",
                                           mla=True, with_moe=True), n, n)
        elif cfg.family in ("ssm", "hybrid"):
            @torch.no_grad()
            def ssm_fn(lp, x, st):
                if decode:
                    h, _ = ssm_mod.ssm_decode(lp["ssm"],
                                              _norm(x, lp["ln"], cfg), st,
                                              cfg, shd)
                    return x + h
                return SV._ssm_prefill_block(lp, x, cfg, shd, st)
            cost = self._count(ssm_fn, self._layer("layers"), x_sds,
                               one("layers"))
            if cfg.family == "ssm":
                out["block"] = (cost, cfg.n_layers, cfg.n_layers)
            else:
                n_seg = n_segments(cfg)
                out["mamba_block"] = (cost, cfg.n_layers, cfg.n_layers)
                out["shared_block"] = (
                    attn_layer(self.compute_sds["shared_block"], "shared"),
                    n_seg, n_seg)
        elif cfg.family == "encdec":
            # decoder self+cross blocks; encoder runs once at prefill
            out["block"] = (self._encdec_serve_block(csds, x_sds, pos,
                                                     decode),
                            cfg.n_layers, cfg.n_layers)
            if not decode:
                out["enc_block"] = (self._encdec_encoder_block(),
                                    cfg.n_enc_layers, cfg.n_enc_layers)
        else:
            raise ValueError(cfg.family)
        return out

    def _encdec_serve_block(self, csds, x_sds, pos, decode):
        cfg, shd = self.cfg, self.shd
        B, S = self.Bm, self.cell.seq_len
        cache = {k: v[0] for k, v in csds["layers"].items()}
        ck_sds = csds["cross_k"][0]
        if decode:
            @torch.no_grad()
            def fn(lp, x, cache, ck, cv):
                h, _ = attn_mod.attn_decode(
                    lp["self_attn"], _norm(x, lp["ln1"], cfg), cache, pos,
                    cfg, shd)
                x = x + h
                x = x + SV._cross_decode(lp["cross_attn"],
                                         _norm(x, lp["ln2"], cfg), ck, cv,
                                         cfg, shd)
                return x + gelu_mlp(lp["mlp"], _norm(x, lp["ln3"], cfg), shd)
            return self._count(fn, self._layer("layers"), x_sds, cache,
                               ck_sds, ck_sds)
        enc_sds = _meta((B, cfg.enc_seq, cfg.d_model), self.dtype)

        @torch.no_grad()
        def fn(lp, x, cache, enc_out, ck, cv):
            positions = positions_for(B, S, x.device)
            h, _ = attn_mod.prefill_into_cache(
                lp["self_attn"], _norm(x, lp["ln1"], cfg), positions, cfg,
                shd, cache, chunk=self.perf.attn_chunk)
            x = x + h
            enc_pos = positions_for(B, enc_out.shape[1], x.device)
            kv = _cross_kv(lp["cross_attn"], enc_out, cfg, shd, whole=True)
            x = x + _cross_attn(lp["cross_attn"], _norm(x, lp["ln2"], cfg),
                                enc_out, positions, enc_pos, cfg, shd, kv)
            x = x + gelu_mlp(lp["mlp"], _norm(x, lp["ln3"], cfg), shd)
            if shd.tp is not None:
                kv = tuple(shd.tp.kv_all(t, cfg) for t in kv)
            ck.copy_(kv[0])
            cv.copy_(kv[1])
            return x
        return self._count(fn, self._layer("layers"), x_sds, cache, enc_sds,
                           ck_sds, ck_sds)

    def _encdec_encoder_block(self):
        cfg, shd = self.cfg, self.shd
        B = self.Bm
        x_sds = _meta((B, cfg.enc_seq, cfg.d_model), self.dtype)

        @torch.no_grad()
        def fn(lp, x):
            pos = positions_for(B, cfg.enc_seq, x.device)
            h = attn_mod.attn_train(lp["attn"], _norm(x, lp["ln1"], cfg),
                                    pos, cfg, shd, causal=False)
            x = x + h
            return x + gelu_mlp(lp["mlp"], _norm(x, lp["ln2"], cfg), shd)
        return self._count(fn, self._layer("enc_layers"), x_sds)

    # ------------------------------------------------------ reconstruction
    def reconstruct(self, full_cost: dict, full_wire: float) -> dict:
        """full_cost: {'flops', 'bytes_accessed'} of the full step's
        direct count (:func:`step_cost`), which holds every layer,
        microbatch and the optimizer: ``total`` is that count."""
        bodies = self.bodies()
        c_full = {"flops": float(full_cost["flops"]),
                  "bytes": float(full_cost["bytes_accessed"]),
                  "wire": float(full_wire)}
        opt = self._opt_cost() if self.cell.kind == "train" else _zero()
        A = self.perf.accum_steps if self.cell.kind == "train" else 1
        emb = {k: v / A for k, v in _sub_clamped(c_full, opt).items()}
        for name, (cost, n_traced, n_true) in bodies.items():
            emb = _sub_clamped(emb, cost, n_true)
        return {
            "total": c_full,
            "per_component": {
                name: {"cost": cost, "traced": n_traced, "true": n_true}
                for name, (cost, n_traced, n_true) in bodies.items()},
            "embed_head": emb,
            "optimizer": opt,
        }


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the full step, counted directly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepRun:
    """A step's direct count on fake tensors: ``cost`` (flops,
    matmul_flops, bytes, wire), ``collectives`` (wire bytes and counts
    by kind, the reference's keys), ``memory`` (bytes, the reference's
    keys) and the seconds to build the step (``build_s``) and run it
    (``run_s``)."""
    cost: dict
    collectives: dict
    memory: dict
    build_s: float
    run_s: float


def step_inputs(kind: str, example, mesh, cfg, cell, multi_pod, shd,
                device="cpu"):
    """The step's arguments as fake tensors (under the caller's
    ``FakeTensorMode``) from its ``"meta"`` example arguments.  On a
    ``DeviceMesh`` parameters, moments and caches are ``DTensor`` s placed
    by their specs, as a running step holds them.  The decode position is
    a Python int, the cache's last slot (``make_decode_step`` calls
    ``int(pos)``, which a fake tensor cannot give)."""
    from torch.distributed.tensor import distribute_tensor
    fake = fake_like(example[:-1] if kind == "decode" else example, device)
    if kind == "decode":
        fake = (*fake, cell.seq_len - 1)
    if not is_device_mesh(mesh):
        return fake

    def placed(t, specs):
        return map_specs(lambda _, x, s: distribute_tensor(
            x, mesh, placements(mesh, s)), t, specs)
    pspecs = param_specs(cfg, example[0], multi_pod)
    params = placed(fake[0], pspecs)
    if kind == "train":
        opt = {"m": placed(fake[1]["m"], pspecs),
               "v": placed(fake[1]["v"], pspecs),
               "step": placed(fake[1]["step"], P())}
        return params, opt, fake[2]
    if kind == "prefill":
        return params, fake[1]
    cspecs = _retarget_cache_specs(cache_specs(cfg, example[2], multi_pod),
                                   shd)
    return params, fake[1], placed(fake[2], cspecs), fake[3]


def _storages(x) -> dict:
    """{id: bytes} of the storages of the tensors of ``x`` (local
    shards of ``DTensor`` s)."""
    return {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in _tensors(x)}


def step_cost(cfg: ArchConfig, cell: ShapeCell, mesh, perf: PerfConfig,
              multi_pod: bool = False, dtype=torch.bfloat16) -> StepRun:
    """Build the cell's step with ``make_train_step`` /
    ``make_prefill_step`` / ``make_decode_step`` on ``device="cpu"`` and
    run it once on fake tensors under :class:`CostCounter`: one rank's
    direct count, with the memory it holds.

    ``memory``: ``argument_bytes``, the rank's shards of the inputs;
    ``output_bytes``, its shards of the outputs; ``alias_bytes``, the
    outputs that are inputs updated in place (parameters and moments,
    a decode's caches on one device); ``temp_bytes``, the rest of the
    peak of storages made during the run; ``peak_bytes_per_device`` =
    arguments + outputs + temporaries - aliases, the reference's sum.
    """
    import time
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, make_train_step)
    make = {"train": make_train_step, "prefill": make_prefill_step,
            "decode": make_decode_step}[cell.kind]
    t0 = time.perf_counter()
    fn, example = make(cfg, cell, mesh, perf=perf, multi_pod=multi_pod,
                       dtype=dtype, device="cpu")
    build_s = time.perf_counter() - t0
    tiny = cell.kind != "train" and cell.global_batch < 16
    shd = make_sharder(mesh, multi_pod, tiny_batch=tiny,
                       parallelism=perf.parallelism)
    with fake_mode():
        args = step_inputs(cell.kind, example, mesh, cfg, cell, multi_pod,
                           shd)
        held = _storages(args)
        with CostCounter(track_memory=True) as c:
            t0 = time.perf_counter()
            out = fn(*args)
            run_s = time.perf_counter() - t0
        made = _storages(out)
        alias = sum(n for k, n in made.items() if k in held)
        output = sum(made.values())
        new_out = output - alias
        temp = max(c.peak_bytes - new_out, 0)
        arg = sum(held.values())
        del out, args
    memory = {"argument_bytes": arg, "output_bytes": output,
              "temp_bytes": temp, "alias_bytes": alias,
              "peak_bytes_per_device": arg + output + temp - alias}
    coll = {**c.collectives, "total_wire_bytes": c.wire,
            "counts": dict(c.counts)}
    return StepRun(cost=c.result(), collectives=coll, memory=memory,
                   build_s=build_s, run_s=run_s)
