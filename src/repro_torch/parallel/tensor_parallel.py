"""Tensor parallelism over the mesh axis ``model`` (Megatron-style), the
compute half of the reference's 2D sharding.

The reference states layouts and lets XLA's partitioner derive the
program: attention heads and ``d_ff`` over ``model`` (``Sharder.bthd``,
``btf``), logits over the vocabulary (``btv``, ``bv``), decode caches
over the sequence (``kv_cache``, the flash-decoding layout).  PyTorch has
no partitioner, so the port writes that program out.  Each rank holds
its ``model`` shard of every split weight as a plain tensor (the step
builders gather the data axes only) and runs the model on its own heads,
``d_ff`` columns and vocabulary rows, with collectives over the
``model`` process group of the ``DeviceMesh``:

- :func:`copy_to_model` (identity forward, all-reduce backward) where a
  replicated activation enters a column-parallel product, and
  :func:`reduce_from_model` (all-reduce forward, identity backward)
  after a row-parallel one: Megatron's conjugate pair, as
  ``torch.autograd.Function`` s;
- the vocabulary-parallel embedding (rows outside the shard give 0,
  then reduce), cross-entropy (max, then the sum of exponentials, then
  the target logit, each reduced) and greedy tokens;
- in decode, the cache's sequence is split over ``seq`` ranks (``model``,
  or the whole mesh for a tiny batch): each rank scores its own slots
  for every head, and the softmax's max and sums reduce over them.

Heads split into contiguous ranges with ``torch.chunk`` semantics, the
way ``DTensor`` splits a dimension.  A ``Shard`` of a head-structured
weight lines up with a rank's heads where the head count divides by the
``model`` size; where it does not (phi3-medium's 40 heads over 16
ranks), or where a rank's query heads read KV heads outside its own
``wk``/``wv`` shard (fewer KV heads than ranks), the step gathers that
weight whole over ``model`` and each rank slices what its heads need
(:func:`layout`); its gradient is then a partial sum over ``model``
that reduce-scatters back to the storage shard.

The moe, ssm and hybrid families split the same way, as the
reference's specs place their weights: a rank runs its ``E / m``
experts (the router, replicated, routes every token on every rank) and
MLA on its heads; a Mamba layer runs its ``d_inner`` channels, whose
conv and scan do not depend on the others, and sums over ``model``
where a product contracts ``d_inner`` (:func:`sum_over_model`).  A
weight that the specs replicate over ``model`` but whose output feeds a
rank's own compute (the router's weights, MLA's ``wq_a``/``wkv_a``,
Mamba-2's ``in_proj_bc``/``in_proj_dt`` and per-head vectors) enters it
through :func:`copy_to_model`, so its gradient is whole and equal on
every rank.

Off ``model``, a MoE train step's load-balance loss needs the means of
the whole batch, which the data ranks split: :class:`DataParallel`
sums them over the data axes, forward and backward
(:func:`mean_over_data`).

Every collective is one of the functional collectives' operators
(``torch.ops._c10d_functional``, as ``DTensor`` issues them), which
``launch.costing.CostCounter`` counts and fake tensors pass through.
Gloo's ``all_gather_into_tensor`` of CUDA tensors crashes both ranks
(``tools/gloo_cuda_probe.py``), so on a gloo group a CUDA all-gather is
the all-reduce of the ranks' zero-padded blocks: the same values, since
a sum with zeros is exact.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

#: the functional collectives' operators (``torch.distributed.
#: _functional_collectives`` calls them; ``DTensor`` does too)
_c10d = torch.ops._c10d_functional

#: the families whose steps split their compute over ``model``
FAMILIES = ("dense", "encdec", "moe", "ssm", "hybrid")

#: attention weights by how their last (columns) or first (rows)
#: dimension splits: over the query heads, or the KV heads
Q_COLS = ("wq", "bq")
KV_COLS = ("wk", "wv", "bk", "bv")
Q_ROWS = ("wo",)
#: MLA's weights split by heads (``wq``/``wq_b``/``wkv_b`` columns,
#: ``wo`` rows)
MLA_HEADS = ("wq", "wq_b", "wkv_b", "wo")
#: a Mamba layer's weights split over ``d_inner``
SSM_CHANNELS = ("in_proj_x", "in_proj_z", "conv_w", "conv_b", "x_proj",
                "dt_proj", "dt_bias", "A_log", "D", "norm_w", "out_proj")


def _range(n: int, parts: int, index: int) -> tuple[int, int]:
    """``torch.chunk(range(n), parts)[index]`` as (start, stop); empty
    where ``torch.chunk`` gives fewer chunks than ``parts``."""
    size = -(-n // parts)
    start = min(index * size, n)
    return start, min(start + size, n)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A rank's place in the ``model`` group and in the decode cache's
    ``seq`` group, with the collectives over them."""
    group: Any          # the ``model`` process group
    rank: int
    size: int
    seq_group: Any      # the group the decode cache's sequence spans
    seq_rank: int
    seq_size: int

    # ------------------------------------------------------------ ranges
    def heads(self, n: int) -> tuple[int, int]:
        """This rank's contiguous range of ``n`` heads (or vocabulary
        rows, ``d_ff`` columns)."""
        return _range(n, self.size, self.rank)

    def slots(self, n: int) -> tuple[int, int]:
        """This rank's range of a cache's ``n`` sequence slots."""
        return _range(n, self.seq_size, self.seq_rank)

    def q_local(self, cfg) -> bool:
        """Whether the storage shards of ``wq``/``bq``/``wo`` are this
        rank's query heads."""
        return cfg.n_heads % self.size == 0

    def kv_local(self, cfg) -> bool:
        """Whether the storage shards of ``wk``/``wv``/``bk``/``bv`` are
        the KV heads this rank's query heads read."""
        return self.q_local(cfg) and cfg.n_kv_heads % self.size == 0

    def units(self, w: torch.Tensor, n: int, width: int, dim: int = -1,
              local: Optional[bool] = None) -> torch.Tensor:
        """This rank's heads (experts, Mamba-2 heads) of ``w``, whose
        dimension ``dim`` holds ``n`` of them, ``width`` entries each:
        ``w`` itself where it is the rank's storage shard (``local``, by
        default where ``n`` divides by the ``model`` size), else their
        slice of the weight gathered whole."""
        if local is None:
            local = n % self.size == 0
        if local:
            return w
        h0, h1 = self.heads(n)
        return w.narrow(dim, h0 * width, (h1 - h0) * width)

    def ssm_units(self, cfg) -> tuple[int, int]:
        """(the units a Mamba layer's ``d_inner`` splits in, channels a
        unit): the channels for Mamba-1, the heads for Mamba-2, whose
        per-head decay spans ``headdim`` channels."""
        din = cfg.ssm.expand * cfg.d_model
        if cfg.ssm.version == 1:
            return din, 1
        return din // cfg.ssm.headdim, cfg.ssm.headdim

    def ssm_local(self, cfg) -> bool:
        """Whether the storage shards of a Mamba layer's ``d_inner``
        weights are this rank's whole units (always for Mamba-1, whose
        unit is a channel)."""
        return cfg.ssm.version == 1 or \
            self.ssm_units(cfg)[0] % self.size == 0

    def ssm_channels(self, w: torch.Tensor, cfg, dim: int = -1
                     ) -> torch.Tensor:
        """This rank's ``d_inner`` channels of a Mamba weight."""
        n, width = self.ssm_units(cfg)
        return self.units(w, n, width, dim, self.ssm_local(cfg))

    def _same_split(self, cfg) -> bool:
        """Whether the ``seq`` ranks' split of the Mamba state's
        ``d_inner`` (the reference's ``ssm_state`` layout) is the
        ``model`` ranks' compute split: the same ranks, aligned shards.
        The same on every rank."""
        return self.seq_size == self.size and self.seq_rank == self.rank \
            and self.ssm_local(cfg)

    def state_to_cache(self, x: torch.Tensor, dim: int, cfg
                       ) -> torch.Tensor:
        """A Mamba state's ``d_inner`` dimension ``dim`` from this rank's
        compute channels to its cache slots (:meth:`slots` of
        ``d_inner``): itself where they are the same, else gathered over
        ``model`` and sliced (the tiny-batch layout on several data
        ranks)."""
        if self._same_split(cfg):
            return x
        n, width = self.ssm_units(cfg)
        whole = self._gather_units(x, dim, n, width, seq=False)
        s0, s1 = self.slots(n * width)
        return whole.narrow(dim, s0, s1 - s0)

    def state_from_cache(self, x: torch.Tensor, dim: int, cfg
                         ) -> torch.Tensor:
        """The inverse of :meth:`state_to_cache`: the cache slots
        gathered over the ``seq`` ranks and this rank's compute channels
        sliced."""
        if self._same_split(cfg):
            return x
        n, width = self.ssm_units(cfg)
        whole = self.all_gather(x, dim, n * width, seq=True)
        h0, h1 = self.heads(n)
        return whole.narrow(dim, h0 * width, (h1 - h0) * width)

    def _gather_units(self, x, dim, n, width, seq):
        shape = list(x.shape)
        unit = x.reshape(shape[:dim] + [shape[dim] // width, width]
                         + shape[dim + 1:])
        whole = self.all_gather(unit, dim, n, seq=seq)
        return whole.reshape(shape[:dim] + [n * width] + shape[dim + 1:])

    def kv_heads(self, cfg) -> tuple[int, int]:
        """The KV heads this rank's query heads read, as a range."""
        h0, h1 = self.heads(cfg.n_heads)
        rep = cfg.n_heads // cfg.n_kv_heads
        if h1 == h0:
            return h0 // rep, h0 // rep
        return h0 // rep, (h1 - 1) // rep + 1

    # ------------------------------------------------- weight selection
    def q_cols(self, w: torch.Tensor, cfg) -> torch.Tensor:
        """The columns of this rank's query heads of ``wq``/``bq`` (the
        storage shard, or a slice of the whole weight)."""
        if self.q_local(cfg):
            return w
        h0, h1 = self.heads(cfg.n_heads)
        dh = cfg.head_dim
        return w.narrow(-1, h0 * dh, (h1 - h0) * dh)

    def q_rows(self, w: torch.Tensor, cfg) -> torch.Tensor:
        """The rows of this rank's query heads of ``wo``."""
        if self.q_local(cfg):
            return w
        h0, h1 = self.heads(cfg.n_heads)
        dh = cfg.head_dim
        return w.narrow(0, h0 * dh, (h1 - h0) * dh)

    def kv_cols(self, w: torch.Tensor, cfg, whole: bool = False
                ) -> torch.Tensor:
        """The columns of ``wk``/``wv``/``bk``/``bv`` a rank projects:
        its storage shard where that holds the KV heads its query heads
        read; else, from the weight gathered whole, every KV head
        (``whole``, for a cache) or those its heads read."""
        if self.kv_local(cfg) or whole:
            return w
        k0, k1 = self.kv_heads(cfg)
        dh = cfg.head_dim
        return w.narrow(-1, k0 * dh, (k1 - k0) * dh)

    def attn_kv(self, k: torch.Tensor, cfg) -> torch.Tensor:
        """K or V [B, S, heads, dh], every KV head or those of
        :meth:`kv_cols`, as the flash kernel takes them for this rank's
        query heads: query head j reads KV head j // (Hq / Hkv).  Where
        the rank's heads split a KV head's group unevenly, each query
        head gets its own copy."""
        k0, k1 = self.kv_heads(cfg)
        if k.shape[2] == cfg.n_kv_heads:
            k = k.narrow(2, k0, k1 - k0)
        h0, h1 = self.heads(cfg.n_heads)
        rep = cfg.n_heads // cfg.n_kv_heads
        if k1 - k0 <= 1 or (h0 % rep == 0 and (h1 - h0) % rep == 0):
            return k
        idx = torch.tensor([h // rep - k0 for h in range(h0, h1)],
                           device=k.device)
        return k.index_select(2, idx)

    def kv_all(self, k: torch.Tensor, cfg) -> torch.Tensor:
        """K or V [B, S, heads, dh] of every KV head from the rank's
        projection (:meth:`kv_cols`): gathered over ``model`` from the
        ranks' shards, or as it is where it holds every head."""
        if k.shape[2] == cfg.n_kv_heads:
            return k
        return self.all_gather(k, 2, cfg.n_kv_heads)

    # ----------------------------------------------------- collectives
    def all_reduce(self, x: torch.Tensor, op: str = "sum",
                   seq: bool = False) -> torch.Tensor:
        group = self.seq_group if seq else self.group
        return _c10d.wait_tensor(_c10d.all_reduce(x.contiguous(), op,
                                                  group.group_name))

    def all_gather(self, x: torch.Tensor, dim: int, n: int,
                   seq: bool = False) -> torch.Tensor:
        """The ranks' blocks of a dimension of ``n`` in ``torch.chunk``
        ranges, concatenated in rank order along ``dim``: each rank's
        block padded to the chunk size, gathered, the padding cut.  Over
        the ``model`` ranks, or with ``seq`` the cache's ``seq`` ranks."""
        import torch.distributed as dist
        group, rank, parts = (self.seq_group, self.seq_rank, self.seq_size) \
            if seq else (self.group, self.rank, self.size)
        size = -(-n // parts)
        have = x.shape[dim]
        if have < size:
            pad = list(x.shape)
            pad[dim] = size - have
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        x = x.movedim(dim, 0).contiguous()
        if x.is_cuda and dist.get_backend(group) == "gloo":
            whole = x.new_zeros((parts * size,) + tuple(x.shape[1:]))
            whole[rank * size:(rank + 1) * size] = x
            out = self.all_reduce(whole, seq=seq)
        else:
            out = _c10d.wait_tensor(_c10d.all_gather_into_tensor(
                x, parts, group.group_name))
        return out[:n].movedim(0, dim)


def tensor_parallel(mesh, model_axes, seq_axes) -> Optional[TensorParallel]:
    """The ``model`` group of ``mesh`` (a ``DeviceMesh``), or ``None``
    where the sharder names no model axis or it has one rank.
    ``seq_axes`` is the decode cache's sequence axis: ``model``, or
    every axis of the mesh (the tiny-batch layout), whose group is the
    default one."""
    if model_axes is None:
        return None
    from repro_torch.parallel.sharding import axis_index
    rank, size = axis_index(mesh, model_axes)
    if size == 1:
        return None
    seq = (seq_axes,) if isinstance(seq_axes, str) else tuple(seq_axes)
    if seq == (model_axes,):
        seq_group, seq_rank, seq_size = mesh.get_group(model_axes), rank, \
            size
    elif sorted(seq) == sorted(mesh.mesh_dim_names):
        import torch.distributed as dist
        seq_group = dist.group.WORLD
        seq_rank, seq_size = axis_index(mesh, seq)
    else:
        raise ValueError(f"a decode cache over {seq_axes!r} is neither "
                         f"{model_axes!r} nor the whole mesh")
    return TensorParallel(group=mesh.get_group(model_axes), rank=rank,
                          size=size, seq_group=seq_group, seq_rank=seq_rank,
                          seq_size=seq_size)


# ---------------------------------------------------------------------------
# the conjugate pair
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBothWays(torch.autograd.Function):
    """An all-reduce (``comm.all_reduce``) forward and backward."""
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


def copy_to_model(x: torch.Tensor, tp: Optional[TensorParallel]
                  ) -> torch.Tensor:
    """``x`` entering a column-parallel product: the identity, whose
    gradient sums the ranks' partial gradients over ``model``."""
    return x if tp is None else _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: Optional[TensorParallel]
                      ) -> torch.Tensor:
    """The ranks' partial sums of a row-parallel product, summed over
    ``model``; the gradient passes through."""
    return x if tp is None else _ReduceFromModel.apply(x, tp)


def sum_over_model(x: torch.Tensor, tp: Optional[TensorParallel]
                   ) -> torch.Tensor:
    """The ranks' partial sums of a product that contracts the split
    dimension, whose whole result then feeds each rank's own compute:
    ``copy_to_model(reduce_from_model(x))``, an all-reduce forward and
    backward."""
    return x if tp is None else _SumBothWays.apply(x, tp)


# ---------------------------------------------------------------------------
# the data axes: the MoE load-balance loss's means
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataParallel:
    """The data axes a train step splits its batch over: one process
    group a mesh axis, and the product of their sizes."""
    groups: tuple
    size: int

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        for g in self.groups:
            x = _c10d.wait_tensor(_c10d.all_reduce(x.contiguous(), "sum",
                                                   g.group_name))
        return x


def data_parallel(mesh, data_axes) -> Optional[DataParallel]:
    """The data axes of ``mesh`` (a name or a tuple of names), or
    ``None`` where they have one rank."""
    from repro_torch.parallel.sharding import axis_index
    if data_axes is None:
        return None
    axes = (data_axes,) if isinstance(data_axes, str) else tuple(data_axes)
    size = axis_index(mesh, axes)[1]
    if size == 1:
        return None
    return DataParallel(groups=tuple(mesh.get_group(a) for a in axes),
                        size=size)


def mean_over_data(x: torch.Tensor, dp: Optional[DataParallel]
                   ) -> torch.Tensor:
    """The mean over the data ranks of each rank's ``x`` (a mean over
    its equal share of the batch): the whole batch's mean.  Its gradient
    is summed over the data ranks too, since the step averages their
    gradients: every rank's loss holds the same term, and its gradient
    reaches each rank's share of the batch whole."""
    if dp is None:
        return x
    return _SumBothWays.apply(x, dp) / dp.size


# ---------------------------------------------------------------------------
# the vocabulary split
# ---------------------------------------------------------------------------

def embed(w: torch.Tensor, tokens: torch.Tensor,
          tp: Optional[TensorParallel]) -> torch.Tensor:
    """``w[tokens]`` from this rank's rows of the embedding (all of it
    off tensor parallelism): tokens outside the rows give 0, and the
    ranks' lookups sum over ``model``."""
    if tp is None:
        # embedding(): its gradient on the card sums each row's repeats
        # in a fixed order (a training step must repeat bit for bit)
        return torch.nn.functional.embedding(tokens, w)
    n = w.shape[0]
    local = tokens - _first_row(n, tp)
    inside = (local >= 0) & (local < n)
    x = torch.nn.functional.embedding(local.clamp(0, n - 1), w)
    return reduce_from_model(x * inside[..., None].to(x.dtype), tp)


def _first_row(n: int, tp: TensorParallel) -> int:
    """The first vocabulary row of a rank's ``n``: the vocabulary is
    padded to a multiple of 256 (``models.model.vocab_padded``), so
    every rank of a ``model`` axis that divides it holds ``n``."""
    return tp.rank * n


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  tp: Optional[TensorParallel]) -> torch.Tensor:
    """Per-token ``logsumexp(logits) - logits[label]`` in float32 over
    the whole vocabulary, from this rank's columns of the logits: the
    max, the sum of exponentials and the target logit, each reduced
    over ``model``.  The padded vocabulary's rows count as real ones."""
    lf = logits.float()
    if tp is None:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
        return lse - gold
    n = lf.shape[-1]
    m = tp.all_reduce(lf.detach().amax(dim=-1), "max")
    sumexp = reduce_from_model(torch.exp(lf - m[..., None]).sum(dim=-1), tp)
    local = labels.long() - _first_row(n, tp)
    inside = (local >= 0) & (local < n)
    picked = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = reduce_from_model(torch.where(inside, picked, 0.0), tp)
    return m + torch.log(sumexp) - gold


def greedy(logits) -> Any:
    """The greedy tokens [B, 1] (int32) of a step's logits, a ``DTensor``
    [B, V] placed by ``P(data, "model")`` (``launch.steps``), placed by
    ``P(data, None)`` as the decode step takes them: each rank's
    (max, index) pairs over its vocabulary columns gathered over
    ``model`` and the largest taken, a tie going to the lowest index (as
    ``argmax`` breaks them)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = logits.device_mesh
    tp = tensor_parallel(mesh, "model", "model")
    local = logits.to_local()
    if tp is None:
        tokens = local.argmax(dim=-1)
    else:
        best, idx = local.float().max(dim=-1)
        idx = idx + _first_row(local.shape[-1], tp)
        pairs = tp.all_gather(torch.stack([best, idx.float()], -1)[:, None],
                              1, tp.size)
        # among the ranks with the largest value the lowest, whose
        # vocabulary rows come first
        win = pairs[..., 0].argmax(dim=-1, keepdim=True)
        tokens = torch.gather(pairs[..., 1], -1, win)[:, 0]
    pl = list(logits.placements)
    pl[mesh.mesh_dim_names.index("model")] = Replicate()
    return DTensor.from_local(tokens[:, None].to(torch.int32), mesh, pl,
                              run_check=False, shape=(logits.shape[0], 1),
                              stride=(1, 1))


def _aligned(cfg, keys, tp: TensorParallel) -> bool:
    """Whether the ``model`` shard of the weight at ``keys`` holds whole
    units of what a rank computes on: heads, experts, Mamba-2 heads."""
    name = keys[-1]
    if "experts" in keys:
        return cfg.moe.n_routed % tp.size == 0
    if "ssm" in keys and name in SSM_CHANNELS:
        return tp.ssm_local(cfg)
    if name in Q_COLS + Q_ROWS + MLA_HEADS:
        return tp.q_local(cfg)
    if name in KV_COLS:
        return tp.kv_local(cfg)
    return True


def layout(cfg, params: Any, pspecs: Any, tp: Optional[TensorParallel]
           ) -> Any:
    """How a step gathers each parameter of ``params`` (specs
    ``pspecs``): ``"shard"`` keeps its ``model`` shard (this rank's
    heads, experts, ``d_ff`` or ``d_inner`` columns, vocabulary rows),
    ``"whole"`` gathers it over ``model`` too (a weight whose shards do
    not line up with the ranks' heads, experts or Mamba-2 heads),
    ``"replicated"`` names no ``model`` axis."""
    from repro_torch.parallel.sharding import map_specs

    def one(keys, _, spec):
        names = [a for e in spec if e is not None
                 for a in ((e,) if isinstance(e, str) else e)]
        if "model" not in names:
            return "replicated"
        if tp is None or not _aligned(cfg, keys, tp):
            return "whole"
        return "shard"
    return map_specs(one, params, pspecs)


__all__ = ["DataParallel", "FAMILIES", "TensorParallel", "copy_to_model",
           "cross_entropy", "data_parallel", "embed", "greedy", "layout",
           "mean_over_data", "reduce_from_model", "sum_over_model",
           "tensor_parallel"]
