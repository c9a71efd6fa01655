"""Shared layers: norms, projections, SwiGLU MLP, embeddings, Sharder.

The port's counterpart of the reference's ``models/layers.py``.  Weights
are made with a ``torch.Generator`` on the generator's device, or on the
``device`` an init helper is given: ``"meta"`` builds every leaf's shape
and dtype with no memory (``launch.steps.params_sds``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.parallel.tensor_parallel import (copy_to_model,
                                                  reduce_from_model)


# ---------------------------------------------------------------------------
# Sharder: the reference's sharding hooks and axis names
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharder:
    """The reference's activation-sharding hooks, with its fields.

    Axis names: 'data' (DP/FSDP), 'model' (TP/EP/SP); 'pod' extends data.
    ``data_axes`` is the batch's shard axis (or axes), ``seq_axes`` the
    cache sequence's, ``model_axes`` by default (for tiny-batch cells the
    launcher sets ``data_axes=None`` and shards the sequence over the
    whole mesh).  ``mesh`` is the ``DeviceMesh`` the step builders place
    storage on (``launch.steps``), ``None`` off a mesh.

    The reference constrains activation layouts with these hooks and
    lets XLA split the compute.  The port writes the split out: ``tp``
    is the tensor-parallel context (``parallel.tensor_parallel.
    TensorParallel``) of a step on a mesh whose ``model`` axis has more
    than one rank, ``None`` otherwise.  With it the attention (GQA or
    MLA), MLP, experts, Mamba layers, embedding, head and loss run on the
    rank's heads, ``d_ff`` columns, experts, ``d_inner`` channels and
    vocabulary rows, the decode caches on its sequence slots; without it
    a rank runs the whole model on its batch rows.  The hooks return
    their argument: the layouts they name are what ``tp`` computes.
    ``dp`` (``tensor_parallel.DataParallel``) is a train step's data
    axes where they have several ranks: the MoE load-balance loss takes
    its means over the whole batch through it.
    """
    mesh: Any = None
    data_axes: Any = "data"
    model_axes: Any = "model"
    seq_axes: Any = None          # defaults to model_axes
    tp: Any = None
    dp: Any = None

    def __post_init__(self):
        if self.seq_axes is None:
            object.__setattr__(self, "seq_axes", self.model_axes)

    def btd(self, x):        # [batch, seq, d_model]
        return x

    def btf(self, x):        # [batch, seq, d_ff]
        return x

    def btv(self, x):        # logits [batch, seq, vocab]
        return x

    def bv(self, x):         # last-position logits [batch, vocab]
        return x

    def kv_cache(self, x):   # [batch, seq, kv_heads, head_dim]
        return x

    def latent_cache(self, x):  # MLA compressed cache [batch, seq, lora]
        return x

    def ssm_state(self, x):  # [batch, d_inner, state]
        return x

    def expert_buf(self, x):  # [groups, experts, capacity, d]
        return x


NOSHARD = Sharder()


@contextlib.contextmanager
def f32_matmul():
    """Full float32 matrix products inside the block (or the decorated
    function): cuBLAS may not round float32 operands to TF32, whose
    10-bit mantissa would move the logits by about 1e-3, beyond what the
    port is held to against the reference.  The caller's setting comes
    back on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def init_device(gen: torch.Generator, device=None) -> torch.device:
    """Where an init helper puts its leaves: ``device``, or by default
    the generator's device."""
    return gen.device if device is None else torch.device(device)


def randn(gen: torch.Generator, shape: tuple, device=None) -> torch.Tensor:
    """Standard normal float32 draws from ``gen`` on ``device``; on
    ``"meta"`` only the shape, with no draw."""
    dev = init_device(gen, device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=dev)
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float | None = None,
               device=None) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    return (randn(gen, (d_in, d_out), device) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    return (randn(gen, (vocab, d), device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms (computed in f32, cast back)
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# SwiGLU MLP (LLaMA-style); GELU MLP (whisper)
# ---------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, d: int, d_ff: int,
                dtype=torch.float32, device=None) -> dict:
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype, device=device),
        "w_up": dense_init(gen, d, d_ff, dtype, device=device),
        "w_down": dense_init(gen, d_ff, d, dtype, device=device),
    }


def swiglu(params: dict, x: torch.Tensor, shd: Sharder = NOSHARD,
           reduce: bool = True) -> torch.Tensor:
    """Column-parallel gate and up, row-parallel down: under tensor
    parallelism the weights are the rank's ``d_ff`` columns (rows of
    ``w_down``) and the partial outputs sum over ``model`` (or, without
    ``reduce``, are returned as this rank's partial sum)."""
    x = copy_to_model(x, shd.tp)
    g = shd.btf(x @ params["w_gate"])
    u = shd.btf(x @ params["w_up"])
    h = F.silu(g) * u
    y = h @ params["w_down"]
    return shd.btd(reduce_from_model(y, shd.tp) if reduce else y)


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int,
                  dtype=torch.float32, device=None) -> dict:
    dev = init_device(gen, device)
    return {
        "w_up": dense_init(gen, d, d_ff, dtype, device=dev),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=dev),
        "w_down": dense_init(gen, d_ff, d, dtype, device=dev),
        "b_down": torch.zeros((d,), dtype=dtype, device=dev),
    }


def gelu_mlp(params: dict, x: torch.Tensor, shd: Sharder = NOSHARD
             ) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    x = copy_to_model(x, shd.tp)
    h = shd.btf(F.gelu(x @ params["w_up"] + params["b_up"],
                       approximate="tanh"))
    # b_down is added once, after the ranks' partial sums
    y = h @ params["w_down"]
    if shd.tp is None:
        return shd.btd(y + params["b_down"])
    return shd.btd(reduce_from_model(y, shd.tp) + params["b_down"])
