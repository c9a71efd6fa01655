"""Shared layers: norms, projections, SwiGLU MLP, embeddings, Sharder.

The port's counterpart of the reference's ``models/layers.py``.  Weights
are made with a ``torch.Generator`` on the generator's device.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Sharder: the reference's sharding hooks, identities on one card
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharder:
    """The reference's activation-sharding hooks as identities.

    The reference constrains layouts on a device mesh; the port runs on
    one card until ``parallel/`` is ported, so every hook returns its
    argument.
    """

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

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float | None = None
               ) -> torch.Tensor:
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


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
                dtype=torch.float32) -> dict:
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype),
        "w_up": dense_init(gen, d, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d, dtype),
    }


def swiglu(params: dict, x: torch.Tensor, shd: Sharder = NOSHARD
           ) -> torch.Tensor:
    g = shd.btf(x @ params["w_gate"])
    u = shd.btf(x @ params["w_up"])
    h = F.silu(g) * u
    return shd.btd(h @ params["w_down"])


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int,
                  dtype=torch.float32) -> dict:
    return {
        "w_up": dense_init(gen, d, d_ff, dtype),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=gen.device),
        "w_down": dense_init(gen, d_ff, d, dtype),
        "b_down": torch.zeros((d,), dtype=dtype, device=gen.device),
    }


def gelu_mlp(params: dict, x: torch.Tensor, shd: Sharder = NOSHARD
             ) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = shd.btf(F.gelu(x @ params["w_up"] + params["b_up"],
                       approximate="tanh"))
    return shd.btd(h @ params["w_down"] + params["b_down"])
