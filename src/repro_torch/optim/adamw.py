"""AdamW with float32 moments over float32 or bfloat16 params, and a
global-norm clip (the port of the reference's ``optim/adamw.py``).

The arithmetic is the reference's, in float32: the learning rate is
``schedule`` of the float32 step, the clip scale and both bias
corrections are float32 scalars, and the moments are float32, or bfloat16
under ``moments_dtype=torch.bfloat16`` (``PerfConfig.opt_moments =
"bf16"``).  Plain PyTorch operations on the parameters' device (the
reference has no kernel here).  :func:`adamw_update` writes the new
parameters and moments into the tensors it is given and returns them.

Weight decay goes where the reference puts it: on a leaf of rank 2 or
more in the reference's pytree.  The reference stacks a layer stack's
leaves on a leading layer axis, so its "matrices only" rule also decays
every per-layer norm weight and bias ([L, d] there); the port keeps a
stack as a list of per-layer dicts, and counts that list as the axis.
The final norm and the hybrid's shared block are not stacked and not
decayed, in both.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moments_dtype: Any = torch.float32   # bfloat16 halves optimizer memory


def adamw_init(params: Any, cfg: AdamWConfig = AdamWConfig()) -> dict:
    """Zero moments shaped as ``params`` (on each leaf's device, ``"meta"``
    included) and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moments_dtype, device=p.device)
    first = tree.leaves(params)
    dev = first[0].device if first else torch.device("cpu")
    return {"m": tree.map_(zeros, params), "v": tree.map_(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup, then a cosine to ``min_lr_frac`` of ``lr``, in
    float32 as the reference computes it (``step`` a float32 scalar)."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (summed leaf by leaf, in the tree's order; the reference's is sorted
    by key)."""
    total = 0
    for g in tree.leaves(grads):
        total = total + torch.sum(g.float() ** 2)
    return torch.sqrt(_f32(total) if isinstance(total, int) else total)


def _reference_rank(key: str, p: torch.Tensor) -> int:
    """The rank of leaf ``key`` in the reference's pytree: its own dims
    plus one for every list index in its path (a layer stack)."""
    return p.dim() + sum(part.isdigit() for part in key.split("/"))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig
                 ) -> tuple[Any, dict, dict]:
    """Returns (params', state', metrics {"grad_norm", "lr"}), params' and
    the moments being the given tensors, updated in place."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    stepf = step.float()
    lr = schedule(stepf, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(_f32(b1).to(stepf.device), stepf)
    bc2 = 1 - torch.pow(_f32(b2).to(stepf.device), stepf)

    def upd(p, g, m, v, rank):
        gf = g.float() * scale
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if rank >= 2:         # the reference's "matrices only" rule
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(mf.to(m.dtype))
        v.copy_(vf.to(v.dtype))

    g, m, v = (dict(tree.paths(t)) for t in (grads, state["m"], state["v"]))
    for key, p in tree.paths(params):
        upd(p, g[key], m[key], v[key], _reference_rank(key, p))
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
