"""Gradient compression: int8 error-feedback quantization (the port of
the reference's ``optim/compress.py``).

``ef_compress``/``ef_decompress`` are per-tensor symmetric int8 with an
error-feedback residual (Seide et al. / EF-SGD): the quantization error
is carried to the next step, so the compression bias vanishes over time.
Both packages round half to even.  The reference's ``compressed_psum``
(the int8 payload over a data axis across devices) waits for the model
half of ``parallel/``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree


def ef_compress(g: torch.Tensor, residual: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q int8, scale f32 scalar, new_residual)."""
    gf = g.float() + residual
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_residual = gf - q.float() * scale
    return q, scale, new_residual


def ef_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Any, residuals: Any) -> tuple[Any, Any, Any]:
    """``ef_compress`` of every leaf: (q tree, scale tree, residual
    tree)."""
    out = [ef_compress(g, r) for g, r in zip(tree.leaves(grads),
                                               tree.leaves(residuals))]

    def part(i):
        it = iter(o[i] for o in out)
        return tree.map_(lambda _: next(it), grads)
    return part(0), part(1), part(2)


def init_residuals(params: Any) -> Any:
    return tree.map_(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
