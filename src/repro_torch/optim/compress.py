"""Gradient compression: int8 error-feedback quantization (the port of
the reference's ``optim/compress.py``).

``ef_compress``/``ef_decompress`` are per-tensor symmetric int8 with an
error-feedback residual (Seide et al. / EF-SGD): the quantization error
is carried to the next step, so the compression bias vanishes over time.
Both packages round half to even.

:func:`compressed_psum` is the wire-level path: the int8 payload (4x
smaller than f32) is what crosses the data axis, summed as int32, with
one shared f32 scale agreed first (a MAX all-reduce of one scalar).
It runs on every rank of a ``torch.distributed`` group, the collective
counterpart of the reference's ``shard_map`` body.
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


def compressed_psum(x: torch.Tensor, residual: torch.Tensor, axis, *,
                    mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean over the ranks of ``axis`` with int8 payload + error feedback:
    (mean, new_residual), the reference's operations in its order.

    ``axis`` is a mesh dimension's name (with ``mesh=`` its
    ``DeviceMesh``) or a process group; every rank of it calls this with
    its own ``x`` and ``residual``.  A SHARED scale is agreed first (the
    MAX of one scalar) so the summed int8 payloads are commensurable;
    the payload's sum itself carries int32.
    """
    import torch.distributed as dist
    group = axis
    if isinstance(axis, str):
        if mesh is None:
            raise TypeError(f"axis {axis!r} names a mesh dimension: pass "
                            "the DeviceMesh as mesh=")
        group = mesh.get_group(axis)
    gf = x.float() + residual
    local_max = torch.max(torch.abs(gf))
    dist.all_reduce(local_max, op=dist.ReduceOp.MAX, group=group)
    scale = local_max / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_res = gf - q.float() * scale
    n = dist.get_world_size(group)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    mean = qsum.float() * scale / n
    return mean, new_res
