"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

M-RoPE splits the rotary half-dims into (temporal, height, width) sections,
each rotated by its own position stream.  For text tokens the three streams
coincide, so text-only behaviour equals standard RoPE.  Both use the
split-half layout (the first dh/2 dims pair with the last dh/2), as the
reference does.
"""
from __future__ import annotations

import torch


def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, dh] rotated by angles ang [B, S, dh/2]."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: [B, S, H, dh]; positions: [B, S] int -> same shape, rotated."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)       # [dh/2]
    ang = positions.float()[..., None] * freqs               # [B, S, dh/2]
    return _rotate(x, ang)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections: tuple,
                theta: float = 1e4) -> torch.Tensor:
    """x: [B, S, H, dh]; positions3: [3, B, S] (t, h, w streams).

    sections: per-stream counts of rotary half-dims, sum == dh // 2.
    """
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"mrope sections {sections} != dh/2 = {dh // 2}")
    freqs = rope_freqs(dh, theta, x.device)                  # [dh/2]
    # each half-dim's position stream, picked by Python-side slices: the
    # shapes never depend on a tensor's values, so the card never syncs
    # and fake tensors (a dry run) go through
    pos = positions3.float()
    B, S = pos.shape[1:]
    pos_per_dim = torch.cat([pos[i][..., None].expand(B, S, n)
                             for i, n in enumerate(sections)], dim=-1)
    ang = pos_per_dim * freqs                                # [B, S, dh/2]
    return _rotate(x, ang)


def text_positions3(positions: torch.Tensor) -> torch.Tensor:
    """[B, S] -> [3, B, S] with identical streams (text-only M-RoPE)."""
    return positions[None].expand((3,) + tuple(positions.shape))
