"""Plain PyTorch attention and its gradient: the flash kernels' oracle
and CPU version.

Layout convention: q [B, Sq, Hq, dh], k/v [B, Sk, Hkv, dh] with
Hq % Hkv == 0 (GQA).  Query positions are the LAST Sq positions of the
Sk-long key sequence (offset = Sk - Sq), the usual prefill/decode contract.

Masking: ``causal`` hides j > i; ``window`` (sliding-window attention)
additionally hides j <= i - window; ``kv_len`` hides j >= kv_len.
Softmax is computed in float32 regardless of input dtype, and a row with
no valid key gives 0, not NaN.
"""
from __future__ import annotations

import torch

NEG = -1e30


def attention_mask(sq: int, sk: int, *, causal: bool, window: int | None,
                   kv_len: int | None = None, device=None) -> torch.Tensor:
    """bool [sq, sk]; True = attend."""
    qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kj = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= kj <= qi
    if window is not None:
        m &= kj > qi - window
    if kv_len is not None:
        m &= kj < kv_len
    return m


def _attend(q, k, v, causal, window, scale, kv_len):
    """(out float32, masked scores, mask) of the plain attention."""
    B, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    rep = hq // hkv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else dh ** -0.5

    qf, kf, vf = q.float(), k.float(), v.float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mask = attention_mask(sq, sk, causal=causal, window=window,
                          kv_len=kv_len, device=q.device)
    scores = torch.where(mask[None, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    # rows with no valid key (fully masked) -> zero output, not NaN
    any_valid = mask.any(dim=-1)
    probs = torch.where(any_valid[None, None, :, None], probs, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out, scores, mask


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int | None = None,
        scale: float | None = None, kv_len: int | None = None
        ) -> torch.Tensor:
    return _attend(q, k, v, causal, window, scale, kv_len)[0].to(q.dtype)


def mha_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int | None = None,
            scale: float | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(:func:`mha` 's output in float32, each row's log-sum-exp of the
    scaled, masked scores [B, Hq, Sq]), the forward kernel's two
    results; +inf on a row with no visible key, as the kernel writes."""
    out, scores, mask = _attend(q, k, v, causal, window, scale, None)
    lse = torch.logsumexp(torch.where(mask[None, None], scores, -torch.inf),
                          dim=-1)
    return out, torch.where(mask.any(dim=-1)[None, None], lse, torch.inf)


def mha_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 d_out: torch.Tensor, *, causal: bool = True,
                 window: int | None = None, scale: float | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`mha` at (q, k, v) for the output gradient
    ``d_out``, by autograd through the plain version: the backward
    kernel's oracle."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = mha(*leaves, causal=causal, window=window, scale=scale)
        return torch.autograd.grad(out, leaves, d_out.to(out.dtype))
