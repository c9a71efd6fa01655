"""GQA attention: train/prefill through the flash kernel, and decode.

Full-sequence attention (``attn_train``, ``prefill_into_cache``) is one
call to :func:`repro_torch.kernels.flash_attention.ops.mha`, which
launches the hand-written CUDA kernel on the card.  The reference
computes the same function with a materialised softmax or a kv-chunked
online softmax (``chunk``, a memory knob of XLA's); the kernel streams
K/V tiles in either case, so ``chunk`` is accepted and changes nothing.

Sliding-window attention uses a ring-buffer cache of window size W with an
explicit per-slot position vector, so decode holds O(W) state.  The port
updates a cache in place and returns the same dict.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models import rope as rope_mod
from repro_torch.models.layers import (NOSHARD, Sharder, dense_init,
                                       init_device)

NEG = -1e30


def attn_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
              d_model: int = 0, *, device=None) -> dict:
    d = d_model or cfg.d_model
    dh = cfg.head_dim
    dev = init_device(gen, device)
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * dh, dtype, device=dev),
        "wk": dense_init(gen, d, cfg.n_kv_heads * dh, dtype, device=dev),
        "wv": dense_init(gen, d, cfg.n_kv_heads * dh, dtype, device=dev),
        "wo": dense_init(gen, cfg.n_heads * dh, d, dtype,
                         scale=(cfg.n_heads * dh) ** -0.5, device=dev),
    }
    if cfg.qkv_bias:
        zeros = lambda n: torch.zeros((n,), dtype=dtype, device=dev)
        p["bq"] = zeros(cfg.n_heads * dh)
        p["bk"] = zeros(cfg.n_kv_heads * dh)
        p["bv"] = zeros(cfg.n_kv_heads * dh)
    return p


def _project_qkv(params, x, cfg: ArchConfig, shd: Sharder):
    B, S, _ = x.shape
    dh = cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = shd.btf(q).reshape(B, S, cfg.n_heads, dh)
    k = k.reshape(B, S, cfg.n_kv_heads, dh)
    v = v.reshape(B, S, cfg.n_kv_heads, dh)
    return q, k, v


def _rope(x, positions, cfg: ArchConfig):
    if cfg.mrope_sections is not None:
        pos3 = positions if positions.dim() == 3 \
            else rope_mod.text_positions3(positions)
        return rope_mod.apply_mrope(x, pos3, cfg.mrope_sections,
                                    cfg.rope_theta)
    return rope_mod.apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# full-sequence attention (train forward / prefill)
# ---------------------------------------------------------------------------

def attn_train(params, x, positions, cfg: ArchConfig, shd: Sharder = NOSHARD,
               *, causal: bool = True, chunk: Optional[int] = None,
               d_model: int = 0):
    """Full-sequence attention; returns [B, S, d].  Forward only.

    ``d_model`` is the reference's, accepted for its signature: the
    projections' shapes carry the width."""
    q, k, v = _project_qkv(params, x, cfg, shd)
    q = _rope(q, positions, cfg)
    k = _rope(k, positions, cfg)
    out = flash.mha(q, k, v, causal=causal, window=cfg.sliding_window)
    B, S = x.shape[:2]
    out = out.reshape(B, S, -1) @ params["wo"]
    return shd.btd(out)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.float32, quantized: bool = False,
               device=None) -> dict:
    """Ring buffer of W = sliding_window if set, else max_seq.

    quantized=True stores K/V as int8 with per-(token, head) symmetric
    scales (KIVI-style): the scales factor exactly out of both attention
    contractions, so the only approximation is the int8 rounding itself.
    """
    W = min(cfg.sliding_window or max_seq, max_seq)
    shape = (batch, W, cfg.n_kv_heads, cfg.head_dim)
    slot_pos = torch.full((W,), -1, dtype=torch.int32, device=device)
    if quantized:
        return {
            "k_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            "v_s": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            "slot_pos": slot_pos,
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": slot_pos,
    }


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, h, dh] -> (int8 values, f32 per-(token, head) scales)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def prefill_into_cache(params, x, positions, cfg: ArchConfig,
                       shd: Sharder = NOSHARD, cache: Optional[dict] = None,
                       chunk: Optional[int] = None):
    """Causal attention over the prompt; fills ``cache`` in place.

    Returns (out, cache).
    """
    q, k, v = _project_qkv(params, x, cfg, shd)
    q = _rope(q, positions, cfg)
    k = _rope(k, positions, cfg)
    out = flash.mha(q, k, v, causal=True, window=cfg.sliding_window)
    B, S = x.shape[:2]
    if cache is not None:
        if "k_q" in cache:
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            store = {"k_q": kq, "v_q": vq, "k_s": ks, "v_s": vs}
        else:
            store = {"k": k, "v": v}
        W = cache["slot_pos"].shape[0]
        if S >= W:
            # keep the last W keys in ring layout: slot i <- position p,
            # p % W == i (prefill positions are contiguous, so this is a
            # permutation of the tail slice)
            last_pos = positions[0, S - W:].to(torch.int32)      # [W]
            slots = (last_pos % W).long()
            for key, val in store.items():
                cache[key][:, slots] = shd.kv_cache(
                    val[:, S - W:].to(cache[key].dtype))
            cache["slot_pos"].fill_(-1)
            cache["slot_pos"][slots] = last_pos
        else:
            # prompt shorter than the window: slots [0, S) in order
            for key, val in store.items():
                cache[key].zero_()
                cache[key][:, :S] = shd.kv_cache(val.to(cache[key].dtype))
            cache["slot_pos"][:S] = positions[0].to(torch.int32)
    out = out.reshape(B, S, -1) @ params["wo"]
    return shd.btd(out), cache


def attn_decode(params, x, cache: dict, pos: int, cfg: ArchConfig,
                shd: Sharder = NOSHARD):
    """One-token step. x: [B, 1, d]; pos: int (shared by the batch).

    Plain PyTorch, as the reference computes it outside any kernel.
    Writes the new key and value into ``cache`` in place and returns
    (out [B, 1, d], cache).
    """
    B = x.shape[0]
    dh = cfg.head_dim
    q, k, v = _project_qkv(params, x, cfg, shd)
    pos = int(pos)
    pos_b = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = _rope(q, pos_b, cfg)
    k = _rope(k, pos_b, cfg)

    W = cache["slot_pos"].shape[0]
    slot = pos % W
    spos = cache["slot_pos"]
    spos[slot] = pos

    hkv = cfg.n_kv_heads
    rep = cfg.n_heads // hkv
    qf = q.reshape(B, hkv, rep, dh)
    quant = "k_q" in cache
    if quant:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        cache["k_q"][:, slot] = kq[:, 0]
        cache["v_q"][:, slot] = vq[:, 0]
        cache["k_s"][:, slot] = ks[:, 0]
        cache["v_s"][:, slot] = vs[:, 0]
        ck, cv = cache["k_q"], cache["v_q"]
        # the reference contracts in bf16 with f32 accumulation: bf16
        # products are exact in f32, so round q to bf16 and multiply in f32
        s = torch.einsum("bhrd,bkhd->bhrk",
                         qf.to(torch.bfloat16).float(), ck.float())
        # the per-token scale factors exactly out of the contraction
        s = s * cache["k_s"].movedim(1, 2)[:, :, None] * dh ** -0.5
    else:
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        ck, cv = cache["k"], cache["v"]
        s = torch.einsum("bhrd,bkhd->bhrk", qf.float(), ck.float()) \
            * dh ** -0.5

    valid = (spos >= 0) & (spos <= pos)
    if cfg.sliding_window is not None:
        valid &= spos > pos - cfg.sliding_window
    s = torch.where(valid[None, None, None], s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid[None, None, None], p, 0.0)
    if quant:
        pv = p * cache["v_s"].movedim(1, 2)[:, :, None]    # fold v scales
        out = torch.einsum("bhrk,bkhd->bhrd",
                           pv.to(torch.bfloat16).float(), cv.float())
    else:
        out = torch.einsum("bhrk,bkhd->bhrd", p.to(cv.dtype),
                           cv).float()
    out = out / p.sum(dim=-1, keepdim=True)
    out = out.reshape(B, 1, cfg.n_heads * dh).to(x.dtype) @ params["wo"]
    return shd.btd(out), cache
