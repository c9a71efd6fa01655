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

Under tensor parallelism (``shd.tp``, ``parallel/tensor_parallel.py``)
a rank projects its own query heads and the KV heads they read, runs the
flash kernel on them and sums its partial ``wo`` product over ``model``.
Its cache holds every KV head for its own range of the sequence slots
(the reference's ``kv_cache`` layout): prefill writes that range, and a
decode step scores the rank's slots for every query head, reducing the
softmax's max and sums over the cache's ``seq`` ranks (flash decoding).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models import rope as rope_mod
from repro_torch.models.layers import (NOSHARD, Sharder, dense_init,
                                       init_device)
from repro_torch.parallel.tensor_parallel import (copy_to_model,
                                                  reduce_from_model)

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


def _project_qkv(params, x, cfg: ArchConfig, shd: Sharder,
                 whole: bool = False):
    """q, k, v [B, S, heads, dh]: every head, or under tensor
    parallelism the rank's query heads and the KV heads of
    ``TensorParallel.kv_cols`` (every KV head with ``whole`` where the
    weights are gathered whole)."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    tp = shd.tp
    wq, wk, wv = params["wq"], params["wk"], params["wv"]
    if tp is not None:
        x = copy_to_model(x, tp)
        wq = tp.q_cols(wq, cfg)
        wk, wv = tp.kv_cols(wk, cfg, whole), tp.kv_cols(wv, cfg, whole)
    q = x @ wq
    k = x @ wk
    v = x @ wv
    if cfg.qkv_bias:
        bq, bk, bv = params["bq"], params["bk"], params["bv"]
        if tp is not None:
            bq = tp.q_cols(bq, cfg)
            bk, bv = tp.kv_cols(bk, cfg, whole), tp.kv_cols(bv, cfg, whole)
        q = q + bq
        k = k + bk
        v = v + bv
    q = shd.btf(q).reshape(B, S, -1, dh)
    k = k.reshape(B, S, -1, dh)
    v = v.reshape(B, S, -1, dh)
    return q, k, v


def _out_proj(params, out, cfg: ArchConfig, shd: Sharder):
    """``out`` [B, S, heads·dh] through ``wo``: under tensor parallelism
    the rank's rows, the partial products summed over ``model``."""
    if shd.tp is None:
        return shd.btd(out @ params["wo"])
    return shd.btd(reduce_from_model(out @ shd.tp.q_rows(params["wo"], cfg),
                                     shd.tp))


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
    if shd.tp is not None:
        k, v = shd.tp.attn_kv(k, cfg), shd.tp.attn_kv(v, cfg)
    out = flash.mha(q, k, v, causal=causal, window=cfg.sliding_window)
    B, S = x.shape[:2]
    return _out_proj(params, out.reshape(B, S, -1), cfg, shd)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.float32, quantized: bool = False,
               device=None, shd: Sharder = NOSHARD) -> dict:
    """Ring buffer of W = sliding_window if set, else max_seq.

    quantized=True stores K/V as int8 with per-(token, head) symmetric
    scales (KIVI-style): the scales factor exactly out of both attention
    contractions, so the only approximation is the int8 rounding itself.
    Under tensor parallelism K/V hold the rank's range of the W slots
    (``TensorParallel.slots``); ``slot_pos`` holds all W.
    """
    W = min(cfg.sliding_window or max_seq, max_seq)
    s0, s1 = (0, W) if shd.tp is None else shd.tp.slots(W)
    shape = (batch, s1 - s0, cfg.n_kv_heads, cfg.head_dim)
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


def _slots(cache: dict, shd: Sharder) -> tuple[int, int]:
    """The range of the W slots that ``cache`` 's K/V hold."""
    W = cache["slot_pos"].shape[0]
    return (0, W) if shd.tp is None else shd.tp.slots(W)


def prefill_into_cache(params, x, positions, cfg: ArchConfig,
                       shd: Sharder = NOSHARD, cache: Optional[dict] = None,
                       chunk: Optional[int] = None):
    """Causal attention over the prompt; fills ``cache`` in place.

    Returns (out, cache).
    """
    tp = shd.tp
    q, k, v = _project_qkv(params, x, cfg, shd, whole=cache is not None)
    q = _rope(q, positions, cfg)
    k = _rope(k, positions, cfg)
    if tp is None:
        out = flash.mha(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        out = flash.mha(q, tp.attn_kv(k, cfg), tp.attn_kv(v, cfg),
                        causal=True, window=cfg.sliding_window)
        if cache is not None:
            k, v = tp.kv_all(k, cfg), tp.kv_all(v, cfg)
    B, S = x.shape[:2]
    if cache is not None:
        if "k_q" in cache:
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            store = {"k_q": kq, "v_q": vq, "k_s": ks, "v_s": vs}
        else:
            store = {"k": k, "v": v}
        W = cache["slot_pos"].shape[0]
        s0, s1 = _slots(cache, shd)
        if S >= W:
            # keep the last W keys in ring layout: slot i <- position p,
            # p % W == i (prefill positions are contiguous, so this is a
            # permutation of the tail slice); the cache holds slots
            # [s0, s1)
            last_pos = positions[0, S - W:].to(torch.int32)      # [W]
            slots = (last_pos % W).long()
            src = torch.empty_like(slots)
            src[slots] = torch.arange(S - W, S, device=slots.device)
            for key, val in store.items():
                cache[key].copy_(shd.kv_cache(
                    val[:, src[s0:s1]].to(cache[key].dtype)))
            cache["slot_pos"].fill_(-1)
            cache["slot_pos"][slots] = last_pos
        else:
            # prompt shorter than the window: slots [0, S) in order
            n = max(min(s1, S) - s0, 0)
            for key, val in store.items():
                cache[key].zero_()
                cache[key][:, :n] = shd.kv_cache(
                    val[:, s0:s0 + n].to(cache[key].dtype))
            cache["slot_pos"][:S] = positions[0].to(torch.int32)
    return _out_proj(params, out.reshape(B, S, -1), cfg, shd), cache


def attn_decode(params, x, cache: dict, pos: int, cfg: ArchConfig,
                shd: Sharder = NOSHARD):
    """One-token step. x: [B, 1, d]; pos: int (shared by the batch).

    Plain PyTorch, as the reference computes it outside any kernel.
    Writes the new key and value into ``cache`` in place and returns
    (out [B, 1, d], cache).  Under tensor parallelism the query heads
    and the new key and value are gathered over ``model``, the rank that
    holds slot ``pos % W`` writes it, and each rank scores its slots for
    every head: the softmax's max, then its sums Σp and Σp·v, reduce
    over the cache's ``seq`` ranks before the rank's heads go through
    its rows of ``wo``.
    """
    B = x.shape[0]
    dh = cfg.head_dim
    tp = shd.tp
    q, k, v = _project_qkv(params, x, cfg, shd, whole=True)
    pos = int(pos)
    pos_b = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = _rope(q, pos_b, cfg)
    k = _rope(k, pos_b, cfg)
    if tp is not None:
        q = tp.all_gather(q, 2, cfg.n_heads)
        k, v = tp.kv_all(k, cfg), tp.kv_all(v, cfg)

    W = cache["slot_pos"].shape[0]
    slot = pos % W
    spos = cache["slot_pos"]
    spos[slot] = pos
    s0, s1 = _slots(cache, shd)
    own = s0 <= slot < s1
    spos = spos[s0:s1]

    hkv = cfg.n_kv_heads
    rep = cfg.n_heads // hkv
    qf = q.reshape(B, hkv, rep, dh)
    quant = "k_q" in cache
    if quant:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        if own:
            cache["k_q"][:, slot - s0] = kq[:, 0]
            cache["v_q"][:, slot - s0] = vq[:, 0]
            cache["k_s"][:, slot - s0] = ks[:, 0]
            cache["v_s"][:, slot - s0] = vs[:, 0]
        ck, cv = cache["k_q"], cache["v_q"]
        # the reference contracts in bf16 with f32 accumulation: bf16
        # products are exact in f32, so round q to bf16 and multiply in f32
        s = torch.einsum("bhrd,bkhd->bhrk",
                         qf.to(torch.bfloat16).float(), ck.float())
        # the per-token scale factors exactly out of the contraction
        s = s * cache["k_s"].movedim(1, 2)[:, :, None] * dh ** -0.5
    else:
        if own:
            cache["k"][:, slot - s0] = k[:, 0]
            cache["v"][:, slot - s0] = v[:, 0]
        ck, cv = cache["k"], cache["v"]
        s = torch.einsum("bhrd,bkhd->bhrk", qf.float(), ck.float()) \
            * dh ** -0.5

    valid = (spos >= 0) & (spos <= pos)
    if cfg.sliding_window is not None:
        valid &= spos > pos - cfg.sliding_window
    s = torch.where(valid[None, None, None], s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    if tp is not None:
        m = tp.all_reduce(m, "max", seq=True)
    p = torch.exp(s - m)
    p = torch.where(valid[None, None, None], p, 0.0)
    if quant:
        pv = p * cache["v_s"].movedim(1, 2)[:, :, None]    # fold v scales
        out = torch.einsum("bhrk,bkhd->bhrd",
                           pv.to(torch.bfloat16).float(), cv.float())
    else:
        out = torch.einsum("bhrk,bkhd->bhrd", p.to(cv.dtype),
                           cv).float()
    l = p.sum(dim=-1, keepdim=True)
    if tp is not None:
        # Σp·v and Σp over the sequence's ranks, in one collective
        both = tp.all_reduce(torch.cat([out, l], dim=-1), seq=True)
        out, l = both[..., :dh], both[..., dh:]
    out = (out / l).reshape(B, cfg.n_heads, dh)
    if tp is not None:
        h0, h1 = tp.heads(cfg.n_heads)
        out = out[:, h0:h1]
    out = out.reshape(B, 1, -1).to(x.dtype)
    return _out_proj(params, out, cfg, shd), cache
