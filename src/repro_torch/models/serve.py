"""Serving path for the dense family: cache init, prefill, one-token decode.

Layer caches are stacked along a leading layer axis, as in the reference
(``caches["layers"]["k"]`` is [L, B, W, Hkv, dh]).  The reference's layer
``scan`` is a Python loop here; each layer works on views of the stacked
cache, so prefill and decode update the caches IN PLACE and return the
same dict.  Prefill and decode run their float32 matrix products
without TF32 (``layers.f32_matmul``), as ``model.forward`` does.

Decode contract: one new token per sequence and a shared position ``pos``
(a Python int).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import NOSHARD, Sharder, f32_matmul, swiglu
from repro_torch.models.model import (PerfConfig, _norm, embed_tokens,
                                      not_ported, positions_for)


def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                dtype=torch.float32, kv_quant: bool = False,
                device=None) -> dict:
    if cfg.family != "dense":
        raise not_ported(cfg.family)
    one = attn_mod.init_cache(cfg, batch, max_seq, dtype, quantized=kv_quant,
                              device=device)
    return {"layers": {k: a[None].repeat((cfg.n_layers,) + (1,) * a.dim())
                       for k, a in one.items()}}


def _layer(caches: dict, i: int) -> dict:
    """Views of layer ``i`` of the stacked caches (writes land in them)."""
    return {k: a[i] for k, a in caches.items()}


@torch.no_grad()
@f32_matmul()
def prefill(params: dict, batch: dict, cfg: ArchConfig,
            shd: Sharder = NOSHARD, perf: PerfConfig = PerfConfig(),
            max_seq: int = 0) -> tuple[torch.Tensor, dict]:
    """Prompt pass; returns (last-position logits [B, vocab_p], caches)."""
    if cfg.family != "dense":
        raise not_ported(cfg.family)
    B, S = batch["tokens"].shape
    max_seq = max_seq or S
    x = shd.btd(embed_tokens(params, batch, cfg))
    caches = init_caches(cfg, B, max_seq, x.dtype, kv_quant=perf.kv_quant,
                         device=x.device)
    positions = positions_for(B, S, x.device)
    for i, lp in enumerate(params["layers"]):
        h, _ = attn_mod.prefill_into_cache(
            lp["attn"], _norm(x, lp["ln1"], cfg), positions, cfg, shd,
            _layer(caches["layers"], i), chunk=perf.attn_chunk)
        x = x + h
        x = x + swiglu(lp["mlp"], _norm(x, lp["ln2"], cfg), shd)
    x = _norm(x[:, -1:], params["final_norm"], cfg)
    logits = shd.bv((x @ params["lm_head"])[:, 0])
    return logits, caches


@torch.no_grad()
@f32_matmul()
def decode_step(params: dict, tokens: torch.Tensor, caches: dict, pos: int,
                cfg: ArchConfig, shd: Sharder = NOSHARD
                ) -> tuple[torch.Tensor, dict]:
    """tokens [B, 1]; pos int. Returns (logits [B, vocab_p], caches)."""
    if cfg.family != "dense":
        raise not_ported(cfg.family)
    x = shd.btd(params["embed"][tokens])
    for i, lp in enumerate(params["layers"]):
        h, _ = attn_mod.attn_decode(
            lp["attn"], _norm(x, lp["ln1"], cfg), _layer(caches["layers"], i),
            pos, cfg, shd)
        x = x + h
        x = x + swiglu(lp["mlp"], _norm(x, lp["ln2"], cfg), shd)
    x = _norm(x, params["final_norm"], cfg)
    logits = shd.bv((x @ params["lm_head"])[:, 0])
    return logits, caches
