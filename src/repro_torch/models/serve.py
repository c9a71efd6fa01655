"""Serving path: cache init, prefill, one-token decode for all families.

Layer caches are stacked along a leading layer axis, as in the reference
(``caches["layers"]["k"]`` is [L, B, W, Hkv, dh]; MLA's ``c_kv`` is
[L, B, S, kv_lora]; an SSM's ``h`` is [L, B, d_inner, N]; the hybrid's
``shared`` caches are stacked over its segments).  The reference's layer
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
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (NOSHARD, Sharder, f32_matmul,
                                       gelu_mlp, swiglu)
from repro_torch.models.model import (PerfConfig, _cross_attn, _cross_kv,
                                      _norm, embed_tokens, encode,
                                      n_segments, positions_for)


def _stack(one: dict, n: int) -> dict:
    return {k: a[None].repeat((n,) + (1,) * a.dim()) for k, a in one.items()}


def init_caches(cfg: ArchConfig, batch: int, max_seq: int,
                dtype=torch.float32, kv_quant: bool = False,
                device=None) -> dict:
    def attn_cache(quantized=False):
        return attn_mod.init_cache(cfg, batch, max_seq, dtype,
                                   quantized=quantized, device=device)
    if cfg.family == "dense":
        return {"layers": _stack(attn_cache(kv_quant), cfg.n_layers)}
    if cfg.family == "moe":
        one = mla_mod.init_cache(cfg, batch, max_seq, dtype, device)
        nd = cfg.moe.first_dense
        return {"dense_layers": _stack(one, nd),
                "layers": _stack(one, cfg.n_layers - nd)}
    if cfg.family in ("ssm", "hybrid"):
        c = {"layers": _stack(ssm_mod.init_state(cfg, batch, dtype, device),
                              cfg.n_layers)}
        if cfg.family == "hybrid":
            c["shared"] = _stack(attn_cache(), n_segments(cfg))
        return c
    if cfg.family == "encdec":
        cross = torch.zeros((cfg.n_layers, batch, cfg.enc_seq,
                             cfg.n_kv_heads, cfg.head_dim), dtype=dtype,
                            device=device)
        return {"layers": _stack(attn_cache(), cfg.n_layers),
                "cross_k": cross, "cross_v": torch.zeros_like(cross)}
    raise ValueError(cfg.family)


def _layer(caches: dict, i: int) -> dict:
    """Views of layer ``i`` of the stacked caches (writes land in them)."""
    return {k: a[i] for k, a in caches.items()}


# ===========================================================================
# prefill
# ===========================================================================

@torch.no_grad()
@f32_matmul()
def prefill(params: dict, batch: dict, cfg: ArchConfig,
            shd: Sharder = NOSHARD, perf: PerfConfig = PerfConfig(),
            max_seq: int = 0) -> tuple[torch.Tensor, dict]:
    """Prompt pass; returns (last-position logits [B, vocab_p], caches)."""
    B, S = batch["tokens"].shape
    max_seq = max_seq or S
    x = shd.btd(embed_tokens(params, batch, cfg))
    caches = init_caches(cfg, B, max_seq, x.dtype, kv_quant=perf.kv_quant,
                         device=x.device)
    positions = positions_for(B, S, x.device)
    chunk = perf.attn_chunk

    if cfg.family == "dense":
        for i, lp in enumerate(params["layers"]):
            h, _ = attn_mod.prefill_into_cache(
                lp["attn"], _norm(x, lp["ln1"], cfg), positions, cfg, shd,
                _layer(caches["layers"], i), chunk=chunk)
            x = x + h
            x = x + swiglu(lp["mlp"], _norm(x, lp["ln2"], cfg), shd)
    elif cfg.family == "moe":
        for key in ("dense_layers", "layers"):
            for i, lp in enumerate(params[key]):
                h, _ = mla_mod.mla_prefill(
                    lp["attn"], _norm(x, lp["ln1"], cfg), positions, cfg,
                    shd, _layer(caches[key], i), chunk=chunk)
                x = x + h
                xn = _norm(x, lp["ln2"], cfg)
                if "moe" in lp:
                    x = x + moe_mod.moe_ffn(lp["moe"], xn, cfg, shd,
                                            groups=perf.moe_groups)[0]
                else:
                    x = x + swiglu(lp["mlp"], xn, shd)
    elif cfg.family == "ssm":
        for i, lp in enumerate(params["layers"]):
            x = _ssm_prefill_block(lp, x, cfg, shd,
                                   _layer(caches["layers"], i))
    elif cfg.family == "hybrid":
        x = _hybrid_prefill(params, x, positions, caches, cfg, shd, perf)
    elif cfg.family == "encdec":
        enc_out = encode(params, batch["audio_embeds"], cfg, shd, perf)
        enc_pos = positions_for(B, enc_out.shape[1], x.device)
        for i, lp in enumerate(params["layers"]):
            h, _ = attn_mod.prefill_into_cache(
                lp["self_attn"], _norm(x, lp["ln1"], cfg), positions, cfg,
                shd, _layer(caches["layers"], i), chunk=chunk)
            x = x + h
            kv = _cross_kv(lp["cross_attn"], enc_out, cfg)
            x = x + _cross_attn(lp["cross_attn"], _norm(x, lp["ln2"], cfg),
                                enc_out, positions, enc_pos, cfg, shd, kv)
            x = x + gelu_mlp(lp["mlp"], _norm(x, lp["ln3"], cfg), shd)
            caches["cross_k"][i] = kv[0]
            caches["cross_v"][i] = kv[1]
    else:
        raise ValueError(cfg.family)

    x = _norm(x[:, -1:], params["final_norm"], cfg)
    logits = shd.bv((x @ params["lm_head"])[:, 0])
    return logits, caches


def _ssm_prefill_block(lp, x, cfg, shd, state: dict):
    """Run the ssm block over the prompt; write its final conv window (the
    last d_conv - 1 pre-conv activations) and scan state into ``state``.
    The reference recomputes the state after the block; the port keeps
    the block's own scan's last state, the same values."""
    k = cfg.ssm.d_conv - 1
    xn = _norm(x, lp["ln"], cfg)
    y, h = ssm_mod.ssm_scan(lp["ssm"], xn, cfg, shd)
    state["conv"].copy_(xn[:, -k:] @ lp["ssm"]["in_proj_x"])
    state["h"].copy_(h)
    return x + y


def _hybrid_prefill(params, x, positions, caches, cfg, shd, perf):
    per = cfg.attn_every
    n_seg = n_segments(cfg)
    sp = params["shared_block"]
    layers = params["layers"]

    def ssm_run(lo, hi, x):
        for i in range(lo, hi):
            x = _ssm_prefill_block(layers[i], x, cfg, shd,
                                   _layer(caches["layers"], i))
        return x
    for seg in range(n_seg):
        h, _ = attn_mod.prefill_into_cache(
            sp["attn"], _norm(x, sp["ln1"], cfg), positions, cfg, shd,
            _layer(caches["shared"], seg), chunk=perf.attn_chunk)
        x = x + h
        x = x + swiglu(sp["mlp"], _norm(x, sp["ln2"], cfg), shd)
        x = ssm_run(seg * per, min((seg + 1) * per, cfg.n_layers), x)
    return ssm_run(n_seg * per, cfg.n_layers, x)


# ===========================================================================
# decode
# ===========================================================================

def _cross_decode(p, xq, ck, cv, cfg: ArchConfig, shd: Sharder):
    """One query a sequence against the cached encoder keys/values, plain
    PyTorch as in the reference."""
    B = xq.shape[0]
    dh, hkv = cfg.head_dim, cfg.n_kv_heads
    rep = cfg.n_heads // hkv
    q = (xq @ p["wq"]).reshape(B, hkv, rep, dh).float()
    s = torch.einsum("bhrd,bkhd->bhrk", q, ck.float()) * dh ** -0.5
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrk,bkhd->bhrd", w, cv.float())
    o = o.reshape(B, 1, cfg.n_heads * dh).to(xq.dtype) @ p["wo"]
    return shd.btd(o)


@torch.no_grad()
@f32_matmul()
def decode_step(params: dict, tokens: torch.Tensor, caches: dict, pos: int,
                cfg: ArchConfig, shd: Sharder = NOSHARD,
                unroll: bool = False, moe_groups: int = 1
                ) -> tuple[torch.Tensor, dict]:
    """tokens [B, 1]; pos int. Returns (logits [B, vocab_p], caches).

    ``unroll`` is the reference's (a straight-line layer loop instead of
    a scan), accepted for its signature: the port's layer loop is a
    Python loop either way.
    """
    x = shd.btd(params["embed"][tokens])

    if cfg.family == "dense":
        for i, lp in enumerate(params["layers"]):
            h, _ = attn_mod.attn_decode(
                lp["attn"], _norm(x, lp["ln1"], cfg),
                _layer(caches["layers"], i), pos, cfg, shd)
            x = x + h
            x = x + swiglu(lp["mlp"], _norm(x, lp["ln2"], cfg), shd)
    elif cfg.family == "moe":
        for key in ("dense_layers", "layers"):
            for i, lp in enumerate(params[key]):
                h, _ = mla_mod.mla_decode(
                    lp["attn"], _norm(x, lp["ln1"], cfg),
                    _layer(caches[key], i), pos, cfg, shd)
                x = x + h
                xn = _norm(x, lp["ln2"], cfg)
                if "moe" in lp:
                    x = x + moe_mod.moe_ffn(lp["moe"], xn, cfg, shd,
                                            groups=moe_groups)[0]
                else:
                    x = x + swiglu(lp["mlp"], xn, shd)
    elif cfg.family == "ssm":
        for i, lp in enumerate(params["layers"]):
            h, _ = ssm_mod.ssm_decode(lp["ssm"], _norm(x, lp["ln"], cfg),
                                      _layer(caches["layers"], i), cfg, shd)
            x = x + h
    elif cfg.family == "hybrid":
        per = cfg.attn_every
        n_seg = n_segments(cfg)
        sp = params["shared_block"]
        for i, lp in enumerate(params["layers"]):
            seg = i // per
            if i % per == 0 and seg < n_seg:
                h, _ = attn_mod.attn_decode(
                    sp["attn"], _norm(x, sp["ln1"], cfg),
                    _layer(caches["shared"], seg), pos, cfg, shd)
                x = x + h
                x = x + swiglu(sp["mlp"], _norm(x, sp["ln2"], cfg), shd)
            h, _ = ssm_mod.ssm_decode(lp["ssm"], _norm(x, lp["ln"], cfg),
                                      _layer(caches["layers"], i), cfg, shd)
            x = x + h
    elif cfg.family == "encdec":
        for i, lp in enumerate(params["layers"]):
            h, _ = attn_mod.attn_decode(
                lp["self_attn"], _norm(x, lp["ln1"], cfg),
                _layer(caches["layers"], i), pos, cfg, shd)
            x = x + h
            x = x + _cross_decode(lp["cross_attn"], _norm(x, lp["ln2"], cfg),
                                  caches["cross_k"][i], caches["cross_v"][i],
                                  cfg, shd)
            x = x + gelu_mlp(lp["mlp"], _norm(x, lp["ln3"], cfg), shd)
    else:
        raise ValueError(cfg.family)

    x = _norm(x, params["final_norm"], cfg)
    logits = shd.bv((x @ params["lm_head"])[:, 0])
    return logits, caches
