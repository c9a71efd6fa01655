"""Model assembly: init and forward for all 10 architectures.

Families, as in the reference's ``models/model.py``:
  dense   — pre-norm GQA transformer (stablelm, phi3, codeqwen, danube,
            qwen2-vl with its stub vision prefix)
  moe     — DeepSeek-V2(-lite): MLA attention + shared/routed MoE FFN
  ssm     — falcon-mamba: pure Mamba-1 stack
  hybrid  — zamba2: Mamba-2 backbone + ONE shared attn+MLP block re-applied
            every ``attn_every`` layers (weight re-use)
  encdec  — whisper: bidirectional encoder over stub audio embeddings +
            causal decoder with cross attention

Each layer stack is a Python loop over per-layer parameter dicts
(``params["layers"]``, ``params["dense_layers"]`` and
``params["enc_layers"]`` are lists; ``params["shared_block"]`` is one
dict), forward only: no remat, no gradient, and no TF32 in the float32
matrix products.  Full-sequence GQA attention (dense, the hybrid's shared
block, whisper's encoder, decoder and cross attention) goes through the
flash kernel; MLA's attention stays plain PyTorch (``models/mla.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (NOSHARD, Sharder, dense_init,
                                       embed_init, f32_matmul, gelu_mlp,
                                       gelu_mlp_init, layernorm, rmsnorm,
                                       rmsnorm_init, swiglu, swiglu_init)


@dataclasses.dataclass(frozen=True)
class PerfConfig:
    """The reference's per-cell knobs that the forward and serving paths
    read."""
    attn_chunk: Optional[int] = None   # kv-chunked attention block size
    #                                    (MLA's online softmax; the flash
    #                                    kernel streams K/V anyway)
    moe_groups: int = 1                # GShard dispatch groups
    kv_quant: bool = False             # int8 KV cache (KIVI-style)


def _norm(x, p, cfg: ArchConfig):
    if cfg.norm_type == "layernorm":
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["w"], cfg.norm_eps)


def _norm_init(d, cfg: ArchConfig, dtype, device=None):
    if cfg.norm_type == "layernorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)}
    return {"w": rmsnorm_init(d, dtype, device)}


def vocab_padded(cfg: ArchConfig) -> int:
    """Embedding/vocab dim padded to a multiple of 256, as the reference
    pads it (the padded logits are real rows)."""
    return -(-cfg.vocab // 256) * 256


def n_segments(cfg: ArchConfig) -> int:
    """The hybrid's shared-block applications: one every ``attn_every``
    layers (the ``n_layers % attn_every`` trailing layers run after the
    last)."""
    return max(cfg.n_layers // cfg.attn_every, 1)


# ===========================================================================
# init
# ===========================================================================

def init_params(cfg: ArchConfig, gen: torch.Generator,
                dtype=torch.float32) -> dict:
    """Random weights at the reference's init scales, on ``gen.device``.

    The numbers differ from the reference's (``jax.random`` and
    ``torch.Generator`` differ); ``interop.lm_params_from_seed`` makes
    the same weights for both packages.
    """
    d = cfg.d_model
    vp = vocab_padded(cfg)
    dev = gen.device
    p: dict = {
        "embed": embed_init(gen, vp, d, dtype),
        "lm_head": dense_init(gen, d, vp, dtype),
        "final_norm": _norm_init(d, cfg, dtype, dev),
    }

    def norms(*names):
        return {n: _norm_init(d, cfg, dtype, dev) for n in names}

    def attn_block(attn, d_ff):
        return {"attn": attn, "mlp": swiglu_init(gen, d, d_ff, dtype),
                **norms("ln1", "ln2")}

    def ssm_layer():
        return {"ssm": ssm_mod.ssm_init(gen, cfg, dtype), **norms("ln")}

    if cfg.family == "dense":
        p["layers"] = [attn_block(attn_mod.attn_init(gen, cfg, dtype),
                                  cfg.d_ff) for _ in range(cfg.n_layers)]
    elif cfg.family == "moe":
        nd = cfg.moe.first_dense
        d_ff_dense = cfg.moe.d_ff_dense or 4 * d
        p["dense_layers"] = [attn_block(mla_mod.mla_init(gen, cfg, dtype),
                                        d_ff_dense) for _ in range(nd)]
        p["layers"] = [{"attn": mla_mod.mla_init(gen, cfg, dtype),
                        "moe": moe_mod.moe_init(gen, cfg, dtype),
                        **norms("ln1", "ln2")}
                       for _ in range(cfg.n_layers - nd)]
    elif cfg.family == "ssm":
        p["layers"] = [ssm_layer() for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        p["layers"] = [ssm_layer() for _ in range(cfg.n_layers)]
        p["shared_block"] = attn_block(attn_mod.attn_init(gen, cfg, dtype),
                                       cfg.d_ff)
    elif cfg.family == "encdec":
        p["enc_layers"] = [{"attn": attn_mod.attn_init(gen, cfg, dtype),
                            "mlp": gelu_mlp_init(gen, d, cfg.d_ff, dtype),
                            **norms("ln1", "ln2")}
                           for _ in range(cfg.n_enc_layers)]
        p["layers"] = [{"self_attn": attn_mod.attn_init(gen, cfg, dtype),
                        "cross_attn": attn_mod.attn_init(gen, cfg, dtype),
                        "mlp": gelu_mlp_init(gen, d, cfg.d_ff, dtype),
                        **norms("ln1", "ln2", "ln3")}
                       for _ in range(cfg.n_layers)]
        p["enc_norm"] = _norm_init(d, cfg, dtype, dev)
    else:
        raise ValueError(cfg.family)
    return p


# ===========================================================================
# blocks (forward and prefill)
# ===========================================================================

def embed_tokens(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Token embeddings, the first ``n_prefix_embeds`` positions replaced
    by the stub frontend's ``prefix_embeds`` where the batch has them."""
    x = params["embed"][batch["tokens"]]
    if cfg.n_prefix_embeds and "prefix_embeds" in batch:
        pe = batch["prefix_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, cfg.n_prefix_embeds:]], dim=1)
    return x


def positions_for(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _dense_block(lp, x, positions, cfg, shd, chunk):
    h = attn_mod.attn_train(lp["attn"], _norm(x, lp["ln1"], cfg), positions,
                            cfg, shd, chunk=chunk)
    x = x + h
    x = x + swiglu(lp["mlp"], _norm(x, lp["ln2"], cfg), shd)
    return x


def _mla_dense_block(lp, x, positions, cfg, shd, chunk):
    h = mla_mod.mla_train(lp["attn"], _norm(x, lp["ln1"], cfg), positions,
                          cfg, shd, chunk=chunk)
    x = x + h
    x = x + swiglu(lp["mlp"], _norm(x, lp["ln2"], cfg), shd)
    return x


def _moe_block(lp, x, positions, cfg, shd, chunk, groups=1):
    h = mla_mod.mla_train(lp["attn"], _norm(x, lp["ln1"], cfg), positions,
                          cfg, shd, chunk=chunk)
    x = x + h
    y, aux = moe_mod.moe_ffn(lp["moe"], _norm(x, lp["ln2"], cfg), cfg, shd,
                             groups=groups)
    return x + y, aux


def _ssm_block(lp, x, cfg, shd):
    return x + ssm_mod.ssm_train(lp["ssm"], _norm(x, lp["ln"], cfg), cfg, shd)


def _whisper_sinusoid(S: int, d: int, dtype, device=None) -> torch.Tensor:
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    ang = pos * torch.exp(-i * math.log(10000.0) / (d // 2 - 1))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


@torch.no_grad()
@f32_matmul()
def encode(params, audio_embeds, cfg: ArchConfig, shd: Sharder = NOSHARD,
           perf: PerfConfig = PerfConfig()) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings [B, F, d]: non-causal
    self-attention through the flash kernel."""
    B, F, d = audio_embeds.shape
    x = audio_embeds + _whisper_sinusoid(F, d, audio_embeds.dtype,
                                         audio_embeds.device)
    pos = positions_for(B, F, x.device)
    for lp in params["enc_layers"]:
        h = attn_mod.attn_train(lp["attn"], _norm(x, lp["ln1"], cfg), pos,
                                cfg, shd, causal=False)
        x = x + h
        x = x + gelu_mlp(lp["mlp"], _norm(x, lp["ln2"], cfg), shd)
    return _norm(x, params["enc_norm"], cfg)


def _cross_kv(p, enc_out, cfg: ArchConfig):
    """The cross attention's keys and values [B, F, Hkv, dh] from the
    encoder output."""
    B, F, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(B, F, cfg.n_kv_heads, cfg.head_dim)
    v = (enc_out @ p["wv"]).reshape(B, F, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def _cross_attn(p, xq, enc_out, positions, enc_pos, cfg, shd, kv=None):
    """Decoder queries against every encoder frame (no mask, no rotary):
    one non-causal flash call.  ``kv`` are ``_cross_kv``'s where the
    caller has them."""
    B, S, _ = xq.shape
    q = (xq @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k, v = kv if kv is not None else _cross_kv(p, enc_out, cfg)
    out = flash.mha(q, k, v, causal=False)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return shd.btd(out)


def _dec_block(lp, x, enc_out, positions, enc_pos, cfg, shd, chunk):
    h = attn_mod.attn_train(lp["self_attn"], _norm(x, lp["ln1"], cfg),
                            positions, cfg, shd, chunk=chunk)
    x = x + h
    # cross attention: queries from decoder, K/V from encoder output
    xq = _norm(x, lp["ln2"], cfg)
    x = x + _cross_attn(lp["cross_attn"], xq, enc_out, positions, enc_pos,
                        cfg, shd)
    return x + gelu_mlp(lp["mlp"], _norm(x, lp["ln3"], cfg), shd)


def _hybrid_forward(params, x, positions, cfg, shd, perf):
    """Zamba2: the shared attn block before every ``attn_every`` mamba
    layers, then the trailing layers if ``n_layers % attn_every``."""
    per = cfg.attn_every
    n_seg = n_segments(cfg)
    layers = params["layers"]
    for seg in range(n_seg):
        x = _dense_block(params["shared_block"], x, positions, cfg, shd,
                         perf.attn_chunk)
        for lp in layers[seg * per:(seg + 1) * per]:
            x = _ssm_block(lp, x, cfg, shd)
    for lp in layers[n_seg * per:]:
        x = _ssm_block(lp, x, cfg, shd)
    return x


# ===========================================================================
# forward: tokens -> logits, aux
# ===========================================================================

@torch.no_grad()
@f32_matmul()
def forward(params: dict, batch: dict, cfg: ArchConfig,
            shd: Sharder = NOSHARD, perf: PerfConfig = PerfConfig()
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] (and ``audio_embeds`` [B, F, d] for encdec) ->
    (logits [B, S, vocab_p], aux: the MoE load-balance loss summed over
    the MoE layers, 0 for the other families)."""
    B, S = batch["tokens"].shape
    x = shd.btd(embed_tokens(params, batch, cfg))
    positions = positions_for(B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    chunk = perf.attn_chunk

    if cfg.family == "dense":
        for lp in params["layers"]:
            x = _dense_block(lp, x, positions, cfg, shd, chunk)
    elif cfg.family == "moe":
        for lp in params["dense_layers"]:
            x = _mla_dense_block(lp, x, positions, cfg, shd, chunk)
        for lp in params["layers"]:
            x, a = _moe_block(lp, x, positions, cfg, shd, chunk,
                              perf.moe_groups)
            aux = aux + a
    elif cfg.family == "ssm":
        for lp in params["layers"]:
            x = _ssm_block(lp, x, cfg, shd)
    elif cfg.family == "hybrid":
        x = _hybrid_forward(params, x, positions, cfg, shd, perf)
    elif cfg.family == "encdec":
        enc_out = encode(params, batch["audio_embeds"], cfg, shd, perf)
        enc_pos = positions_for(B, enc_out.shape[1], x.device)
        for lp in params["layers"]:
            x = _dec_block(lp, x, enc_out, positions, enc_pos, cfg, shd,
                           chunk)
    else:
        raise ValueError(cfg.family)

    x = _norm(x, params["final_norm"], cfg)
    logits = shd.btv(x @ params["lm_head"])
    return logits, aux
