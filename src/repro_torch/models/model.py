"""Model assembly for the dense family: init and forward.

dense — pre-norm GQA transformer (stablelm, phi3, codeqwen, danube,
qwen2-vl with its stub vision prefix).  The layer stack is a Python loop
over per-layer parameter dicts (``params["layers"]`` is a list), forward
only: no remat, no gradient, and no TF32 in the float32 matrix products.  The moe, ssm, hybrid and encdec families
raise ``NotImplementedError`` until they are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (NOSHARD, Sharder, dense_init,
                                       embed_init, f32_matmul, layernorm,
                                       rmsnorm, rmsnorm_init, swiglu,
                                       swiglu_init)


@dataclasses.dataclass(frozen=True)
class PerfConfig:
    """The reference's per-cell knobs that the serving path reads."""
    attn_chunk: Optional[int] = None   # kv-chunked attention block size
    #                                    (accepted; the kernel streams K/V)
    kv_quant: bool = False             # int8 KV cache (KIVI-style)


def not_ported(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {family!r} family is not ported yet: only 'dense' runs in the "
        "port (ROADMAP Queue 1, 'Left' item 3: the rest of the LM substrate)")


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
    if cfg.family != "dense":
        raise not_ported(cfg.family)
    d = cfg.d_model
    vp = vocab_padded(cfg)
    dev = gen.device
    p: dict = {
        "embed": embed_init(gen, vp, d, dtype),
        "lm_head": dense_init(gen, d, vp, dtype),
        "final_norm": _norm_init(d, cfg, dtype, dev),
    }
    p["layers"] = [{
        "attn": attn_mod.attn_init(gen, cfg, dtype),
        "mlp": swiglu_init(gen, d, cfg.d_ff, dtype),
        "ln1": _norm_init(d, cfg, dtype, dev),
        "ln2": _norm_init(d, cfg, dtype, dev),
    } for _ in range(cfg.n_layers)]
    return p


# ===========================================================================
# forward: tokens -> logits, aux
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


@torch.no_grad()
@f32_matmul()
def forward(params: dict, batch: dict, cfg: ArchConfig,
            shd: Sharder = NOSHARD, perf: PerfConfig = PerfConfig()
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, vocab_p], aux 0)."""
    if cfg.family != "dense":
        raise not_ported(cfg.family)
    B, S = batch["tokens"].shape
    x = shd.btd(embed_tokens(params, batch, cfg))
    positions = positions_for(B, S, x.device)
    for lp in params["layers"]:
        x = _dense_block(lp, x, positions, cfg, shd, perf.attn_chunk)
    x = _norm(x, params["final_norm"], cfg)
    logits = shd.btv(x @ params["lm_head"])
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
