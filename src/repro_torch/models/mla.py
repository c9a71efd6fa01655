"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The port of the reference's ``models/mla.py``.  K/V are compressed into a
rank-``kv_lora`` latent c_kv plus a shared ``qk_rope``-dim decoupled
rotary key.  Prefill expands K/V and attends; decode uses the *absorbed*
form — w_uk folds into the query and w_uv into the output — so the
per-token cache is only (kv_lora + qk_rope) floats:

    score_t = q_nope^T W_uk c_t + q_rope^T k_rope_t
    out     = (sum_t p_t c_t) W_uv

Both attentions are plain PyTorch, as the reference computes them with
einsums outside any kernel: the flash kernel takes one head dim for q, k
and v, and MLA's q·k runs over qk_nope + qk_rope dims against v_dim for v
(ROADMAP Queue 2).  The cache is updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rope as rope_mod
from repro_torch.models.layers import (NOSHARD, Sharder, dense_init, rmsnorm,
                                       rmsnorm_init)

NEG = -1e30


def mla_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32
             ) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dev = gen.device
    p = {}
    if m.q_lora:
        p["wq_a"] = dense_init(gen, d, m.q_lora, dtype)
        p["q_norm"] = rmsnorm_init(m.q_lora, dtype, dev)
        p["wq_b"] = dense_init(gen, m.q_lora, H * (m.qk_nope + m.qk_rope),
                               dtype)
    else:
        p["wq"] = dense_init(gen, d, H * (m.qk_nope + m.qk_rope), dtype)
    p["wkv_a"] = dense_init(gen, d, m.kv_lora + m.qk_rope, dtype)
    p["kv_norm"] = rmsnorm_init(m.kv_lora, dtype, dev)
    p["wkv_b"] = dense_init(gen, m.kv_lora, H * (m.qk_nope + m.v_dim), dtype)
    p["wo"] = dense_init(gen, H * m.v_dim, d, dtype,
                         scale=(H * m.v_dim) ** -0.5)
    return p


def _queries(params, x, positions, cfg: ArchConfig, shd: Sharder):
    m = cfg.mla
    B, S, _ = x.shape
    if m.q_lora:
        cq = rmsnorm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
        q = cq @ params["wq_b"]
    else:
        q = x @ params["wq"]
    q = shd.btf(q).reshape(B, S, cfg.n_heads, m.qk_nope + m.qk_rope)
    q_nope = q[..., :m.qk_nope]
    q_rope = rope_mod.apply_rope(q[..., m.qk_nope:], positions,
                                 cfg.rope_theta)
    return q_nope, q_rope


def _latents(params, x, positions, cfg: ArchConfig):
    m = cfg.mla
    kv = x @ params["wkv_a"]                           # [B, S, lora+rope]
    c_kv = rmsnorm(kv[..., :m.kv_lora], params["kv_norm"], cfg.norm_eps)
    k_rope = kv[..., m.kv_lora:][:, :, None, :]        # single shared head
    k_rope = rope_mod.apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _expanded(params, x, q_nope, q_rope, c_kv, k_rope, cfg: ArchConfig,
              shd: Sharder, chunk: Optional[int]):
    """Causal attention with K/V expanded from the latents; [B, S, d]."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    kv = (c_kv @ params["wkv_b"]).reshape(B, S, H, m.qk_nope + m.v_dim)
    k_nope = kv[..., :m.qk_nope]
    v = kv[..., m.qk_nope:]

    scale = (m.qk_nope + m.qk_rope) ** -0.5
    qf = torch.cat([q_nope, q_rope], -1).float()
    kf = torch.cat([k_nope, k_rope[:, :, None].expand(
        B, S, H, m.qk_rope)], -1).float()
    if chunk is not None and S % chunk == 0 and S > chunk:
        out = _chunked_mla(qf, kf, v.float(), scale, chunk)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        qi = torch.arange(S, device=x.device)
        mask = qi[None, :] <= qi[:, None]
        s = torch.where(mask[None, None], s, NEG)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = out.to(x.dtype).reshape(B, S, H * m.v_dim) @ params["wo"]
    return shd.btd(out)


def mla_train(params, x, positions, cfg: ArchConfig, shd: Sharder = NOSHARD,
              *, chunk: Optional[int] = None):
    """Expanded-KV causal attention over the sequence; [B, S, d]."""
    q_nope, q_rope = _queries(params, x, positions, cfg, shd)
    c_kv, k_rope = _latents(params, x, positions, cfg)
    return _expanded(params, x, q_nope, q_rope, c_kv, k_rope, cfg, shd,
                     chunk)


def _chunked_mla(qf, kf, vf, scale, chunk):
    """Online softmax over KV chunks (the reference's recurrence), as a
    loop over the S / chunk key chunks."""
    B, S, H, _ = qf.shape
    dv = vf.shape[-1]
    qi = torch.arange(S, device=qf.device)
    qs = qf * scale
    mx = torch.full((B, H, S), NEG, device=qf.device)
    l = torch.zeros((B, H, S), device=qf.device)
    acc = torch.zeros((B, H, S, dv), device=qf.device)
    for c0 in range(0, S, chunk):
        kb, vb = kf[:, c0:c0 + chunk], vf[:, c0:c0 + chunk]
        kj = c0 + torch.arange(chunk, device=qf.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qs, kb)
        mask = (kj[None, :] <= qi[:, None])[None, None]
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(mx, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(mx - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        mx = m_new
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.movedim(1, 2)                           # [B, S, H, dv]


# ---------------------------------------------------------------------------
# compressed cache: prefill + absorbed decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.float32, device=None) -> dict:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_seq, m.kv_lora), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_seq, m.qk_rope), dtype=dtype,
                              device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def mla_prefill(params, x, positions, cfg: ArchConfig,
                shd: Sharder = NOSHARD, cache: Optional[dict] = None,
                chunk: Optional[int] = None):
    """Causal attention over the prompt; writes its latents into
    ``cache`` (in place) where one is given.  Returns (out, cache)."""
    q_nope, q_rope = _queries(params, x, positions, cfg, shd)
    c_kv, k_rope = _latents(params, x, positions, cfg)
    out = _expanded(params, x, q_nope, q_rope, c_kv, k_rope, cfg, shd, chunk)
    if cache is not None:
        S = x.shape[1]
        cache["c_kv"][:, :S] = shd.latent_cache(c_kv.to(cache["c_kv"].dtype))
        cache["k_rope"][:, :S] = shd.latent_cache(
            k_rope.to(cache["k_rope"].dtype))
        cache["len"].fill_(S)
    return out, cache


def mla_decode(params, x, cache: dict, pos: int, cfg: ArchConfig,
               shd: Sharder = NOSHARD):
    """Absorbed one-token step on the compressed cache: x [B, 1, d], pos
    an int shared by the batch.  Writes the token's latents into
    ``cache`` in place and returns (out [B, 1, d], cache)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    pos = int(pos)
    pos_b = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(params, x, pos_b, cfg, shd)   # [B,1,H,*]
    c_new, kr_new = _latents(params, x, pos_b, cfg)
    cache["c_kv"][:, pos] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, pos] = kr_new[:, 0].to(cache["k_rope"].dtype)
    c_kv = shd.latent_cache(cache["c_kv"])
    k_rope = shd.latent_cache(cache["k_rope"])
    S = c_kv.shape[1]

    # absorb: q_nope' = q_nope @ W_uk  (per head, into latent space)
    w_b = params["wkv_b"].reshape(m.kv_lora, H, m.qk_nope + m.v_dim)
    w_uk = w_b[..., :m.qk_nope].float()               # [lora, H, nope]
    w_uv = w_b[..., m.qk_nope:].float()               # [lora, H, v]
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(), w_uk)

    scale = (m.qk_nope + m.qk_rope) ** -0.5
    c_f = c_kv.float()
    s = (torch.einsum("bhl,bsl->bhs", q_lat, c_f)
         + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                        k_rope.float())) * scale
    valid = (torch.arange(S, device=x.device) <= pos)[None, None]
    s = torch.where(valid, s, NEG)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - mx), 0.0)
    lat = torch.einsum("bhs,bsl->bhl", p, c_f)
    lat = lat / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhl,lhv->bhv", lat, w_uv)
    out = out.reshape(B, 1, H * m.v_dim).to(x.dtype) @ params["wo"]
    cache["len"].fill_(pos + 1)
    return shd.btd(out), cache
