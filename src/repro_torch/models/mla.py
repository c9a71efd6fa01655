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

Under tensor parallelism (``shd.tp``) a rank runs its own heads: its
columns of ``wq`` (or ``wq_b``) and ``wkv_b``, its rows of ``wo``, whose
partial products sum over ``model``.  The latents (``wkv_a``, and
``wq_a`` with q-LoRA) are replicated and enter the rank's heads through
``copy_to_model``.  The cache holds the rank's range of the sequence
slots (the reference's ``latent_cache`` layout): prefill writes it, and
a decode step gathers the absorbed queries of every head, scores them
against the rank's slots and reduces the softmax's max and sums over
the cache's ``seq`` ranks (flash decoding), before each rank applies its
heads' ``w_uv`` and rows of ``wo``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rope as rope_mod
from repro_torch.models.layers import (NOSHARD, Sharder, dense_init,
                                       init_device, rmsnorm, rmsnorm_init)
from repro_torch.parallel.tensor_parallel import (copy_to_model,
                                                  reduce_from_model)

NEG = -1e30


def mla_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
             *, device=None) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dev = init_device(gen, device)
    p = {}
    if m.q_lora:
        p["wq_a"] = dense_init(gen, d, m.q_lora, dtype, device=dev)
        p["q_norm"] = rmsnorm_init(m.q_lora, dtype, dev)
        p["wq_b"] = dense_init(gen, m.q_lora, H * (m.qk_nope + m.qk_rope),
                               dtype, device=dev)
    else:
        p["wq"] = dense_init(gen, d, H * (m.qk_nope + m.qk_rope), dtype,
                             device=dev)
    p["wkv_a"] = dense_init(gen, d, m.kv_lora + m.qk_rope, dtype, device=dev)
    p["kv_norm"] = rmsnorm_init(m.kv_lora, dtype, dev)
    p["wkv_b"] = dense_init(gen, m.kv_lora, H * (m.qk_nope + m.v_dim), dtype,
                            device=dev)
    p["wo"] = dense_init(gen, H * m.v_dim, d, dtype,
                         scale=(H * m.v_dim) ** -0.5, device=dev)
    return p


def _heads(w: torch.Tensor, cfg: ArchConfig, shd: Sharder, width: int,
           dim: int = -1) -> torch.Tensor:
    """The rank's heads of an MLA weight whose dimension ``dim`` holds
    every head, ``width`` entries each (all of it off tensor
    parallelism)."""
    if shd.tp is None:
        return w
    return shd.tp.units(w, cfg.n_heads, width, dim)


def _queries(params, x, positions, cfg: ArchConfig, shd: Sharder):
    m = cfg.mla
    B, S, _ = x.shape
    width = m.qk_nope + m.qk_rope
    if m.q_lora:
        cq = rmsnorm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
        q = copy_to_model(cq, shd.tp) @ _heads(params["wq_b"], cfg, shd,
                                                width)
    else:
        q = copy_to_model(x, shd.tp) @ _heads(params["wq"], cfg, shd, width)
    q = shd.btf(q).reshape(B, S, -1, width)
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
    H = q_nope.shape[2]                                # the rank's heads
    tp = shd.tp
    c_kv, k_rope = copy_to_model(c_kv, tp), copy_to_model(k_rope, tp)
    kv = (c_kv @ _heads(params["wkv_b"], cfg, shd, m.qk_nope + m.v_dim)
          ).reshape(B, S, H, m.qk_nope + m.v_dim)
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
    out = out.to(x.dtype).reshape(B, S, H * m.v_dim) \
        @ _heads(params["wo"], cfg, shd, m.v_dim, 0)
    return shd.btd(reduce_from_model(out, tp))


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
               dtype=torch.float32, device=None,
               shd: Sharder = NOSHARD) -> dict:
    """The compressed cache, zeroed; under tensor parallelism the rank's
    range of the ``max_seq`` slots, which must split evenly over the
    cache's ``seq`` ranks (:func:`_slots` reads the range back from the
    local size)."""
    m = cfg.mla
    n = max_seq
    if shd.tp is not None:
        if max_seq % shd.tp.seq_size:
            raise ValueError(f"an MLA cache of {max_seq} slots does not "
                             f"split evenly over {shd.tp.seq_size} ranks")
        s0, s1 = shd.tp.slots(max_seq)
        n = s1 - s0
    return {
        "c_kv": torch.zeros((batch, n, m.kv_lora), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, n, m.qk_rope), dtype=dtype,
                              device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def _slots(cache: dict, shd: Sharder) -> tuple[int, int]:
    """The range of the sequence slots ``cache`` holds."""
    n = cache["c_kv"].shape[1]
    if shd.tp is None:
        return 0, n
    return shd.tp.seq_rank * n, (shd.tp.seq_rank + 1) * n


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
        s0, s1 = _slots(cache, shd)
        n = max(min(s1, S) - s0, 0)
        cache["c_kv"][:, :n] = shd.latent_cache(
            c_kv[:, s0:s0 + n].to(cache["c_kv"].dtype))
        cache["k_rope"][:, :n] = shd.latent_cache(
            k_rope[:, s0:s0 + n].to(cache["k_rope"].dtype))
        cache["len"].fill_(S)
    return out, cache


def mla_decode(params, x, cache: dict, pos: int, cfg: ArchConfig,
               shd: Sharder = NOSHARD):
    """Absorbed one-token step on the compressed cache: x [B, 1, d], pos
    an int shared by the batch.  Writes the token's latents into
    ``cache`` in place and returns (out [B, 1, d], cache).  Under tensor
    parallelism (module docstring) the rank that holds slot ``pos``
    writes it."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    tp = shd.tp
    pos = int(pos)
    pos_b = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(params, x, pos_b, cfg, shd)   # [B,1,Hl,*]
    c_new, kr_new = _latents(params, x, pos_b, cfg)
    s0, s1 = _slots(cache, shd)
    if s0 <= pos < s1:
        cache["c_kv"][:, pos - s0] = c_new[:, 0].to(cache["c_kv"].dtype)
        cache["k_rope"][:, pos - s0] = kr_new[:, 0].to(
            cache["k_rope"].dtype)
    c_kv = shd.latent_cache(cache["c_kv"])
    k_rope = shd.latent_cache(cache["k_rope"])

    # absorb: q_nope' = q_nope @ W_uk  (per head, into latent space)
    Hl = q_nope.shape[2]
    w_b = _heads(params["wkv_b"], cfg, shd, m.qk_nope + m.v_dim).reshape(
        m.kv_lora, Hl, m.qk_nope + m.v_dim)
    w_uk = w_b[..., :m.qk_nope].float()               # [lora, Hl, nope]
    w_uv = w_b[..., m.qk_nope:].float()               # [lora, Hl, v]
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(), w_uk)
    q_rope = q_rope[:, 0]
    if tp is not None:
        # every head's queries against the rank's slots, in one gather
        both = tp.all_gather(torch.cat([q_lat, q_rope.float()], -1), 1, H)
        q_lat, q_rope = both[..., :m.kv_lora], both[..., m.kv_lora:]

    scale = (m.qk_nope + m.qk_rope) ** -0.5
    c_f = c_kv.float()
    s = (torch.einsum("bhl,bsl->bhs", q_lat, c_f)
         + torch.einsum("bhd,bsd->bhs", q_rope.float(),
                        k_rope.float())) * scale
    valid = (torch.arange(s0, s1, device=x.device) <= pos)[None, None]
    s = torch.where(valid, s, NEG)
    mx = s.amax(dim=-1, keepdim=True)
    if tp is not None:
        mx = tp.all_reduce(mx, "max", seq=True)
    p = torch.where(valid, torch.exp(s - mx), 0.0)
    lat = torch.einsum("bhs,bsl->bhl", p, c_f)
    l = p.sum(dim=-1, keepdim=True)
    if tp is not None:
        # Σp·c and Σp over the sequence's ranks, in one collective
        both = tp.all_reduce(torch.cat([lat, l], dim=-1), seq=True)
        lat, l = both[..., :m.kv_lora], both[..., m.kv_lora:]
        h0, h1 = tp.heads(H)
        lat, l = lat[:, h0:h1], l[:, h0:h1]
    lat = lat / l
    out = torch.einsum("bhl,lhv->bhv", lat, w_uv)
    out = out.reshape(B, 1, Hl * m.v_dim).to(x.dtype) \
        @ _heads(params["wo"], cfg, shd, m.v_dim, 0)
    cache["len"].fill_(pos + 1)
    return shd.btd(reduce_from_model(out, tp)), cache
