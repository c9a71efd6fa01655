"""Mixture-of-Experts FFN (DeepSeek-V2 style: shared + fine-grained routed).

The port of the reference's ``models/moe.py``.  Dispatch is sort-based
with a capacity bound, GROUP-LOCAL in the GShard sense: tokens are split
into ``groups``, each routing into its own [E, cap_g, d] slice of the
buffer (``groups=1`` is plain global-capacity routing).  An (expert,
slot) pair a token is routed past the capacity of is dropped.  The
Switch-style load-balance aux loss is returned beside the output.

Under tensor parallelism (``shd.tp``) the experts split over ``model``,
as the reference's specs place them (``w_gate``/``w_up`` ``P("model",
data, None)``, the buffer ``P(data, "model", None, None)``).  The
activations are replicated over ``model``, so every rank routes its data
rank's tokens itself, the same decisions on each (the router's input
comes out of an all-reduce, the same on every rank); it fills only its
own experts' rows of the buffer, runs their products and combines a
partial output, which it sums with the shared expert's row-parallel
partial in one all-reduce over ``model``.  No token moves between ranks.
On a train step whose batch the data ranks split (``shd.dp``) the
load-balance loss's token and probability fractions are means over the
whole batch, as the reference's are under any sharding.

The reference scatters with an atomic add and combines with another; the
port does neither.  Every kept (group, expert, slot) is unique, so the
dispatch is an indexed assignment (dropped entries all land in one spare
row past the buffer, which is cut off).  The combine gathers each token's
``top_k`` expert outputs back to [Tg, K, d] and sums over K, a fixed
order, so the output is the same from run to run on the card.  The
expert products are batched ``torch.einsum``, as the reference computes
them outside any kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (NOSHARD, Sharder, dense_init, swiglu,
                                       swiglu_init)
from repro_torch.parallel.tensor_parallel import (copy_to_model,
                                                  mean_over_data,
                                                  reduce_from_model)


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
             *, device=None) -> dict:
    m = cfg.moe
    d, E = cfg.d_model, m.n_routed

    def stacked(d_in, d_out):
        return torch.stack([dense_init(gen, d_in, d_out, dtype, device=device)
                            for _ in range(E)])
    p = {
        "router": dense_init(gen, d, E, torch.float32,   # fp32 router
                             device=device),
        "experts": {"w_gate": stacked(d, m.d_expert),
                    "w_up": stacked(d, m.d_expert),
                    "w_down": stacked(m.d_expert, d)},
    }
    if m.n_shared:
        p["shared"] = swiglu_init(gen, d, m.n_shared * m.d_expert, dtype,
                                  device)
    return p


def _capacity(tokens_per_group: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    cap = int(m.capacity_factor * tokens_per_group * m.top_k / m.n_routed)
    return max(8, -(-cap // 8) * 8)        # round up to a lane-friendly size


def route(params: dict, x: torch.Tensor, cfg: ArchConfig, groups: int = 1,
          dp=None) -> dict:
    """The router's decisions for x [B, S, d], as the reference makes them.

    Returns a dict: ``G``, ``cap``; ``ids`` and ``w`` [G, Tg, K] (top-k
    expert ids, descending, and their renormalised weights); for each of
    the Tg·K (token, k) entries in token-major order, ``pos`` (its slot
    in its expert, by a stable sort on the ids) and ``keep`` (pos <
    cap); and ``aux``, the load-balance loss, whose fractions are means
    over the data ranks ``dp`` (``tensor_parallel.DataParallel``) where
    they split the batch.
    """
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    G = groups if T % groups == 0 else 1
    Tg = T // G
    K = m.top_k
    xt = x.reshape(G, Tg, d)

    logits = xt.float() @ params["router"]                      # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, K, dim=-1)                       # [G, Tg, K]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)      # renormalise

    # Switch-style load-balance aux loss
    frac_tokens = mean_over_data(F.one_hot(ids[..., 0], m.n_routed).float()
                                 .mean(dim=(0, 1)), dp)
    frac_probs = mean_over_data(probs.mean(dim=(0, 1)), dp)
    aux = m.n_routed * torch.sum(frac_tokens * frac_probs) * m.aux_weight

    flat_ids = ids.reshape(G, Tg * K)
    order = torch.argsort(flat_ids, dim=1, stable=True)        # [G, Tg*K]
    sorted_eids = torch.gather(flat_ids, 1, order).contiguous()
    run_start = torch.searchsorted(sorted_eids, sorted_eids, right=False)
    sorted_pos = torch.arange(Tg * K, device=x.device)[None] - run_start
    pos = torch.empty_like(sorted_pos).scatter_(1, order, sorted_pos)
    cap = _capacity(Tg, cfg)
    return dict(G=G, cap=cap, ids=ids, w=w, pos=pos,
                keep=pos < cap, aux=aux)


def moe_ffn(params: dict, x: torch.Tensor, cfg: ArchConfig,
            shd: Sharder = NOSHARD, groups: int = 1
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar)."""
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.n_routed, m.top_k
    tp = shd.tp
    r = route(params, x, cfg, groups, shd.dp)
    G, cap = r["G"], r["cap"]
    Tg = B * S // G
    dev = x.device
    e = params["experts"]
    # this rank's experts [e0, e1) (all of them off tensor parallelism);
    # the router's outputs enter its own compute here
    e0, e1 = (0, E) if tp is None else tp.heads(E)
    if tp is not None:
        e = {k: tp.units(w, E, 1, 0) for k, w in e.items()}
    El = e1 - e0
    xin = copy_to_model(x, tp)
    w = copy_to_model(r["w"], tp)

    # ---- group-local dispatch: row (g, e, slot) of a flat buffer of the
    # rank's experts; the dropped entries and the other ranks' to the
    # spare row G·El·cap
    g_of = torch.arange(G, device=dev)[:, None]
    flat_ids = r["ids"].reshape(G, Tg * K)
    own = r["keep"]
    if tp is not None:
        own = own & (flat_ids >= e0) & (flat_ids < e1)
    row = (g_of * El + flat_ids - e0) * cap + r["pos"]
    row = torch.where(own, row, G * El * cap).reshape(-1)
    token = (g_of * Tg + torch.arange(Tg * K, device=dev)[None] // K)
    buf = torch.zeros((G * El * cap + 1, d), dtype=x.dtype, device=dev)
    buf[row] = xin.reshape(G * Tg, d)[token.reshape(-1)]
    buf = shd.expert_buf(buf[:G * El * cap].view(G, El, cap, d))

    # ---- batched expert SwiGLU over (G, El)
    g = torch.einsum("gecd,edf->gecf", buf, e["w_gate"])
    u = torch.einsum("gecd,edf->gecf", buf, e["w_up"])
    h = F.silu(g) * u
    out_buf = shd.expert_buf(torch.einsum("gecf,efd->gecd", h, e["w_down"]))

    # ---- group-local combine: each token's K outputs (those of the
    # rank's experts), summed over K
    vals = out_buf.reshape(G * El * cap, d)[
        torch.where(own.reshape(-1), row, 0)]
    wk = w.reshape(-1) * own.reshape(-1)
    y = (vals.float() * wk[:, None]).reshape(G * Tg, K, d).sum(dim=1)
    y = y.to(x.dtype).reshape(B, S, d)

    if m.n_shared:
        y = y + swiglu(params["shared"], x, shd, reduce=False)
    return shd.btd(reduce_from_model(y, tp)), r["aux"]
