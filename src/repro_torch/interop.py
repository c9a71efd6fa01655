"""Carry state across from the reference package ``repro``.

Plain NumPy in, tensors out: the parity tests convert the reference's
arrays with ``np.asarray`` and hand them here, so both packages run on the
same grids, fields, planes, schedules and LM weights.  This module imports nothing of
the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import APState, PassSchedule, schedule_tensors
from repro_torch.kernels.ap_megakernel.ref import OpGroup
from repro_torch.models.model import vocab_padded
from repro_torch.workloads._device import MinExtractTrace


def planes_from_reference(planes: np.ndarray, device="cuda") -> torch.Tensor:
    """uint32 bit planes [n_bits, n_lanes] -> the port's int32 planes
    (the same bits) on ``device``."""
    arr = np.ascontiguousarray(np.asarray(planes, np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(
        resolve_device(device))


def planes_to_reference(planes: torch.Tensor) -> np.ndarray:
    """The port's int32 planes -> uint32 host planes (inverse of
    :func:`planes_from_reference`)."""
    return np.ascontiguousarray(planes.cpu().numpy()).view(np.uint32)


def schedule_from_reference(cmp_cols, cmp_key, w_cols, w_key,
                            device="cuda") -> tuple[torch.Tensor, ...]:
    """A reference pass table (int32 columns, uint32 keys, [P, K]) ->
    four int32 tensors on ``device``, as ``ops.run_schedule`` takes
    them."""
    return schedule_tensors(np.asarray(cmp_cols, np.int32),
                            np.asarray(cmp_key, np.uint32),
                            np.asarray(w_cols, np.int32),
                            np.asarray(w_key, np.uint32),
                            resolve_device(device))


def fields_from_reference(F: dict, device="cuda") -> dict:
    """The reference's face-conductance fields (any leading batch dims)
    -> float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in F.items()}


def case_from_reference(leaves, device="cuda") -> tuple:
    """The leaves of the reference's ``feedback.assemble_case``
    (dyn, leak0, refresh0, logic_mask, F, cap3) -> the same leaves as
    float32 tensors on ``device``, ready for the port's ``replay_cases``.
    """
    dev = resolve_device(device)
    dyn, l0, r0, lm, F, cap3 = leaves
    as_t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev)
    return (as_t(dyn), as_t(l0), as_t(r0), as_t(lm),
            fields_from_reference(F, dev), as_t(cap3))


def conductances_from_reference(g: dict, device="cuda") -> dict:
    """The reference's legacy ``Grid.conductances()`` (``g_lat`` [L],
    ``g_vert`` [L-1] arrays, ``g_pkg`` and ``r_pkg`` floats) -> float32
    tensors on ``device`` for the arrays, Python floats for the rest."""
    dev = resolve_device(device)
    out = {}
    for k, v in g.items():
        if k in ("g_lat", "g_vert"):
            out[k] = torch.from_numpy(np.array(v, np.float32)).to(dev)
        else:
            out[k] = float(v)
    return out


def levels_from_reference(levels, device="cuda") -> list:
    """A reference multigrid hierarchy ``[(F_0, d_0), (F_1, d_1), ...]``
    (field dicts and ``d_extra`` arrays, any leading batch dims) -> the
    same hierarchy as float32 tensors on ``device``."""
    dev = resolve_device(device)
    return [(fields_from_reference(F, dev),
             torch.from_numpy(np.array(d, np.float32)).to(dev))
            for F, d in levels]


def op_group_from_reference(tables) -> OpGroup:
    """A reference ``OpGroup``'s six tables (``group.tables()``: op, cond,
    cmp_cols, cmp_key, w_cols, w_key) -> the port's ``OpGroup``."""
    op, cond, cc, ck, wc, wk = (np.asarray(t) for t in tables)
    return OpGroup(op.astype(np.int32), cond.astype(np.int32),
                   cc.astype(np.int32), ck.astype(np.uint32),
                   wc.astype(np.int32), wk.astype(np.uint32))


def state_from_reference(planes, tag, counters, device="cuda") -> APState:
    """A reference ``APState``'s leaves (uint32 planes and tag, int32
    counters) -> the port's ``APState`` on ``device``."""
    dev = resolve_device(device)
    return APState(planes_from_reference(planes, dev),
                   planes_from_reference(np.asarray(tag)[None], dev)[0],
                   torch.from_numpy(np.array(counters, np.int32)).to(dev))


def pass_schedule_from_reference(sched) -> PassSchedule:
    """A reference ``PassSchedule`` -> the port's (the same six tables)."""
    return PassSchedule(*(np.array(getattr(sched, k)) for k in (
        "cmp_cols", "cmp_key", "w_cols", "w_key", "kc", "kw")))


def min_extract_trace_from_reference(tr):
    """A reference ``MinExtractTrace`` -> the port's, field for field, as
    NumPy arrays (its schedule as the port's ``PassSchedule``)."""
    return MinExtractTrace(
        pass_schedule_from_reference(tr.copy_sched),
        *(np.array(getattr(tr, k)) for k in (
            "copy_matched", "m1", "m2", "take", "count", "tie_tag",
            "masked", "device_counters")))


#: the params keys whose leaves carry a leading layer axis in the
#: reference's pytree (lists of per-layer dicts in the port's)
STACKED_KEYS = ("layers", "dense_layers", "enc_layers")


def lm_params_from_reference(params_np: dict, device="cuda") -> dict:
    """The reference's params pytree of any family, as NumPy arrays ->
    the port's params on ``device``: each stacked stack
    (``STACKED_KEYS``, a leading layer axis) becomes a list of per-layer
    dicts; ``shared_block``, ``enc_norm`` and the rest carry over as
    they are (a MoE layer's experts stay stacked [E, ...])."""
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return torch.from_numpy(np.require(tree, requirements="CW")).to(dev)

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i]

    def n_layers(tree):
        while isinstance(tree, dict):
            tree = next(iter(tree.values()))
        return len(tree)

    out = conv({k: v for k, v in params_np.items() if k not in STACKED_KEYS})
    for key in STACKED_KEYS:
        if key in params_np:
            stacked = params_np[key]
            out[key] = [conv(layer(stacked, i))
                        for i in range(n_layers(stacked))]
    return out


def lm_params_seed_numpy(cfg: ArchConfig, seed: int) -> dict:
    """Weights of any family from ``np.random.default_rng(seed)`` at the
    reference's init scales, in the reference's pytree layout (float32
    NumPy arrays; layers stacked [L, ...], a MoE layer's experts [L, E,
    ...], ``shared_block`` and ``enc_norm`` unstacked).  Every matrix is
    a standard normal times ``d_in**-0.5``, but the embedding (0.02),
    each attention ``wo`` (``(H*dh)**-0.5``; MLA's ``(H*v_dim)**-0.5``)
    and an SSM's ``conv_w`` (``(d_conv*d_inner)**-0.5``); biases 0, norm
    weights 1; an SSM's ``dt_bias`` -4.6, ``D`` 1, Mamba-1's ``A_log``
    ``log(1..N)`` and Mamba-2's 0, as the reference's ``init_params``.

    The normal draws run in this order, each over all layers of a stack
    at once: embed, lm_head; then
      dense:  wq, wk, wv, wo, w_gate, w_up, w_down;
      moe:    for ``dense_layers`` then ``layers``: the MLA weights (wq_a,
              wq_b with q-LoRA, else wq; wkv_a, wkv_b, wo), then the
              dense layers' w_gate, w_up, w_down, or the MoE layers'
              router, the experts' w_gate, w_up, w_down and the shared
              experts' w_gate, w_up, w_down;
      ssm:    in_proj_x, in_proj_z, conv_w, x_proj, dt_proj, out_proj;
      hybrid: in_proj_x, in_proj_z, in_proj_bc, in_proj_dt, conv_w,
              out_proj; then the shared block's wq, wk, wv, wo, w_gate,
              w_up, w_down;
      encdec: the encoder's wq, wk, wv, wo, w_up, w_down; then the
              decoder's self-attention wq, wk, wv, wo, its cross
              attention's, and its w_up, w_down.
    """
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(scale)
        return a

    def full(shape, value):
        return np.full(shape, value, np.float32)

    d, dh, vp = cfg.d_model, cfg.head_dim, vocab_padded(cfg)
    hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh

    def norm(*lead, width=d):
        n = {"w": full(lead + (width,), 1.0)}
        if cfg.norm_type == "layernorm":
            n["b"] = full(lead + (width,), 0.0)
        return n

    def dense(lead, d_in, d_out, scale=None):
        return normal(lead + (d_in, d_out), scale or d_in ** -0.5)

    def attn(*lead):
        a = {"wq": dense(lead, d, hq), "wk": dense(lead, d, hkv),
             "wv": dense(lead, d, hkv), "wo": dense(lead, hq, d)}
        if cfg.qkv_bias:
            a.update(bq=full(lead + (hq,), 0.0), bk=full(lead + (hkv,), 0.0),
                     bv=full(lead + (hkv,), 0.0))
        return a

    def swiglu(lead, d_ff):
        return {"w_gate": dense(lead, d, d_ff), "w_up": dense(lead, d, d_ff),
                "w_down": dense(lead, d_ff, d)}

    def gelu(lead):
        return {"w_up": dense(lead, d, cfg.d_ff),
                "b_up": full(lead + (cfg.d_ff,), 0.0),
                "w_down": dense(lead, cfg.d_ff, d),
                "b_down": full(lead + (d,), 0.0)}

    def mla(lead):
        m = cfg.mla
        H, qk = cfg.n_heads, m.qk_nope + m.qk_rope
        a = {}
        if m.q_lora:
            a["wq_a"] = dense(lead, d, m.q_lora)
            a["q_norm"] = full(lead + (m.q_lora,), 1.0)
            a["wq_b"] = dense(lead, m.q_lora, H * qk)
        else:
            a["wq"] = dense(lead, d, H * qk)
        a["wkv_a"] = dense(lead, d, m.kv_lora + m.qk_rope)
        a["kv_norm"] = full(lead + (m.kv_lora,), 1.0)
        a["wkv_b"] = dense(lead, m.kv_lora, H * (m.qk_nope + m.v_dim))
        a["wo"] = dense(lead, H * m.v_dim, d)
        return a

    def moe(lead):
        m = cfg.moe
        ex = lead + (m.n_routed,)
        p = {"router": dense(lead, d, m.n_routed),
             "experts": {"w_gate": dense(ex, d, m.d_expert),
                         "w_up": dense(ex, d, m.d_expert),
                         "w_down": dense(ex, m.d_expert, d)}}
        if m.n_shared:
            p["shared"] = swiglu(lead, m.n_shared * m.d_expert)
        return p

    def ssm(lead):
        s = cfg.ssm
        din, N = s.expand * d, s.d_state
        p = {"in_proj_x": dense(lead, d, din),
             "in_proj_z": dense(lead, d, din)}
        if s.version == 1:
            r = s.dt_rank or -(-d // 16)
            p["conv_w"] = dense(lead, s.d_conv, din, (s.d_conv * din) ** -0.5)
            p["x_proj"] = dense(lead, din, r + 2 * N)
            p["dt_proj"] = dense(lead, r, din)
            p["out_proj"] = dense(lead, din, d)
            p.update(conv_b=full(lead + (din,), 0.0),
                     dt_bias=full(lead + (din,), -4.6),
                     A_log=np.broadcast_to(np.log(np.arange(
                         1, N + 1, dtype=np.float32)), lead + (din, N)).copy(),
                     D=full(lead + (din,), 1.0))
        else:
            H = din // s.headdim
            p["in_proj_bc"] = dense(lead, d, 2 * N)
            p["in_proj_dt"] = dense(lead, d, H)
            p["conv_w"] = dense(lead, s.d_conv, din, (s.d_conv * din) ** -0.5)
            p["out_proj"] = dense(lead, din, d)
            p.update(conv_b=full(lead + (din,), 0.0),
                     dt_bias=full(lead + (H,), -4.6),
                     A_log=full(lead + (H,), 0.0), D=full(lead + (H,), 1.0),
                     norm_w=full(lead + (din,), 1.0))
        return p

    p = {"embed": normal((vp, d), 0.02), "lm_head": dense((), d, vp),
         "final_norm": norm()}
    L = (cfg.n_layers,)
    if cfg.family == "dense":
        p["layers"] = {"attn": attn(*L), "mlp": swiglu(L, cfg.d_ff),
                       "ln1": norm(*L), "ln2": norm(*L)}
    elif cfg.family == "moe":
        nd = cfg.moe.first_dense
        Ld, Lm = (nd,), (cfg.n_layers - nd,)
        p["dense_layers"] = {
            "attn": mla(Ld), "mlp": swiglu(Ld, cfg.moe.d_ff_dense or 4 * d),
            "ln1": norm(*Ld), "ln2": norm(*Ld)}
        p["layers"] = {"attn": mla(Lm), "moe": moe(Lm), "ln1": norm(*Lm),
                       "ln2": norm(*Lm)}
    elif cfg.family in ("ssm", "hybrid"):
        p["layers"] = {"ssm": ssm(L), "ln": norm(*L)}
        if cfg.family == "hybrid":
            p["shared_block"] = {"attn": attn(), "mlp": swiglu((), cfg.d_ff),
                                 "ln1": norm(), "ln2": norm()}
    elif cfg.family == "encdec":
        E = (cfg.n_enc_layers,)
        p["enc_layers"] = {"attn": attn(*E), "mlp": gelu(E), "ln1": norm(*E),
                           "ln2": norm(*E)}
        p["layers"] = {"self_attn": attn(*L), "cross_attn": attn(*L),
                       "mlp": gelu(L), "ln1": norm(*L), "ln2": norm(*L),
                       "ln3": norm(*L)}
        p["enc_norm"] = norm()
    else:
        raise ValueError(cfg.family)
    return p


def lm_params_from_seed(cfg: ArchConfig, seed: int, device="cuda") -> dict:
    """The port's params for :func:`lm_params_seed_numpy`'s weights: the
    same numbers the reference gets from the same call's arrays."""
    return lm_params_from_reference(lm_params_seed_numpy(cfg, seed), device)
