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
from repro_torch.models.model import not_ported, vocab_padded
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


def lm_params_from_reference(params_np: dict, device="cuda") -> dict:
    """The reference's dense-family params pytree, as NumPy arrays with
    the leading layer axis of ``params["layers"]`` -> the port's params
    on ``device`` (``params["layers"]`` a list of per-layer dicts)."""
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return torch.from_numpy(np.require(tree, requirements="CW")).to(dev)

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i]

    out = conv({k: v for k, v in params_np.items() if k != "layers"})
    stacked = params_np["layers"]
    n_layers = len(next(iter(next(iter(stacked.values())).values())))
    out["layers"] = [conv(layer(stacked, i)) for i in range(n_layers)]
    return out


def lm_params_seed_numpy(cfg: ArchConfig, seed: int) -> dict:
    """Dense-family weights from ``np.random.default_rng(seed)`` at the
    reference's init scales, in the reference's pytree layout (float32
    NumPy arrays; stacked layers): embed 0.02, each dense ``d_in**-0.5``,
    ``wo`` ``(H*dh)**-0.5``, biases 0, norm weights 1 and biases 0.

    The draws run in this order, each over all layers at once: embed,
    lm_head, wq, wk, wv, wo, w_gate, w_up, w_down.
    """
    if cfg.family != "dense":
        raise not_ported(cfg.family)
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(scale)
        return a

    L, d, dh, ff = cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.d_ff
    hq, hkv, vp = cfg.n_heads * dh, cfg.n_kv_heads * dh, vocab_padded(cfg)

    def norm(*lead):
        n = {"w": np.ones(lead + (d,), np.float32)}
        if cfg.norm_type == "layernorm":
            n["b"] = np.zeros(lead + (d,), np.float32)
        return n

    p = {"embed": normal((vp, d), 0.02),
         "lm_head": normal((d, vp), d ** -0.5),
         "final_norm": norm()}
    attn = {"wq": normal((L, d, hq), d ** -0.5),
            "wk": normal((L, d, hkv), d ** -0.5),
            "wv": normal((L, d, hkv), d ** -0.5),
            "wo": normal((L, hq, d), hq ** -0.5)}
    if cfg.qkv_bias:
        attn.update(bq=np.zeros((L, hq), np.float32),
                    bk=np.zeros((L, hkv), np.float32),
                    bv=np.zeros((L, hkv), np.float32))
    mlp = {"w_gate": normal((L, d, ff), d ** -0.5),
           "w_up": normal((L, d, ff), d ** -0.5),
           "w_down": normal((L, ff, d), ff ** -0.5)}
    p["layers"] = {"attn": attn, "mlp": mlp, "ln1": norm(L), "ln2": norm(L)}
    return p


def lm_params_from_seed(cfg: ArchConfig, seed: int, device="cuda") -> dict:
    """The port's params for :func:`lm_params_seed_numpy`'s weights: the
    same numbers the reference gets from the same call's arrays."""
    return lm_params_from_reference(lm_params_seed_numpy(cfg, seed), device)
