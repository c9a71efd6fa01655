"""Selective state-space layers: Mamba-1 (falcon-mamba) and Mamba-2 (zamba2).

The port of the reference's ``models/ssm.py``.  The full-sequence path is
a **chunked selective scan**: a loop over sequence chunks carrying the
[B, d_inner, N] state; inside each chunk a scan of the linear recurrence
``h_t = decay_t * h_{t-1} + inp_t`` materialises only
[B, chunk, d_inner, N].  The reference scans a chunk with
``jax.lax.associative_scan``; PyTorch has none, so the port runs the same
combine ``(da, ia) . (db, ib) = (da * db, ib + db * ia)`` as a shifted
Hillis-Steele scan over the chunk axis: ceil(log2(chunk)) elementwise
steps, never a loop over time steps.

Mamba-2 runs through the same per-channel scan by broadcasting its
per-head scalar decay to the head's channels, as in the reference (whose
simplification — the short causal conv on x only, not on B/C — the port
keeps).  Decode carries {conv window, ssm state}, O(1) per token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (NOSHARD, Sharder, dense_init, rmsnorm,
                                       rmsnorm_init)


def _dt_rank(cfg: ArchConfig) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def ssm_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32
             ) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    din = d_inner(cfg)
    N = s.d_state
    dev = gen.device

    def const(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    def conv_w():
        w = torch.randn((s.d_conv, din), generator=gen, device=dev)
        return (w * (s.d_conv * din) ** -0.5).to(dtype)
    if s.version == 1:
        r = _dt_rank(cfg)
        return {
            # split x/z projections, as the reference keeps them
            "in_proj_x": dense_init(gen, d, din, dtype),
            "in_proj_z": dense_init(gen, d, din, dtype),
            "conv_w": conv_w(),
            "conv_b": torch.zeros((din,), dtype=dtype, device=dev),
            "x_proj": dense_init(gen, din, r + 2 * N, dtype),
            "dt_proj": dense_init(gen, r, din, dtype),
            "dt_bias": const((din,), -4.6),        # softplus ~ 0.01
            "A_log": torch.log(torch.arange(
                1, N + 1, dtype=torch.float32, device=dev)).expand(
                    din, N).clone(),
            "D": const((din,), 1.0),
            "out_proj": dense_init(gen, din, d, dtype, scale=din ** -0.5),
        }
    H = din // s.headdim                            # mamba2 / SSD
    return {
        "in_proj_x": dense_init(gen, d, din, dtype),
        "in_proj_z": dense_init(gen, d, din, dtype),
        "in_proj_bc": dense_init(gen, d, 2 * N, dtype),
        "in_proj_dt": dense_init(gen, d, H, dtype),
        "conv_w": conv_w(),
        "conv_b": torch.zeros((din,), dtype=dtype, device=dev),
        "dt_bias": const((H,), -4.6),
        "A_log": const((H,), 0.0),
        "D": const((H,), 1.0),
        "norm_w": rmsnorm_init(din, dtype, dev),
        "out_proj": dense_init(gen, din, d, dtype, scale=din ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv: x [B, L, D], w [K, D] -> [B, L, D]."""
    K = w.shape[0]
    L = x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = sum(pad[:, k:k + L] * w[k] for k in range(K))
    return y + b


def _scan_chunk(decay: torch.Tensor, inp: torch.Tensor):
    """Inclusive scan of ``h_t = decay_t * h_{t-1} + inp_t`` over axis 1
    from a zero state: returns (cumulative decay, cumulative input), each
    [B, ck, D, N].  Shifted Hillis-Steele: at offset o every t >= o
    combines with t - o, ceil(log2(ck)) steps.  Works in place on its
    arguments."""
    ck = decay.shape[1]
    off = 1
    while off < ck:
        inp[:, off:] += decay[:, off:] * inp[:, :-off]
        decay[:, off:] = decay[:, off:] * decay[:, :-off]
        off *= 2
    return decay, inp


def _scan_chunks(h0, x1, dt, Bm, Cm, A, chunk: int):
    """Chunked selective scan.

    h0 [B, D, N]; x1/dt [B, L, D]; Bm/Cm [B, L, N]; A [D, N] (positive decay
    rates).  Returns (y [B, L, D], h_last).
    """
    L = x1.shape[1]
    nc = max(L // chunk, 1)
    ck = L // nc
    if nc * ck != L:
        raise ValueError(f"sequence length {L} is not {nc} chunks of {ck} "
                         f"(chunk {chunk}), as the reference needs")
    h = h0.float()
    ys = []
    for c0 in range(0, L, ck):
        xc, dtc, Bc, Cc = (v[:, c0:c0 + ck].float()
                           for v in (x1, dt, Bm, Cm))
        decay = torch.exp(-dtc[..., None] * A)            # [B, ck, D, N]
        inp = (dtc * xc)[..., None] * Bc[:, :, None, :]   # [B, ck, D, N]
        dcum, states = _scan_chunk(decay, inp)
        states += dcum * h[:, None]                       # [B, ck, D, N]
        del dcum
        ys.append((states * Cc[:, :, None, :]).sum(-1))   # [B, ck, D]
        h = states[:, -1].clone()
        del states
    return torch.cat(ys, 1), h


def _split_m2(params, x, cfg: ArchConfig):
    N = cfg.ssm.d_state
    z = x @ params["in_proj_z"]
    x1 = x @ params["in_proj_x"]
    bc = x @ params["in_proj_bc"]
    Bm, Cm = bc[..., :N], bc[..., N:]
    dt_h = x @ params["in_proj_dt"]
    return z, x1, Bm, Cm, dt_h


def _scan_inputs(params, x, cfg: ArchConfig, shd: Sharder):
    """The projections the scan reads: (z, x1 after the conv, dt, Bm, Cm,
    A, D) for the whole sequence."""
    s = cfg.ssm
    din = d_inner(cfg)
    N = s.d_state
    if s.version == 1:
        x1 = x @ params["in_proj_x"]
        z = x @ params["in_proj_z"]
        x1 = F.silu(_causal_conv(x1, params["conv_w"], params["conv_b"]))
        x1 = shd.btf(x1)
        r = _dt_rank(cfg)
        dbc = x1 @ params["x_proj"]
        dt = F.softplus(dbc[..., :r] @ params["dt_proj"] + params["dt_bias"])
        Bm, Cm = dbc[..., r:r + N], dbc[..., r + N:]
        A = torch.exp(params["A_log"])
        D = params["D"]
    else:
        z, x1, Bm, Cm, dt_h = _split_m2(params, x, cfg)
        x1 = F.silu(_causal_conv(x1, params["conv_w"], params["conv_b"]))
        x1 = shd.btf(x1)
        dt_h = F.softplus(dt_h + params["dt_bias"])               # [B, L, H]
        dt = torch.repeat_interleave(dt_h, s.headdim, dim=-1)     # [B, L, D]
        A = torch.repeat_interleave(torch.exp(params["A_log"]),
                                    s.headdim)[:, None].expand(din, N)
        D = torch.repeat_interleave(params["D"], s.headdim)
    return z, x1, dt, Bm, Cm, A, D


def ssm_scan(params: dict, x: torch.Tensor, cfg: ArchConfig,
             shd: Sharder = NOSHARD) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: x [B, L, d] -> ([B, L, d], final state
    [B, d_inner, N]), the state the reference's prefill recomputes."""
    s = cfg.ssm
    z, x1, dt, Bm, Cm, A, D = _scan_inputs(params, x, cfg, shd)
    h0 = torch.zeros((x.shape[0], d_inner(cfg), s.d_state),
                     dtype=torch.float32, device=x.device)
    y, h = _scan_chunks(h0, x1, dt, Bm, Cm, A, s.chunk)
    y = y + D * x1.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    if s.version == 2:
        y = rmsnorm(y, params["norm_w"], cfg.norm_eps)
    return shd.btd(y @ params["out_proj"]), h


def ssm_train(params: dict, x: torch.Tensor, cfg: ArchConfig,
              shd: Sharder = NOSHARD) -> torch.Tensor:
    """Full-sequence forward: x [B, L, d] -> [B, L, d]."""
    return ssm_scan(params, x, cfg, shd)[0]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
               device=None) -> dict:
    s = cfg.ssm
    din = d_inner(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, din), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, din, s.d_state), dtype=torch.float32,
                         device=device),
    }


def ssm_decode(params: dict, x: torch.Tensor, state: dict, cfg: ArchConfig,
               shd: Sharder = NOSHARD) -> tuple[torch.Tensor, dict]:
    """One token: x [B, 1, d] -> ([B, 1, d], state), the state updated in
    place."""
    s = cfg.ssm
    din = d_inner(cfg)
    N = s.d_state
    if s.version == 1:
        x1 = x @ params["in_proj_x"]
        z = x @ params["in_proj_z"]
    else:
        z, x1, Bm, Cm, dt_h = _split_m2(params, x, cfg)

    # conv window update
    window = torch.cat([state["conv"], x1.to(state["conv"].dtype)], dim=1)
    xc = (window * params["conv_w"]).sum(dim=1, keepdim=True) \
        + params["conv_b"]
    xc = F.silu(xc)
    state["conv"].copy_(window[:, 1:])

    if s.version == 1:
        r = _dt_rank(cfg)
        dbc = xc @ params["x_proj"]
        dt = F.softplus(dbc[..., :r] @ params["dt_proj"] + params["dt_bias"])
        Bm, Cm = dbc[..., r:r + N], dbc[..., r + N:]
        A = torch.exp(params["A_log"])
        D = params["D"]
    else:
        dt_h = F.softplus(dt_h + params["dt_bias"])
        dt = torch.repeat_interleave(dt_h, s.headdim, dim=-1)
        A = torch.repeat_interleave(torch.exp(params["A_log"]),
                                    s.headdim)[:, None].expand(din, N)
        D = torch.repeat_interleave(params["D"], s.headdim)

    dtf = dt[:, 0].float()                                 # [B, din]
    xf = xc[:, 0].float()
    decay = torch.exp(-dtf[..., None] * A)                 # [B, din, N]
    inp = (dtf * xf)[..., None] * Bm[:, 0, None, :].float()
    h = shd.ssm_state(decay * state["h"] + inp)
    state["h"].copy_(h)
    y = (h * Cm[:, 0, None, :].float()).sum(-1)            # [B, din]
    y = y + D * xf
    y = y[:, None] * F.silu(z.float())
    if s.version == 2:
        y = rmsnorm(y.to(x.dtype), params["norm_w"], cfg.norm_eps)
    else:
        y = y.to(x.dtype)
    out = shd.btd(y @ params["out_proj"])
    return out, state
