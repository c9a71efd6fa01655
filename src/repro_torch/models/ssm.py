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

Under tensor parallelism (``shd.tp``) a rank runs its own ``d_inner``
channels, as the reference's specs split ``in_proj_x``/``in_proj_z``,
``conv_w``/``conv_b``, ``x_proj``, ``dt_proj``, Mamba-1's
``A_log``/``D``/``dt_bias``, ``norm_w`` and ``out_proj``: a channel's
conv and scan do not depend on the others.  Where a product contracts
``d_inner`` it sums over ``model`` forward and backward
(``sum_over_model``): Mamba-1's ``x_proj``, Mamba-2's gated RMS norm's
sum of squares.  ``out_proj`` is row-parallel.  Mamba-2's ``in_proj_bc``
and ``in_proj_dt`` and its per-head ``dt_bias``/``A_log``/``D`` are
replicated; their outputs enter the rank's channels through
``copy_to_model``, and each rank takes its own heads.  The decode state
holds the cache's ``seq`` ranks' channels (the reference's
``ssm_state`` layout): the rank's own where that split is the compute's,
else the state crosses between the two splits
(``TensorParallel.state_to_cache``/``state_from_cache``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (NOSHARD, Sharder, dense_init,
                                       init_device, randn, rmsnorm,
                                       rmsnorm_init)
from repro_torch.parallel.tensor_parallel import (copy_to_model,
                                                  reduce_from_model,
                                                  sum_over_model)


def _dt_rank(cfg: ArchConfig) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def ssm_init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32,
             *, device=None) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    din = d_inner(cfg)
    N = s.d_state
    dev = init_device(gen, device)

    def const(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    def conv_w():
        w = randn(gen, (s.d_conv, din), dev)
        return (w * (s.d_conv * din) ** -0.5).to(dtype)
    if s.version == 1:
        r = _dt_rank(cfg)
        return {
            # split x/z projections, as the reference keeps them
            "in_proj_x": dense_init(gen, d, din, dtype, device=dev),
            "in_proj_z": dense_init(gen, d, din, dtype, device=dev),
            "conv_w": conv_w(),
            "conv_b": torch.zeros((din,), dtype=dtype, device=dev),
            "x_proj": dense_init(gen, din, r + 2 * N, dtype, device=dev),
            "dt_proj": dense_init(gen, r, din, dtype, device=dev),
            "dt_bias": const((din,), -4.6),        # softplus ~ 0.01
            "A_log": torch.log(torch.arange(
                1, N + 1, dtype=torch.float32, device=dev)).expand(
                    din, N).clone(),
            "D": const((din,), 1.0),
            "out_proj": dense_init(gen, din, d, dtype, scale=din ** -0.5,
                                   device=dev),
        }
    H = din // s.headdim                            # mamba2 / SSD
    return {
        "in_proj_x": dense_init(gen, d, din, dtype, device=dev),
        "in_proj_z": dense_init(gen, d, din, dtype, device=dev),
        "in_proj_bc": dense_init(gen, d, 2 * N, dtype, device=dev),
        "in_proj_dt": dense_init(gen, d, H, dtype, device=dev),
        "conv_w": conv_w(),
        "conv_b": torch.zeros((din,), dtype=dtype, device=dev),
        "dt_bias": const((H,), -4.6),
        "A_log": const((H,), 0.0),
        "D": const((H,), 1.0),
        "norm_w": rmsnorm_init(din, dtype, dev),
        "out_proj": dense_init(gen, din, d, dtype, scale=din ** -0.5,
                               device=dev),
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
    arguments, but where autograd records (a training forward): there each
    step builds new tensors of the same values, since autograd cannot
    differentiate a slice written from an overlapping slice of itself."""
    ck = decay.shape[1]
    off = 1
    grad = torch.is_grad_enabled() and (decay.requires_grad
                                        or inp.requires_grad)
    while off < ck:
        if grad:
            inp = torch.cat([inp[:, :off], inp[:, off:]
                             + decay[:, off:] * inp[:, :-off]], 1)
            decay = torch.cat([decay[:, :off],
                               decay[:, off:] * decay[:, :-off]], 1)
        else:
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


def _local(params: dict, cfg: ArchConfig, shd: Sharder) -> dict:
    """The layer's weights as the rank computes with them: its
    ``d_inner`` channels of every split weight (all of them off tensor
    parallelism)."""
    tp = shd.tp
    if tp is None:
        return params
    dims = {"in_proj_x": 1, "in_proj_z": 1, "conv_w": 1, "conv_b": 0,
            "x_proj": 0, "dt_proj": 1, "norm_w": 0, "out_proj": 0}
    if cfg.ssm.version == 1:
        dims.update(dt_bias=0, A_log=0, D=0)
    return {k: tp.ssm_channels(w, cfg, dims[k]) if k in dims else w
            for k, w in params.items()}


def _heads_m2(v: torch.Tensor, cfg: ArchConfig, shd: Sharder
              ) -> torch.Tensor:
    """Mamba-2's per-head values [..., H] (computed whole on every rank)
    for the rank's heads, repeated over each head's ``headdim``
    channels; under tensor parallelism entering the rank's own compute
    through ``copy_to_model``."""
    tp = shd.tp
    if tp is not None:
        h0, h1 = tp.heads(v.shape[-1])
        v = copy_to_model(v, tp)[..., h0:h1]
    return torch.repeat_interleave(v, cfg.ssm.headdim, dim=-1)


def _in_proj(params, x, cfg: ArchConfig, shd: Sharder):
    """(z, x1 before the conv) of the rank's channels, and Mamba-2's
    (Bm, Cm, dt_h) from the replicated projections, whole."""
    xin = copy_to_model(x, shd.tp)
    z = xin @ params["in_proj_z"]
    x1 = xin @ params["in_proj_x"]
    if cfg.ssm.version == 1:
        return z, x1, None
    N = cfg.ssm.d_state
    bc = copy_to_model(x @ params["in_proj_bc"], shd.tp)
    return z, x1, (bc[..., :N], bc[..., N:], x @ params["in_proj_dt"])


def _selective(params, xc, m2, cfg: ArchConfig, shd: Sharder):
    """(dt, Bm, Cm, A, D) of the scan from the conv's output ``xc`` (the
    rank's channels) and Mamba-2's projections ``m2``."""
    s = cfg.ssm
    N = s.d_state
    if s.version == 1:
        r = _dt_rank(cfg)
        dbc = sum_over_model(xc @ params["x_proj"], shd.tp)
        dt = F.softplus(dbc[..., :r] @ params["dt_proj"] + params["dt_bias"])
        Bm, Cm = dbc[..., r:r + N], dbc[..., r + N:]
        A = torch.exp(params["A_log"])
        D = params["D"]
    else:
        Bm, Cm, dt_h = m2
        dt = _heads_m2(F.softplus(dt_h + params["dt_bias"]), cfg, shd)
        A = _heads_m2(torch.exp(params["A_log"]), cfg, shd)[:, None].expand(
            xc.shape[-1], N)
        D = _heads_m2(params["D"], cfg, shd)
    return dt, Bm, Cm, A, D


def _gated_norm(y, w, cfg: ArchConfig, shd: Sharder):
    """Mamba-2's RMS norm over all of ``d_inner``: under tensor
    parallelism the sum of squares of the rank's channels summed over
    ``model``."""
    if shd.tp is None:
        return rmsnorm(y, w, cfg.norm_eps)
    yf = y.float()
    ss = sum_over_model((yf * yf).sum(dim=-1, keepdim=True), shd.tp)
    return (yf * torch.rsqrt(ss / d_inner(cfg) + cfg.norm_eps)
            ).to(y.dtype) * w


def _out(params, y, z, D, x1, x, cfg: ArchConfig, shd: Sharder):
    """The skip, gate, norm and ``out_proj`` of the scan's output ``y``
    (float32, the rank's channels) -> [B, L, d]."""
    y = y + D * x1.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    if cfg.ssm.version == 2:
        y = _gated_norm(y, params["norm_w"], cfg, shd)
    return shd.btd(reduce_from_model(y @ params["out_proj"], shd.tp))


def ssm_scan(params: dict, x: torch.Tensor, cfg: ArchConfig,
             shd: Sharder = NOSHARD) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: x [B, L, d] -> ([B, L, d], final state
    [B, d_inner, N] of the rank's channels), the state the reference's
    prefill recomputes."""
    s = cfg.ssm
    params = _local(params, cfg, shd)
    z, x1, m2 = _in_proj(params, x, cfg, shd)
    x1 = F.silu(_causal_conv(x1, params["conv_w"], params["conv_b"]))
    x1 = shd.btf(x1)
    dt, Bm, Cm, A, D = _selective(params, x1, m2, cfg, shd)
    h0 = torch.zeros((x.shape[0], x1.shape[-1], s.d_state),
                     dtype=torch.float32, device=x.device)
    y, h = _scan_chunks(h0, x1, dt, Bm, Cm, A, s.chunk)
    return _out(params, y, z, D, x1, x, cfg, shd), h


def ssm_train(params: dict, x: torch.Tensor, cfg: ArchConfig,
              shd: Sharder = NOSHARD) -> torch.Tensor:
    """Full-sequence forward: x [B, L, d] -> [B, L, d]."""
    return ssm_scan(params, x, cfg, shd)[0]


def ssm_prefill(params: dict, x: torch.Tensor, cfg: ArchConfig,
                shd: Sharder, state: dict) -> torch.Tensor:
    """``ssm_scan`` of the prompt, its final conv window (the last
    d_conv - 1 pre-conv activations) and scan state written into
    ``state`` in place, in the cache's layout: [B, L, d].  The reference
    recomputes the state after the block; the port keeps the block's own
    scan's last state, the same values."""
    k = cfg.ssm.d_conv - 1
    y, h = ssm_scan(params, x, cfg, shd)
    xin = x[:, -k:]
    window = xin @ _local(params, cfg, shd)["in_proj_x"]
    if shd.tp is not None:
        window = shd.tp.state_to_cache(window, 2, cfg)
        h = shd.tp.state_to_cache(h, 1, cfg)
    state["conv"].copy_(window)
    state["h"].copy_(h)
    return y


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
               device=None, shd: Sharder = NOSHARD) -> dict:
    """The decode state, zeroed: under tensor parallelism the cache's
    ``seq`` ranks' range of ``d_inner``."""
    s = cfg.ssm
    c0, c1 = (0, d_inner(cfg)) if shd.tp is None \
        else shd.tp.slots(d_inner(cfg))
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, c1 - c0), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, c1 - c0, s.d_state), dtype=torch.float32,
                         device=device),
    }


def ssm_decode(params: dict, x: torch.Tensor, state: dict, cfg: ArchConfig,
               shd: Sharder = NOSHARD) -> tuple[torch.Tensor, dict]:
    """One token: x [B, 1, d] -> ([B, 1, d], state), the state updated in
    place."""
    tp = shd.tp
    params = _local(params, cfg, shd)
    z, x1, m2 = _in_proj(params, x, cfg, shd)
    conv, h_prev = state["conv"], state["h"]
    if tp is not None:
        conv = tp.state_from_cache(conv, 2, cfg)
        h_prev = tp.state_from_cache(h_prev, 1, cfg)

    # conv window update
    window = torch.cat([conv, x1.to(conv.dtype)], dim=1)
    xc = (window * params["conv_w"]).sum(dim=1, keepdim=True) \
        + params["conv_b"]
    xc = F.silu(xc)
    dt, Bm, Cm, A, D = _selective(params, xc, m2, cfg, shd)

    dtf = dt[:, 0].float()                                 # [B, din]
    xf = xc[:, 0].float()
    decay = torch.exp(-dtf[..., None] * A)                 # [B, din, N]
    inp = (dtf * xf)[..., None] * Bm[:, 0, None, :].float()
    h = shd.ssm_state(decay * h_prev + inp)
    if tp is None:
        state["conv"].copy_(window[:, 1:])
        state["h"].copy_(h)
    else:
        state["conv"].copy_(tp.state_to_cache(window[:, 1:], 2, cfg))
        state["h"].copy_(tp.state_to_cache(h, 1, cfg))
    y = (h * Cm[:, 0, None, :].float()).sum(-1)            # [B, din]
    out = _out(params, y[:, None], z, D, xc, x, cfg, shd)
    return out, state
