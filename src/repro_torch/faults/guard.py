"""Graceful degradation for DTM controllers: the :class:`GuardedPolicy`
(PyTorch port of ``repro.faults.guard``).

Any registered policy senses ``PolicyContext.layer_T`` — under a
:class:`~repro_torch.faults.models.SensorFaultSpec` that is the (possibly
stuck, noisy, or NaN) PRIMARY sensor, and a naive controller inherits
every one of its failure modes.  ``GuardedPolicy`` wraps an inner policy
with three layers of hardening, in order:

1. **median-of-K** over the redundant sensors (``PolicyContext.sensor_T``,
   NaN-skipping) — rejects any minority of stuck/outlier sensors per
   layer;
2. **plausibility + last-good hold** — a fused reading must be finite,
   inside ``[lo_C, hi_C]``, and within ``max_step_C`` of the last
   accepted value; otherwise the guard holds the last good reading for
   that layer;
3. **fail-safe floor** — after ``hold_max`` consecutive implausible
   intervals on any die layer the guard clamps both duties to ``floor``.

Port notes: the fusion is :func:`nanmedian`, the reference's
``jnp.nanmedian`` (NaNs skipped, the mean of the two middle readings
when an even number is valid), not ``torch.nanmedian``, which returns
the lower of the two.  As every controller of the port, ``act`` sees the
whole case batch (``sensor_T`` ``[B, K, L]``, ``layer_T`` ``[B, L]``);
the state's per-layer ``[L]`` tensors are made on the host and move to
the batch's device on the first ``act``, after which each case carries
its own ``[B, L]`` hold and count.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.constants import AMBIENT_C
from repro_torch.policy.base import Policy, PolicyContext, check_floor


def nanmedian(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.nanmedian(x, axis=dim)``: the midpoint of the middle valid
    values along ``dim`` (NaN where none is valid), in JAX's operations:
    sort with NaNs last, ``q = 0.5 (n_valid - 1)``, ``(x[floor q] +
    x[ceil q]) * 0.5``."""
    x = torch.sort(x, dim=dim).values
    n = (~torch.isnan(x)).sum(dim=dim, keepdim=True).to(x.dtype)
    q = 0.5 * (n - 1.0)
    lo = torch.clamp(torch.minimum(torch.floor(q), n - 1.0), min=0.0)
    hi = torch.clamp(torch.minimum(torch.ceil(q), n - 1.0), min=0.0)
    low = torch.gather(x, dim, lo.long())
    high = torch.gather(x, dim, hi.long())
    return ((low + high) * 0.5).squeeze(dim)


@dataclasses.dataclass(frozen=True)
class GuardedPolicy(Policy):
    """Median-of-K + last-good-hold + fail-safe floor around ``inner``."""
    inner: Policy = dataclasses.field(default_factory=Policy)
    lo_C: float = -20.0          # plausible sensor range (DTS span)
    hi_C: float = 150.0
    max_step_C: float = 60.0     # max credible interval-to-interval jump
    hold_max: int = 3            # consecutive bad intervals before panic
    floor: float = 0.25          # fail-safe duty once panicked

    def __post_init__(self):
        check_floor(self.floor)
        if not (math.isfinite(self.lo_C) and math.isfinite(self.hi_C)
                and self.lo_C < self.hi_C):
            raise ValueError("need finite lo_C < hi_C; got "
                             f"({self.lo_C!r}, {self.hi_C!r})")
        if not (math.isfinite(self.max_step_C) and self.max_step_C > 0):
            raise ValueError("max_step_C must be finite and > 0; got "
                             f"{self.max_step_C!r}")
        if self.hold_max < 1:
            raise ValueError(f"hold_max must be >= 1; got {self.hold_max!r}")

    @property
    def name(self) -> str:
        return f"guarded-{self.inner.name}"

    def init_state(self, n_layers: int | None = None):
        if n_layers is None:
            raise ValueError("GuardedPolicy.init_state needs n_layers "
                             "(its last-good hold is per layer)")
        return (self.inner.init_state(n_layers),
                torch.full((n_layers,), AMBIENT_C, dtype=torch.float32),
                torch.zeros((n_layers,), dtype=torch.int32))

    def act(self, state, ctx: PolicyContext):
        inner_state, last_good, bad = state
        dev = ctx.layer_T.device
        if last_good.device != dev:
            last_good, bad = last_good.to(dev), bad.to(dev)
        readings = ctx.sensor_T
        if readings is None:         # fault-free replay: one true sensor
            readings = ctx.layer_T.unsqueeze(-2)
        fused = nanmedian(readings, dim=-2)
        plausible = (torch.isfinite(fused)
                     & (fused >= self.lo_C) & (fused <= self.hi_C)
                     & ((fused - last_good).abs() <= self.max_step_C))
        T_used = torch.where(plausible, fused, last_good)
        bad = torch.where(plausible, 0, bad + 1)
        inner_state, f_power, f_perf = self.inner.act(
            inner_state, ctx._replace(layer_T=T_used, sensor_T=None))
        # panic only on DIE layers the verdict cares about: a spreader
        # sensor going dark must not floor the whole stack
        die = (ctx.logic_mask + ctx.dram_mask) > 0
        panic = (die & (bad >= self.hold_max)).any(dim=-1)
        fp = panic if f_power.dim() == panic.dim() else panic[..., None]
        f_power = torch.where(fp, torch.clamp(f_power, max=self.floor),
                              f_power)
        f_perf = torch.where(panic, torch.clamp(f_perf, max=self.floor),
                             f_perf)
        return (inner_state, T_used, bad), f_power, f_perf


__all__ = ["GuardedPolicy", "nanmedian"]
