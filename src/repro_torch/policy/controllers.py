"""The policy family: sampled DTM/DVFS controllers for the closed loop
(PyTorch port of ``repro.policy.controllers``).

Every controller here implements the :class:`~repro_torch.policy.base.Policy`
protocol and is registered by name in ``repro_torch.policy`` — that name
is what :class:`~repro_torch.sweep.spec.SweepSpec` sweeps over.  All of
them actuate on the *measured* start-of-interval hot spots.

Port note: the reference vmaps one case's controller over the batch; here
each ``act`` sees the whole batch (``ctx.layer_T`` ``[B, L]``), so every
scalar of the reference is a ``[B]`` tensor.  A stateful controller's
``init_state`` returns a Python number, because it knows neither the
batch nor the device; the first ``act`` broadcasts it against the
batch's own tensors, so from then on every case carries its own state
(hysteresis latch, PID integral and error, DVFS operating point) on the
device, and nothing crosses to the host.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.policy.base import (Policy, PolicyContext, check_floor,
                                     check_trip, masked_hot, ramp_duty)
from repro_torch.policy.dvfs import DVFSTable, build_dvfs_table


@functools.lru_cache(maxsize=None)
def _device_floats(values: tuple[float, ...], device: torch.device
                   ) -> torch.Tensor:
    """A float32 tensor of ``values`` on ``device``, made once for each
    (values, device): a policy's constant tables cross to the card once,
    not once an interval."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _float32_linspace(start: float, stop: float, num: int
                      ) -> tuple[float, ...]:
    """The float32 values of ``jnp.linspace(float32(start),
    float32(stop), num)`` as the reference's jitted replay folds it:
    ``start·(1 − s) + stop·s`` with ``s = i · (1 / (num − 1))`` in float32
    (XLA turns the division by a constant into a product by its
    reciprocal), the last value ``stop`` exactly."""
    a, b = np.float32(start), np.float32(stop)
    s = np.arange(num - 1, dtype=np.float32) \
        * (np.float32(1.0) / np.float32(num - 1))
    out = a * (np.float32(1.0) - s) + b * s
    return tuple(float(v) for v in out) + (float(b),)


@dataclasses.dataclass(frozen=True)
class RampPolicy(Policy):
    """The classic linear throttle: duty ramps from 1 at ``trip_C`` down
    to ``floor`` over ``ramp_C`` degrees, sensed on the logic hot spot.
    ``ramp_C = 0`` is a step trip."""
    trip_C: float = 95.0
    ramp_C: float = 10.0
    floor: float = 0.25

    def __post_init__(self):
        check_trip(self.trip_C)
        check_floor(self.floor)
        if self.ramp_C < 0:
            raise ValueError(f"ramp_C must be >= 0; got {self.ramp_C!r}")

    def act(self, state, ctx: PolicyContext):
        t = masked_hot(ctx.layer_T, ctx.logic_mask)
        f = ramp_duty(t, self.trip_C, self.ramp_C, self.floor)
        return state, f, f


@dataclasses.dataclass(frozen=True)
class HysteresisPolicy(Policy):
    """Bang-bang throttle with a release band.

    Trips to ``floor`` when the logic hot spot exceeds ``trip_C`` and
    releases back to full duty only once it has cooled below
    ``trip_C - band_C``; inside the band each case HOLDS its previous
    decision.
    """
    trip_C: float = 95.0
    band_C: float = 5.0
    floor: float = 0.25

    def __post_init__(self):
        check_trip(self.trip_C)
        check_floor(self.floor)
        if self.band_C < 0:
            raise ValueError(f"band_C must be >= 0; got {self.band_C!r}")

    def init_state(self, n_layers: int | None = None):
        return 0.0                       # 1.0 while throttled

    def act(self, state, ctx: PolicyContext):
        t = masked_hot(ctx.layer_T, ctx.logic_mask)
        held = state if torch.is_tensor(state) else torch.full_like(t, state)
        on = torch.where(t > self.trip_C, 1.0,
                         torch.where(t < self.trip_C - self.band_C, 0.0,
                                     held))
        f = torch.where(on > 0, self.floor, 1.0).to(t.dtype)
        return on, f, f


@dataclasses.dataclass(frozen=True)
class PIDPolicy(Policy):
    """PID regulation of the logic hot spot onto ``target_C``.

    Duty = ``clip(1 - (kp·e + ki·∫e + kd·Δe), floor, 1)`` with
    ``e = T_hot - target_C``.  The integral is clamped to
    ``[0, (1 - floor)/ki]`` (anti-windup).
    """
    target_C: float = 90.0
    kp: float = 0.10
    ki: float = 0.02
    kd: float = 0.05
    floor: float = 0.25

    def __post_init__(self):
        check_trip(self.target_C, "target_C")
        check_floor(self.floor)
        if min(self.kp, self.ki, self.kd) < 0:
            raise ValueError("PID gains must be >= 0")

    def init_state(self, n_layers: int | None = None):
        return (0.0, 0.0)                # (∫e, prev e)

    def act(self, state, ctx: PolicyContext):
        integ, prev = state
        err = masked_hot(ctx.layer_T, ctx.logic_mask) - self.target_C
        err = torch.clamp(err, min=-1e6)               # -inf-safe (no logic)
        i_max = (1.0 - self.floor) / self.ki if self.ki > 0 else 0.0
        integ = torch.clamp(integ + err, 0.0, i_max)
        u = self.kp * err + self.ki * integ + self.kd * (err - prev)
        f = torch.clamp(1.0 - u, self.floor, 1.0)
        return (integ, err), f, f


@dataclasses.dataclass(frozen=True)
class PerDiePolicy(Policy):
    """Independent per-die throttling for heterogeneous stacks.

    DRAM dies ramp their activate/IO power on the DRAM sensor (tripping
    at ``dram_trip_C``); logic dies ramp on their own sensor AND honor the
    DRAM ceiling.  ``f_power`` is per layer, ``[B, L]``; the performance
    duty is the logic dies'.  Layers that are neither stay at full power.
    """
    logic_trip_C: float = 95.0
    logic_ramp_C: float = 10.0
    dram_trip_C: float = 83.0
    dram_ramp_C: float = 3.0
    floor: float = 0.10

    def __post_init__(self):
        check_trip(self.logic_trip_C, "logic_trip_C")
        check_trip(self.dram_trip_C, "dram_trip_C")
        check_floor(self.floor)
        if min(self.logic_ramp_C, self.dram_ramp_C) < 0:
            raise ValueError("ramp widths must be >= 0")

    def act(self, state, ctx: PolicyContext):
        t_logic = masked_hot(ctx.layer_T, ctx.logic_mask)
        t_dram = masked_hot(ctx.layer_T, ctx.dram_mask)
        f_dram = ramp_duty(t_dram, self.dram_trip_C, self.dram_ramp_C,
                           self.floor)
        f_logic = torch.minimum(
            ramp_duty(t_logic, self.logic_trip_C, self.logic_ramp_C,
                      self.floor),
            f_dram)
        f_power = (ctx.logic_mask * f_logic[:, None]
                   + ctx.dram_mask * f_dram[:, None]
                   + (1.0 - ctx.logic_mask - ctx.dram_mask))
        return state, f_power, f_logic


@dataclasses.dataclass(frozen=True)
class DVFSPolicy(Policy):
    """Discrete DVFS stepping over a technology-node table.

    One OP step per interval: above ``trip_C`` (sensed on the hottest die
    of any kind) step down one OP; below ``trip_C - band_C`` step back up;
    inside the band hold.  Power scales with the OP's ``f·V²`` factor,
    performance with ``f`` only.
    """
    table: DVFSTable = dataclasses.field(
        default_factory=lambda: build_dvfs_table("22nm"))
    trip_C: float = 85.0
    band_C: float = 4.0

    def __post_init__(self):
        check_trip(self.trip_C)
        if self.band_C < 0:
            raise ValueError(f"band_C must be >= 0; got {self.band_C!r}")

    @property
    def name(self) -> str:
        return f"dvfs-{self.table.node}"

    def init_state(self, n_layers: int | None = None):
        return self.table.n_ops - 1                   # start at top OP

    def act(self, state, ctx: PolicyContext):
        t = torch.maximum(masked_hot(ctx.layer_T, ctx.logic_mask),
                          masked_hot(ctx.layer_T, ctx.dram_mask))
        step = torch.where(t > self.trip_C, -1,
                           torch.where(t < self.trip_C - self.band_C, 1, 0))
        idx = torch.clamp(state + step, 0, self.table.n_ops - 1)
        dev = ctx.layer_T.device
        f_power = _device_floats(self.table.power_scales(), dev)[idx]
        f_perf = _device_floats(self.table.perf_scales(), dev)[idx]
        return idx, f_power, f_perf

    def residency(self, duty) -> dict[str, float]:
        """Intervals spent at each OP, attributed by nearest perf scale
        (the recorded duty trace IS the per-interval ``f/f₀``)."""
        perf = np.asarray(self.table.perf_scales())
        idx = np.abs(np.asarray(duty, np.float64)[..., None]
                     - perf).argmin(axis=-1)
        labels = self.table.labels()
        return {labels[i]: int((idx == i).sum())
                for i in range(self.table.n_ops) if (idx == i).any()}


@dataclasses.dataclass(frozen=True)
class PredictivePolicy(Policy):
    """Model-predictive throttle: pick the highest duty whose *forecast*
    hot spot stays under ``trip_C``.

    The forecast is the closed loop's own thermal RC operator advanced
    one implicit substep under each candidate duty (``ctx.predict_hot``,
    ``[B, K]``, from ``cosim.interval_forecaster``); each case takes its
    own highest safe candidate.
    """
    trip_C: float = 95.0
    floor: float = 0.25
    n_cands: int = 8

    def __post_init__(self):
        check_trip(self.trip_C)
        check_floor(self.floor)
        if self.n_cands < 2:
            raise ValueError("n_cands must be >= 2")

    def act(self, state, ctx: PolicyContext):
        cands = _device_floats(
            _float32_linspace(self.floor, 1.0, self.n_cands),
            ctx.layer_T.device)
        hot = ctx.predict_hot(cands)                  # [B, K]
        # trip_C = inf compares True against any finite forecast
        ok = hot <= self.trip_C if math.isfinite(self.trip_C) \
            else torch.ones_like(hot, dtype=torch.bool)
        f = torch.where(ok, cands, self.floor).amax(dim=-1)
        return state, f, f
