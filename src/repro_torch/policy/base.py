"""The DVFS/DTM policy protocol and shared controller math (PyTorch port).

A *policy* is the sampled controller that turns measured start-of-interval
temperatures into a power/performance operating point for the next
interval of the closed-loop replay (``repro_torch.stack.feedback``).
Policies are frozen dataclasses.  :meth:`Policy.act` runs inside the
replay's interval loop, so it must not sync with the host: no Python
branch on a tensor, no ``.item()``.

Contract (one call per trace interval, for the whole case batch):

``init_state(n_layers=None)``
    The controller's carry (``()`` for stateless controllers).  It knows
    neither the batch nor the device, so a stateful controller returns
    Python numbers here and its first ``act`` broadcasts them to ``[B]``
    tensors on the batch's device: every case owns its state.

``act(state, ctx) -> (state', f_power, f_perf)``
    ``ctx`` is a :class:`PolicyContext` of *measured* (start-of-interval)
    quantities.  ``f_power`` scales the interval's dynamic power — ``[B]``
    (all layers of a case together, the classic throttle) or ``[B, L]``
    (per-die control).  ``f_perf`` ``[B]`` is the performance duty in
    ``(0, 1]`` the runtime-slowdown accounting uses (``mean(1/f_perf)``).

Port note: the reference vmaps one case's controller over the batch; here
the batch is a leading dimension written out, so every ``[L]`` quantity of
the reference is ``[B, L]`` and every scalar is ``[B]``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch


class PolicyContext(NamedTuple):
    """Measured inputs handed to :meth:`Policy.act` each interval.

    ``layer_T`` [B, L]: per-layer hot-spot temperature (°C) at the
    interval start; ``logic_mask``/``dram_mask`` [B, L]: 1.0 on layers of
    that kind; ``predict_hot``: duty candidates [K] → forecast logic hot
    spots [B, K] one replay substep ahead (``cosim.interval_forecaster``).
    ``sensor_T`` is always ``None`` in this port (sensor faults are not
    ported yet).
    """
    layer_T: torch.Tensor
    logic_mask: torch.Tensor
    dram_mask: torch.Tensor
    predict_hot: Callable[[torch.Tensor], torch.Tensor]
    sensor_T: torch.Tensor | None = None


def masked_hot(layer_T: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Hot spot over the masked layers of each case, [B] (−inf when a
    case's mask is empty)."""
    return torch.where(mask > 0, layer_T, -math.inf).amax(dim=-1)


def ramp_duty(t_C: torch.Tensor, trip_C: float, ramp_C: float,
              floor: float) -> torch.Tensor:
    """The linear throttle law: duty 1 below ``trip_C``, ramping to
    ``floor`` over ``ramp_C`` degrees.  ``ramp_C == 0`` is a legal step
    trip (duty drops straight to the floor above ``trip_C``)."""
    if ramp_C == 0.0:
        return torch.where(t_C > trip_C, floor, 1.0).to(t_C.dtype)
    return torch.clamp(1.0 - (t_C - trip_C) / ramp_C, floor, 1.0)


def check_trip(trip_C: float, name: str = "trip_C") -> None:
    """Trip temperatures must be real or +inf (= never trips)."""
    if math.isnan(trip_C) or trip_C == -math.inf:
        raise ValueError(f"{name} must be a real temperature or math.inf "
                         f"(never trips); got {trip_C!r}")


def check_floor(floor: float, name: str = "floor") -> None:
    """Duty floors must sit in (0, 1] — 0 would make the slowdown
    accounting ``mean(1/f)`` divide by zero, above 1 is not a floor."""
    if not (0.0 < floor <= 1.0):
        raise ValueError(f"{name} must lie in (0, 1]; got {floor!r}")


@dataclasses.dataclass(frozen=True)
class Policy:
    """Base class: a no-op controller (always full power).

    Subclasses override :meth:`act` (and :meth:`init_state` when they
    carry state).  The base class doubles as the explicit "no DTM"
    policy.
    """

    @property
    def name(self) -> str:
        return type(self).__name__.removesuffix("Policy").lower()

    def init_state(self, n_layers: int | None = None):
        return ()

    def act(self, state, ctx: PolicyContext):
        one = torch.ones(ctx.layer_T.shape[0], dtype=ctx.layer_T.dtype,
                         device=ctx.layer_T.device)
        return state, one, one

    def residency(self, duty) -> dict[str, float] | None:
        """Optional post-hoc residency attribution for a recorded duty
        trace (``None`` = no discrete operating points to attribute)."""
        return None
