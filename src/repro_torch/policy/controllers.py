"""The policy family: sampled DTM/DVFS controllers for the closed loop.

Port note: only :class:`RampPolicy`, the default controller of the
closed-loop replay, is ported so far; hysteresis, PID, per-die, DVFS and
predictive control follow (ROADMAP Queue 1, item 2).
"""
from __future__ import annotations

import dataclasses

from repro_torch.policy.base import (Policy, PolicyContext, check_floor,
                                     check_trip, masked_hot, ramp_duty)


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
