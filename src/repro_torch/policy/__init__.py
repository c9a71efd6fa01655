"""``repro_torch.policy`` — the DTM policy protocol and its default
controller (the linear ramp), ported from ``repro.policy``."""
from repro_torch.policy.base import (Policy, PolicyContext, check_floor,
                                     check_trip, masked_hot, ramp_duty)
from repro_torch.policy.controllers import RampPolicy

__all__ = ["Policy", "PolicyContext", "masked_hot", "ramp_duty",
           "check_trip", "check_floor", "RampPolicy"]
