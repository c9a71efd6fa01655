"""``repro_torch.policy`` — the DVFS/DTM policy engine (PyTorch port of
``repro.policy``).

A *policy* is a sampled dynamic-thermal-management controller behind the
common :class:`~repro_torch.policy.base.Policy` protocol: it reads
measured start-of-interval hot spots and sets the next interval's power
and performance duty.  The closed-loop replay
(``repro_torch.stack.feedback``) threads the policy state through its
interval loop, and ``SweepSpec.policies`` sweeps the registered names
below as a scenario axis.

``"guarded"`` is ``repro_torch.faults.GuardedPolicy`` around
:class:`PerDiePolicy` (imported when asked for, as in the reference, since
``faults`` imports this package).
"""
from typing import Callable

from repro_torch.policy.base import (Policy, PolicyContext, check_floor,
                                     check_trip, masked_hot, ramp_duty)
from repro_torch.policy.controllers import (DVFSPolicy, HysteresisPolicy,
                                            PerDiePolicy, PIDPolicy,
                                            PredictivePolicy, RampPolicy)
from repro_torch.policy.dvfs import (DVFSTable, OperatingPoint,
                                     build_dvfs_table, nodes)
from repro_torch.policy.pareto import dominates, pareto_front


def _guarded_perdie() -> Policy:
    from repro_torch.faults.guard import GuardedPolicy
    return GuardedPolicy(inner=PerDiePolicy())


#: name -> zero-argument factory for the sweepable policy family; the
#: names are SweepSpec.policies values and the `policy/<name>/*`
#: telemetry prefixes
POLICIES: dict[str, Callable[[], Policy]] = {
    "ramp": RampPolicy,
    "step": lambda: RampPolicy(ramp_C=0.0),
    "hysteresis": HysteresisPolicy,
    "pid": PIDPolicy,
    "perdie": PerDiePolicy,
    "dvfs": DVFSPolicy,
    "predictive": PredictivePolicy,
    "guarded": _guarded_perdie,
}


def names() -> tuple[str, ...]:
    """Registered policy names, registration order."""
    return tuple(POLICIES)


def get(name: str) -> Policy:
    """Instantiate a registered policy by name (fresh instance)."""
    try:
        factory = POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; expected one of "
                         f"{names()}") from None
    return factory()


__all__ = [
    "Policy", "PolicyContext", "masked_hot", "ramp_duty",
    "check_trip", "check_floor",
    "RampPolicy", "HysteresisPolicy", "PIDPolicy", "PerDiePolicy",
    "DVFSPolicy", "PredictivePolicy",
    "DVFSTable", "OperatingPoint", "build_dvfs_table", "nodes",
    "dominates", "pareto_front",
    "POLICIES", "names", "get",
]
