"""``repro_torch.faults`` — fault injection & graceful degradation
(PyTorch port of ``repro.faults``).

- :mod:`repro_torch.faults.models` — deterministic sensor-fault models
  (:class:`SensorFaultSpec`) read once an interval by the closed-loop
  replay via ``FeedbackParams.faults``, with the reference's seeded
  ``jax.random`` draws repeated in PyTorch, plus host-side power-spike
  injection (:class:`PowerFaultSpec`).
- :mod:`repro_torch.faults.guard` — :class:`GuardedPolicy`, hardening any
  DTM controller with median-of-K sensor fusion, last-good hold, and a
  fail-safe floor duty (registered as ``"guarded"``).
- :mod:`repro_torch.faults.inject` — :func:`poison_solver`, the
  deterministic forced-divergence hook behind the solver fallback chain.
"""
from repro_torch.faults.guard import GuardedPolicy
from repro_torch.faults.inject import poison_solver, solver_poisoned
from repro_torch.faults.models import (FaultState, PowerFaultSpec,
                                       SensorFaultSpec, inject_power_spikes)

__all__ = [
    "SensorFaultSpec", "FaultState", "PowerFaultSpec",
    "inject_power_spikes", "GuardedPolicy", "poison_solver",
    "solver_poisoned",
]
