"""Fault injection of the PyTorch port.

Only :mod:`repro_torch.faults.inject` (the forced-divergence hook behind
the steady solver's fallback chain) is ported; the sensor-fault models
and ``GuardedPolicy`` follow with the replay's fault support.
"""
from repro_torch.faults.inject import poison_solver, solver_poisoned

__all__ = ["poison_solver", "solver_poisoned"]
