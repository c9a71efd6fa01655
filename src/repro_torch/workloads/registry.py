"""Workload registry: one place that binds a workload name to (a) its
exact bit-serial AP implementation for trace capture and (b) its
calibrated analytic :class:`repro_torch.core.models.Workload` entry.

Every registered workload provides ``run_small(n, device)`` — run an
n-element instance on the :class:`~repro_torch.core.engine.APEngine` and
return the engine counters *including* the ``trace_cycles`` /
``trace_energy`` event arrays.  Names are unique; :func:`register`
rejects duplicates.

Port note: only the paper's §3.1 trio is registered so far (the four
suite workloads follow, ROADMAP Queue 1, item 1).  The trio is
schedule-driven, so the reference's ``mode`` argument (which picks an
execution path for data-dependent workloads) has no counterpart here;
``device`` picks where the engine runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core import models as M

_REGISTRY: dict[str, "WorkloadDef"] = {}


@dataclasses.dataclass(frozen=True)
class WorkloadDef:
    """One registered workload.

    ``run_small(n, device)`` executes an ~n-element instance and returns
    engine counters with trace events; ``paper`` marks the original §3.1
    trio.
    """
    name: str
    title: str
    run_small: Callable[..., dict]
    paper: bool = False

    @property
    def model(self) -> M.Workload:
        """The calibrated analytic entry (eqs (2)-(17) constants)."""
        return M.WORKLOADS[self.name]


def register(wd: WorkloadDef) -> WorkloadDef:
    if wd.name in _REGISTRY:
        raise ValueError(f"workload {wd.name!r} already registered")
    if wd.name not in M.WORKLOADS:
        raise ValueError(f"workload {wd.name!r} has no calibrated "
                         f"models.Workload entry")
    _REGISTRY[wd.name] = wd
    return wd


def get(name: str) -> WorkloadDef:
    if name not in _REGISTRY:
        raise ValueError(f"unknown workload {name!r}; registered: "
                         f"{names()}")
    return _REGISTRY[name]


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def trace_counters(name: str, n_elems: int = 64, *,
                   device="cuda") -> dict:
    """Run the named workload's ~n_elems-element instance for its trace."""
    return get(name).run_small(n_elems, device=device)


# ---------------------------------------------------------------------------
# trio registrations.  Each runner sizes a small exact instance off ``n``
# (the same inputs, from the same seeds, as the reference registry) so
# the captured activity profile keeps its per-phase structure.
# ---------------------------------------------------------------------------

def _run_dmm(n: int, device="cuda") -> dict:
    rng = np.random.default_rng(0)
    from repro_torch.workloads import dmm
    side = max(4, int(np.sqrt(n)) // 2 * 2)
    A = rng.integers(0, 64, (side, side), dtype=np.uint64)
    B = rng.integers(0, 64, (side, side), dtype=np.uint64)
    _, ctr = dmm.ap_matmul(A, B, m=6, device=device)
    return ctr


def _run_fft(n: int, device="cuda") -> dict:
    rng = np.random.default_rng(0)
    from repro_torch.workloads import fft
    N = 1 << max(3, int(np.log2(max(n, 8))) // 2 + 2)
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)) * (0.3 / np.sqrt(N))
    _, ctr = fft.ap_fft(x, m=12, frac=9, device=device)
    return ctr


def _run_bs(n: int, device="cuda") -> dict:
    rng = np.random.default_rng(0)
    from repro_torch.workloads import blackscholes as bs
    k = max(n, 32)
    _, ctr = bs.ap_blackscholes(rng.uniform(0.9, 1.4, k),
                                rng.uniform(0.9, 1.4, k),
                                rng.uniform(0.5, 1.5, k),
                                rng.uniform(0.2, 0.5, k), device=device)
    return ctr


for _wd in (
    WorkloadDef("dmm", "dense matrix multiply (§3.1)", _run_dmm, paper=True),
    WorkloadDef("fft", "radix-2 FFT (§3.1)", _run_fft, paper=True),
    WorkloadDef("bs", "Black-Scholes (§3.1)", _run_bs, paper=True),
):
    register(_wd)
