"""Workload registry: one place that binds a workload name to (a) its
exact bit-serial AP implementation for trace capture and (b) its
calibrated analytic :class:`repro_torch.core.models.Workload` entry.

Every registered workload provides ``run_small(n, device)`` — run an
n-element instance on the :class:`~repro_torch.core.engine.APEngine` and
return the engine counters *including* the ``trace_cycles`` /
``trace_energy`` event arrays.  Names are unique; :func:`register`
rejects duplicates.

The paper's §3.1 trio and the four suite additions register on import
of :mod:`repro_torch.workloads`.  ``mode`` picks the execution path of
the data-dependent suite workloads, as in the reference; ``device``
picks where the engine runs.
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

    ``run_small(n, mode, device)`` executes an ~n-element instance and
    returns engine counters with trace events; ``paper`` marks the
    original §3.1 trio.  ``mode`` selects device-resident execution
    ("device", the default), the per-cycle eager oracle ("eager"), or
    the op-group megakernel path ("megakernel") for the data-dependent
    workloads — the schedule-driven trio ignores it.
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


def trace_counters(name: str, n_elems: int = 64, mode: str = "device", *,
                   device="cuda") -> dict:
    """Run the named workload's ~n_elems-element instance for its trace."""
    return get(name).run_small(n_elems, mode=mode, device=device)


# ---------------------------------------------------------------------------
# suite registrations.  Each runner sizes a small exact instance off ``n``
# (the same inputs, from the same seeds, as the reference registry) so
# the captured activity profile keeps its per-phase structure.
# ---------------------------------------------------------------------------

def _run_dmm(n: int, mode: str = "device", device="cuda") -> dict:
    rng = np.random.default_rng(0)
    from repro_torch.workloads import dmm
    side = max(4, int(np.sqrt(n)) // 2 * 2)
    A = rng.integers(0, 64, (side, side), dtype=np.uint64)
    B = rng.integers(0, 64, (side, side), dtype=np.uint64)
    _, ctr = dmm.ap_matmul(A, B, m=6, device=device)
    return ctr


def _run_fft(n: int, mode: str = "device", device="cuda") -> dict:
    rng = np.random.default_rng(0)
    from repro_torch.workloads import fft
    N = 1 << max(3, int(np.log2(max(n, 8))) // 2 + 2)
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)) * (0.3 / np.sqrt(N))
    _, ctr = fft.ap_fft(x, m=12, frac=9, device=device)
    return ctr


def _run_bs(n: int, mode: str = "device", device="cuda") -> dict:
    rng = np.random.default_rng(0)
    from repro_torch.workloads import blackscholes as bs
    k = max(n, 32)
    _, ctr = bs.ap_blackscholes(rng.uniform(0.9, 1.4, k),
                                rng.uniform(0.9, 1.4, k),
                                rng.uniform(0.5, 1.5, k),
                                rng.uniform(0.2, 0.5, k), device=device)
    return ctr


def _run_sort(n: int, mode: str = "device", device="cuda") -> dict:
    rng = np.random.default_rng(0)
    from repro_torch.workloads import sort
    _, ctr = sort.ap_sort(rng.integers(0, 256, max(n, 32),
                                       dtype=np.uint64), m=8, mode=mode,
                          device=device)
    return ctr


def _run_spmv(n: int, mode: str = "device", device="cuda") -> dict:
    rng = np.random.default_rng(0)
    from repro_torch.workloads import spmv
    n_rows = max(8, int(np.sqrt(max(n, 16))))
    nnz = max(n, 16)
    r = rng.integers(0, n_rows, nnz)
    c = rng.integers(0, n_rows, nnz)
    v = rng.integers(0, 50, nnz, dtype=np.uint64)
    x = rng.integers(0, 50, n_rows, dtype=np.uint64)
    _, ctr = spmv.ap_spmv(r, c, v, x, n_rows, m=6, mode=mode, device=device)
    return ctr


def _run_knn(n: int, mode: str = "device", device="cuda") -> dict:
    rng = np.random.default_rng(0)
    from repro_torch.workloads import knn
    rows = max(n, 32)
    # k scales with the database (capped) so the min-extraction phase
    # keeps its per-round structure at larger trace instances instead
    # of staying a fixed 5-round tail behind the LUT distance sweep
    k = min(64, max(5, rows // 8))
    db = rng.integers(0, 16, (rows, 4), dtype=np.uint64)
    q = rng.integers(0, 16, 4, dtype=np.uint64)
    _, ctr = knn.ap_knn(db, q, k=min(k, rows), m=4, mode=mode,
                        device=device)
    return ctr


def hist_bins(n: int) -> int:
    """Bin count for a histogram trace instance: more bins at larger
    instances keep the per-bin activity structure (and the bin-probe
    phase from degenerating to a handful of cycles), capped at one bin
    per value (2^6 for the m=6 trace instances).  Power of two, as
    ``ap_histogram`` requires."""
    return 1 << int(np.log2(max(8, min(64, n // 4))))


def _run_hist(n: int, mode: str = "device", device="cuda") -> dict:
    rng = np.random.default_rng(0)
    from repro_torch.workloads import histogram
    _, ctr = histogram.ap_histogram(
        rng.integers(0, 64, max(n, 32), dtype=np.uint64),
        n_bins=hist_bins(n), m=6, mode=mode, device=device)
    return ctr


for _wd in (
    WorkloadDef("dmm", "dense matrix multiply (§3.1)", _run_dmm, paper=True),
    WorkloadDef("fft", "radix-2 FFT (§3.1)", _run_fft, paper=True),
    WorkloadDef("bs", "Black-Scholes (§3.1)", _run_bs, paper=True),
    WorkloadDef("sort", "associative sort (min-extraction)", _run_sort),
    WorkloadDef("spmv", "sparse matrix-vector multiply", _run_spmv),
    WorkloadDef("knn", "k-nearest-neighbour search", _run_knn),
    WorkloadDef("hist", "histogram (response-counter binning)", _run_hist),
):
    register(_wd)
