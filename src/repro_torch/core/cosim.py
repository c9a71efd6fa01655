"""Power-trace co-simulation helpers (PyTorch port).

1. **Trace capture** — ``APEngine`` meters every compare/write pass with
   its exact matched-row energy accounting; :func:`trace_from_counters`
   bins those events into n equal cycle windows (energy-conserving).  The
   SIMD reference gets an analytic two-phase trace from the eq-(14)
   execute/sync decomposition (:func:`simd_phase_trace`).
2. **Replay** — the closed-loop replay of ``repro_torch.stack.feedback``
   modulates floorplan power maps by these traces.

Time base: small AP kernel instances run in microseconds of engine time
while package thermal constants are ~0.1 s, so the replay *dilates* the
trace onto a configurable ``t_end`` — the trace supplies the activity
profile's shape, the design point supplies its mean wattage.

Port note: this slice ports what the closed-loop replay needs —
:class:`PowerTrace`, :func:`trace_from_counters`, :func:`trace_elems`,
:func:`ap_workload_trace`, :func:`simd_phase_trace`,
:func:`interval_forecaster` and :func:`comparable_design_point`.  The
open-loop ``cosim_transient`` replay, ``run_cosim``, frame synthesis and
interval coarsening follow (ROADMAP Queue 1, item 2).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import models as M
from repro_torch.core.engine import bin_energy_trace


@dataclasses.dataclass(frozen=True)
class PowerTrace:
    """Per-interval dynamic activity of one die layer (dimensionless).

    ``activity`` has mean 1.0 over the trace, so scaling by a design
    point's per-layer dynamic wattage preserves its time-averaged power.
    ``native_s`` is the engine time the trace actually spans (cycles at
    ``M.AP_CLOCK_HZ``) before replay dilation, 0 for analytic traces.
    """
    activity: np.ndarray
    source: str = ""
    native_s: float = 0.0

    @property
    def n_intervals(self) -> int:
        return int(self.activity.shape[0])


def trace_from_counters(counters: dict, n_intervals: int,
                        source: str = "") -> PowerTrace:
    """Bin a workload's engine events (``counters['trace_*']``) into an
    activity profile.  Energy-conserving: mean(activity) == 1 exactly."""
    total_cycles = max(int(counters["cycles"]), 1)
    _, bins = bin_energy_trace(counters["trace_cycles"],
                               counters["trace_energy"],
                               total_cycles, n_intervals)
    mean = bins.mean()
    if mean <= 0.0:
        return PowerTrace(np.ones(n_intervals), source,
                          total_cycles / M.AP_CLOCK_HZ)
    return PowerTrace(bins / mean, source, total_cycles / M.AP_CLOCK_HZ)


def trace_elems(size: int) -> int:
    """Small-instance element count for a dataset size: sqrt(N) clamped
    to [32, 2^20] — the one sizing rule every entry point shares, so
    the same nominal scenario always replays the same trace."""
    return int(min(max(math.sqrt(size), 32), 1 << 20))


def ap_workload_trace(workload: str, n_intervals: int = 64,
                      n_elems: int = 64, mode: str = "device", *,
                      device="cuda") -> PowerTrace:
    """Run a small instance of the named AP workload on ``device`` and
    bin its measured energy events.  ``n_elems`` scales the instance;
    ``mode`` picks the execution path ("device" / "eager" /
    "megakernel") — all three are bit-identical, so it only affects
    capture speed.

    Cached per (workload, n_intervals, n_elems, mode, device): the device
    is part of the key, so a CPU capture never serves a CUDA run.
    """
    return _ap_workload_trace(workload, n_intervals, n_elems, mode,
                              str(resolve_device(device)))


@functools.lru_cache(maxsize=None)
def _ap_workload_trace(workload: str, n_intervals: int, n_elems: int,
                       mode: str, device: str) -> PowerTrace:
    from repro_torch.workloads import registry

    ctr = registry.trace_counters(workload, n_elems, mode=mode,
                                  device=device)
    return trace_from_counters(ctr, n_intervals, source=f"ap:{workload}")


def simd_phase_trace(wl: M.Workload, dp: M.DesignPoint,
                     n_intervals: int = 64,
                     period_intervals: int = 8) -> PowerTrace:
    """Analytic SIMD trace: eq (14) splits runtime into execute and
    synchronize phases; instantaneous dynamic power alternates between the
    two levels at the duty cycle f_run = (1/n) / (1/n + I_s)."""
    p_exec_W, p_sync_W, f_run = M.simd_phase_powers(wl, dp.simd_n_pus)
    lvl_exec = p_exec_W / max(f_run, 1e-9)
    lvl_sync = p_sync_W / max(1.0 - f_run, 1e-9)
    act = np.empty(n_intervals)
    for i in range(n_intervals):
        phase = (i % period_intervals) / period_intervals
        act[i] = lvl_exec if phase < f_run else lvl_sync
    return PowerTrace(act / act.mean(), source=f"simd:{wl.name}")


def interval_forecaster(A, solve, logic_mask3: torch.Tensor, t_amb: float):
    """One-substep RC forecast of the logic hot spot, affine in the duty.

    Built per interval inside the replay and handed to policies as
    ``PolicyContext.predict_hot``: ``predict(dT, P_dyn, P_stat)`` yields
    ``hot(cands)`` — for duty candidates ``cands [K]``, the forecast
    end-of-substep logic hot spots ``[B, K]`` of each case under power
    ``f·P_dyn + P_stat``.  The theta-step response is affine in ``f``, so
    all candidates cost two inner solves:

        dT(f) = dT + solve(P_stat − A dT) + f · solve(P_dyn)

    ``logic_mask3`` is ``[B, L, 1, 1]``; the solves run only when
    ``hot`` is called, so a policy that never forecasts costs nothing.
    """
    def predict(dT, P_dyn, P_stat):
        def hot(cands):
            base = dT + solve(P_stat - A(dT))
            gain = solve(P_dyn)
            fields = base[:, None] + cands[None, :, None, None, None] \
                * gain[:, None]
            masked = torch.where(logic_mask3[:, None] > 0, fields + t_amb,
                                 -math.inf)
            return masked.amax(dim=(2, 3, 4))
        return hot
    return predict


def comparable_design_point(workload: str | M.Workload,
                            n_ap_start: int = M.N_DATA) -> M.DesignPoint:
    """Largest same-performance AP/SIMD pair that exists for a workload.

    A SIMD can only match AP speedups below its synchronization ceiling
    1/I_s (eq 3).  For dmm/bs the paper's full-size AP (n = 2^20) is
    comparable; for fft it is not, so the AP is halved from
    ``n_ap_start`` until the comparison point exists.
    """
    if isinstance(workload, M.Workload):
        wl = workload
    elif workload in M.WORKLOADS:
        wl = M.WORKLOADS[workload]
    else:
        raise ValueError(f"unknown workload {workload!r}; expected one of "
                         f"{sorted(M.WORKLOADS)}")
    n_ap = n_ap_start
    while n_ap >= 1024:
        try:
            return M.design_point(wl, n_ap)
        except ValueError:
            n_ap //= 2
    raise ValueError(f"no comparable design point for {wl.name!r}")
