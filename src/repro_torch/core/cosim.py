"""Power-trace co-simulation helpers (PyTorch port).

1. **Trace capture** — ``APEngine`` meters every compare/write pass with
   its exact matched-row energy accounting; :func:`trace_from_counters`
   bins those events into n equal cycle windows (energy-conserving).  The
   SIMD reference gets an analytic two-phase trace from the eq-(14)
   execute/sync decomposition (:func:`simd_phase_trace`).
2. **Frame synthesis** — each interval's total dynamic power modulates
   the floorplan's spatial power map (leakage stays constant), producing
   a [T, L, NY, NX] power-frame stack over the thermal grid domain
   (:func:`power_frames`, host NumPy).
3. **Replay** — an implicit theta-scheme stepper (``thermal.pcg_fixed``
   inner solves, whose matvec is the thermal-stencil kernel on a card)
   steps the frames and records per-layer peak/min per interval
   (:func:`cosim_transient`, and :func:`cosim_transient_batch` over a
   leading batch of design points); the closed-loop replay of
   ``repro_torch.stack.feedback`` adds temperature feedback.

Time base: small AP kernel instances run in microseconds of engine time
while package thermal constants are ~0.1 s, so the replay *dilates* the
trace onto a configurable ``t_end`` — the trace supplies the activity
profile's shape, the design point supplies its mean wattage.

Interval coarsening (:class:`CoarsePlan`, :func:`coarsen_plan`) merges
runs of near-constant activity into longer intervals for the
variable-step replay (``feedback.closed_loop_replay(dt_scale=...)``);
:func:`dc_peak_rise_C` bounds the temperature error that costs.

Port notes: ``vmap`` is a leading batch dimension written out and
``lax.scan`` a Python loop that reads nothing back until the results
cross to the host.  The reference traces ``interval_dt`` and forms the
step ``interval_dt / steps_per_interval`` in float32; here it is a
Python float, rounded to float32 where it meets the capacities, which
may differ in the last bit.  ``use_pallas`` is accepted and ignored;
:func:`run_cosim` and :func:`ap_workload_trace` take the keyword-only
``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import models as M
from repro_torch.core import thermal
from repro_torch.core.constants import AMBIENT_C, DRAM_LIMIT_C
from repro_torch.core.engine import bin_energy_trace
from repro_torch.core.floorplan import MM, APFloorplan, SIMDFloorplan
from repro_torch.kernels.thermal_stencil import ops as stencil_ops
from repro_torch.stack.spec import PAPER_STACK, StackParams


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


# ---------------------------------------------------------------------------
# frame synthesis
# ---------------------------------------------------------------------------

def power_frames(trace: PowerTrace, pmap: np.ndarray, leak_W: float,
                 grid: thermal.Grid) -> np.ndarray:
    """[T, L, NY, NX] float32 power frames over the full thermal domain.

    ``pmap`` is a floorplan layer map (leakage included, as produced by
    ``*Floorplan.power_map``); leakage stays constant per interval while
    the dynamic remainder is modulated by the trace activity.  Every
    LOGIC layer carries the same map; DRAM layers of a heterogeneous
    spec, the spreader layer, and the margin ring get zero.
    """
    grid_n = pmap.shape[0]
    leak_map = np.full_like(pmap, leak_W / pmap.size)
    dyn_map = pmap - leak_map
    frames_2d = leak_map[None] + trace.activity[:, None, None] * dyn_map[None]
    T = trace.n_intervals
    L = grid.n_layers
    m = grid.margin
    out = np.zeros((T, L, grid.dom_ny, grid.dom_nx), np.float32)
    for l in grid.stack.logic_layers:
        out[:, l, m:m + grid_n, m:m + grid_n] = frames_2d
    return out


# ---------------------------------------------------------------------------
# adaptive interval coarsening (multi-hour serving horizons)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CoarsePlan:
    """A merge of consecutive base intervals into variable-length coarse
    intervals: ``reps[i]`` base intervals fold into coarse interval i.

    Built by :func:`coarsen_plan` so that the activity range inside each
    run is bounded by the plan's tolerance; the merged power is the run
    MEAN, which conserves energy exactly (equal-length base intervals).
    The replay consumes ``dt_scale`` as the per-interval step multiplier
    (``stack.feedback.closed_loop_replay(..., dt_scale=...)``).
    """
    reps: np.ndarray            # [Tc] int, each >= 1, sum == n_base

    def __post_init__(self):
        reps = np.asarray(self.reps, np.int64)
        if reps.ndim != 1 or reps.size == 0 or (reps < 1).any():
            raise ValueError("reps must be a non-empty 1-D array of "
                             "positive run lengths")
        object.__setattr__(self, "reps", reps)

    @property
    def n_coarse(self) -> int:
        return int(self.reps.size)

    @property
    def n_base(self) -> int:
        return int(self.reps.sum())

    @property
    def ratio(self) -> float:
        """Solver-interval saving vs uniform stepping (>= 1)."""
        return self.n_base / self.n_coarse

    def dt_scale(self) -> np.ndarray:
        """Per-coarse-interval duration in units of the base interval."""
        return self.reps.astype(np.float32)

    def _edges(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.reps)])

    def merge(self, x: np.ndarray) -> np.ndarray:
        """Mean of ``x`` (leading axis = base intervals) over each run —
        the energy-conserving lowering of a base-resolution signal."""
        x = np.asarray(x)
        if x.shape[0] != self.n_base:
            raise ValueError(f"signal has {x.shape[0]} base intervals, "
                             f"plan covers {self.n_base}")
        e = self._edges()
        return np.stack([x[e[i]:e[i + 1]].mean(axis=0)
                         for i in range(self.n_coarse)])

    def expand(self, y: np.ndarray) -> np.ndarray:
        """Inverse resampling: repeat each coarse value over its run."""
        y = np.asarray(y)
        if y.shape[0] != self.n_coarse:
            raise ValueError(f"signal has {y.shape[0]} coarse intervals, "
                             f"plan has {self.n_coarse}")
        return np.repeat(y, self.reps, axis=0)

    def pad_to(self, n: int) -> "CoarsePlan":
        """Split the largest runs until the plan has ``n`` coarse
        intervals (clamped to ``n_base``).  Splitting only ever SHRINKS
        within-run activity ranges, so the plan's error bound still
        holds; it buckets plans onto a few lengths."""
        n = min(n, self.n_base)
        reps = list(self.reps)
        while len(reps) < n:
            i = int(np.argmax(reps))
            if reps[i] < 2:
                break
            half = reps[i] // 2
            reps[i:i + 1] = [reps[i] - half, half]
        return CoarsePlan(np.asarray(reps, np.int64))


def coarsen_plan(activity: np.ndarray, tol: float,
                 max_merge: int = 64) -> CoarsePlan:
    """Greedy run-merging of a base-resolution activity signal.

    Consecutive intervals join the current run while the run's
    max-min activity range (including the candidate) stays <= ``tol``
    and the run is shorter than ``max_merge`` intervals.  With the
    merged power set to the run mean (:meth:`CoarsePlan.merge`), the
    instantaneous power error of the coarsened trace is bounded by
    ``tol`` activity units, so the replay's temperature error is bounded
    by ``tol`` x the DC thermal gain of the modulated power map
    (:func:`dc_peak_rise_C`).

    ``activity`` may be [T] or [T, K] (K signals coarsened jointly, the
    range criterion applied to the worst signal).
    """
    act = np.asarray(activity, np.float64)
    if act.ndim == 1:
        act = act[:, None]
    if act.ndim != 2 or act.shape[0] == 0:
        raise ValueError("activity must be [T] or [T, K] with T >= 1")
    if tol < 0:
        raise ValueError("tol must be >= 0")
    if max_merge < 1:
        raise ValueError("max_merge must be >= 1")

    reps = []
    run = 1
    lo = act[0].copy()
    hi = act[0].copy()
    for t in range(1, act.shape[0]):
        nlo = np.minimum(lo, act[t])
        nhi = np.maximum(hi, act[t])
        if run < max_merge and float((nhi - nlo).max()) <= tol:
            run += 1
            lo, hi = nlo, nhi
        else:
            reps.append(run)
            run = 1
            lo = act[t].copy()
            hi = act[t].copy()
    reps.append(run)
    return CoarsePlan(np.asarray(reps, np.int64))


def dc_peak_rise_C(frame, F: dict) -> float:
    """Peak steady-state temperature rise of ONE power frame [L, NY, NX].

    The DC gain of the passive RC network: ``tol * dc_peak_rise_C(
    worst_frame, F)`` bounds the coarsened-replay temperature error at
    activity tolerance ``tol`` for a linear (open-loop) replay.  The
    solve (tolerance Jacobi-PCG) runs on the fields' device.
    """
    F = stencil_ops.pack_fields(F)
    frame = torch.as_tensor(np.asarray(frame, np.float32)
                            if not torch.is_tensor(frame) else frame,
                            dtype=torch.float32, device=F.data.device)
    dT, _ = thermal._solve_fields(frame, F, "pcg")
    return float(dT.max())


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


# ---------------------------------------------------------------------------
# implicit open-loop replay (loop over frames, batched over design points)
# ---------------------------------------------------------------------------

def _on_device(x, dev: torch.device) -> torch.Tensor:
    """A float32 tensor of ``x`` (NumPy or tensor) on ``dev``."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.to(dev, torch.float32)


def _replay(frames, F, cap3, interval_dt, theta, t_amb, *,
            steps_per_interval: int, n_cg: int, n_si: int, margin: int,
            die_n: int):
    """The replay over a batch: frames [B, T, L, NY, NX], every field of
    F and cap3 [B, L, NY, NX]."""
    F = stencil_ops.pack_fields(F)
    dev = F.data.device
    frames, cap3 = _on_device(frames, dev), _on_device(cap3, dev)
    A = lambda v: stencil_ops.apply_operator_fields(v, F)
    solve = thermal.pcg_lhs_solver(A, cap3, thermal._diag_fields(F),
                                   interval_dt / steps_per_interval, theta,
                                   n_cg)
    win = (slice(None), slice(None, n_si), slice(margin, margin + die_n),
           slice(margin, margin + die_n))
    dTc = torch.zeros_like(frames[:, 0])
    mx, mn = [], []
    for i in range(frames.shape[1]):
        P = frames[:, i]
        for _ in range(steps_per_interval):
            dTc = dTc + solve(P - A(dTc))
        die = dTc[win]
        mx.append(die.amax(dim=(2, 3)))
        mn.append(die.amin(dim=(2, 3)))
    stack = lambda xs: torch.stack(xs, dim=1) if xs \
        else frames.new_zeros((frames.shape[0], 0, n_si))
    return dTc + t_amb, stack(mx) + t_amb, stack(mn) + t_amb


def cosim_transient(frames, F: dict, cap3, interval_dt,
                    theta: float = 1.0, t_amb: float = AMBIENT_C, *,
                    die_n: int, steps_per_interval: int = 2, n_cg: int = 40,
                    n_si: int = 4, margin: int = 0,
                    use_pallas: bool = False):
    """Replay one frame stack [T, L, NY, NX] on the fields' device.
    Returns (T_end [L,NY,NX], peak_C [T,n_si], min_C [T,n_si]) — peaks
    and mins over the die footprint of the silicon layers only."""
    out = _replay(_on_device(frames, F["g_pkg"].device)[None],
                  {k: v[None] for k, v in F.items()},
                  _on_device(cap3, F["g_pkg"].device)[None], interval_dt,
                  theta, t_amb, steps_per_interval=steps_per_interval,
                  n_cg=n_cg, n_si=n_si, margin=margin, die_n=die_n)
    return tuple(o[0] for o in out)


def cosim_transient_batch(frames, F: dict, cap3, interval_dt,
                          theta: float = 1.0, t_amb: float = AMBIENT_C, *,
                          die_n: int, steps_per_interval: int = 2,
                          n_cg: int = 40, n_si: int = 4, margin: int = 0,
                          use_pallas: bool = False):
    """The replay over a leading batch of design points, as one batched
    replay: frames [B, T, L, NY, NX]; each field of F and cap3
    [B, L, NY, NX] (the batch shares one grid shape; conductances and
    capacities differ per die)."""
    return _replay(frames, F, cap3, interval_dt, theta, t_amb,
                   steps_per_interval=steps_per_interval, n_cg=n_cg,
                   n_si=n_si, margin=margin, die_n=die_n)


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CosimReport:
    """Time-resolved thermal summary of one replay (host NumPy)."""
    label: str
    interval_s: float
    peak_C: np.ndarray          # [T, n_si]
    min_C: np.ndarray           # [T, n_si]

    @property
    def times(self) -> np.ndarray:
        return self.interval_s * np.arange(1, self.peak_C.shape[0] + 1)

    @property
    def span_C(self) -> np.ndarray:
        return self.peak_C - self.min_C

    @property
    def final_peak_C(self) -> np.ndarray:
        return self.peak_C[-1]

    def time_above(self, limit_C: float = DRAM_LIMIT_C) -> np.ndarray:
        """Seconds each layer spent above ``limit_C`` (per-interval
        granularity, counted on the layer's peak cell)."""
        return self.interval_s * (self.peak_C > limit_C).sum(axis=0)

    def crossing_time(self, limit_C: float = DRAM_LIMIT_C) -> np.ndarray:
        """First time [s] each layer's peak exceeds ``limit_C`` (inf if
        it never does)."""
        above = self.peak_C > limit_C
        first = np.where(above.any(axis=0), above.argmax(axis=0), -1)
        t = self.times
        return np.where(first >= 0, t[np.maximum(first, 0)], np.inf)


# ---------------------------------------------------------------------------
# top-level driver: batched AP-vs-SIMD per-workload co-simulation
# ---------------------------------------------------------------------------

def run_cosim(workloads=("dmm", "fft"), grid_n: int = 32,
              n_intervals: int = 64, t_end: float = 0.25,
              steps_per_interval: int = 2, n_cg: int = 40,
              theta: float = 1.0, stack: StackParams | None = None,
              use_pallas: bool = False, *, device="cuda") -> dict:
    """The §4 comparison, transient: for each workload, replay the AP's
    measured trace (captured on ``device``) and the SIMD reference's
    analytic trace through the same stack in ONE batched replay on
    ``device``.  Returns ``{workload: {"ap": CosimReport, "simd":
    CosimReport}, "design_points": {...}, "interval_s", "t_end"}``.
    """
    dev = resolve_device(device)
    stack = stack or PAPER_STACK
    margin = grid_n // 4
    interval_dt = t_end / n_intervals

    labels, all_frames, all_F, all_cap = [], [], [], []
    dps = {}
    for w in workloads:
        dp = comparable_design_point(w)
        dps[w] = dp
        wl = M.WORKLOADS[w]
        ap_fp = APFloorplan(die_w_mm=math.sqrt(dp.ap_area_mm2))
        simd_fp = SIMDFloorplan(die_w_mm=math.sqrt(dp.simd_area_mm2))
        cases = (
            (f"{w}/ap", ap_fp.power_map(grid_n, dp.ap_power_W),
             ap_fp.leakage_W(), ap_fp.die_w_mm,
             ap_workload_trace(w, n_intervals, trace_elems(M.N_DATA),
                               device=dev)),
            (f"{w}/simd", simd_fp.power_map(grid_n, dp),
             simd_fp.leakage_W(dp), simd_fp.die_w_mm,
             simd_phase_trace(wl, dp, n_intervals)),
        )
        for label, pmap, leak_W, die_w_mm, trace in cases:
            grid = thermal.Grid(die_w=die_w_mm * MM, ny=grid_n, nx=grid_n,
                                params=stack, margin=margin)
            labels.append(label)
            all_frames.append(power_frames(trace, pmap, leak_W, grid))
            all_F.append(grid.fields(dev))
            all_cap.append(grid.capacity_field(dev))

    frames = torch.from_numpy(np.stack(all_frames)).to(dev)
    Fb = {k: torch.stack([F[k] for F in all_F]) for k in all_F[0]}
    capb = torch.stack(all_cap)
    _, peaks, mins = cosim_transient_batch(
        frames, Fb, capb, interval_dt, theta,
        steps_per_interval=steps_per_interval, n_cg=n_cg,
        n_si=stack.n_si_layers, margin=margin, die_n=grid_n)
    peaks = peaks.cpu().numpy()
    mins = mins.cpu().numpy()

    out: dict = {"design_points": dps, "interval_s": interval_dt,
                 "t_end": t_end}
    for i, label in enumerate(labels):
        w, machine = label.split("/")
        out.setdefault(w, {})[machine] = CosimReport(
            label=label, interval_s=interval_dt,
            peak_C=peaks[i], min_C=mins[i])
    return out
