"""Closed-loop temperature↔power co-simulation for heterogeneous stacks
(PyTorch port of ``repro.stack.feedback``).

The replay steps a batch of (workload × machine) cases through the trace
intervals and closes the loop through three temperature couplings —

1. **DRAM refresh** — JEDEC bins (``stack.dram.refresh_multiplier``):
   refresh power doubles above 85 °C and doubles again above 95 °C,
   evaluated per cell.
2. **Leakage** — exponential in temperature,
   ``leak0 * exp(beta (T − T_ref))``, applied to every die layer.
3. **DTM policy** — a sampled controller (``repro_torch.policy``) reads
   the measured start-of-interval hot spots and sets a power duty that
   scales the dynamic power, plus a performance duty recorded per
   interval for the slowdown accounting.

Refresh and leakage are solved implicitly by **Picard iteration**: iterate
k evaluates them at iterate k−1's end-of-interval temperature and
re-integrates the interval with implicit theta steps.  The inner solve is
``solver="pcg"`` (``n_cg`` iterations of ``thermal.pcg_fixed``, whose
matvec is the thermal-stencil kernel on a card) or ``solver="mg"``
(``n_mg`` V-cycles of ``multigrid.iterate_fixed`` on a hierarchy built
once per replay, smoothed by the ``mg_smooth`` kernel on a card).  The
recorded fixed-point residual ``max |T_k − T_{k−1}|`` must fall below
``picard_tol_C`` (0.05 °C) on every interval.  The DTM throttle stays
outside the fixed point: it actuates on the start-of-interval sample.

Where the API differs from the reference:

- ``vmap`` is a leading batch dimension written out:
  :func:`closed_loop_batch` takes ``[B, ...]`` inputs and
  :func:`closed_loop_replay` is the ``B = 1`` case.  ``lax.scan`` and
  ``fori_loop`` are Python loops with the same fixed counts, and nothing
  inside them syncs with the host: the only sync is the final copy of
  the results.
- ``use_pallas`` is accepted and ignored: the device of the inputs picks
  the stencil (the CUDA kernel for CUDA tensors, its plain version on
  the CPU).  :func:`replay_cases`, :func:`run_stack_cosim` and
  :func:`assemble_case` take the keyword-only ``device`` (default
  ``"cuda"``).
- ``dt_scale`` (the variable-step replay of coarsened traces,
  ``cosim.CoarsePlan.dt_scale``) rebuilds the PCG LHS and its Jacobi
  preconditioner each interval from the interval's step, in double
  precision on the host (``interval_dt * scale / steps``), so a scale of
  1 gives the fixed replay's step and a ``dt_scale`` of ones replays it
  bit for bit.  The reference forms that step in float32, which may
  differ in its last bit.
- ``FeedbackParams.faults`` (a ``repro_torch.faults.SensorFaultSpec``)
  is read once an interval: the policy sees sensor 0 as ``layer_T`` and
  all K readings ``[B, K, L]`` as ``sensor_T``; every case of the batch
  gets the same seeded draws, as every case of the reference's ``vmap``
  reads the same key chain.
- ``n_shards`` (:func:`closed_loop_sharded`) slices the case batch over
  local devices of the inputs' type, a slice a device, where the
  reference ``shard_map`` s it over a mesh.  No per-case sum, coarse
  factor or coarse solve of the replay depends on the batch size
  (``thermal.case_sum``, ``multigrid.coarse_factorization``), so any
  shard count gives bitwise the unsharded results.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import cosim
from repro_torch.core import models as M
from repro_torch.core import thermal
from repro_torch.core.constants import AMBIENT_C, DRAM_LIMIT_C
from repro_torch.core.floorplan import MM, APFloorplan, SIMDFloorplan
from repro_torch.faults.models import SensorFaultSpec
from repro_torch.kernels.thermal_stencil import ops as stencil_ops
from repro_torch.policy import Policy, PolicyContext, RampPolicy
from repro_torch.stack import dram
from repro_torch.stack.spec import (DRAM, LOGIC, PAPER_STACK, StackParams,
                                    StackSpec, dram_on_logic)


@dataclasses.dataclass(frozen=True)
class FeedbackParams:
    """Feedback-loop constants.

    ``policy`` selects the DTM/DVFS controller (``repro_torch.policy``);
    None resolves to the classic linear ramp built from the ``dtm_*``
    fields.  ``faults`` injects sensor faults into the temperatures the
    policy reads (``repro_torch.faults``); None keeps the replay exactly
    the fault-free one.
    """
    leak_beta: float = 0.012     # 1/K exponential leakage slope (~2x / 60 K)
    t_ref_C: float = AMBIENT_C   # leakage reference temperature
    n_picard: int = 6            # fixed Picard iterations per interval
    picard_tol_C: float = 0.05   # documented per-step residual bar [°C]
    dtm_trip_C: float = 95.0     # logic hot-spot trip temperature
    dtm_ramp_C: float = 10.0     # °C over which power ramps down to floor
    dtm_floor: float = 0.25      # minimum DTM duty factor
    refresh_feedback: bool = True   # False -> refresh pinned at 1x
    policy: Policy | None = None    # None -> ramp from the dtm_* fields
    faults: SensorFaultSpec | None = None   # None -> perfect sensing

    def __post_init__(self):
        if not (0.0 < self.dtm_floor <= 1.0):
            raise ValueError("dtm_floor must lie in (0, 1] (0 breaks the "
                             "mean(1/f) slowdown accounting, > 1 is not "
                             f"a floor); got {self.dtm_floor!r}")
        if math.isnan(self.dtm_trip_C) or self.dtm_trip_C == -math.inf:
            raise ValueError("dtm_trip_C must be a real temperature or "
                             "math.inf (= DTM never trips); got "
                             f"{self.dtm_trip_C!r}")
        if self.dtm_ramp_C < 0:
            raise ValueError("dtm_ramp_C must be >= 0 (0 = step trip); "
                             f"got {self.dtm_ramp_C!r}")

    def resolved_policy(self) -> Policy:
        """The controller the replay actually runs."""
        if self.policy is not None:
            return self.policy
        return RampPolicy(trip_C=self.dtm_trip_C, ramp_C=self.dtm_ramp_C,
                          floor=self.dtm_floor)

    @classmethod
    def disabled(cls) -> "FeedbackParams":
        """Open-loop limit: constant leakage, 1x refresh, no DTM
        (``n_picard = 2``, so the recorded residual is a true fixed-point
        defect)."""
        return cls(leak_beta=0.0, n_picard=2, dtm_trip_C=math.inf,
                   refresh_feedback=False)


# ---------------------------------------------------------------------------
# closed-loop replay core (loop over intervals, batched over cases)
# ---------------------------------------------------------------------------

# the replay is never differentiated, so none of its thousands of small
# launches an interval pays for autograd's bookkeeping
@torch.no_grad()
def _closed_loop(dyn_frames, leak0, refresh0, logic_mask, F, cap3,
                 interval_dt, theta, t_amb, *, fb: FeedbackParams,
                 steps_per_interval: int, n_cg: int, n_die: int,
                 margin: int, die_n: int, solver: str = "pcg",
                 n_mg: int = 3, dt_scale=None):
    """The replay over a batch: dyn_frames [B, T, L, NY, NX]; leak0,
    refresh0, cap3 and every field of F [B, L, NY, NX]; logic_mask
    [B, L]; ``dt_scale`` None or [T] (host values).  Returns
    (T_end [B,L,NY,NX], peak_C [B,T,n_die], min_C [B,T,n_die],
    residual_C [B,T], throttle [B,T], refresh_W [B,T], leak_W [B,T],
    dyn_W [B,T])."""
    F = stencil_ops.pack_fields(F)       # checked once, one pointer a launch
    A = lambda v: stencil_ops.apply_operator_fields(v, F)
    if dt_scale is None:
        solve = thermal.implicit_lhs_solver(
            A, F, cap3, interval_dt / steps_per_interval, theta,
            solver=solver, n_cg=n_cg, n_mg=n_mg)
        solve_for = lambda _i: solve
    else:
        # variable-dt replay (coarsened traces): the theta-scheme LHS and
        # its Jacobi preconditioner are rebuilt each interval.  The
        # multigrid hierarchy is assembled for ONE dt, hence PCG only.
        if solver != "pcg":
            raise ValueError("variable-dt replay (dt_scale) requires "
                             "solver='pcg'; the multigrid hierarchy is "
                             "built for a fixed step")
        diagA = thermal._diag_fields(F)
        scales = [float(s) for s in np.asarray(
            dt_scale.cpu() if torch.is_tensor(dt_scale) else dt_scale,
            np.float32)]
        if len(scales) != dyn_frames.shape[1]:
            raise ValueError(f"dt_scale has {len(scales)} intervals, the "
                             f"frames {dyn_frames.shape[1]}")
        solve_for = lambda i: thermal.pcg_lhs_solver(
            A, cap3, diagA, interval_dt * scales[i] / steps_per_interval,
            theta, n_cg)
    lm3 = logic_mask[:, :, None, None]
    # DRAM layers are exactly the refresh-bearing ones
    dram_mask = (refresh0.sum(dim=(2, 3)) > 0).to(logic_mask.dtype)
    p_stat = leak0 + refresh0
    policy = fb.resolved_policy()
    fspec = fb.faults
    pstate = policy.init_state(int(logic_mask.shape[1]))
    fstate = None if fspec is None \
        else fspec.init_state(int(logic_mask.shape[1]))
    win = (slice(None), slice(None, n_die), slice(margin, margin + die_n),
           slice(margin, margin + die_n))

    dTc = torch.zeros_like(dyn_frames[:, 0])
    ys = []
    for i in range(dyn_frames.shape[1]):
        P_dyn = dyn_frames[:, i]
        solve = solve_for(i)
        # the policy actuates on the MEASURED (start-of-interval) hot spots
        layer_T = dTc.amax(dim=(2, 3)) + t_amb
        sensor_T = None
        if fspec is not None:
            # what the controller SENSES is the faulted readings: sensor 0
            # replaces layer_T, all K [B, K, L] go to hardened policies
            fstate, sensor_T = fspec.read(fstate, layer_T)
            layer_T = sensor_T[:, 0]
        predict = cosim.interval_forecaster(A, solve, lm3, t_amb)
        ctx = PolicyContext(layer_T=layer_T, logic_mask=logic_mask,
                            dram_mask=dram_mask,
                            predict_hot=predict(dTc, P_dyn, p_stat),
                            sensor_T=sensor_T)
        pstate, f_power, f = policy.act(pstate, ctx)
        fp = f_power[:, None, None, None] if f_power.dim() == 1 \
            else f_power[:, :, None, None]
        P_base = fp * P_dyn

        dTk = dTc
        for _ in range(fb.n_picard):
            T = dTk + t_amb
            p_leak = leak0 * torch.exp(fb.leak_beta * (T - fb.t_ref_C))
            p_ref = refresh0 * dram.refresh_multiplier(T) \
                if fb.refresh_feedback else refresh0
            P = P_base + p_leak + p_ref
            dTn = dTc
            for _ in range(steps_per_interval):
                dTn = dTn + solve(P - A(dTn))
            res = (dTn - dTk).abs().amax(dim=(1, 2, 3))
            dTk = dTn
        dTc = dTk
        die = dTc[win]
        ys.append((die.amax(dim=(2, 3)), die.amin(dim=(2, 3)), res, f,
                   thermal.case_sum(p_ref), thermal.case_sum(p_leak),
                   thermal.case_sum(P_base)))
    mx, mn, res, f, ref_W, leak_W, dyn_W = (torch.stack(y, dim=1)
                                            for y in zip(*ys))
    return (dTc + t_amb, mx + t_amb, mn + t_amb, res, f, ref_W, leak_W,
            dyn_W)


def closed_loop_replay(dyn_frames, leak0, refresh0, logic_mask, F: dict,
                       cap3, interval_dt, theta: float = 1.0,
                       t_amb: float = AMBIENT_C, *, fb: FeedbackParams,
                       die_n: int, n_die: int, steps_per_interval: int = 2,
                       n_cg: int = 40, margin: int = 0,
                       use_pallas: bool = False, solver: str = "pcg",
                       n_mg: int = 3, dt_scale=None):
    """Replay one frame stack with temperature feedback.

    dyn_frames [T, L, NY, NX]: trace-modulated *dynamic* power — NO
    leakage or refresh baked in; leak0 / refresh0 [L, NY, NX]: leakage at
    ``fb.t_ref_C`` and 1× refresh power; logic_mask [L]: 1.0 on layers
    whose hot spot trips the DTM; F and cap3 [L, NY, NX] on the same
    device.  ``dt_scale`` [T] (optional) stretches interval i to
    ``interval_dt * dt_scale[i]`` — the variable-step replay coarsened
    traces use (``cosim.CoarsePlan.dt_scale``); PCG only, since the
    multigrid hierarchy is built for one step.  The DTM controller then
    samples at the coarsened boundaries.  Returns (T_end [L,NY,NX],
    peak_C [T,n_die], min_C [T,n_die], residual_C [T], throttle [T],
    refresh_W [T], leak_W [T], dyn_W [T]).
    """
    thermal.check_solver(solver)
    out = _closed_loop(dyn_frames[None], leak0[None], refresh0[None],
                       logic_mask[None], {k: v[None] for k, v in F.items()},
                       cap3[None], interval_dt, theta, t_amb, fb=fb,
                       steps_per_interval=steps_per_interval, n_cg=n_cg,
                       n_die=n_die, margin=margin, die_n=die_n,
                       solver=solver, n_mg=n_mg, dt_scale=dt_scale)
    return tuple(o[0] for o in out)


def closed_loop_batch(dyn_frames, leak0, refresh0, logic_mask, F: dict,
                      cap3, interval_dt, theta: float = 1.0,
                      t_amb: float = AMBIENT_C, *, fb: FeedbackParams,
                      die_n: int, n_die: int, steps_per_interval: int = 2,
                      n_cg: int = 40, margin: int = 0,
                      use_pallas: bool = False, solver: str = "pcg",
                      n_mg: int = 3, dt_scale=None):
    """Closed-loop replay over a leading design-point batch: every input
    of :func:`closed_loop_replay` with a leading ``[B]`` dimension, and
    every output likewise; ``dt_scale`` [T] (the port's addition: the
    serving co-simulation replays its machines as one batch) is shared
    by the batch."""
    thermal.check_solver(solver)
    return _closed_loop(dyn_frames, leak0, refresh0, logic_mask, F, cap3,
                        interval_dt, theta, t_amb, fb=fb,
                        steps_per_interval=steps_per_interval, n_cg=n_cg,
                        n_die=n_die, margin=margin, die_n=die_n,
                        solver=solver, n_mg=n_mg, dt_scale=dt_scale)


def closed_loop_sharded(dyn_frames, leak0, refresh0, logic_mask, F: dict,
                        cap3, interval_dt, theta: float = 1.0,
                        t_amb: float = AMBIENT_C, *, fb: FeedbackParams,
                        die_n: int, n_die: int,
                        steps_per_interval: int = 2, n_cg: int = 40,
                        margin: int = 0, use_pallas: bool = False,
                        solver: str = "pcg", n_mg: int = 3,
                        n_shards: int | None = None):
    """:func:`closed_loop_batch` partitioned over local devices.

    The case batch is padded to a multiple of the shard count (repeating
    the last case; padding rows are dropped from every output), and each
    shard's slice replays on its own device of
    ``repro_torch.parallel.sharding.sweep_mesh`` (of the inputs' device
    type).  Each device runs the identical per-case program on its slice,
    and no sum, coarse factor or coarse solve of a case depends on how
    many cases share its launch (``thermal.case_sum``,
    ``multigrid.coarse_factorization``), so results are bitwise those of
    the unsharded batch for ANY shard count — the property the sweep
    cache relies on.
    ``F`` is the dict of batched fields; the outputs come back on the
    inputs' device.
    """
    from repro_torch.parallel import sharding as shardlib
    thermal.check_solver(solver)
    mesh = shardlib.sweep_mesh(n_shards, device=dyn_frames.device)
    batch = (dyn_frames, leak0, refresh0, logic_mask, dict(F), cap3)
    batch, n_cases = shardlib.pad_case_batch(batch, len(mesh))

    def fn(tree):
        return closed_loop_batch(
            *tree, interval_dt, theta, t_amb, fb=fb, die_n=die_n,
            n_die=n_die, steps_per_interval=steps_per_interval,
            n_cg=n_cg, margin=margin, solver=solver, n_mg=n_mg)

    out = shardlib.shard_case_batch(fn, mesh)(batch)
    return shardlib.unpad_case_batch(out, n_cases)


# ---------------------------------------------------------------------------
# power-input assembly for one (machine, stack) case
# ---------------------------------------------------------------------------

def stack_power_inputs(spec: StackSpec, grid: thermal.Grid,
                       trace: cosim.PowerTrace, logic_pmap: np.ndarray,
                       logic_leak_W: float, dram_fp: dram.DRAMFloorplan,
                       traffic_bytes_per_s: float):
    """Build (dyn_frames, leak0, refresh0, logic_mask) for one stack, as
    host NumPy float32.

    Logic layers carry the floorplan's dynamic map modulated by the trace
    (every logic layer the same map); DRAM layers carry the
    traffic-driven activate map modulated by the SAME trace plus their
    leakage/refresh statics.
    """
    gn = logic_pmap.shape[0]
    L, NY, NX, m = grid.n_layers, grid.dom_ny, grid.dom_nx, grid.margin
    Tn = trace.n_intervals
    act = trace.activity.astype(np.float32)[:, None, None]

    dyn = np.zeros((Tn, L, NY, NX), np.float32)
    leak0 = np.zeros((L, NY, NX), np.float32)
    refresh0 = np.zeros((L, NY, NX), np.float32)

    leak_cell = logic_leak_W / gn ** 2
    dyn_logic = (logic_pmap - leak_cell).astype(np.float32)
    n_dram = len(spec.dram_layers)
    act_map = dram_fp.activate_map(gn) \
        * dram.activate_io_W(traffic_bytes_per_s, n_dram)
    ref_map = dram_fp.refresh_map(gn) * dram_fp.base_refresh_W()
    dram_leak_cell = dram_fp.leakage_W() / gn ** 2

    win = (slice(m, m + gn), slice(m, m + gn))
    for l, layer in enumerate(spec.layers[:-1]):
        if layer.kind == LOGIC:
            dyn[(slice(None), l) + win] = act * dyn_logic
            leak0[(l,) + win] = leak_cell
        elif layer.kind == DRAM:
            dyn[(slice(None), l) + win] = act * act_map
            leak0[(l,) + win] = dram_leak_cell
            refresh0[(l,) + win] = ref_map
    return dyn, leak0, refresh0, spec.layer_mask(LOGIC)


def stack_power_frames(spec: StackSpec, grid: thermal.Grid,
                       activity: np.ndarray, logic_pmap: np.ndarray,
                       logic_leak_W: float, dram_fp: dram.DRAMFloorplan,
                       traffic_bytes_per_s):
    """:func:`stack_power_inputs` for externally-computed interval signals.

    ``activity`` [T] is a raw utilization trace (NOT mean-normalized like
    a :class:`~repro_torch.core.cosim.PowerTrace`) — logic layers draw
    ``activity[t] *`` their dynamic map.  DRAM activate power follows
    ``traffic_bytes_per_s``: a scalar is modulated by the same activity,
    while an array [T] is taken as the per-interval traffic verbatim.
    Returns the same (dyn, leak0, refresh0, logic_mask) host NumPy tuple.
    """
    gn = logic_pmap.shape[0]
    L, NY, NX, m = grid.n_layers, grid.dom_ny, grid.dom_nx, grid.margin
    act = np.asarray(activity, np.float32)
    if act.ndim != 1:
        raise ValueError("activity must be a 1-D interval signal")
    Tn = act.shape[0]
    n_dram = len(spec.dram_layers)
    traffic = np.asarray(traffic_bytes_per_s, np.float64)
    if traffic.ndim == 0:
        io_W_t = act * dram.activate_io_W(float(traffic), n_dram)
    elif traffic.shape == (Tn,):
        io_W_t = np.array([dram.activate_io_W(float(b), n_dram)
                           for b in traffic], np.float32)
    else:
        raise ValueError("traffic_bytes_per_s must be a scalar or match "
                         "the activity length")

    dyn = np.zeros((Tn, L, NY, NX), np.float32)
    leak0 = np.zeros((L, NY, NX), np.float32)
    refresh0 = np.zeros((L, NY, NX), np.float32)

    leak_cell = logic_leak_W / gn ** 2
    dyn_logic = (logic_pmap - leak_cell).astype(np.float32)
    act_shape = dram_fp.activate_map(gn)
    ref_map = dram_fp.refresh_map(gn) * dram_fp.base_refresh_W()
    dram_leak_cell = dram_fp.leakage_W() / gn ** 2

    win = (slice(m, m + gn), slice(m, m + gn))
    for l, layer in enumerate(spec.layers[:-1]):
        if layer.kind == LOGIC:
            dyn[(slice(None), l) + win] = act[:, None, None] * dyn_logic
            leak0[(l,) + win] = leak_cell
        elif layer.kind == DRAM:
            dyn[(slice(None), l) + win] = io_W_t[:, None, None] * act_shape
            leak0[(l,) + win] = dram_leak_cell
            refresh0[(l,) + win] = ref_map
    return dyn, leak0, refresh0, spec.layer_mask(LOGIC)


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackReport:
    """Time-resolved closed-loop summary of one stack replay (host
    NumPy arrays)."""
    label: str
    interval_s: float
    spec: StackSpec
    peak_C: np.ndarray          # [T, n_die]
    min_C: np.ndarray           # [T, n_die]
    residual_C: np.ndarray      # [T] final Picard residual per interval
    throttle: np.ndarray        # [T] DTM duty factor in (0, 1]
    refresh_W: np.ndarray       # [T] total DRAM refresh power
    leak_W: np.ndarray          # [T] total leakage power
    base_refresh_W: float       # 1x refresh total of all DRAM dies
    tol_C: float = FeedbackParams.picard_tol_C   # the run's residual bar
    dyn_W: np.ndarray | None = None   # [T] policy-scaled dynamic power

    @property
    def times(self) -> np.ndarray:
        return self.interval_s * np.arange(1, self.peak_C.shape[0] + 1)

    @property
    def span_C(self) -> np.ndarray:
        return self.peak_C - self.min_C

    def _layer_peak(self, idx: tuple[int, ...]) -> np.ndarray:
        if not idx:
            return np.zeros(self.peak_C.shape[0], self.peak_C.dtype)
        return self.peak_C[:, list(idx)].max(axis=1)

    @property
    def dram_peak_C(self) -> np.ndarray:
        """[T] hottest DRAM cell per interval (zeros if no DRAM dies)."""
        return self._layer_peak(self.spec.dram_layers)

    @property
    def logic_peak_C(self) -> np.ndarray:
        return self._layer_peak(self.spec.logic_layers)

    @property
    def refresh_overhead(self) -> float:
        """Mean refresh power / the 1× (cool-DRAM) refresh power."""
        if self.base_refresh_W <= 0:
            return 1.0
        return float(self.refresh_W.mean() / self.base_refresh_W)

    @property
    def dtm_slowdown(self) -> float:
        """Runtime inflation from throttling: mean(1/f) >= 1."""
        return float(np.mean(1.0 / self.throttle))

    @property
    def energy_J(self) -> float:
        """Total energy over the replay window (dynamic + leak +
        refresh)."""
        if self.dyn_W is None:
            raise ValueError("this report has no dyn_W recording")
        return float(self.interval_s
                     * (self.dyn_W + self.leak_W + self.refresh_W).sum())

    @property
    def energy_per_work_J(self) -> float:
        """Energy divided by the fraction of full-speed work completed."""
        return self.energy_J / float(np.mean(self.throttle))

    def time_above(self, limit_C: float = DRAM_LIMIT_C,
                   layers: tuple[int, ...] | None = None) -> np.ndarray:
        """Seconds each selected layer's peak spent above ``limit_C``."""
        sel = list(layers) if layers is not None \
            else list(range(self.peak_C.shape[1]))
        return self.interval_s * (self.peak_C[:, sel] > limit_C).sum(axis=0)

    @property
    def dram_time_above_limit_s(self) -> float:
        if not self.spec.dram_layers:
            return 0.0
        return float(self.time_above(layers=self.spec.dram_layers).max())

    @property
    def converged(self) -> bool:
        """Did EVERY interval's Picard iteration meet the residual bar?"""
        return bool(self.residual_C.max() <= self.tol_C)


# ---------------------------------------------------------------------------
# per-case assembly (shared by run_stack_cosim and the tests)
# ---------------------------------------------------------------------------

def check_finite_power(what: str, **arrays) -> None:
    """Raise ``ValueError`` if any power input carries non-finite cells
    (NaN compares False against the 85 °C ceiling, i.e. reads as OK)."""
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if not np.isfinite(arr).all():
            n_bad = int((~np.isfinite(arr)).sum())
            raise ValueError(
                f"{what}: power input {name!r} has {n_bad} non-finite "
                f"cell(s) (shape {arr.shape}); refusing to replay — "
                "NaN temperatures would silently pass the 85C verdict")


def assemble_case(dp: M.DesignPoint, workload: str, machine: str,
                  spec: StackSpec, params: StackParams, grid_n: int,
                  trace: cosim.PowerTrace, margin: int, *, device="cuda"):
    """Build the closed-loop replay inputs for one (workload, machine) case.

    Returns (dyn, leak0, refresh0, logic_mask, F, cap3): the power inputs
    as host NumPy (exactly the reference's arrays), the face fields and
    capacities as float32 tensors on ``device``.  ``machine`` is "ap" or
    "simd".
    """
    dev = resolve_device(device)
    traffic = M.mem_traffic_bytes_per_s(workload, dp.ap_n_pus)
    if machine == "ap":
        fp = APFloorplan(die_w_mm=math.sqrt(dp.ap_area_mm2))
        pmap = fp.power_map(grid_n, dp.ap_power_W)
        leak_W = fp.leakage_W()
    elif machine == "simd":
        fp = SIMDFloorplan(die_w_mm=math.sqrt(dp.simd_area_mm2))
        pmap = fp.power_map(grid_n, dp)
        leak_W = fp.leakage_W(dp)
    else:
        raise ValueError(f"unknown machine {machine!r}")
    grid = thermal.Grid(die_w=fp.die_w_mm * MM, ny=grid_n, nx=grid_n,
                        params=params, spec=spec, margin=margin)
    dfp = dram.DRAMFloorplan(die_w_mm=fp.die_w_mm)
    dyn, l0, r0, lm = stack_power_inputs(spec, grid, trace, pmap, leak_W,
                                         dfp, traffic)
    check_finite_power(f"assemble_case({workload}/{machine})",
                       dyn_frames=dyn, leak0=l0, refresh0=r0)
    return dyn, l0, r0, lm, grid.fields(dev), grid.capacity_field(dev)


def _batch(xs, dev: torch.device) -> torch.Tensor:
    """Stack per-case leaves (NumPy arrays or tensors) into one float32
    [B, ...] tensor on ``dev``."""
    return torch.stack([torch.as_tensor(np.asarray(x, np.float32)
                                        if isinstance(x, np.ndarray) else x)
                        .to(dev, torch.float32) for x in xs])


def _replay_telemetry(fb: FeedbackParams, res: np.ndarray,
                      thr: np.ndarray) -> None:
    """The reference's ``feedback/*`` and ``policy/<name>/*`` metrics of
    one replay, from its residuals and duties ``[B, T]`` on the host."""
    res_h, thr_h = res.astype(np.float64), thr.astype(np.float64)
    n_cases, n_int = res_h.shape
    obs.count("feedback/intervals", n_cases * n_int)
    obs.count("feedback/picard_iterations", n_cases * n_int * fb.n_picard)
    obs.count("feedback/throttled_intervals", int((thr_h < 1.0).sum()))
    obs.observe_many("feedback/picard_residual_C", res_h.max(axis=1))
    obs.observe_many("feedback/throttle_duty", thr_h.mean(axis=1))
    pol = fb.resolved_policy()
    obs.observe_many(f"policy/{pol.name}/duty", thr_h.ravel())
    for op, n in (pol.residency(thr_h) or {}).items():
        obs.count(f"policy/{pol.name}/residency/{op}", n)


def replay_cases(cases, spec: StackSpec, fb: FeedbackParams, grid_n: int,
                 interval_dt: float, *, theta: float = 1.0,
                 steps_per_interval: int = 2, n_cg: int = 40,
                 margin: int | None = None, use_pallas: bool = False,
                 solver: str = "pcg", n_mg: int = 3,
                 n_shards: int | None = None,
                 device="cuda") -> dict[str, StackReport]:
    """Replay pre-assembled cases as ONE batched closed-loop replay on
    ``device``.

    ``cases``: sequence of (label, :func:`assemble_case` leaves) — every
    case must share the stack ``spec`` and grid shape; NumPy leaves and
    tensors on any device are accepted and moved to ``device``.  Returns
    {label: StackReport}; the results cross to the host once, at the end.
    ``n_shards`` routes through :func:`closed_loop_sharded` over that many
    local devices of ``device`` 's type (0/None = the plain batch on
    ``device``).
    """
    thermal.check_solver(solver)
    dev = resolve_device(device)
    margin = grid_n // 4 if margin is None else margin
    labels = [label for label, _ in cases]
    dyns, leaks, refs, masks, Fs, caps = zip(*(leaves for _, leaves in cases))
    replay = closed_loop_batch if not n_shards else functools.partial(
        closed_loop_sharded, n_shards=n_shards)
    with obs.span("feedback/replay", cases=len(labels), grid_n=grid_n,
                  solver=solver, n_shards=n_shards or 0):
        Fb = {k: _batch([F[k] for F in Fs], dev) for k in Fs[0]}
        out = replay(
            _batch(dyns, dev), _batch(leaks, dev), _batch(refs, dev),
            _batch(masks, dev), Fb, _batch(caps, dev), interval_dt, theta,
            fb=fb, die_n=grid_n, n_die=spec.n_die_layers,
            steps_per_interval=steps_per_interval, n_cg=n_cg,
            margin=margin, solver=solver, n_mg=n_mg)
        _, peaks, mins, res, thr, ref_W, leak_W, dyn_W = (o.cpu().numpy()
                                                           for o in out)
    if obs.is_enabled():
        _replay_telemetry(fb, res, thr)
    base_ref = dram.DRAMFloorplan(die_w_mm=1.0).base_refresh_W() \
        * len(spec.dram_layers)
    return {
        label: StackReport(
            label=label, interval_s=interval_dt, spec=spec,
            peak_C=peaks[i], min_C=mins[i], residual_C=res[i],
            throttle=thr[i], refresh_W=ref_W[i], leak_W=leak_W[i],
            base_refresh_W=base_ref, tol_C=fb.picard_tol_C,
            dyn_W=dyn_W[i])
        for i, label in enumerate(labels)}


# ---------------------------------------------------------------------------
# top-level entry point: batched AP+DRAM vs SIMD+DRAM closed-loop co-simulation
# ---------------------------------------------------------------------------

def run_stack_cosim(workloads=("dmm", "fft", "bs"), n_dram: int = 2,
                    grid_n: int = 16, n_intervals: int = 32,
                    t_end: float = 0.25, steps_per_interval: int = 2,
                    n_cg: int = 40, theta: float = 1.0,
                    fb: FeedbackParams = FeedbackParams(),
                    params: StackParams = PAPER_STACK,
                    use_pallas: bool = False, solver: str = "pcg",
                    n_mg: int = 3, n_shards: int | None = None, *,
                    device="cuda") -> dict:
    """The paper's abstract claim, quantified: for each workload replay the
    AP and the same-performance SIMD under ``n_dram`` stacked DRAM dies
    with closed-loop refresh/leakage/DTM feedback, in ONE batch on
    ``device`` (the AP traces are captured there too).

    Returns ``{workload: {"ap": StackReport, "simd": StackReport},
    "design_points": {...}, "spec": StackSpec, ...}``.
    """
    thermal.check_solver(solver)
    dev = resolve_device(device)
    spec = dram_on_logic(n_dram, params)
    margin = grid_n // 4
    interval_dt = t_end / n_intervals
    n_small = cosim.trace_elems(M.N_DATA)    # shared trace-sizing rule

    cases, dps = [], {}
    for w in workloads:
        dp = cosim.comparable_design_point(w)
        dps[w] = dp
        wl = M.WORKLOADS[w]
        pair = (("ap", cosim.ap_workload_trace(w, n_intervals, n_small,
                                               device=dev)),
                ("simd", cosim.simd_phase_trace(wl, dp, n_intervals)))
        for machine, trace in pair:
            cases.append((f"{w}/{machine}", assemble_case(
                dp, w, machine, spec, params, grid_n, trace, margin,
                device=dev)))

    reports = replay_cases(cases, spec, fb, grid_n, interval_dt,
                           theta=theta,
                           steps_per_interval=steps_per_interval,
                           n_cg=n_cg, margin=margin, solver=solver,
                           n_mg=n_mg, n_shards=n_shards, device=dev)
    out: dict = {"design_points": dps, "spec": spec,
                 "interval_s": interval_dt, "t_end": t_end, "fb": fb}
    for label, rep in reports.items():
        w, machine = label.split("/")
        out.setdefault(w, {})[machine] = rep
    return out
