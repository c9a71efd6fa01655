"""Lower a :class:`~repro_torch.sweep.spec.SweepSpec` to batched replays
(PyTorch port of ``repro.sweep.engine``).

Scenario points that share a stack height, feedback mode and DTM policy
share one replay, so the engine groups the grid by
``(n_dram, fb_mode, policy)`` and replays each group as ONE batched
``feedback.replay_cases`` call over every (point × machine) case on the
device — the same path ``stack/feedback.run_stack_cosim`` uses.  Results
come back as :class:`SweepRecord`\\ s wrapping the port's
:class:`~repro_torch.stack.feedback.StackReport`, in deterministic
``spec.points() × spec.machines`` order, and are persisted through the
content-hashed cache (``repro_torch.sweep.cache``) so a repeat invocation
is served bit-identically from disk.

Port notes: :func:`run_sweep` takes the keyword-only ``device`` (default
``"cuda"``; without a card it raises), and captures the AP traces there
with ``spec.ap_backend`` as the capture mode.  A group whose replay
raises ``ValueError`` or ``FloatingPointError`` is demoted to FAILED
records, as in the reference; any other error propagates, so a FAILED
row never hides the card: a CUDA or kernel error is a ``RuntimeError``,
and a shape a kernel cannot take on the card (past its 32-bit indices)
is a ``NotImplementedError``.  ``n_shards`` slices each group's case
batch over that many local devices of ``device`` 's type
(``stack.feedback.closed_loop_sharded``).
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict

import numpy as np

from repro_torch import obs, resolve_device
from repro_torch import policy as policy_registry
from repro_torch.core import cosim
from repro_torch.core import models as M
from repro_torch.core.constants import DRAM_LIMIT_C
from repro_torch.stack import feedback
from repro_torch.stack.spec import PAPER_STACK, StackParams, dram_on_logic
from repro_torch.sweep.spec import SweepPoint, SweepSpec


def resolve_fb(mode: str, n_picard: int = 6,
               policy: str = "ramp") -> feedback.FeedbackParams:
    """Map a spec-level (feedback mode, policy name) to FeedbackParams.

    ``n_picard`` applies to the implicit-coupling modes; "open" keeps
    the fixed 2-iterate count of :meth:`FeedbackParams.disabled`.
    ``policy`` (a ``repro_torch.policy`` registry name) selects the
    controller in "closed" mode only — "nodtm" and "open" disable DTM by
    definition, so the policy axis is inert there."""
    if mode == "closed":
        pol = None if policy == "ramp" else policy_registry.get(policy)
        return feedback.FeedbackParams(n_picard=n_picard, policy=pol)
    if mode == "nodtm":
        return feedback.FeedbackParams(dtm_trip_C=math.inf,
                                       n_picard=n_picard)
    if mode == "open":
        return feedback.FeedbackParams.disabled()
    raise ValueError(f"unknown fb_mode {mode!r}")


@dataclasses.dataclass(frozen=True)
class SweepRecord:
    """One (scenario point, machine) outcome."""
    point: SweepPoint
    machine: str
    report: feedback.StackReport

    @property
    def label(self) -> str:
        return f"{self.point.label}/{self.machine}"

    @property
    def limit_layers(self) -> tuple[int, ...]:
        """Layers the 85 °C verdict is judged on: the DRAM dies when the
        stack has any, else every die layer (bare-logic stacking case)."""
        spec = self.report.spec
        return spec.dram_layers or tuple(range(spec.n_die_layers))

    @property
    def time_above_limit_s(self) -> float:
        return float(self.report.time_above(
            layers=self.limit_layers).max())

    @property
    def failed(self) -> bool:
        """Did this case's replay yield non-finite results (a diverged
        solve, or a group whose replay raised)?  Failed records mark
        FAILED in the table and never read as a passing verdict."""
        return not (np.isfinite(self.report.peak_C).all()
                    and np.isfinite(self.report.residual_C).all()
                    and np.isfinite(self.report.throttle).all())

    @property
    def verdict_ok(self) -> bool:
        """May this die sit under (or be) 3D DRAM?  (§4.3 ceiling)"""
        return not self.failed and self.time_above_limit_s == 0.0


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """All records of one sweep, in spec.points() × spec.machines order."""
    spec: SweepSpec
    records: tuple[SweepRecord, ...]
    from_cache: bool = False

    def __iter__(self):
        return iter(self.records)

    def get(self, point: SweepPoint, machine: str) -> SweepRecord:
        for r in self.records:
            if r.point == point and r.machine == machine:
                return r
        raise KeyError((point, machine))

    def table(self) -> str:
        """Per-point verdict table (CSV-ish, one row per record)."""
        lines = ["workload,size,n_dram,fb,policy,machine,logic_peak_C,"
                 "dram_peak_C,refresh_x,dtm_x,above_85C_s,resid_C,verdict"]
        for r in self.records:
            p, rep = r.point, r.report
            dram_pk = rep.dram_peak_C.max() if rep.spec.dram_layers else 0.0
            verdict = "FAILED" if r.failed else \
                "OK" if r.verdict_ok else "BLOCKED"
            lines.append(
                f"{p.workload},{p.size},{p.n_dram},{p.fb_mode},"
                f"{p.policy},{r.machine},"
                f"{rep.logic_peak_C.max():.1f},{dram_pk:.1f},"
                f"{rep.refresh_overhead:.3f},{rep.dtm_slowdown:.3f},"
                f"{r.time_above_limit_s:.3f},{rep.residual_C.max():.2g},"
                f"{verdict}")
        return "\n".join(lines)

    @property
    def n_failed(self) -> int:
        return sum(1 for r in self.records if r.failed)


# ---------------------------------------------------------------------------
# the lowering
# ---------------------------------------------------------------------------

def _run_group(spec: SweepSpec, points: list[SweepPoint], n_dram: int,
               fb_mode: str, policy: str, params: StackParams,
               n_shards: int | None = None, *, device="cuda"
               ) -> dict[tuple[SweepPoint, str], SweepRecord]:
    """Replay one (n_dram, fb_mode, policy) group as a single batch on
    ``device``, optionally partitioned over local devices
    (``n_shards``)."""
    dev = resolve_device(device)
    stack_spec = dram_on_logic(n_dram, params)
    fb = resolve_fb(fb_mode, spec.n_picard, policy)
    margin = spec.grid_n // 4
    interval_dt = spec.t_end / spec.n_intervals

    with obs.span("sweep/capture", n_dram=n_dram, fb=fb_mode,
                  policy=policy, points=len(points)):
        # cached per (workload, intervals, elements, mode, device) in
        # cosim, so a workload's capture is shared by every group
        traces = {(p.workload, p.size): cosim.ap_workload_trace(
            p.workload, spec.n_intervals, spec.trace_elems(p.size),
            mode=spec.ap_backend, device=dev)
            for p in points if "ap" in spec.machines}
    with obs.span("sweep/assemble", n_dram=n_dram, fb=fb_mode,
                  policy=policy, points=len(points)):
        keys, cases = [], []
        for p in points:
            dp = cosim.comparable_design_point(p.workload, p.size)
            wl = M.WORKLOADS[p.workload]
            for mc in spec.machines:
                trace = traces[(p.workload, p.size)] if mc == "ap" else \
                    cosim.simd_phase_trace(wl, dp, spec.n_intervals)
                keys.append((p, mc))
                cases.append((f"{p.label}/{mc}", feedback.assemble_case(
                    dp, p.workload, mc, stack_spec, params, spec.grid_n,
                    trace, margin, device=dev)))
    obs.count("sweep/cases", len(cases))

    with obs.span("sweep/replay", n_dram=n_dram, fb=fb_mode,
                  policy=policy, cases=len(cases)):
        reports = feedback.replay_cases(
            cases, stack_spec, fb, spec.grid_n, interval_dt,
            theta=spec.theta, steps_per_interval=spec.steps_per_interval,
            n_cg=spec.n_cg, margin=margin, solver=spec.solver,
            n_mg=spec.n_mg, n_shards=n_shards, device=dev)
    return {(p, mc): SweepRecord(point=p, machine=mc,
                                 report=reports[f"{p.label}/{mc}"])
            for p, mc in keys}


def _failed_group(spec: SweepSpec, points: list[SweepPoint], n_dram: int,
                  fb_mode: str, policy: str, params: StackParams,
                  reason: str
                  ) -> dict[tuple[SweepPoint, str], SweepRecord]:
    """NaN-filled placeholder records for a group whose replay raised.

    Shapes match a live replay's, every value is NaN, so each record
    reports ``failed`` and the table row reads FAILED — the rest of the
    sweep is unaffected (per-group failure isolation)."""
    stack_spec = dram_on_logic(n_dram, params)
    fb = resolve_fb(fb_mode, spec.n_picard, policy)
    nanT = np.full((spec.n_intervals, stack_spec.n_die_layers), np.nan,
                   np.float32)
    nan1 = np.full(spec.n_intervals, np.nan, np.float32)
    out = {}
    for p in points:
        for mc in spec.machines:
            rep = feedback.StackReport(
                label=f"{p.label}/{mc}",
                interval_s=spec.t_end / spec.n_intervals, spec=stack_spec,
                peak_C=nanT, min_C=nanT, residual_C=nan1, throttle=nan1,
                refresh_W=nan1, leak_W=nan1, base_refresh_W=0.0,
                tol_C=fb.picard_tol_C, dyn_W=nan1)
            out[(p, mc)] = SweepRecord(point=p, machine=mc, report=rep)
    print(f"sweep: group dram{n_dram}/{fb_mode}/{policy} FAILED "
          f"({reason}); {len(out)} case(s) isolated")
    return out


def run_sweep(spec: SweepSpec, cache_dir=None, use_cache: bool = True,
              params: StackParams = PAPER_STACK,
              n_shards: int | None = None, *,
              device="cuda") -> SweepResult:
    """Run (or load) a sweep on ``device``.  With ``use_cache`` the
    content-hashed on-disk entry of this device type is consulted first
    and written after a live run, so a second invocation of the same spec
    is served bit-identically from disk.

    ``n_shards`` partitions every group's case batch over that many
    local devices of ``device`` 's type (None/0 = the plain batch on
    ``device``).  It is an EXECUTION knob, not part of the spec:
    per-case results are bitwise identical for any shard count, so cache
    keys and cached artifacts do not depend on it.
    """
    from repro_torch.sweep import cache
    dev = resolve_device(device)
    if params != PAPER_STACK:
        use_cache = False       # cache keys don't cover custom stack params
    if use_cache:
        hit = cache.load(spec, cache_dir, device=dev)
        if hit is not None:
            return hit

    # "nodtm"/"open" ignore the policy axis entirely, so their points
    # collapse onto one replay group per (n_dram, fb_mode) regardless of
    # the spec's policy list — no duplicate physics for inert labels
    by_group: dict[tuple[int, str, str], list[SweepPoint]] = \
        defaultdict(list)
    for p in spec.points():
        pol = p.policy if p.fb_mode == "closed" else "ramp"
        by_group[(p.n_dram, p.fb_mode, pol)].append(p)

    results: dict[tuple[SweepPoint, str], SweepRecord] = {}
    with obs.span("sweep/run", groups=len(by_group)):
        for (n_dram, fb_mode, pol), pts in sorted(by_group.items()):
            with obs.span("sweep/group", n_dram=n_dram, fb=fb_mode,
                          policy=pol, points=len(pts)):
                # per-group failure isolation: bad power inputs or a
                # solver blow-up demote one group to NaN records; any
                # other error (a CUDA or kernel fault) propagates
                try:
                    results.update(_run_group(spec, pts, n_dram, fb_mode,
                                              pol, params, n_shards,
                                              device=dev))
                except (ValueError, FloatingPointError) as e:
                    obs.count("sweep/groups_failed")
                    results.update(_failed_group(
                        spec, pts, n_dram, fb_mode, pol, params, str(e)))

    records = tuple(results[(p, mc)] for p in spec.points()
                    for mc in spec.machines)
    out = SweepResult(spec=spec, records=records)
    # never persist failures: a cached FAILED row would keep serving
    # the placeholder after the underlying cause is fixed
    if use_cache and not out.n_failed:
        cache.store(out, cache_dir, device=dev)
    return out


__all__ = ["SweepRecord", "SweepResult", "run_sweep", "resolve_fb",
           "DRAM_LIMIT_C"]
