"""Traffic → power → thermal interval co-simulation (the tentpole).

The CoMeT loop (arXiv 2109.12405) at serving granularity: a fluid FIFO
queue turns the request trace into per-interval machine utilization and
decode-batch state; the interval lowering turns that into logic power
and DRAM activate traffic for the 3D stack; the closed-loop replay
(``stack/feedback``) integrates the thermal network with refresh,
leakage, and DTM feedback; and the DTM throttle flows BACK into the
queue's capacity for the next macro-round.  Two or three rounds
suffice — the throttle→capacity coupling is weak at interval
granularity — and the recorded ``throttle_residual`` certifies it.

Double-counting guard: the replay itself multiplies dynamic power by
its throttle f, so the frames fed to it carry the *busy fraction*
``d = served / (f_prev · C · dt)`` (power demanded if unthrottled).  At
the fixed point ``f = f_prev`` the applied power is ``f · d = served /
(C · dt)`` — exactly the machine's true utilization.

Multi-hour horizons stay cheap through adaptive interval coarsening
(``cosim.coarsen_plan``): base intervals merge while the utilization
and traffic signals move less than ``coarsen_tol``, and the replay runs
the merged variable-dt schedule (``dt_scale``).  The temperature error
this introduces is bounded by ``coarsen_tol`` × the stack's DC thermal
gain (``cosim.dc_peak_rise_C``; property-tested in
tests/test_coarsen_replay.py) and reported per scenario.

The port of the reference's ``serving/sim.py``.  The queue, the interval
lowering, the coarse plan and the reports are the same host NumPy
float64; the replay (``stack.feedback.closed_loop_batch``, whose PCG
matvec is the thermal-stencil kernel on a card) runs on the keyword-only
``device`` of :func:`run_serving_cosim`, ``"cuda"`` by default: without
a card it raises unless it is given ``device="cpu"``.  Where the
reference replays one machine after another, the port replays every
machine of a round in one batch (they share the round's coarse plan), so
a round costs the launches of one machine's replay; each machine's
results are bit for bit its replay alone.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import cosim
from repro_torch.core import models as M
from repro_torch.core import thermal
from repro_torch.core.constants import DRAM_LIMIT_C
from repro_torch.core.floorplan import MM, APFloorplan, SIMDFloorplan
from repro_torch.serving.cost import (ModelServingCost, RequestShape,
                                      serving_cost)
from repro_torch.serving.traffic import TrafficSpec
from repro_torch.stack import dram, feedback
from repro_torch.stack.spec import PAPER_STACK, StackParams, dram_on_logic


@dataclasses.dataclass(frozen=True)
class ServingScenario:
    """One serving co-simulation case (per machine)."""
    config: str
    traffic: TrafficSpec
    request: RequestShape = RequestShape()
    load: float = 0.7           # offered load as a fraction of saturation
    # (used when traffic.mean_qps <= 0: mean_qps = load * C / W_request)
    max_batch: int = 32         # decode batch cap (models/serve.py batching)
    n_dram: int = 2
    grid_n: int = 8
    coarsen_tol: float = 0.02   # activity units (busy fraction is in [0,1])
    max_merge: int = 64
    pad_quantum: int = 64       # coarse plans pad up to a multiple of this
    # (CoarsePlan.pad_to), as the reference buckets its jitted replays
    n_rounds: int = 2           # throttle<->queue macro-iterations
    steps_per_interval: int = 1
    n_cg: int = 25
    theta: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.load:
            raise ValueError("load must be > 0")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.n_rounds < 1:
            raise ValueError("n_rounds must be >= 1")
        if self.coarsen_tol < 0:
            raise ValueError("coarsen_tol must be >= 0")

    @property
    def label(self) -> str:
        return f"{self.config}/{self.traffic.shape}"


# ---------------------------------------------------------------------------
# fluid FIFO queue with continuous decode batching
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QueueResult:
    """Per-interval queue state of one round."""
    served_flops: np.ndarray    # [T] work served per interval
    busy: np.ndarray            # [T] busy fraction of *available* capacity
    batch: np.ndarray           # [T] decode batch size in effect
    backlog_flops: np.ndarray   # [T] work in system at interval END
    latency_s: np.ndarray       # per-request end-to-end latency [n_requests]


def fluid_queue(arrivals: np.ndarray, cost: ModelServingCost,
                cap_flops_per_s: float, throttle: np.ndarray,
                interval_s: float, max_batch: int) -> QueueResult:
    """FIFO fluid queue at interval granularity.

    Work is measured in FLOPs (``cost.request_flops`` per request).
    Interval t offers capacity ``throttle[t] * cap * dt``; the batch in
    effect is the number of requests in system clamped to ``max_batch``
    (continuous batching: every live sequence advances each step, the
    parameter read amortized across them — ``models/serve.py``
    semantics).  Request latency = fluid FIFO finish time − arrival
    time, floored by the request's serialized decode time at the batch
    in effect (B·flops/token per generated token: batching trades
    single-stream latency for shared-weight throughput).
    """
    arrivals = np.asarray(arrivals)
    T = arrivals.shape[0]
    throttle = np.broadcast_to(np.asarray(throttle, np.float64), (T,))
    w_req = cost.request_flops
    cap_dt = cap_flops_per_s * interval_s

    served = np.zeros(T)
    busy = np.zeros(T)
    batch = np.ones(T)
    backlog_end = np.zeros(T)
    backlog = 0.0
    for t in range(T):
        backlog += arrivals[t] * w_req
        avail = throttle[t] * cap_dt
        s = min(backlog, avail)
        served[t] = s
        busy[t] = s / avail if avail > 0 else 0.0
        backlog -= s
        backlog_end[t] = backlog
        n_live = backlog / w_req + arrivals[t]
        batch[t] = min(max_batch, max(1.0, math.ceil(n_live)))

    # ---- per-request latency from cumulative arrived vs served work ----
    n_req = int(arrivals.sum())
    if n_req == 0:
        return QueueResult(served, busy, batch, backlog_end, np.zeros(0))
    # arrival times: uniform within each interval; work positions: FIFO
    t_arr = np.repeat(np.arange(T) * interval_s, arrivals) \
        + np.concatenate([(np.arange(a) + 0.5) / max(a, 1) * interval_s
                          for a in arrivals]) if n_req else np.zeros(0)
    w_pos = (np.arange(n_req) + 1.0) * w_req     # finish needs own work done
    S = np.concatenate([[0.0], np.cumsum(served)])
    t_edge = np.arange(T + 1) * interval_s
    # extrapolate past the horizon at the final capacity so every request
    # finishes and the tail percentile stays meaningful under overload
    tail_rate = max(throttle[-1] * cap_flops_per_s, 1e-6 * cap_flops_per_s)
    extra = max(w_pos[-1] - S[-1], 0.0)
    S_ext = np.concatenate([S, [S[-1] + extra + cap_dt]])
    t_ext = np.concatenate([t_edge, [t_edge[-1]
                                     + (extra + cap_dt) / tail_rate]])
    t_fin = np.interp(w_pos, S_ext, t_ext)
    # serialized-decode floor at the batch in effect on arrival
    b_arr = np.repeat(batch, arrivals)
    floor = (cost.prefill_flops + cost.request.output_tokens
             * cost.decode_flops_per_token * b_arr) / cap_flops_per_s
    lat = np.maximum(t_fin - t_arr, floor)
    return QueueResult(served, busy, batch, backlog_end, lat)


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServingReport:
    """SLA + thermal outcome of one (scenario, machine) co-simulation."""
    label: str                  # "<config>/<traffic>/<machine>"
    machine: str
    scenario: ServingScenario
    dp: M.DesignPoint
    mean_qps: float             # resolved offered rate
    stack: feedback.StackReport         # coarse-interval thermal record
    durations_s: np.ndarray     # [Tc] coarse interval lengths
    queue: QueueResult          # final-round queue state (base intervals)
    latency_s: np.ndarray       # final-round per-request latencies
    n_base: int
    n_coarse: int
    error_bound_C: float        # coarsening bound: tol x DC gain
    throttle_residual: float    # max |f_k - f_{k-1}| of the last round

    @property
    def coarsen_ratio(self) -> float:
        return self.n_base / self.n_coarse

    @property
    def p50_s(self) -> float:
        return float(np.median(self.latency_s)) if self.latency_s.size \
            else 0.0

    @property
    def p99_s(self) -> float:
        return float(np.percentile(self.latency_s, 99)) \
            if self.latency_s.size else 0.0

    @property
    def dtm_slowdown(self) -> float:
        """Duration-weighted mean 1/f (>= 1)."""
        w = self.durations_s / self.durations_s.sum()
        return float(np.sum(w / self.stack.throttle))

    def time_above(self, limit_C: float = DRAM_LIMIT_C) -> float:
        """Seconds the verdict layers (DRAM dies if any, else all dies)
        spent above ``limit_C``, duration-weighted over the coarse grid."""
        spec = self.stack.spec
        layers = list(spec.dram_layers
                      or range(spec.n_die_layers))
        hot = (self.stack.peak_C[:, layers] > limit_C).any(axis=1)
        return float(self.durations_s[hot].sum())

    @property
    def verdict_ok(self) -> bool:
        return self.time_above() == 0.0

    @property
    def served_qps(self) -> float:
        w_req = serving_cost(self.scenario.config,
                             self.scenario.request).request_flops
        horizon = self.scenario.traffic.horizon_s
        return float(self.queue.served_flops.sum() / w_req / horizon)

    def throttle_curve(self, n_bins: int = 5):
        """Throughput-vs-throttle: (f bin centers, mean served QPS in
        bin, seconds spent in bin) over the coarse intervals."""
        w_req = serving_cost(self.scenario.config,
                             self.scenario.request).request_flops
        f = self.stack.throttle
        plan_served = self.queue.served_flops
        # fold base-interval served work onto the coarse grid
        edges = np.concatenate([[0], np.cumsum(
            np.round(self.durations_s
                     / self.scenario.traffic.interval_s).astype(int))])
        served_c = np.array([plan_served[edges[i]:edges[i + 1]].sum()
                             for i in range(self.n_coarse)])
        qps_c = served_c / w_req / self.durations_s
        bins = np.linspace(f.min(), max(f.max(), f.min() + 1e-9),
                           n_bins + 1)
        idx = np.clip(np.digitize(f, bins) - 1, 0, n_bins - 1)
        centers = 0.5 * (bins[:-1] + bins[1:])
        mean_qps = np.array([qps_c[idx == b].mean() if (idx == b).any()
                             else 0.0 for b in range(n_bins)])
        secs = np.array([self.durations_s[idx == b].sum()
                         for b in range(n_bins)])
        return centers, mean_qps, secs


# ---------------------------------------------------------------------------
# the co-simulation
# ---------------------------------------------------------------------------

def _machine_floorplan(machine: str, dp: M.DesignPoint, wl: M.Workload):
    if machine == "ap":
        fp = APFloorplan(die_w_mm=math.sqrt(dp.ap_area_mm2))
        return fp, lambda gn: fp.power_map(gn, dp.ap_power_W), \
            fp.leakage_W()
    if machine == "simd":
        fp = SIMDFloorplan(die_w_mm=math.sqrt(dp.simd_area_mm2))
        return fp, lambda gn: fp.power_map(gn, dp, wl), fp.leakage_W(dp)
    raise ValueError(f"unknown machine {machine!r}")


def _machine_inputs(machine: str, scenario: ServingScenario, dp, wl,
                    spec, params: StackParams, margin: int, dev) -> dict:
    """One machine's floorplan, grid, power map, leakage, DRAM floorplan,
    and its grid's fields and capacity on ``dev``."""
    fp, pmap_of, leak_W = _machine_floorplan(machine, dp, wl)
    grid = thermal.Grid(die_w=fp.die_w_mm * MM, ny=scenario.grid_n,
                        nx=scenario.grid_n, params=params, spec=spec,
                        margin=margin)
    return dict(grid=grid, pmap=pmap_of(scenario.grid_n), leak_W=leak_W,
                dfp=dram.DRAMFloorplan(die_w_mm=fp.die_w_mm),
                F=grid.fields(dev), cap3=grid.capacity_field(dev))


def _serving_round(scenario: ServingScenario, arrivals, cost, cap, dp,
                   f_base: dict, plan, coarsen, spec, inputs: dict, fb,
                   margin):
    """One throttle↔queue macro-iteration of the serving co-simulation,
    for every machine of ``f_base`` ({machine: [T] throttle}) at once.

    The coarse plan is built in round 1, where every machine's queue
    runs at a throttle of 1 and so is the same, and then frozen: every
    machine replays the same plan, so the machines' replays run as ONE
    batched replay (``feedback.closed_loop_batch``), each machine a case
    with its own grid's fields (``inputs``, from :func:`_machine_inputs`).
    No per-case sum of the replay depends on the batch size, so each
    machine's results are bit for bit those of its replay alone.
    Returns ``(queues, plan, f_new, residuals, repl)``, all but the plan
    by machine, ``repl`` each machine's replay output ``(dyn, peaks,
    mins, picard_res, f_c, ref_W, leak_Wt, dyn_Wt)`` as host NumPy
    (``dyn`` kept for the coarsening error bound).
    """
    tr = scenario.traffic
    T = arrivals.shape[0]
    queues, traffic = {}, {}
    for m, f in f_base.items():
        q = fluid_queue(arrivals, cost, cap, f, tr.interval_s,
                        scenario.max_batch)
        # demand traffic at the interval's decode batch (per-batch AI)
        queues[m], traffic[m] = q, np.array(
            [q.busy[t] * cost.traffic_bytes_per_s(int(q.batch[t]),
                                                  dp.ap_n_pus)
             for t in range(T)])
    if plan is None:        # frozen after round 1
        q, traffic_t = next(iter(queues.values())), \
            next(iter(traffic.values()))
        if coarsen and scenario.coarsen_tol > 0:
            tref = max(traffic_t.max(), 1e-30)
            joint = np.stack([q.busy, traffic_t / tref], axis=1)
            plan = cosim.coarsen_plan(joint, scenario.coarsen_tol,
                                      scenario.max_merge)
            qmax = scenario.pad_quantum
            plan = plan.pad_to(
                min(-(-plan.n_coarse // qmax) * qmax, T))
        else:
            plan = cosim.CoarsePlan(np.ones(T, np.int64))
    frames = {m: feedback.stack_power_frames(
        spec, inputs[m]["grid"], plan.merge(queues[m].busy),
        inputs[m]["pmap"], inputs[m]["leak_W"], inputs[m]["dfp"],
        plan.merge(traffic[m])) for m in queues}
    first = next(iter(inputs.values()))
    dev = first["cap3"].device

    def batch(xs):
        return torch.stack([torch.from_numpy(np.asarray(x, np.float32))
                            if isinstance(x, np.ndarray) else x
                            for x in xs]).to(dev)
    res = feedback.closed_loop_batch(
        *(batch([frames[m][i] for m in queues]) for i in range(4)),
        {k: batch([inputs[m]["F"][k] for m in queues])
         for k in first["F"]},
        batch([inputs[m]["cap3"] for m in queues]),
        tr.interval_s, scenario.theta, fb=fb,
        die_n=scenario.grid_n, n_die=spec.n_die_layers,
        steps_per_interval=scenario.steps_per_interval,
        n_cg=scenario.n_cg, margin=margin, solver="pcg",
        dt_scale=plan.dt_scale())
    out = [r.cpu().numpy() for r in res[1:]]
    f_new, residuals, repl = {}, {}, {}
    for b, m in enumerate(queues):
        peaks, mins, picard_res, f_c, ref_W, leak_Wt, dyn_Wt = (
            o[b] for o in out)
        f_new[m] = plan.expand(f_c)
        residuals[m] = float(np.abs(f_new[m] - f_base[m]).max())
        repl[m] = (frames[m][0], peaks, mins, picard_res, f_c, ref_W,
                   leak_Wt, dyn_Wt)
    return queues, plan, f_new, residuals, repl


def run_serving_cosim(scenario: ServingScenario,
                      machines=("ap", "simd"),
                      fb: feedback.FeedbackParams = feedback.FeedbackParams(),
                      params: StackParams = PAPER_STACK,
                      coarsen: bool = True, *,
                      device: str | torch.device = "cuda"
                      ) -> dict[str, ServingReport]:
    """Co-simulate one serving scenario on each machine.

    Returns ``{machine: ServingReport}``.  ``coarsen=False`` replays
    every base interval uniformly (the reference the error bound is
    stated against; the property test diffs the two).  The replays run
    on ``device``, every machine's round in one batch (see
    :func:`_serving_round`), so one ``serving/machine`` span (its
    ``machine`` argument names them all) holds the rounds, where the
    reference opens one a machine.
    """
    dev = resolve_device(device)
    cost = serving_cost(scenario.config, scenario.request)
    # the machine pair: same-performance AP/SIMD at the serving AI of a
    # saturated decode batch (the thermally-binding operating point)
    wl = cost.workload(scenario.max_batch)
    dp = cosim.comparable_design_point(wl)
    cap = M.ap_flops_per_s(dp.ap_n_pus)

    tr = scenario.traffic
    mean_qps = tr.mean_qps if tr.mean_qps > 0 else \
        scenario.load * cap / cost.request_flops
    arrivals = tr.arrivals(mean_qps)
    T = arrivals.shape[0]

    spec = dram_on_logic(scenario.n_dram, params)
    margin = scenario.grid_n // 4
    inputs = {m: _machine_inputs(m, scenario, dp, wl, spec, params, margin,
                                 dev) for m in machines}
    f_base = {m: np.ones(T) for m in machines}
    plan = None
    with obs.span("serving/machine", machine=",".join(machines),
                  scenario=scenario.label, n_base=T):
        for rnd in range(scenario.n_rounds):
            with obs.span("serving/round", machine=",".join(machines),
                          round=rnd):
                queues, plan, f_base, residuals, repl = _serving_round(
                    scenario, arrivals, cost, cap, dp, f_base, plan,
                    coarsen, spec, inputs, fb, margin)
    out: dict[str, ServingReport] = {}
    for machine in machines:
        q, residual, inp = queues[machine], residuals[machine], \
            inputs[machine]
        dyn, peaks, mins, picard_res, f_c, ref_W, leak_Wt, dyn_Wt = \
            repl[machine]
        if obs.is_enabled():
            w_req = cost.request_flops
            obs.count("serving/requests", q.latency_s.size)
            obs.count("serving/base_intervals", T)
            obs.count("serving/coarse_intervals", plan.n_coarse)
            obs.observe_many("serving/request_latency_s", q.latency_s)
            obs.observe_many("serving/queue_depth_req",
                             q.backlog_flops / w_req)
            obs.observe_many("serving/batch_occupancy",
                             q.batch / scenario.max_batch)
            obs.observe("serving/throttle_residual", residual)

        stack_rep = feedback.StackReport(
            label=f"{scenario.label}/{machine}", interval_s=tr.interval_s,
            spec=spec, peak_C=peaks, min_C=mins, residual_C=picard_res,
            throttle=f_c, refresh_W=ref_W, leak_W=leak_Wt,
            base_refresh_W=inp["dfp"].base_refresh_W()
            * len(spec.dram_layers),
            tol_C=fb.picard_tol_C, dyn_W=dyn_Wt)
        bound = scenario.coarsen_tol * cosim.dc_peak_rise_C(
            dyn.max(axis=0), inp["F"]) if coarsen else 0.0
        out[machine] = ServingReport(
            label=f"{scenario.label}/{machine}", machine=machine,
            scenario=scenario, dp=dp, mean_qps=mean_qps, stack=stack_rep,
            durations_s=plan.dt_scale() * tr.interval_s, queue=q,
            latency_s=q.latency_s, n_base=T, n_coarse=plan.n_coarse,
            error_bound_C=bound, throttle_residual=residual)
    return out


def verdict_table(reports: dict[str, dict[str, ServingReport]]) -> str:
    """AP-vs-SIMD SLA/thermal verdict table (CSV-ish, one row per
    (scenario, machine)).  ``reports``: {scenario_label: {machine: rep}}."""
    lines = ["config,traffic,machine,qps,p50_s,p99_s,logic_peak_C,"
             "dram_peak_C,dtm_x,above_85C_s,coarsen_x,verdict"]
    for label, by_machine in reports.items():
        for machine, r in by_machine.items():
            dram_pk = r.stack.dram_peak_C.max() \
                if r.stack.spec.dram_layers else 0.0
            lines.append(
                f"{r.scenario.config},{r.scenario.traffic.shape},{machine},"
                f"{r.mean_qps:.2f},{r.p50_s:.3f},{r.p99_s:.3f},"
                f"{r.stack.logic_peak_C.max():.1f},{dram_pk:.1f},"
                f"{r.dtm_slowdown:.3f},{r.time_above():.1f},"
                f"{r.coarsen_ratio:.1f},"
                f"{'OK' if r.verdict_ok else 'BLOCKED'}")
    return "\n".join(lines)


__all__ = ["ServingScenario", "ServingReport", "QueueResult",
           "fluid_queue", "run_serving_cosim", "verdict_table"]
