"""JAX reference values for ``chip_smoke.py``'s phases 22-30.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/chip_reference.py

Runs the reference package ``repro`` on the CPU at each phase's sizes and
writes ``tools/chip_reference.json``: for every phase the parameters it
used (which ``chip_smoke.py`` reads back, so the card runs exactly these
cases) and the reference's results.  The card machine has no JAX, so the
port's chip run is held against this file.

- ``cosim`` (phase 22): ``cosim.run_cosim(("dmm", "fft", "bs"),
  grid_n=32, n_intervals=64, t_end=0.25)`` — every case's ``peak_C`` and
  ``min_C`` [64, 4], ``time_above`` and ``crossing_time``; and the same
  at ``n_cg=120`` (the converged twin).
- ``coarsen`` (phase 23): the variable-step replay on ``dram_on_logic(2)``
  at ``grid_n=24``: 384 base intervals (8 plateaus plus jitter below the
  tolerance, seeded), ``coarsen_plan(tol=0.1, max_merge=16).pad_to(48)``,
  the base-resolution and the coarsened replay, with feedback disabled
  and on; ``dc_peak_rise_C`` of the worst frame.
- ``faults`` (phase 24): ``benchmarks/bench_faults.py``'s grid (sort/ap,
  dmm/simd on 2 DRAM dies; none, stuck, dropout x naive per-die and
  guarded) at its own size and at ``grid_n=24`` with 48 intervals: each
  cell's verdict, DRAM peak and slowdown, ``n_guard_rescued``; the
  ``poison_solver("mg")`` fallback and its ``thermal/fallback/*``
  counters; the power-spike peaks; every replay again at ``n_cg=120``
  (the converged twins).
- ``deep`` (phase 25): steady ``mg`` and ``mgcg`` on ``dram_on_logic(12)``
  and ``(16)`` at 256^2 (phase 9's case), and ``run_sweep`` of
  ``bench_sweep.py``'s quick spec on 12 DRAM dies with ``solver="mg"``.
- ``shard`` (phase 26): ``tests/test_faults.py``'s device-count
  invariance case — sort/ap of 2^20 on 2 DRAM dies under ``PerDiePolicy``
  with the seeded ``SensorFaultSpec`` — replayed unsharded at
  ``grid_n=8`` (8 intervals) and at ``grid_n=24`` (48 intervals):
  ``peak_C``, ``min_C`` and ``throttle`` (NaN where a dropped-out reading
  reaches the policy).
- ``apfloat`` (phase 27): ``fp_mul`` and ``fp_add`` at N = 64 and 1024
  on ``bench_cycles.py``'s inputs (normal draws seeded by N): the
  cycles, every counter with the float64 energy, and SHA-256 digests of
  the result bits and of the trace arrays.
- ``families`` (phase 28): four configs at their published widths, cut
  in depth (``FAMILY_DEPTHS``), seeded weights: prefill and greedy decode
  steps (argmax, leading logits, sums of squares).
- ``serving`` (phase 29): ``run_serving_cosim`` of
  ``tests/test_serving.py``'s smoke scenario and of
  ``benchmarks/bench_serving.py``'s four quick scenarios (stablelm-1.6b
  and deepseek-v2-lite-16b x diurnal and bursty, 3600 s), both machines:
  each report's summary (resolved QPS, base and coarse interval counts,
  the coarse plan, latency percentiles, peaks, DTM slowdown, time above
  85 °C, verdict, error bound, throttle residual), SHA-256 digests of the
  first round's ``stack_power_frames`` outputs, the verdict table, the
  bench's gated aggregates, ``serving_cost`` of both configs, and each
  scenario again at ``n_cg=120`` (the converged twins).
- ``training`` (phase 30): ``train_loop`` at ``tests/test_runtime.py``'s
  size (stablelm-1.6b cut to 2 layers of d 64, 4 x 32 tokens, 10 steps,
  weights ``interop.lm_params_seed_numpy(cfg, 0)``) driven by the
  reference's ``make_train_step`` on a mesh of Auto axes (its own
  ``make_local_mesh`` makes Explicit axes on this JAX, on which
  ``loss_fn``'s sharding constraints fail): the 10 losses and grad
  norms; and for each of the ten reduced configs one
  ``value_and_grad(loss_fn)`` at B = 2, S = 32 (MoE capacity drops
  off): loss, nll, aux and the gradients' global norm.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import sys
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro import obs
from repro.core import apfloat, cosim, thermal
from repro.core import models as M
from repro.core.engine import APEngine
from repro.configs import get_config
from repro.core.floorplan import MM, APFloorplan
from repro.faults import (GuardedPolicy, PowerFaultSpec, SensorFaultSpec,
                          inject_power_spikes, poison_solver)
from repro.policy import PerDiePolicy
from repro.stack import dram, feedback
from repro.stack.spec import PAPER_STACK, dram_on_logic
from repro.models import serve as RS
from repro.serving import (RequestShape, ServingScenario, TrafficSpec,
                           run_serving_cosim, serving_cost, verdict_table)
from repro.sweep import SweepSpec, run_sweep
from repro import configs as jcfg
from repro.configs import list_configs
from repro.configs.base import ShapeCell
from repro.data import SyntheticLM
from repro.launch.steps import make_train_step
from repro.models import model as RM
from repro.optim import AdamWConfig, adamw_init
from repro.optim.adamw import global_norm
from repro.runtime.trainer import TrainerConfig, train_loop
from repro_torch import configs as tcfg
from repro_torch import interop

OUT = Path(__file__).with_suffix(".json")


def _arr(x, nd: int = 6):
    return np.round(np.asarray(x, np.float64), nd).tolist()


def cosim_phase() -> dict:
    params = dict(workloads=["dmm", "fft", "bs"], grid_n=32, n_intervals=64,
                  t_end=0.25, steps_per_interval=2, n_cg=40, twin_n_cg=120)
    out = dict(params=params)
    for key, n_cg in (("cases", params["n_cg"]),
                      ("twin", params["twin_n_cg"])):
        res = cosim.run_cosim(tuple(params["workloads"]),
                              grid_n=params["grid_n"],
                              n_intervals=params["n_intervals"],
                              t_end=params["t_end"],
                              steps_per_interval=params["steps_per_interval"],
                              n_cg=n_cg)
        out[key] = {
            f"{w}/{m}": dict(peak_C=_arr(r.peak_C), min_C=_arr(r.min_C),
                             time_above=_arr(r.time_above(), 9),
                             crossing_time=[float(v) for v
                                            in r.crossing_time()])
            for w in params["workloads"] for m, r in res[w].items()}
    return out


def coarsen_activity(seed: int, tol: float, n_base: int,
                     n_plateaus: int) -> np.ndarray:
    """``tests/test_coarsen_replay.py``'s ``_activity`` at ``n_base``
    intervals: plateaus plus jitter below the tolerance."""
    rng = np.random.default_rng(seed)
    act = np.repeat(rng.uniform(0.1, 1.0, n_plateaus), n_base // n_plateaus)
    act = act + rng.uniform(-0.3, 0.3, n_base) * tol
    return np.clip(act, 0.0, 1.2)


def coarsen_phase() -> dict:
    p = dict(n_dram=2, grid_n=24, margin=6, n_base=384, n_plateaus=8,
             seed=7, tol=0.1, max_merge=16, pad_to=48, interval_dt=0.05,
             n_cg=25, coarse_steps=4, traffic_bytes_per_s=1e10)
    spec = dram_on_logic(p["n_dram"])
    act = coarsen_activity(p["seed"], p["tol"], p["n_base"],
                           p["n_plateaus"])
    plan = cosim.coarsen_plan(act, p["tol"], p["max_merge"]).pad_to(
        p["pad_to"])
    dp = cosim.comparable_design_point("dmm")
    fp = APFloorplan(die_w_mm=math.sqrt(dp.ap_area_mm2))
    gn = p["grid_n"]
    grid = thermal.Grid(die_w=fp.die_w_mm * MM, ny=gn, nx=gn,
                        params=PAPER_STACK, spec=spec, margin=p["margin"])
    dfp = dram.DRAMFloorplan(die_w_mm=fp.die_w_mm)
    pmap = fp.power_map(gn, dp.ap_power_W)
    build = lambda a: feedback.stack_power_frames(
        spec, grid, a, pmap, fp.leakage_W(), dfp, p["traffic_bytes_per_s"])

    def replay(frames, fb, steps, dt_scale=None):
        dyn, l0, r0, lm = frames
        out = feedback.closed_loop_replay(
            dyn, l0, r0, lm, grid.fields(), grid.capacity_field(),
            p["interval_dt"], fb=fb, die_n=gn, n_die=spec.n_die_layers,
            steps_per_interval=steps, n_cg=p["n_cg"], margin=p["margin"],
            dt_scale=dt_scale)
        return np.asarray(out[1])

    base, merged = build(act), build(plan.merge(act))
    out = dict(params=p, reps=plan.reps.tolist(),
               dc_peak_rise_C=cosim.dc_peak_rise_C(base[0].max(axis=0),
                                                   grid.fields()))
    for mode, fb in (("disabled", feedback.FeedbackParams.disabled()),
                     ("feedback", feedback.FeedbackParams())):
        exact = replay(base, fb, 1)
        coarse = replay(merged, fb, p["coarse_steps"],
                        plan.dt_scale())
        out[mode] = dict(exact_peak_C=_arr(exact), coarse_peak_C=_arr(coarse),
                         error_C=abs(float(exact.max()) - float(coarse.max())))
    return out


def _verdict(rep) -> str:
    if not np.isfinite(rep.peak_C).all():
        return "FAILED"
    return "OK" if rep.dram_time_above_limit_s == 0.0 else "BLOCKED"


FAULTS = {"none": None,
          "stuck": SensorFaultSpec(seed=0, n_sensors=3, n_stuck=1),
          "dropout": SensorFaultSpec(seed=0, n_sensors=3, p_dropout=0.4)}


def fault_grid(grid_n: int, n_intervals: int, n_cg: int,
               twin_n_cg: int = 120) -> dict:
    spec = dram_on_logic(2, PAPER_STACK)
    margin = grid_n // 4
    dt = 0.25 / n_intervals
    cases = []
    for wl, mc in (("sort", "ap"), ("dmm", "simd")):
        dp = cosim.comparable_design_point(wl, 2 ** 20)
        trace = cosim.ap_workload_trace(
            wl, n_intervals, cosim.trace_elems(2 ** 20)) if mc == "ap" \
            else cosim.simd_phase_trace(M.WORKLOADS[wl], dp, n_intervals)
        cases.append((f"{wl}/{mc}", feedback.assemble_case(
            dp, wl, mc, spec, PAPER_STACK, grid_n, trace, margin)))
    policies = {"naive": PerDiePolicy(),
                "guarded": GuardedPolicy(inner=PerDiePolicy())}
    cells, verdicts = {}, {}
    for fname, fspec in FAULTS.items():
        for pname, pol in policies.items():
            fb = feedback.FeedbackParams(policy=pol, faults=fspec)
            reps, twins = (feedback.replay_cases(
                cases, spec, fb, grid_n, dt, steps_per_interval=1, n_cg=k,
                margin=margin) for k in (n_cg, twin_n_cg))
            for label, rep in reps.items():
                v = _verdict(rep)
                verdicts[(label, fname, pname)] = v
                cells[f"{label}/{fname}/{pname}"] = dict(
                    verdict=v, dram_peak_C=float(rep.dram_peak_C.max()),
                    slowdown=float(rep.dtm_slowdown),
                    twin_verdict=_verdict(twins[label]),
                    twin_dram_peak_C=float(twins[label].dram_peak_C.max()))
    rescued = sum(
        1 for label, _ in cases for f in FAULTS if f != "none"
        and verdicts[(label, f, "naive")] != "OK"
        and verdicts[(label, f, "guarded")] == "OK")
    label, (dyn, l0, r0, lm, F, cap3) = cases[0]
    spiked = inject_power_spikes(
        dyn, PowerFaultSpec(seed=0, n_spikes=2, magnitude=3.0))
    fb = feedback.FeedbackParams(policy=policies["naive"])
    spike = [float(feedback.replay_cases(
        [(label, (d, l0, r0, lm, F, cap3))], spec, fb, grid_n, dt,
        steps_per_interval=1, n_cg=k, margin=margin)[label]
        .dram_peak_C.max()) for d, k in ((dyn, n_cg), (spiked, n_cg),
                                         (spiked, twin_n_cg))]
    return dict(params=dict(grid_n=grid_n, n_intervals=n_intervals,
                            n_cg=n_cg, twin_n_cg=twin_n_cg),
                cells=cells, n_guard_rescued=rescued,
                spike_peak_C=spike[:2], spike_twin_peak_C=spike[2])


def fallback() -> dict:
    g = thermal.Grid(die_w=3e-3, ny=16, nx=16, margin=4)
    p = np.zeros((g.n_die_layers, 16, 16), np.float32)
    p[0, 4:12, 4:12] = 0.05
    _, healthy = thermal.steady_state_stats(p, g, solver="mg")
    with obs.scoped():
        with poison_solver("mg"):
            _, stats = thermal.steady_state_stats(p, g, solver="mg")
        counters = {k: v for k, v in obs.snapshot()["counters"].items()
                    if k.startswith("thermal/fallback/")}
    return dict(healthy_attempts=healthy["attempts"],
                attempts=stats["attempts"], solved_by=stats["solved_by"],
                counters=counters)


def faults_phase() -> dict:
    return dict(spec=fault_grid(8, 16, 25), wide=fault_grid(24, 48, 25),
                fallback=fallback())


def deep_phase() -> dict:
    out = dict(steady={}, params=dict(n=256, die_w=5e-3, power_W=40.0,
                                      n_dram=[12, 16]))
    for n_dram in (12, 16):
        spec = dram_on_logic(n_dram)
        n = 256
        grid = thermal.Grid(die_w=5e-3, ny=n, nx=n, margin=n // 4,
                            spec=spec)
        power = np.zeros((grid.n_die_layers, n, n), np.float32)
        power[list(spec.logic_layers)] = 40.0 / (len(spec.logic_layers)
                                                 * n * n)
        for s in ("mg", "mgcg"):
            T, st = thermal.steady_state_stats(power, grid, solver=s)
            out["steady"][f"{n_dram}/{s}"] = dict(
                max_C=float(np.max(np.asarray(T))),
                iterations=int(st["iterations"]))
    kw = dict(workloads=("sort", "hist"), sizes=(4096, 2 ** 20),
              n_dram=(12,), grid_n=8, n_intervals=8, steps_per_interval=1,
              n_cg=25, solver="mg")
    res = run_sweep(SweepSpec(**kw), use_cache=False)
    out["sweep"] = dict(params={k: list(v) if isinstance(v, tuple) else v
                                for k, v in kw.items()},
                        content_hash=res.spec.content_hash(),
                        records={r.label: dict(
                            verdict="OK" if r.verdict_ok else "BLOCKED",
                            dram_peak_C=float(r.report.dram_peak_C.max()))
                            for r in res.records})
    return out


#: tests/test_faults.py's faulted replay; its grid 24 twin at 48 intervals
SHARD_FAULTS = dict(seed=3, n_sensors=3, noise_C=0.8, n_stuck=1,
                    p_dropout=0.1)
SHARD_CASES = {"grid8": dict(grid_n=8, n_intervals=8, interval_dt=0.02,
                             margin=2, n_cg=15),
               "grid24": dict(grid_n=24, n_intervals=48,
                              interval_dt=0.25 / 48, margin=6, n_cg=15)}


def shard_phase() -> dict:
    spec = dram_on_logic(2, PAPER_STACK)
    dp = cosim.comparable_design_point("sort", 2 ** 20)
    fb = feedback.FeedbackParams(policy=PerDiePolicy(),
                                 faults=SensorFaultSpec(**SHARD_FAULTS))
    out = dict(faults=SHARD_FAULTS, cases={})
    for key, c in SHARD_CASES.items():
        trace = cosim.ap_workload_trace("sort", c["n_intervals"],
                                        cosim.trace_elems(2 ** 20))
        case = [("sort/ap", feedback.assemble_case(
            dp, "sort", "ap", spec, PAPER_STACK, c["grid_n"], trace,
            c["margin"]))]
        rep = feedback.replay_cases(
            case, spec, fb, c["grid_n"], c["interval_dt"],
            steps_per_interval=1, n_cg=c["n_cg"],
            margin=c["margin"])["sort/ap"]
        out["cases"][key] = dict(params=c, peak_C=_arr(rep.peak_C),
                                 min_C=_arr(rep.min_C),
                                 throttle=_arr(rep.throttle))
    return out


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


APFLOAT_BITS = 352


def apfloat_run(op: str, n: int) -> dict:
    """One ``bench_cycles.py``-style call: the engine's counters, cycles
    of the op alone and digests of the result and trace arrays."""
    eng = APEngine(n_words=n, n_bits=APFLOAT_BITS)
    x, y, z = (apfloat.FpField.alloc(eng) for _ in range(3))
    s = apfloat.FpScratch.alloc(eng)
    rng = np.random.default_rng(n)
    apfloat.load_fp32(eng, x, rng.normal(size=n).astype(np.float32))
    apfloat.load_fp32(eng, y, rng.normal(size=n).astype(np.float32))
    c0 = eng.cycles
    getattr(apfloat, op)(eng, x, y, z, s)
    out = apfloat.read_fp32(eng, z)
    return dict(cycles=eng.cycles - c0, counters=eng.counters(),
                result_sha256=_digest(out.view(np.uint32)),
                trace_sha256=_digest(*eng.trace_events()))


def apfloat_phase() -> dict:
    return dict(n_bits=APFLOAT_BITS,
                runs={f"{op}/{n}": apfloat_run(op, n)
                      for op in ("fp_mul", "fp_add") for n in (64, 1024)})


#: phase 28's configs and the depth each is cut to (the width is the
#: published one); the prompt length and greedy steps
FAMILY_DEPTHS = {"deepseek-v2-lite-16b": 2, "falcon-mamba-7b": 2,
                 "zamba2-1.2b": 7, "whisper-base": 6}
FAMILY_PROMPT, FAMILY_GEN = 64, 8


def _jnp_in_place(tree: dict) -> dict:
    """NumPy leaves -> jnp arrays, one leaf at a time, so the host holds
    one copy of the weights and not two."""
    for k, v in tree.items():
        tree[k] = _jnp_in_place(v) if isinstance(v, dict) else jnp.asarray(v)
    return tree


def family_run(name: str) -> dict:
    depth = FAMILY_DEPTHS[name]
    cfg = dataclasses.replace(get_config(name), n_layers=depth)
    params = _jnp_in_place(interop.lm_params_seed_numpy(
        dataclasses.replace(tcfg.get_config(name), n_layers=depth), 0))
    batch = {"tokens": jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, FAMILY_PROMPT)))}
    if cfg.family == "encdec":
        batch["audio_embeds"] = jnp.asarray(np.random.default_rng(1).normal(
            size=(1, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    logits, caches = RS.prefill(params, batch, cfg,
                                max_seq=FAMILY_PROMPT + FAMILY_GEN)
    step = jax.jit(lambda p, t, c, pos: RS.decode_step(p, t, c, pos, cfg))
    steps = []
    for i in range(FAMILY_GEN + 1):
        lg = np.asarray(logits[0], np.float64)
        top2 = np.sort(lg)[-2:]
        steps.append(dict(argmax=int(lg.argmax()), lead=lg[:6].tolist(),
                          sumsq=float((lg ** 2).sum()),
                          gap=float(top2[1] - top2[0])))
        if i < FAMILY_GEN:
            toks = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            logits, caches = step(params, toks, caches,
                                  jnp.int32(FAMILY_PROMPT + i))
    return dict(n_layers=depth, steps=steps)


def families_phase() -> dict:
    return dict(prompt=FAMILY_PROMPT, gen=FAMILY_GEN, seed=0,
                runs={name: family_run(name) for name in FAMILY_DEPTHS})


#: phase 29's scenarios: ``tests/test_serving.py``'s smoke scenario, and
#: ``benchmarks/bench_serving.py``'s ``scenarios(quick=True)`` (a copy:
#: its configs x shapes over one hour, at load 0.7, grid 8, tol 0.02,
#: padded to multiples of 64, two rounds); the twins at ``TWIN_N_CG``
SERVING_SMOKE = dict(config="stablelm-1.6b", shape="diurnal",
                     horizon_s=120.0, load=0.6, grid_n=8, n_rounds=2,
                     coarsen_tol=0.05, pad_quantum=16)
SERVING_QUICK = [dict(config=c, shape=sh, horizon_s=3600.0, load=0.7,
                      grid_n=8, coarsen_tol=0.02, pad_quantum=64,
                      n_rounds=2)
                 for c in ("stablelm-1.6b", "deepseek-v2-lite-16b")
                 for sh in ("diurnal", "bursty")]
SERVING_TWIN_N_CG = 120


def serving_scenario(p: dict, n_cg: int = 25) -> ServingScenario:
    kw = {k: v for k, v in p.items() if k not in ("shape", "horizon_s")}
    return ServingScenario(traffic=TrafficSpec(shape=p["shape"],
                                               horizon_s=p["horizon_s"]),
                           n_cg=n_cg, **kw)


def _frames_digest(frames) -> str:
    return _digest(*(np.asarray(x, np.float32) for x in frames))


def serving_report(r) -> dict:
    return dict(
        mean_qps=r.mean_qps, n_base=r.n_base, n_coarse=r.n_coarse,
        durations_sha256=_digest(np.asarray(r.durations_s, np.float64)),
        p50_s=r.p50_s, p99_s=r.p99_s, dtm_slowdown=r.dtm_slowdown,
        time_above=r.time_above(), verdict_ok=bool(r.verdict_ok),
        logic_peak_C=float(r.stack.logic_peak_C.max()),
        dram_peak_C=float(r.stack.dram_peak_C.max()),
        throttle_min=float(r.stack.throttle.min()),
        n_throttled=int((r.stack.throttle < 1.0).sum()),
        max_picard_residual_C=float(r.stack.residual_C.max()),
        error_bound_C=r.error_bound_C,
        throttle_residual=r.throttle_residual,
        coarsen_ratio=r.coarsen_ratio, served_qps=r.served_qps,
        n_requests=int(r.latency_s.size))


def serving_run(p: dict, n_cg: int = 25) -> dict:
    """One scenario on both machines, with the first round's frames of
    each machine digested as ``stack_power_frames`` returns them."""
    sc = serving_scenario(p, n_cg)
    frames, orig = [], feedback.stack_power_frames

    def spy(*a, **kw):
        out = orig(*a, **kw)
        frames.append(_frames_digest(out))
        return out
    feedback.stack_power_frames = spy
    try:
        t0 = time.time()
        reps = run_serving_cosim(sc)
        seconds = time.time() - t0
    finally:
        feedback.stack_power_frames = orig
    # two rounds a machine: the first round's frames are calls 0 and 2
    n_rounds = sc.n_rounds
    out = dict(label=sc.label, seconds=seconds, reports={})
    for i, (m, r) in enumerate(reps.items()):
        out["reports"][m] = dict(serving_report(r),
                                 frames_round1_sha256=frames[i * n_rounds])
    r0 = next(iter(reps.values()))
    out["plan"] = dict(reps=[int(v) for v in
                             np.round(r0.durations_s
                                      / sc.traffic.interval_s)],
                       n_coarse=r0.n_coarse, n_base=r0.n_base)
    out["table"] = verdict_table({sc.label: reps})
    return out, reps


def serving_phase() -> dict:
    out = dict(smoke_params=SERVING_SMOKE, quick_params=SERVING_QUICK,
               twin_n_cg=SERVING_TWIN_N_CG, cost={})
    for config in ("stablelm-1.6b", "deepseek-v2-lite-16b"):
        c = serving_cost(config, RequestShape())
        out["cost"][config] = dict(
            n_params=c.n_params, n_active=c.n_active,
            kv_bytes_tok=c.kv_bytes_tok, decode_ai_1=c.decode_ai(1),
            decode_ai_32=c.decode_ai(32), request_flops=c.request_flops)
    out["smoke"], _ = serving_run(SERVING_SMOKE)
    out["smoke_twin"], _ = serving_run(SERVING_SMOKE, SERVING_TWIN_N_CG)
    out["quick"], out["quick_twin"], all_reps = [], [], {}
    for p in SERVING_QUICK:
        run, reps = serving_run(p)
        out["quick"].append(run)
        all_reps[run["label"]] = reps
        out["quick_twin"].append(serving_run(p, SERVING_TWIN_N_CG)[0])
    flat = [r for reps in all_reps.values() for r in reps.values()]
    out["table"] = verdict_table(all_reps)
    out["gates"] = dict(
        n_cases=len(all_reps),
        n_ap_ok=sum(r["ap"].verdict_ok for r in all_reps.values()),
        n_simd_ok=sum(r["simd"].verdict_ok for r in all_reps.values()),
        min_coarsen_x=min(r.coarsen_ratio for r in flat),
        max_ap_throttle_residual=max(r["ap"].throttle_residual
                                     for r in all_reps.values()),
        max_error_bound_C=max(r.error_bound_C for r in flat))
    return out


#: phase 30 (c): the trainer at test_runtime's size; (d): one gradient
#: of every reduced config
TRAIN_SHAPE = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                   d_ff=128, vocab=512, d_head=32)
TRAIN_LOOP = dict(seq_len=32, global_batch=4, steps=10, ckpt_every=4,
                  stop_after=6, weight_seed=0, data_seed=0, remat="none",
                  accum_steps=1, lr=1e-3, warmup_steps=2, total_steps=10)
GRAD_CASE = dict(batch=2, seq_len=32, weight_seed=3, data_seed=1,
                 capacity_factor=100.0)


def grad_batch(cfg, p: dict) -> dict:
    """Phase 30 (d)'s batch of ``cfg`` (NumPy, from ``p["data_seed"]``);
    ``chip_smoke.py`` makes the same."""
    rng = np.random.default_rng(p["data_seed"])
    B, S = p["batch"], p["seq_len"]
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["audio_embeds"] = rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.normal(
            size=(B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return out


def grad_run(name: str) -> dict:
    def cut(pkg):
        c = pkg.get_config(name).reduced()
        if c.moe is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=GRAD_CASE["capacity_factor"]))
        return c
    cfg, tc = cut(jcfg), cut(tcfg)
    params = jax.tree_util.tree_map(jnp.asarray, interop.lm_params_seed_numpy(
        tc, GRAD_CASE["weight_seed"]))
    batch = {k: jnp.asarray(v) for k, v in grad_batch(cfg, GRAD_CASE).items()}
    (loss, met), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, b, cfg, perf=RM.PerfConfig(remat="none")),
        has_aux=True))(params, batch)
    return dict(loss=float(loss), nll=float(met["nll"]),
                aux=float(met["aux"]), grad_norm=float(global_norm(grads)))


def training_phase() -> dict:
    from jax.sharding import AxisType
    p = TRAIN_LOOP
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              **TRAIN_SHAPE)
    tc = dataclasses.replace(tcfg.get_config("stablelm-1.6b").reduced(),
                             **TRAIN_SHAPE)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    ts, _ = make_train_step(
        cfg, ShapeCell("t", p["seq_len"], p["global_batch"], "train"), mesh,
        perf=RM.PerfConfig(remat=p["remat"], accum_steps=p["accum_steps"]),
        opt_cfg=AdamWConfig(lr=p["lr"], warmup_steps=p["warmup_steps"],
                            total_steps=p["total_steps"]),
        dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, interop.lm_params_seed_numpy(
        tc, p["weight_seed"]))
    with tempfile.TemporaryDirectory() as d:
        out = train_loop(ts, params, adamw_init(params),
                         SyntheticLM(cfg.vocab, p["seq_len"],
                                     p["global_batch"], seed=p["data_seed"]),
                         TrainerConfig(steps=p["steps"],
                                       ckpt_every=p["ckpt_every"],
                                       ckpt_dir=d))
    loop = dict(losses=[h["loss"] for h in out["history"]],
                grad_norms=[h["grad_norm"] for h in out["history"]])
    return dict(shape=TRAIN_SHAPE, loop_params=p, loop=loop,
                grad_params=GRAD_CASE,
                grads={name: grad_run(name) for name in list_configs()})


def main(argv) -> int:
    phases = dict(cosim=cosim_phase, coarsen=coarsen_phase,
                  faults=faults_phase, deep=deep_phase, shard=shard_phase,
                  apfloat=apfloat_phase, families=families_phase,
                  serving=serving_phase, training=training_phase)
    want = argv or list(phases)
    data = json.loads(OUT.read_text()) if OUT.exists() else {}
    for name in want:
        t0 = time.time()
        data[name] = phases[name]()
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)
        OUT.write_text(json.dumps(data, sort_keys=True,
                                  separators=(",", ":")) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
