"""JAX reference values for ``chip_smoke.py``'s phases 22-28.

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
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import sys
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
from repro.sweep import SweepSpec, run_sweep
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


def main(argv) -> int:
    phases = dict(cosim=cosim_phase, coarsen=coarsen_phase,
                  faults=faults_phase, deep=deep_phase, shard=shard_phase,
                  apfloat=apfloat_phase, families=families_phase)
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
