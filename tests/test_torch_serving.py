"""The serving co-simulation of the port against the reference.

The port's ``repro_torch.serving`` runs the reference's host NumPy
arithmetic (traffic, cost, the fluid queue, the coarse plan, the
reports) and replays the interval power through the port's closed loop
on the CPU here.  Host values must match the reference's bit for bit;
the replay's float32 peaks within ``PEAK_TOL_C`` at the scenario's 25 CG
iterations and within ``TWIN_TOL_C`` at 120 (the converged twin), as
ROADMAP Queue 3 items 4 and 11 record.  Every test of the reference's
``tests/test_serving.py`` has its twin here, run on the port.
"""
import dataclasses
import hashlib
import json
import math
from pathlib import Path

import numpy as np
import pytest

from repro import obs as jobs
from repro import serving as J
from repro.configs import list_configs
from repro.core import models as JM
from repro_torch import obs as tobs
from repro_torch import serving as S
from repro_torch.core import models as M
from repro_torch.serving import (RequestShape, TrafficSpec, fluid_queue,
                                 kv_bytes_per_token, run_serving_cosim,
                                 serving_cost, verdict_table)
from repro_torch.serving.sim import ServingScenario

PEAK_TOL_C = 0.1
TWIN_TOL_C = 1e-3
TWIN_N_CG = 120
SMOKE = dict(config="stablelm-1.6b", load=0.6, grid_n=8, n_rounds=2,
             coarsen_tol=0.05, pad_quantum=16)


def test_all_is_the_references():
    assert S.__all__ == J.__all__
    assert S.SHAPES == J.SHAPES


# ---------------------------------------------------------------- traffic

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shape", ["constant", "diurnal", "bursty"])
def test_arrivals_match_reference(shape, seed):
    kw = dict(shape=shape, mean_qps=3.5, horizon_s=900.0, interval_s=1.0,
              seed=seed)
    got, want = TrafficSpec(**kw), J.TrafficSpec(**kw)
    np.testing.assert_array_equal(got.rate_qps(), want.rate_qps())
    np.testing.assert_array_equal(got.arrivals(), want.arrivals())
    np.testing.assert_array_equal(got.arrivals(1.25), want.arrivals(1.25))
    assert (got.n_intervals, got.label) == (want.n_intervals, want.label)


def test_traffic_is_deterministic_per_seed():
    spec = TrafficSpec(shape="bursty", mean_qps=2.0, horizon_s=300)
    np.testing.assert_array_equal(spec.arrivals(), spec.arrivals())
    other = TrafficSpec(shape="bursty", mean_qps=2.0, horizon_s=300, seed=1)
    assert not np.array_equal(spec.arrivals(), other.arrivals())


@pytest.mark.parametrize("shape", ["constant", "diurnal", "bursty"])
def test_traffic_mean_rate_is_preserved(shape):
    spec = TrafficSpec(shape=shape, mean_qps=5.0, horizon_s=2000.0)
    rates = spec.rate_qps()
    assert rates.shape == (spec.n_intervals,)
    assert (rates >= 0).all()
    tol = 0.02 if shape != "bursty" else 0.5
    assert abs(rates.mean() / 5.0 - 1.0) < tol


def test_diurnal_trough_at_start_peak_mid_cycle():
    spec = TrafficSpec(shape="diurnal", mean_qps=10.0, horizon_s=1000.0,
                       swing=0.8)
    rates = spec.rate_qps()
    assert rates.argmin() in (0, len(rates) - 1)
    assert abs(rates.argmax() - len(rates) // 2) <= 1
    assert rates.max() <= 10.0 * 1.8 + 1e-9


def test_traffic_validation():
    with pytest.raises(ValueError, match="unknown traffic shape"):
        TrafficSpec(shape="sawtooth")
    with pytest.raises(ValueError):
        TrafficSpec(horizon_s=-1.0)
    with pytest.raises(ValueError):
        TrafficSpec(swing=1.5)
    with pytest.raises(ValueError, match="resolved"):
        TrafficSpec(mean_qps=0.0).rate_qps()


NAN, INF = float("nan"), float("inf")


@pytest.mark.parametrize("kw", [
    {"horizon_s": NAN}, {"horizon_s": 0.0}, {"horizon_s": INF},
    {"interval_s": NAN}, {"interval_s": 0.0}, {"interval_s": -1.0},
    {"mean_qps": NAN}, {"mean_qps": INF},
    {"period_s": NAN},
    {"burst_ratio": NAN}, {"burst_ratio": 0.5}, {"burst_ratio": INF},
    {"p_enter": 0.0}, {"p_exit": 1.5},
])
def test_traffic_rejects_nonfinite_shape_params(kw):
    """The same ValueError as the reference's, with its message."""
    with pytest.raises(ValueError) as want:
        J.TrafficSpec(**kw)
    with pytest.raises(ValueError) as got:
        TrafficSpec(**kw)
    assert str(got.value) == str(want.value)


def test_rate_qps_rejects_nonfinite_mean():
    spec = TrafficSpec(mean_qps=0.0)
    with pytest.raises(ValueError, match="resolved"):
        spec.rate_qps(NAN)
    with pytest.raises(ValueError, match="resolved"):
        spec.rate_qps(INF)
    assert spec.rate_qps(2.0).shape == (spec.n_intervals,)


# ------------------------------------------------------------------- cost

@pytest.mark.parametrize("name", list_configs())
def test_serving_cost_matches_reference(name):
    """Every field and derived figure of every config, exactly."""
    req = RequestShape(512, 64)
    got, want = serving_cost(name, req), J.serving_cost(
        name, J.RequestShape(512, 64))
    assert (got.config, got.n_params, got.n_active, got.kv_bytes_tok) \
        == (want.config, want.n_params, want.n_active, want.kv_bytes_tok)
    for attr in ("prefill_flops", "decode_flops_per_token", "request_flops",
                 "param_bytes", "mean_context"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for b in (1, 4, 32, 64):
        assert got.decode_step_bytes(b) == want.decode_step_bytes(b)
        assert got.decode_ai(b) == want.decode_ai(b)
        assert got.traffic_bytes_per_s(b, 4096) \
            == want.traffic_bytes_per_s(b, 4096)
        assert got.workload(b) == M.derived_workload(
            f"serve:{name}", want.decode_ai(b))
    assert got.n_params > 0 and 0 < got.n_active <= got.n_params
    # the workload is the reference's Workload, field for field
    assert dataclasses.astuple(got.workload(32)) \
        == dataclasses.astuple(want.workload(32))


def test_serving_cost_basics():
    cost = serving_cost("stablelm-1.6b", RequestShape(1024, 128))
    assert cost.n_params > 1e9
    assert 0 < cost.n_active <= cost.n_params
    assert cost.prefill_flops == 2.0 * cost.n_active * 1024
    assert cost.request_flops > cost.prefill_flops
    assert cost.decode_step_bytes(2) - cost.decode_step_bytes(1) \
        == pytest.approx(cost.kv_bytes_tok * cost.mean_context)
    with pytest.raises(ValueError):
        cost.decode_step_bytes(0)
    with pytest.raises(ValueError):
        RequestShape(0, 1)


def test_decode_ai_rises_with_batch_then_saturates():
    cost = serving_cost("stablelm-1.6b")
    ais = [cost.decode_ai(b) for b in (1, 4, 16, 64)]
    assert all(b > a for a, b in zip(ais, ais[1:]))
    ceiling = cost.decode_flops_per_token / (
        cost.kv_bytes_tok * cost.mean_context / M.BYTES_PER_WORD)
    assert ais[-1] < ceiling


def test_kv_bytes_family_rules():
    from repro_torch.configs import get_config
    assert kv_bytes_per_token(get_config("falcon-mamba-7b")) == 0.0
    mla = get_config("deepseek-v2-lite-16b")
    assert kv_bytes_per_token(mla) \
        == mla.n_layers * (mla.mla.kv_lora + mla.mla.qk_rope) * 2.0
    hyb = get_config("zamba2-1.2b")
    dense = get_config("stablelm-1.6b")
    assert 0 < kv_bytes_per_token(hyb) < kv_bytes_per_token(dense) * 10


def test_serving_workload_anchoring():
    cost = serving_cost("stablelm-1.6b")
    wl = cost.workload(32)
    assert wl.name == "serve:stablelm-1.6b"
    dmm = M.WORKLOADS["dmm"]
    assert wl.i_s * cost.decode_ai(32) \
        == pytest.approx(dmm.i_s * M.ARITH_INTENSITY["dmm"])
    with pytest.raises(ValueError):
        M.derived_workload("bad", 0.0)


# ------------------------------------------------------------------ queue

def _cost_stub(w_req=100.0, prompt=1, out=1, pkg=S):
    return pkg.ModelServingCost(
        config="stub", request=pkg.RequestShape(prompt, out),
        n_params=w_req, n_active=w_req / (2 * (prompt + out)),
        kv_bytes_tok=0.0)


QUEUE_CASES = {
    "conserves": (np.array([3, 0, 5, 1, 0, 0, 2, 0]), 150.0, np.ones(8), 4),
    "fast": (np.array([4, 4, 4, 4]), 500.0, np.ones(4), 8),
    "throttled": (np.array([4, 4, 4, 4]), 500.0, np.full(4, 0.5), 8),
    "overload": (np.full(4, 10), 100.0, np.ones(4), 8),
    "idle": (np.zeros(5, np.int64), 100.0, np.ones(5), 8),
}


@pytest.mark.parametrize("case", sorted(QUEUE_CASES))
def test_fluid_queue_matches_reference(case):
    arrivals, cap, throttle, max_batch = QUEUE_CASES[case]
    got = fluid_queue(arrivals, _cost_stub(), cap, throttle, 1.0, max_batch)
    want = J.fluid_queue(arrivals, _cost_stub(pkg=J), cap, throttle, 1.0,
                         max_batch)
    for field in ("served_flops", "busy", "batch", "backlog_flops",
                  "latency_s"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


def test_fluid_queue_conserves_work():
    cost = _cost_stub()
    arrivals = np.array([3, 0, 5, 1, 0, 0, 2, 0])
    q = fluid_queue(arrivals, cost, cap_flops_per_s=150.0,
                    throttle=np.ones(8), interval_s=1.0, max_batch=4)
    w = cost.request_flops
    np.testing.assert_allclose(q.served_flops.sum() + q.backlog_flops[-1],
                               arrivals.sum() * w)
    assert (q.busy >= 0).all() and (q.busy <= 1 + 1e-12).all()
    assert (q.batch >= 1).all() and (q.batch <= 4).all()
    assert q.latency_s.shape == (arrivals.sum(),)
    assert (q.latency_s > 0).all()


def test_fluid_queue_throttle_slows_service():
    cost = _cost_stub()
    arrivals = np.array([4, 4, 4, 4])
    fast = fluid_queue(arrivals, cost, 500.0, np.ones(4), 1.0, 8)
    slow = fluid_queue(arrivals, cost, 500.0, np.full(4, 0.5), 1.0, 8)
    assert slow.served_flops.sum() <= fast.served_flops.sum()
    assert np.percentile(slow.latency_s, 99) \
        > np.percentile(fast.latency_s, 99)


def test_fluid_queue_overload_latency_extrapolates():
    q = fluid_queue(np.full(4, 10), _cost_stub(), 100.0, np.ones(4), 1.0, 8)
    assert q.backlog_flops[-1] > 0
    assert np.isfinite(q.latency_s).all()
    assert q.latency_s.max() > 4.0


# ------------------------------------------------------- end-to-end smoke

def _counters(o):
    return {k: v for k, v in o.snapshot()["counters"].items()
            if k.startswith("serving/")}


@pytest.fixture(scope="module")
def smoke():
    """``test_serving.py``'s smoke scenario in both packages, at the
    scenario's 25 CG iterations and at TWIN_N_CG, with obs on."""
    out = {}
    for n_cg in (25, TWIN_N_CG):
        with jobs.scoped():
            jr = J.run_serving_cosim(J.ServingScenario(
                traffic=J.TrafficSpec(shape="diurnal", horizon_s=120.0),
                n_cg=n_cg, **SMOKE))
            jc = _counters(jobs)
        with tobs.scoped():
            tr = run_serving_cosim(ServingScenario(
                traffic=TrafficSpec(shape="diurnal", horizon_s=120.0),
                n_cg=n_cg, **SMOKE), device="cpu")
            tc = _counters(tobs)
        out[n_cg] = (jr, tr, jc, tc)
    return out


def test_smoke_host_values_match_reference(smoke):
    """Interval counts, the coarse plan, the resolved rate, the queue of
    the AP (never throttled, as in the reference) and the counters are the
    reference's exactly."""
    jr, tr, jc, tc = smoke[25]
    assert tc == jc and tc["serving/base_intervals"] == 240
    for m in ("ap", "simd"):
        g, w = tr[m], jr[m]
        assert (g.label, g.n_base, g.n_coarse, g.mean_qps) \
            == (w.label, w.n_base, w.n_coarse, w.mean_qps)
        np.testing.assert_array_equal(g.durations_s, w.durations_s)
        assert dataclasses.astuple(g.dp) == dataclasses.astuple(w.dp)
    ap, jap = tr["ap"], jr["ap"]
    assert (ap.stack.throttle == 1.0).all() and ap.throttle_residual == 0.0
    np.testing.assert_array_equal(ap.latency_s, jap.latency_s)
    np.testing.assert_array_equal(ap.queue.batch, jap.queue.batch)
    assert (ap.p50_s, ap.p99_s, ap.served_qps) \
        == (jap.p50_s, jap.p99_s, jap.served_qps)
    assert ap.time_above() == jap.time_above() == 0.0


def test_smoke_peaks_match_reference(smoke):
    """The AP's peaks at every interval within PEAK_TOL_C; the SIMD's
    maxima and verdict (ROADMAP Queue 3 item 11: the DTM ramp amplifies
    the 25-iteration CG's float32 differences at 227 °C, and one interval
    parts the time above 85 °C); the converged twins within TWIN_TOL_C at
    every interval with time above and slowdown equal."""
    jr, tr, _, _ = smoke[25]
    np.testing.assert_allclose(tr["ap"].stack.peak_C, jr["ap"].stack.peak_C,
                               rtol=0, atol=PEAK_TOL_C)
    g, w = tr["ap"].stack, jr["ap"].stack
    assert abs(g.logic_peak_C.max() - w.logic_peak_C.max()) <= PEAK_TOL_C
    assert abs(g.dram_peak_C.max() - w.dram_peak_C.max()) <= PEAK_TOL_C
    for m in ("ap", "simd"):
        assert tr[m].verdict_ok == jr[m].verdict_ok
        assert tr[m].error_bound_C == pytest.approx(jr[m].error_bound_C,
                                                    rel=1e-5)
    assert not tr["simd"].verdict_ok
    jt, tt, jc, tc = smoke[TWIN_N_CG]
    assert tc == jc
    for m in ("ap", "simd"):
        np.testing.assert_allclose(tt[m].stack.peak_C, jt[m].stack.peak_C,
                                   rtol=0, atol=TWIN_TOL_C)
        np.testing.assert_array_equal(tt[m].stack.throttle,
                                      jt[m].stack.throttle)
        assert tt[m].time_above() == jt[m].time_above()
        assert tt[m].dtm_slowdown == jt[m].dtm_slowdown
        assert tt[m].p99_s == jt[m].p99_s


def test_run_serving_cosim_smoke(smoke):
    """``test_serving.py``'s own assertions, on the port."""
    sc, reps = ServingScenario(config="stablelm-1.6b", traffic=TrafficSpec(
        shape="diurnal", horizon_s=120.0), load=0.6, grid_n=8, n_rounds=2,
        coarsen_tol=0.05, pad_quantum=16), smoke[25][1]
    assert set(reps) == {"ap", "simd"}
    for rep in reps.values():
        assert rep.n_base == 120
        assert rep.n_coarse <= rep.n_base
        assert float(rep.durations_s.sum()) == pytest.approx(120.0)
        assert rep.error_bound_C > 0
        assert 0.0 <= rep.throttle_residual <= 0.75 + 1e-9
        assert rep.stack.logic_peak_C.max() > 25.0
        assert rep.p99_s >= rep.p50_s > 0
    assert reps["ap"].throttle_residual < 0.05
    assert reps["ap"].stack.logic_peak_C.max() \
        <= reps["simd"].stack.logic_peak_C.max()
    table = verdict_table({sc.label: reps})
    assert table.count("\n") == 2
    assert "stablelm-1.6b,diurnal,ap," in table
    centers, qps, secs = reps["ap"].throttle_curve()
    assert secs.sum() == pytest.approx(120.0)
    assert (qps >= 0).all()


def test_verdict_table_and_curve_match_reference(smoke):
    """The AP rows of the verdict table, and its throughput curve, are
    the reference's."""
    jr, tr, _, _ = smoke[TWIN_N_CG]
    label = f"{SMOKE['config']}/diurnal"
    got = verdict_table({label: tr}).splitlines()
    want = J.verdict_table({label: jr}).splitlines()
    assert got[0] == want[0]
    assert got[1] == want[1]
    for g, w in zip(tr["ap"].throttle_curve(), jr["ap"].throttle_curve()):
        np.testing.assert_array_equal(g, w)


def test_scenario_validation():
    tr = TrafficSpec(horizon_s=60.0)
    with pytest.raises(ValueError):
        ServingScenario(config="x", traffic=tr, load=0.0)
    with pytest.raises(ValueError):
        ServingScenario(config="x", traffic=tr, n_rounds=0)
    with pytest.raises(ValueError):
        ServingScenario(config="x", traffic=tr, max_batch=0)
    with pytest.raises(ValueError):
        ServingScenario(config="x", traffic=tr, coarsen_tol=-1.0)
    with pytest.raises(ValueError, match="unknown machine"):
        run_serving_cosim(
            ServingScenario(config="stablelm-1.6b",
                            traffic=TrafficSpec(horizon_s=30.0)),
            machines=("tpu",), device="cpu")
    assert math.isfinite(ServingScenario(config="x", traffic=tr).load)


def test_uncoarsened_replay_matches_reference():
    """``coarsen=False`` replays every base interval (the plan of ones):
    the reference's host values, and peaks within PEAK_TOL_C, on the
    AP alone."""
    kw = dict(config="stablelm-1.6b", load=0.6, grid_n=8, n_rounds=1)
    got = run_serving_cosim(ServingScenario(
        traffic=TrafficSpec(shape="bursty", horizon_s=24.0), **kw),
        ("ap",), coarsen=False, device="cpu")["ap"]
    want = J.run_serving_cosim(J.ServingScenario(
        traffic=J.TrafficSpec(shape="bursty", horizon_s=24.0), **kw),
        ("ap",), coarsen=False)["ap"]
    assert got.n_coarse == want.n_coarse == 24
    assert got.error_bound_C == want.error_bound_C == 0.0
    np.testing.assert_array_equal(got.latency_s, want.latency_s)
    np.testing.assert_allclose(got.stack.peak_C, want.stack.peak_C,
                               rtol=0, atol=PEAK_TOL_C)


def test_reference_models_are_the_ports():
    """The machine model the cost anchors on is the reference's copy."""
    assert M.BYTES_PER_WORD == JM.BYTES_PER_WORD
    assert M.ap_flops_per_s(4096) == JM.ap_flops_per_s(4096)


def test_machines_replay_as_one_batch_bit_for_bit(smoke):
    """Each machine replayed alone gives its report in the batch of both
    bit for bit: the round's coarse plan is every machine's, and no
    per-case sum of the replay depends on the batch size."""
    _, both, _, _ = smoke[25]
    for m in ("ap", "simd"):
        alone = run_serving_cosim(ServingScenario(
            traffic=TrafficSpec(shape="diurnal", horizon_s=120.0), **SMOKE),
            (m,), device="cpu")[m]
        for name in ("peak_C", "min_C", "residual_C", "throttle",
                     "refresh_W", "leak_W", "dyn_W"):
            np.testing.assert_array_equal(getattr(alone.stack, name),
                                          getattr(both[m].stack, name))
        np.testing.assert_array_equal(alone.latency_s, both[m].latency_s)
        assert alone.error_bound_C == both[m].error_bound_C


#: ``tools/chip_reference.json``: the reference's values for
#: ``chip_smoke.py``, written by ``tools/chip_reference.py`` on the CPU
CHIP_REFERENCE = Path(__file__).resolve().parents[1] / "tools" \
    / "chip_reference.json"
#: the converged twin's slowdown and latency percentiles, relative: the
#: converged replays' duty traces agree, so these are the same queue
#: arithmetic
TWIN_RTOL = 1e-6


def test_deepseek_diurnal_simd_twin_matches_reference():
    """A quick-lane SIMD report's converged twin against the reference's.

    At the scenarios' 25 CG iterations ``bench_serving.py``'s
    deepseek-v2-lite-16b scenarios part the port's SIMD report from the
    reference's by 0.10-0.12 °C on the DRAM peak, and ``chip_smoke.py``
    phase 29 holds them to a recorded bound (ROADMAP Queue 3 item 11):
    the DTM ramp, at its floor at 217-273 °C, amplifies the unconverged
    CG's float32 differences.  At ``twin_n_cg`` = 120 iterations the
    diurnal one (the cheaper of the two) lands within TWIN_TOL_C of the
    reference's twin in ``tools/chip_reference.json``, with the same
    time above 85 °C and verdict.  Measured: 7.6e-5 °C on the logic
    peak, 3.1e-5 °C on the DRAM peak, the slowdown equal, p50 3e-8
    relative.  It replays 2 rounds of 384 coarse intervals at 120 CG
    iterations: about 180 s on one core."""
    ref = json.loads(CHIP_REFERENCE.read_text())["serving"]
    (i,) = [i for i, p in enumerate(ref["quick_params"])
            if (p["config"], p["shape"]) == ("deepseek-v2-lite-16b",
                                             "diurnal")]
    p, want = ref["quick_params"][i], ref["quick_twin"][i]["reports"]["simd"]
    kw = {k: v for k, v in p.items() if k not in ("shape", "horizon_s")}
    sc = ServingScenario(traffic=TrafficSpec(shape=p["shape"],
                                             horizon_s=p["horizon_s"]),
                         n_cg=ref["twin_n_cg"], **kw)
    got = run_serving_cosim(sc, ("simd",), device="cpu")["simd"]
    assert (got.mean_qps, got.n_base, got.n_coarse) \
        == (want["mean_qps"], want["n_base"], want["n_coarse"])
    assert hashlib.sha256(np.ascontiguousarray(
        got.durations_s, np.float64).tobytes()).hexdigest() \
        == want["durations_sha256"]
    assert abs(float(got.stack.logic_peak_C.max())
               - want["logic_peak_C"]) <= TWIN_TOL_C
    assert abs(float(got.stack.dram_peak_C.max())
               - want["dram_peak_C"]) <= TWIN_TOL_C
    assert got.time_above() == want["time_above"]
    assert bool(got.verdict_ok) is want["verdict_ok"] is False
    assert got.dtm_slowdown == pytest.approx(want["dtm_slowdown"],
                                             rel=TWIN_RTOL)
    assert got.p50_s == pytest.approx(want["p50_s"], rel=TWIN_RTOL)
    assert got.p99_s == pytest.approx(want["p99_s"], rel=TWIN_RTOL)
