"""PyTorch port vs the JAX reference: the observability layer.

``repro_torch.obs`` is a copy of ``repro.obs`` (standard library only):
the same registry math, spans, strict no-op disabled mode and Chrome
trace-event export, switched on by the same ``REPRO_OBS=1``.  The same
call sequence must give the same snapshot in both packages' registries.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import obs as jobs
from repro_torch import obs
from repro_torch.obs.registry import Histogram, Registry, percentile
from repro_torch.obs.trace import Tracer

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_obs():
    """Each test sees fresh, disabled obs state in both packages."""
    prev = (obs.is_enabled(), jobs.is_enabled())
    for m in (obs, jobs):
        m.disable()
        m.reset()
    yield
    for m, was in zip((obs, jobs), prev):
        m.reset()
        (m.enable if was else m.disable)()


def _drive(m, rng_seed: int = 0):
    """One fixed sequence of metric calls, with values from a seeded
    generator, on the obs module ``m``."""
    rng = np.random.default_rng(rng_seed)
    with m.scoped():
        for i in range(5):
            m.count("sweep/cases", int(rng.integers(1, 9)))
            m.count(f"policy/dvfs-22nm/residency/op{i % 3}")
        m.gauge("feedback/residual_C", float(rng.random()))
        m.observe("feedback/throttle_duty", float(rng.random()))
        m.observe_many("feedback/picard_residual_C", rng.random(257))
    return m.snapshot()


def test_same_calls_give_the_same_snapshot():
    got, want = _drive(obs), _drive(jobs)
    assert got == want
    assert obs.values_by_prefix("policy/dvfs-22nm/") \
        == jobs.values_by_prefix("policy/dvfs-22nm/")
    assert got["counters"]["policy/dvfs-22nm/residency/op0"] == 2


# ------------------------------------------------------------- disabled

@pytest.mark.parametrize("m", [obs, jobs], ids=["port", "reference"])
def test_disabled_mode_is_strict_noop(m):
    m.count("x")
    m.gauge("g", 3.0)
    m.observe("h", 1.0)
    m.observe_many("h", [2.0, 3.0])
    with m.span("s", k=1):
        pass
    assert m.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert m.trace_events()["traceEvents"] == []
    assert m.value("x") == 0


def test_disabled_span_is_shared_null_singleton():
    a, b = obs.span("a"), obs.span("b", attr=1)
    assert a is b                   # no per-call allocation when off


def test_scoped_restores_prior_state():
    assert not obs.is_enabled()
    with obs.scoped():
        assert obs.is_enabled()
        with obs.scoped(on=False):
            assert not obs.is_enabled()
        assert obs.is_enabled()
    assert not obs.is_enabled()


@pytest.mark.parametrize("env,on", [("1", True), ("on", True), ("", False),
                                    ("0", False)])
def test_same_switch_as_the_reference(env, on):
    """``REPRO_OBS`` enables both packages at import, with the same
    spellings."""
    code = ("from repro import obs as j; from repro_torch import obs as t; "
            "print(j.is_enabled(), t.is_enabled())")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_OBS=env,
                 JAX_PLATFORMS="cpu"), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [str(on), str(on)]


# -------------------------------------------------------------- metrics

def test_counter_gauge_roundtrip():
    with obs.scoped():
        obs.count("c")
        obs.count("c", 4)
        obs.gauge("g", 2.0)
        obs.gauge("g", 7.5)         # last write wins
    snap = obs.snapshot()
    assert snap["counters"]["c"] == 5
    assert snap["gauges"]["g"] == 7.5
    assert obs.value("c") == 5      # readable even while disabled


def test_histogram_percentiles_match_numpy():
    vals = np.random.default_rng(0).exponential(size=501)
    h = Histogram()
    h.extend(vals)
    s = h.summary()
    assert s["count"] == 501
    np.testing.assert_allclose(s["p50"], np.percentile(vals, 50))
    np.testing.assert_allclose(s["p95"], np.percentile(vals, 95))
    np.testing.assert_allclose(s["p99"], np.percentile(vals, 99))
    np.testing.assert_allclose(s["mean"], vals.mean())
    assert s["min"] == vals.min() and s["max"] == vals.max()


def test_percentile_edge_cases():
    assert np.isnan(percentile([], 50))
    assert percentile([4.0], 99) == 4.0
    assert percentile([1.0, 2.0], 50) == 1.5
    assert Histogram().summary() == {"count": 0}


def test_registry_snapshot_is_json_serializable_and_sorted():
    r = Registry()
    r.counter("b").inc()
    r.counter("a").inc(2)
    r.histogram("h").observe(1.0)
    snap = json.loads(json.dumps(r.snapshot()))
    assert list(snap["counters"]) == ["a", "b"]
    assert snap["histograms"]["h"]["count"] == 1


# ---------------------------------------------------------------- spans

def test_nested_span_parent_child_ordering():
    tr = Tracer()
    with tr.span("outer", case="x"):
        with tr.span("inner"):
            pass
    by_name = {e["name"]: e for e in tr.trace_object()["traceEvents"]}
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer["args"]["depth"] == 0 and inner["args"]["depth"] == 1
    assert inner["tid"] == outer["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert outer["args"]["case"] == "x"


def test_span_durations_feed_histograms_and_survive_exceptions():
    with obs.scoped():
        with obs.span("work"):
            pass
        with pytest.raises(RuntimeError):
            with obs.span("work"):
                raise RuntimeError
        with obs.span("after"):
            pass
    assert obs.snapshot()["histograms"]["span/work"]["count"] == 2
    after = [e for e in obs.trace_events()["traceEvents"]
             if e["name"] == "after"]
    assert after[0]["args"]["depth"] == 0


def test_chrome_trace_event_json_validity(tmp_path):
    with obs.scoped():
        with obs.span("phase", n=3, label="a b", dev=object()):
            with obs.span("leaf"):
                pass
    path = tmp_path / "trace.json"
    obs.write_trace(str(path))
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    events = doc["traceEvents"]
    assert len(events) == 2
    for ev in events:
        assert ev["ph"] == "X" and ev["cat"] == "obs"
        assert isinstance(ev["ts"], float) and isinstance(ev["dur"], float)
        assert ev["ts"] >= 0 and ev["dur"] >= 0
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
    phase = next(e for e in events if e["name"] == "phase")
    assert phase["args"]["n"] == 3 and phase["args"]["label"] == "a b"
    assert isinstance(phase["args"]["dev"], str)    # coerced at record


def test_reset_restarts_trace_clock():
    with obs.scoped():
        with obs.span("one"):
            pass
        obs.reset()
        with obs.span("two"):
            pass
        events = obs.trace_events()["traceEvents"]
    assert [e["name"] for e in events] == ["two"]


def test_replay_telemetry_matches_reference():
    """The replay's ``feedback/*`` and ``policy/<name>/*`` metrics: the
    same names and counts as the reference's for the same residuals and
    duties (DVFS, whose residency attributes operating points)."""
    from repro.policy import DVFSPolicy as JDVFS
    from repro_torch.policy import DVFSPolicy
    from repro_torch.stack import feedback as tfb
    rng = np.random.default_rng(3)
    perf = np.asarray(DVFSPolicy().table.perf_scales(), np.float32)
    thr = perf[rng.integers(0, len(perf), (3, 8))]
    res = rng.random((3, 8)).astype(np.float32) * 1e-3
    with obs.scoped():
        tfb._replay_telemetry(tfb.FeedbackParams(policy=DVFSPolicy()),
                              res, thr)
    snap = obs.snapshot()
    assert snap["counters"]["feedback/intervals"] == 24
    assert snap["counters"]["feedback/picard_iterations"] == 24 * 6
    assert snap["counters"]["feedback/throttled_intervals"] \
        == int((thr < 1.0).sum())
    residency = obs.values_by_prefix("policy/dvfs-22nm/residency/")
    want = JDVFS().residency(thr.astype(np.float64))
    assert residency == {f"policy/dvfs-22nm/residency/{k}": v
                         for k, v in want.items()}
    assert snap["histograms"]["policy/dvfs-22nm/duty"]["count"] == 24


# ------------------------------------------------- the solvers' counters

def _solver_counters(m):
    return {k: v for k, v in m.snapshot()["counters"].items()
            if k.startswith(("thermal/", "mg/", "kernels/"))
            and "/retrace/" not in k}


def test_steady_solve_counters_match_reference():
    """``thermal/steady`` (span, solves, iterations and residual
    observations) and ``mg/hierarchies_built``: the same names and counts
    as the reference's for the same steady solves.  The reference counts
    a hierarchy once a trace of its jitted driver, the port once a
    build; a steady mg solve builds one in both.  The reference's jit
    caches are cleared first, so its drivers trace inside this test
    whatever ran before it in the process."""
    import jax
    from repro.core import thermal as jth
    from repro_torch.core import thermal as tth
    jax.clear_caches()
    n = 16
    for pkg, kw, m in ((jth, {}, jobs), (tth, {"device": "cpu"}, obs)):
        grid = pkg.Grid(die_w=3e-3, ny=n, nx=n, margin=4)
        p = np.zeros((grid.n_die_layers, n, n), np.float32)
        p[0, 4:12, 4:12] = 0.05
        with m.scoped():
            for s in ("pcg", "mg"):
                pkg.steady_state_stats(p, grid, solver=s, **kw)
    got, want = _solver_counters(obs), _solver_counters(jobs)
    assert got == want
    assert got["thermal/steady/solves"] == 2
    assert got["mg/hierarchies_built"] >= 1
    for name in ("span/thermal/steady", "thermal/steady/iterations[pcg]",
                 "thermal/steady/iterations[mg]",
                 "thermal/steady/rel_residual"):
        assert obs.snapshot()["histograms"][name]["count"] \
            == jobs.snapshot()["histograms"][name]["count"], name


@pytest.mark.parametrize("solver", ["pcg", "mg"])
def test_transient_counters_and_residuals_match_reference(solver):
    """``thermal/transient``: solves, steps and inner iterations equal,
    and one residual observation a step, each small, as the reference's
    ``with_residuals`` path records them; with obs off the return is the
    same 2-tuple bit for bit."""
    from repro.core import thermal as jth
    from repro_torch.core import thermal as tth
    n, steps = 8, 5
    out = {}
    for pkg, kw, m in ((jth, {}, jobs), (tth, {"device": "cpu"}, obs)):
        grid = pkg.Grid(die_w=3e-3, ny=n, nx=n)
        p = np.full((grid.n_die_layers, n, n), 1e-3, np.float32)
        with m.scoped():
            out[m] = pkg.transient_solve_implicit(p, grid, 0.02, steps,
                                                  solver=solver, n_cg=20,
                                                  **kw)
    got = obs.snapshot()
    want = jobs.snapshot()
    for name in ("thermal/transient/solves", "thermal/transient/steps",
                 "thermal/transient/inner_iterations"):
        assert got["counters"][name] == want["counters"][name], name
    h, jh = (s["histograms"]["thermal/transient/step_rel_residual"]
             for s in (got, want))
    assert h["count"] == jh["count"] == steps
    assert h["max"] <= max(10 * jh["max"], 1e-5)
    from repro_torch.core import thermal as tth
    grid = tth.Grid(die_w=3e-3, ny=n, nx=n)
    p = np.full((grid.n_die_layers, n, n), 1e-3, np.float32)
    off = tth.transient_solve_implicit(p, grid, 0.02, steps, solver=solver,
                                       n_cg=20, device="cpu")
    assert len(off) == 2
    for x, y in zip(off, out[obs]):
        assert (x == y).all()


@pytest.mark.parametrize("w", ["hist", "spmv", "sort"])
def test_megakernel_launch_counters_match_reference(w):
    """``kernels/launch/ap_megakernel*`` of a megakernel-mode capture.
    hist and spmv (probe batches) count as the reference does; sort's
    min-extraction counts ``/min_extract_rounds`` as the reference does,
    and ``kernels/launch/ap_megakernel`` once a launch of a round, where
    the reference's rounds are one compiled program (the module note of
    ``repro_torch.workloads._device``)."""
    from repro.workloads import registry as jreg
    from repro_torch.workloads import registry as treg
    with jobs.scoped():
        jreg.trace_counters(w, 64, mode="megakernel")
    with obs.scoped():
        treg.trace_counters(w, 64, mode="megakernel", device="cpu")
    got = obs.values_by_prefix("kernels/launch/")
    want = jobs.values_by_prefix("kernels/launch/")
    if w == "sort":
        key = "kernels/launch/ap_megakernel/min_extract_rounds"
        assert got[key] == want[key] >= 1
        assert got["kernels/launch/ap_megakernel"] \
            >= want["kernels/launch/ap_megakernel"]
    else:
        assert got == want
        assert got["kernels/launch/ap_megakernel"] >= 1
