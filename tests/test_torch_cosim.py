"""PyTorch port vs the JAX reference: the open-loop co-simulation
(``core/cosim.py``'s frame synthesis, implicit replay, batched driver and
reports) and the implicit transient steppers it stands on.

The semantics of the reference's ``tests/test_cosim.py``, each on the port
(its plain stencil on the CPU) and against the reference on the same
inputs.  Tolerances: frame synthesis and traces are NumPy in both
packages and held bit for bit; a replay sums its float32 CG in another
order on each side, so temperatures are held to 1e-3 °C where the CG has
converged (60 iterations) and to 2e-3 °C at the run_cosim sizes (25-40
iterations), and every verdict-bearing quantity (time above 85 °C,
crossing time) exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import cosim as jcosim
from repro.core import models as JM
from repro.core import thermal as jthermal
from repro_torch.core import cosim as tcosim
from repro_torch.core import models as TM
from repro_torch.core import thermal as tthermal

CONVERGED_ATOL_C = 1e-3
RUN_COSIM_ATOL_C = 2e-3


# ------------------------------------------------- implicit transient solver

def test_implicit_matches_explicit_oracle():
    """Peak within 0.1 C of the explicit (CFL-bound) oracle at >= 10x
    fewer time steps, on a 16x16 grid; and the reference's implicit
    answer within 1e-3 C."""
    rng = np.random.default_rng(0)
    grid = tthermal.Grid(die_w=5e-3, ny=16, nx=16)
    p = rng.uniform(0, 2e-3, size=(4, 16, 16)).astype(np.float32)
    t_end = 0.05
    n_exp = max(int(t_end / tthermal.explicit_dt(grid)), 1)
    T_e, _ = tthermal.transient_solve(p, grid, t_end, device="cpu")
    n_imp = max(n_exp // 20, 1)
    assert n_exp / n_imp >= 10
    T_i, peaks = tthermal.transient_solve_implicit(p, grid, t_end,
                                                   n_steps=n_imp,
                                                   device="cpu")
    assert abs(float(T_i.max()) - float(T_e.max())) < 0.1
    np.testing.assert_allclose(T_i.numpy(), T_e.numpy(), atol=0.1)
    assert peaks.shape == (n_imp,)
    jgrid = jthermal.Grid(die_w=5e-3, ny=16, nx=16)
    T_j, _ = jthermal.transient_solve_implicit(p, jgrid, t_end,
                                               n_steps=n_imp)
    np.testing.assert_allclose(T_i.numpy(), np.asarray(T_j), rtol=0,
                               atol=CONVERGED_ATOL_C)


def test_implicit_crank_nicolson_also_agrees():
    rng = np.random.default_rng(1)
    grid = tthermal.Grid(die_w=4e-3, ny=12, nx=12)
    p = rng.uniform(0, 1e-3, size=(4, 12, 12)).astype(np.float32)
    t_end = 0.02
    T_e, _ = tthermal.transient_solve(p, grid, t_end, device="cpu")
    n_imp = max(int(t_end / tthermal.explicit_dt(grid)) // 20, 1)
    T_i, _ = tthermal.transient_solve_implicit(p, grid, t_end,
                                               n_steps=n_imp, theta=0.5,
                                               device="cpu")
    np.testing.assert_allclose(T_i.numpy(), T_e.numpy(), atol=0.1)


def test_transient_implicit_fields_reaches_steady_state():
    """The fields-operator stepper on a margin grid lands on the steady
    solve, as the reference's does."""
    rng = np.random.default_rng(7)
    grid = tthermal.Grid(die_w=3e-3, ny=8, nx=8, margin=2)
    power = rng.uniform(0, 2e-3, size=(4, 8, 8)).astype(np.float32)
    p_dom = torch.nn.functional.pad(grid.pad_power(power, "cpu"),
                                    (2, 2, 2, 2))
    T0 = torch.full(p_dom.shape, tthermal.AMBIENT_C)
    T, peaks = tthermal.transient_implicit_fields(
        T0, p_dom, grid.fields("cpu"), grid.capacity_field("cpu"), dt=0.05,
        n_steps=60, n_cg=60)
    T_ss = tthermal.steady_state(power, grid, device="cpu").numpy()
    np.testing.assert_allclose(T.numpy()[:4, 2:10, 2:10], T_ss, atol=0.05)
    assert peaks.shape == (60,)
    assert float(peaks[0]) == pytest.approx(tthermal.AMBIENT_C)


def _constant_case():
    rng = np.random.default_rng(2)
    grid_n, margin = 8, 2
    pmap = rng.uniform(0, 5e-3, size=(grid_n, grid_n))
    grids = [pkg.Grid(die_w=3e-3, ny=grid_n, nx=grid_n, margin=margin)
             for pkg in (jthermal, tthermal)]
    frames = tcosim.power_frames(tcosim.PowerTrace(np.ones(12)), pmap,
                                 float(pmap.sum()) * 0.3, grids[1])
    return pmap, grids, frames


def test_constant_trace_replay_reaches_steady_state():
    """A constant-activity open-loop replay lands on the steady-state
    solution; each interval's peaks and mins are the reference's."""
    pmap, (jgrid, grid), frames = _constant_case()
    kw = dict(steps_per_interval=4, n_cg=60, margin=2, die_n=8)
    T_end, peaks, mins = tcosim.cosim_transient(
        torch.from_numpy(frames), grid.fields("cpu"),
        grid.capacity_field("cpu"), 2.0 / 12, **kw)
    power = np.broadcast_to(pmap, (4, 8, 8)).astype(np.float32)
    T_ss = tthermal.steady_state(power, grid, device="cpu").numpy()
    for l in range(4):
        assert abs(float(peaks[-1, l]) - T_ss[l].max()) < 0.05
        assert abs(float(mins[-1, l]) - T_ss[l].min()) < 0.05
    _, jpeaks, jmins = jcosim.cosim_transient(
        jnp.asarray(frames), jgrid.fields(), jgrid.capacity_field(),
        2.0 / 12, **kw)
    np.testing.assert_allclose(peaks.numpy(), np.asarray(jpeaks), rtol=0,
                               atol=CONVERGED_ATOL_C)
    np.testing.assert_allclose(mins.numpy(), np.asarray(jmins), rtol=0,
                               atol=CONVERGED_ATOL_C)
    assert T_end.shape == frames.shape[1:]


def test_batch_is_a_batch_of_single_replays():
    """cosim_transient_batch is one batched replay whose every case is
    the single replay of that case."""
    rng = np.random.default_rng(3)
    grid = tthermal.Grid(die_w=3e-3, ny=8, nx=8, margin=2)
    F, cap = grid.fields("cpu"), grid.capacity_field("cpu")
    frames = []
    for b in range(3):
        pmap = rng.uniform(0, 5e-3, size=(8, 8))
        act = rng.uniform(0.5, 1.5, 5)
        frames.append(tcosim.power_frames(
            tcosim.PowerTrace(act / act.mean()), pmap, 0.0, grid))
    frames = torch.from_numpy(np.stack(frames))
    kw = dict(steps_per_interval=2, n_cg=20, margin=2, die_n=8)
    batch = tcosim.cosim_transient_batch(
        frames, {k: v.expand(3, *v.shape) for k, v in F.items()},
        cap.expand(3, *cap.shape), 0.02, **kw)
    for b in range(3):
        one = tcosim.cosim_transient(frames[b], F, cap, 0.02, **kw)
        for x, y in zip(one, batch):
            torch.testing.assert_close(x, y[b], rtol=1e-6, atol=1e-5)


# ------------------------------------------------------------- power traces

def test_engine_trace_conserves_energy():
    from repro_torch.core.engine import APEngine
    eng = APEngine(n_words=64, n_bits=16, device="cpu")
    eng.bwrite([0, 1], [1, 0])
    eng.compare([0], [1])
    eng.write([1, 2, 3], [1, 1, 0])
    _, bins = eng.power_trace(8)
    assert bins.sum() == pytest.approx(eng.energy)


def test_workload_trace_bins_sum_to_engine_energy():
    """Binned trace == engine energy for a real pass-schedule workload,
    and the activity profile is the reference's bit for bit."""
    from repro.workloads import dmm as jdmm
    from repro_torch.workloads import dmm as tdmm
    rng = np.random.default_rng(3)
    A = rng.integers(0, 16, (4, 4), dtype=np.uint64)
    B = rng.integers(0, 16, (4, 4), dtype=np.uint64)
    _, ctr = tdmm.ap_matmul(A, B, m=4, device="cpu")
    assert ctr["trace_energy"].sum() == pytest.approx(ctr["energy"])
    assert int(ctr["trace_cycles"].max()) <= ctr["cycles"]
    tr = tcosim.trace_from_counters(ctr, 16)
    assert tr.activity.shape == (16,)
    assert tr.activity.mean() == pytest.approx(1.0)
    assert (tr.activity >= 0).all()
    _, jctr = jdmm.ap_matmul(A, B, m=4)
    np.testing.assert_array_equal(
        tr.activity, jcosim.trace_from_counters(jctr, 16).activity)


def test_simd_phase_trace_mean_one():
    dp = tcosim.comparable_design_point("dmm")
    tr = tcosim.simd_phase_trace(TM.WORKLOADS["dmm"], dp, 32)
    assert tr.activity.mean() == pytest.approx(1.0)
    assert tr.activity.std() > 0
    jdp = jcosim.comparable_design_point("dmm")
    np.testing.assert_array_equal(
        tr.activity,
        jcosim.simd_phase_trace(JM.WORKLOADS["dmm"], jdp, 32).activity)


def test_power_frames_conserve_power():
    """mean-over-time of each frame's total == n_si x layer power; the
    frames are the reference's bit for bit."""
    grid_n, margin = 8, 2
    grid = tthermal.Grid(die_w=2e-3, ny=grid_n, nx=grid_n, margin=margin)
    rng = np.random.default_rng(4)
    pmap = rng.uniform(0, 1e-2, size=(grid_n, grid_n))
    act = rng.uniform(0.2, 2.0, 10)
    trace = tcosim.PowerTrace(act / act.mean())
    frames = tcosim.power_frames(trace, pmap, float(pmap.sum()) * 0.4, grid)
    n_si = grid.params.n_si_layers
    assert frames.shape == (10, grid.params.n_layers, grid.dom_ny,
                            grid.dom_nx)
    mean_total = frames.sum(axis=(1, 2, 3)).mean()
    assert mean_total == pytest.approx(n_si * pmap.sum(), rel=1e-5)
    assert frames[:, -1].sum() == 0.0
    jgrid = jthermal.Grid(die_w=2e-3, ny=grid_n, nx=grid_n, margin=margin)
    np.testing.assert_array_equal(frames, jcosim.power_frames(
        jcosim.PowerTrace(act / act.mean()), pmap, float(pmap.sum()) * 0.4,
        jgrid))


# --------------------------------------------------------- batched driver

@pytest.fixture(scope="module")
def dmm_cosim():
    kw = dict(workloads=("dmm",), grid_n=8, n_intervals=8, t_end=0.1,
              steps_per_interval=1, n_cg=25)
    return jcosim.run_cosim(**kw), tcosim.run_cosim(device="cpu", **kw)


def test_vmapped_cosim_shapes_and_dtypes(dmm_cosim):
    ref, res = dmm_cosim
    for machine in ("ap", "simd"):
        r = res["dmm"][machine]
        assert r.peak_C.shape == (8, 4)
        assert r.min_C.shape == (8, 4)
        assert r.peak_C.dtype == np.float32
        assert np.isfinite(r.peak_C).all() and np.isfinite(r.min_C).all()
        assert (r.peak_C >= r.min_C - 1e-4).all()
        assert (r.min_C > 0).all()
    # AP runs cooler than the same-performance SIMD throughout (Fig 10/12)
    assert res["dmm"]["ap"].peak_C.max() < res["dmm"]["simd"].peak_C.max()
    assert res["interval_s"] == ref["interval_s"]
    assert res["design_points"]["dmm"].__dict__ \
        == ref["design_points"]["dmm"].__dict__


def test_run_cosim_matches_reference(dmm_cosim):
    ref, res = dmm_cosim
    for machine in ("ap", "simd"):
        r, g = ref["dmm"][machine], res["dmm"][machine]
        np.testing.assert_allclose(g.peak_C, r.peak_C, rtol=0,
                                   atol=RUN_COSIM_ATOL_C)
        np.testing.assert_allclose(g.min_C, r.min_C, rtol=0,
                                   atol=RUN_COSIM_ATOL_C)
        for limit in (50.0, 85.0):
            np.testing.assert_array_equal(g.time_above(limit),
                                          r.time_above(limit))
            np.testing.assert_array_equal(g.crossing_time(limit),
                                          r.crossing_time(limit))


def test_cosim_pallas_route_matches_jnp():
    """``use_pallas`` is accepted and ignored (the tensor's device picks
    the stencil): the same replay bit for bit, and the reference's
    Pallas-route answer within its own test's tolerance."""
    rng = np.random.default_rng(5)
    grid_n, margin = 8, 2
    grid = tthermal.Grid(die_w=3e-3, ny=grid_n, nx=grid_n, margin=margin)
    pmap = rng.uniform(0, 5e-3, size=(grid_n, grid_n))
    act = rng.uniform(0.5, 1.5, 6)
    frames = tcosim.power_frames(tcosim.PowerTrace(act / act.mean()), pmap,
                                 0.0, grid)
    args = (torch.from_numpy(frames), grid.fields("cpu"),
            grid.capacity_field("cpu"), 0.02)
    kw = dict(steps_per_interval=2, n_cg=30, margin=margin, die_n=grid_n)
    _, pk, mn = tcosim.cosim_transient(*args, **kw)
    _, pk_p, mn_p = tcosim.cosim_transient(*args, **kw, use_pallas=True)
    assert torch.equal(pk, pk_p) and torch.equal(mn, mn_p)
    jgrid = jthermal.Grid(die_w=3e-3, ny=grid_n, nx=grid_n, margin=margin)
    _, pk_j, mn_j = jcosim.cosim_transient(
        jnp.asarray(frames), jgrid.fields(), jgrid.capacity_field(), 0.02,
        **kw, use_pallas=True)
    np.testing.assert_allclose(pk.numpy(), np.asarray(pk_j), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(mn.numpy(), np.asarray(mn_j), rtol=1e-5,
                               atol=1e-3)


# ---------------------------------------------------------------- reports

def test_report_time_above_and_crossing():
    peak = np.array([[50.0, 50.0], [90.0, 60.0], [100.0, 84.9],
                     [80.0, 86.0]], np.float32)
    r = tcosim.CosimReport(label="t", interval_s=0.5, peak_C=peak,
                           min_C=peak - 10.0)
    np.testing.assert_allclose(r.time_above(85.0), [1.0, 0.5])
    np.testing.assert_allclose(r.crossing_time(85.0), [1.0, 2.0])
    np.testing.assert_allclose(r.span_C, 10.0)
    np.testing.assert_array_equal(r.final_peak_C, peak[-1])
    never = tcosim.CosimReport(label="n", interval_s=0.5,
                               peak_C=peak * 0 + 50.0,
                               min_C=peak * 0 + 49.0)
    assert np.isinf(never.crossing_time(85.0)).all()
    assert never.time_above(85.0).max() == 0.0
    jr = jcosim.CosimReport(label="t", interval_s=0.5, peak_C=peak,
                            min_C=peak - 10.0)
    np.testing.assert_array_equal(r.times, jr.times)
    np.testing.assert_array_equal(r.crossing_time(), jr.crossing_time())
