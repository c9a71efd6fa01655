"""PyTorch port vs the JAX reference: interval coarsening and the
variable-step (``dt_scale``) replay.

The semantics of the reference's ``tests/test_coarsen_replay.py`` on the
port, with the reference run on the same inputs.  ``coarsen_plan`` and
``CoarsePlan`` are NumPy in both packages and held equal; the stack power
frames bit for bit.  The coarsened replay's peak error stays within the
advertised ``tol x dc_peak_rise_C`` (open loop: a theorem; closed loop:
within twice it, as the reference states).  A ``dt_scale`` of ones must
reproduce the fixed-step replay bit for bit (the port forms a step of
scale 1 exactly as the fixed replay does).  Replays are held to the
reference's within 0.02 °C: float32 CG of 25 iterations summed in
another order, below the 0.05 °C Picard bar.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.core import cosim as jcosim
from repro.core import thermal as jthermal
from repro.core.floorplan import APFloorplan as JAPFloorplan
from repro.stack import dram as jdram
from repro.stack import feedback as jfb
from repro.stack.spec import dram_on_logic as j_dram_on_logic
from repro_torch.core import cosim as tcosim
from repro_torch.core import thermal as tthermal
from repro_torch.core.floorplan import MM, APFloorplan
from repro_torch.stack import dram as tdram
from repro_torch.stack import feedback as tfb
from repro_torch.stack.spec import PAPER_SPEC, PAPER_STACK, dram_on_logic

GRID_N, MARGIN, T_BASE, T_COARSE = 8, 2, 48, 12
DT = 0.05
REPLAY_ATOL_C = 0.02


def _activity(seed: int, tol: float) -> np.ndarray:
    """Piecewise plateaus + sub-tolerance jitter: mergeable by design,
    with genuine level changes the plan must NOT merge across."""
    rng = np.random.default_rng(seed)
    act = np.repeat(rng.uniform(0.1, 1.0, 6), T_BASE // 6)
    act = act + rng.uniform(-0.3, 0.3, T_BASE) * tol
    return np.clip(act, 0.0, 1.2)


def _case(spec):
    dp = tcosim.comparable_design_point("dmm")
    fp = APFloorplan(die_w_mm=math.sqrt(dp.ap_area_mm2))
    grid = tthermal.Grid(die_w=fp.die_w_mm * MM, ny=GRID_N, nx=GRID_N,
                         params=PAPER_STACK, spec=spec, margin=MARGIN)
    dfp = tdram.DRAMFloorplan(die_w_mm=fp.die_w_mm)
    pmap = fp.power_map(GRID_N, dp.ap_power_W)
    build = lambda a, traffic=1e10: tfb.stack_power_frames(
        spec, grid, a, pmap, fp.leakage_W(), dfp, traffic)
    return grid, build


def _replay(spec, grid, frames, fb, *, steps, dt_scale=None, n_cg=25):
    dyn, l0, r0, lm = (torch.from_numpy(np.asarray(x, np.float32))
                       for x in frames)
    return tfb.closed_loop_replay(
        dyn, l0, r0, lm, grid.fields("cpu"), grid.capacity_field("cpu"), DT,
        fb=fb, die_n=GRID_N, n_die=spec.n_die_layers,
        steps_per_interval=steps, n_cg=n_cg, margin=MARGIN,
        dt_scale=dt_scale)


def _coarse_vs_exact(spec, act, tol, fb):
    grid, build = _case(spec)
    exact = _replay(spec, grid, build(act), fb, steps=1)
    plan = tcosim.coarsen_plan(act, tol, max_merge=8).pad_to(T_COARSE)
    coarse = _replay(spec, grid, build(plan.merge(act)), fb, steps=4,
                     dt_scale=plan.dt_scale())
    frames = build(act)[0]
    bound = tol * tcosim.dc_peak_rise_C(frames.max(axis=0),
                                        grid.fields("cpu"))
    err = abs(float(exact[1].max()) - float(coarse[1].max()))
    return err, bound, plan, exact, coarse


@pytest.mark.parametrize("spec", [PAPER_SPEC, dram_on_logic(2)],
                         ids=["paper", "dram2"])
@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 1 << 16),
       tol=st.sampled_from((0.05, 0.1, 0.2)))
def test_coarsened_peak_error_within_advertised_bound(spec, seed, tol):
    err, bound, plan, _, _ = _coarse_vs_exact(
        spec, _activity(seed, tol), tol, tfb.FeedbackParams.disabled())
    assert plan.n_base == T_BASE and plan.n_coarse == T_COARSE
    assert err <= bound, (err, bound)


def test_closed_loop_coarsening_stays_small():
    """With DTM/refresh/leakage active the DC bound is not a theorem, but
    the error stays within twice it; both replays are the reference's."""
    tol = 0.1
    act = _activity(7, tol)
    err, bound, plan, exact, coarse = _coarse_vs_exact(
        dram_on_logic(2), act, tol, tfb.FeedbackParams())
    assert err <= 2.0 * bound, (err, bound)

    # the reference's replays of the same inputs
    spec = j_dram_on_logic(2)
    dp = jcosim.comparable_design_point("dmm")
    fp = JAPFloorplan(die_w_mm=math.sqrt(dp.ap_area_mm2))
    grid = jthermal.Grid(die_w=fp.die_w_mm * MM, ny=GRID_N, nx=GRID_N,
                         spec=spec, margin=MARGIN)
    dfp = jdram.DRAMFloorplan(die_w_mm=fp.die_w_mm)
    pmap = fp.power_map(GRID_N, dp.ap_power_W)
    build = lambda a: jfb.stack_power_frames(spec, grid, a, pmap,
                                             fp.leakage_W(), dfp, 1e10)
    jplan = jcosim.coarsen_plan(act, tol, max_merge=8).pad_to(T_COARSE)
    np.testing.assert_array_equal(plan.reps, jplan.reps)

    def jreplay(frames, steps, dt_scale=None):
        dyn, l0, r0, lm = (jnp.asarray(x) for x in frames)
        return jfb.closed_loop_replay(
            dyn, l0, r0, lm, grid.fields(), grid.capacity_field(), DT,
            fb=jfb.FeedbackParams(), die_n=GRID_N, n_die=spec.n_die_layers,
            steps_per_interval=steps, n_cg=25, margin=MARGIN,
            dt_scale=dt_scale)
    jexact = jreplay(build(act), 1)
    jcoarse = jreplay(build(jplan.merge(act)), 4, jplan.dt_scale())
    for got, want in ((exact, jexact), (coarse, jcoarse)):
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=REPLAY_ATOL_C)
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def test_plan_invariants_and_padding():
    act = _activity(3, 0.1)
    plan = tcosim.coarsen_plan(act, 0.1, max_merge=8)
    assert plan.n_base == T_BASE
    assert (plan.reps >= 1).all() and (plan.reps <= 8).all()
    edges = np.concatenate([[0], np.cumsum(plan.reps)])
    for i in range(plan.n_coarse):
        seg = act[edges[i]:edges[i + 1]]
        assert seg.max() - seg.min() <= 0.1 + 1e-12
    merged = plan.merge(act)
    np.testing.assert_allclose(merged @ plan.reps / plan.n_base,
                               act.mean(), rtol=1e-12)
    np.testing.assert_array_equal(plan.merge(plan.expand(merged)), merged)
    padded = plan.pad_to(T_BASE)
    assert padded.n_coarse == T_BASE and (padded.reps == 1).all()
    with pytest.raises(ValueError):
        tcosim.coarsen_plan(act, -0.1)
    with pytest.raises(ValueError):
        tcosim.CoarsePlan(np.array([0, 3]))
    # the reference's plan, merge, expand and padding, on [T] and [T, K]
    rng = np.random.default_rng(0)
    for sig in (act, np.stack([act, rng.permutation(act)], axis=1)):
        for tol, mm, pad in ((0.1, 8, 12), (0.05, 3, 30), (0.3, 64, 5)):
            a = tcosim.coarsen_plan(sig, tol, mm)
            b = jcosim.coarsen_plan(sig, tol, mm)
            np.testing.assert_array_equal(a.reps, b.reps)
            np.testing.assert_array_equal(a.pad_to(pad).reps,
                                          b.pad_to(pad).reps)
            np.testing.assert_array_equal(a.merge(sig), b.merge(sig))
            np.testing.assert_array_equal(a.dt_scale(), b.dt_scale())
            assert a.ratio == b.ratio


def test_variable_dt_matches_fixed_dt_at_unit_scale():
    """dt_scale=ones must reproduce the fixed-step replay bitwise, at one
    and at several steps an interval; the stack power frames are the
    reference's bit for bit."""
    spec = dram_on_logic(2)
    act = _activity(1, 0.1)
    grid, build = _case(spec)
    fb = tfb.FeedbackParams()
    for steps in (1, 3):
        a = _replay(spec, grid, build(act), fb, steps=steps, n_cg=10)
        b = _replay(spec, grid, build(act), fb, steps=steps, n_cg=10,
                    dt_scale=np.ones(T_BASE, np.float32))
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    jspec = j_dram_on_logic(2)
    dp = jcosim.comparable_design_point("dmm")
    fp = JAPFloorplan(die_w_mm=math.sqrt(dp.ap_area_mm2))
    jgrid = jthermal.Grid(die_w=fp.die_w_mm * MM, ny=GRID_N, nx=GRID_N,
                          spec=jspec, margin=MARGIN)
    jdfp = jdram.DRAMFloorplan(die_w_mm=fp.die_w_mm)
    pmap = fp.power_map(GRID_N, dp.ap_power_W)
    traffic = np.linspace(1e9, 3e10, T_BASE)
    for tr in (1e10, traffic):
        want = jfb.stack_power_frames(jspec, jgrid, act, pmap,
                                      fp.leakage_W(), jdfp, tr)
        got = build(act, tr)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, np.asarray(y))


def test_variable_dt_rejects_multigrid():
    spec = dram_on_logic(2)
    act = _activity(1, 0.1)
    grid, build = _case(spec)
    with pytest.raises(ValueError, match="solver='pcg'"):
        dyn, l0, r0, lm = (torch.from_numpy(np.asarray(x, np.float32))
                           for x in build(act))
        tfb.closed_loop_replay(
            dyn, l0, r0, lm, grid.fields("cpu"), grid.capacity_field("cpu"),
            DT, fb=tfb.FeedbackParams(), die_n=GRID_N,
            n_die=spec.n_die_layers, steps_per_interval=1, n_cg=10,
            margin=MARGIN, solver="mg", dt_scale=np.ones(T_BASE))
    with pytest.raises(ValueError, match="solver='pcg'"):
        jdyn, jl0, jr0, jlm = (jnp.asarray(x) for x in build(act))
        jspec = j_dram_on_logic(2)
        jgrid = jthermal.Grid(die_w=grid.die_w, ny=GRID_N, nx=GRID_N,
                              spec=jspec, margin=MARGIN)
        jfb.closed_loop_replay(
            jdyn, jl0, jr0, jlm, jgrid.fields(), jgrid.capacity_field(),
            DT, fb=jfb.FeedbackParams(), die_n=GRID_N,
            n_die=jspec.n_die_layers, steps_per_interval=1, n_cg=10,
            margin=MARGIN, solver="mg", dt_scale=jnp.ones(T_BASE))
