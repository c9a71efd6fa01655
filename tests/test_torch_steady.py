"""PyTorch port vs the JAX reference: the steady-state solves, the solver
fallback chain, the legacy uniform-per-layer stencil and transients, and
the paper's §4 AP-vs-SIMD comparison.

Both packages solve the same grids and power maps (numpy inputs); the
port runs on the CPU with its plain kernels, the reference's Pallas
stencil in interpret mode.  Tolerances:

- stencils: rtol 1e-5 (float32; XLA may contract a multiply-add);
- steady and transient temperatures: 1e-3 °C (float32 solves to a
  tolerance, or a fixed number of iterations, summed in another order);
- the §4 layer peaks: 0.01 °C;
- iteration counts of the tolerance solves: within 2 (the float32
  residual floor decides the last one).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import floorplan as jfloorplan
from repro.core import thermal as jthermal
from repro.faults.inject import poison_solver as j_poison
from repro.kernels.thermal_stencil import ops as jops
from repro.stack.spec import PAPER_SPEC as J_PAPER_SPEC
from repro.stack.spec import dram_on_logic as j_dram_on_logic
from repro_torch import interop
from repro_torch.core import floorplan as tfloorplan
from repro_torch.core import thermal as tthermal
from repro_torch.faults.inject import poison_solver as t_poison
from repro_torch.kernels.thermal_stencil import ops as tops
from repro_torch.stack.spec import PAPER_SPEC as T_PAPER_SPEC
from repro_torch.stack.spec import dram_on_logic as t_dram_on_logic

STACKS = {"paper": (J_PAPER_SPEC, T_PAPER_SPEC),
          "dram2": (j_dram_on_logic(2), t_dram_on_logic(2))}
T_ATOL_C = 1e-3


def _grids(stack, n=16, margin=4, die_w=5e-3):
    js, ts = STACKS[stack]
    kw = dict(die_w=die_w, ny=n, nx=n, margin=margin)
    return jthermal.Grid(spec=js, **kw), tthermal.Grid(spec=ts, **kw)


def _logic_power(grid, watts=40.0):
    n = grid.ny
    logic = list(grid.stack.logic_layers)
    p = np.zeros((grid.n_die_layers, n, n), np.float32)
    p[logic] = watts / (len(logic) * n * n)
    return p


@pytest.mark.parametrize("solver", ["pcg", "mg", "mgcg"])
@pytest.mark.parametrize("stack", ["paper", "dram2"])
def test_steady_state_matches_reference(stack, solver):
    jg, tg = _grids(stack)
    p = _logic_power(jg)
    Tj, sj = jthermal.steady_state_stats(p, jg, solver=solver)
    Tt, st = tthermal.steady_state_stats(p, tg, device="cpu", solver=solver)
    assert Tt.shape == Tj.shape
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0,
                               atol=T_ATOL_C)
    assert abs(st["iterations"] - sj["iterations"]) <= 2
    assert (st["solver"], st["attempts"], st["solved_by"]) \
        == (sj["solver"], sj["attempts"], sj["solved_by"])
    assert st["rel_residual"] <= tthermal.HEALTH_RTOL
    T_plain = tthermal.steady_state(p, tg, device="cpu", solver=solver)
    assert torch.equal(T_plain, Tt)


def test_solver_constants_and_fallback_chain_match_reference():
    assert tthermal.SOLVERS == jthermal.SOLVERS
    assert tthermal.HEALTH_RTOL == jthermal.HEALTH_RTOL
    for s in tthermal.SOLVERS:
        assert tthermal.fallback_chain(s) == jthermal.fallback_chain(s)
    with pytest.raises(ValueError):
        tthermal.fallback_chain("cg")
    assert tthermal.package_resistance(25e-6) \
        == jthermal.package_resistance(25e-6)


def test_poisoned_mg_falls_back_to_mgcg_as_reference():
    """The bench_faults scenario: mg forced to diverge is caught by the
    TRUE-residual check and solved by mgcg on the second attempt."""
    jg = jthermal.Grid(die_w=3e-3, ny=16, nx=16, margin=4)
    tg = tthermal.Grid(die_w=3e-3, ny=16, nx=16, margin=4)
    p = np.zeros((jg.n_die_layers, 16, 16), np.float32)
    p[0, 4:12, 4:12] = 0.05
    with j_poison("mg"):
        Tj, sj = jthermal.steady_state_stats(p, jg, solver="mg")
    with t_poison("mg"):
        Tt, st = tthermal.steady_state_stats(p, tg, device="cpu",
                                             solver="mg")
    assert (st["attempts"], st["solved_by"]) == (2, "mgcg")
    assert (sj["attempts"], sj["solved_by"]) == (2, "mgcg")
    assert st["rel_residual"] <= tthermal.HEALTH_RTOL
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0,
                               atol=T_ATOL_C)
    # every rung poisoned: the chain is exhausted and reports it
    with t_poison("mg", "mgcg", "pcg"):
        T, stats = tthermal.steady_state_stats(p, tg, device="cpu",
                                               solver="mg")
    assert stats["attempts"] == 4 and not math.isfinite(
        stats["rel_residual"])


def test_steady_state_refuses_non_finite_power_and_zero_power_is_ambient():
    _, tg = _grids("paper", n=8, margin=2)
    p = _logic_power(tg)
    p[0, 1, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        tthermal.steady_state(p, tg, device="cpu")
    T, stats = tthermal.steady_state_stats(np.zeros_like(p), tg,
                                           device="cpu", solver="mg")
    assert torch.equal(T, torch.full_like(T, tthermal.AMBIENT_C))
    assert stats["rel_residual"] == 0.0


def _legacy(stack="paper", n=12):
    jg, tg = _grids(stack, n=n, margin=0, die_w=7.33e-3)
    gj = jg.conductances()
    gt = interop.conductances_from_reference(
        {k: np.asarray(v) if not isinstance(v, float) else v
         for k, v in gj.items()}, "cpu")
    return jg, tg, gj, gt


@pytest.mark.parametrize("batched", [False, True])
def test_legacy_apply_operator_matches_reference_and_pallas(batched):
    jg, tg, gj, gt = _legacy()
    shape = (jg.n_layers, jg.ny, jg.nx)
    rng = np.random.default_rng(3)
    T = (45.0 + 30.0 * rng.random((2,) + shape if batched else shape)) \
        .astype(np.float32)
    args_j = (gj["g_lat"], gj["g_vert"], gj["g_pkg"])
    before = tops.apply_operator.launches
    got = tthermal.apply_operator(torch.from_numpy(T), gt["g_lat"],
                                  gt["g_vert"], gt["g_pkg"]).numpy()
    assert tops.apply_operator.launches == before      # plain on the CPU
    for i, Ti in enumerate(T if batched else [T]):
        ref = np.asarray(jthermal.apply_operator(jnp.asarray(Ti), *args_j))
        pallas = np.asarray(jops.apply_operator(jnp.asarray(Ti), *args_j,
                                                block_y=4))
        g = got[i] if batched else got
        scale = np.abs(ref).max()
        np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(g, pallas, rtol=1e-5, atol=1e-5 * scale)


def test_legacy_diag_and_scalar_conductances_match_reference():
    jg, tg, gj, gt = _legacy(n=8)
    shape = (jg.n_layers, 8, 8)
    ref = np.asarray(jthermal._diag(shape, gj["g_lat"], gj["g_vert"],
                                    gj["g_pkg"]))
    got = tthermal._diag(shape, gt["g_lat"], gt["g_vert"], gt["g_pkg"])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    T = np.random.default_rng(4).random(shape).astype(np.float32)
    ref = np.asarray(jthermal.apply_operator(jnp.asarray(T), 2.0, 0.5, 0.1))
    got = tthermal.apply_operator(torch.from_numpy(T), 2.0, 0.5, 0.1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_legacy_cg_solve_matches_reference():
    jg, tg, gj, gt = _legacy(n=8)
    shape = (jg.n_layers, 8, 8)
    b = np.zeros(shape, np.float32)
    b[:4] = 0.01
    dj = jthermal._diag(shape, gj["g_lat"], gj["g_vert"], gj["g_pkg"])
    ref = np.asarray(jthermal._cg_solve(jnp.asarray(b), dj, gj["g_lat"],
                                        gj["g_vert"], gj["g_pkg"]))
    got = tthermal._cg_solve(torch.from_numpy(b), tthermal._diag(
        shape, gt["g_lat"], gt["g_vert"], gt["g_pkg"]), gt["g_lat"],
        gt["g_vert"], gt["g_pkg"])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=T_ATOL_C)


def test_explicit_transient_matches_reference():
    jg, tg = _grids("paper", n=8, margin=0, die_w=7.33e-3)
    p = _logic_power(jg, watts=20.0)
    assert tthermal.explicit_dt(tg) == jthermal.explicit_dt(jg)
    Tj, pj = jthermal.transient_solve(p, jg, t_end=40 * jthermal.explicit_dt(jg))
    Tt, pt = tthermal.transient_solve(p, tg, t_end=40 * tthermal.explicit_dt(tg),
                                      device="cpu")
    assert pt.shape == pj.shape
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0,
                               atol=T_ATOL_C)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=T_ATOL_C)


@pytest.mark.parametrize("solver", ["pcg", "mg"])
def test_transient_solve_implicit_matches_reference(solver):
    jg, tg = _grids("paper", n=16, margin=0, die_w=7.33e-3)
    p = _logic_power(jg)
    Tj, pj = jthermal.transient_solve_implicit(p, jg, 0.05, 10,
                                               solver=solver)
    Tt, pt = tthermal.transient_solve_implicit(p, tg, 0.05, 10,
                                               solver=solver, device="cpu")
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0,
                               atol=T_ATOL_C)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=T_ATOL_C)


def test_transient_residual_telemetry_matches_reference():
    """with_residuals=True: the per-step relative linear residual of each
    inner solve (the reference's telemetry return)."""
    jg, tg, gj, gt = _legacy(n=8)
    p = np.array(jg.pad_power(_logic_power(jg)))
    T0 = np.full(p.shape, 45.0, np.float32)
    cap = np.array(jg.capacities())
    _, _, rj = jthermal.transient_implicit(
        jnp.asarray(T0), jnp.asarray(p), gj["g_lat"], gj["g_vert"],
        gj["g_pkg"], jnp.asarray(cap), 0.005, 4, n_cg=8,
        with_residuals=True)
    _, _, rt = tthermal.transient_implicit(
        torch.from_numpy(T0), torch.from_numpy(p), gt["g_lat"], gt["g_vert"],
        gt["g_pkg"], torch.from_numpy(cap), 0.005, 4, n_cg=8,
        with_residuals=True)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0.05,
                               atol=1e-6)


@pytest.fixture(scope="module")
def comparisons():
    kw = dict(grid_ap=64, grid_simd=32, workload="dmm")
    return (jfloorplan.thermal_comparison(**kw),
            tfloorplan.thermal_comparison(device="cpu", **kw))


@pytest.mark.parametrize("machine", ["ap", "simd"])
def test_thermal_comparison_matches_reference(comparisons, machine):
    ref, got = comparisons[0][machine], comparisons[1][machine]
    for key in ("peak_C", "min_C", "span_C"):
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=0.01,
                                   err_msg=key)
    np.testing.assert_array_equal(got["power_map"], ref["power_map"])
    assert got["p_layer_W"] == ref["p_layer_W"]
    for a, b in zip(got["t_cut"], ref["t_cut"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=0.01)


def test_thermal_comparison_verdict(comparisons):
    """The paper's §4 verdict: the AP stays under the 85 °C DRAM ceiling
    across its die, the same-performance SIMD does not."""
    _, got = comparisons
    assert max(got["ap"]["peak_C"]) < 85.0
    assert got["simd"]["min_C"][0] > 85.0
    assert got["design_point"].__dict__ \
        == comparisons[0]["design_point"].__dict__


def test_ap_block_zoom_matches_reference():
    jfp = jfloorplan.APFloorplan()
    tfp = tfloorplan.APFloorplan()
    ref = jfloorplan.ap_block_zoom(jfp, 4.0, grid_n=16)
    got = tfloorplan.ap_block_zoom(tfp, 4.0, grid_n=16, device="cpu")
    np.testing.assert_array_equal(got["power_map"], ref["power_map"])
    np.testing.assert_allclose(got["peak_C"], ref["peak_C"], rtol=0,
                               atol=T_ATOL_C)
    np.testing.assert_allclose(got["span_C"], ref["span_C"], rtol=0,
                               atol=T_ATOL_C)
