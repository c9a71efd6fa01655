"""The port's entry points take the reference's parameters.

Each entry point is called with the reference's positional and keyword
arguments (``backend=``, ``use_pallas=``, ``sweep_fn=``/``prolong_fn=``,
``g_vert``, the kernel wrappers' Pallas options) on the same seeded
inputs in both packages, and must give the reference's answers and
counters.  The port on the CPU runs each kernel's plain version; the
reference runs its ``jnp`` path (its Pallas paths give the same bits, as
its own tests pin).  ``device`` is the port's own keyword and is
keyword-only.  Also here: ``APEngine.run`` hands the pass-schedule kernel
its tables' column range, and a field pack gives the stencil the same
``y`` as the dict of seven.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import engine as jengine
from repro.core import multigrid as jmg
from repro.core import thermal as jthermal
from repro.kernels.ap_match import ops as jap_ops
from repro.kernels.thermal_stencil import ops as jst_ops
from repro.stack import feedback as jfb
from repro.stack.spec import dram_on_logic as j_dram_on_logic
from repro.workloads import _device as jdev
from repro.workloads import blackscholes as jbs
from repro.workloads import dmm as jdmm
from repro.workloads import fft as jfft
from repro.workloads import histogram as jhist
from repro.workloads import knn as jknn
from repro.workloads import sort as jsort
from repro.workloads import spmv as jspmv
from repro_torch import interop
from repro_torch.core import engine as tengine
from repro_torch.core import multigrid as tmg
from repro_torch.core import thermal as tthermal
from repro_torch.kernels.ap_match import ops as tap_ops
from repro_torch.kernels.ap_megakernel import ops as tmk_ops
from repro_torch.kernels.ap_megakernel import ref as tmk_ref
from repro_torch.kernels.mg_smooth import ops as tmg_ops
from repro_torch.kernels.thermal_stencil import ops as tst_ops
from repro_torch.stack import feedback as tfb
from repro_torch.stack.spec import dram_on_logic as t_dram_on_logic
from repro_torch.workloads import _device as tdev
from repro_torch.workloads import blackscholes as tbs
from repro_torch.workloads import dmm as tdmm
from repro_torch.workloads import fft as tfft
from repro_torch.workloads import histogram as thist
from repro_torch.workloads import knn as tknn
from repro_torch.workloads import sort as tsort
from repro_torch.workloads import spmv as tspmv

ALL_BACKENDS = ("jnp", "pallas", "megakernel", "megakernel_pallas")


def _same(ref, got):
    """Answers equal, counters (trace arrays included) identical."""
    (r_out, r_ctr), (t_out, t_ctr) = ref, got
    np.testing.assert_array_equal(np.asarray(t_out), np.asarray(r_out))
    assert set(t_ctr) == set(r_ctr)
    for k, v in r_ctr.items():
        if isinstance(v, np.ndarray) or hasattr(v, "shape"):
            np.testing.assert_array_equal(np.asarray(t_ctr[k]),
                                          np.asarray(v), err_msg=k)
        else:
            assert t_ctr[k] == v, k


def test_backend_names_are_the_references():
    assert tengine.APEngine.BACKENDS == jengine.APEngine.BACKENDS
    for b in ALL_BACKENDS:
        eng = tengine.APEngine(32, 8, tengine.PAPER_POWER, True, b,
                               device="cpu")
        assert eng.backend == b
    for mode in ("eager", "device", "megakernel"):
        for b in ALL_BACKENDS:
            assert tdev.engine_backend(b, mode) == \
                jdev.engine_backend(b, mode)
    with pytest.raises(ValueError, match="backend"):
        tdev.engine_backend("ap_match", "megakernel")


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_ap_matmul_reference_arguments(backend):
    rng = np.random.default_rng(0)
    A = rng.integers(0, 16, (4, 4), dtype=np.uint64)
    ref = jdmm.ap_matmul(A, A, 8, "jnp")
    _same(ref, tdmm.ap_matmul(A, A, 8, backend, device="cpu"))
    _same(ref, tdmm.ap_matmul(A, A, m=8, backend=backend, device="cpu"))


def test_device_is_keyword_only():
    A = np.ones((4, 4), np.uint64)
    with pytest.raises(TypeError):
        tdmm.ap_matmul(A, A, 8, "jnp", "cpu")
    with pytest.raises(TypeError):
        tsort.ap_sort(np.arange(4, dtype=np.uint64), 8, "jnp", "device",
                      None, "cpu")


def test_ap_fft_and_blackscholes_reference_arguments():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=8) + 1j * rng.normal(size=8)) * 0.1
    ref = jfft.ap_fft(x, 12, 9, "parallel", "jnp")
    _same(ref, tfft.ap_fft(x, 12, 9, "parallel", "pallas", device="cpu"))
    S, K, T, sig = (rng.uniform(lo, hi, 4) for lo, hi in
                    ((0.9, 1.4), (0.9, 1.4), (0.5, 1.5), (0.2, 0.5)))
    ref = jbs.ap_blackscholes(S, K, T, sig, 0.05, "jnp")
    _same(ref, tbs.ap_blackscholes(S, K, T, sig, 0.05, "megakernel",
                                   device="cpu"))


@pytest.mark.parametrize("mode", ["eager", "device", "megakernel"])
def test_suite_entry_points_reference_arguments(mode):
    """``ap_sort(x, 8, "jnp")``, ``ap_sort(x, 8, backend="jnp")`` and the
    other suite entry points with the backend in its position, every
    backend name against the reference's ``jnp``."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, 40, dtype=np.uint64)
    ref = jsort.ap_sort(x, 8, "jnp", mode)
    _same(ref, tsort.ap_sort(x, 8, "jnp", mode, device="cpu"))
    _same(ref, tsort.ap_sort(x, 8, backend="pallas", mode=mode,
                             device="cpu"))
    h = rng.integers(0, 64, 40, dtype=np.uint64)
    _same(jhist.ap_histogram(h, 8, 6, "jnp", mode),
          thist.ap_histogram(h, 8, 6, "megakernel", mode, device="cpu"))
    db = rng.integers(0, 16, (40, 4), dtype=np.uint64)
    q = rng.integers(0, 16, 4, dtype=np.uint64)
    _same(jknn.ap_knn(db, q, 5, 4, "jnp", mode),
          tknn.ap_knn(db, q, 5, 4, "megakernel_pallas", mode, None,
                      device="cpu"))
    r, c = rng.integers(0, 8, 16), rng.integers(0, 8, 16)
    v = rng.integers(0, 50, 16, dtype=np.uint64)
    xv = rng.integers(0, 50, 8, dtype=np.uint64)
    _same(jspmv.ap_spmv(r, c, v, xv, 8, 6, "jnp", mode),
          tspmv.ap_spmv(r, c, v, xv, 8, 6, "pallas", mode, device="cpu"))


def test_engine_run_passes_its_column_range(monkeypatch):
    """``APEngine.run`` hands ``run_schedule`` the (least, greatest)
    column of its bucketed host tables, so a launch reads nothing back."""
    seen = []
    real = tap_ops.run_schedule

    def spy(planes, cc, ck, wc, wk, col_range=None, **kw):
        seen.append((col_range, (cc.numpy(), wc.numpy())))
        return real(planes, cc, ck, wc, wk, col_range, **kw)

    monkeypatch.setattr(tap_ops, "run_schedule", spy)
    eng = tengine.APEngine(64, 40, device="cpu")
    two = tengine.PassSchedule.build([([3, 9], [1, 0], [17], [1]),
                                      ([5], [1], [30, 2], [0, 1])])
    # three passes bucket to four: the padding pass names column 0
    three = tengine.PassSchedule.build([([3, 9], [1, 0], [17], [1]),
                                        ([5], [1], [30, 2], [0, 1]),
                                        ([4], [0], [6], [1])])
    for sched, want in ((two, (2, 30)), (three, (0, 30))):
        seen.clear()
        eng.run(sched)
        [(col_range, (cc, wc))] = seen
        cols = np.concatenate([cc.ravel(), wc.ravel()])
        assert col_range == (int(cols.min()), int(cols.max())) == want
        bucketed = tengine.bucket_schedule(sched)
        assert col_range == tengine.schedule_col_range(bucketed[0],
                                                       bucketed[2])


def test_schedule_tensors_share_one_buffer():
    """The four tables cross in one copy: views of one packed buffer."""
    sched = tengine.PassSchedule.build([([3, 9], [1, 0], [17], [1]),
                                        ([5], [1], [30, 2], [0, 1])])
    tables = tengine.bucket_schedule(sched)
    tabs = tengine.schedule_tensors(*tables, "cpu")
    base = tabs[0].untyped_storage().data_ptr()
    for host, t in zip(tables, tabs):
        assert t.untyped_storage().data_ptr() == base
        assert t.is_contiguous() and t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(host).view(np.int32))


def _fields(seed, shape):
    rng = np.random.default_rng(seed)
    F = {k: rng.uniform(0, 1e-2, shape).astype(np.float32)
         for k in tst_ops.FIELD_KEYS}
    T = rng.uniform(45, 75, shape).astype(np.float32)
    return T, F


@pytest.mark.parametrize("shape", [(5, 9, 7), (3, 4, 6, 6)])
def test_field_pack_matches_dict(shape):
    """A pack built once gives the same ``y`` as the dict of seven (the
    plain path), its fields are views of one tensor, and its keys stay."""
    T, F = _fields(3, shape)
    Ft = {k: torch.from_numpy(v) for k, v in F.items()}
    pack = tst_ops.pack_fields(Ft)
    assert tst_ops.pack_fields(pack) is pack
    assert pack.data.shape == (7,) + shape and pack.shape == shape
    for i, k in enumerate(tst_ops.FIELD_KEYS):
        assert torch.equal(pack[k], Ft[k])
        assert pack[k].data_ptr() == pack.data[i].data_ptr()
    Tt = torch.from_numpy(T)
    want = tst_ops.apply_operator_fields(Tt, Ft)
    torch.testing.assert_close(tst_ops.apply_operator_fields(Tt, pack), want,
                               rtol=0, atol=0)
    with pytest.raises(TypeError):
        pack["g_pkg"] = Ft["g_pkg"]
    twin = copy.deepcopy(pack)              # a copy is a pack of its own
    assert type(twin) is tst_ops.FieldPack
    assert twin["gz_dn"].data_ptr() == twin.data[5].data_ptr()
    torch.testing.assert_close(tst_ops.apply_operator_fields(Tt, twin), want,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="gz_up"):
        tst_ops.pack_fields(dict(Ft, gz_up=Ft["gz_up"][:1]))


def test_grid_fields_are_a_pack_of_the_references_fields():
    jg = jthermal.Grid(die_w=4e-3, ny=8, nx=8, margin=2,
                       spec=j_dram_on_logic(2))
    tg = tthermal.Grid(die_w=4e-3, ny=8, nx=8, margin=2,
                       spec=t_dram_on_logic(2))
    Ft = tg.fields("cpu")
    assert isinstance(Ft, tst_ops.FieldPack)
    for k, v in jg.fields().items():
        np.testing.assert_array_equal(Ft[k].numpy(), np.asarray(v))


def test_stencil_wrappers_take_the_references_arguments():
    """``apply_operator(T, g_lat, g_vert, g_pkg)`` and the Pallas options
    of both stencils, against the reference's wrappers."""
    T, F = _fields(4, (4, 8, 8))
    g_lat = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    g_vert = np.array([0.5, 0.6, 0.7], np.float32)
    ref = np.asarray(jst_ops.apply_operator(jnp.asarray(T), g_lat, g_vert,
                                            0.05, block_y=4))
    got = tst_ops.apply_operator(torch.from_numpy(T), g_lat, g_vert, 0.05,
                                 block_y=4, interpret=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    ref = np.asarray(jst_ops.apply_operator_fields(
        jnp.asarray(T), {k: jnp.asarray(v) for k, v in F.items()},
        block_y=4))
    got = tst_ops.apply_operator_fields(
        torch.from_numpy(T), {k: torch.from_numpy(v) for k, v in F.items()},
        block_y=4, interpret=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_kernel_wrappers_ignore_the_pallas_options():
    rng = np.random.default_rng(5)
    sched = tengine.PassSchedule.build([([1, 2], [1, 0], [3], [1]),
                                        ([3], [1], [0], [0])])
    tables = tengine.bucket_schedule(sched)
    planes = rng.integers(0, 2 ** 32, (4, 3), dtype=np.uint64) \
        .astype(np.uint32)
    ref_p, ref_m = jap_ops.run_schedule(jnp.asarray(planes), *tables,
                                        backend="jnp")
    tplanes = interop.planes_from_reference(planes, "cpu")
    tabs = tengine.schedule_tensors(*tables, "cpu")
    got_p, got_m = tap_ops.run_schedule(tplanes, *tabs, backend="pallas",
                                        block_lanes=512, interpret=True)
    np.testing.assert_array_equal(interop.planes_to_reference(got_p),
                                  np.asarray(ref_p))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    group = tmk_ref.OpGroup.from_schedule(*tables)
    tag = torch.zeros(3, dtype=torch.int32)
    mk = tmk_ops.run_group(tplanes, tag, group, None, backend="jnp",
                           mesh=None, block_lanes=512, interpret=True)
    assert torch.equal(mk[0], got_p) and torch.equal(mk[2], got_m)
    T, F = _fields(6, (3, 6, 6))
    Tt = torch.from_numpy(T)
    Ft = {k: torch.from_numpy(v) for k, v in F.items()}
    b = torch.full_like(Tt, 1e-3)
    torch.testing.assert_close(
        tmg_ops.rb_line_sweep(Tt, b, Ft, 0.0, 1, block_y=4, interpret=True),
        tmg_ops.rb_line_sweep(Tt, b, Ft, 0.0, 1), rtol=0, atol=0)


def _mg_case():
    jg = jthermal.Grid(die_w=4e-3, ny=8, nx=8, margin=4,
                       spec=j_dram_on_logic(1))
    Fj = jg.fields()
    Ft = interop.fields_from_reference({k: np.asarray(v)
                                        for k, v in Fj.items()}, "cpu")
    b = np.random.default_rng(7).uniform(
        0, 1e-2, np.asarray(Fj["g_pkg"]).shape).astype(np.float32)
    return Fj, Ft, b


def test_multigrid_hooks_and_use_pallas():
    """``v_cycle``'s ``sweep_fn``/``prolong_fn`` and ``iterate_fixed``'s
    ``sweep_fn`` in their positions; ``use_pallas=True`` is accepted."""
    Fj, Ft, b = _mg_case()
    lj, lt = jmg.build_levels(Fj, 0.0), tmg.build_levels(Ft, 0.0)
    ref = np.asarray(jmg.v_cycle(lj, jnp.asarray(b), 1, 1, 0,
                                 jmg.rb_line_sweep, jmg.prolong))
    got = tmg.v_cycle(lt, torch.from_numpy(b), 1, 1, 0, tmg.rb_line_sweep,
                      tmg.prolong)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * scale)
    calls = []

    def sweep(*a, **kw):
        calls.append(1)
        return tmg.rb_line_sweep(*a, **kw)

    ct = tmg.coarse_solve_fn(lt)
    got = tmg.iterate_fixed(lt, torch.from_numpy(b), 2, 1, 1, sweep, ct)
    assert calls
    ref = np.asarray(jmg.iterate_fixed(lj, jnp.asarray(b), 2, 1, 1,
                                       jmg.rb_line_sweep,
                                       jmg.coarse_solve_fn(lj)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    ref = np.asarray(jmg.mg_fixed(jnp.asarray(b), Fj, 0.0, 2, 1, 1, False))
    got = tmg.mg_fixed(torch.from_numpy(b), Ft, 0.0, 2, 1, 1, True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())
    for jfn, tfn in ((jmg.mg_solve_fields, tmg.mg_solve_fields),
                     (jmg.mgcg_solve_fields, tmg.mgcg_solve_fields)):
        xr, _ = jfn(jnp.asarray(b), Fj, 0.0, 1e-6, 50, 1, 1, False)
        xt, _ = tfn(torch.from_numpy(b), Ft, 0.0, 1e-6, 50, 1, 1, True)
        xr = np.asarray(xr)
        np.testing.assert_allclose(xt.numpy(), xr, rtol=1e-3,
                                   atol=1e-3 * np.abs(xr).max())


def test_thermal_use_pallas_in_its_position():
    jg = jthermal.Grid(die_w=4e-3, ny=8, nx=8, margin=2,
                       spec=j_dram_on_logic(1))
    tg = tthermal.Grid(die_w=4e-3, ny=8, nx=8, margin=2,
                       spec=t_dram_on_logic(1))
    p = np.random.default_rng(8).uniform(
        0, 0.05, (jg.n_die_layers, 8, 8)).astype(np.float32)
    Tj, sj = jthermal.steady_state_stats(p, jg, 45.0, False, "mg", 1e-8)
    Tt, st = tthermal.steady_state_stats(p, tg, 45.0, True, "mg", 1e-8,
                                         device="cpu")
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-3)
    assert st["solved_by"] == sj["solved_by"]
    np.testing.assert_allclose(
        tthermal.steady_state(p, tg, 45.0, True, "pcg", device="cpu")
        .numpy(), np.asarray(jthermal.steady_state(p, jg, 45.0, False,
                                                   "pcg")), atol=1e-3)
    F = jg.fields()
    Ft = tg.fields("cpu")
    cap = np.array(jg.capacity_field())
    T0 = np.full(cap.shape, 45.0, np.float32)
    pw = np.zeros(cap.shape, np.float32)
    pw[:jg.n_die_layers, 2:10, 2:10] = p
    Tr, pr = jthermal.transient_implicit_fields(
        jnp.asarray(T0), jnp.asarray(pw), F, jnp.asarray(cap), 0.01, 3,
        1.0, 45.0, 20, "mg", 2, False)
    Tq, pq = tthermal.transient_implicit_fields(
        torch.from_numpy(T0), torch.from_numpy(pw), Ft,
        torch.from_numpy(cap), 0.01, 3, 1.0, 45.0, 20, "mg", 2, True)
    np.testing.assert_allclose(Tq.numpy(), np.asarray(Tr), atol=1e-3)
    np.testing.assert_allclose(pq.numpy(), np.asarray(pr), atol=1e-3)
    A = lambda v: tthermal.apply_operator_fields(v, Ft)
    solve = tthermal.implicit_lhs_solver(
        A, Ft, torch.from_numpy(cap), 0.01, 1.0, solver="pcg", n_cg=10,
        use_pallas=True)
    assert solve(torch.from_numpy(pw)[None]).shape == (1,) + cap.shape


def test_run_stack_cosim_use_pallas_in_its_position():
    """``run_stack_cosim`` with the reference's positional arguments up to
    ``use_pallas`` and ``solver``: the reference's answer (the replay's
    float32 tolerance of ``test_torch_feedback.py``)."""
    args = (("dmm",), 1, 8, 6, 0.25, 1, 20, 1.0, jfb.FeedbackParams())
    ref = jfb.run_stack_cosim(*args, jfb.PAPER_STACK, False, "pcg")
    got = tfb.run_stack_cosim(*args[:-1], tfb.FeedbackParams(),
                              tfb.PAPER_STACK, True, "pcg", device="cpu")
    for machine in ("ap", "simd"):
        r, g = ref["dmm"][machine], got["dmm"][machine]
        np.testing.assert_allclose(g.peak_C, np.asarray(r.peak_C),
                                   atol=0.1)


# ---------------------------------------------------------------------------
# the open-loop co-simulation, coarsening and sensor faults
# ---------------------------------------------------------------------------

def _params(fn):
    """Positional-or-keyword parameter names of ``fn``, in order, and its
    keyword-only ones."""
    import inspect
    ps = inspect.signature(fn).parameters.values()
    return ([p.name for p in ps if p.kind != p.KEYWORD_ONLY],
            sorted(p.name for p in ps if p.kind == p.KEYWORD_ONLY))


def test_new_entry_points_have_the_references_signatures():
    """Every entry point of this slice takes the reference's parameters in
    the reference's positions; ``device`` is the port's own, keyword-only
    addition where the entry point creates tensors."""
    from repro.core import cosim as jc
    from repro.faults import guard as jg
    from repro.faults import models as jm
    from repro_torch.core import cosim as tc
    from repro_torch.faults import guard as tg
    from repro_torch.faults import models as tm
    pairs = [(jc.power_frames, tc.power_frames, []),
             (jc.coarsen_plan, tc.coarsen_plan, []),
             (jc.dc_peak_rise_C, tc.dc_peak_rise_C, []),
             (jc.cosim_transient, tc.cosim_transient, []),
             (jc.cosim_transient_batch, tc.cosim_transient_batch, []),
             (jc.run_cosim, tc.run_cosim, ["device"]),
             (jfb.stack_power_frames, tfb.stack_power_frames, []),
             (jfb.closed_loop_replay, tfb.closed_loop_replay, []),
             (jm.inject_power_spikes, tm.inject_power_spikes, [])]
    for ref, port, extra in pairs:
        rp, rk = _params(ref)
        pp, pk = _params(port)
        assert pp == rp, port.__name__
        assert pk == sorted(rk + extra), port.__name__
    for ref, port in ((jc.CoarsePlan, tc.CoarsePlan),
                      (jc.CosimReport, tc.CosimReport),
                      (jm.SensorFaultSpec, tm.SensorFaultSpec),
                      (jm.PowerFaultSpec, tm.PowerFaultSpec),
                      (jg.GuardedPolicy, tg.GuardedPolicy),
                      (jfb.FeedbackParams, tfb.FeedbackParams)):
        import dataclasses
        assert [f.name for f in dataclasses.fields(port)] \
            == [f.name for f in dataclasses.fields(ref)], port.__name__
    for name in ("merge", "expand", "pad_to", "dt_scale"):
        assert _params(getattr(tc.CoarsePlan, name)) \
            == _params(getattr(jc.CoarsePlan, name)), name
    assert _params(tm.SensorFaultSpec.read) == _params(jm.SensorFaultSpec.read)


def test_run_cosim_reference_positional_arguments():
    """``run_cosim`` with every reference argument in its position, up to
    ``stack`` and ``use_pallas``: the reference's answer within 2e-3 °C
    (60 CG iterations; the SIMD case runs at 160 °C, where 20 leave the
    two packages' float32 sums 0.04 °C apart)."""
    from repro.core import cosim as jc
    from repro_torch.core import cosim as tc
    from repro_torch.stack.spec import PAPER_STACK
    args = (("dmm",), 8, 6, 0.1, 1, 60, 1.0)
    ref = jc.run_cosim(*args, jfb.PAPER_STACK, False)
    got = tc.run_cosim(*args, PAPER_STACK, True, device="cpu")
    for machine in ("ap", "simd"):
        np.testing.assert_allclose(got["dmm"][machine].peak_C,
                                   ref["dmm"][machine].peak_C, atol=2e-3)


def test_cosim_transient_and_coarsening_reference_positional_arguments():
    """``cosim_transient`` with ``theta`` and ``t_amb`` positional,
    ``coarsen_plan(activity, tol, max_merge)``, ``CoarsePlan(reps)`` and
    ``dc_peak_rise_C(frame, F)`` as the reference takes them."""
    from repro.core import cosim as jc
    from repro_torch.core import cosim as tc
    rng = np.random.default_rng(6)
    jgrid = jthermal.Grid(die_w=3e-3, ny=8, nx=8, margin=2)
    tgrid = tthermal.Grid(die_w=3e-3, ny=8, nx=8, margin=2)
    pmap = rng.uniform(0, 5e-3, size=(8, 8))
    act = rng.uniform(0.5, 1.5, 5)
    frames = tc.power_frames(tc.PowerTrace(act / act.mean()), pmap, 0.0,
                             tgrid)
    kw = dict(die_n=8, steps_per_interval=2, n_cg=40, n_si=4, margin=2)
    ref = jc.cosim_transient(jnp.asarray(frames), jgrid.fields(),
                             jgrid.capacity_field(), 0.02, 0.5, 30.0, **kw)
    got = tc.cosim_transient(torch.from_numpy(frames), tgrid.fields("cpu"),
                             tgrid.capacity_field("cpu"), 0.02, 0.5, 30.0,
                             **kw)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-3)
    plan = tc.coarsen_plan(act, 0.3, 2)
    np.testing.assert_array_equal(plan.reps,
                                  jc.coarsen_plan(act, 0.3, 2).reps)
    assert tc.CoarsePlan(plan.reps).n_base == 5
    np.testing.assert_allclose(
        tc.dc_peak_rise_C(frames[0], tgrid.fields("cpu")),
        jc.dc_peak_rise_C(frames[0], jgrid.fields()), rtol=1e-4)


def test_fault_specs_and_guard_reference_positional_arguments():
    """``SensorFaultSpec``, ``PowerFaultSpec`` and ``GuardedPolicy`` built
    positionally as the reference's; ``FeedbackParams(faults=)`` and
    ``policy.get("guarded")`` take them."""
    from repro.faults import models as jm
    from repro.faults import guard as jg
    from repro.policy import PerDiePolicy as JPerDie
    from repro_torch.faults import models as tm
    from repro_torch.faults import guard as tg
    from repro_torch.policy import PerDiePolicy, get
    args = (3, 4, 0.5, 0.25, 0.1, 0.5, 1, 0.2)
    assert dataclasses_astuple(tm.SensorFaultSpec(*args)) \
        == dataclasses_astuple(jm.SensorFaultSpec(*args))
    assert dataclasses_astuple(tm.PowerFaultSpec(1, 2, 3.0, 2)) \
        == dataclasses_astuple(jm.PowerFaultSpec(1, 2, 3.0, 2))
    g = tg.GuardedPolicy(PerDiePolicy(), -10.0, 140.0, 50.0, 2, 0.3)
    jgp = jg.GuardedPolicy(JPerDie(), -10.0, 140.0, 50.0, 2, 0.3)
    assert (g.lo_C, g.hi_C, g.max_step_C, g.hold_max, g.floor, g.name) \
        == (jgp.lo_C, jgp.hi_C, jgp.max_step_C, jgp.hold_max, jgp.floor,
            jgp.name)
    fb = tfb.FeedbackParams(policy=get("guarded"),
                            faults=tm.SensorFaultSpec(*args))
    assert fb.resolved_policy().name == "guarded-perdie"


def dataclasses_astuple(x):
    import dataclasses
    return dataclasses.astuple(x)


def test_serving_entry_points_have_the_references_signatures():
    """The serving package and the parameter-count path take the
    reference's parameters in the reference's positions; ``device`` is
    ``run_serving_cosim``'s own keyword-only addition, and the dataclasses
    have the reference's fields in order."""
    import dataclasses
    from repro import serving as J
    from repro.launch import roofline as JRF
    from repro.launch import steps as jsteps
    from repro.serving import sim as jsim
    from repro_torch import serving as S
    from repro_torch.launch import roofline as TRF
    from repro_torch.launch import steps as tsteps
    from repro_torch.serving import sim as tsim
    pairs = [(J.run_serving_cosim, S.run_serving_cosim, ["device"]),
             (J.fluid_queue, S.fluid_queue, []),
             (J.serving_cost, S.serving_cost, []),
             (J.kv_bytes_per_token, S.kv_bytes_per_token, []),
             (J.verdict_table, S.verdict_table, []),
             (jsim._machine_floorplan, tsim._machine_floorplan, []),
             (jsteps.params_sds, tsteps.params_sds, []),
             (JRF.count_params, TRF.count_params, []),
             (JRF.count_active_params, TRF.count_active_params, []),
             (JRF.model_flops_per_device, TRF.model_flops_per_device, []),
             (JRF.roofline, TRF.roofline, []),
             (JRF.parse_collectives, TRF.parse_collectives, [])]
    for ref, port, extra in pairs:
        rp, rk = _params(ref)
        pp, pk = _params(port)
        assert pp == rp, port.__name__
        assert pk == sorted(rk + extra), port.__name__
    for ref, port in ((J.ServingScenario, S.ServingScenario),
                      (J.ServingReport, S.ServingReport),
                      (J.QueueResult, S.QueueResult),
                      (J.TrafficSpec, S.TrafficSpec),
                      (J.RequestShape, S.RequestShape),
                      (J.ModelServingCost, S.ModelServingCost),
                      (JRF.RooflineTerms, TRF.RooflineTerms)):
        assert [f.name for f in dataclasses.fields(port)] \
            == [f.name for f in dataclasses.fields(ref)], port.__name__
    for name in ("rate_qps", "arrivals"):
        assert _params(getattr(S.TrafficSpec, name)) \
            == _params(getattr(J.TrafficSpec, name)), name
    for name in ("decode_step_bytes", "decode_ai", "workload",
                 "traffic_bytes_per_s"):
        assert _params(getattr(S.ModelServingCost, name)) \
            == _params(getattr(J.ModelServingCost, name)), name
    for name in ("time_above", "throttle_curve"):
        assert _params(getattr(S.ServingReport, name)) \
            == _params(getattr(J.ServingReport, name)), name


def test_run_serving_cosim_reference_positional_arguments():
    """``run_serving_cosim(scenario, machines, fb, params, coarsen)``
    positionally, as the reference takes it: the reference's plan and
    rate, its peaks within 0.1 °C."""
    from repro import serving as J
    from repro_torch import serving as S
    from repro_torch.stack.spec import PAPER_STACK
    kw = dict(config="deepseek-v2-lite-16b", load=0.5, grid_n=8,
              n_rounds=1, coarsen_tol=0.05, pad_quantum=8)
    ref = J.run_serving_cosim(J.ServingScenario(
        traffic=J.TrafficSpec(shape="bursty", horizon_s=40.0), **kw),
        ("ap",), jfb.FeedbackParams(), jfb.PAPER_STACK, True)["ap"]
    got = S.run_serving_cosim(S.ServingScenario(
        traffic=S.TrafficSpec(shape="bursty", horizon_s=40.0), **kw),
        ("ap",), tfb.FeedbackParams(), PAPER_STACK, True,
        device="cpu")["ap"]
    assert (got.n_coarse, got.mean_qps) == (ref.n_coarse, ref.mean_qps)
    np.testing.assert_array_equal(got.durations_s, ref.durations_s)
    np.testing.assert_allclose(got.stack.peak_C, ref.stack.peak_C, atol=0.1)


def _train_cfgs():
    import dataclasses
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    shape = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                 vocab=512, d_head=32)
    return (dataclasses.replace(jget("stablelm-1.6b").reduced(), **shape),
            dataclasses.replace(tget("stablelm-1.6b").reduced(), **shape))


def test_training_entry_points_take_reference_arguments(tmp_path):
    """``loss_fn(params, batch, cfg, shd, perf)``, ``adamw_update(params,
    grads, state, cfg)``, ``make_train_step(cfg, cell, mesh, perf=,
    opt_cfg=, multi_pod=, dtype=)``, ``train_loop(train_step, params, opt,
    pipe, tcfg, accum, extras_fn, hook)`` and ``CheckpointManager(dir,
    keep, async_save)`` with the reference's arguments in its positions
    (``device`` by keyword): the reference's losses within 1e-5."""
    import jax
    from jax.sharding import AxisType

    from repro.configs.base import ShapeCell as JCell
    from repro.data import SyntheticLM as JPipe
    from repro.launch.steps import make_train_step as j_step
    from repro.models import model as JM
    from repro.models.layers import NOSHARD as J_NOSHARD
    from repro.optim import AdamWConfig as JAdam
    from repro.optim import adamw_init as j_init
    from repro.optim import adamw_update as j_update
    from repro.runtime.trainer import TrainerConfig as JTcfg
    from repro.runtime.trainer import train_loop as j_loop
    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as TM
    from repro_torch.models.layers import NOSHARD
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.runtime import TrainerConfig, train_loop

    jc, tc = _train_cfgs()
    pnp = interop.lm_params_seed_numpy(tc, 1)
    jp = jax.tree_util.tree_map(jnp.asarray, pnp)
    tp = interop.lm_params_from_reference(pnp, "cpu")
    b = SyntheticLM(512, 32, 4, seed=2).batch(0)
    want, _ = JM.loss_fn(jp, {k: jnp.asarray(v) for k, v in b.items()}, jc,
                         J_NOSHARD, JM.PerfConfig(remat="none"))
    got, _ = TM.loss_fn(tp, {k: torch.from_numpy(v) for k, v in b.items()},
                        tc, NOSHARD, TM.PerfConfig(remat="none"))
    assert float(got) == pytest.approx(float(want), rel=1e-5)

    grads_np = jax.tree_util.tree_map(lambda a: np.ones_like(a) * 0.01, pnp)
    _, _, jm = j_update(jp, jax.tree_util.tree_map(jnp.asarray, grads_np),
                        j_init(jp), JAdam())
    _, _, tm = adamw_update(tp, interop.lm_params_from_reference(
        grads_np, "cpu"), adamw_init(tp), AdamWConfig())
    # 32k equal squares a leaf: the two sums' orders part in the 6th digit
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert tm["lr"].item() == float(jm["lr"])

    opt = dict(lr=1e-3, warmup_steps=2, total_steps=3)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    jts, _ = j_step(jc, JCell("t", 32, 4, "train"), mesh,
                    perf=JM.PerfConfig(remat="full", accum_steps=2),
                    opt_cfg=JAdam(**opt), multi_pod=False,
                    dtype=jnp.float32)
    ts, _ = make_train_step(tc, ShapeCell("t", 32, 4, "train"),
                            make_local_mesh(1, 1, device="cpu"),
                            perf=TM.PerfConfig(remat="full", accum_steps=2),
                            opt_cfg=AdamWConfig(**opt), multi_pod=False,
                            dtype=torch.float32, device="cpu")
    seen = []
    ref = j_loop(jts, jax.tree_util.tree_map(jnp.asarray, pnp),
                 j_init(jax.tree_util.tree_map(jnp.asarray, pnp)),
                 JPipe(512, 32, 4, seed=0),
                 JTcfg(steps=3, ckpt_every=2, ckpt_dir=str(tmp_path / "j")),
                 2, lambda step: {}, None)
    params = interop.lm_params_from_reference(pnp, "cpu")
    out = train_loop(ts, params, adamw_init(params),
                     SyntheticLM(512, 32, 4, seed=0),
                     TrainerConfig(steps=3, ckpt_every=2,
                                   ckpt_dir=str(tmp_path / "t")),
                     2, lambda step: {}, lambda *a: seen.append(a[0]))
    assert seen == [0, 1, 2]
    for g, r in zip(out["history"], ref["history"]):
        assert g["loss"] == pytest.approx(r["loss"], rel=1e-5)

    mgr = CheckpointManager(tmp_path / "m", 2, False)
    mgr.save(4, {"params": out["params"]}, {"loss": 1.0})
    back = mgr.restore(4, {"params": out["params"]}, None, None)
    for a, b in zip(tree.leaves(out["params"]), tree.leaves(back)):
        assert torch.equal(a, b)
