"""PyTorch port vs the JAX reference: the DTM/DVFS policy family.

The reference vmaps one case's controller over the case batch; the port's
controllers act on the whole batch at once, each case carrying its own
state.  Each controller's ``act`` is held against the reference's, case
by case, over a batch whose hot spots straddle the trip: state, power and
performance duty bit for bit.  Each controller then runs inside
``replay_cases`` against the reference's replay: DRAM and logic peaks
within 1e-3 °C with the CG converged (``n_cg=120``; at ``n_cg=30`` the
unconverged float32 CG differs by up to 0.1 °C, ROADMAP Queue 3 item 4)
and the duty traces equal.  The rest ports ``tests/test_policy.py``'s
semantics.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.policy as JP
import repro_torch.policy as P
from repro.core import cosim as jcosim
from repro.core import models as JM
from repro.stack import feedback as jfb
from repro.stack.spec import dram_on_logic as j_dram_on_logic
from repro_torch import interop
from repro_torch.stack import feedback as tfb
from repro_torch.stack.spec import dram_on_logic as t_dram_on_logic

GRID_N, MARGIN, N_INT, DT = 8, 2, 10, 0.25 / 10
#: peaks of a replay with the CG converged (n_cg=120) [°C]
CONVERGED_ATOL_C = 1e-3
#: every controller of the registry but "guarded" (not ported), and the
#: reference's instance of each
CONTROLLERS = [n for n in P.names() if n != "guarded"]


# ---------------------------------------------------------------------------
# act against the reference's, case by case
# ---------------------------------------------------------------------------

#: five layers: logic, DRAM, DRAM, spreader-like (neither), logic; the
#: cases differ in which layers are which
LOGIC = np.array([[1, 0, 0, 0, 1], [1, 0, 0, 0, 0], [0, 0, 0, 0, 1],
                  [1, 0, 0, 0, 0]], np.float32)
DRAMS = np.array([[0, 1, 1, 0, 0], [0, 1, 0, 0, 0], [0, 1, 1, 0, 0],
                  [0, 0, 0, 0, 0]], np.float32)


def _temperatures(seed: int, n: int = 12) -> np.ndarray:
    """[n, B, L] float32 hot spots straddling every controller's trip
    (80-100 °C), from a seeded generator."""
    rng = np.random.default_rng(seed)
    return (75.0 + 30.0 * rng.random((n,) + LOGIC.shape)).astype(np.float32)


def _forecast(seed: int):
    """Per-case affine forecasts ``base + f·gain`` [°C], float32."""
    rng = np.random.default_rng(seed)
    base = (70.0 + 20.0 * rng.random(LOGIC.shape[0])).astype(np.float32)
    gain = (5.0 + 30.0 * rng.random(LOGIC.shape[0])).astype(np.float32)
    return base, gain


def _port_ctx(T, base, gain):
    def hot(cands):
        return torch.from_numpy(base)[:, None] \
            + cands[None, :] * torch.from_numpy(gain)[:, None]
    return P.PolicyContext(layer_T=torch.from_numpy(T),
                           logic_mask=torch.from_numpy(LOGIC),
                           dram_mask=torch.from_numpy(DRAMS),
                           predict_hot=hot)


def _ref_ctx(T, base, gain, b):
    return JP.PolicyContext(
        layer_T=jnp.asarray(T[b]), logic_mask=jnp.asarray(LOGIC[b]),
        dram_mask=jnp.asarray(DRAMS[b]),
        predict_hot=lambda c: jnp.float32(base[b]) + c * jnp.float32(gain[b]))


def _leaves(state):
    if isinstance(state, tuple):
        return [x for s in state for x in _leaves(s)]
    return [state]


def _run_both(name: str, temps: np.ndarray, seed: int = 1):
    """Drive the port's controller over the batch and the reference's
    over each case; yield (interval, port outputs, reference outputs per
    case)."""
    pol, jpol = P.get(name), JP.get(name)
    base, gain = _forecast(seed)
    B = LOGIC.shape[0]
    state = pol.init_state(LOGIC.shape[1])
    jstates = [jpol.init_state(LOGIC.shape[1]) for _ in range(B)]
    for i, T in enumerate(temps):
        state, fp, ff = pol.act(state, _port_ctx(T, base, gain))
        ref = []
        for b in range(B):
            jstates[b], jfp, jff = jpol.act(jstates[b],
                                            _ref_ctx(T, base, gain, b))
            ref.append((jstates[b], jfp, jff))
        yield i, (state, fp, ff), ref


@pytest.mark.parametrize("name", CONTROLLERS)
def test_act_matches_reference_case_by_case(name):
    temps = _temperatures(0)
    seen = set()
    for i, (state, fp, ff), ref in _run_both(name, temps):
        assert fp.dtype == ff.dtype == torch.float32
        assert ff.shape == (LOGIC.shape[0],)
        for b, (jstate, jfp, jff) in enumerate(ref):
            jfp = np.broadcast_to(np.asarray(jfp), LOGIC.shape[1:]) \
                if fp.dim() == 2 else np.asarray(jfp)
            got_fp = fp[b].numpy()
            np.testing.assert_array_equal(got_fp, jfp, f"{name} f_power "
                                          f"interval {i} case {b}")
            assert float(ff[b]) == float(jff), (name, i, b)
            for s, js in zip(_leaves(state), _leaves(jstate)):
                assert float(s[b]) == float(js), (name, "state", i, b)
            seen.add(float(ff[b]))
    if name != "ramp":           # the batch straddles every trip
        assert len(seen) > 1, name


def test_predictive_candidates_are_the_references():
    """The duty candidates bit for bit as the reference's replay makes
    them: inside jit, where XLA folds the constant ``linspace``."""
    import jax
    from repro_torch.policy.controllers import _float32_linspace
    for floor, n in ((0.25, 8), (0.1, 2), (0.3, 13), (0.05, 17), (0.2, 11)):
        want = np.asarray(jax.jit(lambda: jnp.linspace(
            jnp.float32(floor), jnp.float32(1.0), n))())
        np.testing.assert_array_equal(
            np.array(_float32_linspace(floor, 1.0, n), np.float32), want)


def _hyst_temps() -> np.ndarray:
    """Four cases on one logic layer whose latches part: at interval 2
    cases 0 and 1 read the same 88 °C inside the band, one held
    throttled and the other held free."""
    seq = [[80, 80, 95, 87], [91, 80, 87, 87], [88, 88, 87, 87],
           [86, 92, 80, 87], [84, 88, 87, 87]]
    T = np.zeros((len(seq), 4, 5), np.float32)
    T[:, :, 0] = np.array(seq, np.float32)
    T[:, :, 4] = T[:, :, 0]
    return T


@pytest.mark.parametrize("name", ["hysteresis", "pid", "dvfs"])
def test_each_case_carries_its_own_state(name):
    """The cases' stateful decisions part (a state shared across the
    batch could not give these answers): every case of the batch run
    equals the same case run alone, and the reference's."""
    kw = {"hysteresis": dict(trip_C=90.0, band_C=5.0),
          "pid": {}, "dvfs": dict(trip_C=85.0, band_C=4.0)}[name]
    pol = {"hysteresis": P.HysteresisPolicy, "pid": P.PIDPolicy,
           "dvfs": P.DVFSPolicy}[name](**kw)
    jpol = {"hysteresis": JP.HysteresisPolicy, "pid": JP.PIDPolicy,
            "dvfs": JP.DVFSPolicy}[name](**kw)
    temps = _hyst_temps()
    logic = torch.tensor([[1.0, 0, 0, 0, 1]]).expand(4, 5).contiguous()
    none = torch.zeros(4, 5)
    state = pol.init_state()
    alone = [pol.init_state() for _ in range(4)]
    jstates = [jpol.init_state() for _ in range(4)]
    parted = False
    for T in temps:
        Tt = torch.from_numpy(T)
        state, _, f = pol.act(state, P.PolicyContext(Tt, logic, none, None))
        for b in range(4):
            alone[b], _, fb = pol.act(alone[b], P.PolicyContext(
                Tt[b:b + 1], logic[b:b + 1], none[b:b + 1], None))
            jstates[b], _, jf = jpol.act(jstates[b], JP.PolicyContext(
                jnp.asarray(T[b]), jnp.asarray(logic[b].numpy()),
                jnp.zeros(5), None))
            assert float(f[b]) == float(fb[0]) == float(jf), (name, b)
        parted |= len(set(f.tolist())) > 1
        for s in _leaves(state):
            assert s.shape == (4,)
    assert parted
    if name == "hysteresis":     # interval 2: 88 °C held both ways
        s = pol.init_state()
        for T in temps[:3]:
            s, _, f = pol.act(s, P.PolicyContext(torch.from_numpy(T), logic,
                                                 none, None))
        assert f[:2].tolist() == [0.25, 1.0]


def test_dvfs_tables_cross_to_the_device_once():
    from repro_torch.policy.controllers import _device_floats
    pol = P.DVFSPolicy()
    _device_floats.cache_clear()
    for _, _, _ in _run_both("dvfs", _temperatures(2, n=4)):
        pass
    assert _device_floats.cache_info().misses == 2      # power, perf
    assert pol.name == JP.DVFSPolicy().name == "dvfs-22nm"


# ---------------------------------------------------------------------------
# the replay, per controller, against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dmm_cases():
    """The reference's dmm AP and SIMD cases on two DRAM dies (the SIMD
    runs hot enough that every controller acts), and the same leaves for
    the port."""
    spec = j_dram_on_logic(2)
    dp = jcosim.comparable_design_point("dmm")
    traces = {"ap": jcosim.ap_workload_trace("dmm", N_INT),
              "simd": jcosim.simd_phase_trace(JM.WORKLOADS["dmm"], dp,
                                              N_INT)}
    jcases = [(f"dmm/{m}", jfb.assemble_case(
        dp, "dmm", m, spec, jfb.PAPER_STACK, GRID_N, traces[m], MARGIN))
        for m in ("ap", "simd")]
    tcases = [(label, interop.case_from_reference(
        [*leaves[:4], {k: np.asarray(v) for k, v in leaves[4].items()},
         np.asarray(leaves[5])], "cpu")) for label, leaves in jcases]
    return jcases, tcases


def _replays(cases, name, n_cg, **fb_kw):
    jcases, tcases = cases
    jpol = None if name is None else JP.get(name)
    tpol = None if name is None else P.get(name)
    kw = dict(steps_per_interval=1, n_cg=n_cg, margin=MARGIN)
    ref = jfb.replay_cases(jcases, j_dram_on_logic(2),
                           jfb.FeedbackParams(policy=jpol, **fb_kw), GRID_N,
                           DT, **kw)
    got = tfb.replay_cases(tcases, t_dram_on_logic(2),
                           tfb.FeedbackParams(policy=tpol, **fb_kw), GRID_N,
                           DT, device="cpu", **kw)
    return ref, got


@pytest.mark.parametrize("name", CONTROLLERS)
def test_replay_matches_reference(dmm_cases, name):
    ref, got = _replays(dmm_cases, name, n_cg=120)
    for label in ref:
        r, g = ref[label], got[label]
        np.testing.assert_allclose(g.peak_C, r.peak_C, rtol=0,
                                   atol=CONVERGED_ATOL_C, err_msg=label)
        np.testing.assert_allclose(g.throttle, r.throttle, rtol=0,
                                   atol=1e-6, err_msg=label)
        np.testing.assert_allclose(g.dyn_W, r.dyn_W, rtol=1e-5,
                                   err_msg=label)
        assert (g.dram_time_above_limit_s > 0) \
            == (r.dram_time_above_limit_s > 0), label
    if name not in ("ramp", "step"):
        # the hot SIMD case throttles under every controller
        assert (got["dmm/simd"].throttle < 1.0).any(), name


@pytest.mark.parametrize("fb_kw", [
    {}, dict(leak_beta=0.0, n_picard=2, dtm_trip_C=math.inf,
             refresh_feedback=False), dict(dt_scale=True)],
    ids=["tripping", "disabled", "dt_scale"])
def test_default_ramp_replay_matches_reference(dmm_cases, fb_kw):
    """The default controller (policy=None, the historical ramp the
    reference pins bit-identical to its legacy loop), the disabled loop
    and the variable-step path (a dt_scale of ones, each case on its
    own: bit for bit the port's fixed-step replay), against the
    reference's replay."""
    if fb_kw.pop("dt_scale", False):
        jcases, tcases = dmm_cases
        for (label, jl), (_, tl) in zip(jcases, tcases):
            kw = dict(die_n=GRID_N, n_die=3, steps_per_interval=1,
                      n_cg=120, margin=MARGIN)
            ref = jfb.closed_loop_replay(
                *(jnp.asarray(x) for x in jl[:4]), jl[4], jl[5], DT,
                fb=jfb.FeedbackParams(), dt_scale=jnp.ones(N_INT), **kw)
            fixed, scaled = (tfb.closed_loop_replay(
                *(torch.as_tensor(np.asarray(x, np.float32))
                  for x in tl[:4]), tl[4], tl[5], DT,
                fb=tfb.FeedbackParams(), dt_scale=s, **kw)
                for s in (None, np.ones(N_INT, np.float32)))
            for x, y in zip(fixed, scaled):
                assert torch.equal(x, y), label
            np.testing.assert_allclose(scaled[1].numpy(),
                                       np.asarray(ref[1]), rtol=0,
                                       atol=CONVERGED_ATOL_C)
            np.testing.assert_array_equal(scaled[4].numpy(),
                                          np.asarray(ref[4]))
        return
    ref, got = _replays(dmm_cases, None, n_cg=120, **fb_kw)
    for label in ref:
        np.testing.assert_allclose(got[label].peak_C, ref[label].peak_C,
                                   rtol=0, atol=CONVERGED_ATOL_C)
        np.testing.assert_array_equal(got[label].throttle,
                                      ref[label].throttle)
    if not fb_kw:                           # the pin has teeth
        assert (got["dmm/simd"].throttle < 1.0).any()


# ---------------------------------------------------------------------------
# tests/test_policy.py's semantics on the port
# ---------------------------------------------------------------------------

def test_registry_names_and_guarded():
    assert P.names() == JP.names()
    assert "guarded" in P.names()
    guarded = P.get("guarded")
    assert type(guarded).__name__ == type(JP.get("guarded")).__name__
    assert guarded.name == JP.get("guarded").name == "guarded-perdie"
    with pytest.raises(ValueError, match="unknown policy"):
        P.get("nope")
    for name in CONTROLLERS:
        assert type(P.get(name)).__name__ == type(JP.get(name)).__name__
        assert P.get(name) == P.get(name)          # fresh, equal instances
    assert P.get("step") == P.RampPolicy(ramp_C=0.0)


def test_policy_constructors_validate():
    with pytest.raises(ValueError, match="floor"):
        P.RampPolicy(floor=0.0)
    with pytest.raises(ValueError, match="trip_C"):
        P.HysteresisPolicy(trip_C=math.nan)
    with pytest.raises(ValueError, match="band_C"):
        P.DVFSPolicy(band_C=-1.0)
    with pytest.raises(ValueError, match="n_cands"):
        P.PredictivePolicy(n_cands=1)
    with pytest.raises(ValueError, match="gains"):
        P.PIDPolicy(kp=-1.0)
    with pytest.raises(ValueError, match="ramp widths"):
        P.PerDiePolicy(dram_ramp_C=-1.0)
    # every controller is accepted by the replay's parameters now
    for name in P.names():
        tfb.FeedbackParams(policy=P.get(name))


def _ctx1(t):
    """One case: a logic layer at ``t`` and a DRAM layer at 0 °C."""
    return P.PolicyContext(layer_T=torch.tensor([[t, 0.0]]),
                           logic_mask=torch.tensor([[1.0, 0.0]]),
                           dram_mask=torch.tensor([[0.0, 1.0]]),
                           predict_hot=None)


def test_hysteresis_holds_inside_band():
    pol = P.HysteresisPolicy(trip_C=90.0, band_C=5.0, floor=0.25)
    s = pol.init_state()
    s, f, _ = pol.act(s, _ctx1(80.0))
    assert float(f) == 1.0
    s, f, _ = pol.act(s, _ctx1(91.0))         # trips
    assert float(f) == 0.25
    for t in (88.0, 86.0, 89.9, 85.1):        # dwell inside the band
        s, f, _ = pol.act(s, _ctx1(t))
        assert float(f) == 0.25
    s, f, _ = pol.act(s, _ctx1(84.9))         # below trip - band
    assert float(f) == 1.0
    for t in (86.0, 89.0):                    # band from below: held
        s, f, _ = pol.act(s, _ctx1(t))
        assert float(f) == 1.0


def test_pid_regulates_toward_target():
    pol = P.PIDPolicy(target_C=90.0, floor=0.25)
    s = pol.init_state()
    duties = []
    for _ in range(10):
        s, f, _ = pol.act(s, _ctx1(100.0))
        duties.append(float(f))
    assert duties[-1] <= duties[0] and duties[-1] == 0.25
    for _ in range(60):
        s, f, _ = pol.act(s, _ctx1(40.0))
    assert float(f) == 1.0


def test_dvfs_policy_steps_one_op_per_interval():
    pol = P.DVFSPolicy(trip_C=85.0, band_C=4.0)
    s = pol.init_state()
    top = pol.table.n_ops - 1
    s, fp, ff = pol.act(s, _ctx1(100.0))      # hot: step down once
    assert int(s) == top - 1
    assert float(fp) < float(ff) < 1.0        # f·V² < f at a lower OP
    s, _, _ = pol.act(s, _ctx1(83.0))         # in band: hold
    assert int(s) == top - 1
    s, _, _ = pol.act(s, _ctx1(60.0))         # cool: step back up
    assert int(s) == top


def test_dvfs_table_and_residency():
    for node in P.nodes():
        t, jt = P.build_dvfs_table(node), JP.build_dvfs_table(node)
        assert t.power_scales() == jt.power_scales()
        assert t.perf_scales() == jt.perf_scales()
        assert t.labels() == jt.labels()
        ps, fs = t.power_scales(), t.perf_scales()
        assert ps[-1] == 1.0 and fs[-1] == 1.0
        assert all(p < s for p, s in zip(ps[:-1], fs[:-1]))
    op = P.OperatingPoint
    with pytest.raises(ValueError, match=">= 2 operating points"):
        P.DVFSTable("x", (op(1000, 1.0),))
    with pytest.raises(ValueError, match="sorted"):
        P.DVFSTable("x", (op(2000, 1.0), op(1000, 0.8)))
    with pytest.raises(ValueError, match="unknown technology node"):
        P.build_dvfs_table("7nm")
    pol = P.DVFSPolicy()
    fs = pol.table.perf_scales()
    duty = np.array([fs[-1], fs[-1], fs[0], fs[1] + 1e-4])
    assert pol.residency(duty) == JP.DVFSPolicy().residency(duty)
    labels = pol.table.labels()
    assert pol.residency(duty)[labels[-1]] == 2
    assert P.RampPolicy().residency(duty) is None


def test_perdie_policy_cools_dram_below_ramp(dmm_cases):
    """The per-die controller senses the DRAM dies directly and drags
    logic down with them: at the settled final interval the SIMD's DRAM
    hot spot is cooler than under the logic-sensed ramp."""
    _, tcases = dmm_cases
    spec = t_dram_on_logic(2)
    kw = dict(steps_per_interval=1, n_cg=20, margin=MARGIN, device="cpu")
    ramp = tfb.replay_cases(tcases, spec, tfb.FeedbackParams(), GRID_N, DT,
                            **kw)["dmm/simd"]
    pd = tfb.replay_cases(tcases, spec, tfb.FeedbackParams(
        policy=P.PerDiePolicy()), GRID_N, DT, **kw)["dmm/simd"]
    assert pd.dram_peak_C[-1] < ramp.dram_peak_C[-1] - 1.0
    # and the hysteresis latch threads through the replay's loop
    hy = tfb.replay_cases(tcases, spec, tfb.FeedbackParams(
        policy=P.HysteresisPolicy(trip_C=70.0, band_C=5.0, floor=0.25)),
        GRID_N, DT, **kw)["dmm/simd"]
    assert set(np.unique(hy.throttle)) <= {np.float32(0.25), np.float32(1.0)}
    assert (hy.throttle == 0.25).any()


def test_predictive_policy_cuts_peak_overshoot(dmm_cases):
    _, tcases = dmm_cases
    spec = t_dram_on_logic(2)
    kw = dict(steps_per_interval=1, n_cg=20, margin=MARGIN, device="cpu")
    ramp = tfb.replay_cases(tcases, spec, tfb.FeedbackParams(), GRID_N, DT,
                            **kw)["dmm/simd"]
    pr = tfb.replay_cases(tcases, spec, tfb.FeedbackParams(
        policy=P.PredictivePolicy(trip_C=95.0)), GRID_N, DT,
        **kw)["dmm/simd"]
    assert pr.peak_C.max() < ramp.peak_C.max() - 5.0
    assert (pr.throttle >= 0.25).all() and (pr.throttle <= 1.0).all()


def test_energy_accounting(dmm_cases):
    """dyn_W: full duty dissipates the frame power exactly; throttling
    strictly reduces it; energy_per_work_J penalizes the slowdown."""
    _, tcases = dmm_cases
    spec = t_dram_on_logic(2)
    kw = dict(steps_per_interval=1, n_cg=20, margin=MARGIN, device="cpu")
    free = tfb.replay_cases(tcases, spec, tfb.FeedbackParams(
        dtm_trip_C=math.inf), GRID_N, DT, **kw)["dmm/simd"]
    hot = tfb.replay_cases(tcases, spec, tfb.FeedbackParams(), GRID_N, DT,
                           **kw)["dmm/simd"]
    frames = tcases[1][1][0].numpy()
    np.testing.assert_allclose(free.dyn_W, frames.sum(axis=(1, 2, 3)),
                               rtol=1e-5)
    assert hot.dyn_W.sum() < free.dyn_W.sum()
    assert hot.energy_per_work_J > hot.energy_J > 0.0


def test_pareto_front_matches_reference():
    pts = [(1.0, 95.0, 5.0), (2.0, 80.0, 4.0), (2.5, 96.0, 6.0),
           (1.0, 95.0, 5.0)]
    assert P.pareto_front(pts) == JP.pareto_front(pts) == (0, 1, 3)
    rng = np.random.default_rng(5)
    cloud = [tuple(p) for p in rng.random((40, 3)).round(2)]
    assert P.pareto_front(cloud) == JP.pareto_front(cloud)
    assert P.dominates((1, 1, 1), (2, 2, 2))
    with pytest.raises(ValueError, match="dimension"):
        P.dominates((1.0,), (1.0, 2.0))
