"""PyTorch port vs the JAX reference: fault injection and graceful
degradation (``repro_torch.faults``).

The semantics of the reference's ``tests/test_faults.py`` on the port,
and parity on the same inputs:

- **Seeded randomness.**  The port's threefry2x32 key chain, ``split``,
  random bits, ``uniform`` and dropout masks are ``jax.random``'s bit for
  bit; ``normal`` goes through XLA's float32 ``erf_inv`` polynomial,
  repeated in PyTorch, whose ``log1p`` and rounding differ in the last
  bits: held within ``NORMAL_ULP`` ulp.  Sensor readings are held bit for
  bit where no normal draw enters them, else within the same ulp bound
  of the draw times its sigma.
- **GuardedPolicy** fuses with the reference's ``nanmedian`` (the mean of
  the two valid readings of three, where ``torch.nanmedian`` would give
  the lower): states and duties equal to the reference's.
- **Replays** of the ``bench_faults.py`` grid: every verdict equal, DRAM
  peaks within ``PEAK_ATOL_C`` (float32 CG of 25 iterations summed in
  another order: up to 0.09 °C measured at this size, where the guard's
  dropout hold multiplies it), ``n_guard_rescued`` equal.
- **Solver fallback**: the ``thermal/fallback/*`` counters equal.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

import repro.faults as JF
from repro import obs as jobs
from repro.core import cosim as jcosim
from repro.core import models as JM
from repro.core import thermal as jthermal
from repro.policy import PerDiePolicy as JPerDie
from repro.policy.base import PolicyContext as JContext
from repro.stack import feedback as jfb
from repro.stack.spec import PAPER_STACK as J_PAPER_STACK
from repro.stack.spec import dram_on_logic as j_dram_on_logic
from repro_torch import interop, obs
from repro_torch.core import thermal
from repro_torch.faults import (GuardedPolicy, PowerFaultSpec,
                                SensorFaultSpec, inject_power_spikes,
                                poison_solver, solver_poisoned)
from repro_torch.faults import models as fm
from repro_torch.faults.guard import nanmedian
from repro_torch.policy import POLICIES, PerDiePolicy
from repro_torch.policy.base import Policy, PolicyContext
from repro_torch.stack import feedback
from repro_torch.stack.spec import dram_on_logic

pytestmark = pytest.mark.faults

NORMAL_ULP = 4
PEAK_ATOL_C = 0.1


def _ulp(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


# ------------------------------------------------------------ spec validation

@pytest.mark.parametrize("kw", [
    {"n_sensors": 0}, {"noise_C": -1.0}, {"noise_C": float("nan")},
    {"offset_C": float("inf")}, {"drift_C": float("nan")},
    {"quant_C": -0.5}, {"n_stuck": -1}, {"n_stuck": 4},
    {"p_dropout": 1.5}, {"p_dropout": float("nan")},
])
def test_sensor_spec_rejects_bad_knobs(kw):
    with pytest.raises(ValueError):
        SensorFaultSpec(**kw)
    with pytest.raises(ValueError):
        JF.SensorFaultSpec(**kw)


@pytest.mark.parametrize("kw", [
    {"n_spikes": -1}, {"width": 0}, {"magnitude": float("nan")},
    {"magnitude": -2.0},
])
def test_power_spec_rejects_bad_knobs(kw):
    with pytest.raises(ValueError):
        PowerFaultSpec(**kw)


def test_spec_is_hashable_static():
    a = SensorFaultSpec(seed=3, noise_C=0.5)
    assert hash(a) == hash(SensorFaultSpec(seed=3, noise_C=0.5))
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.seed = 4
    assert not SensorFaultSpec().randomized
    assert SensorFaultSpec(noise_C=0.1).randomized
    assert SensorFaultSpec(p_dropout=0.1).randomized
    assert [f.name for f in dataclasses.fields(SensorFaultSpec)] \
        == [f.name for f in dataclasses.fields(JF.SensorFaultSpec)]


# ------------------------------------------------- the generator, bit for bit

@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 - 1])
def test_keys_bits_and_uniform_are_jax_randoms(seed):
    jk, tk = jax.random.PRNGKey(seed), fm.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk, np.int64))
    for num in (2, 3):
        np.testing.assert_array_equal(
            fm.split(tk, num).numpy(),
            np.asarray(jax.random.split(jk, num), np.int64))
    jsub, tsub = jax.random.split(jk)[1], fm.split(tk)[1]
    for shape in [(3,), (3, 5), (2, 4, 6)]:
        np.testing.assert_array_equal(
            fm.random_bits(tsub, shape).numpy(),
            np.asarray(jax.random.bits(jsub, shape), np.int64))
        got = fm.uniform(tsub, shape).numpy()
        assert _ulp(got, jax.random.uniform(jsub, shape)) == 0
        drop = fm.uniform(tsub, shape) < 0.4
        np.testing.assert_array_equal(
            drop.numpy(), np.asarray(jax.random.uniform(jsub, shape) < 0.4))


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_normal_is_jax_normal_within_ulps(seed):
    jk = jax.random.split(jax.random.PRNGKey(seed))[0]
    tk = fm.split(fm.PRNGKey(seed))[0]
    for shape in [(3,), (3, 7), (5, 40)]:
        got = fm.normal(tk, shape).numpy()
        want = np.asarray(jax.random.normal(jk, shape))
        assert _ulp(got, want) <= NORMAL_ULP, shape


def test_erfinv_is_xlas_within_ulps():
    from jax import lax
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1, 1, 20000),
                        1 - np.logspace(-7, -1, 200),
                        -1 + np.logspace(-7, -1, 200),
                        [0.0, 1.0, -1.0]]).astype(np.float32)
    got = fm.erfinv(torch.from_numpy(x)).numpy()
    want = np.asarray(lax.erf_inv(jnp.asarray(x)))
    assert _ulp(got, want) <= NORMAL_ULP


# --------------------------------------------------- read() fault semantics

def _scan_read(spec, T_path):
    """spec.read over a [T, L] true-temperature path -> [T, K, L]."""
    state = spec.init_state(T_path.shape[1])
    out = []
    for T in np.asarray(T_path, np.float32):
        state, r = spec.read(state, torch.from_numpy(T))
        out.append(r.numpy())
    return np.stack(out)


def _jscan_read(spec, T_path):
    def step(state, T):
        return spec.read(state, T)
    _, out = jax.lax.scan(step, spec.init_state(T_path.shape[1]),
                          jnp.asarray(T_path, jnp.float32))
    return np.asarray(out)


def test_stuck_at_latches_first_reading():
    spec = SensorFaultSpec(n_sensors=3, n_stuck=1)
    path = np.stack([np.full(4, 30.0), np.full(4, 90.0)])
    out = _scan_read(spec, path)
    np.testing.assert_array_equal(out[1, 0], 30.0)
    np.testing.assert_array_equal(out[1, 1:], 90.0)


def test_quantization_snaps_to_step():
    spec = SensorFaultSpec(n_sensors=2, quant_C=0.5)
    out = _scan_read(spec, np.array([[31.26, 47.13]]))
    np.testing.assert_array_equal(out % 0.5, 0.0)
    np.testing.assert_allclose(out[0, 0], [31.5, 47.0])


def test_dropout_returns_nan():
    heavy = _scan_read(SensorFaultSpec(n_sensors=3, p_dropout=0.5),
                       np.full((20, 2), 50.0))
    clean = _scan_read(SensorFaultSpec(n_sensors=3), np.full((20, 2), 50.0))
    assert np.isnan(heavy).any()
    assert np.isfinite(clean).all()
    np.testing.assert_array_equal(clean, 50.0)


def test_drift_and_offset_compose():
    spec = SensorFaultSpec(n_sensors=2, drift_C=0.5, offset_C=1.0)
    out = _scan_read(spec, np.full((3, 1), 40.0))
    off = spec.init_state(1).offset.numpy()
    for t in range(3):
        np.testing.assert_allclose(out[t, :, 0], 40.0 + off + 0.5 * t,
                                   rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(seed=3, n_stuck=1, p_dropout=0.3),
    dict(seed=11, quant_C=0.25, drift_C=0.125, n_stuck=2),
    dict(seed=5, p_dropout=0.9, n_sensors=5),
], ids=["stuck+dropout", "quant+drift", "heavy_dropout"])
def test_readings_are_the_references_bit_for_bit(kw):
    """No normal draw: stuck latches, quantisation, drift and the dropout
    masks are the reference's exactly."""
    path = np.linspace(25.0, 95.0, 7 * 4).reshape(7, 4)
    got = _scan_read(SensorFaultSpec(**kw), path)
    want = _jscan_read(JF.SensorFaultSpec(**kw), path)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 4])
def test_noisy_readings_match_the_reference(seed):
    """With noise and an offset, every reading within the normal draw's
    ulp bound (times sigma) of the reference's; the dropout masks equal."""
    kw = dict(seed=seed, noise_C=1.0, offset_C=0.5, p_dropout=0.2)
    path = np.linspace(25.0, 95.0, 6 * 3).reshape(6, 3)
    got = _scan_read(SensorFaultSpec(**kw), path)
    want = _jscan_read(JF.SensorFaultSpec(**kw), path)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0,
                               atol=NORMAL_ULP * 2e-6 * 100)


@settings(max_examples=15)
@given(seed=st.integers(0, 2**31 - 1),
       noise=st.floats(0.0, 5.0, allow_nan=False),
       p_drop=st.floats(0.0, 0.9, allow_nan=False),
       n_stuck=st.integers(0, 3))
def test_seeded_read_is_bitwise_reproducible(seed, noise, p_drop, n_stuck):
    spec = SensorFaultSpec(seed=seed, n_sensors=3, noise_C=noise,
                           p_dropout=p_drop, n_stuck=n_stuck)
    path = np.linspace(25.0, 95.0, 6 * 4).reshape(6, 4)
    np.testing.assert_array_equal(_scan_read(spec, path),
                                  _scan_read(spec, path))


def test_different_seeds_differ_when_randomized():
    path = np.full((8, 2), 60.0)
    a = _scan_read(SensorFaultSpec(seed=0, noise_C=1.0), path)
    b = _scan_read(SensorFaultSpec(seed=1, noise_C=1.0), path)
    assert not np.array_equal(a, b)


def test_every_case_of_a_batch_reads_the_same_draws():
    """The reference vmaps init_state, so every case of a batch reads the
    same key chain: a [B, L] read gives each case what its own [L] read
    gives, while the stuck latch stays per case."""
    spec = SensorFaultSpec(seed=2, n_stuck=1, p_dropout=0.5)
    T = torch.tensor([[40.0, 50.0], [60.0, 70.0], [80.0, 90.0]])
    state_b = spec.init_state(2)
    singles = [spec.init_state(2) for _ in range(3)]
    for t in range(4):
        state_b, rb = spec.read(state_b, T + t)
        for b in range(3):
            singles[b], r1 = spec.read(singles[b], T[b] + t)
            np.testing.assert_array_equal(rb[b].numpy(), r1.numpy())
    assert state_b.latch.shape == (3, 3, 2)
    assert np.isnan(rb.numpy()).any()


# ----------------------------------------------------- power-spike injection

def test_power_spikes_deterministic_and_pure():
    dyn = np.ones((10, 2, 3, 3), np.float32)
    spec = PowerFaultSpec(seed=7, n_spikes=3, magnitude=2.5)
    out = inject_power_spikes(dyn, spec)
    np.testing.assert_array_equal(out, inject_power_spikes(dyn, spec))
    np.testing.assert_array_equal(dyn, 1.0)
    assert (out[:, 0, 0, 0] == 2.5).sum() == 3
    np.testing.assert_array_equal(np.unique(out), [1.0, 2.5])
    np.testing.assert_array_equal(inject_power_spikes(
        dyn, PowerFaultSpec(n_spikes=0)), dyn)
    np.testing.assert_array_equal(
        inject_power_spikes(dyn, PowerFaultSpec(n_spikes=99)), 2.0)
    np.testing.assert_array_equal(out, JF.inject_power_spikes(
        dyn, JF.PowerFaultSpec(seed=7, n_spikes=3, magnitude=2.5)))


# ----------------------------------------------------------- GuardedPolicy

def _ctx(layer_T, sensor_T=None):
    """One case, its layers all logic."""
    L = len(layer_T)
    return PolicyContext(
        layer_T=torch.tensor([layer_T], dtype=torch.float32),
        logic_mask=torch.ones((1, L)), dram_mask=torch.zeros((1, L)),
        predict_hot=None,
        sensor_T=None if sensor_T is None
        else torch.tensor([sensor_T], dtype=torch.float32))


def test_guard_needs_n_layers():
    with pytest.raises(ValueError, match="n_layers"):
        GuardedPolicy().init_state()
    st3 = GuardedPolicy().init_state(3)
    assert st3[1].shape == (3,) and st3[2].shape == (3,)


@pytest.mark.parametrize("kw", [
    {"floor": 0.0}, {"floor": 1.5}, {"hold_max": 0},
    {"max_step_C": 0.0}, {"max_step_C": float("nan")},
    {"lo_C": 50.0, "hi_C": 40.0}, {"hi_C": float("inf")},
])
def test_guard_rejects_bad_knobs(kw):
    with pytest.raises(ValueError):
        GuardedPolicy(**kw)


def test_guard_median_rejects_stuck_minority():
    g = GuardedPolicy()
    state = g.init_state(2)
    sensors = [[25.0, 25.0], [80.0, 80.0], [80.0, 80.0]]
    state, _, _ = g.act(state, _ctx([25.0, 25.0], sensors))
    np.testing.assert_allclose(state[1].numpy(), 80.0)
    np.testing.assert_array_equal(state[2].numpy(), 0)


def test_guard_nan_holds_last_good_then_panics():
    g = GuardedPolicy(hold_max=2)
    state = g.init_state(1)
    state, _, _ = g.act(state, _ctx([70.0], [[70.0]]))
    nan_ctx = _ctx([np.nan], [[np.nan]])
    state, f_p, f = g.act(state, nan_ctx)
    assert float(state[1][0, 0]) == 70.0 and int(state[2][0, 0]) == 1
    assert float(f) == 1.0
    state, f_p, f = g.act(state, nan_ctx)
    assert int(state[2][0, 0]) == 2
    assert float(f_p) == float(f) == g.floor


def test_guard_implausible_jump_is_held():
    g = GuardedPolicy(max_step_C=60.0)
    state = g.init_state(1)
    state, _, _ = g.act(state, _ctx([30.0], [[30.0]]))
    state, _, _ = g.act(state, _ctx([130.0], [[130.0]]))
    assert float(state[1][0, 0]) == 30.0
    state, _, _ = g.act(state, _ctx([140.0], [[140.0]]))
    assert int(state[2][0, 0]) == 2


def test_guard_fault_free_passthrough():
    g = GuardedPolicy(inner=PerDiePolicy())
    state = g.init_state(2)
    state, f_p, f = g.act(state, _ctx([50.0, 60.0]))
    np.testing.assert_array_equal(state[1].numpy(), [[50.0, 60.0]])
    _, rf_p, rf = PerDiePolicy().act((), _ctx([50.0, 60.0]))
    assert torch.equal(f_p, rf_p) and torch.equal(f, rf)


def test_guard_fuses_one_dropout_as_the_references_mean():
    """One NaN among three sensors: jnp.nanmedian takes the MEAN of the
    two valid readings (torch.nanmedian would take the lower); states,
    duties and the panic count equal the reference's, interval by
    interval, on a [3, L] reading per case."""
    rng = np.random.default_rng(1)
    L, n = 4, 6
    logic = np.array([1, 0, 0, 0], np.float32)
    dram_m = np.array([0, 1, 1, 0], np.float32)
    readings = rng.uniform(60, 100, (n, 3, L)).astype(np.float32)
    readings[rng.random(readings.shape) < 0.3] = np.nan
    readings[2, :, 1] = np.nan                   # a blind DRAM layer
    one_nan = readings[0].copy()
    one_nan[:, 0] = [70.0, np.nan, 81.0]
    readings[0] = one_nan
    got = nanmedian(torch.from_numpy(one_nan), dim=0)
    assert float(got[0]) == 75.5
    assert float(torch.nanmedian(torch.from_numpy(one_nan), dim=0)
                 .values[0]) == 70.0
    jg, tg = JF.GuardedPolicy(inner=JPerDie()), GuardedPolicy(
        inner=PerDiePolicy())
    js, ts = jg.init_state(L), tg.init_state(L)
    for i in range(n):
        ctx = PolicyContext(
            layer_T=torch.from_numpy(readings[i, 0])[None],
            logic_mask=torch.from_numpy(logic)[None],
            dram_mask=torch.from_numpy(dram_m)[None], predict_hot=None,
            sensor_T=torch.from_numpy(readings[i])[None])
        jctx = JContext(layer_T=jnp.asarray(readings[i, 0]),
                        logic_mask=jnp.asarray(logic),
                        dram_mask=jnp.asarray(dram_m),
                        predict_hot=None,
                        sensor_T=jnp.asarray(readings[i]))
        ts, tfp, tf = tg.act(ts, ctx)
        js, jfp, jf = jg.act(js, jctx)
        np.testing.assert_array_equal(ts[1][0].numpy(), np.asarray(js[1]))
        np.testing.assert_array_equal(ts[2][0].numpy(), np.asarray(js[2]))
        np.testing.assert_array_equal(tfp[0].numpy(), np.asarray(jfp))
        assert float(tf[0]) == float(jf)


def test_nanmedian_is_jnp_nanmedian():
    rng = np.random.default_rng(0)
    x = rng.uniform(20, 100, (200, 5, 6)).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = np.nan
    for dim in (0, 1, 2):
        got = nanmedian(torch.from_numpy(x), dim=dim).numpy()
        want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=dim))
        np.testing.assert_array_equal(got, want)


def test_guarded_registered_in_policy_registry():
    pol = POLICIES["guarded"]()
    assert isinstance(pol, GuardedPolicy)
    assert pol.name == "guarded-perdie"


# ------------------------------------------------- replay-level integration

_GRID_N = 8
_N_INT = 16


@pytest.fixture(scope="module")
def fault_cases():
    """bench_faults.py's two scenarios on two DRAM dies, assembled by the
    reference, and the same leaves for the port."""
    spec = j_dram_on_logic(2, J_PAPER_STACK)
    margin = _GRID_N // 4
    jcases = []
    for wl, mc in (("sort", "ap"), ("dmm", "simd")):
        dp = jcosim.comparable_design_point(wl, 2 ** 20)
        trace = jcosim.ap_workload_trace(
            wl, _N_INT, jcosim.trace_elems(2 ** 20)) if mc == "ap" \
            else jcosim.simd_phase_trace(JM.WORKLOADS[wl], dp, _N_INT)
        jcases.append((f"{wl}/{mc}", jfb.assemble_case(
            dp, wl, mc, spec, J_PAPER_STACK, _GRID_N, trace, margin)))
    tcases = [(label, interop.case_from_reference(
        [*leaves[:4], {k: np.asarray(v) for k, v in leaves[4].items()},
         np.asarray(leaves[5])], "cpu")) for label, leaves in jcases]
    return jcases, tcases


def _replay(cases, fb, n_cg=25):
    return feedback.replay_cases(
        cases, dram_on_logic(2), fb, _GRID_N, 0.25 / _N_INT,
        steps_per_interval=1, n_cg=n_cg, margin=_GRID_N // 4, device="cpu")


def _jreplay(cases, fb, n_cg=25):
    return jfb.replay_cases(
        cases, j_dram_on_logic(2), fb, _GRID_N, 0.25 / _N_INT,
        steps_per_interval=1, n_cg=n_cg, margin=_GRID_N // 4)


def test_no_spec_runs_no_fault_code(fault_cases, monkeypatch):
    """FeedbackParams.faults=None keeps the replay the fault-free one:
    no fault state, no draw (the port's counterpart of the reference's
    no-random-ops jaxpr pin)."""
    calls = []
    real = fm.split
    monkeypatch.setattr(fm, "split", lambda *a: calls.append(1) or real(*a))
    _, tcases = fault_cases
    _replay(tcases[:1], feedback.FeedbackParams(), n_cg=3)
    assert not calls
    _replay(tcases[:1], feedback.FeedbackParams(
        faults=SensorFaultSpec(noise_C=0.5)), n_cg=3)
    assert len(calls) == _N_INT


def test_faulted_replay_is_deterministic(fault_cases):
    _, tcases = fault_cases
    fb = feedback.FeedbackParams(
        policy=PerDiePolicy(),
        faults=SensorFaultSpec(seed=5, noise_C=1.0, p_dropout=0.1))
    a, b = _replay(tcases, fb), _replay(tcases, fb)
    for label in a:
        np.testing.assert_array_equal(a[label].peak_C, b[label].peak_C)
        np.testing.assert_array_equal(a[label].throttle, b[label].throttle)


def test_stuck_sensor_rescue(fault_cases):
    """A stuck-at-ambient primary sensor blinds the naive per-die
    controller (DRAM blows the 85 C ceiling) while the guarded wrapper's
    median still sees the true temperature."""
    _, tcases = fault_cases
    case = tcases[:1]
    stuck = SensorFaultSpec(seed=0, n_sensors=3, n_stuck=1)
    naive = _replay(case, feedback.FeedbackParams(
        policy=PerDiePolicy(), faults=stuck))["sort/ap"]
    guarded = _replay(case, feedback.FeedbackParams(
        policy=GuardedPolicy(inner=PerDiePolicy()), faults=stuck))["sort/ap"]
    clean = _replay(case, feedback.FeedbackParams(
        policy=PerDiePolicy()))["sort/ap"]
    assert clean.dram_time_above_limit_s == 0.0
    assert naive.dram_time_above_limit_s > 0.0
    assert float(naive.throttle.min()) == 1.0
    assert guarded.dram_time_above_limit_s == 0.0
    assert float(guarded.dram_peak_C.max()) \
        == pytest.approx(float(clean.dram_peak_C.max()), abs=0.5)


def _verdict(rep) -> str:
    if not np.isfinite(rep.peak_C).all():
        return "FAILED"
    return "OK" if rep.dram_time_above_limit_s == 0.0 else "BLOCKED"


def test_bench_faults_grid_matches_reference(fault_cases):
    """bench_faults.py's grid (none / stuck / dropout x naive / guarded):
    every verdict and n_guard_rescued equal to the reference's, DRAM
    peaks within PEAK_ATOL_C, slowdowns within 1e-2."""
    jcases, tcases = fault_cases
    faults = {"none": (None, None),
              "stuck": (SensorFaultSpec(n_stuck=1),
                        JF.SensorFaultSpec(n_stuck=1)),
              "dropout": (SensorFaultSpec(p_dropout=0.4),
                          JF.SensorFaultSpec(p_dropout=0.4))}
    policies = {"naive": (PerDiePolicy(), JPerDie()),
                "guarded": (GuardedPolicy(inner=PerDiePolicy()),
                            JF.GuardedPolicy(inner=JPerDie()))}
    verdicts = {}
    for fname, (tf, jf) in faults.items():
        for pname, (tp, jp) in policies.items():
            got = _replay(tcases, feedback.FeedbackParams(policy=tp,
                                                          faults=tf))
            want = _jreplay(jcases, jfb.FeedbackParams(policy=jp, faults=jf))
            for label in want:
                g, w = got[label], want[label]
                cell = (label, fname, pname)
                verdicts[cell] = (_verdict(g), _verdict(w))
                assert verdicts[cell][0] == verdicts[cell][1], cell
                if verdicts[cell][1] != "FAILED":
                    assert abs(float(g.dram_peak_C.max())
                               - float(w.dram_peak_C.max())) <= PEAK_ATOL_C
                    assert g.dtm_slowdown == pytest.approx(w.dtm_slowdown,
                                                           abs=1e-2)
    rescued = [sum(1 for (label, f, p), v in verdicts.items()
                   if f != "none" and p == "naive" and v[k] != "OK"
                   and verdicts[(label, f, "guarded")][k] == "OK")
               for k in (0, 1)]
    assert rescued[0] == rescued[1] >= 1


def test_power_spike_raises_the_peak(fault_cases):
    """The spikes raise sort/ap's DRAM peak.  The spiked replay runs at
    130 °C, where 25 CG iterations leave the two packages 0.26 °C apart
    (ROADMAP Queue 3, item 7's hot cases): the spiked peak is held to the
    reference's with the CG converged (n_cg=120), to 1e-3 °C."""
    jcases, tcases = fault_cases
    label, (dyn, l0, r0, lm, F, cap3) = tcases[0]
    spec = PowerFaultSpec(seed=0, n_spikes=2, magnitude=3.0)
    spiked = inject_power_spikes(dyn, spec)
    fb = feedback.FeedbackParams(policy=PerDiePolicy())
    base, bump = (_replay([(label, (d, l0, r0, lm, F, cap3))], fb)[label]
                  for d in (dyn, spiked))
    assert bump.dram_peak_C.max() > base.dram_peak_C.max() + 10.0
    twin = _replay([(label, (spiked, l0, r0, lm, F, cap3))], fb,
                   n_cg=120)[label]
    jl = jcases[0][1]
    jtwin = _jreplay([(label, (JF.inject_power_spikes(
        jl[0], JF.PowerFaultSpec(seed=0, n_spikes=2, magnitude=3.0)),
        *jl[1:]))], jfb.FeedbackParams(policy=JPerDie()), n_cg=120)[label]
    assert abs(float(twin.dram_peak_C.max())
               - float(jtwin.dram_peak_C.max())) <= 1e-3


# ------------------------------------------------------- solver fallback

def test_fallback_chain_shapes():
    assert thermal.fallback_chain("mg") == (
        ("mg", 1.0), ("mgcg", 1.0), ("pcg", 1.0), ("pcg", 0.1))
    assert thermal.fallback_chain("pcg") == (("pcg", 1.0), ("pcg", 0.1))
    with pytest.raises(ValueError, match="unknown solver"):
        thermal.fallback_chain("sor")


def test_poison_solver_scoping():
    assert not solver_poisoned("mg")
    with poison_solver("mg", "mgcg"):
        assert solver_poisoned("mg") and solver_poisoned("mgcg")
        with poison_solver("mg"):
            assert solver_poisoned("mg")
        assert solver_poisoned("mg")
    assert not solver_poisoned("mg") and not solver_poisoned("mgcg")


def _hot_plate(pkg):
    g = pkg.Grid(die_w=3e-3, ny=16, nx=16, margin=4)
    p = np.zeros((g.n_die_layers, 16, 16), np.float32)
    p[0, 4:12, 4:12] = 0.05
    return p, g


def test_fallback_recovers_poisoned_solve_with_counters():
    p, g = _hot_plate(thermal)
    dT_ref, ref = thermal.steady_state_stats(p, g, solver="mg",
                                             device="cpu")
    assert ref["attempts"] == 1 and ref["solved_by"] == "mg"
    with obs.scoped():
        obs.reset()
        with poison_solver("mg"):
            dT, stats = thermal.steady_state_stats(p, g, solver="mg",
                                                   device="cpu")
        snap = obs.snapshot()["counters"]
    assert stats["solved_by"] == "mgcg" and stats["attempts"] == 2
    assert stats["solver"] == "mg"
    assert stats["rel_residual"] <= thermal.HEALTH_RTOL
    np.testing.assert_allclose(dT.numpy(), dT_ref.numpy(), atol=1e-3)
    assert snap["thermal/fallback/engaged"] == 1
    assert snap["thermal/fallback/retries"] == 1
    assert snap["thermal/fallback/recovered"] == 1
    assert snap["thermal/fallback/unhealthy[mg]"] == 1
    jp, jg = _hot_plate(jthermal)
    with jobs.scoped():
        jobs.reset()
        with JF.poison_solver("mg"):
            jthermal.steady_state_stats(jp, jg, solver="mg")
        jsnap = jobs.snapshot()["counters"]
    pick = lambda s: {k: v for k, v in s.items()
                      if k.startswith("thermal/fallback/")}
    assert pick(snap) == pick(jsnap)


def test_fallback_exhaustion_is_loud_not_silent():
    p, g = _hot_plate(thermal)
    with obs.scoped():
        obs.reset()
        with poison_solver("mg", "mgcg", "pcg"):
            dT, stats = thermal.steady_state_stats(p, g, solver="mg",
                                                   device="cpu")
        snap = obs.snapshot()["counters"]
    assert stats["attempts"] == len(thermal.fallback_chain("mg"))
    assert not torch.isfinite(dT).all()
    assert not np.isfinite(stats["rel_residual"])
    assert snap["thermal/fallback/exhausted"] == 1
    assert snap["thermal/fallback/retries"] == 4


def test_steady_state_rejects_nonfinite_power():
    p, g = _hot_plate(thermal)
    p[0, 0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        thermal.steady_state(p, g, device="cpu")


def test_check_finite_power_names_offender():
    with pytest.raises(ValueError, match="dyn_frames.*2 non-finite"):
        feedback.check_finite_power(
            "unit", dyn_frames=np.array([np.nan, np.inf, 1.0]),
            leak0=np.ones(3))
    feedback.check_finite_power("unit", ok=np.ones(3))


# ------------------------------------------------- sweep with the guard

def test_sweep_runs_the_guarded_policy(tmp_path):
    """"guarded" is a sweep policy axis value: with perfect sensors its
    fused reading is the true one, so it replays as per-die does."""
    from repro_torch.sweep import SweepSpec, run_sweep
    kw = dict(workloads=("hist",), sizes=(4096,), n_dram=(2,),
              fb_modes=("closed",), grid_n=8, n_intervals=4,
              steps_per_interval=1, n_cg=10)
    res = {p: run_sweep(SweepSpec(policies=(p,), **kw), cache_dir=tmp_path,
                        device="cpu") for p in ("perdie", "guarded")}
    for a, b in zip(res["perdie"].records, res["guarded"].records):
        np.testing.assert_array_equal(a.report.peak_C, b.report.peak_C)
        np.testing.assert_array_equal(a.report.throttle, b.report.throttle)


# ---------------------------------------------------------- Policy protocol

def test_all_policies_accept_n_layers():
    for name, factory in POLICIES.items():
        factory().init_state(3)
    assert Policy().init_state() == ()
    assert Policy().init_state(5) == ()
