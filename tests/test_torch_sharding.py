"""PyTorch port vs the JAX reference: the sharded case batch.

``tests/test_shard_sweep.py``'s semantics on the port
(``repro_torch.parallel.sharding``, ``replay_cases(n_shards=)``,
``run_sweep(n_shards=)``): mesh validation, the pad/unpad round trip,
``n_shards=1`` bitwise the unsharded batch, 1, 3 and 4 shards bitwise
the unsharded records for a sweep and for the faulted sort replay of
``tests/test_faults.py``, a cache key without a shard field, and the
port's one-shard records against the reference's one-shard records.

The host has one CPU device, so the several-shard cases monkeypatch
``sharding.local_devices`` to list it four times, as the reference
forces four XLA host devices: each shard then runs its slice of the
batch alone, which is what must not change a bit of any case.
"""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.parallel import sharding
from repro_torch.stack import feedback
from repro_torch.sweep import SweepSpec, run_sweep
from repro_torch.sweep import cache as sweep_cache
from repro_torch.sweep import engine

CPU = torch.device("cpu")
_QUICK = dict(workloads=("hist",), sizes=(4096,), n_dram=(1,),
              fb_modes=("open",), grid_n=8, n_intervals=4,
              steps_per_interval=1, n_cg=15)
#: the reference's subprocess spec: 4 cases a group, so 3 shards pad
_PADDED = dict(_QUICK, workloads=("hist", "sort"), n_dram=(1, 2),
               fb_modes=("open", "closed"))
ARRAYS = ("peak_C", "min_C", "residual_C", "throttle", "refresh_W",
          "leak_W", "dyn_W")
#: the faulted replays' peaks against the reference's: float32 CG of 15
#: iterations summed in another order (``test_torch_faults.PEAK_ATOL_C``)
PEAK_ATOL_C = 0.1
#: converged CG (n_cg=120): ``test_torch_sweep.CONVERGED_ATOL_C``
CONVERGED_ATOL_C = 1e-3


@pytest.fixture
def four_cpus(monkeypatch):
    """Four "local devices", each the host's CPU."""
    monkeypatch.setattr(sharding, "local_devices",
                        lambda device="cuda": (CPU,) * 4)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def assert_same_reports(a, b, what=""):
    """Two StackReports bit for bit (NaNs included)."""
    for name in ARRAYS:
        np.testing.assert_array_equal(_bits(getattr(a, name)),
                                      _bits(getattr(b, name)),
                                      err_msg=f"{what} {name}")


# ---------------------------------------------------------------------------
# the mesh and the batch helpers
# ---------------------------------------------------------------------------

def test_local_devices_of_the_host():
    assert sharding.local_devices("cpu") == (CPU,)
    assert sharding.sweep_mesh(device="cpu") == (CPU,)
    assert sharding.ap_mesh(1, device="cpu") == (CPU,)
    for fn in (sharding.sweep_mesh, sharding.ap_mesh):
        with pytest.raises(ValueError, match="out of range"):
            fn(2, device="cpu")


@pytest.mark.parametrize("fn", ["sweep_mesh", "ap_mesh"])
def test_mesh_validates_device_count(fn, four_cpus):
    mesh = getattr(sharding, fn)
    assert mesh(device="cpu") == (CPU,) * 4
    assert mesh(3, device="cpu") == (CPU,) * 3
    for bad in (0, 5, -1):
        with pytest.raises(ValueError, match="out of range"):
            mesh(bad, device="cpu")


def test_pad_case_batch_roundtrip():
    batch = (torch.arange(10).reshape(5, 2),
             {"g": torch.ones((5, 3)), "h": [torch.zeros(5)]})
    padded, n = sharding.pad_case_batch(batch, 3)
    assert n == 5
    assert all(leaf.shape[0] == 6 for leaf in sharding._leaves(padded))
    # padding repeats the last case
    assert (padded[0][5] == padded[0][4]).all()
    back = sharding.unpad_case_batch(padded, n)
    assert (back[0] == batch[0]).all()
    assert (back[1]["g"] == batch[1]["g"]).all()
    assert back[1]["h"][0].shape == (5,)
    same, n2 = sharding.pad_case_batch(batch, 5)
    assert same is batch and n2 == 5
    with pytest.raises(ValueError, match="inconsistent"):
        sharding.pad_case_batch((torch.zeros(3), torch.zeros(4)), 2)


def test_shard_case_batch_slices_and_gathers(four_cpus):
    seen = []

    def fn(tree):
        seen.append(tree[0].shape[0])
        return tree[0] * 2, {"s": tree[1]["x"].sum(dim=1)}

    x = torch.arange(12.0).reshape(6, 2)
    out = sharding.shard_case_batch(fn, (CPU,) * 3)((x, {"x": x}))
    assert seen == [2, 2, 2]
    assert (out[0] == x * 2).all()
    assert (out[1]["s"] == x.sum(dim=1)).all()
    with pytest.raises(ValueError, match="multiple"):
        sharding.shard_case_batch(fn, (CPU,) * 4)((x, {"x": x}))


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def test_single_shard_matches_the_unsharded_sweep():
    """n_shards=1 runs on the one local device and is bitwise the plain
    batch."""
    spec = SweepSpec(**_QUICK)
    ref = run_sweep(spec, use_cache=False, device="cpu")
    got = run_sweep(spec, use_cache=False, n_shards=1, device="cpu")
    for a, b in zip(ref.records, got.records):
        assert a.label == b.label
        assert_same_reports(a.report, b.report, a.label)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_sweep_is_shard_count_invariant(n_shards, four_cpus):
    """Groups of 4 cases on 1, 3 (padded to 6) and 4 shards: every
    record bitwise the unsharded run's."""
    spec = SweepSpec(**_PADDED)
    ref = run_sweep(spec, use_cache=False, device="cpu")
    got = run_sweep(spec, use_cache=False, n_shards=n_shards, device="cpu")
    assert [r.label for r in got.records] == [r.label for r in ref.records]
    assert not got.n_failed
    for a, b in zip(ref.records, got.records):
        assert_same_reports(a.report, b.report, f"{n_shards} {a.label}")


def test_cache_key_ignores_shard_count(tmp_path, four_cpus):
    """Sharding is an execution detail: the spec hash (= cache key) has
    no shard field, so an entry written unsharded serves a 4-shard run,
    bit for bit."""
    spec = SweepSpec(**_QUICK)
    assert "shard" not in str(sorted(spec.canonical()))
    live = run_sweep(spec, cache_dir=tmp_path, device="cpu")
    assert sweep_cache.path_for(spec, tmp_path, device="cpu").exists()
    with obs.scoped():
        obs.reset()             # whatever ran before in this process
        hit = run_sweep(spec, cache_dir=tmp_path, n_shards=4, device="cpu")
        assert obs.value("sweep/cases") == 0        # served, not replayed
    for a, b in zip(live.records, hit.records):
        assert_same_reports(a.report, b.report, a.label)


def test_run_group_takes_the_references_signature(monkeypatch, tmp_path):
    """``_run_group(spec, points, n_dram, fb_mode, policy, params,
    n_shards)``: a wrapper written for the reference's signature (the
    port's ``device`` rides as a keyword) isolates a failed group."""
    spec = SweepSpec(**dict(_QUICK, fb_modes=("open", "nodtm")))
    real = engine._run_group

    def sabotaged(spec, points, n_dram, fb_mode, policy, params,
                  n_shards=None, **kw):
        if fb_mode == "open":
            raise ValueError("injected group failure")
        return real(spec, points, n_dram, fb_mode, policy, params,
                    n_shards, **kw)

    monkeypatch.setattr(engine, "_run_group", sabotaged)
    res = run_sweep(spec, cache_dir=tmp_path, n_shards=1, device="cpu")
    by_mode = {r.point.fb_mode: r for r in res.records}
    assert by_mode["open"].failed and not by_mode["nodtm"].failed
    assert res.n_failed == 2


def test_single_shard_records_match_the_references_single_shard():
    """The port's n_shards=1 sweep against the reference's n_shards=1 on
    the same spec, the CG converged: every array within 1e-3 °C, the
    verdicts and duties equal."""
    from repro.sweep import SweepSpec as JSpec
    from repro.sweep import run_sweep as jrun
    kw = dict(_QUICK, workloads=("hist", "sort"), n_cg=120)
    got = run_sweep(SweepSpec(**kw), use_cache=False, n_shards=1,
                    device="cpu")
    ref = jrun(JSpec(**kw), use_cache=False, n_shards=1)
    for g, r in zip(got.records, ref.records):
        assert g.label == r.label
        for name in ("peak_C", "min_C"):
            np.testing.assert_allclose(getattr(g.report, name),
                                       getattr(r.report, name), rtol=0,
                                       atol=CONVERGED_ATOL_C)
        np.testing.assert_array_equal(g.report.throttle, r.report.throttle)
        assert g.verdict_ok == r.verdict_ok


# ---------------------------------------------------------------------------
# the faulted replay (tests/test_faults.py's device-count invariance case)
# ---------------------------------------------------------------------------

_FAULT_SPEC = dict(seed=3, n_sensors=3, noise_C=0.8, n_stuck=1,
                   p_dropout=0.1)


def _fault_case(pkg_feedback, pkg_cosim, spec_mod, faults_mod, policy_cls,
                **dev):
    spec = spec_mod.dram_on_logic(2, spec_mod.PAPER_STACK)
    dp = pkg_cosim.comparable_design_point("sort", 2 ** 20)
    trace = pkg_cosim.ap_workload_trace(
        "sort", 8, pkg_cosim.trace_elems(2 ** 20), **dev)
    case = [("sort/ap", pkg_feedback.assemble_case(
        dp, "sort", "ap", spec, spec_mod.PAPER_STACK, 8, trace, 2, **dev))]
    fb = pkg_feedback.FeedbackParams(
        policy=policy_cls(), faults=faults_mod.SensorFaultSpec(**_FAULT_SPEC))
    return case, spec, fb


@pytest.fixture(scope="module")
def port_fault_case():
    from repro_torch import faults
    from repro_torch.core import cosim
    from repro_torch.policy import PerDiePolicy
    from repro_torch.stack import spec as spec_mod
    return _fault_case(feedback, cosim, spec_mod, faults, PerDiePolicy,
                       device="cpu")


def _port_fault_replay(case, n_shards):
    case, spec, fb = case
    return feedback.replay_cases(case, spec, fb, 8, 0.02,
                                 steps_per_interval=1, n_cg=15, margin=2,
                                 n_shards=n_shards, device="cpu")["sort/ap"]


def test_faulted_replay_is_shard_count_invariant(port_fault_case,
                                                 four_cpus):
    """One case on 1, 3 and 4 shards (padded with copies of itself):
    bitwise the unsharded replay, NaNs of the dropped-out readings
    included, with the same seeded draws for every shard."""
    ref = _port_fault_replay(port_fault_case, None)
    assert np.isnan(ref.throttle).any()       # the dropout reaches PerDie
    for n in (1, 3, 4):
        assert_same_reports(_port_fault_replay(port_fault_case, n), ref,
                            f"n_shards={n}")


def test_faulted_single_shard_matches_the_reference(port_fault_case):
    """The port's one-shard faulted replay against the reference's: NaN
    where the reference has NaN, the peaks and duties within
    ``PEAK_ATOL_C`` (the minima of 15 unconverged CG iterations part by
    up to 0.11 °C, and ``test_torch_faults`` holds peaks only)."""
    from repro import faults as jfaults
    from repro.core import cosim as jcosim
    from repro.policy import PerDiePolicy as JPerDie
    from repro.stack import feedback as jfb
    from repro.stack import spec as jspec
    jcase, jstack, jfbp = _fault_case(jfb, jcosim, jspec, jfaults, JPerDie)
    want = jfb.replay_cases(jcase, jstack, jfbp, 8, 0.02,
                            steps_per_interval=1, n_cg=15, margin=2,
                            n_shards=1)["sort/ap"]
    got = _port_fault_replay(port_fault_case, 1)
    for name in ("peak_C", "min_C", "throttle"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        if name != "min_C":
            np.testing.assert_allclose(g[~np.isnan(g)], w[~np.isnan(w)],
                                       rtol=0, atol=PEAK_ATOL_C,
                                       err_msg=name)


def test_replay_span_carries_n_shards(port_fault_case, four_cpus):
    with obs.scoped():
        obs.reset()             # whatever ran before in this process
        _port_fault_replay(port_fault_case, 3)
        _port_fault_replay(port_fault_case, None)
        spans = [e for e in obs.trace_events()["traceEvents"]
                 if e["name"] == "feedback/replay"]
    assert [s["args"]["n_shards"] for s in spans] == [3, 0]
