"""PyTorch port vs the JAX reference: the scenario sweep and its cache.

``tests/test_sweep.py``'s semantics on the port (spec validation and
hashing, point order, cache hits bit-identical, perturbed specs and
corrupt files missing), held against the reference on the same specs:
the same content hash, points and verdicts.  The port's cache entries
live in a namespace of their own (``repro_torch`` and the device type in
the file name and the manifest), so a reference entry is never served to
the port.  A group whose replay raises ``ValueError`` becomes FAILED
records that are not cached; a ``RuntimeError`` (a CUDA or kernel error)
propagates.
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from repro.sweep import SweepSpec as JSpec
from repro.sweep import cache as jcache
from repro.sweep import run_sweep as jrun
from repro_torch import obs
from repro_torch.sweep import SweepSpec, run_sweep
from repro_torch.sweep import cache as sweep_cache
from repro_torch.sweep import engine

_QUICK = dict(workloads=("hist",), sizes=(4096,), n_dram=(1,),
              fb_modes=("open",), grid_n=8, n_intervals=4,
              steps_per_interval=1, n_cg=15)
#: ``benchmarks/bench_sweep.py``'s quick spec (grid 8, 8 intervals,
#: sizes 4096 and 2^20: 64- and 1024-element traces)
_BENCH_QUICK = dict(workloads=("sort", "hist"), sizes=(4096, 2 ** 20),
                    n_dram=(2,), grid_n=8, n_intervals=8,
                    steps_per_interval=1, n_cg=25)
#: peaks of the same spec with the CG converged (n_cg=120) [°C]; at the
#: bench's n_cg=25 the unconverged float32 CG differs by up to 0.2 °C
#: (ROADMAP Queue 3, item 7)
CONVERGED_ATOL_C = 1e-3
ARRAYS = ("peak_C", "min_C", "residual_C", "throttle", "refresh_W",
          "leak_W", "dyn_W")


def _run(spec, tmp_path, **kw):
    return run_sweep(spec, cache_dir=tmp_path, device="cpu", **kw)


def _verdicts(res):
    return [(r.label, "FAILED" if r.failed else
             "OK" if r.verdict_ok else "BLOCKED") for r in res.records]


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

def test_spec_validation():
    with pytest.raises(ValueError):
        SweepSpec(workloads=("no_such_workload",))
    with pytest.raises(ValueError):
        SweepSpec(workloads=("dmm",), fb_modes=("bogus",))
    with pytest.raises(ValueError):
        SweepSpec(workloads=("dmm",), sizes=(128,))
    with pytest.raises(ValueError):
        SweepSpec(workloads=("dmm",), machines=("gpu",))
    with pytest.raises(ValueError):
        SweepSpec(workloads=("dmm",), ap_backend="bogus")
    with pytest.raises(ValueError):
        SweepSpec(workloads=("dmm",), solver="mgcg")
    with pytest.raises(ValueError, match="unknown policy"):
        SweepSpec(workloads=("dmm",), policies=("bogus",))
    # every registered policy is a sweep axis value, "guarded" included
    assert SweepSpec(workloads=("dmm",), policies=("guarded",)).policies \
        == ("guarded",)


_PERTURB = dict(
    workloads=("hist", "sort"), sizes=(8192,), n_dram=(2,),
    fb_modes=("closed",), policies=("ramp", "perdie"),
    machines=("ap",), grid_n=12, n_intervals=8,
    t_end=0.5, steps_per_interval=2, n_cg=16, theta=0.5, n_picard=8,
    solver="mg", n_mg=5, ap_backend="megakernel")


@pytest.mark.parametrize("field", list(_PERTURB))
def test_spec_hash_sensitivity_and_reference_hash(field):
    """Perturbing any one field changes the key, and every spec hashes
    as the reference's spec of the same fields."""
    spec = SweepSpec(**_QUICK)
    assert spec.content_hash() == SweepSpec(**_QUICK).content_hash()
    assert spec.content_hash() == JSpec(**_QUICK).content_hash()
    other = dataclasses.replace(spec, **{field: _PERTURB[field]})
    assert other.content_hash() != spec.content_hash()
    assert other.content_hash() \
        == JSpec(**dict(_QUICK, **{field: _PERTURB[field]})).content_hash()
    assert other.canonical() == dataclasses.replace(
        JSpec(**_QUICK), **{field: _PERTURB[field]}).canonical()


def test_points_enumeration_as_reference():
    kw = dict(workloads=("hist", "sort"), sizes=(4096, 8192),
              n_dram=(0, 2), fb_modes=("open", "closed"),
              policies=("ramp", "dvfs"))
    pts, jpts = SweepSpec(**kw).points(), JSpec(**kw).points()
    assert len(pts) == SweepSpec(**kw).n_points == 32
    assert [p.label for p in pts] == [p.label for p in jpts]
    assert pts[0].workload == "hist" and pts[-1].workload == "sort"
    assert SweepSpec(**kw).trace_elems(2 ** 20) == 1024


# ---------------------------------------------------------------------------
# the sweep against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_quick(tmp_path_factory):
    """The bench's quick spec in both packages, the port on the CPU."""
    tmp = tmp_path_factory.mktemp("bench_quick")
    return (run_sweep(SweepSpec(**_BENCH_QUICK), cache_dir=tmp,
                      device="cpu"),
            jrun(JSpec(**_BENCH_QUICK), use_cache=False), tmp)


def test_verdict_table_matches_reference(bench_quick):
    got, ref, _ = bench_quick
    assert _verdicts(got) == _verdicts(ref)
    assert got.table().splitlines()[0] == ref.table().splitlines()[0]
    for g, r in zip(got.table().splitlines()[1:],
                    ref.table().splitlines()[1:]):
        assert g.split(",")[:6] == r.split(",")[:6]
        assert g.split(",")[-1] == r.split(",")[-1]
    # hist is BLOCKED on the AP at both sizes, sort OK (the bench's rows)
    assert dict(_verdicts(got))["hist/N4096/dram2/closed/ramp/ap"] \
        == "BLOCKED"
    assert dict(_verdicts(got))["sort/N4096/dram2/closed/ramp/ap"] == "OK"


def test_converged_peaks_match_reference(tmp_path):
    """With the CG converged, every record's arrays agree with the
    reference's to 1e-3 °C."""
    kw = dict(_BENCH_QUICK, n_cg=120)
    got = _run(SweepSpec(**kw), tmp_path, use_cache=False)
    ref = jrun(JSpec(**kw), use_cache=False)
    for g, r in zip(got.records, ref.records):
        assert g.label == r.label
        np.testing.assert_allclose(g.report.peak_C, r.report.peak_C,
                                   rtol=0, atol=CONVERGED_ATOL_C)
        np.testing.assert_array_equal(g.report.throttle, r.report.throttle)
        assert g.verdict_ok == r.verdict_ok


def test_sweep_record_order_matches_points(bench_quick):
    got, _, _ = bench_quick
    spec = got.spec
    expect = [(p, mc) for p in spec.points() for mc in spec.machines]
    assert [(r.point, r.machine) for r in got.records] == expect
    for r in got.records:
        assert r.limit_layers == r.report.spec.dram_layers


def test_policy_axis(tmp_path):
    """Closed-mode points run one replay group per policy (the ramp rows
    are the pre-axis default); outside closed mode the axis is inert."""
    spec = SweepSpec(**dict(_QUICK, fb_modes=("closed",),
                            policies=("ramp", "step")))
    res = _run(spec, tmp_path)
    assert {r.point.policy for r in res.records} == {"ramp", "step"}
    base = _run(SweepSpec(**dict(_QUICK, fb_modes=("closed",))), tmp_path)
    for a, b in zip([r for r in res.records if r.point.policy == "ramp"],
                    base.records):
        np.testing.assert_array_equal(a.report.peak_C, b.report.peak_C)
    inert = _run(SweepSpec(**dict(_QUICK, policies=("ramp", "pid"))),
                 tmp_path)
    by_pol = {(r.point.policy, r.machine): r for r in inert.records}
    for mc in inert.spec.machines:
        np.testing.assert_array_equal(by_pol[("ramp", mc)].report.dyn_W,
                                      by_pol[("pid", mc)].report.dyn_W)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def test_sweep_cache_roundtrip_bit_identical(bench_quick):
    got, _, tmp = bench_quick
    spec = got.spec
    assert not got.from_cache
    path = sweep_cache.path_for(spec, tmp, device="cpu")
    assert path.name == f"sweep_torch-cpu_{spec.content_hash()}.npz"
    assert path.exists()
    again = _run(spec, tmp)
    assert again.from_cache
    for a, b in zip(got.records, again.records):
        assert a.point == b.point and a.machine == b.machine
        assert a.report.label == b.report.label
        for name in ARRAYS:
            av, bv = getattr(a.report, name), getattr(b.report, name)
            assert av.dtype == bv.dtype
            np.testing.assert_array_equal(av, bv)
    assert got.table() == again.table()


def test_sweep_cache_misses_on_perturbation(tmp_path):
    spec = SweepSpec(**_QUICK)
    _run(spec, tmp_path)
    assert sweep_cache.load(dataclasses.replace(spec, n_cg=16), tmp_path,
                            device="cpu") is None
    assert sweep_cache.load(spec, tmp_path, device="cpu") is not None


def test_sweep_cache_corrupt_file_is_a_miss(tmp_path):
    spec = SweepSpec(**_QUICK)
    path = sweep_cache.path_for(spec, tmp_path, device="cpu")
    _run(spec, tmp_path)                       # a genuine entry
    corruptions = {"not_a_zip": b"this is not an npz archive at all",
                   "truncated": path.read_bytes()[:200], "empty": b""}
    for kind, payload in corruptions.items():
        path.write_bytes(payload)
        with obs.scoped():
            before = obs.value("sweep/cache/corrupt")
            assert sweep_cache.load(spec, tmp_path, device="cpu") is None
            assert obs.value("sweep/cache/corrupt") == before + 1, kind
        assert not _run(spec, tmp_path).from_cache
        assert _run(spec, tmp_path).from_cache


def test_reference_entry_is_never_served_to_the_port(tmp_path):
    """A reference-written entry in the same directory, even copied to
    the port's file name, is a miss; so is the port's CPU entry asked
    for by the card's name."""
    spec, jspec = SweepSpec(**_QUICK), JSpec(**_QUICK)
    jrun(jspec, cache_dir=tmp_path)
    jpath = jcache.path_for(jspec, tmp_path)
    assert jpath.exists()
    with obs.scoped():
        before = obs.value("sweep/cache/miss")
        assert sweep_cache.load(spec, tmp_path, device="cpu") is None
        shutil.copy(jpath, sweep_cache.path_for(spec, tmp_path,
                                                device="cpu"))
        assert sweep_cache.load(spec, tmp_path, device="cpu") is None
        assert obs.value("sweep/cache/miss") == before + 2
    res = _run(spec, tmp_path)                 # recomputed, overwritten
    assert not res.from_cache and _run(spec, tmp_path).from_cache
    # the port writes under its own name, which the reference never reads
    assert jpath.name == f"sweep_{spec.content_hash()}.npz"
    assert sweep_cache.path_for(spec, tmp_path, device="cpu") != jpath
    # and a CPU entry is never served to the card
    cuda_path = sweep_cache.path_for(spec, tmp_path, device="cuda")
    assert cuda_path != sweep_cache.path_for(spec, tmp_path, device="cpu")
    shutil.copy(sweep_cache.path_for(spec, tmp_path, device="cpu"),
                cuda_path)
    assert sweep_cache.load(spec, tmp_path, device="cuda") is None


# ---------------------------------------------------------------------------
# failure isolation
# ---------------------------------------------------------------------------

def _failing_replay(exc, n_dram: int):
    real = engine.feedback.replay_cases

    def replay(cases, stack_spec, *a, **kw):
        if len(stack_spec.dram_layers) == n_dram:
            raise exc("injected")
        return real(cases, stack_spec, *a, **kw)
    return replay


def test_value_error_group_becomes_failed_rows_not_cached(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    spec = SweepSpec(**dict(_QUICK, n_dram=(1, 2)))
    monkeypatch.setattr(engine.feedback, "replay_cases",
                        _failing_replay(ValueError, 2))
    with obs.scoped():
        before = obs.value("sweep/groups_failed")
        res = _run(spec, tmp_path)
        assert obs.value("sweep/groups_failed") == before + 1
    assert "FAILED (injected)" in capsys.readouterr().out
    failed = {r.label for r in res.records if r.failed}
    assert failed == {r.label for r in res.records if r.point.n_dram == 2}
    assert res.n_failed == 2
    assert "FAILED" in res.table()
    assert not any(r.verdict_ok for r in res.records if r.failed)
    assert not sweep_cache.path_for(spec, tmp_path, device="cpu").exists()


@pytest.mark.parametrize("exc", [RuntimeError, NotImplementedError])
def test_runtime_error_propagates(tmp_path, monkeypatch, exc):
    """A CUDA or kernel error is a RuntimeError: it must never become a
    FAILED row."""
    spec = SweepSpec(**dict(_QUICK, n_dram=(1, 2)))
    monkeypatch.setattr(engine.feedback, "replay_cases",
                        _failing_replay(exc, 2))
    with pytest.raises(exc, match="injected"):
        _run(spec, tmp_path)
    assert not sweep_cache.path_for(spec, tmp_path, device="cpu").exists()


def test_unported_and_card_only(tmp_path):
    spec = SweepSpec(**_QUICK)
    # n_shards is ported: two shards on the host's one CPU device are out
    # of range, a ValueError that turns each group FAILED, as in the
    # reference, and is never cached
    res = run_sweep(spec, cache_dir=tmp_path, n_shards=2, device="cpu")
    assert res.n_failed == len(res.records) > 0
    assert not sweep_cache.path_for(spec, tmp_path, device="cpu").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run_sweep(spec, cache_dir=tmp_path)
