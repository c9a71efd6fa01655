"""PyTorch port vs the JAX reference: the AP megakernel's lane sharding.

``run_group(mesh=)`` on 1, 2 and 4 shards must give the reference's
``group_scan`` oracle bit for bit (planes, tag, matched counts) on
random groups, conditional and not, with disabled ops; the port's
shard-summing plain twin ``group_scan_plain_sharded`` the same; and
sort, knn, hist and spmv in megakernel mode with ``n_shards`` their
unsharded results, counters and trace arrays.  The reference's bad
configurations raise its messages, and a sharded launch counts what the
reference counts in ``obs``.

The host has one CPU device, so the several-shard cases monkeypatch
``sharding.local_devices`` to list it four times, as the reference
forces four XLA host devices.  Here each segment runs the plain version
on every shard; on a card the same segments launch the hand-written
kernel (``tests/test_torch_cuda_kernels.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ap_megakernel import ref as jref
from repro_torch import interop, obs
from repro_torch.core import engine as tengine
from repro_torch.kernels.ap_megakernel import ops as tops
from repro_torch.kernels.ap_megakernel import ref as tref
from repro_torch.parallel import sharding
from repro_torch.workloads import histogram, knn, registry, sort, spmv

CPU = torch.device("cpu")
_group_scan = jax.jit(jref.group_scan)


@pytest.fixture
def four_cpus(monkeypatch):
    monkeypatch.setattr(sharding, "local_devices",
                        lambda device="cuda": (CPU,) * 4)


def _ops(rng, n_bits, P, conditional):
    out = []
    for p in range(P):
        opc = int(rng.integers(0, 4))
        cond = (int(rng.integers(0, min(p, tref.MAX_COND) + 1))
                if conditional else 0)
        nc, nw = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        out.append((opc, cond, rng.integers(0, n_bits, nc).tolist(),
                    rng.integers(0, 2, nc).tolist(),
                    rng.integers(0, n_bits, nw).tolist(),
                    rng.integers(0, 2, nw).tolist()))
    return out


def _case(seed, conditional, n_lanes=8, n_bits=7, P=10):
    rng = np.random.default_rng(seed)
    group = jref.OpGroup.build(_ops(rng, n_bits, P, conditional))
    planes = rng.integers(0, 2 ** 32, (n_bits, n_lanes),
                          dtype=np.uint64).astype(np.uint32)
    tag = rng.integers(0, 2 ** 32, n_lanes, dtype=np.uint64).astype(np.uint32)
    enabled = rng.integers(0, 4, P) > 0
    want = [np.asarray(a) for a in _group_scan(
        jnp.asarray(planes), jnp.asarray(tag),
        tuple(jnp.asarray(t) for t in group.tables()), jnp.asarray(enabled))]
    return (interop.op_group_from_reference(group.tables()),
            interop.planes_from_reference(planes, "cpu"),
            interop.planes_from_reference(tag[None], "cpu")[0], enabled, want)


def _check(p, t, m, want):
    np.testing.assert_array_equal(interop.planes_to_reference(p), want[0])
    np.testing.assert_array_equal(interop.planes_to_reference(t[None])[0],
                                  want[1])
    np.testing.assert_array_equal(m.numpy(), want[2])


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("conditional", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_sharded_run_group_matches_reference(seed, conditional, n_shards,
                                             four_cpus):
    group, planes, tag, enabled, want = _case(seed, conditional)
    p, t, m = tops.run_group(planes, tag, group, enabled,
                             mesh=sharding.ap_mesh(n_shards, device="cpu"))
    _check(p, t, m, want)
    # the inputs are left unchanged
    assert torch.equal(planes, interop.planes_from_reference(
        interop.planes_to_reference(planes), "cpu"))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("seed", range(3))
def test_shard_summing_twin_matches_reference(seed, n_shards):
    """The plain twin of the reference's ``group_scan(axis_name=)``: each
    op's count summed over the shards before any predicate reads it."""
    group, planes, tag, enabled, want = _case(seed, True)
    w = planes.shape[1] // n_shards
    ps, ts, m, ex = tref.group_scan_plain_sharded(
        [planes[:, s * w:(s + 1) * w] for s in range(n_shards)],
        [tag[s * w:(s + 1) * w] for s in range(n_shards)],
        group.tables(), enabled)
    _check(torch.cat(ps, dim=1), torch.cat(ts), m, want)
    np.testing.assert_array_equal(ex.numpy(), want[3])


def test_segments_end_at_branched_on_ops():
    """Every condition of a segment reads an op of an earlier segment,
    and every segment runs unconditionally."""
    rng = np.random.default_rng(9)
    for _ in range(20):
        group = tref.OpGroup.build(_ops(rng, 5, 12, True))
        sg = tops.sharded_group(group, (CPU, CPU))
        assert sg.segments[0][0] == 0 and sg.segments[-1][1] == 12
        for (a, b), (c, _) in zip(sg.segments, sg.segments[1:]):
            assert b == c
        for (a, b), dgs in zip(sg.segments, sg.groups):
            assert not dgs[CPU].conditional and dgs[CPU].n_ops == b - a
            for q in range(a, b):
                if group.cond[q]:
                    assert q - group.cond[q] < a
    unconditional = tref.OpGroup.probes([[0], [1]], [[1], [0]])
    assert tops.sharded_group(unconditional, (CPU,)).segments == ((0, 2),)


# ---------------------------------------------------------------------------
# the suite in megakernel mode
# ---------------------------------------------------------------------------

def _same_counters(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


_ENTRY = {"sort": (sort, "ap_sort"), "knn": (knn, "ap_knn"),
          "hist": (histogram, "ap_histogram"), "spmv": (spmv, "ap_spmv")}


@pytest.mark.parametrize("w", ["sort", "knn", "hist", "spmv"])
def test_suite_traces_are_shard_count_invariant(w, four_cpus, monkeypatch):
    """The registry's trace instances with every megakernel group
    lane-sharded over 1, 2 and 4 shards: answers, counters and trace
    arrays bitwise the unsharded run's."""
    base = registry.trace_counters(w, 256, mode="megakernel", device="cpu")
    mod, name = _ENTRY[w]
    real = getattr(mod, name)
    for n in (1, 2, 4):
        monkeypatch.setattr(mod, name, functools.partial(real, n_shards=n))
        _same_counters(registry.trace_counters(w, 256, mode="megakernel",
                                               device="cpu"), base)
    monkeypatch.setattr(mod, name, real)


def test_sort_and_histogram_answers_are_shard_count_invariant(four_cpus):
    """The reference's subprocess workloads: sort of 128 bytes and a
    histogram of 100 values on 1, 2 and 4 shards."""
    rng = np.random.default_rng(123)
    x = rng.integers(0, 256, 128, dtype=np.uint64)
    runs = {ns: sort.ap_sort(x, m=8, mode="megakernel", n_shards=ns,
                             device="cpu") for ns in (None, 1, 2, 4)}
    for ns in (1, 2, 4):
        np.testing.assert_array_equal(runs[None][0], runs[ns][0])
        _same_counters(runs[None][1], runs[ns][1])
    np.testing.assert_array_equal(runs[None][0], np.sort(x))
    h = rng.integers(0, 64, 100, dtype=np.uint64)
    hr = {ns: histogram.ap_histogram(h, 8, m=6, mode="megakernel",
                                     n_shards=ns, device="cpu")
          for ns in (None, 2, 4)}
    for ns in (2, 4):
        np.testing.assert_array_equal(hr[None][0], hr[ns][0])
        _same_counters(hr[None][1], hr[ns][1])


def test_engine_run_shards_its_schedules(four_cpus):
    """``APEngine.run`` with ``n_shards`` runs each schedule as a sharded
    all-PASS group: planes, counters and trace as the unsharded engine's."""
    from repro_torch.core import isa
    engs = [tengine.APEngine(256, 12, backend="megakernel", n_shards=ns,
                             device="cpu") for ns in (None, 4)]
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 16, 256, dtype=np.uint64)
    for eng in engs:
        a, b, c = (eng.alloc.alloc(4), eng.alloc.alloc(4),
                   eng.alloc.alloc(1))
        eng.load(a, vals)
        eng.load(b, vals[::-1].copy())
        eng.run(isa.add(a, b, c))
    assert engs[1].mesh == (CPU,) * 4 and engs[0].mesh is None
    assert torch.equal(engs[0].planes, engs[1].planes)
    assert engs[0].counters() == engs[1].counters()
    for x, y in zip(engs[0].trace_events(), engs[1].trace_events()):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the reference's bad configurations and counters
# ---------------------------------------------------------------------------

def test_engine_rejects_bad_shard_config():
    with pytest.raises(ValueError, match="megakernel"):
        tengine.APEngine(n_words=64, n_bits=4, backend="jnp", n_shards=2,
                         device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tengine.APEngine(n_words=32, n_bits=4, backend="megakernel",
                         n_shards=3, device="cpu")
    # more shards than local devices: the mesh raises on first use
    eng = tengine.APEngine(n_words=64, n_bits=4, backend="megakernel",
                           n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        eng.mesh


def test_run_group_rejects_bad_shard_config(four_cpus):
    group, planes, tag, enabled, _ = _case(0, True, n_lanes=6)
    mesh = sharding.ap_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="backend='jnp'"):
        tops.run_group(planes, tag, group, backend="pallas", mesh=mesh)
    with pytest.raises(ValueError, match="not divisible by n_shards=4"):
        tops.run_group(planes, tag, group, mesh=mesh)


@pytest.mark.parametrize("w", ["hist", "spmv", "sort"])
def test_sharded_launch_counters_match_reference(w, monkeypatch):
    """``kernels/launch/ap_megakernel*`` of a one-shard megakernel-mode
    capture: the ``jnp_sharded`` counts as the reference's; sort counts
    its rounds' launches once a round (the unsharded rule,
    ``test_torch_obs``)."""
    from repro.workloads import histogram as jhist
    from repro.workloads import registry as jreg
    from repro.workloads import sort as jsort
    from repro.workloads import spmv as jspmv
    jmod = {"hist": (jhist, "ap_histogram"), "spmv": (jspmv, "ap_spmv"),
            "sort": (jsort, "ap_sort")}[w]
    mod, name = _ENTRY[w]
    monkeypatch.setattr(jmod[0], jmod[1],
                        functools.partial(getattr(jmod[0], jmod[1]),
                                          n_shards=1))
    monkeypatch.setattr(mod, name,
                        functools.partial(getattr(mod, name), n_shards=1))
    with obs.scoped():
        obs.reset()
        registry.trace_counters(w, 64, mode="megakernel", device="cpu")
        got = obs.values_by_prefix("kernels/launch/")
    from repro import obs as jobs
    with jobs.scoped():
        jobs.reset()
        jreg.trace_counters(w, 64, mode="megakernel")
        want = jobs.values_by_prefix("kernels/launch/")
    if w == "sort":
        key = "kernels/launch/ap_megakernel/min_extract_rounds"
        assert got[key] == want[key] >= 1
        assert got["kernels/launch/ap_megakernel/jnp_sharded"] >= 1
    else:
        assert got == want
        assert got["kernels/launch/ap_megakernel/jnp_sharded"] >= 1
