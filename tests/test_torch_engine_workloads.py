"""PyTorch port vs the JAX reference: the AP engine and the paper trio.

``registry.trace_counters(w, 64)`` runs dmm, fft and bs on the exact
bit-serial engine of each package (the port on the CPU, where
``APEngine.run`` takes the plain pass-schedule version).  Results, cycle
counters, event counts, float64 energies and the trace event arrays must
be identical; so must the binned energy trace and the power trace the
co-simulation builds from them.
"""
import numpy as np
import pytest

from repro.core import cosim as jcosim
from repro.core import engine as jengine
from repro.core import isa as jisa
from repro.core.bitplane import Field as JField
from repro.workloads import blackscholes as jbs
from repro.workloads import dmm as jdmm
from repro.workloads import fft as jfft
from repro.workloads import registry as jregistry
from repro_torch.core import cosim as tcosim
from repro_torch.core import engine as tengine
from repro_torch.core import isa as tisa
from repro_torch.core.bitplane import Field as TField
from repro_torch.workloads import blackscholes as tbs
from repro_torch.workloads import dmm as tdmm
from repro_torch.workloads import fft as tfft
from repro_torch.workloads import registry as tregistry

ENTRY = {"dmm": "ap_matmul", "fft": "ap_fft", "bs": "ap_blackscholes"}
MODULES = {"dmm": (jdmm, tdmm), "fft": (jfft, tfft), "bs": (jbs, tbs)}


def _spy(monkeypatch, module, name, sink):
    """Record the (result, counters) the registry's runner gets back."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        sink.append(out)
        return out
    monkeypatch.setattr(module, name, wrapped)


def _assert_counters_identical(ref: dict, got: dict):
    assert set(ref) == set(got)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert type(got[k]) is type(v) and got[k] == v, k


@pytest.mark.parametrize("w", ["dmm", "fft", "bs"])
def test_trio_trace_counters_identical(monkeypatch, w):
    jmod, tmod = MODULES[w]
    j_out, t_out = [], []
    _spy(monkeypatch, jmod, ENTRY[w], j_out)
    _spy(monkeypatch, tmod, ENTRY[w], t_out)
    ref = jregistry.trace_counters(w, 64)
    got = tregistry.trace_counters(w, 64, device="cpu")
    _assert_counters_identical(ref, got)
    assert got["energy"] == ref["energy"]            # float64, bit for bit
    [(j_res, _)], [(t_res, _)] = j_out, t_out
    np.testing.assert_array_equal(np.asarray(t_res), np.asarray(j_res))

    # binned energy trace and the co-simulation's activity profile
    for n in (7, 48):
        ji, jb = jengine.bin_energy_trace(ref["trace_cycles"],
                                          ref["trace_energy"],
                                          ref["cycles"], n)
        ti, tb = tengine.bin_energy_trace(got["trace_cycles"],
                                          got["trace_energy"],
                                          got["cycles"], n)
        assert ji == ti
        np.testing.assert_array_equal(tb, jb)
        jt = jcosim.trace_from_counters(ref, n, source=f"ap:{w}")
        tt = tcosim.trace_from_counters(got, n, source=f"ap:{w}")
        np.testing.assert_array_equal(tt.activity, jt.activity)
        assert (tt.source, tt.native_s) == (jt.source, jt.native_s)


def test_engine_ops_and_power_trace_identical():
    """Eager compare/write/bwrite/read_tagged plus one fused run: planes,
    tags, counters and the binned power trace match the reference."""
    rng = np.random.default_rng(5)
    av = rng.integers(0, 1 << 8, 64, dtype=np.uint64)
    bv = rng.integers(0, 1 << 8, 64, dtype=np.uint64)
    engines = (jengine.APEngine(64, 32),
               tengine.APEngine(64, 32, device="cpu"))
    for eng, isa in zip(engines, (jisa, tisa)):
        a, b = eng.alloc.alloc(8), eng.alloc.alloc(8)
        c, flag = eng.alloc.alloc(1), eng.alloc.alloc(1)
        eng.load(a, av)
        eng.load(b, bv)
        isa.run_add(eng, a, b, c)                      # fused schedule
        eng.compare(a.cols()[:3], [1, 0, 1])
        eng.write([flag.col(0)], [1])
        eng.compare([c.col(0)], [1], restrict_to_tag=True)
        eng.set_bits(c, 1)
        eng.load_tag_column(flag.col(0))
        eng.read_tagged(b)
        eng.clear(flag)
    je, te = engines
    np.testing.assert_array_equal(te.peek(TField(0, 32)),
                                  je.peek(JField(0, 32)))
    np.testing.assert_array_equal(te.read(TField(0, 16), signed=True),
                                  je.read(JField(0, 16), signed=True))
    assert te.tag_count() == je.tag_count()
    assert te.counters() == je.counters()
    assert te.energy == je.energy
    for n in (5, 16):
        ji, jb = je.power_trace(n)
        ti, tb = te.power_trace(n)
        assert ji == ti
        np.testing.assert_array_equal(tb, jb)


def test_trace_elems_and_design_points_match():
    for size in (1, 1 << 10, 1 << 20, 1 << 44):
        assert tcosim.trace_elems(size) == jcosim.trace_elems(size)
    for w in ("dmm", "fft", "bs"):
        jdp = jcosim.comparable_design_point(w)
        tdp = tcosim.comparable_design_point(w)
        assert tdp.__dict__ == jdp.__dict__
        tr_j = jcosim.simd_phase_trace(jcosim.M.WORKLOADS[w], jdp, 48)
        tr_t = tcosim.simd_phase_trace(tcosim.M.WORKLOADS[w], tdp, 48)
        np.testing.assert_array_equal(tr_t.activity, tr_j.activity)
