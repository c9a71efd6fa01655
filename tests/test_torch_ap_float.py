"""PyTorch port vs the JAX reference: FP32 on the AP (``core/apfloat.py``).

``tests/test_ap_float.py``'s semantics on the port — the load/read round
trip, ``fp_mul`` against NumPy float32 within 2 ulp in a 4000-5800 cycle
window and with cycles independent of the vector length (the paper's
~4400-cycle claim, §2.2), and the four ``fp_add`` cases within 4 ulp
with exact zeros — and then the port against the reference on the same
inputs: results, every counter, the float64 energy and the trace arrays
bit for bit (integer bit-serial arithmetic; the pass schedules are the
reference's).
"""
import numpy as np
import pytest

from repro.core import apfloat as japf
from repro.core.engine import APEngine as JEngine
from repro_torch.core import apfloat
from repro_torch.core.engine import APEngine


def build(n=128, n_bits=352, pkg=apfloat, engine=APEngine, **kw):
    eng = engine(n_words=n, n_bits=n_bits, **kw)
    x = pkg.FpField.alloc(eng)
    y = pkg.FpField.alloc(eng)
    out = pkg.FpField.alloc(eng)
    scr = pkg.FpScratch.alloc(eng)
    return eng, x, y, out, scr


def rand_fp(n, seed, lo=-100.0, hi=100.0):
    rng = np.random.default_rng(seed)
    v = rng.uniform(lo, hi, size=n).astype(np.float32)
    v[v == 0] = 1.0
    return v


def ulp_diff(a, b):
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, np.int64(-2**31) - ai, ai)
    bi = np.where(bi < 0, np.int64(-2**31) - bi, bi)
    return np.abs(ai - bi)


def add_operands(case, n):
    """``test_ap_float.test_fp_add_correct``'s operands."""
    rng = np.random.default_rng(5)
    if case == "same_sign":
        va = rng.uniform(0.5, 50, n).astype(np.float32)
        vb = rng.uniform(0.5, 50, n).astype(np.float32)
    elif case == "mixed":
        va = rng.uniform(-50, 50, n).astype(np.float32)
        vb = rng.uniform(-50, 50, n).astype(np.float32)
    elif case == "cancel":
        va = rng.uniform(1, 2, n).astype(np.float32)
        vb = (-va * rng.choice([1.0, 0.5, 0.9990234375], n)).astype(np.float32)
    else:  # far: exponent gap > mantissa width
        va = rng.uniform(1e10, 1e12, n).astype(np.float32)
        vb = rng.uniform(1e-6, 1e-4, n).astype(np.float32)
    va[0], vb[0] = 0.0, 7.5
    va[1], vb[1] = -7.5, 0.0
    va[2], vb[2] = 0.0, 0.0
    va[3], vb[3] = 1.5, -1.5
    return va, vb


# ---------------------------------------------------------------------------
# test_ap_float.py's semantics
# ---------------------------------------------------------------------------

def test_fp_load_read_roundtrip():
    eng, x, _, _, _ = build(device="cpu")
    v = rand_fp(128, 0)
    apfloat.load_fp32(eng, x, v)
    np.testing.assert_array_equal(apfloat.read_fp32(eng, x), v)


def test_fp_mul_correct_and_cycle_count():
    eng, x, y, out, scr = build(device="cpu")
    va, vb = rand_fp(128, 1), rand_fp(128, 2)
    va[:4] = [0.0, 3.5, 0.0, -1.25]
    vb[:4] = [2.0, 0.0, 0.0, -8.0]
    apfloat.load_fp32(eng, x, va)
    apfloat.load_fp32(eng, y, vb)
    base = eng.cycles
    apfloat.fp_mul(eng, x, y, out, scr)
    took = eng.cycles - base
    got = apfloat.read_fp32(eng, out)
    assert ulp_diff(got, va * vb).max() <= 2
    assert 4000 <= took <= 5800, took


def test_fp_mul_cycles_independent_of_vector_length():
    counts = []
    for n in (64, 1024):
        eng, x, y, out, scr = build(n=n, device="cpu")
        apfloat.load_fp32(eng, x, rand_fp(n, 3))
        apfloat.load_fp32(eng, y, rand_fp(n, 4))
        base = eng.cycles
        apfloat.fp_mul(eng, x, y, out, scr)
        counts.append(eng.cycles - base)
    assert counts[0] == counts[1], "word-parallel: cycles must not depend on N"


@pytest.mark.parametrize("case", ["same_sign", "mixed", "cancel", "far"])
def test_fp_add_correct(case):
    n = 128
    eng, x, y, out, scr = build(n=n, n_bits=512, device="cpu")
    va, vb = add_operands(case, n)
    apfloat.load_fp32(eng, x, va)
    apfloat.load_fp32(eng, y, vb)
    apfloat.fp_add(eng, x, y, out, scr)
    got = apfloat.read_fp32(eng, out)
    want = va + vb
    exact_zero = want == 0
    assert np.all(got[exact_zero] == 0), got[exact_zero][:5]
    nz = ~exact_zero
    assert ulp_diff(got[nz], want[nz]).max() <= 4


# ---------------------------------------------------------------------------
# bit for bit against the reference
# ---------------------------------------------------------------------------

def _run(pkg, engine, op, va, vb, n_bits, **kw):
    eng, x, y, out, scr = build(len(va), n_bits, pkg, engine, **kw)
    pkg.load_fp32(eng, x, va)
    pkg.load_fp32(eng, y, vb)
    getattr(pkg, op)(eng, x, y, out, scr)
    return pkg.read_fp32(eng, out), eng.counters(), eng.trace_events()


def assert_same_run(got, want):
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  want[0].view(np.uint32))
    assert got[1] == want[1]               # cycles, events, float64 energy
    assert len(got[2]) == len(want[2])
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["jnp", "megakernel"])
@pytest.mark.parametrize("n", [64, 1024])
def test_fp_mul_is_the_references(n, backend):
    """``bench_cycles.py``'s inputs (normal draws seeded by N): results,
    counters, energy and trace as the reference's; the megakernel
    backend's too."""
    rng = np.random.default_rng(n)
    va = rng.normal(size=n).astype(np.float32)
    vb = rng.normal(size=n).astype(np.float32)
    want = _run(japf, JEngine, "fp_mul", va, vb, 256)
    got = _run(apfloat, APEngine, "fp_mul", va, vb, 256, backend=backend,
               device="cpu")
    assert_same_run(got, want)


@pytest.mark.parametrize("case", ["same_sign", "mixed", "cancel", "far"])
def test_fp_add_is_the_references(case):
    va, vb = add_operands(case, 128)
    assert_same_run(_run(apfloat, APEngine, "fp_add", va, vb, 512,
                         device="cpu"),
                    _run(japf, JEngine, "fp_add", va, vb, 512))


def test_helpers_are_the_references():
    """``_conditionalize``, ``_add_zext`` and ``_seeded_inc`` build the
    reference's pass schedules, table for table."""
    from repro.core.bitplane import Field as JField
    from repro_torch.core.bitplane import Field
    a, b, c = Field(0, 5), Field(5, 8), Field(13, 1)
    ja, jb, jc = JField(0, 5), JField(5, 8), JField(13, 1)
    pairs = [(apfloat._add_zext(a, b, c), japf._add_zext(ja, jb, jc)),
             (apfloat._seeded_inc(b, c, a.slice(0, 1)),
              japf._seeded_inc(jb, jc, ja.slice(0, 1)))]
    pairs.append((apfloat._conditionalize(pairs[0][0], 20, 1),
                  japf._conditionalize(pairs[0][1], 20, 1)))
    for got, want in pairs:
        for f in ("cmp_cols", "cmp_key", "w_cols", "w_key", "kc", "kw"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
