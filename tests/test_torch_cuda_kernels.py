"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the reference package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import arith, isa
from repro_torch.core.bitplane import Field
from repro_torch.core.engine import APEngine, PassSchedule, bucket_schedule
from repro_torch.kernels.ap_match import ops as ap_ops
from repro_torch.kernels.ap_megakernel import ops as mk_ops
from repro_torch.kernels.ap_megakernel import ref as mk_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mg_smooth import ops as mg_ops
from repro_torch.kernels.thermal_stencil import ops as st_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(7, 36, 36), (6, 7, 36, 36),
                                   (7, 40, 24), (2, 3, 5, 33)])
def test_stencil_kernel_equals_plain(cuda, shape):
    """The kernel repeats the plain version's arithmetic bit for bit
    (terms in the same order, built with -fmad=false)."""
    rng = np.random.default_rng(sum(shape))
    T = torch.from_numpy(rng.uniform(45, 75, shape).astype(np.float32))
    F = {k: torch.from_numpy(rng.uniform(0, 1e-2, shape).astype(np.float32))
         for k in st_ops.FIELD_KEYS}
    T, F = T.to(cuda), {k: v.to(cuda) for k, v in F.items()}
    before = st_ops.apply_operator_fields.launches
    y = st_ops.apply_operator_fields(T, F)
    assert st_ops.apply_operator_fields.launches == before + 1
    torch.testing.assert_close(y, st_ops.apply_operator_fields_plain(T, F),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape", [
    (1, 4, 4), (20, 8, 8), (3, 1, 9), (3, 9, 1), (1, 1, 1), (2, 3, 5, 33),
    (1, 7, 36, 36), (3, 17, 6, 7), (7, 384, 384)])
def test_stencil_kernel_edge_shapes_equal_plain(cuda, shape):
    """One thread a cell: L = 1 and L > 16, NY or NX of 1, NX not a
    multiple of 4 or 32, B = 1 and 3-D input, bit for bit, from a pack
    and from a dict of seven."""
    rng = np.random.default_rng(sum(shape) + 1)
    T = torch.from_numpy(rng.uniform(45, 75, shape).astype(np.float32))
    F = {k: torch.from_numpy(rng.uniform(0, 1e-2, shape).astype(np.float32))
         for k in st_ops.FIELD_KEYS}
    T, F = T.to(cuda), {k: v.to(cuda) for k, v in F.items()}
    pack = st_ops.pack_fields(F)
    want = st_ops.apply_operator_fields_plain(T, F)
    before = st_ops.apply_operator_fields.launches
    for fields in (pack, F):
        torch.testing.assert_close(st_ops.apply_operator_fields(T, fields),
                                   want, rtol=0, atol=0)
    assert st_ops.apply_operator_fields.launches == before + 2


def test_stencil_kernel_rejects_what_it_does_not_take(cuda):
    T = torch.zeros((3, 8, 8), device=cuda)
    F = {k: torch.zeros((3, 8, 8), device=cuda) for k in st_ops.FIELD_KEYS}
    with pytest.raises(ValueError):
        st_ops.apply_operator_fields(T.double(), F)
    with pytest.raises(ValueError):
        st_ops.apply_operator_fields(T, dict(F, g_pkg=F["g_pkg"].cpu()))
    pack = st_ops.pack_fields(F)
    with pytest.raises(ValueError):
        st_ops.apply_operator_fields(T[:, :4], pack)
    with pytest.raises(ValueError):
        st_ops.apply_operator_fields(T, st_ops.pack_fields(
            {k: v.cpu() for k, v in F.items()}))


def _smooth_case(shape, seed, cuda):
    rng = np.random.default_rng(seed)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)
    T = as_t(rng.uniform(45, 75, shape))
    b = as_t(rng.uniform(0, 1e-3, shape))
    F = {k: as_t(rng.uniform(0, 1e-2, shape)) for k in st_ops.FIELD_KEYS}
    for k in ("gz_up", "gx_lf", "gy_up"):   # void faces and top layer
        F[k][..., :1, :, :] = 0.0
    F["gz_dn"][..., -1:, :, :] = 0.0
    d = as_t(rng.uniform(0, 5e-2, shape))
    d[..., :, :2, :] = 0.0        # all-zero void columns: diag guard
    for k in F:
        F[k][..., :, :2, :] = 0.0
    return T, b, F, d


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("shape", [(7, 36, 36), (6, 7, 36, 36),
                                   (6, 7, 18, 18), (5, 40, 24),
                                   (2, 9, 5, 33), (1, 6, 6)])
def test_smoother_kernel_equals_plain(cuda, shape, color):
    """The red-black line sweep repeats its plain version bit for bit
    (sums in the same order, -fmad=false, IEEE division)."""
    T, b, F, d = _smooth_case(shape, sum(shape) + color, cuda)
    before = mg_ops.rb_line_sweep.launches
    got = mg_ops.rb_line_sweep(T, b, F, d, color)
    assert mg_ops.rb_line_sweep.launches == before + 1
    torch.testing.assert_close(
        got, mg_ops.rb_line_sweep_plain(T, b, F, d, color), rtol=0, atol=0)
    # a scalar d_extra is expanded as the reference's wrapper broadcasts it
    torch.testing.assert_close(
        mg_ops.rb_line_sweep(T, b, F, 0.0, color),
        mg_ops.rb_line_sweep_plain(T, b, F, torch.zeros_like(T), color),
        rtol=0, atol=0)


@pytest.mark.parametrize("inputs", ["pack", "dict", "level", "scalar"])
@pytest.mark.parametrize("shape", [(1, 9, 7), (2, 5, 6), (7, 35, 37),
                                   (16, 12, 12), (3, 7, 18, 18),
                                   (2, 16, 5, 9), (4, 1, 1, 3)])
def test_smoother_layers_and_inputs_equal_plain(cuda, shape, inputs):
    """L of 1, 2, 7 and 16 (each its own template instance), odd NX and
    NY, batched; the fields as a pack, a plain dict or a checked multigrid
    level, and a scalar d_extra: bit for bit, both colours."""
    T, b, F, d = _smooth_case(shape, sum(shape) + 3, cuda)
    if inputs == "pack":
        F = st_ops.pack_fields(F)
    elif inputs == "level":
        F, d = mg_ops.checked_level(F, d)
    elif inputs == "scalar":
        d = 0.0125
    want_d = torch.full_like(T, d) if inputs == "scalar" else d
    for color in (0, 1):
        before = mg_ops.rb_line_sweep.launches
        got = mg_ops.rb_line_sweep(T, b, F, d, color)
        assert mg_ops.rb_line_sweep.launches == before + 1
        torch.testing.assert_close(
            got, mg_ops.rb_line_sweep_plain(T, b, F, want_d, color),
            rtol=0, atol=0)


def test_smoother_level_is_checked_once_and_only_for_its_own_extra(cuda):
    """A checked level skips the field and d_extra checks for its own
    d_extra only; another tensor beside the same pack is checked."""
    T, b, F, d = _smooth_case((3, 8, 8), 5, cuda)
    pack, dl = mg_ops.checked_level(F, d)
    assert pack is not F and dl.data_ptr() == d.data_ptr()
    torch.testing.assert_close(mg_ops.rb_line_sweep(T, b, pack, dl, 1),
                               mg_ops.rb_line_sweep_plain(T, b, F, d, 1),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="d_extra"):
        mg_ops.rb_line_sweep(T, b, pack, d[:, :4].clone(), 1)
    with pytest.raises(ValueError):
        mg_ops.rb_line_sweep(T, b[:, :4], pack, dl, 1)


def test_smoother_kernel_rejects_what_it_does_not_take(cuda):
    T, b, F, d = _smooth_case((3, 8, 8), 0, cuda)
    with pytest.raises(ValueError):
        mg_ops.rb_line_sweep(T.double(), b, F, d, 0)
    with pytest.raises(ValueError):
        mg_ops.rb_line_sweep(T, b[:, :4], F, d, 0)
    with pytest.raises(ValueError):
        mg_ops.rb_line_sweep(T, b, F, d.cpu(), 0)
    # a column past the register path's depth is taken, not refused
    deep = torch.zeros((mg_ops.MAX_LAYERS + 1, 4, 4), device=cuda)
    Fb = {k: torch.zeros_like(deep) for k in st_ops.FIELD_KEYS}
    torch.testing.assert_close(mg_ops.rb_line_sweep(deep, deep, Fb, 0.0, 1),
                               deep, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(17, 36, 36), (6, 21, 36, 36),
                                   (32, 9, 7), (2, 17, 5, 33),
                                   (21, 384, 384)])
def test_smoother_deep_columns_equal_plain(cuda, shape):
    """Past MAX_LAYERS the kernel streams the column through its output:
    L of 17, 21 and 32, batched, odd widths, from a checked level and
    from a dict: bit for bit, both colours."""
    T, b, F, d = _smooth_case(shape, sum(shape) + 7, cuda)
    pack, dl = mg_ops.checked_level(F, d)
    for color in (0, 1):
        want = mg_ops.rb_line_sweep_plain(T, b, F, d, color)
        before = mg_ops.rb_line_sweep.launches
        got = mg_ops.rb_line_sweep(T, b, pack, dl, color)
        loose = mg_ops.rb_line_sweep(T, b, F, d, color)
        assert mg_ops.rb_line_sweep.launches == before + 2
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(loose, want, rtol=0, atol=0)


def test_sweep_past_the_smoother_layer_cap_raises(cuda, tmp_path):
    """A 12-die stack (17 layers) with the mg inner solve, once past the
    smoother kernel's register path, now runs on the card: every record
    finite with a verdict, none FAILED, and the smoother launched."""
    from repro_torch.sweep import SweepSpec, run_sweep
    spec = SweepSpec(workloads=("hist",), sizes=(4096,), n_dram=(12,),
                     grid_n=8, n_intervals=2, steps_per_interval=1,
                     n_cg=5, solver="mg")
    before = mg_ops.rb_line_sweep.launches
    res = run_sweep(spec, cache_dir=tmp_path, device="cuda")
    assert mg_ops.rb_line_sweep.launches > before
    assert res.n_failed == 0
    for r in res.records:
        assert np.isfinite(r.report.peak_C).all()


@pytest.mark.parametrize("shape", [(5, 384, 384), (5, 64, 64), (7, 40, 24),
                                   (3, 5, 16, 16), (1, 1, 7)])
def test_uniform_stencil_kernel_equals_plain(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    L = shape[-3]
    T = torch.from_numpy(rng.uniform(45, 75, shape).astype(np.float32))
    vecs = [torch.from_numpy(rng.uniform(0, 1e-1, L).astype(np.float32))
            for _ in range(4)]
    vecs[1][0] = 0.0        # no interface above the top layer
    vecs[2][-1] = 0.0       # nor below the spreader
    T, vecs = T.to(cuda), [v.to(cuda) for v in vecs]
    before = st_ops.apply_operator.launches
    y = st_ops.apply_operator_vectors(T, *vecs)
    assert st_ops.apply_operator.launches == before + 1
    torch.testing.assert_close(y, st_ops.apply_operator_plain(T, *vecs),
                               rtol=0, atol=0)
    # the reference's form: g_lat, g_vert, g_pkg
    g_vert = vecs[2][:-1] if L > 1 else 0.0     # scalar or [L-1]
    ref_form = st_ops.apply_operator(T, vecs[0], g_vert, 0.25)
    torch.testing.assert_close(
        ref_form, st_ops.apply_operator_plain(
            T, *st_ops.vectors(L, vecs[0], g_vert, 0.25, cuda)),
        rtol=0, atol=0)


@pytest.mark.parametrize("L", list(range(1, 17)) + [20])
@pytest.mark.parametrize("batch,ny,nx", [(None, 24, 32), (None, 9, 13),
                                         (3, 17, 36), (2, 5, 7)])
def test_uniform_stencil_every_layer_count_equals_plain(cuda, L, batch, ny,
                                                        nx):
    """One thread a cell, four x-adjacent cells a thread where NX is a
    multiple of 4 (else one): every layer count, batched and not, odd
    widths, from the pack and from four loose vectors, bit for bit; the
    inputs are left unchanged."""
    shape = (L, ny, nx) if batch is None else (batch, L, ny, nx)
    rng = np.random.default_rng(L * 1000 + ny * 10 + nx)
    T = torch.from_numpy(rng.uniform(45, 75, shape).astype(np.float32))
    g = rng.uniform(0, 1e-1, (4, L)).astype(np.float32)
    g[1, 0] = g[2, -1] = 0.0
    T = T.to(cuda)
    pack = st_ops.pack_vectors(tuple(torch.from_numpy(v).to(cuda)
                                     for v in g))
    T0, V0 = T.clone(), pack.data.clone()
    before = st_ops.apply_operator.launches
    got = st_ops.apply_operator_vectors(T, pack)
    loose = st_ops.apply_operator_vectors(T, *pack)
    assert st_ops.apply_operator.launches == before + 2
    want = st_ops.apply_operator_plain(T, *pack)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(loose, want, rtol=0, atol=0)
    assert torch.equal(T, T0) and torch.equal(pack.data, V0)


def test_uniform_stencil_unaligned_input_equals_plain(cuda):
    """A T whose storage does not start on 16 bytes takes a cell a
    thread."""
    L, ny, nx = 5, 8, 16
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.uniform(45, 75, L * ny * nx + 1)
                            .astype(np.float32)).to(cuda)
    T = flat[1:].view(L, ny, nx)
    assert T.data_ptr() % 16 != 0
    pack = st_ops.vectors(L, 0.05, 0.3, 0.1, cuda)
    torch.testing.assert_close(st_ops.apply_operator_vectors(T, pack),
                               st_ops.apply_operator_plain(T, *pack),
                               rtol=0, atol=0)


def test_uniform_stencil_kernel_rejects_bad_vectors(cuda):
    T = torch.zeros((3, 8, 8), device=cuda)
    v = torch.zeros(3, device=cuda)
    with pytest.raises(ValueError):
        st_ops.apply_operator_vectors(T, v, v, v, torch.zeros(2, device=cuda))
    with pytest.raises(ValueError):
        st_ops.apply_operator_vectors(T, v, v, v.cpu(), v)
    pack = st_ops.pack_vectors((v, v, v, v))
    with pytest.raises(ValueError, match="L = 3"):
        st_ops.apply_operator_vectors(torch.zeros((4, 8, 8), device=cuda),
                                      pack)
    with pytest.raises(ValueError, match="float32"):
        st_ops.apply_operator_vectors(T.double(), pack)


def _schedule(name):
    prod, carry = Field(20, 13), Field(33, 1)
    return {
        "add": lambda: isa.add(Field(0, 8), Field(8, 8), Field(16, 1)),
        "mul": lambda: PassSchedule.concat(arith.mul_schedules(
            Field(0, 6), Field(8, 6), prod, carry)),
        "lut": lambda: isa.lut(Field(0, 4), Field(34, 6),
                               lambda x: (x * x + 3) % 64),
    }[name]()


@pytest.mark.parametrize("n_lanes", [1, 4, 32, 33, 4096])
@pytest.mark.parametrize("name", ["add", "mul", "lut"])
def test_ap_kernel_equals_plain(cuda, name, n_lanes):
    tabs = interop.schedule_from_reference(*bucket_schedule(_schedule(name)),
                                           cuda)
    rng = np.random.default_rng(n_lanes)
    planes = interop.planes_from_reference(
        rng.integers(0, 2 ** 32, (40, n_lanes),
                     dtype=np.uint64).astype(np.uint32), cuda)
    before = ap_ops.run_schedule.launches
    got, m = ap_ops.run_schedule(planes, *tabs)
    assert ap_ops.run_schedule.launches == before + 1
    want, m_want = ap_ops.run_schedule_plain(planes, *tabs)
    assert torch.equal(got, want) and torch.equal(m, m_want)


def test_ap_kernel_rejects_out_of_range_columns(cuda):
    planes = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    tab = torch.tensor([[7]], dtype=torch.int32, device=cuda)
    with pytest.raises(IndexError):
        ap_ops.run_schedule(planes, tab, tab * 0, tab * 0, tab * 0)
    ok = torch.tensor([[1]], dtype=torch.int32, device=cuda)
    with pytest.raises(IndexError):
        ap_ops.run_schedule(planes, ok, ok, ok, ok, col_range=(0, 4))
    with pytest.raises(ValueError):
        ap_ops.run_schedule(planes, ok, ok, ok, ok, path="registers")


def _random_tables(rng, n_bits, P, kc, kw, lo=0):
    """A random schedule over columns [lo, n_bits): repeated columns in a
    pass, a write column also compared in the same and the next pass, and
    entries repeated as padding."""
    cc = rng.integers(lo, n_bits, (P, kc))
    wc = rng.integers(lo, n_bits, (P, kw))
    if P > 1 and kc > 1:
        cc[1:, -1] = wc[:-1, 0]          # the next pass compares a write
        cc[:, 0] = wc[:, -1]             # the same pass compares it too
    if kw > 1:
        wc[::3, 1] = wc[::3, 0]          # one column written twice
    if kc > 2:
        cc[::2, 2] = cc[::2, 0]          # a repeated compare entry
    ck = rng.integers(0, 2, (P, kc))
    wk = rng.integers(0, 2, (P, kw))
    return [np.ascontiguousarray(a, np.int32) for a in (cc, ck, wc, wk)]


def _ap_case(cuda, n_bits, n_lanes, P, kc, kw, seed, lo=0):
    rng = np.random.default_rng(seed)
    tables = _random_tables(rng, n_bits, P, kc, kw, lo)
    planes = interop.planes_from_reference(
        rng.integers(0, 2 ** 32, (n_bits, n_lanes),
                     dtype=np.uint64).astype(np.uint32), cuda)
    tabs = [torch.from_numpy(t).to(cuda) for t in tables]
    cols = np.concatenate([tables[0].ravel(), tables[2].ravel()])
    col_range = (int(cols.min()), int(cols.max())) if P else (0, 0)
    return planes, tabs, col_range


@pytest.mark.parametrize("path", [None, "shared", "global"])
@pytest.mark.parametrize("n_bits,n_lanes,P,kc,kw", [
    (1, 1, 5, 1, 1), (7, 31, 9, 2, 2), (40, 33, 300, 4, 2),
    (12, 32768, 64, 4, 2), (402, 32, 256, 4, 2), (30, 5, 2500, 3, 3),
    (64, 40, 20, 16, 16), (26, 129, 200, 8, 1)])
def test_ap_kernel_paths_equal_plain(cuda, path, n_bits, n_lanes, P, kc,
                                     kw):
    """Both paths bit for bit: n_lanes of 1, 31, 33 and 32768; P past one
    table chunk (2500 > 1024); Kc and Kw that are not powers of two; a
    write column compared in its own pass and the next; repeated
    entries."""
    planes, tabs, col_range = _ap_case(cuda, n_bits, n_lanes, P, kc, kw,
                                       seed=n_bits * 31 + n_lanes + P)
    before = ap_ops.run_schedule.launches
    got, m = ap_ops.run_schedule(planes, *tabs, col_range=col_range,
                                 path=path)
    assert ap_ops.run_schedule.launches == before + 1
    want, m_want = ap_ops.run_schedule_plain(planes, *tabs)
    assert torch.equal(got, want) and torch.equal(m, m_want)
    if path is None:
        assert ap_ops.kernel_path(n_lanes, col_range, P, kc, kw) == "shared"


@pytest.mark.parametrize("n_bits,lo,n_lanes", [(2000, 0, 33), (2000, 1990, 33),
                                               (1900, 0, 1)])
def test_ap_kernel_tile_past_shared_memory(cuda, n_bits, lo, n_lanes):
    """Rows past one shared-memory tile (2000 x 128 B > 227 KB) take the
    device-memory path; the same planes with a narrow column range keep
    the shared-memory one (the rows outside it are copied through)."""
    planes, tabs, col_range = _ap_case(cuda, n_bits, n_lanes, 40, 4, 2,
                                       seed=n_bits + lo, lo=lo)
    expect = "shared" if col_range[1] - col_range[0] < 1500 else "global"
    assert ap_ops.kernel_path(n_lanes, col_range, 40, 4, 2) == expect
    got, m = ap_ops.run_schedule(planes, *tabs, col_range=col_range)
    want, m_want = ap_ops.run_schedule_plain(planes, *tabs)
    assert torch.equal(got, want) and torch.equal(m, m_want)
    if expect == "global":
        with pytest.raises(RuntimeError):
            ap_ops.run_schedule(planes, *tabs, col_range=col_range,
                                path="shared")


def test_ap_kernel_empty_schedule_and_wide_tables(cuda):
    """P = 0 launches nothing and returns the planes and no counts; Kc
    above 16 takes the device-memory path."""
    planes, tabs, _ = _ap_case(cuda, 8, 3, 0, 2, 1, seed=0)
    before = ap_ops.run_schedule.launches
    got, m = ap_ops.run_schedule(planes, *tabs)
    assert ap_ops.run_schedule.launches == before
    assert torch.equal(got, planes) and m.shape == (0,)
    planes, tabs, col_range = _ap_case(cuda, 40, 33, 30, 17, 2, seed=1)
    assert ap_ops.kernel_path(33, col_range, 30, 17, 2) == "global"
    got, m = ap_ops.run_schedule(planes, *tabs)
    want, m_want = ap_ops.run_schedule_plain(planes, *tabs)
    assert torch.equal(got, want) and torch.equal(m, m_want)


def test_ap_latency_probe(cuda):
    """The probe's chains take some cycles each, at a clock of a card."""
    t = ap_ops.latency_probe(cuda, iters=256)
    assert 5 < t["load_cycles"] < 200 and 1 < t["alu_cycles"] < 50
    assert t["rmw_cycles"] >= t["alu_cycles"] and 0.5 < t["sm_ghz"] < 3.0


def _random_group(rng, n_bits, P, conditional):
    """Random ops of every kind; repeated write columns allowed."""
    ops = []
    for p in range(P):
        opc = int(rng.integers(0, 4))
        cond = int(rng.integers(0, min(p, mk_ref.MAX_COND) + 1)) \
            if conditional else 0
        nc, nw = int(rng.integers(1, 4)), int(rng.integers(1, 3))
        ops.append((opc, cond, rng.integers(0, n_bits, nc).tolist(),
                    rng.integers(0, 2, nc).tolist(),
                    rng.integers(0, n_bits, nw).tolist(),
                    rng.integers(0, 2, nw).tolist()))
    return mk_ref.OpGroup.build(ops)


@pytest.mark.parametrize("P", [7, 1024])
@pytest.mark.parametrize("kind", ["conditional", "unconditional",
                                  "disabled"])
@pytest.mark.parametrize("n_lanes", [1, 31, 32, 129, 32768])
def test_megakernel_equals_plain(cuda, n_lanes, kind, P):
    """Planes, tag and matched bit for bit against the plain version; 129
    lanes do not fill the last CTA tile of an unconditional group."""
    rng = np.random.default_rng(n_lanes * 7 + P)
    n_bits = 10
    group = _random_group(rng, n_bits, P, kind == "conditional")
    planes = interop.planes_from_reference(
        rng.integers(0, 2 ** 32, (n_bits, n_lanes),
                     dtype=np.uint64).astype(np.uint32), cuda)
    tag = interop.planes_from_reference(
        rng.integers(0, 2 ** 32, (1, n_lanes),
                     dtype=np.uint64).astype(np.uint32), cuda)[0]
    enabled = (np.zeros(P, bool) if kind == "disabled"
               else rng.integers(0, 4, P) > 0)
    before = mk_ops.run_group.launches
    got_p, got_t, got_m = mk_ops.run_group(planes, tag, group, enabled)
    assert mk_ops.run_group.launches == before + 1
    want_p, want_t, want_m, _ = mk_ref.group_scan_plain(
        planes, tag, group.tables(), enabled)
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_t, want_t)
    assert torch.equal(got_m, want_m)
    if kind == "disabled":
        assert torch.equal(got_p, planes) and int(got_m.abs().sum()) == 0


def _wide_group(rng, n_bits, P):
    """Random conditional ops of every kind with one to six compare and
    write terms, so an op's record can hold two groups of four."""
    ops = []
    for p in range(P):
        nc, nw = int(rng.integers(1, 7)), int(rng.integers(1, 7))
        ops.append((int(rng.integers(0, 4)),
                    int(rng.integers(0, min(p, mk_ref.MAX_COND) + 1)),
                    rng.integers(0, n_bits, nc).tolist(),
                    rng.integers(0, 2, nc).tolist(),
                    rng.integers(0, n_bits, nw).tolist(),
                    rng.integers(0, 2, nw).tolist()))
    return mk_ref.OpGroup.build(ops)


#: conditional groups on both sides of every cluster-size and path
#: boundary of ops.plan_conditional: (n_bits, n_lanes) -> (path, cluster)
CLUSTER_SHAPES = {
    (10, 1024): ("shared", 1), (10, 1025): ("shared", 2),
    (10, 2048): ("shared", 2), (10, 2049): ("shared", 4),
    (10, 4097): ("shared", 8), (10, 8193): ("shared", 16),
    (10, 65536): ("shared", 16), (10, 65537): ("global", 16),
    (200, 32768): ("global", 16), (2000, 33): ("global", 1),
}


@pytest.mark.parametrize("shape", sorted(CLUSTER_SHAPES))
def test_megakernel_cluster_paths_equal_plain(cuda, shape):
    """Each cluster size and both paths, chosen by shape: random
    conditional groups with up to six compare and write terms (two record
    groups), lookbacks 1-4 and disabled ops, bit for bit."""
    n_bits, n_lanes = shape
    rng = np.random.default_rng(n_bits * 100003 + n_lanes)
    group = _wide_group(rng, n_bits, 24)
    lo, hi = int(min(group.cmp_cols.min(), group.w_cols.min())), \
        int(max(group.cmp_cols.max(), group.w_cols.max()))
    plan = mk_ops.plan_conditional(n_lanes, hi - lo + 1, group.n_ops,
                                   group.cmp_cols.shape[1],
                                   group.w_cols.shape[1])
    assert (plan.path, plan.cluster) == CLUSTER_SHAPES[shape]
    planes = interop.planes_from_reference(
        rng.integers(0, 2 ** 32, (n_bits, n_lanes),
                     dtype=np.uint64).astype(np.uint32), cuda)
    tag = interop.planes_from_reference(
        rng.integers(0, 2 ** 32, (1, n_lanes),
                     dtype=np.uint64).astype(np.uint32), cuda)[0]
    enabled = rng.integers(0, 4, group.n_ops) > 0
    before = mk_ops.run_group.launches
    got = mk_ops.run_group(planes, tag, group, enabled)
    assert mk_ops.run_group.launches == before + 1
    want = mk_ref.group_scan_plain(planes, tag, group.tables(), enabled)
    for a, b in zip(got, want[:3]):
        assert torch.equal(a, b)


def _unconditional_group(rng, n_bits, P, max_c, max_w):
    """Random unconditional ops of every kind with up to ``max_c`` compare
    and ``max_w`` write terms, a CMP_TAG after a CMP and a column written
    twice in one op."""
    ops = []
    for _ in range(P):
        nc, nw = int(rng.integers(1, max_c + 1)), int(rng.integers(1,
                                                                   max_w + 1))
        ops.append((int(rng.integers(0, 4)), 0,
                    rng.integers(0, n_bits, nc).tolist(),
                    rng.integers(0, 2, nc).tolist(),
                    rng.integers(0, n_bits, nw).tolist(),
                    rng.integers(0, 2, nw).tolist()))
    ops[1] = (mk_ref.OP_CMP, 0, [1, 2], [1, 0], [], [])
    ops[2] = (mk_ref.OP_CMP_TAG, 0, [3], [1], [], [])
    ops[-1] = (mk_ref.OP_WRITE, 0, [], [], [3, 5, 3], [1, 0, 0])
    return mk_ref.OpGroup.build(ops)


#: unconditional groups on each path, lanes-a-thread value and chunking:
#: (n_bits, n_lanes, ops, max Kc, max Kw) -> (path, lanes a thread)
UNCONDITIONAL_SHAPES = {
    (12, 32, 40, 2, 1): ("shared", 1),        # one CTA, one warp
    (12, 31, 40, 4, 2): ("shared", 1),        # lanes not filling the CTA
    (12, 1025, 40, 8, 4): ("shared", 1),      # a ragged last CTA
    (12, 32769, 40, 6, 2): ("shared", 2),
    (12, 100000, 40, 3, 3): ("shared", 4),    # 4 lanes a thread
    (12, 2 ** 20, 24, 2, 1): ("shared", 4),
    (12, 4096, 600, 10, 6): ("shared", 1),    # chunks; groups out of line
    (2000, 33, 40, 6, 4): ("global", 0),      # tile past one CTA
    (2000, 1000, 300, 9, 5): ("global", 0),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", sorted(UNCONDITIONAL_SHAPES))
def test_megakernel_unconditional_paths_equal_plain(cuda, shape, masked):
    """The unconditional path bit for bit (planes, tag, matched) on both
    of its paths, every lanes-a-thread value, more ops than a chunk, with
    and without an enabled mask; the inputs are left unchanged."""
    n_bits, n_lanes, P, max_c, max_w = shape
    rng = np.random.default_rng(n_bits * 7 + n_lanes + P)
    group = _unconditional_group(rng, n_bits, P, max_c, max_w)
    cols = np.concatenate([group.cmp_cols.ravel(), group.w_cols.ravel()])
    plan = mk_ops.plan_unconditional(n_lanes, int(cols.max() - cols.min())
                                     + 1, P, group.cmp_cols.shape[1],
                                     group.w_cols.shape[1])
    assert (plan.path, plan.lpt) == UNCONDITIONAL_SHAPES[shape]
    if P == 600:
        assert plan.chunk < P
    planes = interop.planes_from_reference(
        rng.integers(0, 2 ** 32, (n_bits, n_lanes),
                     dtype=np.uint64).astype(np.uint32), cuda)
    tag = interop.planes_from_reference(
        rng.integers(0, 2 ** 32, (1, n_lanes),
                     dtype=np.uint64).astype(np.uint32), cuda)[0]
    enabled = rng.integers(0, 4, P) > 0 if masked else None
    p0, t0 = planes.clone(), tag.clone()
    before = (mk_ops.run_group.launches,
              mk_ops.run_group.unconditional_launches)
    got = mk_ops.run_group(planes, tag, group, enabled)
    assert (mk_ops.run_group.launches,
            mk_ops.run_group.unconditional_launches) == \
        (before[0] + 1, before[1] + 1)
    want = mk_ref.group_scan_plain(planes, tag, group.tables(), enabled)
    for a, b, what in zip(got, want[:3], ("planes", "tag", "matched")):
        assert torch.equal(a, b), what
    assert torch.equal(planes, p0) and torch.equal(tag, t0)
    # a second launch on the same stream reuses the counts' accumulator
    again = mk_ops.run_group(planes, tag, group, enabled)
    for a, b in zip(again, want[:3]):
        assert torch.equal(a, b)


def test_megakernel_unconditional_on_two_streams(cuda):
    """Launches on two streams keep their counts apart (one accumulator a
    stream)."""
    rng = np.random.default_rng(9)
    group = _unconditional_group(rng, 10, 64, 3, 2)
    planes = interop.planes_from_reference(
        rng.integers(0, 2 ** 32, (10, 8192),
                     dtype=np.uint64).astype(np.uint32), cuda)
    tag = torch.full((8192,), -1, dtype=torch.int32, device=cuda)
    want = mk_ref.group_scan_plain(planes, tag, group.tables())
    dg = mk_ops.device_group(group, cuda)
    side = torch.cuda.Stream()
    outs = []
    for s in (torch.cuda.current_stream(), side, side,
              torch.cuda.current_stream()):
        with torch.cuda.stream(s):
            outs.append(mk_ops.run_group(planes, tag, dg))
    torch.cuda.synchronize()
    for got in outs:
        for a, b in zip(got, want[:3]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n_lanes", [32, 1025, 32768])
def test_megakernel_sort_round_with_nothing_to_match(cuda, n_lanes):
    """A sort round with no active word: every probe and the tie group
    count 0, every conditional op is skipped, and matched is written as
    zeros where those ops did not run (the wrapper fills nothing)."""
    from repro_torch.workloads import _device
    val, active, cand = Field(0, 8), Field(8, 1), Field(9, 1)
    group = _device._min_extract_group(isa.copy(cand, active), val, active,
                                       cand, readout=False)
    rng = np.random.default_rng(n_lanes)
    planes = interop.planes_from_reference(
        rng.integers(0, 2 ** 32, (10, n_lanes),
                     dtype=np.uint64).astype(np.uint32), cuda)
    planes[8] = 0
    tag = torch.full((n_lanes,), -1, dtype=torch.int32, device=cuda)
    dg = mk_ops.device_group(group, cuda)
    got = mk_ops.run_group(planes, tag, dg)
    want = mk_ref.group_scan_plain(planes, tag, group.tables())
    for a, b in zip(got, want[:3]):
        assert torch.equal(a, b)
    assert int(got[2][2:].abs().sum()) == 0   # past the two copy passes
    assert int(want[3].sum()) == 2 + 8 + 1    # copies, probes, tie group


def test_megakernel_cluster_probe(cuda):
    t = mk_ops.cluster_probe(cuda, iters=256)
    assert 10 < t["barrier_cycles"] < 20000
    assert 10 < t["dsmem_cycles"] < 20000
    assert 10 < t["op_cycles"] < 2000 and 0.5 < t["sm_ghz"] < 3.0


def test_megakernel_rejects_what_it_does_not_take(cuda):
    group = mk_ref.OpGroup.probes([[7]], [[1]])
    planes = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    tag = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(IndexError):
        mk_ops.run_group(planes, tag, group)
    ok = mk_ref.OpGroup.probes([[1]], [[1]])
    with pytest.raises(ValueError):
        mk_ops.run_group(planes.double(), tag, ok)
    with pytest.raises(ValueError):
        mk_ops.run_group(planes, tag.cpu(), ok)


@pytest.mark.parametrize("mode", ["eager", "device", "megakernel"])
@pytest.mark.parametrize("w", ["sort", "knn", "hist", "spmv"])
def test_suite_workloads_card_equals_host(cuda, w, mode):
    """Each suite workload's counters and trace events are identical on
    the card and on the host; megakernel mode launches the megakernel."""
    from repro_torch.workloads import registry
    before = mk_ops.run_group.launches
    on_card = registry.trace_counters(w, 64, mode=mode, device="cuda")
    launched = mk_ops.run_group.launches - before
    on_host = registry.trace_counters(w, 64, mode=mode, device="cpu")
    assert set(on_card) == set(on_host)
    for k, v in on_host.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(on_card[k], v, err_msg=k)
        else:
            assert on_card[k] == v, k
    assert (launched > 0) == (mode == "megakernel")


def test_engine_megakernel_run_card_equals_host(cuda):
    """APEngine.run with the megakernel backend: planes, tag, counters and
    trace on the card equal the host's."""
    engines = [APEngine(64, 40, backend="megakernel", device=d)
               for d in ("cuda", "cpu")]
    vals = np.random.default_rng(3).integers(0, 64, 64, dtype=np.uint64)
    for eng in engines:
        eng.load(Field(0, 6), vals)
        eng.load(Field(8, 6), vals[::-1].copy())
        eng.run(_schedule("mul"))
    card, host = engines
    assert torch.equal(card.planes.cpu(), host.planes)
    assert card.counters() == host.counters()
    for a, b in zip(card.trace_events(), host.trace_events()):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def one_card_shards(cuda, monkeypatch):
    """Four "local devices", each the one card: n shards run on one card
    (the mechanism, not several cards)."""
    from repro_torch.parallel import sharding
    monkeypatch.setattr(sharding, "local_devices",
                        lambda device="cuda": (torch.device("cuda", 0),) * 4)
    return sharding


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("n_lanes", [32, 1024, 32768])
def test_sharded_sort_round_equals_unsharded_kernel(one_card_shards,
                                                    n_lanes, n_shards):
    """A sort round lane-sharded on (cuda:0,)*n: its segments launch the
    kernel on every shard, and planes, tag and the summed counts equal
    the unsharded kernel's and the plain version's, with no plain
    version called on the card."""
    from repro_torch.workloads import _device
    val, active, cand = Field(0, 8), Field(8, 1), Field(9, 1)
    group = _device._min_extract_group(isa.copy(cand, active), val, active,
                                       cand, readout=False)
    rng = np.random.default_rng(n_lanes + n_shards)
    host = interop.planes_from_reference(
        rng.integers(0, 2 ** 32, (10, n_lanes),
                     dtype=np.uint64).astype(np.uint32), "cpu")
    tag = torch.zeros(n_lanes, dtype=torch.int32)
    planes = host.cuda()
    want = mk_ops.run_group(planes, tag.cuda(), group)
    mesh = one_card_shards.ap_mesh(n_shards, device="cuda")
    sg = mk_ops.sharded_group(group, mesh)
    before = mk_ops.run_group.launches
    real_plain = mk_ref.group_scan_plain

    def no_plain(*a, **kw):
        raise AssertionError("a plain version ran on the card")

    mk_ref.group_scan_plain = no_plain
    try:
        got = mk_ops.run_group(planes, tag.cuda(), sg, mesh=mesh)
    finally:
        mk_ref.group_scan_plain = real_plain
    assert mk_ops.run_group.launches - before == len(sg.segments) * n_shards
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    plain = mk_ref.group_scan_plain(host, tag, group.tables())
    for a, b in zip(got, plain[:3]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("w", ["sort", "knn", "hist", "spmv"])
def test_sharded_suite_workloads_equal_unsharded_on_the_card(
        one_card_shards, monkeypatch, w):
    """The suite's megakernel-mode traces with every group lane-sharded
    over 2 and 4 shards on the card: counters and trace events equal the
    unsharded card run's."""
    import functools
    from repro_torch.workloads import histogram, knn, registry, sort, spmv
    mod, name = {"sort": (sort, "ap_sort"), "knn": (knn, "ap_knn"),
                 "hist": (histogram, "ap_histogram"),
                 "spmv": (spmv, "ap_spmv")}[w]
    want = registry.trace_counters(w, 256, mode="megakernel", device="cuda")
    real = getattr(mod, name)
    for n in (2, 4):
        monkeypatch.setattr(mod, name, functools.partial(real, n_shards=n))
        got = registry.trace_counters(w, 256, mode="megakernel",
                                      device="cuda")
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=f"{n} {k}")


@pytest.mark.parametrize("solver,workloads", [
    ("pcg", ("hist", "sort", "dmm")), ("mg", ("hist", "sort", "dmm")),
    ("pcg", ("hist", "sort")), ("mg", ("hist", "sort"))])
def test_sharded_replay_equals_unsharded_on_the_card(one_card_shards,
                                                     solver, workloads):
    """A case batch of 6 (or 4: one case a shard on 4 shards) on 1, 3 and
    4 shards of the one card: every report array bit for bit the
    unsharded batch's (no per-case sum, factor or coarse solve depends
    on the batch size: ``thermal.case_sum``,
    ``multigrid.coarse_factorization``)."""
    from repro_torch.sweep import SweepSpec, run_sweep
    spec = SweepSpec(workloads=workloads, sizes=(4096,), n_dram=(2,),
                     machines=("ap", "simd"), grid_n=8, n_intervals=4,
                     steps_per_interval=1, n_cg=15, solver=solver)
    ref = run_sweep(spec, use_cache=False, device="cuda")
    for n in (1, 3, 4):
        got = run_sweep(spec, use_cache=False, n_shards=n, device="cuda")
        for a, b in zip(ref.records, got.records):
            for f in ("peak_C", "min_C", "residual_C", "throttle",
                      "refresh_W", "leak_W", "dyn_W"):
                np.testing.assert_array_equal(
                    getattr(a.report, f).view(np.uint32),
                    getattr(b.report, f).view(np.uint32),
                    err_msg=f"{n} {a.label} {f}")


@pytest.mark.parametrize("shape", [(7, 36, 36), (5, 48, 48), (6, 12, 12),
                                   (17, 36, 36)])
def test_case_sum_is_batch_invariant_on_the_card(cuda, shape):
    """A case's ``case_sum`` is the same bits in a batch of 1-8 as in a
    batch of 16 (a CUDA sum over a case's whole volume is not)."""
    from repro_torch.core import thermal
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(16,) + shape).astype(np.float32)).to(cuda)
    full = thermal.case_sum(x)
    for B in range(1, 9):
        got = torch.cat([thermal.case_sum(x[i:i + B])
                         for i in range(0, 16 - 16 % B, B)])
        assert torch.equal(got, full[:got.shape[0]]), B
    assert torch.equal(thermal.case_sum(x, keepdim=True).flatten(), full)


def test_coarse_solve_is_batch_invariant_on_the_card(cuda):
    """The mg replay's coarsest factor and solve give a case the same bits
    in a batch of 1-5 as in a batch of 6."""
    import math
    from repro_torch.core import cosim, multigrid, thermal
    from repro_torch.core.floorplan import MM
    grids = [thermal.Grid(die_w=math.sqrt(a) * MM, ny=24, nx=24, margin=6)
             for w in ("dmm", "fft", "bs")
             for dp in (cosim.comparable_design_point(w),)
             for a in (dp.ap_area_mm2, dp.simd_area_mm2)]
    Fs = [g.fields(cuda) for g in grids]
    F = {k: torch.stack([f[k] for f in Fs]) for k in Fs[0]}
    cap = torch.stack([g.capacity_field(cuda) for g in grids])
    b = torch.from_numpy(np.random.default_rng(2).normal(
        size=tuple(cap.shape)).astype(np.float32)).to(cuda)

    def coarse_of(sl):
        levels = multigrid.build_levels({k: v[sl] for k, v in F.items()},
                                        cap[sl] / 0.0025)
        rhs = torch.zeros_like(levels[-1][0]["g_pkg"]) + b[sl, :, :1, :1]
        return multigrid.coarse_solve_fn(levels)(rhs)

    full = coarse_of(slice(0, 6))
    for B in range(1, 6):
        got = torch.cat([coarse_of(slice(i, i + B))
                         for i in range(0, 6 - 6 % B, B)])
        assert torch.equal(got, full[:got.shape[0]]), B


#: the flash kernel sums in another order than the plain version's
#: materialised softmax: 1e-4 absolute at float32 (outputs of magnitude
#: below 1); for bfloat16 inputs both round that float32 result to
#: bfloat16, so one bfloat16 step (2^-7 relative) more.  (rtol, atol)
FLASH_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-4)}


def _flash_inputs(shape_q, shape_kv, dtype, seed, cuda):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(cuda, dtype) for s in (shape_q, shape_kv, shape_kv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,sq,sk,hq,hkv,dh,window", [
    (1, 4096, 4096, 32, 32, 64, None),   # causal MHA, no window
    (1, 512, 512, 32, 8, 120, 200),      # the serving path's GQA, dh, window
    (2, 1040, 1040, 32, 8, 120, 1000),   # the same at B = 2, ragged last tile
    (1, 50, 70, 2, 1, 16, None),         # ragged
    (2, 1, 96, 4, 4, 32, None),          # decode
    (2, 64, 64, 4, 2, 32, 16),           # window inside a tile
    (1, 8, 8, 2, 2, 16, 0),              # every row fully masked
    # the kernel's tile edges: a CTA takes 128 query rows, a key tile is
    # 64 keys, the K/V ring has two stages of one tile each
    (1, 127, 127, 4, 2, 64, None),       # one less than 128 and 2 x 64
    (1, 129, 129, 4, 2, 64, None),       # one more than 128 and 2 x 64
    (1, 255, 319, 4, 1, 32, None),       # one less than 2 x 128 and 5 x 64
    (1, 257, 321, 4, 1, 32, None),       # one more than 2 x 128 and 5 x 64
    (1, 300, 300, 4, 2, 64, 100),        # window edge inside a ring stage
    (2, 300, 300, 8, 2, 128, 150),       # dh = 128 at B = 2
    (2, 300, 300, 8, 2, 120, None),      # dh = 120 at B = 2
])
def test_flash_kernel_matches_plain(cuda, B, sq, sk, hq, hkv, dh, window,
                                    causal, dtype):
    q, k, v = _flash_inputs((B, sq, hq, dh), (B, sk, hkv, dh), dtype,
                            sq + sk + dh, cuda)
    before = fa_ops.mha.launches
    got = fa_ops.mha(q, k, v, causal=causal, window=window)
    assert fa_ops.mha.launches == before + 1
    want = fa_ops.mha(q, k, v, causal=causal, window=window,
                      backend="plain")
    assert fa_ops.mha.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert torch.isfinite(got).all()


#: the backward kernel against autograd through the plain version, as a
#: normwise relative gap ||got - want|| / ||want|| of each of dq, dk, dv:
#: float32 both (the kernel sums in another order and takes exp of
#: s * scale - lse where the plain softmax divides), so about 1e-6 is
#: expected; bfloat16 inputs give the plain version float32 gradients of
#: the same bf16 values while the kernel rounds its own to bf16 (2^-9
#: relative each), and its forward output, which D = rowsum(dO O) reads,
#: is the float32 one
FLASH_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _flash_grads(q, k, v, d_out, **mask):
    """(out, dq, dk, dv) through ``fa_ops.mha`` on the card."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fa_ops.mha(*leaves, **mask)
    return (out, *torch.autograd.grad(out, leaves, d_out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,sq,sk,hq,hkv,dh,causal,window", [
    (1, 256, 256, 8, 8, 64, True, None),      # causal MHA
    (2, 256, 256, 8, 2, 120, True, 64),       # GQA, dh 120, window
    (2, 224, 1500, 8, 8, 64, False, None),    # cross attention, Sq != Sk
    (1, 100, 130, 4, 2, 32, True, None),      # ragged, causal offset 30
    (1, 8, 8, 2, 2, 16, True, 0),             # every row fully masked
    (1, 100, 64, 4, 2, 64, True, None),       # Sq > Sk: 36 rows see none
    (1, 70, 70, 4, 4, 128, True, 8),          # a window of 8 keys
    (2, 1, 96, 4, 4, 32, False, None),        # one query row
    # the tile edges: 64 keys (dK/dV) and 64 query rows (dQ) a CTA, and
    # looped-over tiles of 64 rows for dh <= 64 and 32 above; one less
    # and one more than each in Sq and Sk, every head dim
    (1, 63, 65, 2, 1, 16, True, None),
    (1, 65, 63, 2, 2, 32, True, None),
    (1, 127, 129, 4, 2, 64, False, None),
    (1, 129, 127, 4, 4, 64, True, None),
    (1, 31, 33, 2, 1, 120, True, None),
    (1, 33, 31, 2, 2, 128, False, None),
    (1, 64, 64, 2, 2, 128, True, None),       # the causal diagonal tile
    (2, 97, 97, 4, 2, 120, True, 10),         # a window inside a tile
    (1, 130, 130, 2, 1, 16, True, 3),         # a window of 3 keys
])
def test_flash_backward_matches_plain_autograd(cuda, B, sq, sk, hq, hkv, dh,
                                               causal, window, dtype):
    q, k, v = _flash_inputs((B, sq, hq, dh), (B, sk, hkv, dh), dtype,
                            sq + sk + dh, cuda)
    d_out = _flash_inputs((B, sq, hq, dh), (1,), dtype, sq + 1, cuda)[0]
    mask = dict(causal=causal, window=window)
    before = (fa_ops.mha.launches, fa_ops.mha_backward.launches)
    out, *got = _flash_grads(q, k, v, d_out, **mask)
    assert (fa_ops.mha.launches, fa_ops.mha_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    want = fa_ops._ref.mha_backward(q.float(), k.float(), v.float(),
                                    d_out.float(), **mask)
    for name, g, w, x in zip("qkv", got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape, name
        assert torch.isfinite(g).all(), name
        if w.norm() == 0:
            assert g.float().abs().max() == 0, name
        else:
            assert _rel(g, w) <= FLASH_BWD_TOL[dtype], (name, _rel(g, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_deterministic(cuda, dtype):
    """No atomics: two runs give the same bits (the trainer's restart
    contract needs them)."""
    q, k, v = _flash_inputs((2, 300, 8, 64), (2, 300, 2, 64), dtype, 5, cuda)
    d_out = _flash_inputs((2, 300, 8, 64), (1,), dtype, 6, cuda)[0]
    a = _flash_grads(q, k, v, d_out, causal=True, window=100)
    b = _flash_grads(q, k, v, d_out, causal=True, window=100)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_gradients_reach_the_projections(cuda):
    """Through ``mha`` on a CUDA tensor every one of q.grad, k.grad and
    v.grad is set and non-zero: the kernel's output carries a grad_fn."""
    q, k, v = (t.requires_grad_(True) for t in _flash_inputs(
        (1, 128, 4, 64), (1, 128, 2, 64), torch.float32, 7, cuda))
    out = fa_ops.mha(q, k, v, causal=True)
    assert out.grad_fn is not None
    out.square().sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and t.grad.abs().max() > 0


def test_flash_forward_lse_matches_plain(cuda):
    """The forward kernel's row log-sum-exp: the plain logsumexp of the
    scaled, masked scores, and +inf on a row with no visible key."""
    q, k, v = _flash_inputs((1, 100, 4, 64), (1, 130, 2, 64),
                            torch.float32, 8, cuda)
    _, _, lse = fa_ops._forward(q, k, v, True, 40, 64 ** -0.5, True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, 2)) \
        * 64 ** -0.5
    mask = fa_ops._ref.attention_mask(100, 130, causal=True, window=40,
                                      device=q.device)
    want = torch.logsumexp(torch.where(mask, s, -torch.inf), -1)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)
    _, _, lse0 = fa_ops._forward(q, k, v, True, 0, 64 ** -0.5, True)
    assert torch.isinf(lse0).all() and (lse0 > 0).all()


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 4, 40), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.mha(q, q, q)
    q = torch.zeros((1, 8, 4, 32), device=cuda)
    with pytest.raises(ValueError):
        fa_ops.mha(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(ValueError):
        fa_ops.mha(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        fa_ops.mha(q, q.cpu(), q.cpu())
    with pytest.raises(ValueError, match="window"):
        fa_ops.mha(q, q, q, window=-1)
