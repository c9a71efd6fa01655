"""PyTorch port vs the JAX reference: geometric multigrid and its
red-black z-line smoother.

Both packages run on the same DRAM-on-logic grids and numpy-seeded
vectors; the reference's Pallas smoother runs in interpret mode, as
``tests/test_kernel_mg_smooth.py`` runs it.  Tolerances, float32
throughout:

- coarsening, restriction and prolongation are sums of four terms:
  rtol 1e-6;
- the line solve and the half-sweep: rtol and atol 1e-5, as the
  reference holds its Pallas kernel to its jnp oracle (the port sums the
  lateral terms in the Pallas kernel's order, the jnp oracle in
  another);
- V-cycles and fixed-cycle iterations: rtol 1e-4 (a dense Cholesky on the
  coarsest level and several sweeps compound the rounding).

Every port function also takes a leading case dimension ``[B, ...]``;
each case of a batch must equal the reference applied to that case alone.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import multigrid as jmg
from repro.core import thermal as jthermal
from repro.kernels.mg_smooth import ops as jsmooth
from repro.stack.spec import dram_on_logic as j_dram_on_logic
from repro_torch import interop
from repro_torch.core import multigrid as tmg
from repro_torch.kernels.mg_smooth import ops as tsmooth


def _fields(n=16, margin=4, n_dram=2, die_w=5e-3):
    grid = jthermal.Grid(die_w=die_w, ny=n, nx=n, margin=margin,
                         spec=j_dram_on_logic(n_dram))
    Fj = grid.fields()
    Fn = {k: np.asarray(v) for k, v in Fj.items()}
    return Fj, Fn, interop.fields_from_reference(Fn, "cpu")


def _vec(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)) \
        .astype(np.float32)


def _close(got, ref, rtol, atol_rel=None):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    atol = 0.0 if atol_rel is None else atol_rel * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("rescale", [False, True])
def test_coarsen_matches_reference(rescale):
    Fj, Fn, Ft = _fields()
    d = _vec(Fn["g_pkg"].shape, 1, 0.3) ** 2
    Fcj, dcj = jmg.coarsen(Fj, jnp.asarray(d), rescale_lateral=rescale)
    Fct, dct = tmg.coarsen(Ft, torch.from_numpy(d), rescale_lateral=rescale)
    for k in Fcj:
        _close(Fct[k], Fcj[k], rtol=1e-6)
    _close(dct, dcj, rtol=1e-6)


def test_restrict_prolong_match_reference():
    shape = (7, 12, 20)
    r = _vec(shape, 2)
    _close(tmg.restrict(torch.from_numpy(r)), jmg.restrict(jnp.asarray(r)),
           rtol=1e-6, atol_rel=1e-7)
    e = _vec((7, 6, 10), 3)
    _close(tmg.prolong(torch.from_numpy(e)), jmg.prolong(jnp.asarray(e)),
           rtol=0)


def test_batched_coarsening_never_mixes_cases():
    """[B, L, NY, NX]: each case coarsens, restricts and prolongs as the
    reference does that case alone."""
    Fs = [_fields(die_w=w)[1] for w in (2.3e-3, 7.3e-3)]
    Fb = {k: np.stack([F[k] for F in Fs]) for k in Fs[0]}
    db = np.stack([_vec(Fs[0]["g_pkg"].shape, s, 0.3) ** 2 for s in (4, 5)])
    Fct, dct = tmg.coarsen(interop.fields_from_reference(Fb, "cpu"),
                           torch.from_numpy(db), rescale_lateral=True)
    r = np.stack([_vec(Fs[0]["g_pkg"].shape, s) for s in (6, 7)])
    rt = tmg.restrict(torch.from_numpy(r))
    pt = tmg.prolong(rt)
    for b in range(2):
        Fj = {k: jnp.asarray(v) for k, v in Fs[b].items()}
        Fcj, dcj = jmg.coarsen(Fj, jnp.asarray(db[b]), rescale_lateral=True)
        for k in Fcj:
            _close(Fct[k][b], Fcj[k], rtol=1e-6)
        _close(dct[b], dcj, rtol=1e-6)
        rj = jmg.restrict(jnp.asarray(r[b]))
        _close(rt[b], rj, rtol=1e-6, atol_rel=1e-7)
        _close(pt[b], jmg.prolong(rj), rtol=1e-6, atol_rel=1e-7)


def test_build_levels_matches_reference():
    Fj, Fn, Ft = _fields(n=32, margin=8)
    d = np.full(Fn["g_pkg"].shape, 0.5, np.float32)
    lj = jmg.build_levels(Fj, jnp.asarray(d))
    lt = tmg.build_levels(Ft, torch.from_numpy(d))
    assert [F["g_pkg"].shape for F, _ in lj] \
        == [tuple(F["g_pkg"].shape) for F, _ in lt]
    carried = interop.levels_from_reference(
        [({k: np.asarray(v) for k, v in F.items()}, np.asarray(dd))
         for F, dd in lj], "cpu")
    for (Ft_l, dt_l), (Fc_l, dc_l) in zip(lt, carried):
        for k in Ft_l:
            _close(Ft_l[k], Fc_l[k].numpy(), rtol=1e-6)
        _close(dt_l, dc_l.numpy(), rtol=1e-6)
    # a scalar d_extra is expanded to full tensors on every level
    assert all(dd.shape == F["g_pkg"].shape
               for F, dd in tmg.build_levels(Ft, 0.0))


def test_line_solve_matches_reference():
    Fj, Fn, Ft = _fields(n_dram=1)
    d = np.full(Fn["g_pkg"].shape, 0.1, np.float32)
    rhs = _vec(Fn["g_pkg"].shape, 8)
    ref = jmg.line_solve(jnp.asarray(rhs), Fj, jnp.asarray(d))
    got = tmg.line_solve(torch.from_numpy(rhs), Ft, torch.from_numpy(d))
    _close(got, ref, rtol=1e-5, atol_rel=1e-5)


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("d_extra", ["field", "scalar"])
def test_rb_line_sweep_plain_matches_oracle_and_pallas(color, d_extra):
    Fj, Fn, Ft = _fields(n=32, margin=8)
    shape = Fn["g_pkg"].shape
    T, b = _vec(shape, 9), _vec(shape, 10)
    d = np.full(shape, 0.5, np.float32) if d_extra == "field" else 0.0
    dj = jnp.asarray(d) if d_extra == "field" else 0.0
    dt = torch.from_numpy(d) if d_extra == "field" else 0.0
    before = tsmooth.rb_line_sweep.launches
    got = tmg.rb_line_sweep(torch.from_numpy(T), torch.from_numpy(b), Ft,
                            dt, color)
    assert tsmooth.rb_line_sweep.launches == before     # plain on the CPU
    oracle = jmg.rb_line_sweep(jnp.asarray(T), jnp.asarray(b), Fj, dj,
                               color)
    pallas = jsmooth.rb_line_sweep(jnp.asarray(T), jnp.asarray(b), Fj, dj,
                                   color, block_y=8)
    _close(got, oracle, rtol=1e-5, atol_rel=1e-5)
    _close(got, pallas, rtol=1e-5, atol_rel=1e-5)
    # the other colour's columns are copied unchanged
    keep = (np.add.outer(np.arange(shape[1]), np.arange(shape[2])) % 2
            != color)
    np.testing.assert_array_equal(got.numpy()[:, keep], T[:, keep])


def test_rb_line_sweep_batched_uses_global_parity_per_case():
    Fs = [_fields(die_w=w)[1] for w in (2.3e-3, 5e-3, 7.3e-3)]
    Fb = {k: np.stack([F[k] for F in Fs]) for k in Fs[0]}
    shape = Fb["g_pkg"].shape
    T, b = _vec(shape, 11), _vec(shape, 12)
    d = (_vec(shape, 13, 0.5) ** 2).astype(np.float32)
    got = tsmooth.rb_line_sweep_plain(
        torch.from_numpy(T), torch.from_numpy(b),
        interop.fields_from_reference(Fb, "cpu"), torch.from_numpy(d), 1)
    for i in range(3):
        Fj = {k: jnp.asarray(v) for k, v in Fs[i].items()}
        ref = jmg.rb_line_sweep(jnp.asarray(T[i]), jnp.asarray(b[i]), Fj,
                                jnp.asarray(d[i]), 1)
        _close(got[i], ref, rtol=1e-5, atol_rel=1e-5)


@pytest.mark.parametrize("shape", [(3, 6, 8), (2, 3, 7, 9), (1, 1, 1)])
def test_split_by_colour_holds_each_colours_swept_cells(shape):
    """The smoother kernel's coefficients: for colour c, array k at (y, i)
    is field k (then d_extra) at (y, 2i + ((y + c) & 1)), exactly the
    cells a half-sweep of colour c solves, each once."""
    rng = np.random.default_rng(sum(shape))
    F = tsmooth.pack_fields({k: torch.from_numpy(
        rng.uniform(0, 1, shape).astype(np.float32))
        for k in tsmooth.FIELD_KEYS})
    d = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
    split = tsmooth.split_by_colour(F, d)
    ny, nx = shape[-2:]
    assert split.shape == (2, 8, *shape[:-1], (nx + 1) // 2)
    arrays = [F[k] for k in tsmooth.FIELD_KEYS] + [d]
    par = tsmooth.parity(ny, nx).numpy()
    for c in (0, 1):
        seen = np.zeros((ny, nx), int)
        for y in range(ny):
            for i in range((nx + 1) // 2):
                x = 2 * i + ((y + c) & 1)
                if x >= nx:
                    continue
                seen[y, x] += 1
                for k, a in enumerate(arrays):
                    assert torch.equal(split[c, k, ..., y, i], a[..., y, x])
        np.testing.assert_array_equal(seen, par == c)
    # a scalar d_extra broadcasts into its array
    assert bool((tsmooth.split_by_colour(F, torch.tensor(0.25))[:, 7]
                 == 0.25).all())


def test_levels_are_checked_once_beside_their_own_extra():
    """Every level of build_levels carries its d_extra and its colour
    split, and is a new pack over the fields' data (the caller's pack is
    left as it is)."""
    _, Fn, Ft = _fields(n=16, margin=4)
    pack = tsmooth.pack_fields(Ft)
    levels = tmg.build_levels(pack, 0.5)
    assert levels[0][0] is not pack and levels[0][0].data is pack.data
    assert "smoother_extra" not in pack.__dict__
    for F, d in levels:
        assert F.smoother_extra is d
        torch.testing.assert_close(
            F.smoother_coefficients, tsmooth.thomas_coefficients(F, d),
            rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(7, 8, 6), (2, 3, 5, 9), (1, 4, 4)])
def test_thomas_coefficients_are_line_solves_own(shape):
    """The smoother kernel's precomputed pivots and forward coefficients
    equal, bit for bit, those the plain line solve forms every sweep, at
    each colour's swept cells; the four lateral fields and lo = -gz_up
    are the fields'."""
    rng = np.random.default_rng(sum(shape) + 7)
    F = {k: torch.from_numpy(rng.uniform(0, 1e-2, shape).astype(np.float32))
         for k in tsmooth.FIELD_KEYS}
    F["gz_up"][..., :1, :, :] = 0.0
    F["gz_dn"][..., -1:, :, :] = 0.0
    for k in F:                         # void columns: the diagonal guard
        F[k][..., :, :1, :] = 0.0
    d = torch.from_numpy(rng.uniform(0, 5e-2, shape).astype(np.float32))
    d[..., :, :1, :] = 0.0
    F = tsmooth.pack_fields(F)
    coef = tsmooth.thomas_coefficients(F, d)
    # the plain recursion, written out on the full grid
    diag = tsmooth.diagonal(F, d)
    diag = torch.where(diag > 0, diag, 1.0)
    lo, up = -F["gz_up"], -F["gz_dn"]
    den, cp = [diag.select(-3, 0)], [up.select(-3, 0) / diag.select(-3, 0)]
    for l in range(1, shape[-3]):
        dn = diag.select(-3, l) - lo.select(-3, l) * cp[-1]
        den.append(torch.where(dn.abs() > 0, dn, 1.0))
        cp.append(up.select(-3, l) / den[-1])
    full = [F["gx_lf"], F["gx_rt"], F["gy_up"], F["gy_dn"], lo,
            torch.stack(den, -3), torch.stack(cp, -3)]
    ny, nx = shape[-2:]
    for c in (0, 1):
        for y in range(ny):
            for i in range((nx + 1) // 2):
                x = 2 * i + ((y + c) & 1)
                if x < nx:
                    for k, a in enumerate(full):
                        assert torch.equal(coef[c, k, ..., y, i],
                                           a[..., y, x])


def test_rb_line_sweep_rejects_bad_color():
    _, Fn, Ft = _fields(n=8, margin=2)
    T = torch.zeros(Fn["g_pkg"].shape)
    with pytest.raises(ValueError):
        tmg.rb_line_sweep(T, T, Ft, 0.0, 2)


@pytest.mark.parametrize("exact_coarse", [True, False])
def test_v_cycle_matches_reference(exact_coarse):
    Fj, Fn, Ft = _fields(n=32, margin=8)
    d = np.full(Fn["g_pkg"].shape, 0.05, np.float32)
    b = _vec(Fn["g_pkg"].shape, 14, 1e-3)
    lj = jmg.build_levels(Fj, jnp.asarray(d))
    lt = tmg.build_levels(Ft, torch.from_numpy(d))
    cj = jmg.coarse_solve_fn(lj) if exact_coarse else None
    ct = tmg.coarse_solve_fn(lt) if exact_coarse else None
    ref = jmg.v_cycle(lj, jnp.asarray(b), coarse_solve=cj)
    got = tmg.v_cycle(lt, torch.from_numpy(b), coarse_solve=ct)
    _close(got, ref, rtol=1e-4, atol_rel=1e-4)


def test_iterate_fixed_batched_matches_reference():
    """The implicit-step inner solve over a case batch: each case equals
    the reference's fixed-cycle iteration on that case."""
    Fs = [_fields(die_w=w)[1] for w in (2.3e-3, 7.3e-3)]
    caps = [np.asarray(jthermal.Grid(die_w=w, ny=16, nx=16, margin=4,
                                     spec=j_dram_on_logic(2))
                       .capacity_field()) for w in (2.3e-3, 7.3e-3)]
    dt = 0.25 / 48 / 2
    Fb = {k: np.stack([F[k] for F in Fs]) for k in Fs[0]}
    db = np.stack(caps) / np.float32(dt)
    rhs = np.stack([_vec(caps[0].shape, s, 1e-2) for s in (15, 16)])
    lt = tmg.build_levels(interop.fields_from_reference(Fb, "cpu"),
                          torch.from_numpy(db))
    got = tmg.iterate_fixed(lt, torch.from_numpy(rhs), 3,
                            coarse_solve=tmg.coarse_solve_fn(lt))
    for i in range(2):
        lj = jmg.build_levels({k: jnp.asarray(v) for k, v in Fs[i].items()},
                              jnp.asarray(db[i]))
        ref = jmg.iterate_fixed(lj, jnp.asarray(rhs[i]), 3,
                                coarse_solve=jmg.coarse_solve_fn(lj))
        _close(got[i], ref, rtol=1e-4, atol_rel=1e-4)
    single = tmg.mg_fixed(torch.from_numpy(rhs[0]),
                          interop.fields_from_reference(Fs[0], "cpu"),
                          torch.from_numpy(db[0]), n_cycles=3)
    _close(single, got[0].numpy(), rtol=1e-5, atol_rel=1e-5)


@pytest.mark.parametrize("solver", ["mg", "mgcg"])
def test_tolerance_solves_match_reference(solver):
    """mg_solve_fields / mgcg_solve_fields on a steady system: the same
    answer, and the cycle or iteration count within 2 (the float32
    residual floor decides the last cycle)."""
    Fj, Fn, Ft = _fields(n=32, margin=8)
    grid = jthermal.Grid(die_w=5e-3, ny=32, nx=32, margin=8,
                         spec=j_dram_on_logic(2))
    b = np.zeros(Fn["g_pkg"].shape, np.float32)
    b[list(grid.stack.logic_layers), 8:40, 8:40] = 40.0 / (2 * 32 * 32)
    jfn = {"mg": jmg.mg_solve_fields, "mgcg": jmg.mgcg_solve_fields}[solver]
    tfn = {"mg": tmg.mg_solve_fields, "mgcg": tmg.mgcg_solve_fields}[solver]
    xj, itj = jfn(jnp.asarray(b), Fj, 0.0, 1e-8)
    xt, itt = tfn(torch.from_numpy(b), Ft, 0.0, 1e-8)
    assert abs(int(itj) - itt) <= 2, (int(itj), itt)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-3)


def test_coarse_factorization_raises_when_not_positive_definite():
    """cho_factor would return NaN silently; the port refuses."""
    _, Fn, Ft = _fields(n=8, margin=2)
    d = torch.full(Fn["g_pkg"].shape, -10.0)
    with pytest.raises(RuntimeError, match="positive definite"):
        tmg.coarse_factorization(tmg.build_levels(Ft, d))


@pytest.mark.parametrize("n_dram", [12, 16])
@pytest.mark.parametrize("color", [0, 1])
def test_deep_column_sweep_matches_reference(n_dram, color):
    """12 and 16 DRAM dies on a logic die: 17 and 21 layers a column, past
    the card kernel's register path.  The plain half-sweep against the
    reference's oracle and its Pallas kernel in interpret mode."""
    Fj, Fn, Ft = _fields(n=16, margin=4, n_dram=n_dram)
    shape = Fn["g_pkg"].shape
    assert shape[0] == n_dram + 5 > tsmooth.MAX_LAYERS
    T, b = _vec(shape, 20 + n_dram), _vec(shape, 21 + n_dram)
    d = np.full(shape, 0.25, np.float32)
    got = tmg.rb_line_sweep(torch.from_numpy(T), torch.from_numpy(b), Ft,
                            torch.from_numpy(d), color)
    oracle = jmg.rb_line_sweep(jnp.asarray(T), jnp.asarray(b), Fj,
                               jnp.asarray(d), color)
    pallas = jsmooth.rb_line_sweep(jnp.asarray(T), jnp.asarray(b), Fj,
                                   jnp.asarray(d), color, block_y=8)
    _close(got, oracle, rtol=1e-5, atol_rel=1e-5)
    _close(got, pallas, rtol=1e-5, atol_rel=1e-5)
    # the plain version is the coefficient-split recursion the kernel runs
    pack, dl = tsmooth.checked_level(Ft, torch.from_numpy(d))
    coef = pack.smoother_coefficients
    assert coef.shape == (2, 7, shape[0], shape[1], (shape[2] + 1) // 2)


def test_deep_stack_steady_mg_matches_reference():
    """Steady mg and mgcg on a 12-high DRAM stack (17 layers) at 16^2:
    maxima within the phase-9 bar (0.05 °C) of the reference's, and the
    port's mg within 1e-3 °C of its mgcg."""
    from repro.core import thermal as jth
    from repro_torch.core import thermal as tth
    from repro_torch.stack.spec import dram_on_logic as t_dram_on_logic
    n = 16
    out = {}
    for pkg, spec, kw in ((jth, j_dram_on_logic(12), {}),
                          (tth, t_dram_on_logic(12), {"device": "cpu"})):
        grid = pkg.Grid(die_w=5e-3, ny=n, nx=n, margin=n // 4, spec=spec)
        power = np.zeros((grid.n_die_layers, n, n), np.float32)
        power[list(spec.logic_layers)] = 40.0 / (len(spec.logic_layers)
                                                 * n * n)
        out[pkg] = {s: np.asarray(pkg.steady_state_stats(
            power, grid, solver=s, **kw)[0]) for s in ("mg", "mgcg")}
    for s in ("mg", "mgcg"):
        assert abs(out[tth][s].max() - out[jth][s].max()) <= 0.05
    assert np.abs(out[tth]["mg"] - out[tth]["mgcg"]).max() <= 1e-3
