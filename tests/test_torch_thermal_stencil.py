"""PyTorch port vs the JAX reference: the face-conductance stencil and the
thermal grid it runs on.

The port's ``apply_operator_fields`` (its plain version, on the CPU) is
held against the reference's jnp operator and its Pallas kernel in
interpret mode, on the same DRAM-on-logic grids and temperatures (numpy
seeds, carried across through ``repro_torch.interop``).  Tolerance: rtol
1e-5 — float32, and XLA may contract a multiply-add into an FMA.  The
grid's fields and capacities are built in NumPy by both packages and must
agree bit for bit.  The kernel-vs-plain check on the card lives in
``test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import thermal as jthermal
from repro.kernels.thermal_stencil import ops as jops
from repro.stack.spec import dram_on_logic as j_dram_on_logic
from repro_torch import interop
from repro_torch.core import thermal as tthermal
from repro_torch.kernels.thermal_stencil import ops as tops
from repro_torch.stack.spec import dram_on_logic as t_dram_on_logic

GRIDS = [(8, 2), (12, 3), (16, 4)]      # (cells across the die, margin)


def _grids(n, margin, n_dram=2):
    kw = dict(die_w=2.3e-3, ny=n, nx=n, margin=margin)
    return (jthermal.Grid(spec=j_dram_on_logic(n_dram), **kw),
            tthermal.Grid(spec=t_dram_on_logic(n_dram), **kw))


def _temps(shape, seed):
    rng = np.random.default_rng(seed)
    return (45.0 + 30.0 * rng.random(shape)).astype(np.float32)


@pytest.mark.parametrize("n,margin", GRIDS)
def test_grid_fields_and_capacities_bit_identical(n, margin):
    jg, tg = _grids(n, margin)
    Fj, Ft = jg.fields(), tg.fields(device="cpu")
    assert set(Fj) == set(Ft)
    for k in Fj:
        assert Ft[k].dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(Fj[k]), Ft[k].numpy(), k)
    np.testing.assert_array_equal(np.asarray(jg.capacity_field()),
                                  tg.capacity_field(device="cpu").numpy())


@pytest.mark.parametrize("n,margin", GRIDS)
def test_stencil_matches_reference_and_pallas(n, margin):
    jg, _ = _grids(n, margin)
    Fj = jg.fields()
    T = _temps(Fj["g_pkg"].shape, seed=n)
    Ft = interop.fields_from_reference(
        {k: np.asarray(v) for k, v in Fj.items()}, device="cpu")
    launches = tops.apply_operator_fields.launches
    got = tthermal.apply_operator_fields(torch.from_numpy(T), Ft).numpy()
    assert tops.apply_operator_fields.launches == launches  # plain on CPU
    ref = np.asarray(jthermal.apply_operator_fields(jnp.asarray(T), Fj))
    pallas = np.asarray(jops.apply_operator_fields(jnp.asarray(T), Fj,
                                                   block_y=4))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5 * scale)


def test_stencil_batched_matches_per_case_reference():
    """A leading case dimension [B, L, NY, NX] (the reference's vmap):
    each case equals the reference applied to that case alone."""
    die_w = (2.3e-3, 4.1e-3, 7.3e-3)    # three dies, one grid shape
    Fjs = [jthermal.Grid(die_w=w, ny=12, nx=12, margin=3,
                         spec=j_dram_on_logic(2)).fields() for w in die_w]
    Fb = {k: np.stack([np.asarray(F[k]) for F in Fjs]) for k in Fjs[0]}
    T = _temps(Fb["g_pkg"].shape, seed=7)
    got = tops.apply_operator_fields(
        torch.from_numpy(T), interop.fields_from_reference(Fb, "cpu"))
    ref = np.asarray(jax.vmap(jthermal.apply_operator_fields)(
        jnp.asarray(T), {k: jnp.asarray(v) for k, v in Fb.items()}))
    for b in range(3):
        single = np.asarray(jthermal.apply_operator_fields(
            jnp.asarray(T[b]), Fjs[b]))
        np.testing.assert_allclose(got[b].numpy(), single, rtol=1e-5,
                                   atol=1e-5 * np.abs(single).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_implicit_pcg_batch_matches_vmapped_reference():
    """The fixed-iteration theta-scheme solve over a case batch vs the
    reference's implicit_lhs_solver vmapped over the same cases
    (float32 CG: the reduction order differs, hence a relative bound)."""
    grids = [jthermal.Grid(die_w=w, ny=8, nx=8, margin=2,
                           spec=j_dram_on_logic(2)) for w in (2.3e-3, 7.3e-3)]
    Fb = {k: np.stack([np.asarray(g.fields()[k]) for g in grids])
          for k in grids[0].fields()}
    capb = np.stack([np.asarray(g.capacity_field()) for g in grids])
    rng = np.random.default_rng(11)
    rhs = rng.uniform(0.0, 1e-2, capb.shape).astype(np.float32)
    dt, theta, n_cg = 0.25 / 48 / 2, 1.0, 40

    def ref_one(F, cap, b):
        A = lambda v: jthermal.apply_operator_fields(v, F)
        solve = jthermal.implicit_lhs_solver(A, F, cap, dt, theta,
                                             n_cg=n_cg)
        return solve(b)

    ref = np.asarray(jax.jit(jax.vmap(ref_one))(
        {k: jnp.asarray(v) for k, v in Fb.items()}, jnp.asarray(capb),
        jnp.asarray(rhs)))
    Ft = interop.fields_from_reference(Fb, "cpu")
    A = lambda v: tthermal.apply_operator_fields(v, Ft)
    solve = tthermal.implicit_lhs_solver(A, Ft, torch.from_numpy(capb), dt,
                                         theta, n_cg=n_cg)
    got = solve(torch.from_numpy(rhs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_pcg_fixed_zero_rhs_stays_zero():
    """The alpha/beta guards are torch.where, not Python branches: a zero
    right-hand side gives a zero update without a host sync or NaN."""
    _, tg = _grids(8, 2)
    F = tg.fields(device="cpu")
    A = lambda v: tthermal.apply_operator_fields(v, F)
    Minv = 1.0 / tthermal._diag_fields(F)
    x = tthermal.pcg_fixed(A, Minv, torch.zeros((2,) + F["g_pkg"].shape),
                           n_iter=5)
    assert torch.equal(x, torch.zeros_like(x))


def test_mg_solver_is_not_ported_yet():
    """The multigrid inner solve is ported now: implicit_lhs_solver
    builds its closure for "mg" as for "pcg", and still refuses a name
    that is neither."""
    _, tg = _grids(8, 2)
    F = {k: v[None] for k, v in tg.fields(device="cpu").items()}
    cap = tg.capacity_field(device="cpu")[None]
    A = lambda v: tthermal.apply_operator_fields(v, F)
    rhs = torch.ones_like(cap) * 1e-3
    for solver in ("pcg", "mg"):
        solve = tthermal.implicit_lhs_solver(A, F, cap, 1e-3, 1.0,
                                             solver=solver)
        delta = solve(rhs)
        assert delta.shape == rhs.shape and bool(torch.isfinite(delta).all())
    with pytest.raises(ValueError, match="unknown solver"):
        tthermal.implicit_lhs_solver(A, F, cap, 1e-3, 1.0, solver="mgcg")
