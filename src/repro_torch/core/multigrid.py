"""Geometric multigrid for the face-conductance thermal operator (PyTorch
port of ``repro.core.multigrid``).

The steady-state system ``G T = P`` and every implicit transient step
``(C/dt + theta G) delta = r`` share one operator family: a 7-point
face-conductance stencil (``thermal.apply_operator_fields``) plus an
optional extra diagonal (the capacity term).

**Hierarchy.**  Levels coarsen the *lateral* grid only (2x2 cell
aggregation; the few-layer stack axis stays resolved).  The coarse
operator is the Galerkin product ``R G P`` with piecewise-constant
prolongation ``P`` and restriction ``R = P^T``; for a conductance stencil
it stays in the family (coarse faces are sums of the fine faces crossing
the coarse interface, diagonal terms are 2x2 sums), so one stencil serves
every level.  The deployed hierarchy halves the lateral sums back to the
true 2h spec-built stencil (see :func:`coarsen`).

**Smoother.**  Red-black *z-line* Gauss-Seidel: cells are coloured by
in-plane parity ``(y + x) % 2`` and each half-sweep solves every coloured
column's vertical tridiagonal system exactly.  :func:`rb_line_sweep` is
``kernels/mg_smooth``: the hand-written CUDA kernel for a CUDA tensor,
its plain PyTorch version for a CPU one.

**Cycles.**  ``v_cycle`` is the symmetric V(nu1, nu2) cycle with an exact
(dense-Cholesky) coarsest-level solve, so the cycle is a fixed SPD linear
operator usable as a stand-alone iteration (``mg_solve_fields``,
``iterate_fixed``/``mg_fixed``) or as a CG preconditioner
(``mgcg_solve_fields``).

Where the port differs from the reference:

- Every function takes an optional leading case dimension
  ``[B, L, NY, NX]`` (fields, ``d_extra`` and right-hand sides alike):
  the closed-loop replay batches its cases where the reference vmaps.
  Coarsening, restriction and prolongation act on the last three dims
  only, so cases never mix.
- ``use_pallas`` is accepted and ignored: the tensor's device picks the
  smoother kernel or its plain version.  ``v_cycle``'s ``sweep_fn`` and
  ``prolong_fn`` and ``iterate_fixed``'s ``sweep_fn`` hooks are kept,
  with :func:`rb_line_sweep` and :func:`prolong` as their defaults.
- The coarsest matrix is assembled once per hierarchy with the plain
  stencil (``apply_operator_fields_plain`` on an identity batch, the
  fields broadcast over it), then factored with
  ``torch.linalg.cholesky_ex`` — a library call outside any kernel, as
  ``cho_factor`` is in the reference.  Unlike ``cho_factor``, which
  returns NaN silently, a matrix that is not positive definite raises.
- The tolerance loop of :func:`mg_solve_fields` checks the residual on
  the host once per cycle (the reference's ``while_loop``).
- ``build_levels`` counts ``mg/hierarchies_built`` (and
  ``[levels=N]``) in ``obs`` once a hierarchy built, where the reference
  counts once a trace of the jitted driver that builds it.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels.mg_smooth import ops as smooth_ops
from repro_torch.kernels.thermal_stencil import ops as stencil_ops

#: stop coarsening below this in-plane size
MIN_COARSE_N = 4

#: red-black line sweeps on the coarsest level when no exact coarse solve
#: is given (palindromic: k pairs red->black then k pairs black->red)
N_COARSE_SWEEPS = 8


def operator(v: torch.Tensor, F: dict, d_extra) -> torch.Tensor:
    """(G + diag(d_extra)) @ v for one level's face fields."""
    return stencil_ops.apply_operator_fields(v, F) + d_extra * v


diagonal = smooth_ops.diagonal


# ---------------------------------------------------------------------------
# Galerkin (aggregation) coarsening over the last three dims
# ---------------------------------------------------------------------------

def _sum4(x: torch.Tensor) -> torch.Tensor:
    """Sum each 2x2 in-plane block: [..., L, NY, NX] -> [..., L, NY/2,
    NX/2]."""
    *lead, NY, NX = x.shape
    return x.reshape(*lead, NY // 2, 2, NX // 2, 2).sum(dim=(-3, -1))


def coarsen(F: dict, d_extra: torch.Tensor, rescale_lateral: bool = False
            ) -> tuple[dict, torch.Tensor]:
    """One 2x2 lateral aggregation level: ``(R G P, R d_extra P)``.

    Coarse face = sum of the fine faces crossing the coarse interface;
    coarse diagonal couplings (vertical, package, extra) = 2x2 sums.
    ``rescale_lateral`` halves the lateral face sums afterwards, which
    recovers the spec-built 2h stencil (``build_levels`` applies it).
    """
    NY, NX = F["g_pkg"].shape[-2:]
    if NY % 2 or NX % 2:
        raise ValueError(f"cannot 2x2-coarsen odd grid {NY}x{NX}")

    def sum_rows(x):                   # row pairs at a fixed fine column
        *lead, ny, nx = x.shape
        return x.reshape(*lead, ny // 2, 2, nx).sum(dim=-2)

    def sum_cols(x):                   # column pairs at a fixed fine row
        *lead, ny, nx = x.shape
        return x.reshape(*lead, ny, nx // 2, 2).sum(dim=-1)

    lat = 0.5 if rescale_lateral else 1.0
    Fc = {
        "gx_lf": lat * sum_rows(F["gx_lf"][..., 0::2]),
        "gx_rt": lat * sum_rows(F["gx_rt"][..., 1::2]),
        "gy_up": lat * sum_cols(F["gy_up"][..., 0::2, :]),
        "gy_dn": lat * sum_cols(F["gy_dn"][..., 1::2, :]),
        "gz_up": _sum4(F["gz_up"]),
        "gz_dn": _sum4(F["gz_dn"]),
        "g_pkg": _sum4(F["g_pkg"]),
    }
    return Fc, _sum4(d_extra)


def restrict(r: torch.Tensor) -> torch.Tensor:
    """R = P^T: sum each 2x2 fine block into its coarse cell."""
    return _sum4(r)


def prolong(e: torch.Tensor) -> torch.Tensor:
    """P: inject each coarse value into its 2x2 fine cells."""
    return e.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def build_levels(F: dict, d_extra, min_n: int = MIN_COARSE_N) -> list:
    """The hierarchy [(F_0, d_0), (F_1, d_1), ...], finest first.

    Every level is the rescaled Galerkin coarsening of the one above.
    Coarsening stops when either in-plane dimension goes odd or drops
    below ``min_n``.  ``d_extra`` (scalar or tensor) is expanded to the
    fields' shape, so every level carries full contiguous tensors; each
    level's fields are one ``FieldPack`` and, with its ``d_extra``,
    checked once here (``smooth_ops.checked_level``).
    """
    levels = [smooth_ops.checked_level(F, d_extra)]
    while True:
        ny, nx = levels[-1][0]["g_pkg"].shape[-2:]
        if ny % 2 or nx % 2 or min(ny, nx) // 2 < min_n:
            obs.count("mg/hierarchies_built")
            obs.count(f"mg/hierarchies_built[levels={len(levels)}]")
            return levels
        levels.append(smooth_ops.checked_level(
            *coarsen(*levels[-1], rescale_lateral=True)))


# ---------------------------------------------------------------------------
# red-black z-line Gauss-Seidel smoother (kernels/mg_smooth)
# ---------------------------------------------------------------------------

line_solve = smooth_ops.line_solve
rb_line_sweep = smooth_ops.rb_line_sweep


def _smooth(T, b, F, d_extra, colors, sweep_fn):
    for c in colors:
        T = sweep_fn(T, b, F, d_extra, c)
    return T


# ---------------------------------------------------------------------------
# the symmetric V-cycle
# ---------------------------------------------------------------------------

def coarse_factorization(levels: list):
    """Dense Cholesky factorization of the coarsest-level operator (one
    per case of a batch).

    The coarsest system is a few hundred unknowns: it is materialized by
    applying the plain operator to the identity, symmetrically
    Jacobi-scaled for float32 conditioning, void rows pinned to identity,
    and factored ONCE per hierarchy.  Returns ``(chol, s)`` with ``chol``
    the lower factor ``[..., n, n]`` and ``s`` the scaling ``[..., n]``.
    Raises ``RuntimeError`` if a scaled matrix is not positive definite.

    On a card a batch is factored one case at a time: the batched
    factorization rounds a case differently from the one-case call, and
    a case's factor must not depend on how many cases share its batch
    (the sharded case batch gives bitwise the unsharded one).
    """
    F, d_extra = levels[-1]
    shape = F["g_pkg"].shape
    lead, (L, ny, nx) = shape[:-3], shape[-3:]
    n = L * ny * nx
    g = F["g_pkg"]
    eye = torch.eye(n, dtype=g.dtype, device=g.device).reshape(
        n, *([1] * len(lead)), L, ny, nx)
    cols = stencil_ops.apply_operator_fields_plain(eye, F) + d_extra * eye
    A = cols.reshape(n, *lead, n).movedim(0, -1)    # A[..., i, j]
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    void = d <= 0
    A = A + torch.diag_embed(void.to(A.dtype))      # void cells: u = 0
    s = 1.0 / torch.sqrt(torch.where(void, 1.0, d))  # Jacobi scaling
    As = s[..., :, None] * A * s[..., None, :]
    if As.is_cuda and As.dim() > 2:
        flat = [torch.linalg.cholesky_ex(a) for a in As.reshape(-1, n, n)]
        chol = torch.stack([c for c, _ in flat]).reshape(As.shape)
        info = torch.stack([i for _, i in flat])
    else:
        chol, info = torch.linalg.cholesky_ex(As)
    bad = int((info != 0).sum())
    if bad:
        raise RuntimeError(
            f"coarse_factorization: {bad} coarsest-level matrix(es) not "
            f"positive definite (cholesky info {info.flatten().tolist()})")
    return chol, s


def coarse_solve_fn(levels: list):
    """Exact coarsest-level solve closure (see
    :func:`coarse_factorization`).

    On a card a batch of one case is solved as a batch of two (the case
    twice): the library takes another route for one matrix than for
    several, which rounds differently, and a case's solve must not depend
    on how many cases share its batch."""
    chol, s = coarse_factorization(levels)
    pad = chol.is_cuda and chol.dim() == 3 and chol.shape[0] == 1
    if pad:
        chol = torch.cat([chol, chol])

    def solve(b):
        rhs = (s * b.flatten(-3))[..., None]
        if pad:
            y = torch.cholesky_solve(torch.cat([rhs, rhs]), chol)[:1]
        else:
            y = torch.cholesky_solve(rhs, chol)
        return (s * y[..., 0]).reshape(b.shape)

    return solve


def v_cycle(levels: list, b: torch.Tensor, nu1: int = 1, nu2: int = 1,
            lvl: int = 0, sweep_fn=rb_line_sweep, prolong_fn=prolong,
            coarse_solve=None) -> torch.Tensor:
    """One V(nu1, nu2) cycle for ``A e = b`` from a zero initial guess.

    Pre-smoothing sweeps red->black, post-smoothing black->red, and the
    coarsest level is solved exactly (``coarse_solve``; a palindromic
    block of line sweeps when None), so with the default injection
    prolongation the cycle is symmetric positive definite — a valid CG
    preconditioner.  The default half-sweep :func:`rb_line_sweep` lets
    the tensor's device pick the smoother kernel or its plain version.
    """
    F, d_extra = levels[lvl]
    T = torch.zeros_like(b)
    if lvl == len(levels) - 1:
        if coarse_solve is not None:
            return coarse_solve(b)
        for _ in range(N_COARSE_SWEEPS):
            T = _smooth(T, b, F, d_extra, (0, 1), sweep_fn)
        for _ in range(N_COARSE_SWEEPS):
            T = _smooth(T, b, F, d_extra, (1, 0), sweep_fn)
        return T
    for _ in range(nu1):
        T = _smooth(T, b, F, d_extra, (0, 1), sweep_fn)
    r = b - operator(T, F, d_extra)
    e = v_cycle(levels, restrict(r), nu1, nu2, lvl + 1, sweep_fn,
                prolong_fn, coarse_solve)
    T = T + prolong_fn(e)
    for _ in range(nu2):
        T = _smooth(T, b, F, d_extra, (1, 0), sweep_fn)
    return T


# ---------------------------------------------------------------------------
# solver drivers
# ---------------------------------------------------------------------------

def mg_solve_fields(b: torch.Tensor, F: dict, d_extra=0.0, tol: float = 1e-8,
                    max_cycles: int = 200, nu1: int = 1, nu2: int = 1,
                    use_pallas: bool = False):
    """Stand-alone V-cycle iteration:  x += V(b - A x)  until the
    residual drops below ``tol * ||b||`` or stops contracting (less than
    10% reduction over a cycle: the float32 residual floor), or turns
    non-finite.  One host check of the residual per cycle.  Returns
    ``(x, n_cycles)``."""
    levels = build_levels(F, d_extra)
    coarse = coarse_solve_fn(levels)
    Fd, dd = levels[0]
    bnorm = float(torch.linalg.vector_norm(b))
    x, r, it, prev = torch.zeros_like(b), b, 0, float("inf")
    while it < max_cycles:
        res = float(torch.linalg.vector_norm(r))
        converged = res <= tol * bnorm
        stalled = it >= 2 and res > 0.9 * prev
        if converged or stalled or res != res or res == float("inf"):
            break
        e = v_cycle(levels, r, nu1, nu2, coarse_solve=coarse)
        x = x + e
        r, prev, it = b - operator(x, Fd, dd), res, it + 1
    return x, it


def iterate_fixed(levels: list, b: torch.Tensor, n_cycles: int,
                  nu1: int = 1, nu2: int = 1, sweep_fn=rb_line_sweep,
                  coarse_solve=None) -> torch.Tensor:
    """Fixed-cycle-count V-cycle iteration on a pre-built hierarchy:
    uniform cost per call and no host sync — the MG counterpart of
    :func:`thermal.pcg_fixed`.  Build ``levels`` AND ``coarse_solve``
    once, outside the time loop (``thermal.implicit_lhs_solver`` does)."""
    Fd, dd = levels[0]
    x, r = torch.zeros_like(b), b
    for _ in range(n_cycles):
        e = v_cycle(levels, r, nu1, nu2, sweep_fn=sweep_fn,
                    coarse_solve=coarse_solve)
        x = x + e
        r = r - operator(e, Fd, dd)
    return x


def mg_fixed(b: torch.Tensor, F: dict, d_extra=0.0, n_cycles: int = 3,
             nu1: int = 1, nu2: int = 1,
             use_pallas: bool = False) -> torch.Tensor:
    """Convenience wrapper over :func:`iterate_fixed`."""
    levels = build_levels(F, d_extra)
    return iterate_fixed(levels, b, n_cycles, nu1, nu2,
                         coarse_solve=coarse_solve_fn(levels))


def mgcg_solve_fields(b: torch.Tensor, F: dict, d_extra=0.0,
                      tol: float = 1e-8, max_iter: int = 500, nu1: int = 1,
                      nu2: int = 1, use_pallas: bool = False):
    """V-cycle-preconditioned CG (the symmetric cycle is SPD, so plain
    PCG theory applies).  Returns ``(x, n_iterations)``."""
    from repro_torch.core.thermal import pcg
    levels = build_levels(F, d_extra)
    coarse = coarse_solve_fn(levels)
    Fd, dd = levels[0]
    A = lambda v: operator(v, Fd, dd)
    Minv = lambda r: v_cycle(levels, r, nu1, nu2, coarse_solve=coarse)
    return pcg(A, Minv, b, tol, max_iter)


__all__ = ["coarsen", "restrict", "prolong", "build_levels", "operator",
           "diagonal", "line_solve", "rb_line_sweep", "v_cycle",
           "coarse_factorization", "coarse_solve_fn", "iterate_fixed",
           "mg_solve_fields", "mg_fixed", "mgcg_solve_fields"]
