"""HotSpot-equivalent 3D RC thermal model of the die stack (PyTorch port).

Each layer of a :class:`~repro_torch.stack.spec.StackSpec` (dies top to
bottom, copper spreader last) is a regular grid over the die footprint
plus a spreader-only margin ring; below the spreader a lumped package
conductance leads to ambient.  The production operator ``G`` is the
seven-field face-conductance stencil (``Grid.fields``), applied by
``kernels/thermal_stencil`` — the hand-written CUDA kernel on a card, its
plain PyTorch version on the CPU.  The legacy uniform-per-layer operator
(:func:`apply_operator`, behind ``transient``, ``transient_implicit`` and
``_cg_solve``) is that module's second kernel.

Ported: ``Grid``; both operators; the tolerance ``pcg`` and the
fixed-iteration ``pcg_fixed``; the steady solves
(``steady_state(_stats)`` over ``SOLVERS`` = pcg, mg, mgcg, with the
guarded ``fallback_chain``); the explicit ``transient``; the implicit
``transient_implicit(_fields)`` and ``transient_solve_implicit``; and
``implicit_lhs_solver`` with ``solver="pcg"`` or ``"mg"`` (multigrid:
``core/multigrid``, smoothed by the ``kernels/mg_smooth`` kernel).

Where the port differs from the reference:

- Entry points take the keyword-only ``device`` (default ``"cuda"``).
  They accept the reference's ``use_pallas`` in its place and ignore
  it: the tensor's device picks each kernel or its plain version.
- ``pcg_fixed`` and ``implicit_lhs_solver`` treat the first dim as a
  case batch (the reference's ``vmap`` written out); the unbatched
  steppers add a batch of one.  ``lax.scan``/``while_loop`` are Python
  loops; the tolerance loops (``pcg``, ``mg_solve_fields``) check the
  residual on the host once per iteration.
- ``obs`` records what the reference records: the ``thermal/steady``
  span and counters, the ``thermal/fallback/*`` retries of the guarded
  steady solve, and the ``thermal/transient`` span with its counters and
  per-step residuals (``with_residuals``, one extra matvec a step, only
  while ``obs`` is on).  The reference's ``thermal/retrace/
  transient_fields`` counts JAX traces; the port traces nothing, so it
  has no such counter.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core.constants import AMBIENT_C
from repro_torch.kernels.thermal_stencil import ops as stencil_ops
from repro_torch.stack.spec import (PAPER_STACK, StackParams, StackSpec,
                                    spec_from_params)

#: selectable linear-solver backends for the fields operator: Jacobi-PCG,
#: stand-alone geometric multigrid V-cycles, and V-cycle-preconditioned CG
#: (see ``core/multigrid.py``)
SOLVERS = ("pcg", "mg", "mgcg")

#: TRUE-relative-residual bar for "this steady solve is healthy".
#: Deliberately loose: converged solves stop at the float32 residual
#: floor rather than their nominal tol, and that floor grows with the
#: grid, so the bar sits well above it — yet orders of magnitude below
#: any diverged (non-finite) or stagnated solve, which is what the
#: fallback chain catches.
HEALTH_RTOL = 2e-2


def package_resistance(die_area_m2: float, p: StackParams = PAPER_STACK
                       ) -> float:
    """Lumped R from the spreader underside to ambient [K/W] (thin
    wrapper over :meth:`StackSpec.package_resistance`)."""
    return spec_from_params(p).package_resistance(die_area_m2)


@dataclasses.dataclass(frozen=True)
class Grid:
    die_w: float                # die edge [m] (square dies, as in the paper)
    ny: int                     # cells across the DIE footprint
    nx: int
    params: StackParams = PAPER_STACK
    pkg_area: float = 0.0       # area feeding the package lump [m^2];
    #   0 -> the spreader footprint (die + margin).
    margin: int = 0             # extra spreader-only cells per side
    spec: StackSpec | None = None   # heterogeneous stack; None -> the
    #   homogeneous ``params`` expanded through ``spec_from_params``.

    @property
    def stack(self) -> StackSpec:
        """The StackSpec every operator on this grid is built from."""
        return self.spec if self.spec is not None \
            else spec_from_params(self.params)

    @property
    def n_layers(self) -> int:
        return self.stack.n_layers

    @property
    def n_die_layers(self) -> int:
        """Device layers (logic + DRAM) — everything above the spreader."""
        return self.stack.n_die_layers

    @property
    def cell_w(self) -> float:
        return self.die_w / self.nx

    @property
    def cell_area(self) -> float:
        return self.cell_w * (self.die_w / self.ny)

    @property
    def dom_ny(self) -> int:
        return self.ny + 2 * self.margin

    @property
    def dom_nx(self) -> int:
        return self.nx + 2 * self.margin

    def conductances(self) -> dict:
        """g_lat [L], g_vert [L-1] (interfaces, top->bottom) as float32
        NumPy, g_pkg and r_pkg as floats."""
        s = self.stack
        g_lat = s.lateral_conductances()
        g_vert = s.vertical_conductances(self.cell_area)
        dom_area = self.dom_ny * self.dom_nx * self.cell_area
        a_pkg = self.pkg_area or dom_area
        r_pkg = s.package_resistance(a_pkg)
        # per-cell share: cell_area / (r_pkg * A)
        g_pkg = self.cell_area / (r_pkg * a_pkg)
        return {"g_lat": np.asarray(g_lat, np.float32),
                "g_vert": np.asarray(g_vert, np.float32),
                "g_pkg": float(g_pkg), "r_pkg": float(r_pkg)}

    def fields_numpy(self) -> dict:
        """The seven [L, NY, NX] float32 face fields, built in NumPy with
        the reference's exact operations (so they match it bit for bit)."""
        g = self.conductances()
        L = self.n_layers
        NY, NX, m = self.dom_ny, self.dom_nx, self.margin
        mask = np.zeros((L, NY, NX), np.float32)
        mask[:-1, m:m + self.ny, m:m + self.nx] = 1.0   # dies: footprint only
        mask[-1] = 1.0                                  # spreader: everywhere
        g_cell = g["g_lat"][:, None, None] * mask

        def face(a, b):  # harmonic mean of cell conductances (0-safe)
            s = a + b
            return np.where(s > 0, 2 * a * b / np.maximum(s, 1e-30), 0.0)

        gx = face(g_cell[:, :, :-1], g_cell[:, :, 1:])   # [L, NY, NX-1]
        gy = face(g_cell[:, :-1, :], g_cell[:, 1:, :])   # [L, NY-1, NX]
        z = np.zeros((L, NY, 1), np.float32)
        gx_lf = np.concatenate([z, gx], axis=2)
        gx_rt = np.concatenate([gx, z], axis=2)
        zy = np.zeros((L, 1, NX), np.float32)
        gy_up = np.concatenate([zy, gy], axis=1)
        gy_dn = np.concatenate([gy, zy], axis=1)
        # vertical: interface exists where BOTH layers have material
        gv = g["g_vert"][:, None, None] * mask[:-1] * mask[1:]
        zl = np.zeros((1, NY, NX), np.float32)
        gz_up = np.concatenate([zl, gv], axis=0)
        gz_dn = np.concatenate([gv, zl], axis=0)
        g_pkg = np.zeros((L, NY, NX), np.float32)
        g_pkg[-1] = g["g_pkg"]
        return {k: np.asarray(v, np.float32) for k, v in dict(
            gx_lf=gx_lf, gx_rt=gx_rt, gy_up=gy_up, gy_dn=gy_dn,
            gz_up=gz_up, gz_dn=gz_dn, g_pkg=g_pkg).items()}

    def fields(self, device="cuda") -> dict:
        """Per-face conductance fields over the (die + margin) domain, as
        float32 tensors on ``device``.

        Die layers (logic and DRAM) exist only over the die footprint
        (faces outside it are zero = adiabatic); the spreader layer spans
        the full domain.  Returns seven [L, NY, NX] tensors: gx_lf, gx_rt,
        gy_up, gy_dn (lateral faces), gz_up, gz_dn (interfaces), g_pkg
        (bottom lump), as one :class:`~repro_torch.kernels.thermal_stencil.
        ops.FieldPack` (seven views of one contiguous tensor).
        """
        dev = resolve_device(device)
        F = self.fields_numpy()
        return stencil_ops.FieldPack(torch.from_numpy(
            np.stack([F[k] for k in stencil_ops.FIELD_KEYS])).to(dev))

    def capacities(self) -> np.ndarray:
        """Per-layer per-cell heat capacity [J/K], float32 [L]."""
        return np.asarray(self.stack.capacities(self.cell_area), np.float32)

    def capacity_field(self, device="cuda") -> torch.Tensor:
        """Per-cell heat capacity [J/K] over the full domain, [L, NY, NX].

        Void cells (die layers over the margin ring) keep the die value:
        they have zero conductance and zero power, so they simply stay at
        their initial temperature; a nonzero capacity keeps the implicit
        system's diagonal well conditioned.
        """
        dev = resolve_device(device)
        c = np.broadcast_to(self.capacities()[:, None, None],
                            (self.n_layers, self.dom_ny, self.dom_nx))
        return torch.from_numpy(np.ascontiguousarray(c)).to(dev)

    def pad_power(self, power, device="cuda") -> torch.Tensor:
        """[n_die, ny, nx] die power -> float32 [L, ny, nx] on ``device``
        (spreader heatless)."""
        dev = resolve_device(device)
        power = torch.as_tensor(np.asarray(power, np.float32)
                                if not torch.is_tensor(power) else power,
                                dtype=torch.float32, device=dev)
        if power.shape[0] == self.n_layers:
            return power
        pad = torch.zeros((self.n_layers - power.shape[0],)
                          + tuple(power.shape[1:]), dtype=torch.float32,
                          device=dev)
        return torch.cat([power, pad], dim=0)


# ---------------------------------------------------------------------------
# legacy uniform-per-layer stencil (kernels/thermal_stencil, second kernel)
# ---------------------------------------------------------------------------

#: scalar-or-vector conductances -> the uniform stencil's four [L] vectors,
#: one checked pack built once a solve
_vectors = stencil_ops.vectors


def apply_operator(T: torch.Tensor, g_lat, g_vert, g_pkg) -> torch.Tensor:
    """y = G @ T.  T: [L, ny, nx] or [B, L, ny, nx] (layer 0 = TOP die,
    layer L-1 = spreader).

    g_lat: scalar or [L]; g_vert: scalar or [L-1]; g_pkg: scalar (bottom
    layer to ambient).  Adiabatic side/top boundaries.  Runs the CUDA
    kernel for a CUDA tensor, the plain version for a CPU one.
    """
    return stencil_ops.apply_operator(T, g_lat, g_vert, g_pkg)


def _diag(shape, g_lat, g_vert, g_pkg, device="cpu") -> torch.Tensor:
    """Diagonal of G (for Jacobi preconditioning), [L, ny, nx]."""
    L, ny, nx = shape
    g_lat, gv_u, gv_d, g_pkg_vec = _vectors(L, g_lat, g_vert, g_pkg, device)
    d = (4.0 * g_lat)[:, None, None].expand(shape)
    edge_y = torch.zeros((ny, 1), device=device)
    edge_y[0] = 1
    edge_y[-1] = 1
    edge_x = torch.zeros((1, nx), device=device)
    edge_x[:, 0] = 1
    edge_x[:, -1] = 1
    d = d - g_lat[:, None, None] * (edge_y + edge_x)[None]
    return d + (gv_u + gv_d + g_pkg_vec)[:, None, None]


# ---------------------------------------------------------------------------
# heterogeneous (face-conductance-field) operator
# ---------------------------------------------------------------------------

#: y = G @ T with per-face conductances (zero faces = adiabatic), ``T``
#: [L, NY, NX] or a batch [B, L, NY, NX]: the CUDA stencil for a CUDA
#: tensor, the plain version for a CPU one (no hop in between: the
#: replay's PCG calls it some 24k times a run)
apply_operator_fields = stencil_ops.apply_operator_fields


def _diag_fields(F: dict) -> torch.Tensor:
    d = stencil_ops.face_diagonal(F)
    return torch.where(d > 0, d, 1.0)     # void cells: identity rows


# ---------------------------------------------------------------------------
# fixed-iteration preconditioned CG over a batch of cases
# ---------------------------------------------------------------------------

def _as_precond(Minv):
    """Normalize a preconditioner to a closure: an inverse-diagonal
    tensor (Jacobi) or a callable."""
    return Minv if callable(Minv) else (lambda r: Minv * r)


def case_sum(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Per-case sum of ``x`` [B, ...] over every dim after the first,
    whose value does not depend on B.

    A CUDA reduction lays its threads out by the number of outputs, so
    one sum over a case's whole volume would add its terms in an order
    that changes with the batch size, and a case would round differently
    alone than among sixteen (the sharded case batch must give bitwise
    the unsharded one).  On a card the sum therefore runs one trailing
    dim at a time: each such reduction has a short row (under 64 terms at
    the replays' widths, or at least 16 rows a case), which the reduction
    lays out the same way for any batch.  The CPU's sum is the same for
    any batch already and stays one call.
    """
    if not x.is_cuda:
        return x.sum(dim=tuple(range(1, x.dim())), keepdim=keepdim)
    for d in reversed(range(1, x.dim())):
        x = x.sum(dim=d, keepdim=keepdim)
    return x


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-case dot product over every dim after the first, shaped to
    broadcast against the case tensors (:func:`case_sum`)."""
    return case_sum(a * b, keepdim=True)


def pcg_fixed(A, Minv, b: torch.Tensor, n_iter: int) -> torch.Tensor:
    """PCG with a fixed iteration count, for a batch ``b`` [B, ...] of
    independent systems (one scalar step size per case).

    Uniform cost per call, so a batch of solves needs no masking and no
    host sync.  Guarded against a zero right-hand side (alpha would be
    0/0): the update is suppressed when the residual has already
    vanished — with ``torch.where``, never a Python branch on a tensor.
    """
    apply_Minv = _as_precond(Minv)
    x = torch.zeros_like(b)
    r = b
    z = apply_Minv(r)
    p = z
    rz = _vdot(r, z)
    for _ in range(n_iter):
        Ap = A(p)
        pAp = _vdot(p, Ap)
        ok = pAp > 0.0
        alpha = torch.where(ok, rz / torch.where(ok, pAp, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_Minv(r)
        rz_new = _vdot(r, z)
        beta = torch.where(ok, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
        p = z + beta * p
        rz = rz_new
    return x


def pcg(A, Minv, b: torch.Tensor, tol: float = 1e-8,
        max_iter: int = 6000):
    """Preconditioned CG for the SPD system A x = b (one system: the dot
    products run over the whole tensor).

    ``A`` is a matvec closure; ``Minv`` is either the inverse diagonal
    (tensor, Jacobi) or a callable applying any fixed SPD preconditioner
    (``multigrid.v_cycle``).  Stops when ``||r|| <= tol ||b||`` or after
    ``max_iter`` iterations, checking the residual on the host once per
    iteration (the reference's ``while_loop``).  Returns
    ``(x, n_iterations)``.
    """
    apply_Minv = _as_precond(Minv)
    x = torch.zeros_like(b)
    r = b
    z = apply_Minv(r)
    p = z
    rz = torch.sum(r * z)
    bnorm = float(torch.linalg.vector_norm(b))
    it = 0
    while it < max_iter and float(torch.linalg.vector_norm(r)) > tol * bnorm:
        Ap = A(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_Minv(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it


def _cg_solve(b, diag, g_lat, g_vert, g_pkg, tol=1e-8, max_iter=6000):
    """Jacobi-preconditioned conjugate gradient for the legacy uniform
    operator, G T = b."""
    vecs = _vectors(b.shape[-3], g_lat, g_vert, g_pkg, b.device)
    A = lambda v: stencil_ops.apply_operator_vectors(v, vecs)
    return pcg(A, 1.0 / diag, b, tol, max_iter)[0]


def _cg_solve_fields_stats(b, F, tol=1e-8, max_iter=8000):
    A = lambda v: apply_operator_fields(v, F)
    return pcg(A, 1.0 / _diag_fields(F), b, tol, max_iter)


def _cg_solve_fields(b, F, tol=1e-8, max_iter=8000):
    return _cg_solve_fields_stats(b, F, tol, max_iter)[0]


def _solve_fields(b, F, solver: str, tol: float = 1e-8):
    """Route one fields solve ``G dT = b`` to the selected backend.

    Returns ``(dT, n_iterations)`` — CG iterations or V-cycles.  On a
    card the PCG backend's matvec is the stencil kernel and the multigrid
    backends smooth with the ``kernels/mg_smooth`` kernel.
    """
    from repro_torch.core import multigrid
    if solver == "mg":
        return multigrid.mg_solve_fields(b, F, 0.0, tol)
    if solver == "mgcg":
        return multigrid.mgcg_solve_fields(b, F, 0.0, tol)
    if solver != "pcg":
        raise ValueError(f"unknown solver {solver!r}; expected {SOLVERS}")
    return _cg_solve_fields_stats(b, F, tol)


def fallback_chain(solver: str) -> tuple[tuple[str, float], ...]:
    """Attempt list for one guarded fields solve: (backend, tol scale).

    Starts at the requested backend, continues down the remaining of
    the ``mg -> mgcg -> pcg`` ladder, and always ends with a
    tightened-tolerance Jacobi-PCG.
    """
    order = ("mg", "mgcg", "pcg")
    if solver not in order:
        raise ValueError(f"unknown solver {solver!r}; expected {SOLVERS}")
    tail = order[order.index(solver):]
    return tuple((s, 1.0) for s in tail) + (("pcg", 0.1),)


def _solve_fields_guarded(b, F, solver: str, tol: float = 1e-8):
    """:func:`_solve_fields` hardened by health checks + fallback.

    After each attempt the TRUE relative residual ``||b - G x||/||b||``
    is recomputed with the fields operator; a non-finite or
    ``> HEALTH_RTOL`` residual (a diverged or stagnated solve — or a
    backend forced down by ``repro_torch.faults.inject.poison_solver``)
    advances to the next rung of :func:`fallback_chain`.  Returns
    ``(dT, iterations, stats)`` with ``stats = {"attempts", "solved_by",
    "rel_residual"}``; retries are counted in ``obs`` under
    ``thermal/fallback/*``.
    """
    from repro_torch.faults import inject
    bnorm = float(torch.linalg.vector_norm(b))
    if bnorm == 0.0 or not math.isfinite(bnorm):
        # zero RHS: x = 0 is exact.  A non-finite RHS no backend can fix.
        resid = 0.0 if bnorm == 0.0 else math.inf
        return torch.zeros_like(b), 0, {"attempts": 1, "solved_by": solver,
                                        "rel_residual": resid}
    last = None
    for i, (s, scale) in enumerate(fallback_chain(solver)):
        if inject.solver_poisoned(s):
            dT, iters = torch.full_like(b, math.nan), 0
        else:
            dT, iters = _solve_fields(b, F, s, tol * scale)
        resid = float(torch.linalg.vector_norm(
            b - apply_operator_fields(dT, F))) / bnorm
        last = (dT, int(iters), {"attempts": i + 1, "solved_by": s,
                                 "rel_residual": resid})
        if math.isfinite(resid) and resid <= HEALTH_RTOL:
            if i:
                obs.count("thermal/fallback/recovered")
            return last
        if i == 0:
            obs.count("thermal/fallback/engaged")
        obs.count("thermal/fallback/retries")
        obs.count(f"thermal/fallback/unhealthy[{s}]")
    obs.count("thermal/fallback/exhausted")
    return last


def steady_state_stats(power, grid: Grid, t_amb: float = AMBIENT_C,
                       use_pallas: bool = False, solver: str = "pcg",
                       tol: float = 1e-8, *, device="cuda"
                       ) -> tuple[torch.Tensor, dict]:
    """:func:`steady_state` plus solver statistics.

    Returns ``(T_die, stats)`` with ``stats = {"iterations", "solver",
    "rel_residual", "attempts", "solved_by"}``: ``iterations`` counts CG
    iterations (pcg/mgcg) or V-cycles (mg), and ``rel_residual`` is the
    TRUE relative residual recomputed after the solve.  An unhealthy
    solve retries down :func:`fallback_chain`.  Non-finite power maps
    raise ``ValueError`` up front.
    """
    with obs.span("thermal/steady", solver=solver,
                  shape=f"{grid.n_layers}x{grid.dom_ny}x{grid.dom_nx}"):
        F = grid.fields(device)
        power = grid.pad_power(power, device)
        if not bool(torch.isfinite(power).all()):
            raise ValueError(
                "steady_state: power map has non-finite cells; refusing "
                "to solve — NaN temperatures would silently poison every "
                "downstream verdict")
        m = grid.margin
        if m:
            power = torch.nn.functional.pad(power, (m, m, m, m))
        dT, iters, fstats = _solve_fields_guarded(power, F, solver, tol)
        n_die = grid.n_die_layers
        if m:
            dT = dT[:n_die, m:m + grid.ny, m:m + grid.nx]
        else:
            dT = dT[:n_die]
        stats = {"iterations": iters, "solver": solver,
                 "rel_residual": fstats["rel_residual"],
                 "attempts": fstats["attempts"],
                 "solved_by": fstats["solved_by"]}
    obs.count("thermal/steady/solves")
    obs.observe(f"thermal/steady/iterations[{solver}]", stats["iterations"])
    obs.observe("thermal/steady/rel_residual", stats["rel_residual"])
    return dT + t_amb, stats


def steady_state(power, grid: Grid, t_amb: float = AMBIENT_C,
                 use_pallas: bool = False, solver: str = "pcg", *,
                 device="cuda") -> torch.Tensor:
    """Steady-state temperatures [C] of the DIE layers over the DIE.

    power: [n_die_layers, ny, nx] watts per cell of the die footprint (the
    spreader layer and margin ring are handled internally and stripped).
    ``solver`` selects the linear backend (:data:`SOLVERS`).
    """
    T, _ = steady_state_stats(power, grid, t_amb, use_pallas, solver,
                              device=device)
    return T


def transient(T0, power, g_lat, g_vert, g_pkg, cap, dt, n_steps: int,
              t_amb: float = AMBIENT_C):
    """Explicit transient:  C dT/dt = P - G (T - Tamb).  Returns
    ``(T(t_end), peaks [n_steps])``, each peak the pre-step maximum."""
    L = T0.shape[-3]
    vecs = _vectors(L, g_lat, g_vert, g_pkg, T0.device)
    cap3 = torch.as_tensor(np.asarray(cap, np.float32)
                           if not torch.is_tensor(cap) else cap,
                           dtype=torch.float32,
                           device=T0.device)[:, None, None]
    T, peaks = T0, []
    for _ in range(n_steps):
        dTdt = (power - stencil_ops.apply_operator_vectors(T - t_amb, vecs)
                ) / cap3
        peaks.append(T.max())
        T = T + dt * dTdt
    return T, torch.stack(peaks) if peaks else T0.new_zeros(0)


def transient_solve(power, grid: Grid, t_end: float,
                    t_amb: float = AMBIENT_C, *, device="cuda"):
    """Convenience wrapper: start from ambient, integrate to t_end
    seconds with the explicit scheme."""
    g = grid.conductances()
    power = grid.pad_power(power, device)
    dt = explicit_dt(grid)
    n = max(int(t_end / dt), 1)
    T0 = torch.full(power.shape, t_amb, dtype=torch.float32,
                    device=power.device)
    return transient(T0, power, g["g_lat"], g["g_vert"], g["g_pkg"],
                     grid.capacities(), dt, n, t_amb)


def explicit_dt(grid: Grid) -> float:
    """The explicit scheme's stability-bound time step (0.5x CFL margin)."""
    g = grid.conductances()
    cap = grid.capacities()
    gmax = float(4 * np.max(g["g_lat"]) + 2 * np.max(g["g_vert"])
                 + g["g_pkg"])
    return 0.5 * float(np.min(cap)) / gmax


def check_solver(solver: str) -> None:
    """Accept the fixed-cost inner solvers ("pcg", "mg"); raise for any
    other name."""
    if solver not in ("pcg", "mg"):
        raise ValueError(f"unknown solver {solver!r}; expected "
                         f"('pcg', 'mg')")


# ---------------------------------------------------------------------------
# implicit (theta-scheme) transient
# ---------------------------------------------------------------------------

def _implicit_scan(dT0, power, A, solve, n_steps: int, lhs=None):
    """theta-scheme steps in excess-temperature space  C dT/dt = P - G dT.

    Solves for the increment:  (C/dt + theta G) delta = P - G dT_n,  then
    dT_{n+1} = dT_n + delta.  ``solve`` is a fixed-cost closure for the
    LHS (:func:`implicit_lhs_solver`).  Returns ``(dT, peaks [n_steps])``
    with each peak the PRE-step maximum; with ``lhs`` (the LHS closure)
    given, ``(dT, (peaks, res))`` with the TRUE relative linear residual
    of each inner solve.
    """
    dTc, peaks, res = dT0, [], []
    for _ in range(n_steps):
        rhs = power - A(dTc)
        delta = solve(rhs)
        peaks.append(dTc.max())
        if lhs is not None:
            res.append(torch.linalg.vector_norm(rhs - lhs(delta))
                       / torch.linalg.vector_norm(rhs).clamp_min(1e-30))
        dTc = dTc + delta
    stack = lambda xs: torch.stack(xs) if xs else dT0.new_zeros(0)
    if lhs is not None:
        return dTc, (stack(peaks), stack(res))
    return dTc, stack(peaks)


def implicit_lhs_solver(A, F, cap3, dt, theta, *, solver: str = "pcg",
                        n_cg: int = 50, n_mg: int = 3,
                        use_pallas: bool = False):
    """Fixed-cost solve closure for the theta-scheme LHS
    ``(C/dt + theta G) delta = rhs`` over the fields operator, for a case
    batch ``[B, L, NY, NX]``.

    "pcg": ``n_cg`` Jacobi-PCG iterations on the closure ``A`` (the
    stencil kernel on a card).  "mg": ``n_mg`` V-cycles on the Galerkin
    hierarchy of the theta-scaled fields — built ONCE here, with its
    coarsest factorization, outside the time loop.
    """
    check_solver(solver)
    if solver == "mg":
        from repro_torch.core import multigrid
        F_lhs = {k: theta * v for k, v in F.items()}
        levels = multigrid.build_levels(F_lhs, cap3 / dt)
        coarse = multigrid.coarse_solve_fn(levels)
        return lambda rhs: multigrid.iterate_fixed(levels, rhs, n_mg,
                                                   coarse_solve=coarse)
    return pcg_lhs_solver(A, cap3, _diag_fields(F), dt, theta, n_cg)


def pcg_lhs_solver(A, cap3, diagA, dt: float, theta: float, n_cg: int):
    """The "pcg" closure of :func:`implicit_lhs_solver` for the step
    ``dt`` (a Python float), given the operator's Jacobi diagonal
    ``diagA``: ``n_cg`` Jacobi-PCG iterations on ``cap3/dt + theta A``.
    The variable-step replay builds one an interval with the same
    operations, so a step of the fixed one's length solves bit for bit
    as the fixed-step replay does."""
    c_dt = cap3 / dt
    lhs = lambda v: c_dt * v + theta * A(v)
    Minv = 1.0 / (c_dt + theta * diagA)
    return lambda rhs: pcg_fixed(lhs, Minv, rhs, n_cg)


def transient_implicit(T0, power, g_lat, g_vert, g_pkg, cap, dt,
                       n_steps: int, theta: float = 1.0,
                       t_amb: float = AMBIENT_C, n_cg: int = 50,
                       with_residuals: bool = False):
    """Implicit counterpart of :func:`transient` on the legacy uniform
    operator (same contract/returns); ``n_cg`` Jacobi-PCG iterations per
    step.  ``with_residuals=True`` appends the per-step relative linear
    residuals: ``(T, peaks, res)``."""
    L = T0.shape[-3]
    dev = T0.device
    vecs = _vectors(L, g_lat, g_vert, g_pkg, dev)
    diag = _diag(tuple(T0.shape), g_lat, g_vert, g_pkg, dev)
    cap3 = torch.as_tensor(np.asarray(cap, np.float32)
                           if not torch.is_tensor(cap) else cap,
                           dtype=torch.float32, device=dev)
    cap3 = cap3.expand(L)[:, None, None]
    A = lambda v: stencil_ops.apply_operator_vectors(v, vecs)
    lhs = lambda v: cap3 / dt * v + theta * A(v)
    Minv = 1.0 / (cap3 / dt + theta * diag)
    # pcg_fixed's dots run per case over the first dim: a batch of one
    solve = lambda rhs: pcg_fixed(lhs, Minv, rhs[None], n_cg)[0]
    out = _implicit_scan(T0 - t_amb, power, A, solve, n_steps,
                         lhs=lhs if with_residuals else None)
    if with_residuals:
        dT, (peaks, res) = out
        return dT + t_amb, peaks + t_amb, res
    dT, peaks = out
    return dT + t_amb, peaks + t_amb


def transient_implicit_fields(T0, power, F: dict, cap3, dt, n_steps: int,
                              theta: float = 1.0, t_amb: float = AMBIENT_C,
                              n_cg: int = 50, solver: str = "pcg",
                              n_mg: int = 3, use_pallas: bool = False,
                              with_residuals: bool = False):
    """Implicit theta-scheme on the heterogeneous (production) operator.

    T0/power: [L, NY, NX] over the full (die + margin) domain; cap3 the
    per-cell capacity field (``Grid.capacity_field()``).  ``solver``
    selects the fixed-cost inner solve: ``n_cg`` PCG iterations or
    ``n_mg`` multigrid V-cycles per step.
    """
    F = stencil_ops.pack_fields(F)
    A = lambda v: apply_operator_fields(v, F)
    Fb = stencil_ops.pack_fields({k: v[None] for k, v in F.items()})
    solve_b = implicit_lhs_solver(
        lambda v: apply_operator_fields(v, Fb), Fb, cap3[None], dt, theta,
        solver=solver, n_cg=n_cg, n_mg=n_mg)
    solve = lambda rhs: solve_b(rhs[None])[0]
    lhs = (lambda v: cap3 / dt * v + theta * A(v)) if with_residuals \
        else None
    out = _implicit_scan(T0 - t_amb, power, A, solve, n_steps, lhs=lhs)
    if with_residuals:
        dT, (peaks, res) = out
        return dT + t_amb, peaks + t_amb, res
    dT, peaks = out
    return dT + t_amb, peaks + t_amb


def transient_solve_implicit(power, grid: Grid, t_end: float,
                             n_steps: int, theta: float = 1.0,
                             t_amb: float = AMBIENT_C, n_cg: int = 50,
                             solver: str = "pcg", n_mg: int = 3, *,
                             device="cuda"):
    """Implicit counterpart of :func:`transient_solve` with a chosen step
    count.  ``solver="mg"`` runs the multigrid inner solve on the fields
    form of the same stack; "pcg" runs Jacobi-PCG on the legacy uniform
    operator.  Returns ``(T_end [L, ny, nx], peaks [n_steps])``.

    With ``obs`` enabled the per-step inner-solve residuals are computed
    on the device (one extra matvec a step) and recorded under
    ``thermal/transient/*``; the return stays the 2-tuple."""
    check_solver(solver)
    wres = obs.is_enabled()
    power = grid.pad_power(power, device)
    dt = t_end / n_steps
    T0 = torch.full(power.shape, t_amb, dtype=torch.float32,
                    device=power.device)
    with obs.span("thermal/transient", solver=solver, n_steps=n_steps):
        if solver == "mg":
            out = transient_implicit_fields(
                T0, power, grid.fields(device), grid.capacity_field(device),
                dt, n_steps, theta, t_amb, n_cg, solver="mg", n_mg=n_mg,
                with_residuals=wres)
        else:
            g = grid.conductances()
            out = transient_implicit(T0, power, g["g_lat"], g["g_vert"],
                                     g["g_pkg"], grid.capacities(), dt,
                                     n_steps, theta, t_amb, n_cg,
                                     with_residuals=wres)
    if wres:
        T, peaks, res = out
        obs.count("thermal/transient/solves")
        obs.count("thermal/transient/steps", n_steps)
        obs.count("thermal/transient/inner_iterations",
                  n_steps * (n_mg if solver == "mg" else n_cg))
        obs.observe_many("thermal/transient/step_rel_residual",
                         res.cpu().numpy().astype(np.float64))
        return T, peaks
    return out
