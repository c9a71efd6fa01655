"""HotSpot-equivalent 3D RC thermal model of the die stack (PyTorch port).

Each layer of a :class:`~repro_torch.stack.spec.StackSpec` (dies top to
bottom, copper spreader last) is a regular grid over the die footprint
plus a spreader-only margin ring; below the spreader a lumped package
conductance leads to ambient.  The operator ``G`` is the seven-field
face-conductance stencil (``Grid.fields``), applied by
``kernels/thermal_stencil`` — the hand-written CUDA kernel on a card, its
plain PyTorch version on the CPU.

Port note: this slice ports what the closed-loop replay uses — ``Grid``
(conductances, fields, capacities), ``apply_operator_fields``,
``_diag_fields``, the fixed-iteration ``pcg_fixed`` (batched over a
leading case dimension, the reference's ``vmap`` written out) and
``implicit_lhs_solver`` with ``solver="pcg"``.  The steady-state solves,
the legacy uniform-per-layer operator and multigrid follow (ROADMAP
Queue 1, item 2).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.thermal_stencil import ops as stencil_ops
from repro_torch.stack.spec import (PAPER_STACK, StackParams, StackSpec,
                                    spec_from_params)


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
        (bottom lump).
        """
        dev = resolve_device(device)
        return {k: torch.from_numpy(v).to(dev)
                for k, v in self.fields_numpy().items()}

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


# ---------------------------------------------------------------------------
# heterogeneous (face-conductance-field) operator
# ---------------------------------------------------------------------------

def apply_operator_fields(T: torch.Tensor, F: dict) -> torch.Tensor:
    """y = G @ T with per-face conductances (zero faces = adiabatic).

    ``T`` is [L, NY, NX] or a batch [B, L, NY, NX]; runs the CUDA stencil
    for a CUDA tensor and the plain version for a CPU one.
    """
    return stencil_ops.apply_operator_fields(T, F)


def _diag_fields(F: dict) -> torch.Tensor:
    d = (F["gx_lf"] + F["gx_rt"] + F["gy_up"] + F["gy_dn"]
         + F["gz_up"] + F["gz_dn"] + F["g_pkg"])
    return torch.where(d > 0, d, 1.0)     # void cells: identity rows


# ---------------------------------------------------------------------------
# fixed-iteration preconditioned CG over a batch of cases
# ---------------------------------------------------------------------------

def _as_precond(Minv):
    """Normalize a preconditioner to a closure: an inverse-diagonal
    tensor (Jacobi) or a callable."""
    return Minv if callable(Minv) else (lambda r: Minv * r)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-case dot product over every dim after the first, shaped to
    broadcast against the case tensors."""
    dims = tuple(range(1, a.dim()))
    return (a * b).sum(dim=dims, keepdim=True)


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


def check_solver(solver: str) -> None:
    """Accept the ported inner solver ("pcg"); raise for "mg", which is
    not ported yet, and for unknown names."""
    if solver == "mg":
        raise NotImplementedError(
            "solver='mg' is not ported yet (multigrid and its rb_line_sweep "
            "kernel: ROADMAP Queue 1, item 2)")
    if solver != "pcg":
        raise ValueError(f"unknown solver {solver!r}; expected "
                         f"('pcg', 'mg')")


def implicit_lhs_solver(A, F, cap3, dt, theta, *, solver: str = "pcg",
                        n_cg: int = 50, n_mg: int = 3):
    """Fixed-cost solve closure for the theta-scheme LHS
    ``(C/dt + theta G) delta = rhs`` over the fields operator: ``n_cg``
    Jacobi-PCG iterations on the closure ``A`` (the stencil kernel on a
    card).  ``solver="mg"`` (``n_mg`` V-cycles) is not ported yet."""
    check_solver(solver)
    c_dt = cap3 / dt
    lhs = lambda v: c_dt * v + theta * A(v)
    Minv = 1.0 / (c_dt + theta * _diag_fields(F))
    return lambda rhs: pcg_fixed(lhs, Minv, rhs, n_cg)
