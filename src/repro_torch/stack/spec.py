"""Declarative heterogeneous 3D-stack specifications.

The thermal solver used to hard-code one stack shape — four identical
silicon logic dies over a TIM and a copper spreader (``StackParams``).
This module generalizes that to an ordered :class:`StackSpec` of dies and
interfaces (top → bottom, spreader last): AP logic layers, a SIMD die,
thinned DRAM dies, die-bond / TIM / TSV interface layers, each with its
own thickness / conductivity / heat capacity.  ``core/thermal.py`` builds
both the steady-state CG operator and the implicit transient stepper from
a spec; the legacy ``StackParams`` path is converted through
:func:`spec_from_params`, so ``PAPER_STACK`` is now just one named spec
(``PAPER_SPEC``) and reproduces the pre-refactor numbers exactly.

Everything here is plain numpy/float math: specs are static geometry
evaluated once per grid, then handed to the solvers as tensors.  This is
the PyTorch port's own copy of the reference ``stack/spec.py``.
Constants are documented in DESIGN.md §7.2 (logic stack) and §7.4 (DRAM
dies).
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np

# layer kinds
LOGIC = "logic"
DRAM = "dram"
SPREADER = "spreader"

# DRAM die defaults (DESIGN.md §7.4): thinned for TSV stacking, slightly
# below bulk-Si conductivity (metallization layers), F2F/TSV micro-bump
# interface resistance below an organic die-bond.
T_DRAM = 50e-6          # thinned DRAM die thickness [m]
K_DRAM = 100.0          # W/(m K)
C_DRAM = 1.75e6         # volumetric heat capacity [J/(m^3 K)]
R_TSV = 0.5e-6          # TSV/F2F bond interface resistance [m^2 K / W]


@dataclasses.dataclass(frozen=True)
class StackParams:
    """Legacy homogeneous-stack constants (one set for AP and SIMD).

    Kept as the compact parameterization of the paper's 4×Si + spreader
    stack; :func:`spec_from_params` expands it into a :class:`StackSpec`.
    """
    n_si_layers: int = 4
    t_si: float = 250e-6         # 3D die thickness [m] (2013-era stacking)
    k_si: float = 110.0          # silicon W/(m K)
    r_bond: float = 0.7e-6       # die-bond interface resistance [m^2 K / W]
    t_tim: float = 12e-6
    k_tim: float = 4.0
    t_spreader: float = 1e-3
    k_spreader: float = 400.0    # copper, resolved as a grid layer
    spreader_w: float = 30e-3
    t_sink: float = 6.9e-3
    k_sink: float = 400.0
    sink_w: float = 60e-3
    r_convec: float = 0.14       # total sink->ambient convective R [K/W]
    spread_beta: float = 1.0     # effective source growth through the
    #   spreader annulus beyond the die edge (the grid models the spreader
    #   only under the die footprint; heat keeps spreading laterally in the
    #   30 mm copper plate — source edge grows by beta * t_spreader per
    #   side before entering the sink; calibrated once, see DESIGN.md §7.2)
    c_si: float = 1.75e6         # volumetric heat capacity [J/(m^3 K)]
    c_cu: float = 3.45e6

    @property
    def n_layers(self) -> int:
        return self.n_si_layers + 1          # + spreader layer


PAPER_STACK = StackParams()


@dataclasses.dataclass(frozen=True)
class Layer:
    """One grid-resolved layer of the stack."""
    name: str
    kind: str                # LOGIC | DRAM | SPREADER
    t: float                 # thickness [m]
    k: float                 # thermal conductivity [W/(m K)]
    c: float                 # volumetric heat capacity [J/(m^3 K)]

    def __post_init__(self):
        if self.kind not in (LOGIC, DRAM, SPREADER):
            raise ValueError(f"unknown layer kind {self.kind!r}")
        if self.t <= 0 or self.k <= 0 or self.c <= 0:
            raise ValueError(f"layer {self.name!r}: t/k/c must be positive")


@dataclasses.dataclass(frozen=True)
class Interface:
    """Vertical interface between two adjacent layers.

    ``r`` is the *additional* area resistance [m^2 K / W] on top of the
    two half-layer conduction terms (die-bond glue, TIM, TSV micro-bumps).
    """
    name: str
    r: float

    def __post_init__(self):
        if self.r < 0:
            raise ValueError(f"interface {self.name!r}: r must be >= 0")


@dataclasses.dataclass(frozen=True)
class StackSpec:
    """Ordered die stack, top → bottom; the last layer is the spreader.

    ``interfaces[i]`` sits between ``layers[i]`` and ``layers[i+1]``.
    Die layers (everything but the spreader) exist only over the die
    footprint; the spreader spans the full grid domain (die + margin).
    The package path below the spreader (sink conduction + spreading +
    convection) stays a lumped resistance, same as before.
    """
    name: str
    layers: tuple[Layer, ...]
    interfaces: tuple[Interface, ...]
    # package path below the bottom (spreader) layer
    spreader_w: float = 30e-3
    t_sink: float = 6.9e-3
    k_sink: float = 400.0
    sink_w: float = 60e-3
    r_convec: float = 0.14
    spread_beta: float = 1.0

    def __post_init__(self):
        if len(self.layers) < 2:
            raise ValueError("a stack needs at least one die + the spreader")
        if len(self.interfaces) != len(self.layers) - 1:
            raise ValueError(
                f"{len(self.layers)} layers need {len(self.layers) - 1} "
                f"interfaces, got {len(self.interfaces)}")
        if self.layers[-1].kind != SPREADER:
            raise ValueError("the bottom layer must be the spreader")
        if any(l.kind == SPREADER for l in self.layers[:-1]):
            raise ValueError("only the bottom layer may be a spreader")

    # ---------------------------------------------------------- structure
    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def n_die_layers(self) -> int:
        """Layers carrying devices (everything above the spreader)."""
        return len(self.layers) - 1

    @property
    def dram_layers(self) -> tuple[int, ...]:
        return tuple(i for i, l in enumerate(self.layers) if l.kind == DRAM)

    @property
    def logic_layers(self) -> tuple[int, ...]:
        return tuple(i for i, l in enumerate(self.layers) if l.kind == LOGIC)

    def layer_mask(self, kind: str) -> np.ndarray:
        """[n_layers] float mask selecting layers of ``kind``."""
        return np.array([1.0 if l.kind == kind else 0.0
                         for l in self.layers], np.float32)

    # ------------------------------------------------------- conductances
    def lateral_conductances(self) -> np.ndarray:
        """Per-layer lateral sheet conductance g = k * t, [n_layers]."""
        return np.array([l.k * l.t for l in self.layers])

    def vertical_resistances(self) -> np.ndarray:
        """Per-interface area resistance [m^2 K / W], [n_layers - 1].

        Half-layer conduction on each side plus the interface term:
        r_i = t_i / (2 k_i) + r_if + t_{i+1} / (2 k_{i+1}).
        """
        out = np.empty(len(self.interfaces))
        for i, iface in enumerate(self.interfaces):
            a, b = self.layers[i], self.layers[i + 1]
            out[i] = 0.5 * a.t / a.k + iface.r + 0.5 * b.t / b.k
        return out

    def vertical_conductances(self, cell_area: float) -> np.ndarray:
        """Per-interface per-cell conductance [W/K], [n_layers - 1]."""
        return cell_area / self.vertical_resistances()

    def capacities(self, cell_area: float) -> np.ndarray:
        """Per-layer per-cell heat capacity [J/K], [n_layers]."""
        return np.array([l.c * cell_area * l.t for l in self.layers])

    def package_resistance(self, source_area_m2: float) -> float:
        """Lumped R from the spreader underside to ambient [K/W].

        The spreader plate itself is grid-resolved; its footprint under
        the die feeds the sink through spreading in the sink base.
        """
        spreader = self.layers[-1]
        a_sink = self.sink_w ** 2
        h_sink_eff = 1.0 / (self.r_convec * a_sink)
        # effective source: the copper plate keeps spreading beyond the
        # die edge (outside the grid-resolved footprint)
        src_w = min(math.sqrt(source_area_m2)
                    + 2 * self.spread_beta * spreader.t,
                    self.spreader_w)
        r_sp = spreading_resistance(src_w ** 2, a_sink, self.t_sink,
                                    self.k_sink, h_sink_eff)
        r_cond_sink = self.t_sink / (self.k_sink * a_sink)
        return r_sp + r_cond_sink + self.r_convec


def spreading_resistance(a_source: float, a_plate: float, t: float,
                         k: float, h: float) -> float:
    """Lee/Song/Au closed-form constriction/spreading resistance."""
    r1 = math.sqrt(a_source / math.pi)
    r2 = math.sqrt(a_plate / math.pi)
    eps = r1 / r2
    tau = t / r2
    Bi = h * r2 / k
    lam = math.pi + 1.0 / (math.sqrt(math.pi) * eps)
    phi = (math.tanh(lam * tau) + lam / Bi) / (1.0 + lam / Bi * math.tanh(lam * tau))
    psi = (eps * tau / math.sqrt(math.pi)
           + (1.0 - eps) * phi / math.sqrt(math.pi))
    return psi / (k * r1 * math.sqrt(math.pi))


# ---------------------------------------------------------------------------
# named specs / builders
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def spec_from_params(p: StackParams = PAPER_STACK) -> StackSpec:
    """Expand the legacy homogeneous parameterization into a spec.

    Reproduces the pre-refactor conductances exactly: Si|Si interfaces are
    half-Si + bond + half-Si = t_si/k_si + r_bond, and the bottom die
    couples to the spreader through half-Si + TIM + half-spreader.
    """
    n = p.n_si_layers
    layers = tuple(Layer(f"si_{n - i}", LOGIC, p.t_si, p.k_si, p.c_si)
                   for i in range(n))
    layers += (Layer("spreader", SPREADER, p.t_spreader, p.k_spreader,
                     p.c_cu),)
    interfaces = tuple(Interface("bond", p.r_bond) for _ in range(n - 1))
    interfaces += (Interface("tim", p.t_tim / p.k_tim),)
    return StackSpec(
        name=f"{n}xSi+spreader", layers=layers, interfaces=interfaces,
        spreader_w=p.spreader_w, t_sink=p.t_sink, k_sink=p.k_sink,
        sink_w=p.sink_w, r_convec=p.r_convec, spread_beta=p.spread_beta)


PAPER_SPEC = spec_from_params(PAPER_STACK)


def dram_on_logic(n_dram: int, params: StackParams = PAPER_STACK, *,
                  t_dram: float = T_DRAM, k_dram: float = K_DRAM,
                  c_dram: float = C_DRAM, r_tsv: float = R_TSV,
                  name: str | None = None) -> StackSpec:
    """``n_dram`` thinned DRAM dies stacked ON TOP of the logic stack.

    Top → bottom: DRAM_n .. DRAM_1 | logic dies | spreader — the paper's
    memory-on-logic configuration.  Heat flows down to the sink, so the
    DRAM sits on the hot side of the logic stack and its floor temperature
    is set by the top logic die.  ``n_dram = 0`` returns the bare logic
    spec (== :func:`spec_from_params`).
    """
    if n_dram < 0:
        raise ValueError("n_dram must be >= 0")
    base = spec_from_params(params)
    if n_dram == 0:
        return base
    dram = tuple(Layer(f"dram_{n_dram - i}", DRAM, t_dram, k_dram, c_dram)
                 for i in range(n_dram))
    tsv = tuple(Interface("tsv", r_tsv) for _ in range(n_dram))
    return dataclasses.replace(
        base, name=name or f"{n_dram}xDRAM+{base.name}",
        layers=dram + base.layers, interfaces=tsv + base.interfaces)
