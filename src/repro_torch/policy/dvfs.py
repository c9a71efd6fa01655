"""Technology-node DVFS frequency/voltage tables.

A :class:`DVFSTable` is a sorted set of discrete operating points
(frequency, voltage) for one technology node — the ``build_dvfs_table``
structure of the snipersim-hotspot integration: the node names a table,
each row is an OP the controller may sit at, and scaling follows the
classic CMOS dynamic-power law

    P_dyn ∝ f · V²     (per OP: ``power_scale = (f/f₀)(V/V₀)²``),

normalized to the table's top OP ``(f₀, V₀)``, while *performance* only
follows frequency (``perf_scale = f/f₀``).  That split is why DVFS
Pareto-dominates plain duty-cycling on the energy axis: stepping an OP
down buys a super-linear power cut for a linear slowdown.

Tables are frozen dataclasses of tuples, so a policy carrying one stays
hashable.  Voltages follow published near-threshold-to-
nominal ranges per node; the exact figures are calibration constants in
the DESIGN.md §10 sense, not measurements.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One DVFS step: core frequency [MHz] and supply voltage [V]."""
    f_mhz: float
    v: float

    def __post_init__(self):
        if self.f_mhz <= 0 or self.v <= 0:
            raise ValueError("operating points need positive f and V; "
                             f"got ({self.f_mhz}, {self.v})")

    @property
    def label(self) -> str:
        return f"{self.f_mhz:g}MHz@{self.v:g}V"


@dataclasses.dataclass(frozen=True)
class DVFSTable:
    """Discrete operating points of one technology node, slowest first."""
    node: str
    points: tuple[OperatingPoint, ...]

    def __post_init__(self):
        if len(self.points) < 2:
            raise ValueError("a DVFS table needs >= 2 operating points")
        freqs = [p.f_mhz for p in self.points]
        if freqs != sorted(freqs) or len(set(freqs)) != len(freqs):
            raise ValueError("operating points must be strictly "
                             "frequency-sorted, slowest first")

    @property
    def n_ops(self) -> int:
        return len(self.points)

    @property
    def top(self) -> OperatingPoint:
        return self.points[-1]

    def power_scales(self) -> tuple[float, ...]:
        """Dynamic-power factor per OP (f·V², normalized to the top OP)."""
        f0, v0 = self.top.f_mhz, self.top.v
        return tuple((p.f_mhz / f0) * (p.v / v0) ** 2 for p in self.points)

    def perf_scales(self) -> tuple[float, ...]:
        """Performance (frequency) factor per OP, normalized likewise."""
        f0 = self.top.f_mhz
        return tuple(p.f_mhz / f0 for p in self.points)

    def labels(self) -> tuple[str, ...]:
        return tuple(p.label for p in self.points)


#: per-node (f [MHz], V) rows, slowest first — the snipersim-hotspot
#: table structure with voltage ranges typical of each node's datasheets
_NODE_ROWS: dict[str, tuple[tuple[float, float], ...]] = {
    "45nm": ((800, 0.85), (1200, 0.95), (1600, 1.05), (2000, 1.15),
             (2400, 1.25)),
    "32nm": ((800, 0.80), (1300, 0.90), (1800, 1.00), (2300, 1.10),
             (2800, 1.20)),
    "22nm": ((800, 0.70), (1400, 0.80), (2000, 0.90), (2600, 1.00),
             (3200, 1.10)),
    "14nm": ((600, 0.60), (1300, 0.70), (2000, 0.80), (2700, 0.95),
             (3400, 1.05)),
}


def nodes() -> tuple[str, ...]:
    return tuple(_NODE_ROWS)


def build_dvfs_table(node: str = "22nm") -> DVFSTable:
    """The operating-point table of a technology node.

    >>> t = build_dvfs_table("22nm")
    >>> t.n_ops, t.top.label
    (5, '3200MHz@1.1V')
    >>> [round(s, 3) for s in t.power_scales()][:2]
    [0.101, 0.231]
    """
    if node not in _NODE_ROWS:
        raise ValueError(f"unknown technology node {node!r}; "
                         f"expected one of {nodes()}")
    return DVFSTable(node, tuple(OperatingPoint(f, v)
                                 for f, v in _NODE_ROWS[node]))
