"""Declarative sweep specifications and their content hash.

A :class:`SweepSpec` names a full scenario grid — registered workloads ×
dataset sizes × DRAM die counts × feedback modes × DTM/DVFS policies
(× machines) — plus the
replay resolution (grid, intervals, horizon, solver knobs).  It is pure
data: :meth:`SweepSpec.points` enumerates the Cartesian product and
:meth:`SweepSpec.content_hash` digests the *canonical JSON* of every
field (plus a schema version) into the cache key, so any field
perturbation — one more workload, a different DTM mode, a finer grid —
misses the cache while the identical spec always hits it
(DESIGN.md §8).

Port note: a copy of ``repro.sweep.spec``, validated against the port's
workload and policy registries.  The same fields and schema give the
same :meth:`SweepSpec.content_hash` as the reference's; the port's cache
keeps its entries apart by file name and manifest (``cache.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json

# Bump when the result schema or replay semantics change: a new schema
# must never be served stale results from an old cache entry.
# 2: solver/n_mg fields (selectable multigrid inner solve).
# 3: device-resident AP engine — trace_elems clamp 256 -> 2048 and
#    instance-scaled histogram bins re-derive every workload trace.
# 4: ap_backend field (megakernel trace capture) and trace_elems clamp
#    2048 -> 2^20; traces at sizes past 2048^2 change element counts.
# 5: policy axis (DTM/DVFS policy engine) and the dyn_W energy array in
#    every record; pre-policy entries lack both.
CACHE_SCHEMA = 5

#: trace-capture execution paths for the AP workloads (all bit-exact;
#: the field exists so a spec records how its traces were captured)
AP_BACKENDS = ("device", "eager", "megakernel")

#: inner-solver axis for the implicit replay steps (engine.py resolves
#: it through ``thermal.implicit_lhs_solver``): fixed-iteration
#: Jacobi-PCG or fixed-cycle geometric multigrid
SOLVERS = ("pcg", "mg")

#: feedback-mode axis -> FeedbackParams factory (resolved in engine.py)
FB_MODES = ("closed", "nodtm", "open")


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One scenario: a (workload, size, stack, feedback, policy) tuple."""
    workload: str
    size: int            # dataset size N (the AP is sized to it, §3)
    n_dram: int          # DRAM dies stacked on the logic stack
    fb_mode: str         # one of FB_MODES
    policy: str = "ramp"     # DTM/DVFS controller (policy registry);
    # only "closed" mode runs it — "nodtm"/"open" disable DTM entirely

    @property
    def label(self) -> str:
        return (f"{self.workload}/N{self.size}/dram{self.n_dram}/"
                f"{self.fb_mode}/{self.policy}")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A scenario grid and the resolution to replay it at."""
    workloads: tuple[str, ...]
    sizes: tuple[int, ...] = (2 ** 20,)
    n_dram: tuple[int, ...] = (2,)
    fb_modes: tuple[str, ...] = ("closed",)
    policies: tuple[str, ...] = ("ramp",)   # policy registry names
    machines: tuple[str, ...] = ("ap", "simd")
    grid_n: int = 16
    n_intervals: int = 24
    t_end: float = 0.25
    steps_per_interval: int = 2
    n_cg: int = 40
    theta: float = 1.0
    n_picard: int = 6     # Picard iterations for the implicit couplings;
    # the documented 0.05 °C/interval bar needs ~20 in the most violent
    # sweep regimes (refresh 4x + leakage much above trip) — "open" mode
    # keeps its own fixed count (FeedbackParams.disabled)
    solver: str = "pcg"   # inner solve per implicit step (SOLVERS);
    # results depend on it (different fixed-cost approximations), so it
    # is part of the spec and the cache key — unlike the shard count,
    # which is a pure execution detail and deliberately NOT a field
    n_mg: int = 3         # V-cycles per step when solver == "mg"
    ap_backend: str = "device"   # AP trace-capture path (AP_BACKENDS);
    # every path is pinned bit-identical by the differential tests, so
    # this cannot change results — it is a spec field (and thus part of
    # the cache key) anyway so a cache entry records exactly how its
    # traces were produced, and because the schema-4 megakernel path is
    # what makes the lifted trace_elems clamp affordable

    def __post_init__(self):
        from repro_torch.workloads import registry
        for w in self.workloads:
            registry.get(w)                      # raises on unknown names
        for mode in self.fb_modes:
            if mode not in FB_MODES:
                raise ValueError(f"unknown fb_mode {mode!r}; "
                                 f"expected one of {FB_MODES}")
        from repro_torch import policy as policy_registry
        for pol in self.policies:
            policy_registry.get(pol)             # raises on unknown names
        for mc in self.machines:
            if mc not in ("ap", "simd"):
                raise ValueError(f"unknown machine {mc!r}")
        if any(s < 1024 for s in self.sizes):
            raise ValueError("dataset sizes below 1024 have no "
                             "comparable design point")
        if any(n < 0 for n in self.n_dram):
            raise ValueError("n_dram must be >= 0")
        if self.n_picard < 1:
            raise ValueError("n_picard must be >= 1")
        if self.solver not in SOLVERS:
            raise ValueError(f"unknown solver {self.solver!r}; "
                             f"expected one of {SOLVERS}")
        if self.n_mg < 1:
            raise ValueError("n_mg must be >= 1")
        if self.ap_backend not in AP_BACKENDS:
            raise ValueError(f"unknown ap_backend {self.ap_backend!r}; "
                             f"expected one of {AP_BACKENDS}")

    # -------------------------------------------------------------- points
    def points(self) -> tuple[SweepPoint, ...]:
        """The Cartesian scenario grid, in deterministic order."""
        return tuple(SweepPoint(w, s, d, f, p) for w, s, d, f, p
                     in itertools.product(self.workloads, self.sizes,
                                          self.n_dram, self.fb_modes,
                                          self.policies))

    @property
    def n_points(self) -> int:
        return (len(self.workloads) * len(self.sizes) * len(self.n_dram)
                * len(self.fb_modes) * len(self.policies))

    def trace_elems(self, size: int) -> int:
        """Small-instance element count for a dataset size — delegates
        to the shared sizing rule (`cosim.trace_elems`) so sweeps and
        the standalone entry points replay identical traces for identical
        scenarios."""
        from repro_torch.core import cosim
        return cosim.trace_elems(size)

    # --------------------------------------------------------------- hash
    def canonical(self) -> dict:
        """Canonical JSON form (the hash input): tuples become lists so
        the dict compares equal after any JSON round-trip."""
        d = dataclasses.asdict(self)
        d["schema"] = CACHE_SCHEMA
        return json.loads(json.dumps(d))

    def content_hash(self) -> str:
        blob = json.dumps(self.canonical(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:20]
