"""Request-trace generation for the serving co-simulation (the port's
copy of the reference's ``serving/traffic.py``; NumPy only, held equal to
it by ``tests/test_torch_serving.py``).

A :class:`TrafficSpec` names a traffic *shape* (constant QPS, diurnal
sinusoid, or bursty two-state MMPP), a mean rate, and a base interval
grid; :meth:`TrafficSpec.arrivals` lowers it to a deterministic
per-interval request-count array (seeded ``numpy`` generator, so the
same spec always replays the same trace — the property every cached
artifact and baseline-gated bench metric relies on).

The diurnal period defaults to the horizon, i.e. ONE full day-cycle is
time-compressed onto the simulated window — the same dilation
convention the trace replay itself uses (README §co-simulation): the
shape supplies the load profile, the horizon supplies the wall time.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

SHAPES = ("constant", "diurnal", "bursty")


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """One request-arrival scenario on a uniform base-interval grid.

    ``mean_qps <= 0`` means "auto": the serving scenario scales the rate
    to a target fraction of machine saturation
    (:class:`repro_torch.serving.sim.ServingScenario.load`).
    """
    shape: str = "diurnal"
    mean_qps: float = 0.0       # <= 0 -> scenario-scaled (load fraction)
    horizon_s: float = 3600.0
    interval_s: float = 1.0
    seed: int = 0
    # diurnal knobs
    period_s: float = 0.0       # <= 0 -> one full cycle over the horizon
    swing: float = 0.8          # peak-to-mean modulation depth in [0, 1]
    # bursty (two-state Markov-modulated Poisson) knobs
    burst_ratio: float = 4.0    # burst-state rate / quiet-state rate
    p_enter: float = 0.02       # per-interval P(quiet -> burst)
    p_exit: float = 0.10        # per-interval P(burst -> quiet)

    def __post_init__(self):
        if self.shape not in SHAPES:
            raise ValueError(f"unknown traffic shape {self.shape!r}; "
                             f"expected one of {SHAPES}")
        # every check below is phrased so NaN FAILS it: `nan <= 0` and
        # `nan < 1` are False, so the naive comparisons would silently
        # accept NaN knobs and lower them into NaN rate paths
        if not (math.isfinite(self.horizon_s) and self.horizon_s > 0
                and math.isfinite(self.interval_s)
                and self.interval_s > 0):
            raise ValueError(
                "horizon_s and interval_s must be finite and > 0; got "
                f"({self.horizon_s!r}, {self.interval_s!r})")
        if self.interval_s > self.horizon_s:
            raise ValueError("interval_s must not exceed horizon_s")
        if not math.isfinite(self.mean_qps):
            raise ValueError("mean_qps must be finite (<= 0 means "
                             f"scenario-scaled); got {self.mean_qps!r}")
        if not math.isfinite(self.period_s):
            raise ValueError("period_s must be finite (<= 0 means one "
                             f"cycle per horizon); got {self.period_s!r}")
        if not 0.0 <= self.swing <= 1.0:
            raise ValueError(f"swing must be in [0, 1]; got {self.swing!r}")
        if not (math.isfinite(self.burst_ratio)
                and self.burst_ratio >= 1.0):
            raise ValueError("burst_ratio must be finite and >= 1; got "
                             f"{self.burst_ratio!r}")
        if not (0.0 < self.p_enter <= 1.0 and 0.0 < self.p_exit <= 1.0):
            raise ValueError("p_enter/p_exit must be in (0, 1]")

    @property
    def n_intervals(self) -> int:
        return max(int(round(self.horizon_s / self.interval_s)), 1)

    @property
    def label(self) -> str:
        return f"{self.shape}@{self.mean_qps:g}qps/{self.horizon_s:g}s"

    # ------------------------------------------------------------- lowering
    def rate_qps(self, mean_qps: float | None = None) -> np.ndarray:
        """[T] per-interval Poisson rate.  Deterministic for constant and
        diurnal shapes; for bursty the seeded two-state Markov chain's
        realized rate path (mean-preserving in expectation)."""
        mean = self.mean_qps if mean_qps is None else mean_qps
        # `not (mean > 0)` rather than `mean <= 0`: NaN must raise too
        if not (math.isfinite(mean) and mean > 0):
            raise ValueError("mean_qps must be resolved (finite, > 0) "
                             "before lowering; pass one or set it on "
                             f"the spec; got {mean!r}")
        T = self.n_intervals
        if self.shape == "constant":
            return np.full(T, mean)
        if self.shape == "diurnal":
            period = self.period_s if self.period_s > 0 else self.horizon_s
            t = (np.arange(T) + 0.5) * self.interval_s
            # trough at t=0, peak mid-cycle; mean over a full period = mean
            return mean * (1.0 + self.swing
                           * np.sin(2 * math.pi * t / period - math.pi / 2))
        # bursty: two-state MMPP; stationary split fixes the state rates so
        # the long-run mean is `mean`:  mean = r_lo (pi_lo + ratio pi_hi)
        rng = np.random.default_rng(self.seed)
        pi_hi = self.p_enter / (self.p_enter + self.p_exit)
        r_lo = mean / ((1.0 - pi_hi) + self.burst_ratio * pi_hi)
        state = rng.random() < pi_hi          # start from stationarity
        rates = np.empty(T)
        flips = rng.random(T)
        for t in range(T):
            rates[t] = r_lo * (self.burst_ratio if state else 1.0)
            state = (flips[t] < self.p_enter) if not state \
                else (flips[t] >= self.p_exit)
        return rates

    def arrivals(self, mean_qps: float | None = None) -> np.ndarray:
        """[T] integer request arrivals: Poisson counts at the shape's
        rate path, from the spec's seeded generator."""
        rates = self.rate_qps(mean_qps)
        rng = np.random.default_rng(self.seed + 1)
        return rng.poisson(rates * self.interval_s).astype(np.int64)


__all__ = ["TrafficSpec", "SHAPES"]
