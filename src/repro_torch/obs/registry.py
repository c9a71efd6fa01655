"""Process-local metrics registry: counters, gauges, histograms.

Three metric kinds, all host-side Python (never device state):

* :class:`Counter`   — monotone integer totals (events, cache hits,
  kernel launches).
* :class:`Gauge`     — last-write-wins floats (the most recent
  residual, the current queue depth).
* :class:`Histogram` — raw float samples summarized at snapshot time
  with count/mean/min/max and p50/p95/p99 (linear-interpolation
  percentiles, matching ``np.percentile``'s default).

Names are flat strings; the repo's convention is a ``/``-separated
hierarchy with an optional ``[...]`` label suffix for per-bucket
variants (``engine/retrace/run_schedule[P=8,Kc=4,Kw=1]``).  The
registry itself carries no enabled/disabled logic — the front-end
(:mod:`repro_torch.obs`) guards every write so the disabled mode is a strict
no-op and never touches these structures.
"""
from __future__ import annotations

import math
import threading

#: hard cap on retained histogram samples; beyond it, new samples
#: overwrite a deterministic striding reservoir so percentile summaries
#: stay meaningful while memory stays bounded
MAX_SAMPLES = 1 << 17


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


def percentile(sorted_vals: list[float], q: float) -> float:
    """q-th percentile of pre-sorted values, linear interpolation
    (``np.percentile`` default: index = q/100 * (n-1))."""
    n = len(sorted_vals)
    if n == 0:
        return math.nan
    pos = q / 100.0 * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class Histogram:
    __slots__ = ("samples", "n_total")

    def __init__(self) -> None:
        self.samples: list[float] = []
        self.n_total = 0          # includes samples evicted past the cap

    def observe(self, v: float) -> None:
        v = float(v)
        if len(self.samples) < MAX_SAMPLES:
            self.samples.append(v)
        else:                     # deterministic striding overwrite
            self.samples[self.n_total % MAX_SAMPLES] = v
        self.n_total += 1

    def extend(self, vs) -> None:
        for v in vs:
            self.observe(v)

    def summary(self) -> dict:
        s = sorted(self.samples)
        if not s:
            return {"count": 0}
        return {
            "count": self.n_total,
            "mean": sum(s) / len(s),
            "min": s[0],
            "max": s[-1],
            "p50": percentile(s, 50.0),
            "p95": percentile(s, 95.0),
            "p99": percentile(s, 99.0),
        }


class Registry:
    """One process-local metric namespace (the singleton lives in
    :mod:`repro_torch.obs`; tests may instantiate their own)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def _get(self, table: dict, name: str, cls):
        m = table.get(name)
        if m is None:
            with self._lock:
                m = table.setdefault(name, cls())
        return m

    def counter(self, name: str) -> Counter:
        return self._get(self.counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self.gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self.histograms, name, Histogram)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()

    def snapshot(self) -> dict:
        """JSON-serializable state: ``{"counters": {...}, "gauges":
        {...}, "histograms": {name: {count, mean, min, max, p50, p95,
        p99}}}`` (sorted keys for diffable artifacts)."""
        return {
            "counters": {k: self.counters[k].value
                         for k in sorted(self.counters)},
            "gauges": {k: self.gauges[k].value
                       for k in sorted(self.gauges)},
            "histograms": {k: self.histograms[k].summary()
                           for k in sorted(self.histograms)},
        }
