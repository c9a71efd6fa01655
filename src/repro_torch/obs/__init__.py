"""``repro_torch.obs`` — the repo-wide observability layer.

One process-local metrics registry (counters / gauges / histograms
with p50/p95/p99 summaries, :mod:`repro_torch.obs.registry`) plus scoped
wall-clock spans exported as Chrome trace-event JSON loadable in
Perfetto (:mod:`repro_torch.obs.trace`).  Everything funnels through this
module's functions so call sites stay one line::

    from repro_torch import obs

    obs.count("sweep/cache/hit")
    obs.observe("serving/request_latency_s", 0.132)
    with obs.span("sweep/replay", cases=24):
        ...

**Disabled mode is a strict no-op**: when :func:`is_enabled` is False
(the default; enable with ``REPRO_OBS=1`` or :func:`enable`), every
recording function returns immediately without touching the registry,
and :func:`span` hands back a shared null context manager — no
allocation, no clock read.

Port note: this is a copy of the reference's ``repro.obs`` (standard
library only), with the same switch and the same names.  Two rules
follow from PyTorch's execution model:

* :func:`observe`/:func:`gauge` take host numbers; reading a CUDA tensor
  with ``float(x)`` waits for the card, so do it where the value already
  crosses to the host (the replay's telemetry reads the arrays that cross
  once, at its end).
* :func:`span` measures host wall clock.  CUDA launches are
  asynchronous, so a span around launches alone measures their issue
  time; a span that ends in a copy to the host (``replay_cases``,
  ``run_sweep``) measures the device work too.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

from repro_torch.obs.registry import Registry
from repro_torch.obs.trace import Tracer

__all__ = [
    "enable", "disable", "is_enabled", "scoped", "reset",
    "count", "value", "values_by_prefix", "gauge", "observe",
    "observe_many",
    "span", "snapshot", "trace_events", "write_trace",
]

_registry = Registry()
_tracer = Tracer()
_tracer._on_close = lambda name, dur_s: \
    _registry.histogram(f"span/{name}").observe(dur_s)

_enabled = os.environ.get("REPRO_OBS", "").lower() in ("1", "true",
                                                       "yes", "on")


# ---------------------------------------------------------------- control

def is_enabled() -> bool:
    return _enabled


def enable(reset: bool = False) -> None:
    """Turn collection on (optionally wiping prior metrics/spans)."""
    global _enabled
    if reset:
        globals()["reset"]()
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


@contextmanager
def scoped(on: bool = True):
    """Temporarily force the enabled state (tests / A-B timing)."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    try:
        yield
    finally:
        _enabled = prev


def reset() -> None:
    """Wipe all metrics and spans (the trace clock restarts at 0)."""
    _registry.reset()
    _tracer.reset()


# ---------------------------------------------------------------- metrics

def count(name: str, n: int = 1) -> None:
    """Add ``n`` to a counter."""
    if _enabled:
        _registry.counter(name).inc(n)


def value(name: str) -> int:
    """Current value of a counter (0 if it never fired)."""
    c = _registry.counters.get(name)
    return 0 if c is None else c.value


def values_by_prefix(prefix: str) -> dict[str, int]:
    """All counters under a name prefix, e.g. ``policy/dvfs-22nm/`` —
    how the policy bench collects per-operating-point residency without
    knowing a table's labels up front (docs/observability.md)."""
    return {name: c.value for name, c in sorted(_registry.counters.items())
            if name.startswith(prefix)}


def gauge(name: str, v: float) -> None:
    """Set a last-write-wins gauge."""
    if _enabled:
        _registry.gauge(name).set(v)


def observe(name: str, v: float) -> None:
    """Add one sample to a histogram."""
    if _enabled:
        _registry.histogram(name).observe(v)


def observe_many(name: str, vs) -> None:
    """Add a batch of samples (any iterable of numbers) to a histogram."""
    if _enabled:
        _registry.histogram(name).extend(vs)


# ---------------------------------------------------------------- spans

class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpan()


def span(name: str, **args):
    """Scoped wall-clock span.  Nested spans stack per thread; each
    completed span becomes a Chrome trace event AND feeds the
    ``span/<name>`` duration histogram (so p50/p95/p99 of any span
    show up in :func:`snapshot`).  Extra keyword arguments land in the
    event's ``args``."""
    if not _enabled:
        return _NULL_SPAN
    return _tracer.span(name, **args)


# ---------------------------------------------------------------- export

def snapshot() -> dict:
    """JSON-serializable registry state (see
    :meth:`repro_torch.obs.registry.Registry.snapshot`)."""
    return _registry.snapshot()


def trace_events() -> dict:
    """The Chrome trace-event JSON object for all completed spans."""
    return _tracer.trace_object()


def write_trace(path: str) -> str:
    """Write the span trace to ``path`` (open it in
    https://ui.perfetto.dev or ``chrome://tracing``)."""
    return _tracer.write(path)
