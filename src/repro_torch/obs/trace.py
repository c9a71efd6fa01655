"""Scoped wall-clock spans exported as Chrome trace-event JSON.

A span measures host wall clock between ``__enter__`` and ``__exit__``
(``time.perf_counter``); completed spans accumulate as Chrome
trace-event "complete" (``ph: "X"``) events — the format Perfetto and
``chrome://tracing`` load directly:

    {"traceEvents": [{"name": ..., "cat": "obs", "ph": "X",
                      "ts": <µs>, "dur": <µs>, "pid": ..., "tid": ...,
                      "args": {...}}, ...],
     "displayTimeUnit": "ms"}

Nesting is positional, per thread: a span opened inside another span's
``with`` block lies within the parent's [ts, ts+dur] window on the same
``tid`` row, which is exactly how the Perfetto timeline stacks them.
Each event also carries its stack ``depth`` in ``args`` so consumers
(and the tests) can check parent/child ordering without reconstructing
the interval containment.

Spans measure *host* time only.  Around CUDA work that is launch plus
any blocking copy to the host, NOT device execution time, unless the
span ends in such a copy.
"""
from __future__ import annotations

import json
import os
import threading
import time

_JSONABLE = (bool, int, float, str)


def _coerce(v):
    return v if isinstance(v, _JSONABLE) or v is None else str(v)


class _Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        local = self._tracer._local
        self._depth = getattr(local, "depth", 0)
        local.depth = self._depth + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self._tracer._local.depth = self._depth
        self._tracer._record(self.name, self._t0, t1, self._depth,
                             self.args)


class Tracer:
    """Collects completed spans for one process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self.epoch = time.perf_counter()    # ts origin (µs = 0)
        self.events: list[dict] = []
        self._on_close = None               # duration hook (obs wires it)

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name,
                     {k: _coerce(v) for k, v in args.items()})

    def _record(self, name, t0, t1, depth, args) -> None:
        ev = {
            "name": name,
            "cat": "obs",
            "ph": "X",
            "ts": (t0 - self.epoch) * 1e6,
            "dur": (t1 - t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": dict(args, depth=depth),
        }
        with self._lock:
            self.events.append(ev)
        if self._on_close is not None:
            self._on_close(name, t1 - t0)

    def reset(self) -> None:
        with self._lock:
            self.events.clear()
            self.epoch = time.perf_counter()

    def trace_object(self) -> dict:
        """The full Chrome trace-event JSON object."""
        with self._lock:
            return {"traceEvents": list(self.events),
                    "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.trace_object(), f, indent=1)
            f.write("\n")
        return path
