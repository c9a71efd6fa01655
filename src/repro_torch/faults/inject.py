"""Deterministic failure injection for the solver fallback chain (the
PyTorch port's own copy of the reference module).

``core/thermal._solve_fields_guarded`` walks a fallback chain of linear
backends and advances past any attempt whose TRUE relative residual is
non-finite or above the health bar.  Testing/benchmarking that path
needs a way to make a backend fail ON DEMAND without perturbing the
physics — :func:`poison_solver` is that hook: inside the context the
named backends return a NaN solution (the signature of a diverged
solve), so the health check fires exactly as it would on a genuine
divergence and the chain retries down the list.

The poison set is process-local host state consulted at dispatch time,
in the guarded driver, so it costs nothing when empty.
"""
from __future__ import annotations

import contextlib

_POISONED: set[str] = set()


def solver_poisoned(name: str) -> bool:
    """Is ``name`` currently forced to diverge?  (host-side check)"""
    return name in _POISONED


@contextlib.contextmanager
def poison_solver(*names: str):
    """Force the named solver backends ("pcg"/"mg"/"mgcg") to return a
    NaN solution inside the context — a deterministic stand-in for
    divergence that exercises the real detection + fallback path."""
    added = set(names) - _POISONED
    _POISONED.update(added)
    try:
        yield
    finally:
        _POISONED.difference_update(added)


__all__ = ["poison_solver", "solver_poisoned"]
