"""Pareto-frontier arithmetic for policy sweeps.

The policy bench scores every (scenario, machine, policy) run on three
minimized axes — runtime slowdown, peak temperature, energy-to-solution
— and reports the non-dominated set per (scenario, machine).  The math
is generic and tiny, so it lives here where both the bench and the docs
walkthrough (docs/policies.md) can import it.
"""
from __future__ import annotations

from typing import Sequence


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True when ``a`` is at least as good on every axis and strictly
    better on one (all axes minimized).

    >>> dominates((1.0, 80.0), (1.2, 85.0))
    True
    >>> dominates((1.0, 90.0), (1.2, 85.0))   # trades temp for speed
    False
    >>> dominates((1.0, 80.0), (1.0, 80.0))   # equal points don't
    False
    """
    if len(a) != len(b):
        raise ValueError("points must share a dimension")
    return all(x <= y for x, y in zip(a, b)) \
        and any(x < y for x, y in zip(a, b))


def pareto_front(points: Sequence[Sequence[float]]) -> tuple[int, ...]:
    """Indices of the non-dominated points, in input order.

    Duplicated coordinates are all kept (none dominates its twin):

    >>> pareto_front([(1.0, 95.0), (2.5, 70.0), (2.6, 96.0), (1.0, 95.0)])
    (0, 1, 3)
    """
    return tuple(i for i, p in enumerate(points)
                 if not any(dominates(q, p) for j, q in enumerate(points)
                            if j != i))
