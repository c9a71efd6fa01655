"""Batched scenario-sweep subsystem (PyTorch port of ``repro.sweep``).

Declares a scenario grid — workloads × dataset sizes × DRAM stack
heights × feedback/DTM modes × policies — as a
:class:`~repro_torch.sweep.spec.SweepSpec` (``spec.py``), lowers it to
batched closed-loop replays over the ``stack/feedback`` path on the card
(``engine.py``), and serves repeat invocations bit-identically from a
content-hashed on-disk cache of the port's own namespace (``cache.py``).
"""
from repro_torch.sweep.spec import SweepPoint, SweepSpec  # noqa: F401
from repro_torch.sweep.engine import (SweepRecord, SweepResult,  # noqa: F401
                                      run_sweep)
