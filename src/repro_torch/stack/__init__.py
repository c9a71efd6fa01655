"""Heterogeneous 3D DRAM-on-logic stack subsystem (PyTorch port).

- :mod:`repro_torch.stack.spec` — declarative :class:`StackSpec` of
  ordered dies/interfaces; ``core/thermal.py`` builds its operators from a
  spec.
- :mod:`repro_torch.stack.dram` — DRAM die floorplan + power model.
- :mod:`repro_torch.stack.feedback` — closed-loop replay coupling
  temperature back into power (Picard-iterated refresh + leakage, DTM
  throttling).

Only ``spec`` is imported eagerly: ``core/thermal.py`` depends on it, so
importing ``feedback`` here would create an import cycle.
"""
from repro_torch.stack.spec import (DRAM, LOGIC, PAPER_SPEC, SPREADER,
                                    Interface, Layer, StackSpec,
                                    dram_on_logic, spec_from_params)

__all__ = [
    "DRAM", "LOGIC", "SPREADER", "PAPER_SPEC", "Interface", "Layer",
    "StackSpec", "dram_on_logic", "spec_from_params",
]
