"""DRAM die floorplan + power model for memory-on-logic stacks (port).

A stacked DRAM die is modeled as a bank array split by a central IO/TSV
spine.  Three power components:

1. **Activate/IO** — driven by the workload's memory-traffic estimate
   (``core/models.mem_traffic_bytes_per_s``): each moved bit costs
   ``E_ACT_PJ_PER_BIT``; a fixed share lands in the IO spine, the rest
   spreads over the banks.  Traffic is striped across the DRAM dies of a
   stack, so per-die activate power is the stack total / n_dies.
2. **Refresh** — temperature-dependent with JEDEC-style bins: the refresh
   interval halves above 85 °C and again above 95 °C, so
   :func:`refresh_multiplier` steps 1× → 2× → 4×.
3. **Static leakage** — DRAM processes leak far less than logic; a reduced
   area density (``GAMMA_DRAM_W_MM2``).

All maps conserve wattage exactly at any grid resolution.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.constants import DRAM_LIMIT_C

# power-model constants
E_ACT_PJ_PER_BIT = 8.0        # activate+IO energy per bit moved, TSV-era
REFRESH_W_PER_GBIT = 0.008    # time-averaged 1x refresh power per Gbit
GAMMA_DRAM_W_MM2 = 1e-2       # DRAM static leakage density [W/mm^2]
REFRESH_BIN2_C = 95.0         # second derating bin (first is DRAM_LIMIT_C)


def refresh_multiplier(T_C: torch.Tensor) -> torch.Tensor:
    """JEDEC-style refresh-rate multiplier vs temperature (elementwise).

    1× below 85 °C, 2× in [85, 95) °C, 4× at and above 95 °C.
    """
    T_C = torch.as_tensor(T_C)
    m = torch.ones_like(T_C)
    m = torch.where(T_C >= DRAM_LIMIT_C, 2.0, m)
    return torch.where(T_C >= REFRESH_BIN2_C, 4.0, m)


def activate_io_W(traffic_bytes_per_s: float, n_dies: int = 1) -> float:
    """Per-die activate/IO wattage for a stack moving ``traffic`` bytes/s."""
    return traffic_bytes_per_s * 8.0 * E_ACT_PJ_PER_BIT * 1e-12 \
        / max(n_dies, 1)


@dataclasses.dataclass(frozen=True)
class DRAMFloorplan:
    """One DRAM die: bank array split by a central IO/TSV spine."""
    die_w_mm: float
    banks_per_edge: int = 4       # 4x4 banks (structure only; refresh and
    #   activate densities are uniform within the bank array)
    io_frac: float = 0.08         # spine height as a fraction of the die
    io_power_share: float = 0.35  # activate/IO share landing in the spine
    capacity_Gbit: float = 8.0

    def leakage_W(self) -> float:
        return GAMMA_DRAM_W_MM2 * self.die_w_mm ** 2

    def base_refresh_W(self) -> float:
        """1× (below-85 °C) time-averaged refresh power of the die."""
        return REFRESH_W_PER_GBIT * self.capacity_Gbit

    def _spine(self, grid_n: int) -> tuple[int, int]:
        h = max(1, int(round(self.io_frac * grid_n)))
        y0 = (grid_n - h) // 2
        return y0, y0 + h

    def bank_mask(self, grid_n: int) -> np.ndarray:
        """[grid_n, grid_n] 1.0 where bank cells live (outside the spine)."""
        mask = np.ones((grid_n, grid_n))
        if grid_n >= 4:
            y0, y1 = self._spine(grid_n)
            mask[y0:y1, :] = 0.0
        return mask

    def activate_map(self, grid_n: int) -> np.ndarray:
        """Normalized (sums to 1) spatial distribution of activate/IO."""
        bank = self.bank_mask(grid_n)
        n_bank = bank.sum()
        if n_bank == 0 or n_bank == bank.size:   # too coarse: uniform
            return np.full((grid_n, grid_n), 1.0 / bank.size)
        spine = 1.0 - bank
        return (self.io_power_share * spine / spine.sum()
                + (1.0 - self.io_power_share) * bank / n_bank)

    def refresh_map(self, grid_n: int) -> np.ndarray:
        """Normalized distribution of refresh power (banks only)."""
        bank = self.bank_mask(grid_n)
        n_bank = bank.sum()
        if n_bank == 0:
            return np.full((grid_n, grid_n), 1.0 / bank.size)
        return bank / n_bank

    def power_map(self, grid_n: int, act_W: float,
                  ref_W: float | None = None,
                  leak_W: float | None = None) -> np.ndarray:
        """[grid_n, grid_n] watts per cell; conserves the requested total."""
        if ref_W is None:
            ref_W = self.base_refresh_W()
        if leak_W is None:
            leak_W = self.leakage_W()
        return (act_W * self.activate_map(grid_n)
                + ref_W * self.refresh_map(grid_n)
                + np.full((grid_n, grid_n), leak_W / grid_n ** 2))
