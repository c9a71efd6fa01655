"""Floorplans and power maps for the thermal analysis (paper Figs 8 & 11).

AP (Fig 8):  7.33 x 7.33 mm die, 8x8 banks, each 8x8 blocks; each block is a
256x256 associative array with KEY/MASK registers on top and TAG on the right.
Power is distributed by region with relative densities derived from the
paper's constants (Table 3 + '2% of flip-flops switching' §4.1):

  array   : eq-17 dynamic bracket / (2 area units per cell)
  KEY/MASK: 2% activity x P_RFo per bit / (3 area units per FF)
  TAG     : same flip-flop treatment as KEY/MASK

Region powers are exact (weights x true areas, normalized to the layer
power); strip cells are grid-quantized so sub-cell strips smear over one grid
row — total power is conserved.

SIMD (Fig 11): 2.3 x 2.3 mm die; 12 processor tiles (64 PUs + RF + L1) in two
side columns of six, shared L2 as the central band.  Execution power lands
in the PU arrays, synchronization power in the caches, leakage everywhere in
proportion to area (eq 14's decomposition).

Port note: this is the PyTorch port's own copy of the reference module,
whole.  ``ap_block_zoom`` and ``thermal_comparison`` (the paper's §4
experiment) run the port's steady-state solver and take the
keyword-only ``device`` (default ``"cuda"``); ``thermal_comparison``
accepts the reference's ``use_pallas`` and ignores it.  Their results
are host NumPy, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import models as M

MM = 1e-3


# ---------------------------------------------------------------------------
# AP floorplan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class APFloorplan:
    die_w_mm: float = 7.33
    banks: int = 8          # banks per edge (8x8 = 64)
    blocks: int = 8         # blocks per bank edge (8x8 = 64)
    words_per_block: int = 256
    bits_per_word: int = 256
    reg_activity: float = 0.02  # §4.1: 2% of flip-flops switch per cycle

    @property
    def blocks_per_edge(self) -> int:
        return self.banks * self.blocks  # 64

    def leakage_W(self) -> float:
        """Static leakage of one layer (same gamma model as power_map)."""
        return M.GAMMA_W_MM2 * self.die_w_mm ** 2

    def region_weights(self) -> dict:
        """Relative power densities (per normalized area unit)."""
        # per bit-cell area unit: eq-17 bracket is per PU (256-bit row) per cycle
        arr_density = M.ap_dynamic_power_per_pu_norm() * self.words_per_block \
            / (self.words_per_block * self.bits_per_word * M.A_AP_BIT)
        ff_density = self.reg_activity * M.P_RF_BIT / M.A_RF_BIT
        return {"array": arr_density, "regs": ff_density, "tag": ff_density}

    def region_areas(self) -> dict:
        """True areas per block in normalized units."""
        n_cells = self.words_per_block * self.bits_per_word
        a_array = n_cells * M.A_AP_BIT
        a_regs = 2 * self.bits_per_word * M.A_RF_BIT   # KEY + MASK rows
        a_tag = self.words_per_block * M.A_RF_BIT      # TAG column
        return {"array": a_array, "regs": a_regs, "tag": a_tag}

    def power_map(self, grid_n: int, p_layer_W: float) -> np.ndarray:
        """[grid_n, grid_n] watts per cell; leakage uniform, dynamic by region."""
        w = self.region_weights()
        a = self.region_areas()
        nb = self.blocks_per_edge ** 2
        dyn_total = sum(w[r] * a[r] for r in w) * nb
        leak_W = self.leakage_W()
        dyn_W = p_layer_W - leak_W
        region_W = {r: dyn_W * (w[r] * a[r] * nb / dyn_total) for r in w}

        bpe = self.blocks_per_edge
        cells_per_block = grid_n / bpe
        if cells_per_block < 3:
            # too coarse to resolve register strips: uniform dynamic + leakage
            return np.full((grid_n, grid_n), p_layer_W / grid_n ** 2)

        # rasterize block sub-regions
        cpb = int(round(cells_per_block))
        if cpb * bpe != grid_n:
            raise ValueError(f"grid_n must be a multiple of {bpe}")
        reg_rows = max(1, int(round(0.01 * cpb)))   # KEY/MASK strip (top)
        tag_cols = max(1, int(round(0.01 * cpb)))   # TAG strip (right)
        block = np.zeros((cpb, cpb))
        arr_cells = cpb * cpb - reg_rows * cpb - tag_cols * (cpb - reg_rows)
        block[reg_rows:, :cpb - tag_cols] = (region_W["array"] / nb) / arr_cells
        block[:reg_rows, :] = (region_W["regs"] / nb) / (reg_rows * cpb)
        block[reg_rows:, cpb - tag_cols:] = (region_W["tag"] / nb) \
            / (tag_cols * (cpb - reg_rows))
        pmap = np.tile(block, (bpe, bpe))
        pmap += leak_W / grid_n ** 2
        return pmap


# ---------------------------------------------------------------------------
# SIMD floorplan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SIMDFloorplan:
    die_w_mm: float = 2.3
    n_cores: int = 12
    l1_frac_of_cache: float = 0.125   # L1s sit inside core tiles; L2 central

    def leakage_W(self, dp: "M.DesignPoint") -> float:
        """Static leakage of one layer (same gamma model as power_map)."""
        return M.GAMMA_W_MM2 * dp.simd_area_mm2

    def power_map(self, grid_n: int, dp: "M.DesignPoint",
                  wl: "M.Workload | None" = None) -> np.ndarray:
        # unregistered workloads must pass their Workload instance explicitly
        wl = M.WORKLOADS[dp.workload] if wl is None else wl
        n = dp.simd_n_pus
        # eq (14) decomposition (normalized -> watts)
        p_exec_W, p_sync_W, _ = M.simd_phase_powers(wl, n)
        p_leak_W = self.leakage_W(dp)

        # geometry (fractions of die area)
        a_pu_mm2 = n * M.simd_pu_area() * M.A_SRAM_UM2 * 1e-6
        a_cache_mm2 = M.simd_cache_area() * M.A_SRAM_UM2 * 1e-6
        die_mm2 = self.die_w_mm ** 2
        a_l1 = self.l1_frac_of_cache * a_cache_mm2
        core_col_frac = (a_pu_mm2 + a_l1) / die_mm2 / 2.0   # two side columns

        pmap = np.zeros((grid_n, grid_n))
        col_w = max(1, int(round(core_col_frac * grid_n)))
        core_h = grid_n // (self.n_cores // 2)
        pu_frac_in_tile = a_pu_mm2 / (a_pu_mm2 + a_l1)
        pu_w = max(1, int(round(col_w * pu_frac_in_tile)))

        dens = np.zeros((grid_n, grid_n))  # relative dynamic density map
        pu_cells = 0
        l1_cells = 0
        for side in (0, 1):
            x0 = 0 if side == 0 else grid_n - col_w
            for c in range(self.n_cores // 2):
                y0, y1 = c * core_h, (c + 1) * core_h
                if side == 0:
                    pu_x = (x0, x0 + pu_w)
                    l1_x = (x0 + pu_w, x0 + col_w)
                else:
                    pu_x = (x0 + col_w - pu_w, x0 + col_w)
                    l1_x = (x0, x0 + col_w - pu_w)
                dens[y0:y1, pu_x[0]:pu_x[1]] = 1.0
                pu_cells += (y1 - y0) * (pu_x[1] - pu_x[0])
                dens[y0:y1, l1_x[0]:l1_x[1]] = 2.0
                l1_cells += (y1 - y0) * (l1_x[1] - l1_x[0])
        l2_cells = grid_n * grid_n - pu_cells - l1_cells

        if pu_cells == 0 or l2_cells == 0:
            # grid too coarse to rasterize the tile columns AND a central
            # band: uniform map keeps total wattage conserved
            total_W = p_exec_W + p_sync_W + p_leak_W
            return np.full((grid_n, grid_n), total_W / grid_n ** 2)
        pmap[dens == 1.0] = p_exec_W / pu_cells
        # sync traffic: half in L1s, half in L2 — when the grid is too
        # coarse to rasterize any L1 cells, their share falls through to
        # L2 so total wattage is conserved at every resolution
        sync_l1_W = 0.5 * p_sync_W if l1_cells else 0.0
        pmap[dens == 2.0] = sync_l1_W / max(l1_cells, 1)
        pmap[dens == 0.0] = (p_sync_W - sync_l1_W) / l2_cells
        pmap += p_leak_W / grid_n ** 2
        return pmap


# ---------------------------------------------------------------------------
# AP block zoom (paper Fig 10(c)): one block at fine resolution
# ---------------------------------------------------------------------------

def ap_block_zoom(fp: APFloorplan, p_layer_W: float, grid_n: int = 64,
                  stack=None, *, device="cuda") -> dict:
    """Thermal map of one AP block near the die center (Fig 10(c)).

    Symmetry argument: a block surrounded by identical blocks sees
    adiabatic lateral boundaries, so solving ONE block footprint with the
    full stack reproduces the infinite-array interior exactly.  The
    KEY/MASK register strip (top) and TAG strip (right) get their share
    of the block power at their true (small) areas.
    """
    from repro_torch.core import thermal

    spec = _as_spec(stack)
    w = fp.region_weights()
    a = fp.region_areas()
    nb = fp.blocks_per_edge ** 2
    block_w_mm = fp.die_w_mm / fp.blocks_per_edge
    dyn_total = sum(w[r] * a[r] for r in w) * nb
    leak_W = fp.leakage_W()
    dyn_W = p_layer_W - leak_W
    region_W = {r: dyn_W * (w[r] * a[r] / dyn_total) for r in w}   # per block
    leak_block = leak_W / nb

    # geometry: register strip height / tag strip width as true area shares
    a_block = sum(a.values())
    reg_frac = a["regs"] / a_block
    tag_frac = a["tag"] / a_block
    reg_rows = max(1, int(round(reg_frac * grid_n)))
    tag_cols = max(1, int(round(tag_frac * grid_n)))

    pmap = np.zeros((grid_n, grid_n))
    arr_cells = grid_n * grid_n - reg_rows * grid_n \
        - tag_cols * (grid_n - reg_rows)
    pmap[reg_rows:, : grid_n - tag_cols] = region_W["array"] / arr_cells
    pmap[:reg_rows, :] = region_W["regs"] / (reg_rows * grid_n)
    pmap[reg_rows:, grid_n - tag_cols:] = region_W["tag"] \
        / (tag_cols * (grid_n - reg_rows))
    pmap += leak_block / grid_n ** 2

    grid = thermal.Grid(die_w=block_w_mm * MM, ny=grid_n, nx=grid_n,
                        spec=spec,
                        pkg_area=(fp.die_w_mm * MM) ** 2)
    L = grid.n_die_layers
    power = _logic_power(pmap, spec)
    T = thermal.steady_state(power, grid, device=device).cpu().numpy()
    return {"T": T, "power_map": pmap,
            "peak_C": [float(T[l].max()) for l in range(L)],
            "min_C": [float(T[l].min()) for l in range(L)],
            "span_C": [float(T[l].max() - T[l].min()) for l in range(L)]}


# ---------------------------------------------------------------------------
# paper §4 comparison driver
# ---------------------------------------------------------------------------

def _as_spec(stack):
    """Accept a StackSpec, a legacy StackParams, or None (paper default)."""
    from repro_torch.stack.spec import PAPER_STACK, StackSpec, \
        spec_from_params

    if stack is None:
        stack = PAPER_STACK
    return stack if isinstance(stack, StackSpec) else spec_from_params(stack)


def _logic_power(pmap: np.ndarray, spec) -> np.ndarray:
    """[n_die, ny, nx] power with ``pmap`` on every LOGIC layer (the §4
    convention) and zeros on DRAM layers."""
    power = np.zeros((spec.n_die_layers, *pmap.shape), pmap.dtype)
    for l in spec.logic_layers:
        power[l] = pmap
    return power


def t_cut(T: np.ndarray) -> np.ndarray:
    """Horizontal center-line profile of one layer (paper Fig 13 'T-Cut')."""
    return np.asarray(T)[T.shape[0] // 2, :]


def thermal_comparison(grid_ap: int = 64, grid_simd: int = 64,
                       workload: str = "dmm", use_pallas: bool = False,
                       stack=None, *, device="cuda") -> dict:
    """Run the full §4 experiment: same-performance AP vs SIMD, 4-layer
    stacks by default; pass a heterogeneous ``StackSpec`` (e.g.
    ``repro_torch.stack.spec.dram_on_logic``) to put unpowered DRAM dies
    on top.  Each steady solve is Jacobi-PCG on ``device``."""
    from repro_torch.core import thermal

    spec = _as_spec(stack)
    dp = M.paper_design_point(workload)
    ap_fp = APFloorplan(die_w_mm=math.sqrt(dp.ap_area_mm2))
    simd_fp = SIMDFloorplan(die_w_mm=math.sqrt(dp.simd_area_mm2))

    results = {}
    for name, fp, p_layer in (
            ("ap", ap_fp, dp.ap_power_W),
            ("simd", simd_fp, dp.simd_power_W)):
        if name == "ap":
            pmap = fp.power_map(grid_ap, p_layer)
        else:
            pmap = fp.power_map(grid_simd, dp)
        L = spec.n_die_layers
        power = _logic_power(pmap, spec)
        grid = thermal.Grid(die_w=fp.die_w_mm * MM, ny=pmap.shape[0],
                            nx=pmap.shape[1], spec=spec,
                            margin=pmap.shape[0] // 4)
        T = thermal.steady_state(power, grid, device=device).cpu().numpy()
        results[name] = {
            "T": T,
            "power_map": pmap,
            "p_layer_W": float(pmap.sum()),
            "peak_C": [float(T[l].max()) for l in range(L)],
            "min_C": [float(T[l].min()) for l in range(L)],
            "span_C": [float(T[l].max() - T[l].min()) for l in range(L)],
            "t_cut": [t_cut(T[l]) for l in range(L)],
        }
    results["design_point"] = dp
    return results
