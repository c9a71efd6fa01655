"""Analytic area / performance / power models — paper §3, equations (2)-(17).

All areas are normalized to one SRAM bit cell (0.1 um^2); all powers to one
SRAM cell write (0.5 uW).  Table 2 / Table 3 constants are module-level
defaults; everything is plain float math so the models can be called from
benchmarks, tests and the thermal floorplanner alike.  This is the PyTorch
port's own copy of the reference ``core/models.py``; its numbers must stay
identical (tests/test_torch_feedback.py compares the design points).

Workload calibration (paper gives anchors, not tables — see DESIGN.md §7.3):

* DMM: the paper pins S_AP(n_AP=2^20) = 350  =>  s_APU(DMM) = 350 / 2^20,
  and S_SIMD(n=768) = 350  =>  I_s(DMM) = 1/350 - 1/768.
* FFT / BS: Fig 4 orders arithmetic intensity BS >> FFT > DMM; synchronization
  intensity is inversely proportional to arithmetic intensity (§3.1).  We use
  the canonical operational intensities of the three kernels at N = 2^20
  (BS ~ O(100) flop/byte, FFT ~ O(log N) ~ 20, DMM blocked ~ O(sqrt(cache)))
  to scale I_s relative to the DMM anchor, and s_APU from bit-serial cycle
  counts (4400-cycle fp32 mul as the unit, paper's lower bound 1/4400).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

# --------------------------------------------------------------------------
# Table 2 — area model parameters (normalized to SRAM cell = 1; 0.1 um^2)
# --------------------------------------------------------------------------
A_SRAM_UM2 = 0.1          # um^2 per normalized area unit
A_PU_BIT = 20.0           # SIMD PU bit-cell area (A_PUo)
A_RF_BIT = 3.0            # register-file flip-flop area (A_RFo)
A_AP_BIT = 2.0            # AP bit-cell area (A_APo)
M_BITS = 32               # data word length m
K_WORDS = 8               # temporary storage words per PU (k)
S_APU_LB = 1.0 / 4400.0   # AP PU speedup lower bound vs SIMD PU (fp32 mul)

# --------------------------------------------------------------------------
# Table 3 — power model parameters (normalized to SRAM write = 1; 0.5 uW)
# --------------------------------------------------------------------------
P_SRAM_UW = 0.5
P_PU_BIT = 40.0           # P_PUo
P_RF_BIT = 5.0            # P_RFo
P_SYNC_BIT = 200.0        # P_So
P_MISWRITE = 0.1          # p_mw
P_MATCH = 0.1             # p_m
P_MISMATCH = 0.75         # p_mm
GAMMA_W_MM2 = 5e-2        # leakage [W / mm^2]

N_DATA = 2 ** 20          # workload data-set size (paper: N = 2^20)
BYTES_PER_WORD = 4        # m = 32-bit data words

# Canonical operational (arithmetic) intensities at N = 2^20 [flop/word] —
# the Fig 4 ordering anchor for the paper trio, extended to the suite
# workloads (DESIGN.md §3.2 for the derivations).  Used both to scale
# synchronization intensity (inversely, §3.1) and as the
# compute-to-traffic ratio for the DRAM activate-power estimate
# (:func:`mem_traffic_bytes_per_s`).
ARITH_INTENSITY = {
    "dmm": 45.0, "fft": 10.0, "bs": 150.0,
    # suite additions: streaming / search kernels are traffic-dominated
    "sort": 2.0,     # compare-exchange streams, ~2 ops per word touched
    "spmv": 4.0,     # 2 flops per nonzero over index + value traffic
    "knn": 3.0,      # d |x-q| accumulations over d streamed words
    "hist": 1.5,     # one bin op per streamed word
}

# AP per-PU speedups for the suite workloads, from bit-serial cycle
# counts pinned by tests/test_new_workloads.py (DESIGN.md §3.2):
# sort: a min-extraction retires one distinct value in ~3m cycles vs one
#   SIMD compare/cycle; spmv: mul-bound like DMM with a 2x tag-masked
#   reduction overhead (filled in by _calibrate); knn: d-feature LUT
#   distance ~d*2^m cycles vs 2d SIMD MACs; hist: one response-counted
#   COMPARE per bin vs ~1 op/word, blended over paper-scale bin counts.
_S_APU_SUITE = {"sort": 1.0 / 96.0, "knn": 1.0 / 128.0, "hist": 1.0 / 100.0}


def _norm_area_to_mm2(a_norm: float) -> float:
    return a_norm * A_SRAM_UM2 * 1e-6


def _mm2_to_norm_area(a_mm2: float) -> float:
    return a_mm2 / (A_SRAM_UM2 * 1e-6)


# --------------------------------------------------------------------------
# workloads
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Workload:
    """A paper workload with its calibrated model constants."""
    name: str
    i_s: float      # synchronization intensity  (T_S / T_1), SIMD-side
    s_apu: float    # AP PU speedup relative to a SIMD PU

    def __post_init__(self):
        if self.i_s < 0 or self.s_apu <= 0:
            raise ValueError("bad workload constants")


def _calibrate() -> dict[str, Workload]:
    # --- DMM anchors (paper Fig. 6 black dots) ------------------------------
    s_star, n_simd_star, n_ap_star = 350.0, 768.0, float(N_DATA)
    i_s_dmm = 1.0 / s_star - 1.0 / n_simd_star           # from eq (3)
    s_apu_dmm = s_star / n_ap_star                       # from eq (8)

    # --- relative arithmetic intensities at N = 2^20 (Fig 4 ordering) ------
    # I_s is inversely proportional to arithmetic intensity (§3.1).
    # DMM blocked in an L1-sized tile: AI ~ 45 flop/word-ish (reference);
    # FFT: AI ~ log2(N)/2 = 10; BS: AI ~ 150 (compute-dominated, ~no sync).
    ai_dmm, ai_fft, ai_bs = (ARITH_INTENSITY[w] for w in ("dmm", "fft", "bs"))
    i_s_fft = i_s_dmm * ai_dmm / ai_fft
    i_s_bs = i_s_dmm * ai_dmm / ai_bs

    # --- AP per-PU speedups from bit-serial cycle counts --------------------
    # fp32 mul = 4400 cycles (paper's unit).  DMM is mul+add per MAC on both
    # machines; the paper's DMM anchor implies the blended value below. FFT
    # butterflies are mul/add balanced but pay serial inter-PU communication
    # (~2x); BS is division/exp/log-heavy: LUT-based AP flow runs closer to
    # the fp-mul bound.
    s_apu_fft = s_apu_dmm / 2.0
    s_apu_bs = S_APU_LB * 1.5

    out = {
        "dmm": Workload("dmm", i_s_dmm, s_apu_dmm),
        "fft": Workload("fft", i_s_fft, s_apu_fft),
        "bs": Workload("bs", i_s_bs, s_apu_bs),
    }
    # --- suite workloads: same inverse-AI scaling off the DMM anchor ------
    for name, s_apu in {**_S_APU_SUITE, "spmv": s_apu_dmm / 2.0}.items():
        i_s = i_s_dmm * ai_dmm / ARITH_INTENSITY[name]
        out[name] = Workload(name, i_s, s_apu)
    return out


WORKLOADS = _calibrate()


def derived_workload(name: str, arith_intensity: float,
                     s_apu: float | None = None) -> Workload:
    """Anchor a NEW workload off the DMM calibration (§3.1 scaling).

    Synchronization intensity is inversely proportional to arithmetic
    intensity, so any workload with a known AI (flop/word) inherits
    ``i_s = i_s_dmm * AI_dmm / AI`` — the same rule ``_calibrate`` uses
    for the suite workloads, exposed here so callers (e.g. the serving
    cost model, which derives an AI per LLM config) can mint comparable
    Workload instances without registering them in ``WORKLOADS``.
    ``s_apu`` defaults to the DMM (MAC-dominated) per-PU speedup.
    """
    if arith_intensity <= 0:
        raise ValueError("arith_intensity must be > 0")
    base = WORKLOADS["dmm"]
    i_s = base.i_s * ARITH_INTENSITY["dmm"] / arith_intensity
    return Workload(name, i_s, base.s_apu if s_apu is None else s_apu)


# --------------------------------------------------------------------------
# SIMD processor model — eqs (2)-(6), (11)-(14)
# --------------------------------------------------------------------------

CACHE_OVERHEAD = 1.1  # tag arrays + decoders/periphery on top of N*m data cells
                      # (calibrated so A_SIMD(768 PUs) = 5.3 mm^2, the paper's
                      # own figure; data cells alone give 4.99 mm^2)


def simd_cache_area(n_data: int = N_DATA, m: int = M_BITS) -> float:
    """A_C: L1+L2 of total size >= N data words (normalized units)."""
    return float(n_data) * m * CACHE_OVERHEAD


def simd_pu_area(m: int = M_BITS, k: int = K_WORDS) -> float:
    return A_PU_BIT * m * m + A_RF_BIT * k * m


def simd_n_pus(area_norm: float, n_data: int = N_DATA) -> float:
    """eq (6): number of PUs for a total (normalized) area budget."""
    usable = area_norm - simd_cache_area(n_data)
    return max(usable, 0.0) / simd_pu_area()


def simd_area(n_pus: float, n_data: int = N_DATA) -> float:
    """eq (4), normalized units."""
    return n_pus * simd_pu_area() + simd_cache_area(n_data)


def simd_speedup(n_pus: float, wl: Workload) -> float:
    """eq (3)."""
    if n_pus <= 0:
        return 0.0
    return 1.0 / (1.0 / n_pus + wl.i_s)


def simd_power_norm(n_pus: float, wl: Workload, m: int = M_BITS,
                    k: int = K_WORDS) -> float:
    """eq (14) in normalized power units (excluding absolute leakage)."""
    if n_pus <= 0:
        return 0.0
    p_exec_per_pu = P_PU_BIT * m * m + P_RF_BIT * k * m
    # eq (14) numerator: per-PU exec power + I_s * P_So * m (all normalized)
    num = p_exec_per_pu + wl.i_s * P_SYNC_BIT * m
    den = 1.0 / n_pus + wl.i_s
    return num / den


def simd_power_W(n_pus: float, wl: Workload, n_data: int = N_DATA) -> float:
    """Total SIMD power in watts: eq (14) dynamic + gamma * area leakage."""
    dyn = simd_power_norm(n_pus, wl) * P_SRAM_UW * 1e-6
    leak = GAMMA_W_MM2 * _norm_area_to_mm2(simd_area(n_pus, n_data))
    return dyn + leak


def simd_phase_powers(wl: Workload, n_pus: float, m: int = M_BITS,
                      k: int = K_WORDS) -> tuple[float, float, float]:
    """Eq (14) split into its two phases: (p_exec_W, p_sync_W, f_run).

    p_exec_W / p_sync_W are time-AVERAGED watts of the execute and
    synchronize components; f_run = (1/n) / (1/n + I_s) is the fraction of
    time spent executing.  Shared by the SIMD floorplan's spatial split and
    the co-sim phase trace so both always use the same decomposition.
    """
    f_run = (1.0 / n_pus) / (1.0 / n_pus + wl.i_s)
    p_exec_W = n_pus * (P_PU_BIT * m * m + P_RF_BIT * k * m) \
        * f_run * P_SRAM_UW * 1e-6
    p_sync_W = (wl.i_s * P_SYNC_BIT * m / (1.0 / n_pus + wl.i_s)) \
        * P_SRAM_UW * 1e-6
    return p_exec_W, p_sync_W, f_run


# --------------------------------------------------------------------------
# AP model — eqs (7)-(10), (15)-(17)
# --------------------------------------------------------------------------

def ap_pu_area(m: int = M_BITS, k: int = K_WORDS) -> float:
    return A_AP_BIT * k * m


def ap_n_pus(area_norm: float) -> float:
    """eq (10)."""
    return area_norm / ap_pu_area()


def ap_area(n_pus: float) -> float:
    """eq (9), normalized units."""
    return n_pus * ap_pu_area()


def ap_speedup(n_pus: float, wl: Workload) -> float:
    """eq (8)."""
    return wl.s_apu * n_pus


def ap_dynamic_power_per_pu_norm() -> float:
    """eq (17) dynamic bracket: 1/8 + 7/8 p_mw + 3/16 p_m + 21/16 p_mm.

    Derivation (eq 16): a pass writes 2 bits (P(write) = 1/8 per row) and
    compares 3 bits (P(match) = 1/8); averaged over the compare and write
    halves of the cycle.
    """
    return (2.0 * (1.0 / 8.0 + 7.0 / 8.0 * P_MISWRITE)
            + 3.0 * (1.0 / 8.0 * P_MATCH + 7.0 / 8.0 * P_MISMATCH)) / 2.0


def ap_power_W(n_pus: float) -> float:
    """eq (17): dynamic + leakage, watts."""
    dyn = n_pus * ap_dynamic_power_per_pu_norm() * P_SRAM_UW * 1e-6
    leak = GAMMA_W_MM2 * _norm_area_to_mm2(ap_area(n_pus))
    return dyn + leak


# --------------------------------------------------------------------------
# derived comparisons (Fig 6 / Fig 7 and §4 inputs)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """A same-performance AP/SIMD pair, the input to the thermal analysis."""
    workload: str
    speedup: float
    ap_n_pus: int
    ap_area_mm2: float
    ap_power_W: float
    simd_n_pus: int
    simd_area_mm2: float
    simd_power_W: float

    @property
    def power_ratio(self) -> float:
        return self.simd_power_W / self.ap_power_W

    @property
    def power_density_ratio(self) -> float:
        return (self.simd_power_W / self.simd_area_mm2) / \
               (self.ap_power_W / self.ap_area_mm2)


def design_point(wl: Workload, n_ap: int = N_DATA) -> DesignPoint:
    """Same-performance AP/SIMD pair for an arbitrary Workload instance.

    The §3/§4 construction: AP sized to ``n_ap`` PUs, SIMD sized to
    yield the same speedup (inverting eq 3).  Raises ValueError when the
    AP speedup exceeds the SIMD synchronization ceiling 1/I_s, i.e. when
    no same-performance SIMD exists."""
    s = ap_speedup(n_ap, wl)
    if s * wl.i_s >= 1.0:
        raise ValueError(f"SIMD cannot reach speedup {s} for {wl.name} "
                         f"(I_s bound {1/wl.i_s:.1f})")
    n_simd = 1.0 / (1.0 / s - wl.i_s)  # invert eq (3)
    return DesignPoint(
        workload=wl.name,
        speedup=s,
        ap_n_pus=n_ap,
        ap_area_mm2=_norm_area_to_mm2(ap_area(n_ap)),
        ap_power_W=ap_power_W(n_ap),
        simd_n_pus=int(round(n_simd)),
        simd_area_mm2=_norm_area_to_mm2(simd_area(n_simd)),
        simd_power_W=simd_power_W(n_simd, wl),
    )


def paper_design_point(workload: str = "dmm",
                       n_ap: int = N_DATA) -> DesignPoint:
    """The §3/§4 comparison point: AP sized to the data set (n_AP = N = 2^20),

    SIMD sized to yield the same speedup."""
    return design_point(WORKLOADS[workload], n_ap)


def break_even_area_mm2(workload: str) -> float:
    """Area at which AP speedup overtakes SIMD speedup (Fig 6 crossing)."""
    wl = WORKLOADS[workload]
    lo, hi = 1e4, 1e12  # normalized area search window
    f = lambda a: ap_speedup(ap_n_pus(a), wl) - simd_speedup(simd_n_pus(a), wl)
    if f(hi) < 0:
        return math.inf
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        if f(mid) < 0:
            lo = mid
        else:
            hi = mid
    return _norm_area_to_mm2(hi)


def speedup_vs_area_curves(workload: str, areas_mm2: np.ndarray):
    """Fig 6: (area, S_SIMD, S_AP) arrays for one workload."""
    wl = WORKLOADS[workload]
    a_norm = np.array([_mm2_to_norm_area(a) for a in areas_mm2])
    s_simd = np.array([simd_speedup(simd_n_pus(a), wl) for a in a_norm])
    s_ap = np.array([ap_speedup(ap_n_pus(a), wl) for a in a_norm])
    return s_simd, s_ap


def power_vs_area_curves(workload: str, areas_mm2: np.ndarray):
    """Fig 7: (P_SIMD, P_AP) in watts for one workload."""
    wl = WORKLOADS[workload]
    a_norm = np.array([_mm2_to_norm_area(a) for a in areas_mm2])
    p_simd = np.array([simd_power_W(simd_n_pus(a), wl) for a in a_norm])
    p_ap = np.array([ap_power_W(ap_n_pus(a)) for a in a_norm])
    return p_simd, p_ap


# --------------------------------------------------------------------------
# AP-backend estimate for the assigned LM architectures (DESIGN.md §4):
# maps a cell's FLOP count onto AP bit-serial cycle costs so the roofline
# report can contrast the paper's architecture with an accelerator.
# --------------------------------------------------------------------------

AP_CYCLES_PER_FP32_MUL = 4400.0   # paper §2.2
AP_CYCLES_PER_FP32_ADD = 1100.0   # ~8m + alignment overheads, model constant
AP_CLOCK_HZ = 1e9                 # 1 GHz-class CAM cycle (paper-era assumption)


def ap_flops_per_s(n_pus: int = N_DATA) -> float:
    """Sustained MAC-rate of one AP in flop/s (every PU in parallel).

    A MAC = one fp32 mul + one fp32 add = 5500 bit-serial cycles; all
    ``n_pus`` rows advance together, so flop/s = 2 * n_pus * f / 5500.
    """
    macs_per_s = n_pus * AP_CLOCK_HZ \
        / (AP_CYCLES_PER_FP32_MUL + AP_CYCLES_PER_FP32_ADD)
    return 2.0 * macs_per_s


def mem_traffic_bytes_per_s(workload: str, n_pus: int = N_DATA) -> float:
    """Off-chip (DRAM) traffic estimate for a design point [bytes/s].

    traffic = compute rate / arithmetic intensity: each AI flops of work
    stream one m-bit word to or from memory (DESIGN.md §7.4).  Evaluated
    at the AP's compute rate — the same-performance SIMD pair sustains the
    same flop/s by construction, so ONE traffic figure drives the DRAM
    activate power of both machines' stacks and the thermal comparison
    stays apples-to-apples.
    """
    if workload not in ARITH_INTENSITY:
        raise ValueError(f"unknown workload {workload!r}; expected one of "
                         f"{sorted(ARITH_INTENSITY)}")
    return traffic_bytes_per_s(ARITH_INTENSITY[workload], n_pus)


def traffic_bytes_per_s(arith_intensity: float,
                        n_pus: int = N_DATA) -> float:
    """`mem_traffic_bytes_per_s` for an AI not in ``ARITH_INTENSITY`` —
    e.g. the per-batch decode AI the serving cost model derives."""
    if arith_intensity <= 0:
        raise ValueError("arith_intensity must be > 0")
    return ap_flops_per_s(n_pus) / arith_intensity * BYTES_PER_WORD


def ap_backend_estimate(total_flops: float, n_pus: int = N_DATA) -> dict:
    """Time/energy for running `total_flops` MAC-dominated work on one AP.

    A MAC = one fp32 mul + one fp32 add = 5500 cycles on every PU in
    parallel.  Returns seconds and joules under the eq-(17) power model.
    """
    macs = total_flops / 2.0
    cycles = (macs / n_pus) * (AP_CYCLES_PER_FP32_MUL + AP_CYCLES_PER_FP32_ADD)
    seconds = cycles / AP_CLOCK_HZ
    watts = ap_power_W(n_pus)
    return {"cycles": cycles, "seconds": seconds, "watts": watts,
            "joules": watts * seconds, "n_pus": n_pus}
