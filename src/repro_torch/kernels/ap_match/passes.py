"""The AP pass-schedule kernel's device time against its number of passes.

    PYTHONPATH=src python -m repro_torch.kernels.ap_match.passes

Builds ``csrc/ap_match.cu`` and times ``run_schedule`` (the path it picks
by shape) under ``torch.profiler`` at 32 and 402 bit columns over 32 lanes
(one warp) and at 32 columns over 32768 lanes, each with random Kc = 4,
Kw = 2 schedules of 16 to 4096 passes.  For each shape it prints the
device time a launch at each P, and the time a pass and the fixed time a
launch from a least-squares line through them; with the SM clock from
``ap_match.latency_probe`` the time a pass is also given in cycles,
beside the latency bound's cycles a pass.  It needs a CUDA card.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np

SHAPES = ((32, 32), (402, 32), (32, 32768))
PASSES = (16, 256, 1024, 4096)


def device_us(fn, n: int = 10) -> float:
    """Mean device time [us] of the AP kernel over ``n`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    hits = [a for a in prof.key_averages() if "run_schedule" in a.key]
    total = sum(getattr(a, "self_device_time_total", 0.0) for a in hits)
    return total / sum(a.count for a in hits)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("passes: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core.engine import schedule_col_range, schedule_tensors
    from repro_torch.kernels.ap_match import ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    probe = ops.latency_probe("cuda")
    bound = probe["rmw_cycles"] + 3 * probe["alu_cycles"]     # Kc = 4
    print(f"SM clock {probe['sm_ghz']:.3f} GHz; latency bound "
          f"{bound:.1f} cycles a pass at Kc = 4")
    rng = np.random.default_rng(0)
    for n_bits, n_lanes in SHAPES:
        times = []
        for P in PASSES:
            tables = [np.ascontiguousarray(t, np.int32) for t in (
                rng.integers(0, n_bits, (P, 4)), rng.integers(0, 2, (P, 4)),
                rng.integers(0, n_bits, (P, 2)), rng.integers(0, 2, (P, 2)))]
            tabs = schedule_tensors(*tables, "cuda")
            cr = schedule_col_range(tables[0], tables[2])
            planes = torch.from_numpy(rng.integers(
                -2 ** 31, 2 ** 31, (n_bits, n_lanes), dtype=np.int64)
                .astype(np.int32)).cuda()
            times.append(device_us(
                lambda: ops.run_schedule(planes, *tabs, col_range=cr)))
        slope, fixed = np.polyfit(PASSES, times, 1)
        cycles = slope * 1e3 * probe["sm_ghz"]
        print(f"{n_bits}x{n_lanes}: " + ", ".join(
            f"P={P} {t:.2f} us" for P, t in zip(PASSES, times))
            + f"; {slope * 1e3:.1f} ns ({cycles:.0f} cycles) a pass, "
            f"{fixed:.2f} us a launch; {cycles / bound:.1f}x the bound's "
            f"cycles a pass")
    return 0


if __name__ == "__main__":
    sys.exit(main())
