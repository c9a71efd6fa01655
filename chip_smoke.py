"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit.  It builds the port's hand-written kernels from ``src/`` and runs
these phases, each printing one line with its result and seconds:

1. the card's name and power limit (``nvidia-smi``), then the kernel build;
2. the thermal-stencil kernel against its plain PyTorch version on the
   card, at the main path's shape (6 cases x 7 layers x 36 x 36) and at the
   256^2 solver grid with margin (7 x 384 x 384): bit for bit, timed with
   CUDA events beside the least time the card could take;
3. the AP pass-schedule kernel against its plain version, bit for bit, at
   the dmm trace shape (402 bit columns x 32 lanes) and at the paper's full
   AP of 2^20 words (32768 lanes), both with a real multiply schedule;
4. the AP trace capture of dmm (1024 elements) and of fft and bs (256) on
   the card and on the host CPU: counters and trace events identical;
5. the main path, ``run_stack_cosim(("dmm", "fft", "bs"), n_dram=2,
   grid_n=24, n_intervals=48)``: every report finite and converged, the
   verdict AP OK / SIMD BLOCKED, and each case's maximum DRAM peak within
   0.1 °C of the JAX reference's value; both kernels' launch counters must
   have risen during this run;
6. a profile (``torch.profiler``): each kernel's device time per launch
   at the main path's shapes, and the device-busy share and top kernels of
   a 4-interval window of the main path's replay.

The line before the last is a JSON object of per-kernel measurements; the
last line is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before those lines.  Without a CUDA card, or outside a checkout of the
repository, it exits non-zero and prints no result.  The full results also
go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: Maximum DRAM peak [°C] of each case of the main path, from the JAX
#: reference package (``repro.stack.feedback.run_stack_cosim`` with the
#: same arguments) run on the CPU.  The port must land within PEAK_TOL_C.
REFERENCE_DRAM_PEAK_C = {
    ("dmm", "ap"): 53.8416, ("dmm", "simd"): 119.2807,
    ("fft", "ap"): 57.6326, ("fft", "simd"): 116.9198,
    ("bs", "ap"): 52.6612, ("bs", "simd"): 108.9859,
}
PEAK_TOL_C = 0.1

#: H100 SXM peaks at the full 700 W limit (NVIDIA data sheet): HBM3 rate,
#: and the non-tensor 32-bit rate, used for both float32 and the 32-bit
#: integer operations of the AP kernel (an upper bound on the int32 rate,
#: so the time bound stays a lower bound).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

LINES: list[str] = []


def say(msg: str) -> None:
    print(msg, flush=True)
    LINES.append(msg)


def phase(name: str):
    """Decorator: run a phase, print its result line and seconds."""
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            say(f"[{name}] ok in {time.perf_counter() - t0:.2f} s")
            return out
        return run
    return wrap


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, timed with
    CUDA events after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

@phase("1 build")
def build_kernels():
    from repro_torch.kernels import _build
    reports = _build.build_all()
    for stem, text in sorted(reports.items()):
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        say(f"  built {stem}: {'; '.join(regs) or 'no ptxas report'}")
    for src in _build.sources():
        check(_build.target(src).exists(), f"no library for {src.name}")


def _stencil_case(shape, seed):
    import numpy as np
    import torch
    from repro_torch.kernels.thermal_stencil import ops
    rng = np.random.default_rng(seed)
    T = torch.from_numpy(rng.normal(50.0, 20.0, shape).astype(np.float32))
    F = {k: torch.from_numpy(rng.uniform(0.0, 1e-2, shape)
                             .astype(np.float32)) for k in ops.FIELD_KEYS}
    # void faces, as the margin ring of a real grid has
    for k in ("gx_lf", "gy_up"):
        F[k][..., :2, :] = 0.0
    return T.cuda(), {k: v.cuda() for k, v in F.items()}


@phase("2 stencil kernel vs plain")
def check_stencil(results):
    import torch
    from repro_torch.kernels.thermal_stencil import ops
    for label, shape, reps in (("main", (6, 7, 36, 36), 2000),
                               ("large", (7, 384, 384), 200)):
        T, F = _stencil_case(shape, seed=sum(shape))
        y = ops.apply_operator_fields(T, F)
        y_plain = ops.apply_operator_fields_plain(T, F)
        torch.cuda.synchronize()
        err = float((y - y_plain).abs().max())
        check(torch.isfinite(y).all().item(), "stencil output not finite")
        check(err == 0.0, f"stencil kernel differs from plain at {shape}: "
              f"max |diff| = {err}")
        cells = T.numel()
        b_ms, b_by = bound_ms(36.0 * cells, 19.0 * cells)
        ms = cuda_ms(lambda: ops.apply_operator_fields(T, F), reps)
        plain = cuda_ms(lambda: ops.apply_operator_fields_plain(T, F),
                        max(reps // 10, 10))
        results[f"stencil_{label}"] = dict(
            shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        say(f"  stencil {shape}: exact; kernel {ms * 1e3:.2f} us, plain "
            f"{plain * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by})")


def _mul_schedule_tables(a0: int, b0: int, prod0: int, prod_w: int,
                         carry: int):
    """One table of the six m=6 multiply schedules (``arith.mul_schedules``)
    and its true pass count, bucketed as ``APEngine.run`` buckets it."""
    from repro_torch.core import arith
    from repro_torch.core.bitplane import Field
    from repro_torch.core.engine import PassSchedule, bucket_schedule
    sched = PassSchedule.concat(arith.mul_schedules(
        Field(a0, 6), Field(b0, 6), Field(prod0, prod_w), Field(carry, 1)))
    return bucket_schedule(sched), sched


@phase("3 AP kernel vs plain")
def check_ap(results):
    import numpy as np
    import torch
    from repro_torch.core.engine import schedule_tensors
    from repro_torch.kernels.ap_match import ops
    # dmm trace shape: 32x32 operands, m=6 -> 402 bit columns, 32 lanes;
    # a_0 at column 0, b_0 at 192, the 17-bit accumulator at 384, carry 401
    cases = (("main", 402, 32, (0, 192, 384, 17, 401), 200),
             ("large", 32, 32768, (0, 6, 12, 13, 25), 20))
    for label, n_bits, n_lanes, layout, reps in cases:
        tables, sched = _mul_schedule_tables(*layout)
        tabs = schedule_tensors(*tables, "cuda")
        rng = np.random.default_rng(n_bits + n_lanes)
        planes = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (n_bits, n_lanes), dtype=np.int64)
            .astype(np.int32)).cuda()
        got, m = ops.run_schedule(planes, *tabs)
        want, m_plain = ops.run_schedule_plain(planes, *tabs)
        torch.cuda.synchronize()
        err = max(int((got.long() - want.long()).abs().max()),
                  int((m.long() - m_plain.long()).abs().max()))
        check(err == 0, f"AP kernel differs from plain at {n_bits}x"
              f"{n_lanes}: planes or matched counts")
        P, kc = tables[0].shape
        kw = tables[2].shape[1]
        n_bytes = 2 * planes.numel() * 4 + 4 * P * (2 * kc + 2 * kw) + 4 * P
        n_ops = P * n_lanes * (3 * kc + 3 * kw + 2)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        ms = cuda_ms(lambda: ops.run_schedule(planes, *tabs), reps)
        plain = cuda_ms(lambda: ops.run_schedule_plain(planes, *tabs),
                        max(reps // 20, 2))
        results[f"ap_{label}"] = dict(
            n_bits=n_bits, n_lanes=n_lanes, passes=P, true_passes=
            sched.n_passes, kc=kc, kw=kw, max_abs_err=err, ms=ms,
            plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        say(f"  run_schedule {n_bits}x{n_lanes} lanes, {P} passes "
            f"(Kc={kc}, Kw={kw}): bit-identical; kernel {ms * 1e3:.2f} us, "
            f"plain {plain * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us "
            f"({b_by})")


def _same_counters(a: dict, b: dict) -> bool:
    import numpy as np
    if set(a) != set(b):
        return False
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            if not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
                return False
        elif a[k] != b[k]:
            return False
    return True


@phase("4 AP trace capture, card vs host")
def check_capture(results):
    from repro_torch.kernels.ap_match import ops
    from repro_torch.workloads import registry
    before = ops.run_schedule.launches
    for w, n in (("dmm", 1024), ("fft", 256), ("bs", 256)):
        t0 = time.perf_counter()
        on_card = registry.trace_counters(w, n, device="cuda")
        t1 = time.perf_counter()
        on_host = registry.trace_counters(w, n, device="cpu")
        t2 = time.perf_counter()
        check(_same_counters(on_card, on_host),
              f"{w}: counters or trace events differ between card and host")
        results[f"capture_{w}_{n}"] = dict(cuda_s=t1 - t0, cpu_s=t2 - t1,
                                           cycles=on_card["cycles"])
        say(f"  {w} n={n}: identical ({on_card['cycles']} cycles); card "
            f"{t1 - t0:.2f} s, host {t2 - t1:.2f} s")
    check(ops.run_schedule.launches > before,
          "the AP kernel was not launched by the card capture")


@phase("5 main path")
def main_path(results):
    import numpy as np
    from repro_torch.core import cosim
    from repro_torch.core import models as M
    from repro_torch.kernels.ap_match import ops as ap_ops
    from repro_torch.kernels.thermal_stencil import ops as st_ops
    from repro_torch.stack import feedback

    workloads, n_intervals = ("dmm", "fft", "bs"), 48
    cosim._ap_workload_trace.cache_clear()
    ap_ops.run_schedule.launches = 0
    st_ops.apply_operator_fields.launches = 0
    # the trace capture run_stack_cosim starts with, through its own
    # (device-keyed) cache, timed apart from the replay
    t0 = time.perf_counter()
    for w in workloads:
        cosim.ap_workload_trace(w, n_intervals,
                                cosim.trace_elems(M.N_DATA), device="cuda")
    t1 = time.perf_counter()
    out = feedback.run_stack_cosim(workloads, n_dram=2, grid_n=24,
                                   n_intervals=n_intervals, device="cuda")
    t2 = time.perf_counter()
    launches = {"ap_match": ap_ops.run_schedule.launches,
                "thermal_stencil": st_ops.apply_operator_fields.launches}
    check(launches["ap_match"] > 0, "main path launched no AP kernel")
    check(launches["thermal_stencil"] > 0,
          "main path launched no stencil kernel")

    say("  workload machine  DRAM peak C  reference C   delta C  "
        "above 85C s  converged  verdict")
    cases = {}
    for w in workloads:
        for machine in ("ap", "simd"):
            r = out[w][machine]
            for name in ("peak_C", "min_C", "residual_C", "throttle",
                         "refresh_W", "leak_W", "dyn_W"):
                check(bool(np.isfinite(getattr(r, name)).all()),
                      f"{w}/{machine}: {name} not finite")
            peak = float(r.dram_peak_C.max())
            ref = REFERENCE_DRAM_PEAK_C[(w, machine)]
            above = r.dram_time_above_limit_s
            verdict = "OK" if above == 0.0 else "BLOCKED"
            cases[f"{w}/{machine}"] = dict(
                dram_peak_C=peak, reference_C=ref, delta_C=peak - ref,
                above_85C_s=above, converged=r.converged,
                residual_C=float(r.residual_C.max()), verdict=verdict)
            say(f"  {w:8s} {machine:7s} {peak:11.4f} {ref:11.4f} "
                f"{peak - ref:+9.4f} {above:12.4f} {str(r.converged):>10s}"
                f"  {verdict}")
    for label, c in cases.items():
        check(c["converged"], f"{label}: Picard residual {c['residual_C']}"
              " above the 0.05 C bar")
        check(abs(c["delta_C"]) <= PEAK_TOL_C,
              f"{label}: DRAM peak {c['dram_peak_C']:.4f} C is "
              f"{c['delta_C']:+.4f} C from the reference")
    for w in workloads:
        check(cases[f"{w}/ap"]["verdict"] == "OK"
              and cases[f"{w}/simd"]["verdict"] == "BLOCKED",
              f"{w}: verdict is AP {cases[f'{w}/ap']['verdict']} / SIMD "
              f"{cases[f'{w}/simd']['verdict']}, not AP OK / SIMD BLOCKED")
    say(f"  verdict: AP OK / SIMD BLOCKED for {', '.join(workloads)}; "
        f"capture {t1 - t0:.2f} s, replay {t2 - t1:.2f} s; launches "
        f"{launches}")
    results["main_path"] = dict(capture_s=t1 - t0, replay_s=t2 - t1,
                                launches=launches, cases=cases)
    return launches


def _self_device_us(avg) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(avg, attr):
            return float(getattr(avg, attr))
    return 0.0


def _device_events(prof) -> list:
    """The profile's per-kernel averages that ran on the card (the host
    ops that launched them carry the same device time, so summing over
    every average would count it twice)."""
    from torch.autograd import DeviceType
    return [a for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA]


def _kernel_device_us(prof, name: str):
    """Mean device time [us] per launch of the kernels whose name holds
    ``name``; None if the profiler recorded no device time for them."""
    hits = [a for a in _device_events(prof) if name in a.key]
    total = sum(_self_device_us(a) for a in hits)
    count = sum(a.count for a in hits)
    return total / count if total > 0 and count else None


@phase("6 profile")
def profile(results):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from repro_torch.core import cosim
    from repro_torch.core import models as M
    from repro_torch.core.engine import schedule_tensors
    from repro_torch.kernels.ap_match import ops as ap_ops
    from repro_torch.kernels.thermal_stencil import ops as st_ops
    from repro_torch.stack import feedback
    from repro_torch.stack.spec import PAPER_STACK, dram_on_logic
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    # each kernel alone, at the main path's shapes
    T, F = _stencil_case((6, 7, 36, 36), seed=1)
    tables, _ = _mul_schedule_tables(0, 192, 384, 17, 401)
    tabs = schedule_tensors(*tables, "cuda")
    planes = torch.from_numpy(np.random.default_rng(0).integers(
        -2 ** 31, 2 ** 31, (402, 32), dtype=np.int64).astype(np.int32)).cuda()
    with torch_profile(activities=acts) as prof:
        for _ in range(50):
            st_ops.apply_operator_fields(T, F)
        for _ in range(10):
            ap_ops.run_schedule(planes, *tabs)
        torch.cuda.synchronize()
    for key, name in (("stencil_main", "stencil_fields"),
                      ("ap_main", "run_schedule")):
        us = _kernel_device_us(prof, name)
        results[key]["device_ms"] = None if us is None else us / 1e3
        say(f"  {name}: device time per launch "
            f"{'not measured' if us is None else f'{us:.2f} us'}")

    # a 4-interval window of the main path's replay (its six cases)
    spec, n_win = dram_on_logic(2), 4
    cases = []
    for w in ("dmm", "fft", "bs"):
        dp = cosim.comparable_design_point(w)
        for machine, trace in (
                ("ap", cosim.ap_workload_trace(
                    w, 48, cosim.trace_elems(M.N_DATA), device="cuda")),
                ("simd", cosim.simd_phase_trace(M.WORKLOADS[w], dp, 48))):
            leaves = feedback.assemble_case(dp, w, machine, spec, PAPER_STACK,
                                            24, trace, 6, device="cuda")
            cases.append((f"{w}/{machine}", (leaves[0][:n_win],)
                           + leaves[1:]))

    def window():
        feedback.replay_cases(cases, spec, feedback.FeedbackParams(), 24,
                              0.25 / 48, device="cuda")
        torch.cuda.synchronize()

    window()
    t0 = time.perf_counter()
    window()
    wall_s = time.perf_counter() - t0
    with torch_profile(activities=acts) as prof:
        window()
    avgs = [(a.key, _self_device_us(a), a.count)
            for a in _device_events(prof)]
    busy_us = sum(us for _, us, _ in avgs)
    top = sorted(avgs, key=lambda a: -a[1])[:5]
    results["replay_window"] = dict(
        intervals=n_win, wall_s=wall_s, device_busy_s=busy_us / 1e6,
        busy_share=busy_us / 1e6 / wall_s,
        top=[dict(kernel=k[:80], device_s=us / 1e6, launches=n)
             for k, us, n in top])
    say(f"  replay window ({n_win} of 48 intervals, 6 cases): wall "
        f"{wall_s * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
        f"({100 * busy_us / 1e6 / wall_s:.1f} %)")
    for k, us, n in top:
        say(f"    {us / 1e3:8.2f} ms  {n:6d} launches  {k[:70]}")


# ---------------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name};"
              " run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    results: dict = {"card": smi}
    build_kernels()
    check_stencil(results)
    check_ap(results)
    check_capture(results)
    launches = main_path(results)
    profile(results)

    kernels = [
        dict(name="thermal_stencil.apply_operator_fields", route="cuda",
             source="src/repro_torch/kernels/thermal_stencil/csrc/"
                    "thermal_stencil.cu",
             replaces="src/repro/kernels/thermal_stencil/kernel.py:75",
             launches=launches["thermal_stencil"],
             **{k: results["stencil_main"][k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")}),
        dict(name="ap_match.run_schedule", route="cuda",
             source="src/repro_torch/kernels/ap_match/csrc/ap_match.cu",
             replaces="src/repro/kernels/ap_match/kernel.py:66",
             launches=launches["ap_match"],
             **{k: results["ap_main"][k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")}),
    ]
    results["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        dict(results, lines=LINES), indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
