"""The JAX reference's sweep replay in float64: a witness for records
whose float32 verdict sits on a rounding knife edge.

The reference (``repro``) computes its replay in float32.  Where a DTM
controller sits at a threshold at the benches' unconverged CG, float32
sums taken in another order (PyTorch's against XLA's) can end on either
side of it.  This script reruns the reference's own replay with every
float in float64, so that its result approximates the exact arithmetic
of the same algorithm, and prints each record beside the float32 one:

    PYTHONPATH=src python tools/float64_witness.py

The traces are captured first as the reference does (float32, x64 off).
Then x64 is switched on, ``jnp.float32`` is rebound to ``jnp.float64``
for the reference's own code, and every float input of
``repro.stack.feedback.closed_loop_batch`` is cast to float64.  The
script checks that the replay's outputs are float64, and that the
records of a converged control (``n_cg=120``) agree in both precisions.
It runs on the CPU in about a minute and prints one JSON object last.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

#: the knife-edge records: ``bench_policy.py``'s ``full_spec()`` cut to
#: hist on two DRAM dies, the AP only, and the policies whose records
#: part (per-die, DVFS) beside ramp, which does not
WITNESS_SPEC = dict(workloads=("hist",), n_dram=(2,), machines=("ap",),
                    policies=("ramp", "perdie", "dvfs"))


def _spec(n_cg: int):
    sys.path.insert(0, "benchmarks")
    import bench_policy
    return dataclasses.replace(bench_policy.full_spec(), n_cg=n_cg,
                               **WITNESS_SPEC)


def _rows(res) -> dict:
    return {r.label: dict(
        dram_peak_C=float(r.report.dram_peak_C.max()),
        verdict="FAILED" if r.failed else "OK" if r.verdict_ok
        else "BLOCKED", dtype=str(r.report.peak_C.dtype),
        throttle=[float(x) for x in r.report.throttle],
        dram_peaks_C=[float(x) for x in r.report.dram_peak_C])
        for r in res.records}


def _to_float64(x):
    import jax.numpy as jnp
    if isinstance(x, dict):
        return {k: _to_float64(v) for k, v in x.items()}
    if hasattr(x, "dtype") and np.issubdtype(np.dtype(x.dtype),
                                             np.floating):
        return jnp.asarray(x, np.float64)
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp
    from repro.core import cosim
    from repro.stack import feedback
    from repro.sweep import run_sweep

    out, t0 = {}, time.perf_counter()
    specs = {"cg30": _spec(30), "cg120": _spec(120)}
    # float32, as the reference runs; this also captures the traces
    for key, spec in specs.items():
        out[f"{key}_float32"] = _rows(run_sweep(spec, use_cache=False))

    # float64: the same replay with every float widened
    jax.config.update("jax_enable_x64", True)
    f32, batch = jnp.float32, feedback.closed_loop_batch
    jnp.float32 = jnp.float64
    feedback.closed_loop_batch = lambda *a, **kw: batch(
        *map(_to_float64, a), **kw)
    try:
        for key, spec in specs.items():
            out[f"{key}_float64"] = _rows(run_sweep(spec, use_cache=False))
    finally:
        feedback.closed_loop_batch = batch
        jnp.float32 = f32
        jax.config.update("jax_enable_x64", False)
    assert cosim.ap_workload_trace.cache_info().hits > 0

    for key in specs:
        for label, r64 in out[f"{key}_float64"].items():
            r32 = out[f"{key}_float32"][label]
            assert r64["dtype"] == "float64", (label, r64["dtype"])
            print(f"{key} {label}: float32 {r32['verdict']} at "
                  f"{r32['dram_peak_C']:.4f} C, float64 {r64['verdict']} "
                  f"at {r64['dram_peak_C']:.4f} C")
    worst = max(abs(out["cg120_float64"][k]["dram_peak_C"]
                    - out["cg120_float32"][k]["dram_peak_C"])
                for k in out["cg120_float32"])
    print(f"converged control (n_cg=120): largest |float64 - float32| "
          f"{worst:.2e} C; {time.perf_counter() - t0:.1f} s")
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
