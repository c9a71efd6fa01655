"""The stack phases of ``chip_smoke.py`` from several checkouts, side by
side on one card.

    PYTHONPATH=src python -m repro_torch.compare_phases ROOT [ROOT ...]

Each ROOT is a checkout of the repository, for example a parent commit
unpacked with ``git archive`` into an ignored directory, and ``.``.  For
each ROOT, in the order given, one process builds that checkout's
kernels (all but flash attention's two) and runs that checkout's own
``chip_smoke.py`` phases 2 (the stencil kernel against its plain version,
timed), 3 (the AP pass-schedule kernel, the same), 5 (the trio's pcg
stack path: capture and replay seconds), the profiled 4-interval pcg
replay window of phase 6 three times (wall time and device-busy share),
7 (the smoother kernel against its plain version at its three shapes,
timed), 8 (the uniform stencil, the same), 11 (the mg stack path), 12
(the legacy transients, pcg and mg), 13 (the op-group megakernel, timed
at each case), 14 (the suite's trace captures in every mode), 15 (the
2^20-byte sort in megakernel mode) and 16 (the suite stack path).  Give
the roots as A B B A to see the spread between two runs of one tree.  It
prints one line of times per run and the card's name and power limit,
and writes every run's results to ``chiprun_out/compare_phases.json``.
It needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

#: what each child process runs, with the checkout's root as argv[1]
_CHILD = r"""
import importlib.util, json, sys
root = sys.argv[1]
sys.path.insert(0, root + "/src")
spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                              root + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from repro_torch.kernels import _build
_build.build_all([s for s in _build.sources()
                  if not s.stem.startswith("flash_attention")])
results = {}
cs.check_stencil(results)
cs.check_ap(results)
cs.main_path(results)
results["pcg_windows"] = [cs._replay_window("pcg") for _ in range(3)]
cs.check_smoother(results)
cs.check_uniform(results)
cs.mg_path(results)
cs.legacy_transient(results)
cs.check_megakernel(results)
cs.suite_capture(results)
cs.paper_sort(results)
cs.suite_stack(results)
print("RESULT " + json.dumps(results, default=str))
"""

#: (label, result key, field, scale to print) of the summary line
_COLUMNS = (("stencil 6x7x36x36 us", "stencil_main", "ms", 1e3),
            ("stencil 7x384x384 us", "stencil_large", "ms", 1e3),
            ("AP 402x32 us", "ap_main", "ms", 1e3),
            ("AP 32x32768 us", "ap_large", "ms", 1e3),
            ("pcg capture s", "main_path", "capture_s", 1.0),
            ("pcg replay s", "main_path", "replay_s", 1.0),
            ("window wall ms", "pcg_windows", "wall_s", 1e3),
            ("window busy %", "pcg_windows", "busy_share", 1e2),
            ("smooth 6x7x36x36 us", "smooth_replay", "ms", 1e3),
            ("smooth 6x7x18x18 us", "smooth_level18", "ms", 1e3),
            ("smooth 7x384x384 us", "smooth_large", "ms", 1e3),
            ("uniform 5x384x384 us", "uniform_large", "ms", 1e3),
            ("mg capture s", "mg_path", "capture_s", 1.0),
            ("mg replay s", "mg_path", "replay_s", 1.0),
            ("transient pcg s", ("legacy_transient", "pcg"), "seconds", 1.0),
            ("transient mg s", ("legacy_transient", "mg"), "seconds", 1.0),
            ("sort round 32768 us", "mk_sort_round_32768", "ms", 1e3),
            ("sort round 32 us", "mk_sort_round_32", "ms", 1e3),
            ("mul group 32768 us", "mk_mul_pass_32768", "ms", 1e3),
            ("spmv probes 32 us", "mk_spmv_probes_32", "ms", 1e3),
            ("hist mk capture s",
             ("suite_capture", "runs", "hist/megakernel/cuda"), "seconds",
             1.0),
            ("spmv mk capture s",
             ("suite_capture", "runs", "spmv/megakernel/cuda"), "seconds",
             1.0),
            ("2^20 sort s", "paper_sort", "seconds", 1.0),
            ("suite capture s", "suite_stack", "capture_s", 1.0),
            ("suite replay s", "suite_stack", "replay_s", 1.0))


def _cell(result, key, field: str, scale: float) -> str:
    """One summary cell (``key`` a result key, or a tuple of nested keys);
    a list of runs (the replay windows) prints each value, joined by
    '/'."""
    got = result
    for k in (key if isinstance(key, tuple) else (key,)):
        got = got[k]
    runs = got if isinstance(got, list) else [got]
    return "/".join(f"{r[field] * scale:.2f}" for r in runs)


def run_root(root: Path) -> dict:
    """The phases of the checkout at ``root``, in a process of their own;
    returns that run's results."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(root)],
                          cwd=root, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: rc {proc.returncode}\n{proc.stdout}\n"
                           f"{proc.stderr}")
    lines = proc.stdout.splitlines()
    result = json.loads(next(ln for ln in lines
                             if ln.startswith("RESULT "))[len("RESULT "):])
    result["log"] = [ln for ln in lines if not ln.startswith("RESULT ")]
    return result


def main(argv=None) -> int:
    roots = [Path(r).resolve() for r in (argv or sys.argv[1:])]
    if not roots:
        print(__doc__)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("compare_phases: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print("run  " + "  ".join(label for label, *_ in _COLUMNS) + "  root")
    runs = []
    for i, root in enumerate(roots):
        r = run_root(root)
        runs.append(dict(root=str(root), results=r))
        cells = [_cell(r, key, field, scale) for _, key, field, scale
                 in _COLUMNS]
        print(f"{i:3d}  " + "  ".join(cells) + f"  {root}", flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "compare_phases.json").write_text(json.dumps(
        dict(card=card, runs=runs), indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
