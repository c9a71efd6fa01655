"""Spawned ``gloo`` worlds for the port's multi-process tests.

:func:`run_world` writes a script of a preamble, the test's body and an
epilogue, and starts it as ``n`` processes, one a rank.  The rendezvous
is a ``FileStore`` in the test's own ``tmp_path``, never a port, so
worlds of tests running side by side (``pytest -n``) never meet.  Each
rank runs one thread (``torch.set_num_threads(1)``), which also keeps
its float sums in one order.  The body fills the dict ``RESULT``, which
each rank saves with ``torch.save``; :func:`run_world` returns the
ranks' dicts in rank order.  The world has a timeout of its own: past
it every rank is killed and the test fails with the ranks' output, so a
hang costs the suite that timeout and no more.

The body sees ``RANK``, ``WORLD`` and ``ARGS`` (the ``args`` given).
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

_PREAMBLE = """\
import datetime, logging, os, sys
import torch
import torch.distributed as dist
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
ARGS = {args!r}
torch.set_num_threads(1)
# DTensor's advice to flatten a 2-D mesh's sequential collectives
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
dist.init_process_group(
    "gloo", store=dist.FileStore(sys.argv[3], WORLD), rank=RANK,
    world_size=WORLD, timeout=datetime.timedelta(seconds={timeout}))
RESULT = {{}}
"""

# the ranks meet once their results are saved, then end without the
# interpreter's teardown, whose order among the group's threads is not
# fixed (a rank may abort there once its work is done)
_EPILOGUE = """
torch.save(RESULT, sys.argv[4] + f".{RANK}.pt")
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""


def run_world(tmp_path: Path, n: int, body: str, *, args=None,
              timeout: float = 90.0, name: str = "world") -> list[dict]:
    """Run ``body`` on ``n`` spawned ranks; their ``RESULT`` s."""
    work = Path(tmp_path) / name
    work.mkdir(parents=True)
    script = work / "rank.py"
    script.write_text(_PREAMBLE.format(args=args or {}, timeout=int(timeout))
                      + textwrap.dedent(body) + _EPILOGUE)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(n):
        log = open(work / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(rank), str(n),
             str(work / "store"), str(work / "out")],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if codes != [0] * n:
        out = "\n".join(f"--- rank {r} (exit {c}) ---\n"
                        + (work / f"rank{r}.log").read_text()[-3000:]
                        for r, c in enumerate(codes))
        raise AssertionError(f"{name}: a rank failed or the world passed "
                             f"its {timeout:.0f} s\n{out}")
    return [torch.load(work / f"out.{r}.pt", weights_only=False)
            for r in range(n)]


def run_reference(script: str, devices: int = 8) -> subprocess.Popen:
    """The reference's ``script`` started in a subprocess with
    ``devices`` forced host devices, as its own ``tests/
    test_distributed.py`` runs it; ``.communicate()`` it for the
    output."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    return subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT)


def finish(proc: subprocess.Popen, timeout: float = 300.0) -> str:
    """Wait for :func:`run_reference` 's process; its stdout, or the
    failure with both streams."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"reference run passed {timeout:.0f} s\n{err}")
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
    return out
