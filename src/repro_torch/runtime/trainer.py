"""Fault-tolerant training loop: checkpoint/restart, straggler monitor,
metric logging (the port of the reference's ``runtime/trainer.py``).

Restart contract: the loop always begins at ``latest_step + 1`` (the data
pipeline regenerates any batch deterministically from the step index), so a
killed job resumes exactly — tests kill a subprocess mid-run and verify the
loss trajectory is identical to an uninterrupted run.

Straggler mitigation (single-host simulation of the fleet policy): per-step
wall time feeds an EWMA; a step exceeding ``straggler_factor`` x EWMA is
counted and logged — on a real fleet this signal triggers the re-dispatch /
hot-spare path; here it drives the same bookkeeping and tests inject
artificial delays to exercise it.

``train_step`` is ``launch.steps.make_train_step``'s: it takes the NumPy
batch, updates the params and optimizer state in place and returns them.
A restart restores new tensors from the newest checkpoint, on the
devices of the ``params`` and ``opt`` it is given.  A step's seconds
include the card's work, since reading the loss waits for it.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLM


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "ckpt"
    keep: int = 3
    log_path: Optional[str] = None
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    alpha: float = 0.2
    ewma: float = 0.0
    n: int = 0
    stragglers: int = 0

    def observe(self, dt: float) -> bool:
        is_straggler = self.n > 3 and dt > self.factor * self.ewma
        self.ewma = dt if self.n == 0 else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        self.n += 1
        if is_straggler:
            self.stragglers += 1
        return is_straggler


def train_loop(train_step: Callable, params: Any, opt: Any,
               pipe: SyntheticLM, tcfg: TrainerConfig,
               accum: int = 1, extras_fn: Optional[Callable] = None,
               hook: Optional[Callable] = None) -> dict:
    """Run (or resume) training; returns final state + history."""
    mgr = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
    mon = StragglerMonitor(tcfg.straggler_factor, tcfg.ewma_alpha)
    if tcfg.log_path:
        pathlib.Path(tcfg.log_path).parent.mkdir(parents=True, exist_ok=True)
    log_f = open(tcfg.log_path, "a") if tcfg.log_path else None

    start = 0
    latest = mgr.latest_step()
    if latest is not None:
        state = mgr.restore(latest, {"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        start = latest + 1

    history = []
    for step in range(start, tcfg.steps):
        batch = pipe.microbatched(step, accum) if accum > 1 \
            else {k: v[None] for k, v in pipe.batch(step).items()}
        if extras_fn is not None:
            batch.update(extras_fn(step))
        t0 = time.time()
        params, opt, metrics = train_step(params, opt, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        straggle = mon.observe(dt)
        rec = {"step": step, "loss": loss, "dt_s": round(dt, 4),
               "straggler": straggle,
               "grad_norm": float(metrics.get("grad_norm", np.nan))}
        history.append(rec)
        if log_f:
            log_f.write(json.dumps(rec) + "\n")
            log_f.flush()
        if hook is not None:
            hook(step, params, opt, rec)
        if (step + 1) % tcfg.ckpt_every == 0 or step + 1 == tcfg.steps:
            mgr.save(step, {"params": params, "opt": opt},
                     extra={"loss": loss})
    mgr.wait()
    if log_f:
        log_f.close()
    return {"params": params, "opt": opt, "history": history,
            "stragglers": mon.stragglers, "final_step": tcfg.steps - 1}
