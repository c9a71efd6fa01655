"""End-to-end training entry point: a small LM for a few hundred steps, with
checkpoint/restart fault tolerance.

  PYTHONPATH=src python -m repro_torch.train_lm --steps 300 [--device cpu]
  # kill it mid-run and re-invoke: it resumes from the newest checkpoint
  # with the same trajectory (deterministic data pipeline and kernels).

The port of ``examples/train_lm.py``, with its flags: a width-scaled
stablelm-family config (~26M params by default; ``--width 768 --layers
12`` gives ~110M), float32 weights from a seeded ``torch.Generator``,
``launch.steps.make_train_step`` on the one-device mesh and
``runtime.train_loop`` with checkpoints.  Prints the loss and the
milliseconds of every tenth step.  Runs on the card unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import resolve_device, tree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.models.model import PerfConfig
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import TrainerConfig, train_loop


def width_scaled(width: int, layers: int, vocab: int):
    """stablelm-1.6b's family at ``width`` and ``layers``: heads of 64,
    d_ff three times the width, as the reference example scales it."""
    return dataclasses.replace(
        get_config("stablelm-1.6b"), n_layers=layers, d_model=width,
        n_heads=width // 64, n_kv_heads=width // 64, d_ff=width * 3,
        vocab=vocab, d_head=64)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--ckpt-dir", default="ckpt/train_lm")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = width_scaled(args.width, args.layers, args.vocab)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in tree.leaves(params))
    print(f"model: {n_params / 1e6:.1f}M params "
          f"({args.layers}L x {args.width}) on {dev}")

    cell = ShapeCell("local", args.seq, args.batch, "train")
    perf = PerfConfig(remat="none", accum_steps=1)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    train_step, _ = make_train_step(cfg, cell, make_local_mesh(1, 1,
                                                               device=dev),
                                    perf=perf, opt_cfg=opt_cfg,
                                    dtype=torch.float32, device=dev)
    opt = adamw_init(params)
    pipe = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir,
                         log_path=f"{args.ckpt_dir}/log.jsonl")

    def hook(step, params, opt, rec):
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {rec['loss']:.4f}  "
                  f"({rec['dt_s'] * 1000:.0f} ms)", flush=True)

    out = train_loop(train_step, params, opt, pipe, tcfg, accum=1, hook=hook)
    if out["history"]:
        print(f"done: loss {out['history'][0]['loss']:.4f} -> "
              f"{out['history'][-1]['loss']:.4f} "
              f"({out['stragglers']} straggler steps)")
    return out


if __name__ == "__main__":
    main()
