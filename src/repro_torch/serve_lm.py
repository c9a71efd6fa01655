"""Batched serving: prefill a batch of prompts, then decode with a KV cache.

  PYTHONPATH=src python -m repro_torch.serve_lm --batch 8 --prompt-len 64 \\
      --gen 32 --arch h2o-danube-3-4b [--device cpu]

The port of ``examples/serve_lm.py``: the reduced config of the chosen arch,
random weights from a seeded ``torch.Generator``, prefill then greedy
decode.  Reports prefill latency and decode tokens/s.  Runs on the card
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models import serve as SV


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(params: dict, tokens: torch.Tensor, cfg: ArchConfig, gen: int,
             max_seq: int = 0, device="cuda", batch_extra: dict | None = None
             ) -> dict:
    """Prefill ``tokens`` [B, P], then ``gen`` greedy decode steps.

    Returns a dict: ``tokens`` [B, gen + 1] (the token prefill picks, then
    one a step), ``logits`` [gen + 1, B, vocab_p] (the logits each token
    was picked from), ``caches``, and ``prefill_s``/``decode_s`` (host
    seconds, the card synchronised).
    """
    dev = resolve_device(device)
    B, P = tokens.shape
    max_seq = max_seq or P + gen
    batch = {"tokens": tokens.to(dev), **(batch_extra or {})}
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = SV.prefill(params, batch, cfg, max_seq=max_seq)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    toks = logits.argmax(-1)[:, None]
    outs, steps = [toks], [logits]
    t0 = time.perf_counter()
    for t in range(P, P + gen):
        logits, caches = SV.decode_step(params, toks, caches, t, cfg)
        toks = logits.argmax(-1)[:, None]
        outs.append(toks)
        steps.append(logits)
    _sync(dev)
    return {"tokens": torch.cat(outs, 1), "logits": torch.stack(steps),
            "caches": caches, "prefill_s": prefill_s,
            "decode_s": time.perf_counter() - t0}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-3-4b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    B, P, G = args.batch, args.prompt_len, args.gen
    rng = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (B, P), generator=rng)
    extra = {}
    if cfg.n_prefix_embeds:
        extra["prefix_embeds"] = torch.randn(
            (B, cfg.n_prefix_embeds, cfg.d_model), generator=rng).to(dev)

    out = generate(params, tokens, cfg, G, device=dev, batch_extra=extra)
    print(f"{args.arch} (reduced): prefill {B}x{P} tokens in "
          f"{out['prefill_s'] * 1000:.0f} ms on {dev}")
    total = B * G
    print(f"decode: {G} steps x {B} sequences = {total} tokens in "
          f"{out['decode_s']:.2f} s -> {total / out['decode_s']:.0f} tok/s "
          "(greedy)")
    print("sample continuation token ids:", out["tokens"][0][:16].tolist())


if __name__ == "__main__":
    main()
