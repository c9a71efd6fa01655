"""Time ``ops.mha`` of another ``flash_attention/ops.py`` against the
package's own, alternately in one process on one card, at
``chip_smoke.py`` 's launch-bound flash shapes (where a call's host time
shows): decode, ragged and whisper's decoder, forward only.

    PYTHONPATH=src python tools/flash_host_cost.py OTHER_OPS_PY [ROUNDS]

``OTHER_OPS_PY`` is loaded as a module of its own (its imports resolve
to this tree's package, so it must take the same kernel library); both
call the same compiled kernel.  Each round times each source by CUDA
events over a shape's ``reps`` calls after a warm-up; the best and the
median of the rounds are printed, milliseconds a call, with the card's
name and power limit.
"""
from __future__ import annotations

import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = ("decode", "decode_causal", "ragged", "ragged_causal",
          "whisper_decoder")


def main() -> None:
    import numpy as np
    import torch
    from chip_smoke import FLASH_CASES, cuda_ms
    from repro_torch.kernels.flash_attention import ops
    spec = importlib.util.spec_from_file_location("other_ops", sys.argv[1])
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 7
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for label in SHAPES:
        B, sq, sk, hq, hkv, dh, causal, window, dt, reps = FLASH_CASES[label]
        rng = np.random.default_rng(sq + sk + dh)
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to("cuda", getattr(torch, dt)) for s in (
                       (B, sq, hq, dh), (B, sk, hkv, dh), (B, sk, hkv, dh)))
        kw = dict(causal=causal, window=window)
        check = torch.equal(other.mha(q, k, v, **kw), ops.mha(q, k, v, **kw))
        times = {"other": [], "this": []}
        for _ in range(rounds):
            for name, mod in (("other", other), ("this", ops)):
                times[name].append(cuda_ms(lambda: mod.mha(q, k, v, **kw),
                                           10 * reps))
        print(f"{label} {[B, sq, sk, hq, hkv, dh]}: " + "; ".join(
            f"{name} best {min(t):.4f} ms, median "
            f"{statistics.median(t):.4f} ms" for name, t in times.items())
            + f"; outputs equal {check}", flush=True)


if __name__ == "__main__":
    main()
