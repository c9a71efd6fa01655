"""Compare flash-attention kernel sources on the card, in one run.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.compare \\
        [SRC.cu ...]

Builds each source (default: the package's own ``csrc/flash_attention.cu``)
with the port's nvcc flags into ``build/flash_compare/``, all at once; then,
each in a child process with a time limit (a kernel that hangs costs only
its own case), holds it against the plain version at a set of small shapes
in float32 and bfloat16 and times it with CUDA events at the serving
path's prefill shape (``[B, 5120, 32|8, 120]``, causal, window 4096: f32
at B = 4, bf16 at B = 1 and B = 4) beside bf16
``scaled_dot_product_attention``.  Every source must export the C entry
``flash_mha`` of ``csrc/flash_attention.cu``.  To compare two versions,
give both in one run (the card and its power limit are printed).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.kernels import _build

OUT_DIR = _build.BUILD_DIR.parent / "flash_compare"
#: (B, Sq, Sk, Hq, Hkv, dh, causal, window): tile edges, GQA, windows
CHECK_CASES = [
    (1, 256, 256, 4, 2, 128, True, None), (1, 200, 300, 4, 2, 120, True, 100),
    (2, 129, 129, 4, 4, 64, False, None), (1, 50, 70, 2, 1, 16, True, None),
    (2, 1, 96, 4, 4, 32, False, None), (1, 8, 8, 2, 2, 16, True, 0),
    (1, 1040, 1040, 8, 2, 120, True, 1000),
    (1, 127, 127, 4, 2, 64, True, None), (1, 257, 321, 4, 1, 32, False, None),
    (2, 300, 300, 8, 2, 120, True, None), (1, 300, 300, 4, 2, 64, True, 100),
]
#: as chip_smoke.FLASH_TOL: (rtol, atol) by dtype name
TOL = {"float32": (0.0, 1e-4), "bfloat16": (2.0 ** -7, 1e-4)}


def _load(lib_path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(lib_path))
    lib.flash_mha.restype = ctypes.c_int
    lib.flash_mha.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_float, ctypes.c_void_p]
    return lib


def _run(lib, q, k, v, causal, window):
    import torch
    B, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, sq, hq, dh), dtype=torch.float32, device=q.device)
    _build.check(lib.flash_mha(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, sq, sk,
        hq, hkv, dh, 0 if q.dtype == torch.float32 else 1, int(causal),
        -1 if window is None else window, ctypes.c_float(dh ** -0.5),
        torch.cuda.current_stream().cuda_stream), "flash_mha")
    return out.to(q.dtype)


def _inputs(shape_q, shape_kv, dtype, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(s, generator=g).to("cuda", dtype)
                 for s in (shape_q, shape_kv, shape_kv))


def _child(lib_path: str) -> None:
    """Check, then time, one built library (runs in a child process)."""
    import torch
    from repro_torch.kernels.flash_attention import ref
    lib = _load(Path(lib_path))
    for dt, (rtol, atol) in TOL.items():
        worst = 0.0
        for B, sq, sk, hq, hkv, dh, causal, window in CHECK_CASES:
            q, k, v = _inputs((B, sq, hq, dh), (B, sk, hkv, dh),
                              getattr(torch, dt), sq + dh)
            got = _run(lib, q, k, v, causal, window).float()
            want = ref.mha(q, k, v, causal=causal, window=window).float()
            worst = max(worst, float(((got - want).abs()
                                      / (atol + rtol * want.abs())).max()))
        print(f"  {dt}: worst |kernel - plain| {worst:.4f} of the limit",
              flush=True)
    for B, dt, reps in ((4, torch.float32, 3), (1, torch.bfloat16, 10),
                        (4, torch.bfloat16, 3)):
        q, k, v = _inputs((B, 5120, 32, 120), (B, 5120, 8, 120), dt, 0)
        ms = _cuda_ms(lambda: _run(lib, q, k, v, True, 4096), reps)
        line = f"  serve prefill B={B} {dt}: {ms:.3f} ms"
        if dt == torch.bfloat16:
            import torch.nn.functional as F
            mask = ref.attention_mask(5120, 5120, causal=True, window=4096,
                                      device="cuda")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = _cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), reps)
            line += f" (SDPA {sdpa:.3f} ms)"
        print(line, flush=True)


def _cuda_ms(fn, reps: int) -> float:
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


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        _child(argv[1])
        return 0
    srcs = [Path(a) for a in argv] or [
        Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = []
    for i, src in enumerate(srcs):
        lib = OUT_DIR / f"{i}-{src.stem}.so"
        jobs.append((src, lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for src, lib, proc in jobs:
        report, _ = proc.communicate()
        print(f"{src}:", flush=True)
        if proc.returncode:
            print(report, flush=True)
            rc = 1
            continue
        t0 = time.perf_counter()
        try:
            run = subprocess.run([sys.executable, "-m", __spec__.name,
                                  "--child", str(lib)], timeout=300)
            rc |= run.returncode
        except subprocess.TimeoutExpired:
            print("  timed out after 300 s", flush=True)
            rc = 1
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
