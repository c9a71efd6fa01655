"""Compare flash-attention kernel sources on the card, in one run.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.compare \\
        [SRC.cu ...]

Builds each source (default: the package's own ``csrc/flash_attention.cu``)
with the port's nvcc flags into ``build/flash_compare/``, all at once; then,
each in a child process with a time limit (a kernel that hangs costs only
its own case), holds it against the plain version at a set of small shapes
in float32 and bfloat16 and times it with CUDA events.

A forward source (one that exports ``flash_mha`` of
``csrc/flash_attention.cu``) is timed at the serving path's prefill shape
(``[B, 5120, 32|8, 120]``, causal, window 4096: f32 at B = 4, bf16 at
B = 1 and B = 4) beside bf16 ``scaled_dot_product_attention``.  A
backward source (one that exports ``flash_mha_bwd`` of
``csrc/flash_attention_bwd.cu``) takes its output and row log-sum-exp from
the package's forward kernel; its dq, dk, dv are held to autograd through
the plain version (normwise, ``BWD_TOL``) and two runs must agree bit for
bit, at ``BWD_CHECK_CASES``; then it is timed at ``BWD_TIME_CASES``
(``chip_smoke.FLASH_BWD_CASES``) beside the backward of
``scaled_dot_product_attention``.  To compare two versions, give both in
one run, in the order old, new, new, old (the card and its power limit are
printed).
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
#: the backward's: (B, Sq, Sk, Hq, Hkv, dh, causal, window): the tile
#: edges of both kernels (63, 65, 127, 129 and 31, 33 rows or keys), every
#: head dim, GQA, windows, cross attention and rows with no visible key
BWD_CHECK_CASES = [
    (1, 63, 63, 2, 1, 16, True, None), (1, 65, 65, 2, 2, 32, True, None),
    (1, 129, 127, 4, 2, 64, True, None), (2, 127, 129, 4, 4, 120, False, 50),
    (1, 33, 31, 2, 1, 128, True, None), (1, 31, 97, 2, 2, 64, False, None),
    (1, 200, 200, 4, 1, 120, True, 20), (1, 100, 64, 4, 2, 64, True, None),
    (2, 224, 300, 4, 4, 64, False, None), (1, 130, 130, 2, 2, 128, True, 70),
    (1, 8, 8, 2, 2, 16, True, 0), (1, 96, 96, 2, 1, 32, True, 5),
]
#: as chip_smoke.FLASH_BWD_TOL: normwise ||kernel - plain|| / ||plain||
BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: as chip_smoke.FLASH_BWD_CASES: label -> (B, Sq, Sk, Hq, Hkv, dh,
#: causal, window, dtype, timed calls)
BWD_TIME_CASES = {
    "stablelm_train": (1, 4096, 4096, 32, 32, 64, True, None, "float32", 5),
    "danube_gqa_window": (2, 1024, 1024, 32, 8, 120, True, 64, "float32",
                          5),
    "whisper_cross": (4, 224, 1500, 8, 8, 64, False, None, "float32", 10),
    "ragged_causal": (1, 100, 130, 4, 2, 32, True, None, "float32", 20),
    "rows_without_keys": (1, 100, 64, 4, 2, 64, True, None, "float32", 20),
    "stablelm_train_bf16": (1, 4096, 4096, 32, 32, 64, True, None,
                            "bfloat16", 5),
}


def _load(lib_path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(lib_path))
    lib.flash_mha.restype = ctypes.c_int
    lib.flash_mha.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_float, ctypes.c_void_p]
    return lib


def _load_bwd(lib_path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(lib_path))
    lib.flash_mha_bwd.restype = ctypes.c_int
    lib.flash_mha_bwd.argtypes = [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    return lib


def _run_bwd(lib, q, k, v, out32, lse, d_out, causal, window):
    """(dq, dk, dv) of one backward source, as ``ops.mha_backward``
    launches the package's."""
    import torch
    B, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, hq, sq), dtype=torch.float32, device=q.device)
    _build.check(lib.flash_mha_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out32.data_ptr(),
        d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, sq, sk, hq, hkv, dh,
        0 if q.dtype == torch.float32 else 1, int(causal),
        -1 if window is None else window, ctypes.c_float(dh ** -0.5),
        torch.cuda.current_stream().cuda_stream), "flash_mha_bwd")
    return dq, dk, dv


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _bwd_inputs(B, sq, sk, hq, hkv, dh, causal, window, dtype, seed):
    """q, k, v, dO on the card and the package's forward output (f32) and
    row log-sum-exp at them."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    g = torch.Generator().manual_seed(seed)
    q, k, v, d_out = (torch.randn(s, generator=g).to("cuda", dtype)
                      for s in ((B, sq, hq, dh), (B, sk, hkv, dh),
                                (B, sk, hkv, dh), (B, sq, hq, dh)))
    _, out32, lse = ops._forward(q, k, v, causal, window, dh ** -0.5, True)
    return q, k, v, d_out, out32, lse


def _child_bwd(lib_path: str) -> None:
    """Check, then time, one built backward library (in a child); exits
    with 1 after the times if a check failed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.models.layers import f32_matmul
    lib = _load_bwd(Path(lib_path))
    ok = True
    with f32_matmul():
        for dt, tol in BWD_TOL.items():
            worst, same = 0.0, True
            for case in BWD_CHECK_CASES:
                B, sq, sk, hq, hkv, dh, causal, window = case
                q, k, v, d_out, out32, lse = _bwd_inputs(
                    *case, getattr(torch, dt), sq + sk + dh)
                got = _run_bwd(lib, q, k, v, out32, lse, d_out, causal,
                               window)
                again = _run_bwd(lib, q, k, v, out32, lse, d_out, causal,
                                 window)
                same &= all(torch.equal(a, b) for a, b in zip(got, again))
                want = ref.mha_backward(q.float(), k.float(), v.float(),
                                        d_out.float(), causal=causal,
                                        window=window)
                for g_, w in zip(got, want):
                    if w.norm() == 0:
                        gap = float("inf") if g_.float().abs().max() > 0 \
                            else 0.0
                    else:
                        gap = _rel(g_, w)
                    if gap > tol:
                        print(f"  {dt} {case}: normwise gap {gap:.3e}",
                              flush=True)
                    worst = max(worst, gap / tol)
            print(f"  {dt}: worst normwise gap {worst:.4f} of the limit; "
                  f"two runs {'bit for bit' if same else 'DIFFER'}",
                  flush=True)
            ok &= same and worst <= 1.0
        for label, (B, sq, sk, hq, hkv, dh, causal, window, dt, reps) in \
                BWD_TIME_CASES.items():
            q, k, v, d_out, out32, lse = _bwd_inputs(
                B, sq, sk, hq, hkv, dh, causal, window, getattr(torch, dt),
                sq + sk + dh + 1)
            ms = _cuda_ms(lambda: _run_bwd(lib, q, k, v, out32, lse, d_out,
                                           causal, window), reps)
            line = f"  {label} {[B, sq, sk, hq, hkv, dh]} {dt}: {ms:.3f} ms"
            mask = ref.attention_mask(sq, sk, causal=causal, window=window,
                                      device="cuda")
            if bool(mask.any(-1).all()):
                lt = [t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v)]
                with torch.enable_grad():
                    lo = F.scaled_dot_product_attention(
                        *lt, attn_mask=mask, enable_gqa=hq != hkv)
                do_t = d_out.transpose(1, 2)
                sdpa = _cuda_ms(lambda: torch.autograd.grad(
                    lo, lt, do_t, retain_graph=True), reps)
                line += f" (SDPA backward {sdpa:.3f} ms)"
            print(line, flush=True)
    if not ok:
        raise SystemExit(1)


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


def _ptxas_summary(report: str) -> str:
    """Each kernel's registers and spills from ``-Xptxas -v``, and any
    warning (a serialized wgmma shows there)."""
    lines, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "warning" in line.lower():
            lines.append("  " + line.strip())
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[1].split("registers")[0].strip()
            lines.append(f"  {name}: {regs} registers")
        elif "spill" in line and " 0 bytes spill stores" not in line:
            lines.append(f"  {name}: {line.strip()}")
    return "\n".join(lines)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        _child(argv[1])
        return 0
    if len(argv) == 2 and argv[0] == "--child-bwd":
        _child_bwd(argv[1])
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
        print(_ptxas_summary(report), flush=True)
        t0 = time.perf_counter()
        child = "--child-bwd" if "flash_mha_bwd" in src.read_text() \
            else "--child"
        try:
            run = subprocess.run([sys.executable, "-m", __spec__.name,
                                  child, str(lib)], timeout=300)
            rc |= run.returncode
        except subprocess.TimeoutExpired:
            print("  timed out after 300 s", flush=True)
            rc = 1
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
