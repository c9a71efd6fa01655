"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Every ``kernels/<name>/csrc/*.cu`` is a self-contained source with a
plain C interface.  On first use it is compiled for Hopper
(``sm_90a``) into ``build/torch_kernels/<stem>-<hash>.so`` at the root
of the checkout (a directory ``.gitignore`` lists) and loaded with
``ctypes``.  The hash covers the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  :func:`build_all`
starts one ``nvcc`` per out-of-date source, all at once, and waits for
every one of them.

``-fmad=false`` keeps float multiply and add separately rounded, so a
kernel repeats its plain PyTorch version's arithmetic bit for bit.
``-Xptxas -v`` leaves each kernel's register and shared-memory report
in ``<stem>-<hash>.log`` beside the library.

Nothing here runs at import time: the CPU tests import every module of
the port on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[Path]:
    """Every kernel source of the port, in a stable order."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH nor under CUDA_HOME; the "
                           "CUDA kernels build only where the toolkit is")
    return str(path)


def target(src: Path) -> Path:
    """Library path for ``src`` (content- and flag-addressed)."""
    h = hashlib.sha1(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_all(srcs: list[Path] | None = None) -> dict[str, str]:
    """Compile every out-of-date source in parallel; return the ptxas
    report of each source built now, by stem.  Raises with the compiler
    output if any build fails."""
    srcs = sources() if srcs is None else srcs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = []
    for src in srcs:
        out = target(src)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, out, tmp, proc))
    reports, failed = {}, []
    for src, out, tmp, proc in running:
        text, _ = proc.communicate()
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"{src.name} (rc {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        reports[src.stem] = text
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``<stem>.cu`` (built on first
    use)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            srcs = [s for s in sources() if s.stem == stem]
            if len(srcs) != 1:
                raise FileNotFoundError(f"no unique kernel source {stem}.cu "
                                        f"under {KERNELS_DIR}")
            build_all(srcs)
            lib = ctypes.CDLL(str(target(srcs[0])))
            _libs[stem] = lib
        return lib


_raw_stream = None


def stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on card ``device_index``
    (what a kernel launches on), without building a ``Stream`` object."""
    global _raw_stream
    if _raw_stream is None:
        import torch
        _raw_stream = getattr(
            torch._C, "_cuda_getCurrentRawStream",
            lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(device_index)


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{rc}")
