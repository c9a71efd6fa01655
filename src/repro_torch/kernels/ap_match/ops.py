"""The AP pass schedule: CUDA kernel and plain version.

:func:`run_schedule` executes every ``APEngine.run``.  For planes on the
CPU it runs :func:`run_schedule_plain`; for planes on a CUDA device it
launches the hand-written kernel ``csrc/ap_match.cu`` (which replaces the
TPU kernel ``run_schedule_kernel`` of the reference package) or raises —
it never falls back.  ``run_schedule.launches`` counts kernel launches.
:func:`latency_probe` measures, on the card, the dependent chains that
bound the kernel.

Planes, keys and tables are int32 tensors: the same bits as the
reference's uint32, which CPU PyTorch cannot shift, invert or compare.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LANE = 32


def run_schedule_plain(planes: torch.Tensor, cmp_cols, cmp_key, w_cols,
                       w_key) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same passes, in order.

    The planes are unpacked to one boolean per AP word for the duration
    of the schedule.  Each pass tags the words whose compare columns all
    equal their key bits and counts them; then each write column takes
    its key bit in the tagged words.  Within one pass the writes happen
    in k order, so a column listed twice ends with its LAST key — the
    sequential read-modify-write of the kernel — which is what writing
    each distinct column once, with its last key, computes.
    Returns (planes', matched int32[P]).
    """
    cc, ck = cmp_cols.tolist(), cmp_key.tolist()
    wc, wk = w_cols.tolist(), w_key.tolist()
    dev = planes.device
    shifts = torch.arange(LANE, dtype=torch.int32, device=dev)
    bits = ((planes.unsqueeze(-1) >> shifts) & 1).bool().flatten(1)
    matched = []
    for p in range(len(cc)):
        cols = torch.tensor(cc[p], device=dev)
        keys = torch.tensor([k != 0 for k in ck[p]], device=dev)
        tag = (bits[cols] == keys[:, None]).all(dim=0)
        matched.append(tag.sum())
        last = {c: k != 0 for c, k in zip(wc[p], wk[p])}
        cols = torch.tensor(list(last), device=dev)
        keys = torch.tensor(list(last.values()), device=dev)
        bits[cols] = torch.where(tag, keys[:, None], bits[cols])
    words = bits.view(bits.shape[0], -1, LANE).to(torch.int64)
    packed = (words << shifts.to(torch.int64)).sum(dim=-1)
    packed = packed - ((packed >> 31) << 32)      # uint32 bits as int32
    out = packed.to(torch.int32)
    if not matched:
        return out, torch.zeros(0, dtype=torch.int32, device=dev)
    return out, torch.stack(matched).to(torch.int32)


#: the kernel's two paths (``csrc/ap_match.cu``): the planes' tile in
#: shared memory, or in device memory where the tile does not fit
PATHS = ("shared", "global")


def run_schedule(planes: torch.Tensor, cmp_cols, cmp_key, w_cols, w_key,
                 col_range: tuple[int, int] | None = None, *,
                 backend: str = "pallas", block_lanes: int = 512,
                 interpret: bool = True, path: str | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Execute a full AP pass schedule.

    planes : int32[n_bits, n_lanes]
    cmp_cols/cmp_key : int32[P, Kc];  w_cols/w_key : int32[P, Kw], on the
    planes' device (:func:`~repro_torch.core.engine.schedule_tensors`
    moves host tables there in one copy).  Returns (planes', matched
    int32[P]); the input planes are left unchanged.  ``col_range`` is
    the (least, greatest) column of the tables where the caller knows it
    from its host copy; without it the wrapper reads the bounds back from
    the card.  ``backend``, ``block_lanes`` and ``interpret`` are the
    reference's Pallas options and are ignored: the planes' device picks
    the kernel or the plain version.  ``path`` forces one of
    :data:`PATHS` (the kernel picks by shape without it).
    """
    if planes.device.type == "cpu":
        return run_schedule_plain(planes, cmp_cols, cmp_key, w_cols, w_key)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    if planes.dim() != 2 or planes.dtype != torch.int32:
        raise ValueError(f"planes must be int32 [n_bits, n_lanes]; got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    if path is not None and path not in PATHS:
        raise ValueError(f"unknown path {path!r}; expected one of {PATHS}")
    n_bits, n_lanes = planes.shape
    P, kc = cmp_cols.shape
    kw = w_cols.shape[1]
    tables = (cmp_cols, cmp_key, w_cols, w_key)
    dev = planes.get_device()
    for t, shape in zip(tables, ((P, kc), (P, kc), (P, kw), (P, kw))):
        if (t.shape != shape or t.dtype != torch.int32
                or t.get_device() != dev or not t.is_contiguous()):
            raise ValueError(f"schedule tables must be contiguous int32 "
                             f"[P,Kc]/[P,Kw] on {planes.device}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    planes = planes.contiguous()
    if P == 0 or n_lanes == 0:
        return (planes.clone(),
                torch.zeros(P, dtype=torch.int32, device=planes.device))
    if col_range is None:
        lo_c, hi_c, lo_w, hi_w = torch.stack(
            [cmp_cols.min(), cmp_cols.max(), w_cols.min(),
             w_cols.max()]).tolist()
        col_range = (min(lo_c, lo_w), max(hi_c, hi_w))
    lo, hi = col_range
    if lo < 0 or hi >= n_bits or lo > hi:
        raise IndexError(f"schedule column range {col_range} outside "
                         f"[0, {n_bits})")
    out = torch.empty_like(planes)
    matched = torch.zeros(P, dtype=torch.int32, device=planes.device)
    rc = _run_fn()(
        planes.data_ptr(), out.data_ptr(), n_bits, n_lanes, lo, hi,
        cmp_cols.data_ptr(), cmp_key.data_ptr(), w_cols.data_ptr(),
        w_key.data_ptr(), P, kc, kw, matched.data_ptr(),
        -1 if path is None else PATHS.index(path), _build.stream(dev))
    if rc:
        _build.check(rc, "ap_match_run_schedule")
    run_schedule.launches += 1
    return out, matched


run_schedule.launches = 0


def kernel_path(n_lanes: int, col_range: tuple[int, int], P: int, kc: int,
                kw: int) -> str:
    """The path (one of :data:`PATHS`) the kernel takes for this shape
    when none is forced."""
    return PATHS[_lib().ap_match_path(n_lanes, col_range[0], col_range[1],
                                      P, kc, kw)]


def latency_probe(device="cuda", iters: int = 4096) -> dict:
    """Cycle counts of dependent shared-memory and ALU chains on one SM of
    the card, from ``ap_match_probe``: ``load_cycles`` (shared-memory
    load to use), ``alu_cycles`` (one dependent 32-bit logic op),
    ``rmw_cycles`` (load, one op, store, and the next load of the same
    word) and ``sm_ghz`` (the SM clock over the probe)."""
    out = torch.zeros(6, dtype=torch.int64, device=device)
    _build.check(_lib().ap_match_probe(
        out.data_ptr(), iters,
        torch.cuda.current_stream(out.device).cuda_stream), "ap_match_probe")
    t = out.tolist()
    n = 16 * iters
    return dict(load_cycles=t[0] / n, alu_cycles=t[1] / n,
                rmw_cycles=t[2] / n, sm_ghz=t[3] / t[4])


_RUN_FN = None


def _run_fn():
    """The kernel's ctypes entry, resolved once."""
    global _RUN_FN
    if _RUN_FN is None:
        _RUN_FN = _lib().ap_match_run_schedule
    return _RUN_FN


def _lib() -> ctypes.CDLL:
    lib = _build.load("ap_match")
    if lib.ap_match_run_schedule.argtypes is None:
        lib.ap_match_path.restype = ctypes.c_int
        lib.ap_match_path.argtypes = [ctypes.c_int] * 6
        lib.ap_match_probe.restype = ctypes.c_int
        lib.ap_match_probe.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p]
        fn = lib.ap_match_run_schedule
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] + [ctypes.c_int] + [ctypes.c_void_p]
    return lib
