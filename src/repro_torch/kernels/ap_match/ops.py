"""The AP pass schedule: CUDA kernel and plain version.

:func:`run_schedule` executes every ``APEngine.run``.  For planes on the
CPU it runs :func:`run_schedule_plain`; for planes on a CUDA device it
launches the hand-written kernel ``csrc/ap_match.cu`` (which replaces the
TPU kernel ``run_schedule_kernel`` of the reference package) or raises —
it never falls back.  ``run_schedule.launches`` counts kernel launches.

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


def run_schedule(planes: torch.Tensor, cmp_cols: torch.Tensor,
                 cmp_key: torch.Tensor, w_cols: torch.Tensor,
                 w_key: torch.Tensor, col_range: tuple[int, int] | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Execute a full AP pass schedule.

    planes : int32[n_bits, n_lanes]
    cmp_cols/cmp_key : int32[P, Kc];  w_cols/w_key : int32[P, Kw], on the
    planes' device.  Returns (planes', matched int32[P]); the input
    planes are left unchanged.  ``col_range`` is the (least, greatest)
    column of the tables where the caller knows it from its host copy;
    without it the wrapper reads the bounds back from the card.
    """
    if planes.device.type == "cpu":
        return run_schedule_plain(planes, cmp_cols, cmp_key, w_cols, w_key)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    if planes.dim() != 2 or planes.dtype != torch.int32:
        raise ValueError(f"planes must be int32 [n_bits, n_lanes]; got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    n_bits, n_lanes = planes.shape
    P, kc = cmp_cols.shape
    kw = w_cols.shape[1]
    tables = (cmp_cols, cmp_key, w_cols, w_key)
    for t, shape in zip(tables, ((P, kc), (P, kc), (P, kw), (P, kw))):
        if (tuple(t.shape) != shape or t.dtype != torch.int32
                or t.device != planes.device):
            raise ValueError(f"schedule tables must be int32 [P,Kc]/[P,Kw] "
                             f"on {planes.device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    lib = _lib()
    if P > lib.ap_match_max_passes():
        raise ValueError(f"schedule of {P} passes exceeds the kernel's "
                         f"{lib.ap_match_max_passes()} (shared-memory counts)")
    out = planes.contiguous().clone()
    matched = torch.zeros(P, dtype=torch.int32, device=planes.device)
    if P == 0 or n_lanes == 0:
        return out, matched
    if col_range is None:
        lo_c, hi_c, lo_w, hi_w = torch.stack(
            [cmp_cols.min(), cmp_cols.max(), w_cols.min(),
             w_cols.max()]).tolist()
        col_range = (min(lo_c, lo_w), max(hi_c, hi_w))
    if col_range[0] < 0 or col_range[1] >= n_bits:
        raise IndexError(f"schedule column outside [0, {n_bits})")
    tables = [t.contiguous() for t in tables]
    rc = lib.ap_match_run_schedule(
        out.data_ptr(), n_bits, n_lanes, *(t.data_ptr() for t in tables),
        P, kc, kw, matched.data_ptr(),
        torch.cuda.current_stream(planes.device).cuda_stream)
    _build.check(rc, "ap_match_run_schedule")
    run_schedule.launches += 1
    return out, matched


run_schedule.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("ap_match")
    if lib.ap_match_run_schedule.argtypes is None:
        lib.ap_match_max_passes.restype = ctypes.c_int
        lib.ap_match_max_passes.argtypes = []
        fn = lib.ap_match_run_schedule
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] \
            + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 2
    return lib
