"""The AP megakernel: CUDA kernel and dispatch.

:func:`run_group` executes an :class:`~.ref.OpGroup` against (planes,
tag).  For planes on the CPU it runs :func:`.ref.group_scan_plain`; for
planes on a CUDA device it launches the hand-written kernel
``csrc/ap_megakernel.cu`` (which replaces the TPU kernel
``run_group_kernel`` of the reference package) or raises — it never
falls back.  ``run_group.launches`` counts kernel launches.

A device program that runs the same group many times uploads its tables
once with :func:`device_group` and passes the result instead of the
``OpGroup``: its columns were checked on the host, so a launch then reads
nothing back from the card.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ap_megakernel import ref
from repro_torch.kernels.ap_megakernel.ref import OpGroup


@dataclasses.dataclass(frozen=True)
class DeviceGroup:
    """An op group's tables as int32 tensors on one device (uint32 keys
    keep their bits), with what the launch needs to know about them."""
    op: torch.Tensor
    cond: torch.Tensor
    cmp_cols: torch.Tensor
    cmp_key: torch.Tensor
    w_cols: torch.Tensor
    w_key: torch.Tensor
    enabled: torch.Tensor     # int32[P] of ones: the default mask
    conditional: bool
    col_range: tuple[int, int]

    @property
    def n_ops(self) -> int:
        return int(self.op.shape[0])

    def tables(self) -> tuple:
        return (self.op, self.cond, self.cmp_cols, self.cmp_key,
                self.w_cols, self.w_key)


def device_group(group: OpGroup, device) -> DeviceGroup:
    """Upload ``group``'s tables to ``device`` once."""
    as_t = lambda a: torch.from_numpy(
        np.ascontiguousarray(a).view(np.int32)).to(device)
    cols = np.concatenate([group.cmp_cols.ravel(), group.w_cols.ravel()])
    return DeviceGroup(*(as_t(a) for a in group.tables()),
                       enabled=torch.ones(group.n_ops, dtype=torch.int32,
                                          device=device),
                       conditional=group.conditional,
                       col_range=(int(cols.min()), int(cols.max())))


def run_group(planes: torch.Tensor, tag: torch.Tensor,
              group: OpGroup | DeviceGroup, enabled=None, *,
              backend: str = "jnp", mesh=None, block_lanes: int = 512,
              interpret: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Execute one op group -> (planes', tag', matched int32[P]).

    planes : int32[n_bits, n_lanes];  tag : int32[n_lanes]
    enabled: optional bool[P] op mask, NumPy or a tensor (default: all on)
    The inputs are left unchanged.  ``backend``, ``mesh``,
    ``block_lanes`` and ``interpret`` are the reference's options and are
    ignored: the planes' device picks the kernel or the plain version,
    and the lanes are not sharded (the result is the same).
    """
    if planes.device.type == "cpu":
        out_planes, out_tag, matched, _ = ref.group_scan_plain(
            planes, tag, group.tables(), enabled)
        return out_planes, out_tag, matched
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    if planes.dim() != 2 or planes.dtype != torch.int32:
        raise ValueError(f"planes must be int32 [n_bits, n_lanes]; got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    n_bits, n_lanes = planes.shape
    if (tuple(tag.shape) != (n_lanes,) or tag.dtype != torch.int32
            or tag.device != planes.device):
        raise ValueError(f"tag must be int32 [{n_lanes}] on {planes.device};"
                         f" got {tag.dtype} {tuple(tag.shape)} on "
                         f"{tag.device}")
    dg = group if isinstance(group, DeviceGroup) \
        else device_group(group, planes.device)
    P, kc = dg.cmp_cols.shape
    kw = dg.w_cols.shape[1]
    for t, shape in zip(dg.tables(), ((P,), (P,), (P, kc), (P, kc),
                                      (P, kw), (P, kw))):
        if (tuple(t.shape) != shape or t.dtype != torch.int32
                or t.device != planes.device or not t.is_contiguous()):
            raise ValueError(f"group tables must be contiguous int32 [P], "
                             f"[P,Kc], [P,Kw] on {planes.device}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    lo, hi = dg.col_range
    if lo < 0 or hi >= n_bits:
        raise IndexError(f"group column outside [0, {n_bits})")
    if enabled is None:
        en = dg.enabled
    else:
        en = torch.as_tensor(enabled, device=planes.device).to(torch.int32)
        if tuple(en.shape) != (P,):
            raise ValueError(f"enabled must have shape ({P},); got "
                             f"{tuple(en.shape)}")
    out_planes = planes.contiguous().clone()
    out_tag = tag.contiguous().clone()
    matched = torch.zeros(P, dtype=torch.int32, device=planes.device)
    if n_lanes == 0:
        return out_planes, out_tag, matched
    en = en.contiguous()
    rc = _lib().ap_megakernel_run_group(
        out_planes.data_ptr(), out_tag.data_ptr(), n_bits, n_lanes,
        dg.op.data_ptr(), dg.cond.data_ptr(), en.data_ptr(),
        *(t.data_ptr() for t in dg.tables()[2:]),
        P, kc, kw, int(dg.conditional), matched.data_ptr(),
        torch.cuda.current_stream(planes.device).cuda_stream)
    _build.check(rc, "ap_megakernel_run_group")
    run_group.launches += 1
    return out_planes, out_tag, matched


run_group.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("ap_megakernel")
    fn = lib.ap_megakernel_run_group
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int] + [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    return lib
