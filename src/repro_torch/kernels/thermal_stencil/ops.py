"""The thermal stencils: CUDA kernels and plain versions.

:func:`apply_operator_fields` is the face-conductance matvec inside every
PCG iteration and multigrid residual of the fields operator;
:func:`apply_operator` is the legacy uniform-per-layer matvec of the
``transient``/``transient_implicit`` steppers and ``_cg_solve``.  For a
tensor on the CPU each runs its plain version
(:func:`apply_operator_fields_plain`, :func:`apply_operator_plain`); for a
CUDA tensor it launches its hand-written kernel in
``csrc/thermal_stencil.cu`` (which replace the TPU kernels
``apply_operator_fields_kernel`` and ``apply_operator_kernel`` of the
reference package) or raises — it never falls back.  Each wrapper's
``.launches`` counts its kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

FIELD_KEYS = ("gx_lf", "gx_rt", "gy_up", "gy_dn", "gz_up", "gz_dn", "g_pkg")


def shift(T: torch.Tensor, dim: int, step: int) -> torch.Tensor:
    """Neighbour ``step`` (-1 before / +1 after) along ``dim`` with the
    edge cell replicated."""
    n = T.shape[dim]
    if step < 0:
        return torch.cat([T.narrow(dim, 0, 1), T.narrow(dim, 0, n - 1)], dim)
    return torch.cat([T.narrow(dim, 1, n - 1), T.narrow(dim, n - 1, 1)], dim)


def face_diagonal(F: dict) -> torch.Tensor:
    """Sum of a cell's seven face conductances: the diagonal of G (0 for
    void cells).  The one place that fixes the order of its terms, which
    the smoother kernel repeats."""
    return (F["gx_lf"] + F["gx_rt"] + F["gy_up"] + F["gy_dn"]
            + F["gz_up"] + F["gz_dn"] + F["g_pkg"])


def apply_operator_fields_plain(T: torch.Tensor, F: dict) -> torch.Tensor:
    """y = G T over the last three dims ``[..., L, NY, NX]`` (plain
    PyTorch; the terms in the reference's order)."""
    t_lf, t_rt = shift(T, -1, -1), shift(T, -1, 1)
    t_up, t_dn = shift(T, -2, -1), shift(T, -2, 1)
    l_up, l_dn = shift(T, -3, -1), shift(T, -3, 1)
    return (F["gx_lf"] * (T - t_lf) + F["gx_rt"] * (T - t_rt)
            + F["gy_up"] * (T - t_up) + F["gy_dn"] * (T - t_dn)
            + F["gz_up"] * (T - l_up) + F["gz_dn"] * (T - l_dn)
            + F["g_pkg"] * T)


def apply_operator_fields(T: torch.Tensor, F: dict) -> torch.Tensor:
    """y = G T for ``T`` of shape [L, NY, NX] or [B, L, NY, NX]; every
    field of ``F`` has T's shape, dtype and device."""
    if T.device.type == "cpu":
        return apply_operator_fields_plain(T, F)
    if T.device.type != "cuda":
        raise ValueError(f"unsupported device {T.device}")
    if T.dim() not in (3, 4) or T.dtype != torch.float32:
        raise ValueError(f"T must be float32 [L,NY,NX] or [B,L,NY,NX]; got "
                         f"{T.dtype} {tuple(T.shape)}")
    fields = [F[k] for k in FIELD_KEYS]
    for k, g in zip(FIELD_KEYS, fields):
        if (g.shape != T.shape or g.dtype != torch.float32
                or g.device != T.device or not g.is_contiguous()):
            raise ValueError(f"field {k} must be a contiguous float32 tensor "
                             f"of T's shape {tuple(T.shape)} on {T.device}")
    T = T.contiguous()
    B = T.shape[0] if T.dim() == 4 else 1
    L, NY, NX = T.shape[-3:]
    y = torch.empty_like(T)
    if y.numel() == 0:
        return y
    lib = _lib()
    rc = lib.thermal_stencil_fields(
        T.data_ptr(), *(g.data_ptr() for g in fields), y.data_ptr(),
        B, L, NY, NX, torch.cuda.current_stream(T.device).cuda_stream)
    _build.check(rc, "thermal_stencil_fields")
    apply_operator_fields.launches += 1
    return y


apply_operator_fields.launches = 0


def apply_operator_plain(T: torch.Tensor, g_lat: torch.Tensor,
                         gv_up: torch.Tensor, gv_dn: torch.Tensor,
                         g_pkg: torch.Tensor) -> torch.Tensor:
    """y = G T over the last three dims ``[..., L, NY, NX]`` with the
    per-layer ``[L]`` vectors of the uniform stencil (plain PyTorch; the
    terms in the reference's order)."""
    col = lambda v: v[:, None, None]
    t_up, t_dn = shift(T, -2, -1), shift(T, -2, 1)
    t_lf, t_rt = shift(T, -1, -1), shift(T, -1, 1)
    y = col(g_lat) * (4.0 * T - t_up - t_dn - t_lf - t_rt)
    l_up, l_dn = shift(T, -3, -1), shift(T, -3, 1)
    return (y + col(gv_up) * (T - l_up) + col(gv_dn) * (T - l_dn)
            + col(g_pkg) * T)


def apply_operator(T: torch.Tensor, g_lat: torch.Tensor,
                   gv_up: torch.Tensor, gv_dn: torch.Tensor,
                   g_pkg: torch.Tensor) -> torch.Tensor:
    """y = G T of the uniform-per-layer stencil for ``T`` of shape
    [L, NY, NX] or [B, L, NY, NX]; the four vectors are float32 [L] on
    T's device (``thermal._vectors`` builds them), shared by the batch."""
    vecs = (g_lat, gv_up, gv_dn, g_pkg)
    if T.device.type == "cpu":
        return apply_operator_plain(T, *vecs)
    if T.device.type != "cuda":
        raise ValueError(f"unsupported device {T.device}")
    if T.dim() not in (3, 4) or T.dtype != torch.float32:
        raise ValueError(f"T must be float32 [L,NY,NX] or [B,L,NY,NX]; got "
                         f"{T.dtype} {tuple(T.shape)}")
    L, NY, NX = T.shape[-3:]
    for name, v in zip(("g_lat", "gv_up", "gv_dn", "g_pkg"), vecs):
        if (v.shape != (L,) or v.dtype != torch.float32
                or v.device != T.device or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [{L}] "
                             f"tensor on {T.device}")
    T = T.contiguous()
    B = T.shape[0] if T.dim() == 4 else 1
    y = torch.empty_like(T)
    if y.numel() == 0:
        return y
    rc = _lib().thermal_stencil_uniform(
        T.data_ptr(), *(v.data_ptr() for v in vecs), y.data_ptr(),
        B, L, NY, NX, torch.cuda.current_stream(T.device).cuda_stream)
    _build.check(rc, "thermal_stencil_uniform")
    apply_operator.launches += 1
    return y


apply_operator.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("thermal_stencil")
    fn = lib.thermal_stencil_fields
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    fn = lib.thermal_stencil_uniform
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    return lib
