"""The red-black z-line multigrid smoother: CUDA kernel and plain version.

:func:`rb_line_sweep` is one half-sweep of the smoother that every
V-cycle level of ``core/multigrid`` runs.  For a tensor on the CPU it
runs :func:`rb_line_sweep_plain`; for a CUDA tensor it launches the
hand-written kernel ``csrc/mg_smooth.cu`` (which replaces the TPU kernel
``rb_line_sweep_kernel`` of the reference package) or raises — it never
falls back.  ``rb_line_sweep.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.thermal_stencil.ops import (
    FIELD_KEYS, face_diagonal, shift)

#: most layers a column may have on the card (the kernel keeps the
#: Thomas coefficients of a column in registers up to this cap)
MAX_LAYERS = 16


def parity(ny: int, nx: int, device=None) -> torch.Tensor:
    """[ny, nx] in-plane checkerboard ``(y + x) % 2`` over the global
    indices (the same in every case and layer)."""
    yy = torch.arange(ny, device=device)[:, None]
    xx = torch.arange(nx, device=device)[None, :]
    return (yy + xx) % 2


def diagonal(F: dict, d_extra) -> torch.Tensor:
    """Exact diagonal of the level operator G + diag(d_extra) (0 for void
    cells), summed in the Pallas kernel's order."""
    return face_diagonal(F) + d_extra


def line_solve(rhs: torch.Tensor, F: dict, d_extra) -> torch.Tensor:
    """Solve every (y, x) column's vertical tridiagonal system exactly
    (Thomas over the layer axis, dim -3 of ``[..., L, NY, NX]``).

    System per column:  diag[l] u[l] - gz_up[l] u[l-1] - gz_dn[l] u[l+1]
    = rhs[l], with ``diag`` the level operator's diagonal (1 for void
    cells, whose rows are all zero).  Sums and guards in the order of
    the Pallas kernel, which the CUDA kernel repeats.
    """
    L = rhs.shape[-3]
    d = diagonal(F, d_extra)
    d = torch.where(d > 0, d, 1.0)
    lo = -F["gz_up"]            # coupling to layer l-1 (zero at l = 0)
    up = -F["gz_dn"]            # coupling to layer l+1 (zero at l = L-1)
    at = lambda x, l: x.select(-3, l)

    cp = [at(up, 0) / at(d, 0)]
    dp = [at(rhs, 0) / at(d, 0)]
    for l in range(1, L):
        denom = at(d, l) - at(lo, l) * cp[-1]
        denom = torch.where(denom.abs() > 0, denom, 1.0)
        cp.append(at(up, l) / denom)
        dp.append((at(rhs, l) - at(lo, l) * dp[-1]) / denom)
    u = [dp[-1]]
    for l in range(L - 2, -1, -1):
        u.append(dp[l] - cp[l] * u[-1])
    return torch.stack(u[::-1], dim=-3)


def rb_line_sweep_plain(T: torch.Tensor, b: torch.Tensor, F: dict, d_extra,
                        color: int) -> torch.Tensor:
    """One half-sweep in plain PyTorch: update the columns whose in-plane
    parity is ``color`` by their exact z-line solve, lateral neighbours
    frozen at ``T``.  ``T`` is [L, NY, NX] or [B, L, NY, NX]."""
    rhs = (b + F["gx_lf"] * shift(T, -1, -1) + F["gx_rt"] * shift(T, -1, 1)
           + F["gy_up"] * shift(T, -2, -1) + F["gy_dn"] * shift(T, -2, 1))
    u = line_solve(rhs, F, d_extra)
    mask = parity(T.shape[-2], T.shape[-1], T.device) == color
    return torch.where(mask, u, T)


def rb_line_sweep(T: torch.Tensor, b: torch.Tensor, F: dict, d_extra,
                  color: int, *, block_y: int = 32,
                  interpret: bool = True) -> torch.Tensor:
    """One red-black z-line Gauss-Seidel half-sweep, out of place.

    ``T`` and ``b`` are [L, NY, NX] or [B, L, NY, NX]; every field of
    ``F`` has T's shape; ``d_extra`` is a scalar or a tensor of T's shape
    (a scalar is expanded, as the reference's wrapper broadcasts it).
    ``block_y`` and ``interpret`` are the reference's Pallas options and
    are ignored.
    """
    if color not in (0, 1):
        raise ValueError(f"color must be 0 or 1; got {color!r}")
    if T.device.type == "cpu":
        return rb_line_sweep_plain(T, b, F, d_extra, color)
    if T.device.type != "cuda":
        raise ValueError(f"unsupported device {T.device}")
    if T.dim() not in (3, 4) or T.dtype != torch.float32:
        raise ValueError(f"T must be float32 [L,NY,NX] or [B,L,NY,NX]; got "
                         f"{T.dtype} {tuple(T.shape)}")
    L, NY, NX = T.shape[-3:]
    if L > MAX_LAYERS:
        raise ValueError(f"{L} layers; the kernel takes at most "
                         f"{MAX_LAYERS}")
    if not torch.is_tensor(d_extra):
        d_extra = torch.full_like(T, float(d_extra))
    arrays = [("b", b)] + [(k, F[k]) for k in FIELD_KEYS] \
        + [("d_extra", d_extra)]
    for name, a in arrays:
        if (a.shape != T.shape or a.dtype != torch.float32
                or a.device != T.device or not a.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"of T's shape {tuple(T.shape)} on {T.device}")
    T = T.contiguous()
    B = T.shape[0] if T.dim() == 4 else 1
    out = torch.empty_like(T)
    if out.numel() == 0:
        return out
    rc = _lib().mg_rb_line_sweep(
        T.data_ptr(), *(a.data_ptr() for _, a in arrays), out.data_ptr(),
        B, L, NY, NX, int(color),
        torch.cuda.current_stream(T.device).cuda_stream)
    _build.check(rc, "mg_rb_line_sweep")
    rb_line_sweep.launches += 1
    return out


rb_line_sweep.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("mg_smooth")
    fn = lib.mg_rb_line_sweep
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
    return lib
