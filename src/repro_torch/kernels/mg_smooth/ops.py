"""The red-black z-line multigrid smoother: CUDA kernel and plain version.

:func:`rb_line_sweep` is one half-sweep of the smoother that every
V-cycle level of ``core/multigrid`` runs.  For a tensor on the CPU it
runs :func:`rb_line_sweep_plain`; for a CUDA tensor it launches the
hand-written kernel ``csrc/mg_smooth.cu`` (which replaces the TPU kernel
``rb_line_sweep_kernel`` of the reference package) or raises — it never
falls back.  A column of up to :data:`MAX_LAYERS` layers is solved in
registers; a deeper one takes the kernel's streaming path, so any layer
count runs, as in the reference.  A shape past the kernel's 32-bit
indices raises ``NotImplementedError``; a bad argument raises
``ValueError``.  ``rb_line_sweep.launches`` counts kernel launches.

The coefficients go to the kernel split by colour, with the parts of
the Thomas recursion that depend on them alone precomputed
(:func:`thomas_coefficients`); a level made by :func:`checked_level` is
checked and set up once, so a launch on it checks only ``T`` and ``b``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.thermal_stencil.ops import (
    FIELD_KEYS, FieldPack, face_diagonal, pack_fields, shift)

#: deepest column the kernel solves in registers; deeper ones stream a
#: layer at a time through the output column
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


def split_by_colour(F: FieldPack, d_extra: torch.Tensor) -> torch.Tensor:
    """The smoother kernel's coefficients, ``[2, 8, *lead, L, NY, NXH]``
    with ``NXH = ceil(NX / 2)``: for colour c, the seven fields
    (``FIELD_KEYS`` order) and ``d_extra`` at the cells (y, 2i + ((y + c)
    & 1)) that a half-sweep of colour c solves, packed densely, so a sweep
    reads only its own half.  (Past an odd NX edge the last i of a row
    repeats the edge cell; no sweep reads it.)  ``d_extra`` has the
    fields' shape or broadcasts to it."""
    data = torch.cat([F.data, d_extra.expand(F.shape)[None]])
    NY, NX = data.shape[-2:]
    y = torch.arange(NY, device=data.device)[:, None]
    i = torch.arange((NX + 1) // 2, device=data.device)[None, :]
    return torch.stack([
        torch.gather(data, -1, (2 * i + ((y + c) & 1)).clamp(max=NX - 1)
                     .expand(*data.shape[:-1], i.shape[-1]))
        for c in (0, 1)])


def thomas_coefficients(F: FieldPack, d_extra: torch.Tensor
                        ) -> torch.Tensor:
    """The smoother kernel's coefficients, ``[2, 7, *lead, L, NY, NXH]``,
    split by colour (:func:`split_by_colour`): ``gx_lf``, ``gx_rt``,
    ``gy_up``, ``gy_dn``, then ``lo = -gz_up`` and the parts of the Thomas
    recursion that depend on the coefficients alone, the pivots
    ``denom[l]`` and forward coefficients ``cp[l]``, computed by the same
    float32 operations, in the same order, as :func:`line_solve`."""
    gx_lf, gx_rt, gy_up, gy_dn, gz_up, gz_dn, g_pkg, d = \
        split_by_colour(F, d_extra).unbind(1)
    diag = gx_lf + gx_rt + gy_up + gy_dn + gz_up + gz_dn + g_pkg + d
    diag = torch.where(diag > 0, diag, 1.0)
    lo, up = -gz_up, -gz_dn
    at = lambda x, l: x.select(-3, l)
    denom = [at(diag, 0)]
    cp = [at(up, 0) / denom[0]]
    for l in range(1, diag.shape[-3]):
        dn = at(diag, l) - at(lo, l) * cp[-1]
        denom.append(torch.where(dn.abs() > 0, dn, 1.0))
        cp.append(at(up, l) / denom[-1])
    return torch.stack([gx_lf, gx_rt, gy_up, gy_dn, lo,
                        torch.stack(denom, dim=-3), torch.stack(cp, dim=-3)],
                       dim=1)


def checked_level(F: dict, d_extra) -> tuple[FieldPack, torch.Tensor]:
    """A multigrid level ``(F', d')`` whose smoother calls skip the
    per-call checks and the set-up of the fields and ``d_extra``.

    ``F'`` is a new :class:`FieldPack` over ``F``'s data (``F`` itself is
    left as it is) and ``d'`` is ``d_extra`` as a contiguous float32
    tensor of the fields' shape on their device (a scalar is expanded);
    both are checked, and the kernel's coefficients made from them
    (:func:`thomas_coefficients`), once here.  :func:`rb_line_sweep` given
    exactly this pair checks only ``T`` and ``b``.
    """
    pack = FieldPack(pack_fields(F).data)
    g = pack["g_pkg"]
    d = torch.as_tensor(d_extra, dtype=g.dtype, device=g.device)
    d = d.expand(g.shape).contiguous()
    pack.smoother_extra = d
    pack.smoother_coefficients = thomas_coefficients(pack, d)
    return pack, d


def _checked_coefficients(F: dict, d_extra
                          ) -> tuple[FieldPack, torch.Tensor]:
    """``F`` as a pack and the kernel's coefficients, after every check:
    a plain dict of fields is packed; a tensor ``d_extra`` must be
    contiguous float32 of the fields' shape on their device, and a scalar
    is expanded."""
    F = pack_fields(F)
    if not torch.is_tensor(d_extra):
        d_extra = torch.tensor(float(d_extra), device=F.data.device)
    elif (d_extra.shape != F.shape or d_extra.dtype != torch.float32
            or d_extra.get_device() != F.device_index
            or not d_extra.is_contiguous()):
        raise ValueError(f"d_extra must be a contiguous float32 tensor of "
                         f"the fields' shape {tuple(F.shape)} on "
                         f"{F.data.device}")
    return F, thomas_coefficients(F, d_extra)


def rb_line_sweep(T: torch.Tensor, b: torch.Tensor, F: dict, d_extra,
                  color: int, *, block_y: int = 32,
                  interpret: bool = True) -> torch.Tensor:
    """One red-black z-line Gauss-Seidel half-sweep, out of place.

    ``T`` and ``b`` are [L, NY, NX] or [B, L, NY, NX]; every field of
    ``F`` has T's shape; ``d_extra`` is a scalar or a tensor of T's shape
    (a scalar is expanded, as the reference's wrapper broadcasts it).
    A level from :func:`checked_level` (as every level of
    ``multigrid.build_levels`` is) is checked, and its kernel coefficients
    made, once there; for any other ``F`` and ``d_extra`` that is done on
    each call on the card.  ``block_y`` and ``interpret`` are the
    reference's Pallas options and are ignored.
    """
    if color not in (0, 1):
        raise ValueError(f"color must be 0 or 1; got {color!r}")
    if not T.is_cuda:
        if T.device.type != "cpu":
            raise ValueError(f"unsupported device {T.device}")
        return rb_line_sweep_plain(T, b, F, d_extra, color)
    if (type(F) is FieldPack and d_extra is not None
            and F.__dict__.get("smoother_extra") is d_extra):
        coef = F.smoother_coefficients
    else:
        F, coef = _checked_coefficients(F, d_extra)
    dev = F.device_index
    if (T.shape != F.shape or T.dtype != torch.float32
            or T.get_device() != dev or b.shape != F.shape
            or b.dtype != torch.float32 or b.get_device() != dev):
        raise ValueError(f"T and b must be float32 tensors of the fields' "
                         f"shape {tuple(F.shape)} on {F.data.device}; got "
                         f"{T.dtype} {tuple(T.shape)} on {T.device} and "
                         f"{b.dtype} {tuple(b.shape)} on {b.device}")
    L, NY, NX = F.layers_y_x
    T = T.contiguous()
    b = b.contiguous()
    out = torch.empty_like(T)
    n = T.numel()
    if n == 0:
        return out
    if coef.numel() >= 2 ** 31:
        raise NotImplementedError(f"{n} cells: the kernel indexes the "
                                  f"coefficients with 32-bit integers")
    rc = _sweep_fn()(T.data_ptr(), b.data_ptr(), coef.data_ptr(),
                     out.data_ptr(), n // (L * NY * NX), L, NY, NX, color,
                     _build.stream(dev))
    if rc:
        _build.check(rc, "mg_rb_line_sweep")
    rb_line_sweep.launches += 1
    return out


rb_line_sweep.launches = 0


_SWEEP_FN = None


def _sweep_fn():
    """The kernel's ctypes entry, typed and resolved once."""
    global _SWEEP_FN
    if _SWEEP_FN is None:
        fn = _build.load("mg_smooth").mg_rb_line_sweep
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        _SWEEP_FN = fn
    return _SWEEP_FN
