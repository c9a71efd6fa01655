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
reference package) or raises — it never falls back.  A shape a kernel
cannot take (past its 32-bit indices or its grid), which the reference
runs, raises ``NotImplementedError``; a bad argument raises
``ValueError``.  Each wrapper's
``.launches`` counts its kernel launches (``apply_operator.launches``
counts the uniform kernel's, whichever of its two entries launched it).

The seven face fields go to the kernel as one contiguous pack
``[7, ...]`` (:class:`FieldPack`, made by :func:`pack_fields`).  A pack is
checked once, where it is built (``thermal.Grid.fields``, the replay's
case batch, every multigrid level), so a launch on it checks only ``T``;
a plain dict of seven tensors is packed, and checked, on every call.  The
uniform stencil's four per-layer vectors go the same way, as one ``[4,
L]`` pack (:class:`LayerVectors`, which :func:`vectors` returns); four
loose tensors are packed, and checked, on every call.
"""
from __future__ import annotations

import ctypes

import numpy as np
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


class FieldPack(dict):
    """The seven face fields as views into one contiguous float32 tensor
    ``data`` of shape ``[7, *shape]`` (``FIELD_KEYS`` order).

    It is the dict of seven tensors every caller reads (``F["gx_lf"]``
    and so on are views of ``data``, so an in-place change to one shows in
    the other), checked once when :func:`pack_fields` builds it.  Keys
    cannot be replaced.
    """

    def __init__(self, data: torch.Tensor):
        super().__init__(zip(FIELD_KEYS, data.unbind(0)))
        self.data = data
        self.shape = data.shape[1:]
        self.layers_y_x = tuple(self.shape[-3:])     # L, NY, NX
        self.device_index = data.get_device()

    def __reduce__(self):    # copies and pickles rebuild the views
        return FieldPack, (self.data,)

    def _frozen(self, *_):
        raise TypeError("a FieldPack's fields are views of one tensor; "
                        "build a new pack with pack_fields")

    __setitem__ = __delitem__ = update = pop = popitem = setdefault = \
        clear = _frozen


def pack_fields(F: dict) -> FieldPack:
    """``F`` as a :class:`FieldPack` (``F`` itself if it is one).

    Every field must be a float32 tensor of one shape ``[L, NY, NX]`` or
    ``[B, L, NY, NX]`` on one device; one copy stacks them.
    """
    if type(F) is FieldPack:
        return F
    fields = [F[k] for k in FIELD_KEYS]
    g0 = fields[0]
    for k, g in zip(FIELD_KEYS, fields):
        if (not torch.is_tensor(g) or g.dim() not in (3, 4)
                or g.shape != g0.shape or g.dtype != torch.float32
                or g.device != g0.device):
            raise ValueError(
                f"field {k} must be a float32 tensor [L,NY,NX] or "
                f"[B,L,NY,NX] of {FIELD_KEYS[0]}'s shape "
                f"{tuple(g0.shape)} on {g0.device}; got "
                f"{getattr(g, 'dtype', type(g))} "
                f"{tuple(getattr(g, 'shape', ()))} on "
                f"{getattr(g, 'device', None)}")
    return FieldPack(torch.stack(fields))


def apply_operator_fields(T: torch.Tensor, F: dict, *, block_y: int = 32,
                          interpret: bool = True) -> torch.Tensor:
    """y = G T for ``T`` of shape [L, NY, NX] or [B, L, NY, NX]; every
    field of ``F`` has T's shape, dtype and device.  Pass a
    :class:`FieldPack` on a hot path: a plain dict is packed anew on each
    call on the card.  ``block_y`` and ``interpret`` are the reference's
    Pallas options and are ignored."""
    if not T.is_cuda:
        if T.device.type != "cpu":
            raise ValueError(f"unsupported device {T.device}")
        return apply_operator_fields_plain(T, F)
    if type(F) is not FieldPack:
        F = pack_fields(F)
    if (T.shape != F.shape or T.dtype != torch.float32
            or T.get_device() != F.device_index):
        raise ValueError(f"T must be float32 of the fields' shape "
                         f"{tuple(F.shape)} on {F.data.device}; got "
                         f"{T.dtype} {tuple(T.shape)} on {T.device}")
    T = T.contiguous()
    y = torch.empty_like(T)
    n = T.numel()
    if n == 0:
        return y
    if 7 * n >= 2 ** 31:
        raise NotImplementedError(f"{n} cells: the kernel indexes the "
                                  f"pack with 32-bit integers")
    rc = _fields_fn()(T.data_ptr(), F.data.data_ptr(), y.data_ptr(), n,
                      *F.layers_y_x, _build.stream(F.device_index))
    if rc:
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


VECTOR_KEYS = ("g_lat", "gv_up", "gv_dn", "g_pkg")


class LayerVectors(tuple):
    """The uniform stencil's four per-layer float32 ``[L]`` vectors
    (``VECTOR_KEYS`` order) as views of one contiguous tensor ``data`` of
    shape ``[4, L]``, checked once when :func:`pack_vectors` builds it.
    It unpacks as the four vectors."""

    def __new__(cls, data: torch.Tensor):
        self = super().__new__(cls, data.unbind(0))
        self.data = data
        self.n_layers = data.shape[1]
        self.device_index = data.get_device()
        self.ptr = data.data_ptr()
        self.launch = {}         # T's shape -> the kernel's checked dims
        return self

    def __reduce__(self):    # copies and pickles rebuild the views
        return LayerVectors, (self.data,)


def pack_vectors(vecs) -> LayerVectors:
    """``vecs`` as a :class:`LayerVectors` (``vecs`` itself if it is one):
    four float32 tensors of one shape ``[L]`` on one device, stacked by
    one copy."""
    if type(vecs) is LayerVectors:
        return vecs
    if len(vecs) != 4:
        raise TypeError(f"the uniform stencil takes four per-layer vectors "
                        f"{VECTOR_KEYS}; got {len(vecs)}")
    v0 = vecs[0]
    for name, v in zip(VECTOR_KEYS, vecs):
        if (not torch.is_tensor(v) or v.dim() != 1 or v.shape != v0.shape
                or v.dtype != torch.float32 or v.device != v0.device):
            raise ValueError(
                f"{name} must be a float32 [L] tensor of {VECTOR_KEYS[0]}'s "
                f"shape {tuple(getattr(v0, 'shape', ()))} on "
                f"{getattr(v0, 'device', None)}; got "
                f"{getattr(v, 'dtype', type(v))} "
                f"{tuple(getattr(v, 'shape', ()))} on "
                f"{getattr(v, 'device', None)}")
    return LayerVectors(torch.stack(vecs))


def vectors(L: int, g_lat, g_vert, g_pkg, device="cpu") -> LayerVectors:
    """Scalar-or-vector conductances -> the uniform stencil's four float32
    [L] per-layer vectors (g_lat, gv_up, gv_dn, g_pkg) on ``device``, as
    one checked :class:`LayerVectors` pack: ``g_lat`` scalar or [L],
    ``g_vert`` scalar or [L-1] (interfaces, top to bottom), ``g_pkg`` a
    scalar on the last layer."""
    as32 = lambda x: torch.as_tensor(np.asarray(x, np.float32)
                                     if not torch.is_tensor(x) else x,
                                     dtype=torch.float32, device=device)
    g_lat = as32(g_lat).expand(L).contiguous()
    g_vert = as32(g_vert).expand(max(L - 1, 1))[: L - 1]
    zero = torch.zeros(1, dtype=torch.float32, device=device)
    gv_u = torch.cat([zero, g_vert])
    gv_d = torch.cat([g_vert, zero])
    g_pkg_vec = torch.zeros(L, dtype=torch.float32, device=device)
    g_pkg_vec[-1] = float(g_pkg)
    return pack_vectors((g_lat, gv_u, gv_d, g_pkg_vec))


def apply_operator(T: torch.Tensor, g_lat, g_vert, g_pkg, *,
                   block_y: int = 32, interpret: bool = True
                   ) -> torch.Tensor:
    """y = G T of the uniform-per-layer stencil (the reference's
    contract): ``g_lat`` scalar or [L], ``g_vert`` scalar or [L-1],
    ``g_pkg`` a scalar.  ``block_y`` and ``interpret`` are the reference's
    Pallas options and are ignored: the tensor's device picks the kernel
    or the plain version."""
    return apply_operator_vectors(
        T, vectors(T.shape[-3], g_lat, g_vert, g_pkg, T.device))


def apply_operator_vectors(T: torch.Tensor, *vecs) -> torch.Tensor:
    """y = G T of the uniform-per-layer stencil for ``T`` of shape
    [L, NY, NX] or [B, L, NY, NX], shared by the batch, from one
    :class:`LayerVectors` pack on T's device (:func:`vectors` builds it
    once; a launch on it checks only ``T``, and a shape once) or from four
    loose float32 [L] tensors (g_lat, gv_up, gv_dn, g_pkg), packed and
    checked on each call on the card.  Its launches count on
    ``apply_operator.launches``."""
    V = vecs[0] if len(vecs) == 1 else vecs
    if not T.is_cuda:
        if T.device.type != "cpu":
            raise ValueError(f"unsupported device {T.device}")
        return apply_operator_plain(T, *V)
    if type(V) is not LayerVectors:
        V = pack_vectors(V)
    if T.dtype != torch.float32 or T.get_device() != V.device_index:
        raise ValueError(f"T must be float32 on {V.data.device}; got "
                         f"{T.dtype} on {T.device}")
    dims = V.launch.get(T.shape)
    if dims is None:
        dims = V.launch.setdefault(T.shape, _uniform_dims(T.shape,
                                                          V.n_layers))
    if not T.is_contiguous():
        T = T.contiguous()
    y = torch.empty_like(T)
    if not dims:
        return y
    rc = _uniform_fn()(T.data_ptr(), V.ptr, y.data_ptr(), *dims,
                       _build.stream(V.device_index))
    if rc:
        _build.check(rc, "thermal_stencil_uniform")
    apply_operator.launches += 1
    return y


def _uniform_dims(shape, n_layers: int) -> tuple:
    """The uniform kernel's (B, L, NY, NX) for ``T`` of ``shape``, checked
    against the pack's ``n_layers`` and the kernel's 32-bit indexing and
    grid limits; ``()`` for an empty ``T``."""
    if len(shape) not in (3, 4) or shape[-3] != n_layers:
        raise ValueError(f"T must be [L,NY,NX] or [B,L,NY,NX] with L = "
                         f"{n_layers}; got {tuple(shape)}")
    L, NY, NX = shape[-3:]
    B = shape[0] if len(shape) == 4 else 1
    n = B * L * NY * NX
    if n == 0:
        return ()
    if n >= 2 ** 31 or B * L > 65535 or NY > 8 * 65535:
        raise NotImplementedError(
            f"T {tuple(shape)}: the kernel indexes cells with 32-bit "
            f"integers and takes at most 65535 planes and 8 * 65535 rows")
    return B, L, NY, NX


apply_operator.launches = 0


_FIELDS_FN = _UNIFORM_FN = None


def _fields_fn():
    """The fields kernel's ctypes entry, resolved once."""
    global _FIELDS_FN
    if _FIELDS_FN is None:
        _FIELDS_FN = _lib().thermal_stencil_fields
    return _FIELDS_FN


def _uniform_fn():
    """The uniform kernel's ctypes entry, resolved once."""
    global _UNIFORM_FN
    if _UNIFORM_FN is None:
        _UNIFORM_FN = _lib().thermal_stencil_uniform
    return _UNIFORM_FN


def _lib() -> ctypes.CDLL:
    lib = _build.load("thermal_stencil")
    fn = lib.thermal_stencil_fields
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    fn = lib.thermal_stencil_uniform
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    return lib
