"""Packed bit-plane representation of the Associative Processing Array.

The AP (paper Fig. 1) is an array of ``n_words`` rows x ``n_bits`` columns
of associative bit cells; a word-row is a Processing Unit (PU).  Compare
and tagged-write act on *columns* across *all rows* at once, so the
layout is column-major bit planes:

    planes : int32[n_bits, n_words // 32]

plane ``i`` holds bit-column ``i`` for every word, packed 32 words per
lane.  The TAG register is a packed ``int32[n_words // 32]`` vector.

Port note: the reference stores uint32; CPU PyTorch lacks ``~``, shifts
and comparisons on uint32, so planes, tags and keys are int32 holding the
same bits.  A broadcast key bit is ``-key`` (0 or all ones), exactly the
reference's ``key * 0xFFFFFFFF`` modulo 2^32.  Host packing works on
NumPy ``uint32``/``uint64`` and hands ``.view(np.int32)`` to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

LANE = 32  # words packed per 32-bit lane


def n_lanes(n_words: int) -> int:
    if n_words % LANE != 0:
        raise ValueError(f"n_words must be a multiple of {LANE}, got {n_words}")
    return n_words // LANE


def alloc_planes(n_bits: int, n_words: int,
                 device: torch.device | str) -> torch.Tensor:
    """All-zero associative array."""
    return torch.zeros((n_bits, n_lanes(n_words)), dtype=torch.int32,
                       device=device)


# ---------------------------------------------------------------------------
# host <-> bitplane conversion
# ---------------------------------------------------------------------------

def pack_words(values: np.ndarray, n_bits: int) -> np.ndarray:
    """Pack integer words ``values[n_words]`` into host bit planes
    int32[n_bits, n_words/32] (the uint32 bits).

    Bit ``i`` of word ``w`` lands in ``planes[i, w // 32]`` at lane-bit
    ``w % 32``.  Host-side NumPy, so fields up to 64 bits wide work.
    """
    if n_bits > 64:
        raise ValueError(
            f"fields wider than 64 bits cannot be packed from uint64 host "
            f"words (got width {n_bits}); split the value across fields")
    values = np.asarray(values).astype(np.uint64)
    nl = n_lanes(values.shape[0])
    bits = (values[None, :] >> np.arange(n_bits, dtype=np.uint64)[:, None]) & 1
    bits = bits.astype(np.uint32).reshape(n_bits, nl, LANE)
    shifts = np.arange(LANE, dtype=np.uint32)
    packed = (bits << shifts[None, None, :]).sum(axis=-1, dtype=np.uint32)
    return packed.view(np.int32)


def unpack_words(planes: torch.Tensor | np.ndarray,
                 out_dtype=np.uint64) -> np.ndarray:
    """Inverse of :func:`pack_words` -> integer words [n_words] (host)."""
    if isinstance(planes, torch.Tensor):
        planes = planes.cpu().numpy()
    pl = np.ascontiguousarray(planes).view(np.uint32)
    n_bits, nl = pl.shape
    shifts = np.arange(LANE, dtype=np.uint32)
    bits = (pl[:, :, None] >> shifts[None, None, :]) & 1  # [bits, nl, LANE]
    bits = bits.reshape(n_bits, nl * LANE).astype(out_dtype)
    weights = (out_dtype(1) << np.arange(n_bits, dtype=out_dtype))
    return (bits * weights[:, None]).sum(axis=0, dtype=out_dtype)


def pack_bits(bitvec: torch.Tensor) -> torch.Tensor:
    """Pack a boolean vector [n_words] into a packed tag row [n_words/32]."""
    nl = n_lanes(bitvec.shape[0])
    bits = bitvec.to(torch.int64).reshape(nl, LANE)
    shifts = torch.arange(LANE, dtype=torch.int64, device=bitvec.device)
    row = (bits << shifts).sum(dim=-1)
    return (row - ((row >> 31) << 32)).to(torch.int32)


def unpack_bits(row: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bits` -> bool [n_words]."""
    shifts = torch.arange(LANE, dtype=torch.int32, device=row.device)
    return ((row[:, None] >> shifts) & 1).reshape(-1).bool()


def popcount(row: torch.Tensor) -> torch.Tensor:
    """Number of set word-bits in a packed row (e.g. matched PUs in TAG).

    SWAR bit count in int64 on the uint32 bits: in int32 the sign
    extension of ``>>`` and the overflow of the final multiply would give
    wrong counts.  Returns a 0-d int64 tensor on the row's device.
    """
    x = row.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).sum()


def _bcast(key: torch.Tensor) -> torch.Tensor:
    """Key bits [K] -> lane masks [K, 1]: 0 or all ones."""
    return (-key.to(torch.int32))[:, None]


# ---------------------------------------------------------------------------
# the three silicon primitives: COMPARE, tagged WRITE, broadcast WRITE.
# Each is ONE AP cycle regardless of the number of active columns — cycle
# cost lives in the engine.  All three return new tensors.
# ---------------------------------------------------------------------------

def compare(planes: torch.Tensor, cols: torch.Tensor, key: torch.Tensor,
            tag_in: torch.Tensor | None = None) -> torch.Tensor:
    """Match ``key`` against columns ``cols`` of every word -> packed TAG.

    cols : int[K] column indices (the unmasked columns)
    key  : int[K] key bits (0/1) for those columns
    tag_in : optional packed row; if given the result is ANDed into it
             (models compare restricted to previously tagged rows).
    """
    eq = ~(planes[cols] ^ _bcast(key))                    # per-bit XNOR
    tag = eq[0]
    for i in range(1, eq.shape[0]):
        tag = tag & eq[i]
    if tag_in is not None:
        tag = tag & tag_in
    return tag


def tagged_write(planes: torch.Tensor, tag: torch.Tensor, cols: torch.Tensor,
                 key: torch.Tensor) -> torch.Tensor:
    """Parallel write of ``key`` into columns ``cols`` of all tagged words."""
    old = planes[cols]
    new = (old & ~tag[None, :]) | (_bcast(key) & tag[None, :])
    out = planes.clone()
    out[cols] = new
    return out


def broadcast_write(planes: torch.Tensor, cols: torch.Tensor,
                    key: torch.Tensor) -> torch.Tensor:
    """Write ``key`` into columns ``cols`` of ALL words (tag = all ones)."""
    out = planes.clone()
    out[cols] = _bcast(key).expand(cols.shape[0], planes.shape[1])
    return out


def set_field_planes(planes: torch.Tensor, sub: torch.Tensor,
                     start: int) -> torch.Tensor:
    """Store packed field planes ``sub`` at bit-column ``start``."""
    out = planes.clone()
    out[start:start + sub.shape[0]] = sub
    return out


# ---------------------------------------------------------------------------
# Field: a named range of bit-columns.  Shifts are free on the AP — "shift is
# implemented by activating different bit columns" (§2.2) — so a shifted view
# is just a new Field with offset column indices.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Field:
    start: int
    width: int

    def col(self, i: int) -> int:
        if not 0 <= i < self.width:
            raise IndexError(f"bit {i} out of field width {self.width}")
        return self.start + i

    def cols(self) -> list[int]:
        return list(range(self.start, self.start + self.width))

    def bit(self, i: int) -> "Field":
        return Field(self.col(i), 1)

    def slice(self, lo: int, width: int) -> "Field":
        if lo + width > self.width:
            raise IndexError("slice outside field")
        return Field(self.start + lo, width)

    def shifted(self, k: int) -> "Field":
        """View of this field shifted left by k columns (zero-cost AP shift)."""
        return Field(self.start + k, self.width)


class FieldAllocator:
    """Trivial bump allocator for bit-columns of the associative word."""

    def __init__(self, n_bits: int):
        self.n_bits = n_bits
        self._next = 0

    def alloc(self, width: int, name: str = "") -> Field:
        if self._next + width > self.n_bits:
            raise MemoryError(
                f"associative word overflow allocating {width} cols for {name!r}: "
                f"{self._next}/{self.n_bits} used")
        f = Field(self._next, width)
        self._next += width
        return f

    @property
    def used(self) -> int:
        return self._next
