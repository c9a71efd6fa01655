"""The AP megakernel's op-group model and its plain PyTorch executor.

A *group* is a static micro-program over one AP array: a table of ops,
each one silicon cycle-accurate against :mod:`repro_torch.core.engine`'s
``state_compare`` / ``state_write`` / ``state_run`` chain:

* ``OP_PASS``     — COMPARE + tagged WRITE with the *fresh* match tag
                    (one schedule pass; the persistent TAG is untouched)
* ``OP_CMP``      — COMPARE into the persistent TAG
* ``OP_CMP_TAG``  — COMPARE ANDed into the persistent TAG
                    (``restrict_to_tag=True``)
* ``OP_WRITE``    — tagged WRITE using the persistent TAG

plus two execution predicates that make data-dependent inner loops (the
sort/knn response-counter branches) expressible as a *static* table:

* ``cond[p] == 0`` — always execute;
* ``cond[p] == k`` (k in 1..MAX_COND) — execute iff the op ``k`` slots
  back matched at least one row (``matched[p-k] > 0``, the response
  counter the paper's controller branches on);

and a dynamic ``enabled[p]`` mask for shape-bucketed padding (a disabled
op leaves all state untouched and reports ``matched = 0``).

``matched[p]`` is the popcount of the tag the op acted with — the fresh
compare tag for PASS/CMP ops, the persistent TAG for WRITE.

:func:`group_scan_plain` is the plain version of the CUDA kernel in
``csrc/ap_megakernel.cu`` (which :mod:`.ops` launches for planes on a
card): the CPU runs it, and ``chip_smoke.py`` holds the kernel to it.

:func:`group_scan_plain_sharded` is the plain version of the lane-sharded
group (the reference's ``group_scan`` with ``axis_name``): the planes
and tag split over shards of lanes, each op's count summed over the
shards before any predicate reads it.

Port note: planes, tags and keys are int32 holding the reference's
uint32 bits, and a broadcast key bit is ``-key``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import bitplane as bp

OP_PASS, OP_CMP, OP_CMP_TAG, OP_WRITE = 0, 1, 2, 3

#: deepest conditional lookback a group may use
MAX_COND = 4


@dataclasses.dataclass(frozen=True)
class OpGroup:
    """A static AP micro-program (host-side numpy tables).

    Column tables are padded by repeating entry 0, which is idempotent
    for both compare (re-ANDing an identical XNOR term) and write
    (re-storing the same value) — the :class:`~repro_torch.core.engine.
    PassSchedule` padding contract.  WRITE ops carry a dummy compare
    column (col 0, key 0) and CMP ops a dummy write column; the executors
    never apply the unused half.
    """
    op: np.ndarray        # int32[P]
    cond: np.ndarray      # int32[P]
    cmp_cols: np.ndarray  # int32[P, Kc]
    cmp_key: np.ndarray   # uint32[P, Kc]
    w_cols: np.ndarray    # int32[P, Kw]
    w_key: np.ndarray     # uint32[P, Kw]

    @property
    def n_ops(self) -> int:
        return int(self.op.shape[0])

    @property
    def conditional(self) -> bool:
        return bool(self.cond.max(initial=0) > 0)

    def tables(self) -> tuple:
        """The six table arrays, in executor argument order."""
        return (self.op, self.cond, self.cmp_cols, self.cmp_key,
                self.w_cols, self.w_key)

    @staticmethod
    def build(ops: Sequence[tuple]) -> "OpGroup":
        """ops: (opcode, cond, cmp_cols, cmp_key, w_cols, w_key) per op.

        CMP ops may pass empty write lists and WRITE ops empty compare
        lists; dummy entries are substituted.  Raises on an empty group
        and on conditions outside [0, MAX_COND] or reaching before op 0.
        """
        if not ops:
            raise ValueError("empty op group")
        norm = []
        for p, (opc, cond, cc, ck, wc, wk) in enumerate(ops):
            if opc not in (OP_PASS, OP_CMP, OP_CMP_TAG, OP_WRITE):
                raise ValueError(f"unknown opcode {opc!r}")
            if not 0 <= cond <= MAX_COND:
                raise ValueError(f"cond {cond} outside [0, {MAX_COND}]")
            if cond > p:
                raise ValueError(f"op {p} cond {cond} reaches before op 0")
            cc, ck = (list(cc), list(ck)) if len(list(cc)) else ([0], [0])
            wc, wk = (list(wc), list(wk)) if len(list(wc)) else ([cc[0]], [0])
            norm.append((opc, cond, cc, ck, wc, wk))
        Kc = max(len(o[2]) for o in norm)
        Kw = max(len(o[4]) for o in norm)

        def pad(vals, K):
            return vals + [vals[0]] * (K - len(vals))

        return OpGroup(
            np.array([o[0] for o in norm], np.int32),
            np.array([o[1] for o in norm], np.int32),
            np.array([pad(o[2], Kc) for o in norm], np.int32),
            np.array([pad(o[3], Kc) for o in norm], np.uint32),
            np.array([pad(o[4], Kw) for o in norm], np.int32),
            np.array([pad(o[5], Kw) for o in norm], np.uint32),
        )

    @staticmethod
    def from_schedule(cmp_cols, cmp_key, w_cols, w_key) -> "OpGroup":
        """A pass schedule (already shape-bucketed) as all-PASS ops."""
        cmp_cols = np.asarray(cmp_cols, np.int32)
        P = cmp_cols.shape[0]
        if P == 0:
            raise ValueError("empty op group")
        return OpGroup(np.zeros(P, np.int32) + OP_PASS,
                       np.zeros(P, np.int32),
                       cmp_cols, np.asarray(cmp_key, np.uint32),
                       np.asarray(w_cols, np.int32),
                       np.asarray(w_key, np.uint32))

    @staticmethod
    def probes(cols, keys) -> "OpGroup":
        """A batch of plain COMPAREs (hist bins / spmv reductions)."""
        cols = np.atleast_2d(np.asarray(cols, np.int32))
        keys = np.atleast_2d(np.asarray(keys, np.uint32))
        P = cols.shape[0]
        if P == 0:
            raise ValueError("empty op group")
        return OpGroup(np.zeros(P, np.int32) + OP_CMP,
                       np.zeros(P, np.int32),
                       cols, keys, cols[:, :1], np.zeros((P, 1), np.uint32))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def _lane_mask(key: int) -> int:
    """A key as the int32 lane mask ``-key`` (the reference's
    ``key * 0xFFFFFFFF`` modulo 2^32, as a signed 32-bit value)."""
    m = (-int(key)) & 0xFFFFFFFF
    return m - (1 << 32) if m >> 31 else m


def group_scan_plain(planes: torch.Tensor, tag: torch.Tensor, tables,
                     enabled=None) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the megakernel: the ops in order.

    planes : int32[n_bits, n_lanes];  tag : int32[n_lanes]
    tables : the six OpGroup arrays (NumPy or tensors)
    enabled: optional bool[P] op mask (default: all on)
    Returns (planes', tag', matched int32[P], executed bool[P]); the
    inputs are left unchanged.

    Each op's predicate is read on the host from the counts of the ops
    before it.  Within one op the writes happen in k order, so a column
    listed twice ends with its LAST key — the kernel's sequential
    read-modify-write.
    """
    (planes,), (tag,), matched, executed = group_scan_plain_sharded(
        [planes], [tag], tables, enabled)
    return planes, tag, matched, executed


def group_scan_plain_sharded(planes: Sequence[torch.Tensor],
                             tag: Sequence[torch.Tensor], tables,
                             enabled=None) -> tuple:
    """:func:`group_scan_plain` over lane shards: ``planes[s]`` int32
    ``[n_bits, lanes_s]`` and ``tag[s]`` ``[lanes_s]`` on any devices.

    Each op runs on every shard, and its count is the sum of the shards'
    popcounts, taken before any later op's predicate reads it (the
    reference's ``psum`` in ``group_scan(axis_name=)``), so the result is
    the unsharded group's on the lanes laid side by side.  Returns
    (planes' list, tag' list, matched int32[P], executed bool[P]), the
    counts on the first shard's device.
    """
    op, cond, cc, ck, wc, wk = (_host(t) for t in tables)
    P = int(op.shape[0])
    en = np.ones(P, bool) if enabled is None else _host(enabled).astype(bool)
    dev = planes[0].device
    planes = [p.clone() for p in planes]
    tag = [t.clone() for t in tag]
    matched = [0] * P
    executed = [False] * P
    for p in range(P):
        opc, cnd = int(op[p]), int(cond[p])
        prev = 1 if cnd == 0 else (matched[p - cnd] if p >= cnd else 0)
        if not (en[p] and prev > 0):
            continue
        executed[p] = True
        for s in range(len(planes)):
            pl, tg = planes[s], tag[s]
            fresh = None
            if opc != OP_WRITE:
                fresh = torch.full_like(tg, -1)
                for c, k in zip(cc[p].tolist(), ck[p].tolist()):
                    fresh = fresh & ~(pl[c] ^ _lane_mask(k))
                if opc == OP_CMP_TAG:
                    fresh = fresh & tg
            wtag = tg if opc == OP_WRITE else fresh
            matched[p] += int(bp.popcount(wtag))
            if opc in (OP_PASS, OP_WRITE):
                for c, k in zip(wc[p].tolist(), wk[p].tolist()):
                    pl[c] = (pl[c] & ~wtag) | (_lane_mask(k) & wtag)
            if opc in (OP_CMP, OP_CMP_TAG):
                tag[s] = fresh
    return (planes, tag, torch.tensor(matched, dtype=torch.int32, device=dev),
            torch.tensor(executed, dtype=torch.bool, device=dev))


def executed_ops(cond: torch.Tensor, enabled: torch.Tensor,
                 matched: torch.Tensor) -> torch.Tensor:
    """Which ops of a group ran, from its ``matched`` counts (bool[P], or
    [R, P] for the counts of R runs of the group).

    An op ran iff it was enabled and its condition held on the count of
    the op ``cond`` slots back — exactly the predicate the executors
    applied.  Computed with tensor ops on the counts' device, so a
    device program needs no host read to get it.
    """
    P = cond.shape[0]
    src = torch.arange(P, device=cond.device) - cond.long()
    prev = matched[..., src.clamp(min=0)]
    ok = (cond == 0) | ((src >= 0) & (prev > 0))
    return enabled.bool() & ok


def counter_delta(op: torch.Tensor, matched: torch.Tensor,
                  executed: torch.Tensor) -> torch.Tensor:
    """Packed int32[N_COUNTERS] delta a group contributes on device
    ([R, N_COUNTERS] for the counts of R runs, ``matched`` and
    ``executed`` [R, P]).

    Mirrors what the ``state_*`` op chain would accumulate: a PASS is a
    compare + a write cycle, CMP/WRITE one cycle each; every non-WRITE
    op's matched count feeds CTR_MATCH (``state_write`` never does).
    """
    from repro_torch.core import engine as E

    ex = executed.to(torch.int32)
    is_pass = (op == OP_PASS).to(torch.int32)
    is_wr = (op == OP_WRITE).to(torch.int32)
    parts = [None] * E.N_COUNTERS
    parts[E.CTR_CYCLES] = (ex * (1 + is_pass)).sum(-1)
    parts[E.CTR_COMPARE] = (ex * (1 - is_wr)).sum(-1)
    parts[E.CTR_WRITE] = (ex * (is_pass | is_wr)).sum(-1)
    parts[E.CTR_READ] = torch.zeros(ex.shape[:-1], dtype=torch.int64,
                                    device=op.device)
    parts[E.CTR_MATCH] = (matched.to(torch.int32) * (1 - is_wr)).sum(-1)
    return torch.stack(parts, dim=-1).to(torch.int32)
