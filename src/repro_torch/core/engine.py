"""The Associative Processor machine model (PyTorch port).

Implements the three silicon operations of the paper's AP (§2.1):

* COMPARE  — key/mask match against all rows, result into TAG (1 cycle)
* WRITE    — parallel write of key into masked columns of all TAGGED rows (1 cycle)
* BWRITE   — broadcast write into masked columns of ALL rows (1 cycle)

plus sequential row read (1 cycle / row, §2.1).

A *pass* = COMPARE cycle followed by WRITE cycle (paper Table 1 footnote).
Arithmetic routines (isa.py / arith.py / apfloat.py) compile to *pass
schedules* — static tables of (compare cols/key, write cols/key) — which
:meth:`APEngine.run` executes through ``kernels/ap_match`` (the CUDA
kernel on a card, its plain version on the CPU).

Bookkeeping is exact and stays on the host, as in the reference: cycles
are Python ints, and the per-pass matched-row counts come back from the
device once per ``run`` and fold into float64 NumPy energies with the
reference's formulas, so energies, events and trace arrays are bit
identical to the reference package's.

The functional core (:class:`APState` and the ``state_*`` ops) lets the
device programs of ``workloads/_device.py`` keep a data-dependent inner
loop on the device: per-pass matched counts and the packed counters stay
there and cross to the host once per workload phase.

Port note: the device is chosen by the keyword-only ``device``;
``backend`` takes the reference's names (:attr:`APEngine.BACKENDS`) and
only picks which kernel :meth:`APEngine.run` executes a schedule with —
the pass-schedule kernel ``kernels/ap_match`` for ``"jnp"`` and
``"pallas"``, the op-group megakernel for ``"megakernel"`` and
``"megakernel_pallas"``.  On a card each is the hand-written kernel, on
the CPU its plain version; every path is bit-identical.  Lane sharding
(``n_shards``, megakernel backend only) splits the planes' lanes over
``n_shards`` local devices of the engine's device type
(:attr:`APEngine.mesh`); the engine keeps its planes whole on ``device``
and each megakernel group runs sharded
(``kernels.ap_megakernel.ops.run_group(mesh=)``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import bitplane as bp
from repro_torch.core.bitplane import Field, FieldAllocator
from repro_torch.kernels.ap_match import ops as ap_ops
from repro_torch.kernels.ap_megakernel import ops as mk_ops
from repro_torch.kernels.ap_megakernel.ref import OpGroup


def bin_energy_trace(cycles: np.ndarray, energy: np.ndarray,
                     total_cycles: int, n_intervals: int
                     ) -> tuple[float, np.ndarray]:
    """Bin (cycle, energy) events into equal windows over [0, total_cycles].

    ``cycles`` holds 1-based completion cycles.  Energy-conserving: the
    returned bins sum to ``energy.sum()`` exactly.  Shared by
    :meth:`APEngine.power_trace` and ``cosim.trace_from_counters``.
    """
    interval = max(int(total_cycles), 1) / n_intervals
    bins = np.zeros(n_intervals, np.float64)
    cycles = np.asarray(cycles, np.int64)
    if cycles.size:
        idx = np.minimum(((cycles - 1) / interval).astype(np.int64),
                         n_intervals - 1)
        np.add.at(bins, idx, np.asarray(energy, np.float64))
    return interval, bins


@dataclasses.dataclass(frozen=True)
class PowerParams:
    """Table 3 of the paper (normalized to SRAM-cell write power = 1)."""
    p_sram_cell_uW: float = 0.5   # absolute anchor: 1 unit = 0.5 uW
    p_m: float = 0.1              # per-bit energy, matched row, compare
    p_mm: float = 0.75            # per-bit energy, mismatched row (line discharge)
    p_mw: float = 0.1             # per-bit energy, miswrite (untagged row)
    p_w: float = 1.0              # per-bit energy, true write (the unit)


PAPER_POWER = PowerParams()


@dataclasses.dataclass
class PassSchedule:
    """A static table of AP passes (compare + tagged write per row).

    Columns are padded (by repetition) to the table-wide max K; ``kc``/``kw``
    keep the true active-column counts for energy accounting.
    """
    cmp_cols: np.ndarray   # int32 [P, Kc]
    cmp_key: np.ndarray    # uint32 [P, Kc]
    w_cols: np.ndarray     # int32 [P, Kw]
    w_key: np.ndarray      # uint32 [P, Kw]
    kc: np.ndarray         # int32 [P]  true compare-column counts
    kw: np.ndarray         # int32 [P]  true write-column counts

    @property
    def n_passes(self) -> int:
        return int(self.cmp_cols.shape[0])

    @staticmethod
    def build(passes: Sequence[tuple[Sequence[int], Sequence[int],
                                     Sequence[int], Sequence[int]]]
              ) -> "PassSchedule":
        """passes: list of (cmp_cols, cmp_key, w_cols, w_key) per pass."""
        if not passes:
            raise ValueError("empty pass schedule")
        kc = np.array([len(p[0]) for p in passes], np.int32)
        kw = np.array([len(p[2]) for p in passes], np.int32)
        Kc, Kw = int(kc.max()), int(kw.max())

        def pad(vals, K):
            vals = list(vals)
            return vals + [vals[0]] * (K - len(vals))

        cc = np.array([pad(p[0], Kc) for p in passes], np.int32)
        ck = np.array([pad(p[1], Kc) for p in passes], np.uint32)
        wc = np.array([pad(p[2], Kw) for p in passes], np.int32)
        wk = np.array([pad(p[3], Kw) for p in passes], np.uint32)
        return PassSchedule(cc, ck, wc, wk, kc, kw)

    @staticmethod
    def concat(schedules: Sequence["PassSchedule"]) -> "PassSchedule":
        if not schedules:
            raise ValueError("empty schedule list")
        Kc = max(s.cmp_cols.shape[1] for s in schedules)
        Kw = max(s.w_cols.shape[1] for s in schedules)

        def padcat(arrs, K):
            out = []
            for a in arrs:
                if a.shape[1] < K:
                    a = np.concatenate(
                        [a, np.repeat(a[:, :1], K - a.shape[1], axis=1)], axis=1)
                out.append(a)
            return np.concatenate(out, axis=0)

        return PassSchedule(
            padcat([s.cmp_cols for s in schedules], Kc),
            padcat([s.cmp_key for s in schedules], Kc),
            padcat([s.w_cols for s in schedules], Kw),
            padcat([s.w_key for s in schedules], Kw),
            np.concatenate([s.kc for s in schedules]),
            np.concatenate([s.kw for s in schedules]),
        )


# ---------------------------------------------------------------------------
# functional core: APState + pure ops.  The device programs of
# workloads/_device.py thread an APState through Python loops over device
# tensors, so a data-dependent inner loop never reads the card back; the
# per-pass matched counts ride along and cross to the host once per
# workload phase.
# ---------------------------------------------------------------------------

#: APState.counters layout (int32): on-device totals mirroring the host
#: counters an eager replay would accumulate (match = matched-row compare
#: events).
CTR_CYCLES, CTR_COMPARE, CTR_WRITE, CTR_READ, CTR_MATCH = range(5)
N_COUNTERS = 5

_UNITS: dict = {}


def _unit(device: torch.device, *entries: int) -> torch.Tensor:
    """A constant int32[N_COUNTERS] vector on ``device`` (cached, so a
    device program uploads it once)."""
    key = (str(device), entries)
    vec = _UNITS.get(key)
    if vec is None:
        vec = torch.tensor(entries, dtype=torch.int32, device=device)
        _UNITS[key] = vec
    return vec


@dataclasses.dataclass(frozen=True)
class APState:
    """Functional snapshot of one AP array.

    ``counters`` is a packed int32[N_COUNTERS] accumulator updated on
    device by the ``state_*`` ops, so a device program carries its
    cycle/event totals with it instead of syncing per cycle.
    """
    planes: torch.Tensor      # int32[n_bits, n_lanes]
    tag: torch.Tensor         # int32[n_lanes]
    counters: torch.Tensor    # int32[N_COUNTERS]


def state_init(n_bits: int, n_words: int, device="cuda") -> APState:
    dev = resolve_device(device)
    return APState(bp.alloc_planes(n_bits, n_words, dev),
                   torch.zeros(bp.n_lanes(n_words), dtype=torch.int32,
                               device=dev),
                   torch.zeros(N_COUNTERS, dtype=torch.int32, device=dev))


def select_state(pred: torch.Tensor, a: APState, b: APState) -> APState:
    """``a`` where pred else ``b`` — masks a whole op inside a device
    program (the on-device version of an eager host-side branch);
    ``pred`` is a 0-d bool tensor on the states' device."""
    return APState(*(torch.where(pred, x, y) for x, y in (
        (a.planes, b.planes), (a.tag, b.tag), (a.counters, b.counters))))


def state_compare(state: APState, cols: torch.Tensor, key: torch.Tensor,
                  restrict_to_tag: bool = False
                  ) -> tuple[APState, torch.Tensor]:
    """COMPARE: one cycle; returns (state', matched responder count as a
    0-d int32 tensor).  ``cols``/``key`` are tensors on the state's
    device."""
    tag = bp.compare(state.planes, cols, key,
                     state.tag if restrict_to_tag else None)
    matched = bp.popcount(tag).to(torch.int32)
    dev = state.counters.device
    ctr = state.counters + _unit(dev, 1, 1, 0, 0, 0) \
        + _unit(dev, 0, 0, 0, 0, 1) * matched
    return APState(state.planes, tag, ctr), matched


def state_write(state: APState, cols: torch.Tensor, key: torch.Tensor
                ) -> tuple[APState, torch.Tensor]:
    """WRITE into tagged rows: one cycle; returns (state', matched)."""
    planes = bp.tagged_write(state.planes, state.tag, cols, key)
    matched = bp.popcount(state.tag).to(torch.int32)
    ctr = state.counters + _unit(state.counters.device, 1, 0, 1, 0, 0)
    return APState(planes, state.tag, ctr), matched


def state_read_charge(state: APState, n_rows: torch.Tensor) -> APState:
    """Charge ``n_rows`` sequential read cycles (read_tagged on device:
    the data itself is already host-resident or rides the trace)."""
    ctr = state.counters + _unit(state.counters.device, 1, 0, 0, 1, 0) \
        * n_rows.to(torch.int32)
    return APState(state.planes, state.tag, ctr)


def state_run(state: APState, cmp_cols, cmp_key, w_cols, w_key,
              col_range: tuple[int, int] | None = None
              ) -> tuple[APState, torch.Tensor]:
    """Run a static pass table functionally; returns (state', matched[P]).

    Mirrors :meth:`APEngine.run`: the TAG register is left untouched.
    The tables are int32 tensors on the state's device; on a card the
    schedule launches ``kernels/ap_match``.  ``col_range`` passes the
    tables' known column bounds on, so the launch reads nothing back.
    """
    planes, matched = ap_ops.run_schedule(state.planes, cmp_cols, cmp_key,
                                          w_cols, w_key, col_range)
    P = cmp_cols.shape[0]
    dev = state.counters.device
    ctr = state.counters + _unit(dev, 2, 1, 1, 0, 0) * P \
        + _unit(dev, 0, 0, 0, 0, 1) * matched.sum().to(torch.int32)
    return APState(planes, state.tag, ctr), matched


def _next_pow2(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


def bucket_schedule(sched: "PassSchedule"
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pad a schedule's (P, Kc, Kw) to power-of-two buckets, as the
    reference does, so both packages run the same tables.

    Extra key columns repeat column 0 — idempotent for both compare
    (re-ANDing an identical XNOR term) and write (re-storing the same
    value).  Extra passes are no-ops: compare column 0 against key 0,
    then write 0 back into column 0 of the rows that matched — the
    planes are unchanged whatever they hold.  Padded passes' matched
    counts are sliced off before accounting, so they contribute zero
    energy and zero events.
    """
    cc, ck, wc, wk = sched.cmp_cols, sched.cmp_key, sched.w_cols, sched.w_key
    P, Kc = cc.shape
    Kw = wc.shape[1]
    if P == 0:
        raise ValueError(
            "empty pass schedule (P=0): nothing to bucket — build "
            "schedules via PassSchedule.build, which rejects empty input")
    Kc2, Kw2, P2 = _next_pow2(Kc), _next_pow2(Kw), _next_pow2(P)

    def pad_cols(a, K2):
        if a.shape[1] == K2:
            return a
        return np.concatenate(
            [a, np.repeat(a[:, :1], K2 - a.shape[1], axis=1)], axis=1)

    cc, ck = pad_cols(cc, Kc2), pad_cols(ck, Kc2)
    wc, wk = pad_cols(wc, Kw2), pad_cols(wk, Kw2)
    if P2 != P:
        cc = np.concatenate([cc, np.zeros((P2 - P, Kc2), cc.dtype)])
        ck = np.concatenate([ck, np.zeros((P2 - P, Kc2), ck.dtype)])
        wc = np.concatenate([wc, np.zeros((P2 - P, Kw2), wc.dtype)])
        wk = np.concatenate([wk, np.zeros((P2 - P, Kw2), wk.dtype)])
    return cc, ck, wc, wk


def schedule_tensors(cc, ck, wc, wk, device) -> tuple[torch.Tensor, ...]:
    """Host schedule tables -> int32 tensors on ``device`` (uint32 keys
    keep their bits).  The four tables cross in one copy: they are views
    of one packed buffer."""
    tabs = [np.ascontiguousarray(a).view(np.int32) for a in (cc, ck, wc, wk)]
    packed = torch.from_numpy(np.concatenate([t.ravel() for t in tabs]))
    packed = packed.to(device)
    out, at = [], 0
    for t in tabs:
        out.append(packed[at:at + t.size].view(t.shape))
        at += t.size
    return tuple(out)


def schedule_col_range(cc, wc) -> tuple[int, int]:
    """(least, greatest) column a host schedule's compare and write
    tables name: what ``ap_match.run_schedule`` takes as ``col_range``."""
    return (int(min(cc.min(), wc.min())), int(max(cc.max(), wc.max())))


class APEngine:
    """One Associative Processing array: n_words PUs x n_bits columns."""

    BACKENDS = ("jnp", "pallas", "megakernel", "megakernel_pallas")

    def __init__(self, n_words: int, n_bits: int = 256,
                 power: PowerParams = PAPER_POWER, collect_stats: bool = True,
                 backend: str = "jnp", n_shards: int | None = None, *,
                 device: str | torch.device = "cuda"):
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one "
                             f"of {self.BACKENDS}")
        if n_shards is not None:
            if backend != "megakernel":
                raise ValueError(
                    "n_shards requires backend='megakernel' (lane sharding "
                    "is a megakernel execution mode)")
            if bp.n_lanes(n_words) % n_shards != 0:
                raise ValueError(
                    f"n_lanes={bp.n_lanes(n_words)} not divisible by "
                    f"n_shards={n_shards}; pick n_words a multiple of "
                    f"{bp.LANE * n_shards}")
        self.device = resolve_device(device)
        self.n_shards = n_shards
        self.n_words = n_words
        self.n_bits = n_bits
        self.power = power
        self.collect_stats = collect_stats
        self.backend = backend
        self.planes = bp.alloc_planes(n_bits, n_words, self.device)
        self.tag = torch.zeros(bp.n_lanes(n_words), dtype=torch.int32,
                               device=self.device)
        self.alloc = FieldAllocator(n_bits)
        self.reset_counters()

    # ----------------------------------------------------------------- state
    def reset_counters(self):
        self.cycles = 0
        self.compare_cycles = 0
        self.write_cycles = 0
        self.bwrite_cycles = 0
        self.read_cycles = 0
        self.energy = 0.0             # normalized (SRAM write = 1)
        self.events = {"match": 0, "mismatch": 0, "write": 0, "miswrite": 0}
        # power trace: per accounted event, the cycle it completed on and its
        # energy (exact same accounting as `energy` — binned by cosim.py)
        self._trace_cycles: list = []     # ints or int64 arrays
        self._trace_energy: list = []     # floats or float64 arrays

    def counters(self) -> dict:
        out = dict(cycles=self.cycles, compare_cycles=self.compare_cycles,
                   write_cycles=self.write_cycles, bwrite_cycles=self.bwrite_cycles,
                   read_cycles=self.read_cycles, energy=self.energy)
        out.update(self.events)
        return out

    def _index(self, vals, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(vals, np.int64), dtype=dtype,
                               device=self.device)

    # ------------------------------------------------------------- data I/O
    def load(self, field: Field, values) -> None:
        """Host-side load of per-word integer values into a field (not an AP op)."""
        if field.width > 64:
            raise ValueError(
                f"cannot load a {field.width}-bit field from uint64 host "
                f"words (max 64); split the value across fields")
        vals = np.asarray(values, np.uint64)
        if vals.shape != (self.n_words,):
            raise ValueError(f"expected ({self.n_words},), got {vals.shape}")
        sub = torch.from_numpy(bp.pack_words(vals, field.width)).to(
            self.device)
        self.planes = bp.set_field_planes(self.planes, sub, field.start)

    def read(self, field: Field, signed: bool = False) -> np.ndarray:
        """Host-side readback of a field for all words (charges n read cycles)."""
        self.charge_read(self.n_words)
        vals = self.peek(field)
        if signed and field.width < 64:
            sign = vals >> (field.width - 1)
            vals = vals.astype(np.int64) - (sign.astype(np.int64) << field.width)
        return vals

    def peek(self, field: Field) -> np.ndarray:
        """Readback WITHOUT charging cycles (debug / test oracle only)."""
        sub = self.planes[field.start:field.start + field.width]
        return bp.unpack_words(sub)

    def read_tagged(self, field: Field) -> tuple[np.ndarray, np.ndarray]:
        """Sequential readout of ``field`` for the currently TAGGED rows.

        Charges 1 read cycle per tagged row (§2.1) — the associative
        "read responders" loop.  Returns (row_indices, values), both
        host numpy, ordered by row index.
        """
        rows = np.where(bp.unpack_bits(self.tag).cpu().numpy())[0]
        self.charge_read(len(rows))
        vals = self.peek(field)[rows]
        return rows, vals

    # ------------------------------------------------------ silicon ops
    def compare(self, cols: Sequence[int], key: Sequence[int],
                restrict_to_tag: bool = False) -> None:
        """COMPARE: one cycle; TAG <- match(key @ cols) [& TAG].

        Eager: with stats on, the matched count crosses to the host every
        cycle, as in the reference's oracle path.
        """
        tag_in = self.tag if restrict_to_tag else None
        self.tag = bp.compare(self.planes, self._index(cols, torch.int64),
                              self._index(key), tag_in)
        matched = int(bp.popcount(self.tag)) if self.collect_stats else 0
        self.charge_compare(len(cols), matched)

    def write(self, cols: Sequence[int], key: Sequence[int]) -> None:
        """WRITE: one cycle; key -> masked cols of all TAGGED rows."""
        self.planes = bp.tagged_write(self.planes, self.tag,
                                      self._index(cols, torch.int64),
                                      self._index(key))
        matched = int(bp.popcount(self.tag)) if self.collect_stats else 0
        self.charge_write(len(cols), matched)

    def bwrite(self, cols: Sequence[int], key: Sequence[int]) -> None:
        """Broadcast write (all rows): one cycle."""
        self.planes = bp.broadcast_write(
            self.planes, self._index(cols, torch.int64), self._index(key))
        self.cycles += 1
        self.bwrite_cycles += 1
        if self.collect_stats:
            self._account_write(len(cols), self.n_words)

    # ----------------------------------------- accounting without executing
    def charge_compare(self, k: int, matched: int) -> None:
        """Account one COMPARE cycle (k active columns, matched rows)."""
        self.cycles += 1
        self.compare_cycles += 1
        if self.collect_stats:
            self._account_compare(int(k), int(matched))

    def charge_write(self, k: int, matched: int) -> None:
        """Account one tagged-WRITE cycle (k active columns, matched rows)."""
        self.cycles += 1
        self.write_cycles += 1
        if self.collect_stats:
            self._account_write(int(k), int(matched))

    def charge_read(self, n_rows: int) -> None:
        """Account ``n_rows`` sequential read cycles (1 cycle/row, §2.1)."""
        self.read_cycles += int(n_rows)
        self.cycles += int(n_rows)

    def charge_run(self, sched: PassSchedule, matched) -> None:
        """Account a full pass schedule from its per-pass matched counts."""
        P = sched.n_passes
        self.cycles += 2 * P           # each pass = compare + write
        self.compare_cycles += P
        self.write_cycles += P
        if self.collect_stats:
            m = np.asarray(matched, np.int64)
            n = self.n_words
            kc = sched.kc.astype(np.float64)
            kw = sched.kw.astype(np.float64)
            mf = m.astype(np.float64)
            pw = self.power
            e_pass = kc * (pw.p_m * mf + pw.p_mm * (n - mf)) \
                + kw * (pw.p_w * mf + pw.p_mw * (n - mf))
            self.energy += float(e_pass.sum())
            self._trace_cycles.append(
                self.cycles - 2 * P + 2 * np.arange(1, P + 1, dtype=np.int64))
            self._trace_energy.append(e_pass)
            self.events["match"] += int(m.sum())
            self.events["mismatch"] += int(P) * n - int(m.sum())
            self.events["write"] += int((kw * mf).sum())
            self.events["miswrite"] += int((kw * (n - mf)).sum())

    def charge_bulk(self, *, cycles: int = 0, compare_cycles: int = 0,
                    write_cycles: int = 0, read_cycles: int = 0,
                    energy_terms=None, trace_cycles=None, trace_energy=None,
                    match: int = 0, mismatch: int = 0, write: int = 0,
                    miswrite: int = 0) -> None:
        """Fold a precomputed bulk replay block into the accounting.

        The vectorized counterpart of a ``charge_*`` call sequence
        (megakernel replay uses it to retire thousands of events in one
        call).  Bit-identity contract the callers uphold:

        * ``energy_terms`` (float64[n]) lists the scalar values the
          equivalent charge sequence would have added to ``energy``, in
          order — one term per scalar event, one PRE-SUMMED term per
          ``charge_run`` chunk (``np.sum`` is pairwise, so chunk sums
          must be taken per chunk, never globally).  The fold here is a
          seeded ``np.cumsum``, which accumulates float64 strictly
          sequentially — identical to the scalar ``+=`` loop.
        * ``trace_cycles``/``trace_energy`` are the absolute-cycle /
          per-event energy arrays in eager append order; they land as
          ONE trace chunk, which concatenates to the same flat arrays.
        * counter/event deltas are exact ints.
        """
        self.cycles += int(cycles)
        self.compare_cycles += int(compare_cycles)
        self.write_cycles += int(write_cycles)
        self.read_cycles += int(read_cycles)
        if not self.collect_stats:
            return
        if energy_terms is not None and len(energy_terms):
            self.energy = float(np.cumsum(np.concatenate(
                [[self.energy], np.asarray(energy_terms, np.float64)]))[-1])
        if trace_cycles is not None and len(trace_cycles):
            self._trace_cycles.append(np.asarray(trace_cycles, np.int64))
            self._trace_energy.append(np.asarray(trace_energy, np.float64))
        self.events["match"] += int(match)
        self.events["mismatch"] += int(mismatch)
        self.events["write"] += int(write)
        self.events["miswrite"] += int(miswrite)

    def clear(self, field: Field) -> None:
        self.bwrite(field.cols(), [0] * field.width)

    def set_bits(self, field: Field, value: int) -> None:
        """Broadcast an immediate constant into a field (1 cycle)."""
        key = [(value >> i) & 1 for i in range(field.width)]
        self.bwrite(field.cols(), key)

    def load_tag_column(self, col: int) -> None:
        """TAG <- column ``col`` (a 1-column compare against key=1)."""
        self.compare([col], [1])

    def tag_count(self) -> int:
        return int(bp.popcount(self.tag))

    # ------------------------------------------------------ fused schedules
    def run(self, sched: PassSchedule) -> None:
        """Execute a static pass schedule through ``kernels/ap_match``
        (backends ``"jnp"``, ``"pallas"``), or as an all-PASS op group
        through ``kernels/ap_megakernel`` (``"megakernel"``,
        ``"megakernel_pallas"``).

        The schedule shape is padded to the reference's power-of-two
        bucket (:func:`bucket_schedule`); the padded no-op passes'
        matched counts are sliced off before accounting.  The tables
        cross to the device in one copy with their column range known
        from the host, so the launch reads nothing back; the counts cross
        to the host once per call.
        """
        P = sched.n_passes
        tables = bucket_schedule(sched)
        if self.backend in ("megakernel", "megakernel_pallas"):
            self.planes, self.tag, matched = mk_ops.run_group(
                self.planes, self.tag, OpGroup.from_schedule(*tables),
                backend="pallas" if self.backend == "megakernel_pallas"
                else "jnp", mesh=self.mesh)
        else:
            self.planes, matched = ap_ops.run_schedule(
                self.planes, *schedule_tensors(*tables, self.device),
                col_range=schedule_col_range(tables[0], tables[2]))
        self.charge_run(sched, matched[:P].cpu().numpy())

    @property
    def mesh(self) -> tuple[torch.device, ...] | None:
        """The devices the lanes shard over when sharded, else None
        (``repro_torch.parallel.sharding.ap_mesh`` of the engine's device
        type)."""
        if self.n_shards is None:
            return None
        from repro_torch.parallel.sharding import ap_mesh
        return ap_mesh(self.n_shards, device=self.device)

    # -------------------------------------------------- functional bridge
    def state(self) -> APState:
        """Snapshot (planes, tag, zeroed counters) for a device program."""
        return APState(self.planes, self.tag,
                       torch.zeros(N_COUNTERS, dtype=torch.int32,
                                   device=self.device))

    def adopt(self, state: APState) -> None:
        """Adopt a device program's final array state.

        Counters are NOT folded in: the caller replays its per-pass
        matched counts through the ``charge_*`` methods so energy/event/
        trace accounting stays event-exact (the device-side
        ``state.counters`` exist to cross-check those replays).
        """
        self.planes = state.planes
        self.tag = state.tag

    # ------------------------------------------------------ energy helpers
    def _account_compare(self, k: int, matched: int) -> None:
        n = self.n_words
        pw = self.power
        e = k * (pw.p_m * matched + pw.p_mm * (n - matched))
        self.energy += e
        self._trace_cycles.append(self.cycles)
        self._trace_energy.append(e)
        self.events["match"] += matched
        self.events["mismatch"] += n - matched

    def _account_write(self, k: int, matched: int) -> None:
        n = self.n_words
        pw = self.power
        e = k * (pw.p_w * matched + pw.p_mw * (n - matched))
        self.energy += e
        self._trace_cycles.append(self.cycles)
        self._trace_energy.append(e)
        self.events["write"] += k * matched
        self.events["miswrite"] += k * (n - matched)

    # ------------------------------------------------------ power trace
    def trace_events(self) -> tuple[np.ndarray, np.ndarray]:
        """All accounted energy events so far: (cycle, energy) arrays.

        ``cycle`` is the 1-based cycle each event completed on; ``energy``
        is normalized (SRAM write = 1) and sums exactly to ``self.energy``.
        """
        if not self._trace_cycles:
            return (np.zeros(0, np.int64), np.zeros(0, np.float64))
        cyc = np.concatenate([np.atleast_1d(np.asarray(c, np.int64))
                              for c in self._trace_cycles])
        e = np.concatenate([np.atleast_1d(np.asarray(v, np.float64))
                            for v in self._trace_energy])
        return cyc, e

    def power_trace(self, n_intervals: int) -> tuple[float, np.ndarray]:
        """Bin the event trace into ``n_intervals`` equal cycle windows.

        Returns (interval_cycles, energy_per_interval[n_intervals]); the
        bins cover [0, self.cycles] and conserve total energy exactly.
        """
        cyc, e = self.trace_events()
        return bin_energy_trace(cyc, e, self.cycles, n_intervals)

    # ------------------------------------------------------ reporting
    def energy_uJ(self) -> float:
        """Absolute energy in microjoules, using the Table 3 SRAM anchor
        (1 normalized unit = P_sram-cell * one 1 ns cycle)."""
        return self.energy * self.power.p_sram_cell_uW * 1e-3  # 1 ns cycles
