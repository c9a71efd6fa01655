"""Associative ISA: truth-table pass compiler + basic word-parallel ops.

The paper (§2.2, Table 1) implements arithmetic as sequences of *passes*:
each pass COMPAREs one truth-table input pattern against a set of bit-columns
and WRITEs the output pattern into the tagged rows.  Two subtleties the
compiler handles:

1. "No action" skipping — entries whose write would not change the row are
   dropped (Table 1 keeps only 4 of 8 full-adder entries).
2. Ordering — because outputs overwrite inputs, a pass must not transform a
   row INTO a pattern that a *later* pass matches (Table 1's 1st..4th pass
   annotation).  We derive a valid order by topological sort of the
   "p's result equals q's input ⇒ q before p" constraint graph.
"""
from __future__ import annotations

import itertools
from typing import Callable, Sequence

from repro_torch.core.bitplane import Field
from repro_torch.core.engine import APEngine, PassSchedule


# ---------------------------------------------------------------------------
# truth-table compiler
# ---------------------------------------------------------------------------

def compile_table(in_cols: Sequence[int], out_cols: Sequence[int],
                  fn: Callable[[tuple[int, ...]], tuple[int, ...]],
                  assume_out_cleared: bool = False) -> list:
    """Compile a truth table into an ordered list of passes.

    fn maps an input bit-tuple (over in_cols) to an output bit-tuple (over
    out_cols).  Returns [(cmp_cols, cmp_key, w_cols, w_key), ...] in a valid
    execution order.  Raises if no order exists (caller must restructure).
    """
    in_cols = list(in_cols)
    out_cols = list(out_cols)
    n_in = len(in_cols)
    overlap = {c: i for i, c in enumerate(in_cols)}  # col -> index in input

    entries = []  # (in_pattern, out_pattern)
    for pattern in itertools.product((0, 1), repeat=n_in):
        out = tuple(fn(pattern))
        if len(out) != len(out_cols):
            raise ValueError("fn output arity mismatch")
        # "No action" check: does the write change anything?
        changed = False
        for oc, ov in zip(out_cols, out):
            if oc in overlap:
                if pattern[overlap[oc]] != ov:
                    changed = True
            elif assume_out_cleared:
                if ov != 0:
                    changed = True
            else:
                changed = True  # unknown current value -> must write
        if changed:
            entries.append((pattern, out))

    # result pattern over in_cols after the write (for ordering constraints)
    def result_pattern(entry):
        pattern, out = entry
        r = list(pattern)
        for oc, ov in zip(out_cols, out):
            if oc in overlap:
                r[overlap[oc]] = ov
        return tuple(r)

    # edge q -> p  means  q must run before p
    n = len(entries)
    before = [set() for _ in range(n)]  # before[p] = set of q that must precede p
    for p in range(n):
        rp = result_pattern(entries[p])
        for q in range(n):
            if p != q and rp == entries[q][0]:
                before[p].add(q)

    order, placed = [], set()
    while len(order) < n:
        progress = False
        for p in range(n):
            if p not in placed and before[p] <= placed:
                order.append(p)
                placed.add(p)
                progress = True
        if not progress:
            raise ValueError("truth table has no conflict-free pass order; "
                             "use a separate output field")

    passes = []
    for p in order:
        pattern, out = entries[p]
        passes.append((in_cols, list(pattern), out_cols, list(out)))
    return passes


def schedule(passes: list) -> PassSchedule:
    return PassSchedule.build(passes)


# ---------------------------------------------------------------------------
# elementary word-parallel routines.  Each returns a PassSchedule (static);
# callers execute with eng.run(...).  Cycle costs are 2 x n_passes.
# ---------------------------------------------------------------------------

def full_adder_passes(c: int, b: int, a: int) -> list:
    """One single-bit addition b,c <- a + b + c (4 passes; paper Table 1)."""
    def fa(bits):
        cc, bb, aa = bits
        s = aa + bb + cc
        return (s >> 1, s & 1)
    return compile_table([c, b, a], [c, b], fa)


def add(a: Field, b: Field, carry: Field) -> PassSchedule:
    """b <- a + b (mod 2^m), carry-out in ``carry`` (must be pre-cleared).

    Exactly 4 passes per bit = 8m cycles (paper §2.2).
    """
    if a.width != b.width:
        raise ValueError("width mismatch")
    passes = []
    for i in range(a.width):
        passes += full_adder_passes(carry.col(0), b.col(i), a.col(i))
    return schedule(passes)


def full_subtractor_passes(br: int, b: int, a: int) -> list:
    """One single-bit subtraction b,br <- b - a - br."""
    def fs(bits):
        rr, bb, aa = bits
        d = bb - aa - rr
        return (1 if d < 0 else 0, d & 1)
    return compile_table([br, b, a], [br, b], fs)


def sub(a: Field, b: Field, borrow: Field) -> PassSchedule:
    """b <- b - a (mod 2^m), borrow-out in ``borrow`` (pre-cleared). 8m cycles."""
    if a.width != b.width:
        raise ValueError("width mismatch")
    passes = []
    for i in range(a.width):
        passes += full_subtractor_passes(borrow.col(0), b.col(i), a.col(i))
    return schedule(passes)


def const_add(b: Field, const: int, carry: Field) -> PassSchedule:
    """b <- b + const (mod 2^m). 2 passes/bit = 4m cycles (constant folds into key)."""
    passes = []
    for i in range(b.width):
        k = (const >> i) & 1
        def ha(bits, k=k):
            cc, bb = bits
            s = bb + cc + k
            return (s >> 1, s & 1)
        passes += compile_table([carry.col(0), b.col(i)], [carry.col(0), b.col(i)], ha)
    return schedule(passes)


def copy(dst: Field, src: Field) -> PassSchedule:
    """dst <- src. 2 passes/bit (no pre-clear needed)."""
    if dst.width != src.width:
        raise ValueError("width mismatch")
    passes = []
    for i in range(src.width):
        passes += compile_table([src.col(i), dst.col(i)], [dst.col(i)],
                                lambda bits: (bits[0],))
    return schedule(passes)


def cond_copy(dst: Field, src: Field, cond: Field,
              reverse: bool = False) -> PassSchedule:
    """dst <- src where cond==1; untouched elsewhere. 2 passes/bit.

    For overlapping src/dst (free-shift copies): ascending bit order is safe
    for right shifts (dst below src); pass ``reverse=True`` for left shifts
    (dst above src) so high bits are written before their sources are read.
    """
    if dst.width != src.width:
        raise ValueError("width mismatch")
    passes = []
    order = reversed(range(src.width)) if reverse else range(src.width)
    for i in order:
        passes += compile_table([cond.col(0), src.col(i), dst.col(i)], [dst.col(i)],
                                lambda bits: (bits[1],) if bits[0] else (bits[2],))
    return schedule(passes)


def logic_not(dst: Field, src: Field) -> PassSchedule:
    passes = []
    for i in range(src.width):
        passes += compile_table([src.col(i), dst.col(i)], [dst.col(i)],
                                lambda bits: (1 - bits[0],))
    return schedule(passes)


def eq_flag(a: Field, b: Field, flag: Field) -> PassSchedule:
    """flag <- (a == b).  flag must be pre-set to 1 (eng.set_bits(flag, 1)).

    2 passes/bit: clear flag where bits differ.
    """
    passes = []
    for i in range(a.width):
        passes += [
            ([flag.col(0), a.col(i), b.col(i)], [1, 1, 0], [flag.col(0)], [0]),
            ([flag.col(0), a.col(i), b.col(i)], [1, 0, 1], [flag.col(0)], [0]),
        ]
    return schedule(passes)


def gt_flag(a: Field, b: Field, gt: Field, decided: Field) -> PassSchedule:
    """gt <- (a > b) unsigned.  gt and decided must be pre-cleared.

    MSB-first scan, 2 passes/bit.
    """
    passes = []
    for i in reversed(range(a.width)):
        passes += [
            ([decided.col(0), a.col(i), b.col(i)], [0, 1, 0],
             [gt.col(0), decided.col(0)], [1, 1]),
            ([decided.col(0), a.col(i), b.col(i)], [0, 0, 1],
             [decided.col(0)], [1]),
        ]
    return schedule(passes)


def lut(arg: Field, out: Field, fn: Callable[[int], int]) -> PassSchedule:
    """out <- fn(arg) by exhaustive LUT matching (paper §2.2, O(2^m) passes).

    ``out`` must be pre-cleared; entries with fn(x) == 0 are skipped, the rest
    take one pass each — worst case 2^m passes / 2^(m+1) cycles.
    """
    passes = []
    in_cols = arg.cols()
    out_cols = out.cols()
    for x in range(1 << arg.width):
        y = fn(x) & ((1 << out.width) - 1)
        if y == 0:
            continue  # out pre-cleared
        ikey = [(x >> i) & 1 for i in range(arg.width)]
        okey = [(y >> i) & 1 for i in range(out.width)]
        passes.append((in_cols, ikey, out_cols, okey))
    if not passes:  # fn == 0 everywhere; nothing to do, emit a no-op pass
        passes.append((in_cols, [0] * arg.width, out_cols, [0] * out.width))
    return schedule(passes)


# convenience: run a routine end-to-end on an engine ------------------------

def run_add(eng: APEngine, a: Field, b: Field, carry: Field) -> None:
    eng.clear(carry)
    eng.run(add(a, b, carry))


def run_sub(eng: APEngine, a: Field, b: Field, borrow: Field) -> None:
    eng.clear(borrow)
    eng.run(sub(a, b, borrow))
