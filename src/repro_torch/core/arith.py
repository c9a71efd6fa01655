"""Fixed-point word-parallel arithmetic on the AP: mul / mac / div.

Multiplication and division follow the paper (§2.2): long multiplication /
long division as series of (conditional) add/subtract with free shifts,
bit-serial but word-parallel — O(m^2) cycles regardless of vector length.

The per-row multiplier bit enters the COMPARE key as an extra column, so a
"conditional add" pass is the full-adder pass with the condition column
prepended — still 4 passes per bit position.
"""
from __future__ import annotations

from repro_torch.core.bitplane import Field
from repro_torch.core.engine import APEngine, PassSchedule
from repro_torch.core import isa


def cond_full_adder_passes(cond: int, c: int, b: int, a: int) -> list:
    """b,c <- a + b + c where row bit ``cond``==1; no action elsewhere."""
    def fa(bits):
        cnd, cc, bb, aa = bits
        if not cnd:
            return (cc, bb)
        s = aa + bb + cc
        return (s >> 1, s & 1)
    return isa.compile_table([cond, c, b, a], [c, b], fa)


def cond_half_adder_passes(cond: int, c: int, b: int) -> list:
    """b,c <- b + c where cond==1 (zero addend; absorbs carry propagation)."""
    def ha(bits):
        cnd, cc, bb = bits
        if not cnd:
            return (cc, bb)
        s = bb + cc
        return (s >> 1, s & 1)
    return isa.compile_table([cond, c, b], [c, b], ha)


def cond_add(a: Field, b: Field, carry: Field, cond: Field) -> PassSchedule:
    """b <- a + b where cond==1.  4 passes/bit, carry pre-cleared by caller."""
    passes = []
    for i in range(a.width):
        passes += cond_full_adder_passes(cond.col(0), carry.col(0),
                                         b.col(i), a.col(i))
    return isa.schedule(passes)


def cond_full_subtractor_passes(cond: int, br: int, b: int, a: int) -> list:
    """b,br <- b - a - br where row bit ``cond``==1; no action elsewhere."""
    def fs(bits):
        cnd, rr, bb, aa = bits
        if not cnd:
            return (rr, bb)
        d = bb - aa - rr
        return (1 if d < 0 else 0, d & 1)
    return isa.compile_table([cond, br, b, a], [br, b], fs)


def cond_sub(a: Field, b: Field, borrow: Field, cond: Field) -> PassSchedule:
    """b <- b - a where cond==1.  4 passes/bit, borrow pre-cleared by caller."""
    passes = []
    for i in range(a.width):
        passes += cond_full_subtractor_passes(cond.col(0), borrow.col(0),
                                              b.col(i), a.col(i))
    return isa.schedule(passes)


def negate(f: Field, carry: Field) -> list[PassSchedule]:
    """f <- -f (two's complement): bitwise NOT then +1.  Returns schedules."""
    return [isa.logic_not(f, f), isa.const_add(f, 1, carry)]


def cond_negate(eng: APEngine, f: Field, cond: Field, carry: Field,
                z: Field) -> None:
    """f <- -f where cond==1 (conditional two's-complement negate).

    An in-place bit toggle has no conflict-free pass order (the two passes
    map rows into each other's input patterns), so each bit is staged
    through the 1-column marker ``z``: copy f_i -> z, then write ~z back
    into f_i where cond.  4 passes/bit, single fused schedule.
    """
    passes = []
    for i in range(f.width):
        passes += isa.compile_table([f.col(i)], [z.col(0)],
                                    lambda b: (b[0],))
        passes += [([cond.col(0), z.col(0)], [1, 1], [f.col(i)], [0]),
                   ([cond.col(0), z.col(0)], [1, 0], [f.col(i)], [1])]
    eng.run(isa.schedule(passes))
    # +1 where cond: seed carry from cond, then conditional half-adder ripple
    eng.clear(carry)
    inc = []
    inc += isa.compile_table([cond.col(0), carry.col(0)], [carry.col(0)],
                             lambda b: (b[0],))
    for i in range(f.width):
        def ha(bits):
            cc, bb = bits
            s = bb + cc
            return (s >> 1, s & 1)
        inc += isa.compile_table([carry.col(0), f.col(i)],
                                 [carry.col(0), f.col(i)], ha)
    eng.run(isa.schedule(inc))


def run_signed_mul(eng: APEngine, a: Field, b: Field, prod: Field,
                   carry: Field, sa: Field, sb: Field, z: Field) -> None:
    """prod <- a * b for two's-complement a, b (sign-magnitude internally).

    sa/sb/z are 1-column scratch.  a and b are restored (magnitude negated
    back) after the multiply; prod is two's complement of full width.
    The minimum value -2^(m-1) is not representable as a magnitude and must
    be avoided by callers (standard Q-format contract).
    """
    # extract signs, take magnitudes
    for f, s in ((a, sa), (b, sb)):
        eng.run(isa.copy(s, f.slice(f.width - 1, 1)))
        cond_negate(eng, f, s, carry, z)
    run_mul(eng, a, b, prod, carry)
    # product sign = sa XOR sb (XOR in-place on sa is conflict-free via z)
    _xor_into(eng, sa, sb, z)
    cond_negate(eng, prod, sa, carry, z)
    # restore operands: sa ^= sb gives back a's sign
    _xor_into(eng, sa, sb, z)
    cond_negate(eng, a, sa, carry, z)
    cond_negate(eng, b, sb, carry, z)


def _xor_into(eng: APEngine, dst: Field, src: Field, z: Field) -> None:
    """dst <- dst XOR src (1-bit fields), staged through marker z."""
    passes = isa.compile_table([dst.col(0)], [z.col(0)], lambda b: (b[0],))
    passes += [([src.col(0), z.col(0)], [1, 1], [dst.col(0)], [0]),
               ([src.col(0), z.col(0)], [1, 0], [dst.col(0)], [1])]
    eng.run(isa.schedule(passes))


def mul_schedules(a: Field, b: Field, prod: Field, carry: Field
                  ) -> list[PassSchedule]:
    """prod <- a * b (unsigned).  prod width must be >= a.width + b.width.

    Long multiplication, LSB-first (shift = column offset, zero cycles):
    for each multiplier bit b_j, conditionally add ``a`` into prod[j : j+m+1]
    (the +1 column absorbs the carry; bits above are provably 0).
    Cycles: b.width * (8*(a.width+1) + 2) ~ 8*m^2  ==> O(m^2) (paper §2.2).

    Returns one schedule per multiplier bit (caller clears carry between).
    """
    m = a.width
    if prod.width < a.width + b.width:
        raise ValueError("product field too narrow")
    scheds = []
    for j in range(b.width):
        cond = b.col(j)
        passes = []
        for i in range(m):
            passes += cond_full_adder_passes(cond, carry.col(0),
                                             prod.col(j + i), a.col(i))
        # absorb the final carry into prod[j+m] (zero addend)
        passes += cond_half_adder_passes(cond, carry.col(0), prod.col(j + m))
        scheds.append(isa.schedule(passes))
    return scheds


def run_mul(eng: APEngine, a: Field, b: Field, prod: Field, carry: Field) -> None:
    """Execute prod <- a*b, clearing prod and managing the carry column."""
    eng.clear(prod)
    for sched in mul_schedules(a, b, prod, carry):
        eng.clear(carry)
        eng.run(sched)


def run_mac(eng: APEngine, a: Field, b: Field, acc: Field, carry: Field) -> None:
    """acc += a*b  (acc must be wide enough to never overflow: the caller's

    responsibility, e.g. width >= a.width + b.width + log2(#accumulations)).
    Same pass structure as mul but without clearing acc; the carry ripple
    above position j+m is handled by extending propagation to the top of acc.
    """
    m = a.width
    for j in range(b.width):
        cond = b.col(j)
        passes = []
        for i in range(m):
            passes += cond_full_adder_passes(cond, carry.col(0),
                                             acc.col(j + i), a.col(i))
        # ripple the carry through the remaining accumulator bits
        for i in range(j + m, acc.width):
            passes += cond_half_adder_passes(cond, carry.col(0), acc.col(i))
        eng.clear(carry)
        eng.run(isa.schedule(passes))


def run_div(eng: APEngine, a: Field, b: Field, quot: Field, wide: Field,
            trial: Field, borrow: Field, qbit: Field) -> None:
    """quot <- a // b (unsigned restoring long division, in-place remainder).

    Scratch:  wide  — 2m+1 columns (dividend low, remainder window walks up)
              trial — m+1 columns, borrow/qbit — 1 column each.
    After the call the remainder a % b sits in wide[0:m].
    Cycles ~ m * (12m + O(1))  ==> O(m^2) (paper §2.2).
    """
    m = a.width
    if wide.width < 2 * m + 1 or trial.width < m + 1 or quot.width < m:
        raise ValueError("scratch fields too narrow")
    eng.clear(wide)
    eng.clear(quot)
    eng.run(isa.copy(wide.slice(0, m), a))

    for i in reversed(range(m)):
        win = wide.slice(i, m + 1)              # remainder window (free shift)
        # trial = window - b  (b zero-extended by 1)
        eng.run(isa.copy(trial, win))
        eng.clear(borrow)
        eng.run(_sub_zext(b, trial, borrow))
        # q_i = ~borrow ; where q_i: window <- trial
        eng.clear(qbit)
        eng.compare([borrow.col(0)], [0])
        eng.write([qbit.col(0), quot.col(i)], [1, 1])
        eng.run(isa.cond_copy(win, trial, qbit))


def _sub_zext(a: Field, b: Field, borrow: Field) -> PassSchedule:
    """b <- b - zext(a): subtract a (narrower) from b, borrow rippling up."""
    passes = []
    for i in range(b.width):
        if i < a.width:
            passes += isa.full_subtractor_passes(borrow.col(0), b.col(i), a.col(i))
        else:
            # a_i = 0: only the borrow ripples:  b,br <- b - br
            def fs0(bits):
                rr, bb = bits
                d = bb - rr
                return (1 if d < 0 else 0, d & 1)
            passes += isa.compile_table([borrow.col(0), b.col(i)],
                                        [borrow.col(0), b.col(i)], fs0)
    return isa.schedule(passes)
