"""IEEE-754 single-precision arithmetic on the AP, bit-serial word-parallel
(PyTorch port of ``repro.core.apfloat``).

The paper (§2.2) claims a direct FP32 vector multiply implementation takes
~4400 cycles *regardless of vector length*.  We implement FP32 multiply and
add from the pass primitives and measure the actual cycle counts.

Representation: a packed fp32 "value" is three adjacent fields of one word:
    sign (1 col) | exp (8 cols, biased) | mant (23 cols)
Denormals are flushed to zero on load; rounding is truncation (documented
deviation — adds <=1 ulp vs round-to-nearest; tests use 2-ulp tolerance).

Port note: every routine runs on the port's
:class:`~repro_torch.core.engine.APEngine` and its ``device`` (each pass
schedule one ``ap_match`` launch on a card, or one megakernel group with
the megakernel backend); the pass schedules, and with them the results,
cycle counters and float64 energies, are the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import arith, isa
from repro_torch.core.bitplane import Field
from repro_torch.core.engine import APEngine, PassSchedule


@dataclasses.dataclass(frozen=True)
class FpField:
    """An fp32 vector resident in the associative array."""
    sign: Field
    exp: Field
    mant: Field

    @staticmethod
    def alloc(eng: APEngine) -> "FpField":
        return FpField(eng.alloc.alloc(1, "s"), eng.alloc.alloc(8, "e"),
                       eng.alloc.alloc(23, "m"))


def load_fp32(eng: APEngine, f: FpField, values: np.ndarray) -> None:
    v = np.asarray(values, np.float32)
    bits = v.view(np.uint32).astype(np.uint64)
    exp = (bits >> 23) & 0xFF
    denorm = exp == 0
    eng.load(f.sign, (bits >> 31) & 1)
    eng.load(f.exp, np.where(denorm, 0, exp))
    eng.load(f.mant, np.where(denorm, 0, bits & 0x7FFFFF))


def read_fp32(eng: APEngine, f: FpField) -> np.ndarray:
    s = eng.peek(f.sign)
    e = eng.peek(f.exp)
    m = eng.peek(f.mant)
    bits = (s.astype(np.uint32) << 31) | (e.astype(np.uint32) << 23) \
        | m.astype(np.uint32)
    return bits.view(np.float32)


@dataclasses.dataclass
class FpScratch:
    """Scratch columns shared by the fp routines (allocate once per engine)."""
    ma: Field      # 24-bit mantissa with hidden bit
    mb: Field      # 24-bit mantissa with hidden bit
    prod: Field    # 49-bit product
    ext: Field     # 10-bit extended exponent
    carry: Field
    cond: Field
    cond2: Field

    @staticmethod
    def alloc(eng: APEngine) -> "FpScratch":
        a = eng.alloc
        return FpScratch(a.alloc(24, "ma"), a.alloc(25, "mb"), a.alloc(49, "prod"),
                         a.alloc(10, "eext"), a.alloc(1, "c"), a.alloc(1, "cd"),
                         a.alloc(1, "cd2"))


def _add_zext(a: Field, b: Field, carry: Field):
    """b <- b + zext(a): ripple the carry through b's extra high bits."""
    passes = []
    for i in range(b.width):
        if i < a.width:
            passes += isa.full_adder_passes(carry.col(0), b.col(i), a.col(i))
        else:
            def ha(bits):
                cc, bb = bits
                s = bb + cc
                return (s >> 1, s & 1)
            passes += isa.compile_table([carry.col(0), b.col(i)],
                                        [carry.col(0), b.col(i)], ha)
    return isa.schedule(passes)


def _seeded_inc(b: Field, seed: Field, carry: Field):
    """b <- b + seed (seed is 1 bit): carry <- seed, then ripple half-adders."""
    passes = isa.compile_table([seed.col(0), carry.col(0)], [carry.col(0)],
                               lambda bits: (bits[0],))
    for i in range(b.width):
        def ha(bits):
            cc, bb = bits
            s = bb + cc
            return (s >> 1, s & 1)
        passes += isa.compile_table([carry.col(0), b.col(i)],
                                    [carry.col(0), b.col(i)], ha)
    return isa.schedule(passes)


def fp_mul(eng: APEngine, x: FpField, y: FpField, out: FpField,
           s: FpScratch) -> None:
    """out <- x * y, word-parallel.  ~4800 measured cycles for the direct

    implementation (paper's optimized figure: 4400; same O(m^2) structure).
    """
    # 1. sign: out.s = x.s XOR y.s  (2 passes)
    eng.run(isa.schedule(isa.compile_table(
        [x.sign.col(0), y.sign.col(0), out.sign.col(0)], [out.sign.col(0)],
        lambda b: (b[0] ^ b[1],))))

    # 2. exponent: ext = x.e + y.e - 127 (10-bit, wraps are caller's concern)
    eng.clear(s.ext)
    eng.run(isa.copy(s.ext.slice(0, 8), x.exp))
    eng.clear(s.carry)
    eng.run(_add_zext(y.exp, s.ext, s.carry))
    eng.clear(s.carry)
    eng.run(isa.const_add(s.ext, (1 << s.ext.width) - 127, s.carry))

    # 3. mantissas with hidden bit
    eng.run(isa.copy(s.ma.slice(0, 23), x.mant))
    eng.set_bits(s.ma.slice(23, 1), 1)
    eng.run(isa.copy(s.mb.slice(0, 23), y.mant))
    eng.set_bits(s.mb.slice(23, 1), 1)
    eng.clear(s.mb.slice(24, 1))

    # 4. 24x24 long multiply -> 48-bit product (the O(m^2) core)
    eng.clear(s.prod)
    for sched in arith.mul_schedules(s.ma, s.mb.slice(0, 24), s.prod, s.carry):
        eng.clear(s.carry)
        eng.run(sched)

    # 5. normalize: product in [2^46, 2^48); cond = bit 47
    eng.run(isa.copy(s.cond, s.prod.slice(47, 1)))
    eng.run(isa.copy(out.mant, s.prod.slice(23, 23)))
    eng.run(isa.cond_copy(out.mant, s.prod.slice(24, 23), s.cond))
    eng.clear(s.carry)
    eng.run(_seeded_inc(s.ext, s.cond, s.carry))

    # 6. exponent writeback (top 2 ext bits are overflow guards; ignored here)
    eng.run(isa.copy(out.exp, s.ext.slice(0, 8)))

    # 7. zero inputs -> zero output (x.e==0 or y.e==0)
    _propagate_zero(eng, x, y, out, s)


def _propagate_zero(eng: APEngine, x: FpField, y: FpField, out: FpField,
                    s: FpScratch) -> None:
    """If either input is (flushed) zero, force out to +/-0."""
    for src in (x, y):
        eng.compare(src.exp.cols(), [0] * 8)
        eng.write(out.exp.cols() + out.mant.cols(), [0] * (8 + 23))


def fp_add(eng: APEngine, x: FpField, y: FpField, out: FpField,
           s: FpScratch, max_shift: int = 25) -> None:
    """out <- x + y (any signs), word-parallel.

    Algorithm (all steps data-parallel over rows):
      1. order operands so |big| has the larger (exp, mant): big/small into
         scratch via cond_copy (magnitude compare on the packed exp|mant bits)
      2. align: small.mant >>= (big.e - small.e) via per-shift tagged copies
      3. same sign -> 25-bit add; opposite -> subtract (big - small)
      4. renormalize: carry-out -> shift right 1; else leading-zero scan
         (priority passes) shifting left by k and exp -= k
    Costs ~6-7k cycles — O(m) passes per step with constant factors from the
    variable-shift LUT loops; reported by bench_cycles.
    """
    a = eng.alloc
    if not hasattr(eng, "_fpadd_scratch"):
        eng._fpadd_scratch = {
            "eb": a.alloc(8, "eb"), "es": a.alloc(8, "es"),
            "mb": a.alloc(26, "mbig"), "ms": a.alloc(26, "msmall"),
            "sb": a.alloc(1, "sbig"), "ss": a.alloc(1, "ssmall"),
            "d": a.alloc(8, "d"), "br": a.alloc(1, "br2"),
            "sdif": a.alloc(1, "sdif"), "done": a.alloc(1, "done"),
        }
    t = eng._fpadd_scratch
    eb, es, mb, ms = t["eb"], t["es"], t["mb"], t["ms"]
    sb, ss, d, br = t["sb"], t["ss"], t["d"], t["br"]
    sdif, done = t["sdif"], t["done"]

    # -- 1. magnitude order: cond = |y| > |x| on (exp,mant) lexicographic
    eng.clear(s.cond)
    eng.clear(s.cond2)
    # compare 31-bit magnitudes MSB-first: exp bits then mant bits
    xcols = list(reversed(x.exp.cols())) + list(reversed(x.mant.cols()))
    ycols = list(reversed(y.exp.cols())) + list(reversed(y.mant.cols()))
    passes = []
    for xc, yc in zip(xcols, ycols):
        passes += [
            ([s.cond2.col(0), yc, xc], [0, 1, 0],
             [s.cond.col(0), s.cond2.col(0)], [1, 1]),
            ([s.cond2.col(0), yc, xc], [0, 0, 1], [s.cond2.col(0)], [1]),
        ]
    eng.run(isa.schedule(passes))

    # big = cond ? y : x ; small = cond ? x : y   (with hidden bits)
    for dst_e, dst_m, dst_s, hi, lo in ((eb, mb, sb, y, x), (es, ms, ss, x, y)):
        eng.run(isa.copy(dst_e, lo.exp))
        eng.run(isa.cond_copy(dst_e, hi.exp, s.cond))
        eng.clear(dst_m)
        eng.run(isa.copy(dst_m.slice(1, 23), lo.mant))
        eng.run(isa.cond_copy(dst_m.slice(1, 23), hi.mant, s.cond))
        eng.set_bits(dst_m.slice(24, 1), 1)
        # flushed-zero operand: mantissa is truly 0, not 1.0 x 2^-127
        eng.compare(dst_e.cols(), [0] * dst_e.width)
        eng.write(dst_m.cols(), [0] * dst_m.width)
        eng.run(isa.copy(dst_s, lo.sign))
        eng.run(isa.cond_copy(dst_s, hi.sign, s.cond))

    # -- 2. align small: d = eb - es; for each shift 1..max, cond-copy
    eng.run(isa.copy(d, eb))
    eng.clear(br)
    eng.run(isa.sub(es, d, br))
    for k in range(1, max_shift):
        eng.clear(s.cond2)
        eng.compare(d.cols(), [(k >> i) & 1 for i in range(8)])
        eng.write([s.cond2.col(0)], [1])
        # small >>= k : copy ms[k:25] -> ms[0:25-k], zero the top k bits
        eng.run(isa.cond_copy(ms.slice(0, 25 - k), ms.slice(k, 25 - k), s.cond2))
        _cond_clear(eng, ms.slice(25 - k, k), s.cond2)
    # shifts >= max_shift: small flushes to 0
    eng.clear(s.cond2)
    eng.clear(t["done"])
    _tag_ge(eng, d, max_shift, s.cond2)
    _cond_clear(eng, ms, s.cond2)

    # -- 3. add or subtract mantissas (26-bit: guard high bit for carry)
    eng.run(isa.schedule(isa.compile_table(
        [sb.col(0), ss.col(0), sdif.col(0)], [sdif.col(0)],
        lambda b: (b[0] ^ b[1],))))
    # subtract where signs differ (small <= big by construction)
    eng.clear(br)
    msub = isa.sub(ms.slice(0, 25), mb.slice(0, 25), br)
    # conditionalize: prepend sdif=1 to each pass
    eng.run(_conditionalize(msub, sdif.col(0), 1))
    # add where same sign
    eng.clear(br)
    madd = _add_zext(ms.slice(0, 25), mb, br)
    eng.run(_conditionalize(madd, sdif.col(0), 0))

    # -- 4. renormalize into out
    eng.run(isa.copy(out.sign, sb))
    eng.run(isa.copy(out.exp, eb))
    eng.clear(done)
    # 4a. carry-out (bit 25): shift right one, exp += 1
    eng.run(isa.copy(s.cond, mb.slice(25, 1)))
    eng.run(isa.cond_copy(mb.slice(0, 25), mb.slice(1, 25), s.cond))
    _cond_clear(eng, mb.slice(25, 1), s.cond)
    eng.clear(s.carry)
    eng.run(_seeded_inc(out.exp, s.cond, s.carry))
    _cond_set(eng, done, s.cond)
    # 4b. leading-zero scan: rows whose leading 1 sits at bit 24-k shift
    # left by k and subtract k from the exponent (conditionalized passes).
    for k in range(0, 25):
        eng.clear(s.cond2)
        eng.compare([done.col(0), mb.col(24 - k)], [0, 1])
        eng.write([s.cond2.col(0)], [1])
        if k > 0:
            eng.run(isa.cond_copy(mb.slice(k, 25 - k), mb.slice(0, 25 - k),
                                  s.cond2, reverse=True))
            _cond_clear(eng, mb.slice(0, k), s.cond2)
            eng.clear(s.carry)
            dec = isa.const_add(out.exp, (1 << 8) - k, s.carry)
            eng.run(_conditionalize(dec, s.cond2.col(0), 1))
        _cond_set(eng, done, s.cond2)
    # rows never tagged have a zero mantissa: result is +/-0
    eng.compare([done.col(0)], [0])
    eng.write(out.exp.cols() + mb.cols(), [0] * (8 + mb.width))
    eng.run(isa.copy(out.mant, mb.slice(1, 23)))


def _conditionalize(sched, cond_col: int, cond_val: int):
    """Prepend a condition column to every pass of a schedule."""
    P = sched.n_passes
    cc = np.concatenate([np.full((P, 1), cond_col, np.int32), sched.cmp_cols], 1)
    ck = np.concatenate([np.full((P, 1), cond_val, np.uint32), sched.cmp_key], 1)
    return PassSchedule(cc, ck, sched.w_cols, sched.w_key,
                        sched.kc + 1, sched.kw)


def _cond_clear(eng: APEngine, f: Field, cond: Field) -> None:
    """f <- 0 where cond: per-column pass (cond=1, f_i=1) -> f_i=0."""
    passes = [([cond.col(0), f.col(i)], [1, 1], [f.col(i)], [0])
              for i in range(f.width)]
    eng.run(isa.schedule(passes))


def _cond_set(eng: APEngine, f: Field, cond: Field) -> None:
    passes = [([cond.col(0), f.col(0)], [1, 0], [f.col(0)], [1])]
    eng.run(isa.schedule(passes))


def _tag_ge(eng: APEngine, f: Field, const: int, out_col: Field) -> None:
    """out_col <- (f >= const) for an 8-bit field, via tagged compares."""
    # tag rows where f >= const by enumerating matching prefixes (MSB logic):
    # f >= c iff for some bit position i: f[hi..i+1]==c[hi..i+1], f_i=1, c_i=0,
    # or f == c.
    m = f.width
    cbits = [(const >> i) & 1 for i in range(m)]
    for i in range(m):
        if cbits[i] == 0:
            cols = [f.col(j) for j in range(i, m)]
            key = [1] + [cbits[j] for j in range(i + 1, m)]
            eng.compare(cols, key)
            eng.write([out_col.col(0)], [1])
    eng.compare(f.cols(), cbits)
    eng.write([out_col.col(0)], [1])
