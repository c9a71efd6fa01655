"""Black-Scholes option pricing on the AP (paper §3.1 workload 1).

One PU per option pair; everything below is word-parallel over all N PUs, so
cycle counts are independent of N — the paper's "embarrassingly parallel, no
inter-PU communication" exemplar.

    C = S * PHI(d1) - K * e^{-rT} * PHI(d2)
    d1 = (ln(S/K) + (r + sigma^2/2) T) / (sigma sqrt(T));  d2 = d1 - sigma sqrt(T)

Numerics: signed Q6.10 fixed point (16-bit).  Transcendentals (ln, sqrt,
exp, PHI) use the paper's LUT idiom (§2.2): a 10-bit argument matched
exhaustively — O(2^10) compare+write passes per function, with the function
values carried in the instruction stream.  Division is restoring long
division, O(m^2).  Expected accuracy ~1e-2 absolute in price units
(dominated by the Q6.10 quantization of PHI and ln) — tests assert against
the float64 reference with that tolerance.

The transcendental LUT schedules all land in one power-of-two shape
bucket (`engine.bucket_schedule`), so the pricing pipeline runs a few
table shapes in all instead of one per LUT.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import arith, isa
from repro_torch.core.apfloat import _tag_ge
from repro_torch.core.bitplane import Field
from repro_torch.core.engine import APEngine

M = 16          # word length
FRAC = 10       # fraction bits (Q6.10)
LUT_BITS = 10   # transcendental LUT argument width
ONE = 1 << FRAC


def _q(x) -> np.ndarray:
    v = np.round(np.asarray(x, np.float64) * ONE).astype(np.int64)
    v = np.clip(v, -(1 << (M - 1)), (1 << (M - 1)) - 1)
    return (v & ((1 << M) - 1)).astype(np.uint64)


def _unq(u) -> np.ndarray:
    u = np.asarray(u, np.int64)
    sign = u >> (M - 1)
    return (u - (sign << M)).astype(np.float64) / ONE


@dataclasses.dataclass
class _Fields:
    S: Field
    K: Field
    T: Field
    sig: Field
    num: Field
    den: Field
    d1: Field
    d2: Field
    phi1: Field
    phi2: Field
    disc: Field
    t1: Field
    t2: Field
    arg: Field
    prod: Field
    div_a: Field
    quot: Field
    wide: Field
    trial: Field
    carry: Field
    borrow: Field
    qbit: Field
    sa: Field
    sb: Field
    flag: Field
    z: Field


def _alloc(eng: APEngine) -> _Fields:
    a = eng.alloc
    dm = M + FRAC  # division dividend width
    return _Fields(
        S=a.alloc(M, "S"), K=a.alloc(M, "K"), T=a.alloc(M, "T"),
        sig=a.alloc(M, "sig"), num=a.alloc(M, "num"), den=a.alloc(M, "den"),
        d1=a.alloc(M, "d1"), d2=a.alloc(M, "d2"),
        phi1=a.alloc(M, "phi1"), phi2=a.alloc(M, "phi2"),
        disc=a.alloc(M, "disc"), t1=a.alloc(M, "t1"), t2=a.alloc(M, "t2"),
        arg=a.alloc(LUT_BITS, "arg"), prod=a.alloc(2 * M, "prod"),
        div_a=a.alloc(dm, "diva"), quot=a.alloc(dm, "quot"),
        wide=a.alloc(2 * dm + 1, "wide"), trial=a.alloc(dm + 1, "trial"),
        carry=a.alloc(1, "c"), borrow=a.alloc(1, "br"), qbit=a.alloc(1, "qb"),
        sa=a.alloc(1, "sa"), sb=a.alloc(1, "sb"), flag=a.alloc(1, "fl"),
        z=a.alloc(1, "z"))


def _smul(eng: APEngine, f: _Fields, dst: Field, a: Field, b: Field) -> None:
    """dst <- (a * b) >> FRAC, signed Q-format."""
    arith.run_signed_mul(eng, a, b, f.prod, f.carry, f.sa, f.sb, f.z)
    eng.run(isa.copy(dst, f.prod.slice(FRAC, M)))


def _sdiv(eng: APEngine, f: _Fields, dst: Field, num: Field,
          den: Field) -> None:
    """dst <- (num << FRAC) / den, num signed, den positive Q-format."""
    eng.run(isa.copy(f.sa, num.slice(M - 1, 1)))
    arith.cond_negate(eng, num, f.sa, f.carry, f.z)
    eng.clear(f.div_a)
    eng.run(isa.copy(f.div_a.slice(FRAC, M), num))
    arith.run_div(eng, f.div_a, den, f.quot, f.wide, f.trial,
                  f.borrow, f.qbit)
    eng.run(isa.copy(dst, f.quot.slice(0, M)))
    arith.cond_negate(eng, dst, f.sa, f.carry, f.z)
    arith.cond_negate(eng, num, f.sa, f.carry, f.z)   # restore argument


def _lut16(eng: APEngine, f: _Fields, dst: Field, src: Field, lo_bit: int,
           fn) -> None:
    """dst <- LUT(fn)(src bits [lo_bit : lo_bit+10]), out Q6.10 unsigned."""
    eng.run(isa.copy(f.arg, src.slice(lo_bit, LUT_BITS)))
    eng.clear(dst)
    eng.run(isa.lut(f.arg, dst, fn))


def _clamp_phi_arg(eng: APEngine, f: _Fields, src: Field) -> None:
    """src <- clip(src + 4.0, 0, 8.0 - eps) in place (PHI LUT domain)."""
    eng.clear(f.carry)
    eng.run(isa.const_add(src, 4 * ONE, f.carry))
    # negative (sign bit set) -> 0
    eng.compare([src.col(M - 1)], [1])
    eng.write(src.cols(), [0] * M)
    # >= 8.0 -> 8.0 - 1ulp
    eng.clear(f.flag)
    _tag_ge(eng, src, 8 * ONE, f.flag)
    hi = 8 * ONE - 1
    eng.compare([f.flag.col(0)], [1])
    eng.write(src.cols(), [(hi >> i) & 1 for i in range(M)])


def _phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def ap_blackscholes(S, K, T, sigma, r: float = 0.05,
                    backend: str = "jnp", *, device="cuda"
                    ) -> tuple[np.ndarray, dict]:
    """Call prices for option vectors (word-parallel on one AP)."""
    S, K, T, sigma = (np.asarray(v, np.float64) for v in (S, K, T, sigma))
    n = S.shape[0]
    n_words = max(((n + 31) // 32) * 32, 32)
    eng = APEngine(n_words=n_words, n_bits=448, backend=backend,
                   device=device)
    f = _alloc(eng)

    def load(field: Field, vals: np.ndarray) -> None:
        buf = np.zeros(n_words, np.uint64)
        buf[:n] = _q(vals)
        eng.load(field, buf)

    load(f.S, S)
    load(f.K, K)
    load(f.T, T)
    load(f.sig, sigma)

    # ---- num = ln(S/K) + (r + sig^2/2) T
    _sdiv(eng, f, f.t1, f.S, f.K)                     # t1 = S/K  (Q6.10 > 0)
    # ln LUT: arg = ratio bits [2:12] => value/4 in [0,1) * 1024
    _lut16(eng, f, f.num, f.t1, 2,
           lambda a: int(np.clip(round(math.log(max(a, 1) * 4.0 / (1 << LUT_BITS))
                                       * ONE), -(1 << (M - 1)), (1 << (M - 1)) - 1))
           & ((1 << M) - 1))
    _smul(eng, f, f.t1, f.sig, f.sig)                 # t1 = sig^2
    # t1 = r + sig^2/2 : halve by field shift, then add constant r
    eng.run(isa.copy(f.t2, f.t1.shifted(1)))          # t2 = t1 >> 1 (free shift)
    eng.clear(f.t2.slice(M - 1, 1))
    eng.clear(f.carry)
    eng.run(isa.const_add(f.t2, int(round(r * ONE)), f.carry))
    _smul(eng, f, f.t1, f.t2, f.T)                    # t1 = (r + s^2/2) T
    eng.clear(f.carry)
    eng.run(isa.add(f.t1, f.num, f.carry))            # num += t1

    # ---- den = sig * sqrt(T)
    # sqrt LUT: arg = T bits [2:12] => value/4 in [0,1) * 1024
    _lut16(eng, f, f.t1, f.T, 2,
           lambda a: int(round(math.sqrt(a * 4.0 / (1 << LUT_BITS)) * ONE)))
    _smul(eng, f, f.den, f.sig, f.t1)

    # ---- d1 = num / den ; d2 = d1 - den
    _sdiv(eng, f, f.d1, f.num, f.den)
    eng.run(isa.copy(f.d2, f.d1))
    eng.clear(f.borrow)
    eng.run(isa.sub(f.den, f.d2, f.borrow))

    # ---- PHI(d1), PHI(d2): clamp to [-4, 4), LUT on (x+4)/8 * 1024
    for d, phi in ((f.d1, f.phi1), (f.d2, f.phi2)):
        eng.run(isa.copy(f.t1, d))
        _clamp_phi_arg(eng, f, f.t1)
        _lut16(eng, f, phi, f.t1, 3,
               lambda a: int(round(_phi(a * 8.0 / (1 << LUT_BITS) - 4.0) * ONE)))

    # ---- disc = e^{-rT}: LUT on rT bits [0:10] (rT < 1)
    eng.clear(f.t2)
    eng.clear(f.carry)
    eng.run(isa.const_add(f.t2, int(round(r * ONE)), f.carry))
    _smul(eng, f, f.t1, f.t2, f.T)                    # t1 = r T
    _lut16(eng, f, f.disc, f.t1, 0,
           lambda a: int(round(math.exp(-a / ONE) * ONE)))

    # ---- C = S*phi1 - K*disc*phi2
    _smul(eng, f, f.t1, f.S, f.phi1)
    _smul(eng, f, f.t2, f.K, f.disc)
    _smul(eng, f, f.t2, f.t2, f.phi2)
    eng.clear(f.borrow)
    eng.run(isa.sub(f.t2, f.t1, f.borrow))            # t1 = t1 - t2

    prices = _unq(eng.read(f.t1)[:n])
    counters = eng.counters()
    counters["trace_cycles"], counters["trace_energy"] = eng.trace_events()
    counters["n"] = n
    return prices, counters


def reference(S, K, T, sigma, r: float = 0.05) -> np.ndarray:
    S, K, T, sigma = (np.asarray(v, np.float64) for v in (S, K, T, sigma))
    d1 = (np.log(S / K) + (r + sigma ** 2 / 2) * T) / (sigma * np.sqrt(T))
    d2 = d1 - sigma * np.sqrt(T)
    phi = np.vectorize(_phi)
    return S * phi(d1) - K * np.exp(-r * T) * phi(d2)
