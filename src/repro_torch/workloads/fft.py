"""N-point radix-2 FFT on the AP (paper §3.1 workload 2).

One PU per point; fixed-point complex data (two's complement, Q-format).
Each of the log2(N) stages is:

  1. *exchange*      — every PU obtains its butterfly partner's (re, im)
                       through the Interconnect (paper §2.1/§2.2).  Two
                       models: ``parallel`` (circuit-switched network: one
                       transfer cycle per active bit-column) and ``serial``
                       (memory reads/writes: 2 cycles per word), both charged
                       to the engine's cycle counter.
  2. *twiddle bcast* — stage-s twiddles take 2^s distinct values; each is
                       broadcast by an index-matched compare + tagged write
                       (the paper's LUT idiom, constants carried in the
                       instruction stream).  Sum over stages: 2(N-1) passes.
  3. *butterfly*     — word-parallel: val = lower ? self : partner;
                       t = w * val (4 signed muls + add/sub, O(m^2));
                       out = upper ? base+t : base-t via conditional
                       add/subtract pass schedules.

Total: O(m^2 log N) compute cycles — length-independent per stage, the
core AP advantage the paper models with s_APU.

Per-stage butterfly/twiddle schedules vary slightly in pass count and
column fan-in; the engine's shape-bucketed runner
(`engine.bucket_schedule`) folds them onto a handful of table
shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import arith, isa
from repro_torch.core.bitplane import Field
from repro_torch.core.engine import APEngine


def _to_fixed(x: np.ndarray, frac: int, m: int) -> np.ndarray:
    v = np.round(np.asarray(x, np.float64) * (1 << frac)).astype(np.int64)
    lim = 1 << (m - 1)
    v = np.clip(v, -lim, lim - 1)
    return v & ((1 << m) - 1)


def _from_fixed(u: np.ndarray, frac: int, m: int) -> np.ndarray:
    u = np.asarray(u, np.int64)
    sign = u >> (m - 1)
    return (u - (sign << m)).astype(np.float64) / (1 << frac)


@dataclasses.dataclass
class _Plan:
    re: Field
    im: Field
    pre: Field
    pim: Field
    vre: Field
    vim: Field
    prod: Field
    t_re: Field
    t_im: Field
    wre: Field
    wim: Field
    idx: Field
    lower: Field
    carry: Field
    sa: Field
    sb: Field
    z: Field


def _interconnect_exchange(eng: APEngine, src: Field, dst: Field,
                           perm: np.ndarray, mode: str) -> None:
    """dst[p] <- src[perm[p]] for all PUs, charging interconnect cycles."""
    vals = eng.peek(src)          # host mediates the transfer model
    eng.load(dst, vals[perm])
    if mode == "parallel":
        # circuit-switched: all PUs move one bit-column per cycle
        eng.cycles += 2 * src.width            # read-out + write-in per column
    elif mode == "serial":
        # associative read + write per word (paper's serial option)
        eng.cycles += 2 * eng.n_words
        eng.read_cycles += eng.n_words
    else:
        raise ValueError(mode)


def _broadcast_twiddles(eng: APEngine, plan: _Plan, stage: int, n: int,
                        frac: int, m: int) -> None:
    """Write stage twiddles by index-matched compare+write (LUT idiom)."""
    half = 1 << stage
    step = n // (2 * half)
    for t in range(half):
        w = np.exp(-2j * np.pi * (t * step) / n)
        wre = int(_to_fixed(np.array([w.real]), frac, m)[0])
        wim = int(_to_fixed(np.array([w.imag]), frac, m)[0])
        cols = [plan.idx.col(b) for b in range(stage)]  # idx mod half == t
        key = [(t >> b) & 1 for b in range(stage)]
        if not cols:  # stage 0: all PUs share w = 1
            eng.bwrite(plan.wre.cols() + plan.wim.cols(),
                       [(wre >> i) & 1 for i in range(m)]
                       + [(wim >> i) & 1 for i in range(m)])
            continue
        eng.compare(cols, key)
        eng.write(plan.wre.cols() + plan.wim.cols(),
                  [(wre >> i) & 1 for i in range(m)]
                  + [(wim >> i) & 1 for i in range(m)])


def ap_fft(x: np.ndarray, m: int = 16, frac: int = 12,
           interconnect: str = "parallel", backend: str = "jnp", *,
           device="cuda") -> tuple[np.ndarray, dict]:
    """FFT of complex vector x (|x| <= 1 advisable) on an N-PU AP.

    Returns (X as complex128 from the fixed-point result, counters).
    """
    x = np.asarray(x, np.complex128)
    n = x.shape[0]
    if n & (n - 1):
        raise ValueError("N must be a power of two")
    stages = int(np.log2(n))
    n_words = max(n, 32)

    # columns: data + partner + operand + product + t + w + idx + flags
    n_bits = (2 + 2 + 2 + 0 + 2 + 2) * m + 2 * m + stages + 6
    eng = APEngine(n_words=n_words, n_bits=n_bits, backend=backend,
                   device=device)
    a = eng.alloc
    plan = _Plan(
        re=a.alloc(m, "re"), im=a.alloc(m, "im"),
        pre=a.alloc(m, "pre"), pim=a.alloc(m, "pim"),
        vre=a.alloc(m, "vre"), vim=a.alloc(m, "vim"),
        prod=a.alloc(2 * m, "prod"),
        t_re=a.alloc(m, "tre"), t_im=a.alloc(m, "tim"),
        wre=a.alloc(m, "wre"), wim=a.alloc(m, "wim"),
        idx=a.alloc(max(stages, 1), "idx"),
        lower=a.alloc(1, "lower"), carry=a.alloc(1, "carry"),
        sa=a.alloc(1, "sa"), sb=a.alloc(1, "sb"), z=a.alloc(1, "z"))

    # bit-reversed input order (standard iterative DIT)
    rev = np.array([int(format(i, f"0{stages}b")[::-1], 2) for i in range(n)])
    re0 = np.zeros(n_words, np.uint64)
    im0 = np.zeros(n_words, np.uint64)
    re0[:n] = _to_fixed(x.real[rev], frac, m)
    im0[:n] = _to_fixed(x.imag[rev], frac, m)
    eng.load(plan.re, re0)
    eng.load(plan.im, im0)
    idxs = np.zeros(n_words, np.uint64)
    idxs[:n] = np.arange(n)
    eng.load(plan.idx, idxs)

    def smul(dst: Field, af: Field, bf: Field):
        """dst <- (af * bf) >> frac  (signed Q-format multiply)."""
        arith.run_signed_mul(eng, af, bf, plan.prod, plan.carry,
                             plan.sa, plan.sb, plan.z)
        eng.run(isa.copy(dst, plan.prod.slice(frac, m)))

    for s in range(stages):
        half = 1 << s
        # 1. exchange with butterfly partner (i XOR half)
        perm = (np.arange(n_words) ^ half) % n_words
        perm[n:] = np.arange(n, n_words)
        _interconnect_exchange(eng, plan.re, plan.pre, perm, interconnect)
        _interconnect_exchange(eng, plan.im, plan.pim, perm, interconnect)
        # lower flag = bit s of index (1 => this PU is x[j], j = i + half)
        eng.run(isa.copy(plan.lower, plan.idx.bit(s)))
        # 2. twiddles
        _broadcast_twiddles(eng, plan, s, n, frac, m)
        # 3. operand select: val = lower ? self : partner
        eng.run(isa.copy(plan.vre, plan.pre))
        eng.run(isa.cond_copy(plan.vre, plan.re, plan.lower))
        eng.run(isa.copy(plan.vim, plan.pim))
        eng.run(isa.cond_copy(plan.vim, plan.im, plan.lower))
        # t = w * val  (complex):  t_re = wr*vr - wi*vi ; t_im = wr*vi + wi*vr
        smul(plan.t_re, plan.wre, plan.vre)
        smul(plan.t_im, plan.wre, plan.vim)
        smul(plan.vre, plan.wim, plan.vre)   # vre <- wi*vr (vre consumed last)
        smul(plan.vim, plan.wim, plan.vim)   # vim <- wi*vi
        eng.clear(plan.carry)
        eng.run(isa.sub(plan.vim, plan.t_re, plan.carry))   # t_re -= wi*vi
        eng.clear(plan.carry)
        eng.run(isa.add(plan.vre, plan.t_im, plan.carry))   # t_im += wi*vr
        # 4. base = lower ? partner : self, then out = base +/- t
        eng.run(isa.cond_copy(plan.re, plan.pre, plan.lower))
        eng.run(isa.cond_copy(plan.im, plan.pim, plan.lower))
        for val_f, t_f in ((plan.re, plan.t_re), (plan.im, plan.t_im)):
            eng.clear(plan.carry)
            eng.run(arith.cond_sub(t_f, val_f, plan.carry, plan.lower))
            # upper: add (condition = NOT lower, via inverted compare key)
            eng.clear(plan.carry)
            sched = arith.cond_add(t_f, val_f, plan.carry, plan.lower)
            # flip the condition key bit: passes matched on lower==1 -> ==0
            flip = sched.cmp_key.copy()
            flip[:, 0] = 1 - flip[:, 0]
            sched.cmp_key = flip
            eng.run(sched)

    re = _from_fixed(eng.read(plan.re)[:n], frac, m)
    im = _from_fixed(eng.read(plan.im)[:n], frac, m)
    counters = eng.counters()
    counters["trace_cycles"], counters["trace_energy"] = eng.trace_events()
    counters["n"] = n
    counters["m"] = m
    return re + 1j * im, counters


def reference(x: np.ndarray) -> np.ndarray:
    return np.fft.fft(np.asarray(x, np.complex128))
