"""Associative sort on the AP (min-extraction idiom, CAM folklore).

The classic CAM sort: keep an *active* marker column, and repeatedly
extract the minimum of the active rows by an MSB-first candidate
narrowing — for each bit position, COMPARE selects the candidates with a
0 at that bit; if any respond (response counter > 0) the 1-candidates
are retired with a tagged WRITE, otherwise the minimum's bit is 1 and
the candidate set is unchanged.  After the LSB the surviving candidates
all hold the minimum, its value is known host-side from the bit
decisions, and the whole tie group is retired at once, so the cost is

    cycles = O(distinct_values * m)     independent of the PU count,

the word-parallel advantage eq (7) models.  Energy flows through the
engine's exact matched-row accounting like every other workload.

Three execution modes, same bit-exact results and accounting:

* ``mode="device"`` (default) — the whole extraction loop runs on the
  device (``_device.min_extract_rounds``), with the response-counter
  branch as an on-device select and one host transfer total;
* ``mode="megakernel"`` — each extraction round is one op-group launch
  of ``kernels/ap_megakernel``, with one bulk accounting fold;
* ``mode="eager"`` — the original per-cycle loop, kept as the oracle.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import isa
from repro_torch.core.bitplane import Field
from repro_torch.core.engine import APEngine
from repro_torch.workloads import _device


def plan_bits(m: int) -> int:
    """Bit columns needed: value + active marker + candidate marker."""
    return m + 2


def extract_min(eng: APEngine, val: Field, active: Field,
                cand: Field) -> tuple[int, int]:
    """One CAM min-extraction over the rows with ``active`` == 1.

    MSB-first narrowing of the candidate set (copied from ``active``);
    leaves TAG selecting the minimum's tie group.  Returns
    (min_value, tie_count); tie_count == 0 means no row was active.
    """
    eng.run(isa.copy(cand, active))
    v = 0
    for i in reversed(range(val.width)):
        eng.compare([cand.col(0), val.col(i)], [1, 0])
        if eng.tag_count() > 0:
            # some candidate has a 0 here: retire the 1-candidates
            eng.compare([cand.col(0), val.col(i)], [1, 1])
            eng.write([cand.col(0)], [0])
        else:
            v |= 1 << i
    eng.compare([cand.col(0)], [1])
    return v, eng.tag_count()


def ap_sort(x: np.ndarray, m: int = 8, backend: str = "jnp",
            mode: str = "device", n_shards: int | None = None, *,
            device="cuda") -> tuple[np.ndarray, dict]:
    """Sort unsigned integers ``x`` (< 2^m) ascending on an n-PU AP.

    Returns (sorted array, engine counters).  Exact.
    ``mode="megakernel"`` runs each extraction round as one fused
    op-group launch plus a single bulk accounting fold (bit-identical
    to both other modes); ``n_shards`` (megakernel only) shards the
    bitplanes over that many local devices' lanes.
    """
    if mode not in ("device", "eager", "megakernel"):
        raise ValueError(f"unknown mode {mode!r}")
    x = np.asarray(x, np.uint64)
    n = x.shape[0]
    if (x >= (1 << m)).any():
        raise ValueError(f"entries must fit in {m} bits")

    n_words = max(((n + 31) // 32) * 32, 32)
    eng = APEngine(n_words=n_words, n_bits=plan_bits(m),
                   backend=_device.engine_backend(backend, mode),
                   n_shards=n_shards, device=device)
    val = eng.alloc.alloc(m, "val")
    active = eng.alloc.alloc(1, "active")
    cand = eng.alloc.alloc(1, "cand")

    buf = np.zeros(n_words, np.uint64)
    buf[:n] = x
    eng.load(val, buf)
    mask = np.zeros(n_words, np.uint64)
    mask[:n] = 1
    eng.load(active, mask)

    out: list[int] = []
    if mode == "megakernel":
        rounds = min(n, 1 << m)
        tr = _device.min_extract_rounds_mk(eng, val, active, cand, rounds,
                                           remaining=n)
        vals, cnts, _ = _device.replay_extract_bulk(eng, tr, m, budget=n)
        out = np.repeat(vals, cnts)[:n].tolist()
    elif mode == "device":
        # at most one extraction per distinct value; rounds past the
        # data-dependent end run as masked no-ops on device
        rounds = min(n, 1 << m)
        tr = _device.min_extract_rounds(eng, val, active, cand, rounds,
                                        remaining=n)
        r = 0
        while len(out) < n and r < rounds:
            v, count = _device.replay_extract(eng, tr, r, m)
            if count == 0:
                break
            out.extend([v] * count)
            eng.charge_write(1, count)      # retire the tie group
            r += 1
    else:
        while len(out) < n:
            v, count = extract_min(eng, val, active, cand)
            if count == 0:  # defensive: active set exhausted early
                break
            out.extend([v] * count)
            eng.write([active.col(0)], [0])  # TAG still holds the tie group

    counters = eng.counters()
    counters["trace_cycles"], counters["trace_energy"] = eng.trace_events()
    counters["n"] = n
    counters["m"] = m
    return np.asarray(out[:n], np.uint64), counters


def reference(x: np.ndarray) -> np.ndarray:
    return np.sort(np.asarray(x, np.uint64))
