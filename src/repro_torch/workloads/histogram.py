"""Histogram on the AP (response-counter binning).

Binning by the top ``log2(n_bins)`` value bits is free on the AP —
"shift is implemented by activating different bit columns" (§2.2), so a
bin id is just a COMPARE key over the high columns.  One COMPARE per bin
tags every word in that bin at once and the response counter (the same
popcount the engine's energy accounting meters) reads the bin count:

    cycles = n_bins     independent of the number of data words,

the extreme point of the word-parallel scaling the paper models.  The
data never moves; energy is dominated by the mismatching rows' line
discharges (p_mm), making this the cheapest-per-word workload in the
suite.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.engine import APEngine
from repro_torch.workloads import _device


def plan_bits(m: int) -> int:
    """Bit columns needed: just the resident values."""
    return m


def ap_histogram(x: np.ndarray, n_bins: int, m: int = 8,
                 backend: str = "jnp", mode: str = "device",
                 n_shards: int | None = None, *, device="cuda"
                 ) -> tuple[np.ndarray, dict]:
    """Histogram of unsigned ``x`` (< 2^m) into ``n_bins`` equal bins.

    ``n_bins`` must be a power of two dividing 2^m.  Returns
    (counts[n_bins], engine counters).  Exact.  ``mode="device"`` runs
    all bin probes as one device program (one host transfer);
    ``mode="eager"`` is the per-bin-sync oracle; ``mode="megakernel"``
    runs the probe batch as one fused op-group launch with bulk
    accounting (``n_shards`` shards the bitplanes over lanes).
    """
    if mode not in ("device", "eager", "megakernel"):
        raise ValueError(f"unknown mode {mode!r}")
    x = np.asarray(x, np.uint64)
    n = x.shape[0]
    if (x >= (1 << m)).any():
        raise ValueError(f"entries must fit in {m} bits")
    b = int(np.log2(max(n_bins, 1)))
    if n_bins < 2 or (1 << b) != n_bins or b > m:
        raise ValueError("n_bins must be a power of two in [2, 2^m]")

    n_words = max(((n + 31) // 32) * 32, 32)
    eng = APEngine(n_words=n_words, n_bits=plan_bits(m),
                   backend=_device.engine_backend(backend, mode),
                   n_shards=n_shards, device=device)
    val = eng.alloc.alloc(m, "val")
    buf = np.zeros(n_words, np.uint64)
    # padding rows hold the value 2^m - 1 shifted out of every bin probe?
    # no spare columns — instead park padding in the LAST bin and correct
    # the count host-side (the controller knows its own padding).
    pad = (1 << m) - 1
    buf[:n] = x
    buf[n:] = pad
    eng.load(val, buf)

    counts = np.zeros(n_bins, np.int64)
    cols = [val.col(i) for i in range(m - b, m)]   # top b columns
    keys = [[(k >> i) & 1 for i in range(b)] for k in range(n_bins)]
    if mode == "megakernel":
        counts[:] = _device.count_probes_mk(
            eng, np.tile(np.asarray(cols, np.int32), (n_bins, 1)),
            np.asarray(keys, np.uint32))
    elif mode == "device":
        counts[:] = _device.count_probes(
            eng, np.tile(np.asarray(cols, np.int32), (n_bins, 1)),
            np.asarray(keys, np.uint32))
    else:
        for k in range(n_bins):
            eng.compare(cols, keys[k])
            counts[k] = eng.tag_count()
    counts[n_bins - 1] -= n_words - n              # remove padding rows

    counters = eng.counters()
    counters["trace_cycles"], counters["trace_energy"] = eng.trace_events()
    counters["n"] = n
    counters["m"] = m
    return counts, counters


def reference(x: np.ndarray, n_bins: int, m: int = 8) -> np.ndarray:
    x = np.asarray(x, np.int64)
    return np.bincount(x >> (m - int(np.log2(n_bins))),
                       minlength=n_bins).astype(np.int64)
