"""Sparse matrix-vector multiply on the AP (tag-masked accumulation).

y = A @ x with A sparse: one PU per stored nonzero, holding the triple
(row index, a_ij, x_j) resident — the gather of x_j happens at load time
(host DMA), so the irregular access pattern that cripples a cached SIMD
costs the AP nothing.  Two phases:

1. *products* — prod = a * x word-parallel over every nonzero at once
   (``arith.run_mul``, O(m^2) cycles total, the eq-(7) advantage);
2. *reduction* — tag-masked accumulation: for output row i and product
   bit b, one COMPARE tags the nonzeros with ``row == i`` and bit b set;
   the response counter contributes ``count << b`` to y_i host-side
   (the CAM's population count is the adder tree).

    cycles = O(m^2) + O(n_rows * 2m)    independent of nnz.

Exact (integer) result; energy through the engine's matched-row
accounting.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import arith
from repro_torch.core.engine import APEngine
from repro_torch.workloads import _device


def plan_bits(n_rows: int, m: int) -> int:
    """Bit columns: row index + a + x + product + carry."""
    r_w = max(1, int(np.ceil(np.log2(max(n_rows, 2)))))
    return r_w + 2 * m + 2 * m + 1


def ap_spmv(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
            x: np.ndarray, n_rows: int, m: int = 8,
            backend: str = "jnp", mode: str = "device",
            n_shards: int | None = None, *, device="cuda"
            ) -> tuple[np.ndarray, dict]:
    """y = A @ x for A in COO form (rows, cols, vals); entries < 2^m.

    Returns (y[n_rows], engine counters).  Exact (integer).
    ``mode="device"`` runs the whole per-(row, bit) tag-count reduction
    as one device program; ``mode="eager"`` is the per-probe oracle;
    ``mode="megakernel"`` fuses the probe batch into one op-group
    launch with bulk accounting (``n_shards`` shards the lanes).
    """
    if mode not in ("device", "eager", "megakernel"):
        raise ValueError(f"unknown mode {mode!r}")
    rows = np.asarray(rows, np.uint64)
    cols = np.asarray(cols, np.uint64)
    vals = np.asarray(vals, np.uint64)
    x = np.asarray(x, np.uint64)
    nnz = vals.shape[0]
    if (vals >= (1 << m)).any() or (x >= (1 << m)).any():
        raise ValueError(f"entries must fit in {m} bits")
    if nnz == 0:
        raise ValueError("empty matrix")

    r_w = max(1, int(np.ceil(np.log2(max(n_rows, 2)))))
    n_words = max(((nnz + 31) // 32) * 32, 32)
    eng = APEngine(n_words=n_words, n_bits=plan_bits(n_rows, m),
                   backend=_device.engine_backend(backend, mode),
                   n_shards=n_shards, device=device)
    row_f = eng.alloc.alloc(r_w, "row")
    a_f = eng.alloc.alloc(m, "a")
    x_f = eng.alloc.alloc(m, "x")
    prod = eng.alloc.alloc(2 * m, "prod")
    carry = eng.alloc.alloc(1, "carry")

    def pad(v, fill=0):
        buf = np.full(n_words, fill, np.uint64)
        buf[:nnz] = v
        return buf

    # padding rows get row index n_rows-1 but a = x = 0 => zero products
    eng.load(row_f, pad(rows, fill=n_rows - 1))
    eng.load(a_f, pad(vals))
    eng.load(x_f, pad(x[cols]))          # the load-time gather

    arith.run_mul(eng, a_f, x_f, prod, carry)

    y = np.zeros(n_rows, np.int64)
    row_cols = row_f.cols()
    if mode in ("device", "megakernel"):
        probe_cols = np.asarray([row_cols + [prod.col(b)]
                                 for i in range(n_rows)
                                 for b in range(2 * m)], np.int32)
        probe_keys = np.asarray([[(i >> rb) & 1 for rb in range(r_w)] + [1]
                                 for i in range(n_rows)
                                 for _ in range(2 * m)], np.uint32)
        probe = (_device.count_probes_mk if mode == "megakernel"
                 else _device.count_probes)
        counts = probe(eng, probe_cols, probe_keys)
        for i in range(n_rows):
            for b in range(2 * m):
                y[i] += int(counts[i * 2 * m + b]) << b
    else:
        for i in range(n_rows):
            key = [(i >> b) & 1 for b in range(r_w)]
            for b in range(2 * m):
                eng.compare(row_cols + [prod.col(b)], key + [1])
                y[i] += eng.tag_count() << b

    counters = eng.counters()
    counters["trace_cycles"], counters["trace_energy"] = eng.trace_events()
    counters["nnz"] = nnz
    counters["n_rows"] = n_rows
    counters["m"] = m
    return y, counters


def reference(rows, cols, vals, x, n_rows: int) -> np.ndarray:
    y = np.zeros(n_rows, np.int64)
    np.add.at(y, np.asarray(rows, np.int64),
              np.asarray(vals, np.int64) * np.asarray(x, np.int64)[cols])
    return y
