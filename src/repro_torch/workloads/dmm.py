"""Dense Matrix Multiplication on the AP (paper §3.1 workload 3).

Layout: C = A @ B with n x n operands; PU (i,j) computes c_ij and holds
row i of A and column j of B *resident* (the paper's central point: storage
== compute, so there is no caches-to-PU synchronization term, eq (7)).

The inner product is n sequential MACs, each word-parallel over all n^2 PUs:

    cycles = n * O(m^2)     independent of the number of PUs.

The "shift" between successive k terms is free — each MAC simply activates
the bit-columns of the k-th resident operand pair (§2.2: "shift is
implemented by activating different bit columns").

The n per-term MAC schedules differ only in their operand columns, so
the engine's power-of-two buckets (`engine.bucket_schedule`) give the
whole sweep one table shape.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import arith
from repro_torch.core.engine import APEngine


def plan_bits(n: int, m: int) -> int:
    """Bit columns needed: n A-words + n B-words + accumulator + carry."""
    acc_w = 2 * m + max(1, int(np.ceil(np.log2(max(n, 2)))))
    return 2 * n * m + acc_w + 1


def ap_matmul(A: np.ndarray, B: np.ndarray, m: int = 8,
              backend: str = "jnp", *, device="cuda"
              ) -> tuple[np.ndarray, dict]:
    """C = A @ B on one AP; A, B: uint [n, n] with entries < 2^m.

    Returns (C, engine counters).  Exact (integer) result.
    """
    A = np.asarray(A, np.uint64)
    B = np.asarray(B, np.uint64)
    n = A.shape[0]
    if A.shape != (n, n) or B.shape != (n, n):
        raise ValueError("square operands only")
    if (A >= (1 << m)).any() or (B >= (1 << m)).any():
        raise ValueError(f"entries must fit in {m} bits")

    n_words = max(((n * n + 31) // 32) * 32, 32)   # round up to lane width
    n_bits = plan_bits(n, m)
    eng = APEngine(n_words=n_words, n_bits=n_bits, backend=backend,
                   device=device)

    a_f = [eng.alloc.alloc(m, f"a{k}") for k in range(n)]
    b_f = [eng.alloc.alloc(m, f"b{k}") for k in range(n)]
    acc_w = 2 * m + max(1, int(np.ceil(np.log2(max(n, 2)))))
    acc = eng.alloc.alloc(acc_w, "acc")
    carry = eng.alloc.alloc(1, "carry")

    # resident data: PU (i,j) holds A[i, :] and B[:, j]
    ii, jj = np.divmod(np.arange(n * n), n)
    for k in range(n):
        av = np.zeros(n_words, np.uint64)
        bv = np.zeros(n_words, np.uint64)
        av[: n * n] = A[ii, k]
        bv[: n * n] = B[k, jj]
        eng.load(a_f[k], av)
        eng.load(b_f[k], bv)

    data_cycles_before = eng.cycles  # loads charge nothing (host DMA)
    for k in range(n):
        arith.run_mac(eng, a_f[k], b_f[k], acc, carry)
    mac_cycles = eng.cycles - data_cycles_before

    C = eng.read(acc)[: n * n].reshape(n, n)
    counters = eng.counters()
    counters["trace_cycles"], counters["trace_energy"] = eng.trace_events()
    counters["mac_cycles"] = mac_cycles
    counters["n"] = n
    counters["m"] = m
    return C.astype(np.uint64), counters


def reference(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    return (np.asarray(A, np.uint64) @ np.asarray(B, np.uint64))
