"""k-nearest-neighbour search on the AP — the CAM-native workload.

The database lives in the CAM, one PU per point; the query never touches
memory.  L1 distance, exact, in two phases:

1. *distance* — per feature f the constant |x_f - q_f| map is applied by
   the paper's LUT idiom (``isa.lut``: one pass per nonzero table entry,
   the query folds into the compare keys) and added into a distance
   accumulator — word-parallel over all points, O(d * 2^m) cycles;
2. *select* — k rounds of the MSB-first min-extraction from
   ``workloads.sort``; each round's winners read out their resident index
   field sequentially (1 cycle/responder, §2.1) and retire.

    cycles = O(d * 2^m + k * m)     independent of the database size,

which is why associative memories were built for this search in the
first place.  Ties are broken by ascending row order, matching the
NumPy oracle.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import isa
from repro_torch.core.engine import APEngine
from repro_torch.workloads import _device
from repro_torch.workloads.sort import extract_min


def plan_bits(d: int, m: int, n: int) -> int:
    """Bit columns: d features + |diff| scratch + distance acc + index
    + active/cand markers + carry."""
    acc_w = m + max(1, int(np.ceil(np.log2(max(d, 2)))))
    idx_w = max(1, int(np.ceil(np.log2(max(n, 2)))))
    return d * m + m + acc_w + idx_w + 3


def ap_knn(db: np.ndarray, q: np.ndarray, k: int, m: int = 4,
           backend: str = "jnp", mode: str = "device",
           n_shards: int | None = None, *, device="cuda"
           ) -> tuple[np.ndarray, dict]:
    """Indices of the k nearest rows of ``db`` to ``q`` (L1, ascending).

    db: uint [n, d] with entries < 2^m; q: uint [d].  Returns
    (indices[k], engine counters).  Exact; ties by row order.
    ``mode="device"`` runs the k min-extraction rounds (including the
    responder readout) as one device program; ``mode="eager"`` is the
    per-cycle oracle; ``mode="megakernel"`` fuses each round into one
    op-group launch with bulk accounting (``n_shards`` shards lanes).
    """
    if mode not in ("device", "eager", "megakernel"):
        raise ValueError(f"unknown mode {mode!r}")
    db = np.asarray(db, np.uint64)
    q = np.asarray(q, np.uint64)
    n, d = db.shape
    if (db >= (1 << m)).any() or (q >= (1 << m)).any():
        raise ValueError(f"entries must fit in {m} bits")
    if not 1 <= k <= n:
        raise ValueError("k out of range")

    acc_w = m + max(1, int(np.ceil(np.log2(max(d, 2)))))
    idx_w = max(1, int(np.ceil(np.log2(max(n, 2)))))
    n_words = max(((n + 31) // 32) * 32, 32)
    eng = APEngine(n_words=n_words, n_bits=plan_bits(d, m, n),
                   backend=_device.engine_backend(backend, mode),
                   n_shards=n_shards, device=device)
    a = eng.alloc
    feat = [a.alloc(m, f"f{j}") for j in range(d)]
    diff = a.alloc(m, "diff")
    acc = a.alloc(acc_w, "acc")
    idx = a.alloc(idx_w, "idx")
    active = a.alloc(1, "active")
    cand = a.alloc(1, "cand")
    carry = a.alloc(1, "carry")

    def pad(v, fill=0):
        buf = np.full(n_words, fill, np.uint64)
        buf[:n] = v
        return buf

    for j in range(d):
        eng.load(feat[j], pad(db[:, j]))
    eng.load(idx, pad(np.arange(n)))
    eng.load(active, pad(np.ones(n)))

    # distance accumulation: acc += |f_j - q_j| via the LUT idiom
    eng.clear(acc)
    for j in range(d):
        qj = int(q[j])
        eng.clear(diff)
        eng.run(isa.lut(feat[j], diff, lambda v, qj=qj: abs(v - qj)))
        eng.clear(carry)
        eng.run(_add_zext(diff, acc, carry))

    # k min-extractions; winners read out their index field
    out: list[int] = []
    if mode == "megakernel":
        idx_vals = pad(np.arange(n))
        tr = _device.min_extract_rounds_mk(eng, acc, active, cand, rounds=k,
                                           remaining=k, readout=True)
        _, _, r_used = _device.replay_extract_bulk(eng, tr, acc.width,
                                                   budget=k, readout=True)
        for r in range(r_used):
            rows = _device.tagged_rows(tr.tie_tag[r])
            out.extend(int(v) for v in idx_vals[rows][:k - len(out)])
    elif mode == "device":
        idx_vals = pad(np.arange(n))            # idx field is never written
        tr = _device.min_extract_rounds(eng, acc, active, cand, rounds=k,
                                        remaining=k, readout=True)
        r = 0
        while len(out) < k:
            _, count = _device.replay_extract(eng, tr, r, acc.width)
            rows = _device.tagged_rows(tr.tie_tag[r])   # TAG = the tie group
            eng.charge_read(len(rows))
            ids = idx_vals[rows]
            out.extend(int(v) for v in ids[:k - len(out)])
            eng.charge_compare(1, count)
            eng.charge_write(1, count)          # retire the whole group
            r += 1
    else:
        while len(out) < k:
            _, count = extract_min(eng, acc, active, cand)
            rows, ids = eng.read_tagged(idx)    # TAG = the tie group
            out.extend(int(v) for v in ids[:k - len(out)])
            eng.compare([cand.col(0)], [1])
            eng.write([active.col(0)], [0])     # retire the whole group

    counters = eng.counters()
    counters["trace_cycles"], counters["trace_energy"] = eng.trace_events()
    counters["n"] = n
    counters["d"] = d
    counters["m"] = m
    return np.asarray(out, np.int64), counters


def _add_zext(a, b, carry):
    """b <- b + zext(a): add a (narrower) into b, carry rippling up."""
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


def reference(db: np.ndarray, q: np.ndarray, k: int) -> np.ndarray:
    dist = np.abs(np.asarray(db, np.int64)
                  - np.asarray(q, np.int64)[None, :]).sum(axis=1)
    return np.argsort(dist, kind="stable")[:k].astype(np.int64)
