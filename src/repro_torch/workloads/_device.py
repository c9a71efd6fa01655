"""Device programs for the data-dependent workload inner loops.

The eager :class:`~repro_torch.core.engine.APEngine` path reads the
response counter back to the host after every compare/write cycle, so the
data-dependent workloads (sort, knn, spmv, hist) run thousands of
sequential device round trips.  The programs here keep the whole inner
loop on the device:

* :func:`min_extract_rounds` — the MSB-first CAM min-extraction idiom
  shared by ``workloads/sort.py`` and ``workloads/knn.py``, as a Python
  loop over extraction rounds whose every step is a device op.  The eager
  "did any candidate respond?" branch becomes an on-device
  :func:`~repro_torch.core.engine.select_state`; rounds after the
  (data-dependent) termination point are masked no-ops.
* :func:`count_probes` — a batch of response-counter COMPAREs (the
  per-bin counting of ``histogram.py``, the per-(row, bit) tag-count
  accumulation of ``spmv.py``).

Both transfer their per-pass matched counts to the host ONCE per workload
phase and replay them through the engine's ``charge_*`` accounting, which
makes cycles / energy / events / trace arrays bit-identical to the eager
per-cycle path.

The megakernel mode (:func:`min_extract_rounds_mk`,
:func:`count_probes_mk`) runs each extraction round, or the whole probe
batch, as ONE op-group launch of ``kernels/ap_megakernel`` and retires
the host accounting in one vectorized :meth:`APEngine.charge_bulk` fold.

Port note: the reference compiles these loops with ``jax.jit`` and
``lax.scan``; here each is a Python loop of device ops (and, in
megakernel mode, one kernel launch a round) that reads nothing back until
the loop ends.  With a lane-sharded engine (``n_shards``) the planes and
tag stay split over the engine's devices for the whole loop, each round
runs as ``ap_megakernel.ops.run_group_sharded``'s segments, and a
round's termination reads the count summed over the shards.  ``obs`` counts
what the reference counts: ``kernels/launch/ap_megakernel/
min_extract_rounds`` once a megakernel-mode extraction, and
``kernels/launch/ap_megakernel`` once a host-level launch — here each
round's ``run_group`` call, where the reference's rounds are one compiled
program and count once.  The reference's ``workloads/retrace/*``
counters count JAX traces of these programs; the port traces and caches
nothing here, so it has no such counter.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import bitplane as bp
from repro_torch.core import engine as E
from repro_torch.core import isa
from repro_torch.core.bitplane import Field
from repro_torch.core.engine import (APEngine, PassSchedule, _next_pow2,
                                     schedule_tensors)
from repro_torch.kernels.ap_megakernel import ops as mk_ops
from repro_torch.kernels.ap_megakernel import ref as mk_ref


# ---------------------------------------------------------------------------
# shared min-extraction program (sort + knn)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MinExtractTrace:
    """Per-round matched counts of one device min-extraction program.

    Arrays are [rounds, ...]; narrowing axes run MSB -> LSB (the eager
    iteration order).  ``masked[r]`` is True for rounds after the
    data-dependent termination point (device no-ops the host never
    replays).  ``device_counters`` are the program's own on-device
    :class:`~repro_torch.core.engine.APState` counter totals,
    cross-checked against the host replay in the tests.
    """
    copy_sched: PassSchedule
    copy_matched: np.ndarray   # [R, P_copy] per-pass counts of cand<-active
    m1: np.ndarray             # [R, m] responders of the 0-probe compare
    m2: np.ndarray             # [R, m] responders of the retire compare
    take: np.ndarray           # [R, m] bool: the eager branch was taken
    count: np.ndarray          # [R] tie-group size of the extracted min
    tie_tag: np.ndarray        # [R, n_lanes] packed tie-group TAG (uint32)
    masked: np.ndarray         # [R] bool: round ran as a masked no-op
    device_counters: np.ndarray  # int32[N_COUNTERS]


def _to_host(*parts: torch.Tensor) -> list[np.ndarray]:
    """Bring several device tensors to the host in ONE transfer; each
    comes back as a NumPy array of its own dtype and shape."""
    flat = torch.cat([p.reshape(-1).to(torch.int64) for p in parts]).cpu()
    out, at = [], 0
    for p in parts:
        n = p.numel()
        dtype = {torch.bool: np.bool_, torch.int32: np.int32}[p.dtype]
        out.append(flat[at:at + n].numpy().astype(dtype).reshape(
            tuple(p.shape)))
        at += n
    return out


def _stack(items: list, shape: tuple, dtype, device) -> torch.Tensor:
    """``torch.stack(items)``, or an empty [0, *shape] tensor."""
    if items:
        return torch.stack(items)
    return torch.zeros((0, *shape), dtype=dtype, device=device)


def _index(vals, dev, dtype=torch.int64) -> torch.Tensor:
    return torch.tensor(vals, dtype=dtype, device=dev)


def min_extract_rounds(eng: APEngine, val: Field, active: Field, cand: Field,
                       rounds: int, remaining: int,
                       readout: bool = False) -> MinExtractTrace:
    """Run up to ``rounds`` min-extractions over ``active`` rows on device.

    One device program, one host transfer.  The engine adopts the final
    array state; NO cycles/energy are charged here — the caller replays
    the returned counts through :func:`replay_extract` + ``charge_*`` in
    eager order.  ``remaining`` is the termination budget (elements left
    to emit: n for sort, k for knn); ``readout`` adds knn's per-round
    responder readout + re-compare + retire to the program.
    """
    copy_sched = isa.copy(cand, active)
    dev = eng.device
    copy_tabs = schedule_tensors(copy_sched.cmp_cols, copy_sched.cmp_key,
                                 copy_sched.w_cols, copy_sched.w_key, dev)
    cols = np.concatenate([copy_sched.cmp_cols.ravel(),
                           copy_sched.w_cols.ravel()])
    copy_range = (int(cols.min()), int(cols.max()))
    # every constant the loop needs, uploaded once before it
    cand_c = _index([cand.col(0)], dev)
    active_c = _index([active.col(0)], dev)
    one = _index([1], dev, torch.int32)
    zero = _index([0], dev, torch.int32)
    key_10 = _index([1, 0], dev, torch.int32)
    key_11 = _index([1, 1], dev, torch.int32)
    probe_cols = [_index([cand.col(0), val.col(i)], dev)
                  for i in reversed(range(val.width))]

    st0 = eng.state()
    done = torch.zeros((), dtype=torch.bool, device=dev)
    rem = torch.tensor(remaining, dtype=torch.int32, device=dev)
    ys = [[] for _ in range(7)]
    for _ in range(rounds):
        st, copy_m = E.state_run(st0, *copy_tabs, col_range=copy_range)
        m1s, m2s, takes = [], [], []
        for cv in probe_cols:
            st_c, m1 = E.state_compare(st, cv, key_10)
            # the eager branch: if any candidate has a 0 here, retire the
            # 1-candidates — on device both arms run, one is selected
            st_b, m2 = E.state_compare(st_c, cv, key_11)
            st_b, _ = E.state_write(st_b, cand_c, zero)
            take = m1 > 0
            st = E.select_state(take, st_b, st_c)
            m1s.append(m1)
            m2s.append(m2)
            takes.append(take)
        st, count = E.state_compare(st, cand_c, one)
        tie_tag = st.tag
        if readout:
            # knn: sequential responder readout + re-compare + retire
            st = E.state_read_charge(st, count)
            st, _ = E.state_compare(st, cand_c, one)
            st, _ = E.state_write(st, active_c, zero)
        else:
            # sort: retire the tie group unless the active set was empty
            st_r, _ = E.state_write(st, active_c, zero)
            st = E.select_state(count > 0, st_r, st)
        new_rem = rem - count
        st_out = E.select_state(done, st0, st)
        rem_out = torch.where(done, rem, new_rem)
        done_out = done | (count == 0) | (new_rem <= 0)
        for y, v in zip(ys, (copy_m, torch.stack(m1s), torch.stack(m2s),
                             torch.stack(takes), count, tie_tag, done)):
            y.append(v)
        st0, done, rem = st_out, done_out, rem_out

    m, Pc, nl = val.width, copy_sched.n_passes, st0.tag.shape[0]
    i32, b = torch.int32, torch.bool
    copy_m, m1, m2, take, count, tie_tag, masked, ctr = _to_host(
        _stack(ys[0], (Pc,), i32, dev), _stack(ys[1], (m,), i32, dev),
        _stack(ys[2], (m,), i32, dev), _stack(ys[3], (m,), b, dev),
        _stack(ys[4], (), i32, dev), _stack(ys[5], (nl,), i32, dev),
        _stack(ys[6], (), b, dev), st0.counters)
    eng.adopt(st0)
    return MinExtractTrace(copy_sched, copy_m, m1, m2, take, count,
                           tie_tag.view(np.uint32), masked, ctr)


def replay_extract(eng: APEngine, tr: MinExtractTrace, r: int,
                   m: int) -> tuple[int, int]:
    """Charge round ``r``'s extraction events in eager order.

    Mirrors ``sort.extract_min`` exactly: the fused candidate copy, the
    MSB-first narrowing (second compare + retire write only where the
    branch was taken), and the final tie-group compare.  Returns
    (min_value, tie_count).
    """
    eng.charge_run(tr.copy_sched, tr.copy_matched[r])
    v = 0
    for pos, i in enumerate(reversed(range(m))):
        eng.charge_compare(2, tr.m1[r, pos])
        if tr.take[r, pos]:
            eng.charge_compare(2, tr.m2[r, pos])
            eng.charge_write(1, tr.m2[r, pos])
        else:
            v |= 1 << i
    eng.charge_compare(1, tr.count[r])
    return v, int(tr.count[r])


def tagged_rows(tag_row: np.ndarray) -> np.ndarray:
    """Row indices set in a packed TAG row (host-side unpack)."""
    shifts = np.arange(bp.LANE, dtype=np.uint32)
    bits = (np.asarray(tag_row, np.uint32)[:, None] >> shifts[None, :]) & 1
    return np.where(bits.reshape(-1))[0]


# ---------------------------------------------------------------------------
# batched response counting (hist + spmv)
# ---------------------------------------------------------------------------

def _pad_probes(cols, keys):
    """Probe tables padded to power-of-two (probes, columns) buckets, as
    the reference pads them: extra columns repeat column 0, extra probes
    repeat the last one."""
    cols = np.atleast_2d(np.asarray(cols, np.int32))
    keys = np.atleast_2d(np.asarray(keys, np.uint32))
    n_probes, k = cols.shape
    np2, k2 = _next_pow2(n_probes), _next_pow2(k)

    def pad(a):
        if k2 != k:
            a = np.concatenate(
                [a, np.repeat(a[:, :1], k2 - k, axis=1)], axis=1)
        if np2 != n_probes:
            a = np.concatenate(
                [a, np.repeat(a[-1:], np2 - n_probes, axis=0)], axis=0)
        return a

    return pad(cols), pad(keys), n_probes, k


def count_probes(eng: APEngine, cols, keys) -> np.ndarray:
    """Run a batch of COMPAREs as one device program; return responder
    counts [n_probes] (int64).

    The engine adopts the final state — TAG holds the LAST probe's
    responders, as after the eager loop — and every probe's compare
    cycle is charged in order.  (The reference also runs its bucket's
    padded probes, masked to no-ops; the loop here stops at the last real
    one, which leaves the same state and counts.)
    """
    cols_p, keys_p, n_probes, k = _pad_probes(cols, keys)
    dev = eng.device
    cols_t = torch.from_numpy(cols_p.astype(np.int64)).to(dev)
    keys_t = torch.from_numpy(keys_p.view(np.int32)).to(dev)
    st = eng.state()
    counts = []
    for i in range(n_probes):
        st, matched = E.state_compare(st, cols_t[i], keys_t[i])
        counts.append(matched)
    [got] = _to_host(_stack(counts, (), torch.int32, dev))
    counts = got.astype(np.int64)
    eng.adopt(st)
    for i in range(n_probes):
        eng.charge_compare(k, counts[i])
    return counts


# ---------------------------------------------------------------------------
# megakernel mode: op-group device programs + bulk (vectorized) host replay
# ---------------------------------------------------------------------------

def engine_backend(backend: str, mode: str) -> str:
    """Map a workload (backend, mode) pair to the :class:`APEngine`
    backend, as the reference does.

    ``mode="megakernel"`` lowers the engine's schedule path through the
    megakernel too: jnp -> 'megakernel', pallas -> 'megakernel_pallas'
    (both the megakernel here).  Every other mode keeps ``backend``."""
    if mode != "megakernel":
        return backend
    if backend in ("jnp", "megakernel"):
        return "megakernel"
    if backend in ("pallas", "megakernel_pallas"):
        return "megakernel_pallas"
    raise ValueError(f"unknown backend {backend!r}")


def _min_extract_group(copy_sched: PassSchedule, val: Field, active: Field,
                       cand: Field, readout: bool) -> mk_ref.OpGroup:
    """One min-extraction round as a static op group.

    Table layout (indices the trace decoder below relies on):
    [0, P_copy)            PASS     the cand <- active copy schedule
    P_copy + 3*pos + 0     CMP      probe (cand, val_bit)==(1, 0) -> m1
    P_copy + 3*pos + 1     CMP      retire probe ==(1, 1), iff m1 > 0
    P_copy + 3*pos + 2     WRITE    cand <- 0,              iff m1 > 0
    P_copy + 3*m           CMP      tie group (cand == 1) -> count
    then sort: WRITE active <- 0 iff count > 0
    or   knn: CMP cand == 1; WRITE active <- 0 (both unconditional;
    the sequential responder read rides the rounds loop's counters).
    """
    ops = []
    for p in range(copy_sched.n_passes):
        ops.append((mk_ref.OP_PASS, 0,
                    copy_sched.cmp_cols[p].tolist(),
                    copy_sched.cmp_key[p].tolist(),
                    copy_sched.w_cols[p].tolist(),
                    copy_sched.w_key[p].tolist()))
    c0 = cand.col(0)
    for i in reversed(range(val.width)):
        cv = [c0, val.col(i)]
        ops.append((mk_ref.OP_CMP, 0, cv, [1, 0], [], []))
        ops.append((mk_ref.OP_CMP, 1, cv, [1, 1], [], []))
        ops.append((mk_ref.OP_WRITE, 2, [], [], [c0], [0]))
    ops.append((mk_ref.OP_CMP, 0, [c0], [1], [], []))
    if readout:
        ops.append((mk_ref.OP_CMP, 0, [c0], [1], [], []))
        ops.append((mk_ref.OP_WRITE, 0, [], [], [active.col(0)], [0]))
    else:
        ops.append((mk_ref.OP_WRITE, 1, [], [], [active.col(0)], [0]))
    return mk_ref.OpGroup.build(ops)


def _mk_rounds(state: E.APState, dg: mk_ops.DeviceGroup, remaining: int,
               rounds: int, readout: bool, sg: mk_ops.ShardedGroup = None):
    """Run ``rounds`` op-group executions with the same termination /
    masking semantics as :func:`min_extract_rounds`: every round runs the
    group from the carried state, and a round past the end keeps that
    state (its counts are still recorded).  Returns the final state and
    the per-round (matched, tag, done) device tensors.

    A round carries only what the next round needs (planes, tag, the
    remaining count and whether the rounds are done); the counters follow
    after the loop from every round's counts at once: a round adds its
    delta unless the rounds were done before it (integer sums, so the
    order does not matter).

    With ``sg`` (a lane-sharded engine's group) the planes and tag stay
    split over ``sg.devices`` across the rounds and are laid side by side
    again at the end; ``dg`` then only supplies the tables the counters
    are formed from.
    """
    dev = state.planes.device
    count_idx = dg.n_ops - (3 if readout else 2)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    rem = torch.tensor(remaining, dtype=torch.int32, device=dev)
    if sg is None:
        devices = (dev,)
        planes, tag = [state.planes], [state.tag]

        def step(planes, tag):
            p, t, matched = mk_ops.run_group(planes[0], tag[0], dg)
            return [p], [t], matched
    else:
        devices = sg.devices
        planes, tag = mk_ops.split_lanes(state.planes, state.tag, devices)

        def step(planes, tag):
            obs.count("kernels/launch/ap_megakernel")
            obs.count("kernels/launch/ap_megakernel/jnp_sharded")
            return mk_ops.run_group_sharded(planes, tag, sg)
    ys = ([], [], [])
    for _ in range(rounds):
        new_planes, new_tag, matched = step(planes, tag)
        count = matched[count_idx]
        new_rem = rem - count
        out_tag = new_tag[0] if len(new_tag) == 1 \
            else torch.cat([t.to(dev) for t in new_tag])
        for y, v in zip(ys, (matched, out_tag, done)):
            y.append(v)
        keep = [done.to(d) for d in devices]
        planes = [torch.where(k, p, q)
                  for k, p, q in zip(keep, planes, new_planes)]
        tag = [torch.where(k, p, q) for k, p, q in zip(keep, tag, new_tag)]
        rem = torch.where(done, rem, new_rem)
        done = done | (count == 0) | (new_rem <= 0)
    planes, tag = (planes[0], tag[0]) if sg is None \
        else mk_ops.gather_lanes(planes, tag, dev)
    nl = state.tag.shape[0]
    ys = (_stack(ys[0], (dg.n_ops,), torch.int32, dev),
          _stack(ys[1], (nl,), torch.int32, dev),
          _stack(ys[2], (), torch.bool, dev))
    matched, _, was_done = ys
    delta = mk_ref.counter_delta(
        dg.op, matched, mk_ref.executed_ops(dg.cond, dg.enabled, matched))
    if readout:
        delta = delta + E._unit(dev, 1, 0, 0, 1, 0) * matched[:, count_idx,
                                                              None]
    counters = state.counters + (delta * (~was_done)[:, None]).sum(
        0, dtype=torch.int64).to(torch.int32)
    return E.APState(planes, tag, counters), ys


def min_extract_rounds_mk(eng: APEngine, val: Field, active: Field,
                          cand: Field, rounds: int, remaining: int,
                          readout: bool = False) -> MinExtractTrace:
    """Megakernel counterpart of :func:`min_extract_rounds`: each round
    is ONE op-group launch (sharded over lanes when the engine has
    ``n_shards``), returning the identical :class:`MinExtractTrace` so
    the replay layer is shared."""
    copy_sched = isa.copy(cand, active)
    group = _min_extract_group(copy_sched, val, active, cand, readout)
    obs.count("kernels/launch/ap_megakernel/min_extract_rounds")
    dg = mk_ops.device_group(group, eng.device)
    sg = None if eng.mesh is None else mk_ops.sharded_group(group, eng.mesh)
    state, ys = _mk_rounds(eng.state(), dg, remaining, rounds, readout, sg)
    matched, tie_tag, masked, ctr = _to_host(*ys, state.counters)
    eng.adopt(state)
    Pc = copy_sched.n_passes
    m = val.width
    base = Pc + 3 * np.arange(m)
    m1 = matched[:, base]
    m2 = matched[:, base + 1]
    return MinExtractTrace(copy_sched, matched[:, :Pc], m1, m2, m1 > 0,
                           matched[:, Pc + 3 * m], tie_tag.view(np.uint32),
                           masked, ctr)


def replay_extract_bulk(eng: APEngine, tr: MinExtractTrace, m: int,
                        budget: int, readout: bool = False
                        ) -> tuple[np.ndarray, np.ndarray, int]:
    """Charge every replayed round's events in ONE bulk fold.

    Replays exactly the rounds (and the per-round tails) the eager
    per-round loop would — sort: conditional tie-group retire, stop on
    a zero count; knn (``readout=True``): responder reads + re-compare
    + retire, stop when ``budget`` indices have been emitted — and
    folds them through :meth:`APEngine.charge_bulk`.  Returns
    (min_values[r_used], tie_counts[r_used], r_used); values follow
    from the recorded branch decisions (bit i of the round's minimum is
    1 iff the 0-probe at bit i had no responders).
    """
    counts = tr.count.astype(np.int64)
    R = counts.shape[0]
    r_used, out_len, tail = 0, 0, []
    if readout:
        while out_len < budget:
            out_len += min(int(counts[r_used]), budget - out_len)
            tail.append(True)
            r_used += 1
    else:
        while out_len < budget and r_used < R:
            c = int(counts[r_used])
            tail.append(c > 0)
            r_used += 1
            if c == 0:
                break
            out_len += c
    if r_used == 0:
        return np.zeros(0, np.uint64), counts[:0], 0

    Ru = r_used
    n = eng.n_words
    pw = eng.power
    sched = tr.copy_sched
    Pc = sched.n_passes
    take = tr.take[:Ru]                              # [Ru, m] bool
    cnt = counts[:Ru]
    tailp = np.asarray(tail, bool)

    # --- per-round scalar slots after the copy chunk:
    #     [cmp1, cmp2?, wr?] x m, count_cmp, then the tail
    S = 3 * m + (4 if readout else 2)
    present = np.zeros((Ru, S), bool)
    e_scal = np.zeros((Ru, S), np.float64)
    is_trace = np.ones(S, bool)
    c1, c2, wr = (3 * np.arange(m) + d for d in (0, 1, 2))
    present[:, c1] = True
    present[:, c2] = take
    present[:, wr] = take
    ci = 3 * m
    present[:, ci] = True
    if readout:
        rd, rc, rt = ci + 1, ci + 2, ci + 3
        present[:, rd:] = True
        is_trace[rd] = False                         # reads carry no event
    else:
        rt = ci + 1
        present[:, rt] = tailp
    delta = present.astype(np.int64)                 # cycles per slot
    if readout:
        delta[:, rd] = np.where(present[:, rd], cnt, 0)

    m1f = tr.m1[:Ru].astype(np.float64)
    m2f = tr.m2[:Ru].astype(np.float64)
    cf = cnt.astype(np.float64)
    e_scal[:, c1] = 2 * (pw.p_m * m1f + pw.p_mm * (n - m1f))
    e_scal[:, c2] = 2 * (pw.p_m * m2f + pw.p_mm * (n - m2f))
    e_scal[:, wr] = 1 * (pw.p_w * m2f + pw.p_mw * (n - m2f))
    e_scal[:, ci] = 1 * (pw.p_m * cf + pw.p_mm * (n - cf))
    if readout:
        e_scal[:, rc] = 1 * (pw.p_m * cf + pw.p_mm * (n - cf))
    e_scal[:, rt] = 1 * (pw.p_w * cf + pw.p_mw * (n - cf))

    # --- the copy chunk: per-pass energies exactly as charge_run
    kc = sched.kc.astype(np.float64)
    kw = sched.kw.astype(np.float64)
    mf = tr.copy_matched[:Ru].astype(np.float64)     # [Ru, Pc]
    e_pass = kc[None, :] * (pw.p_m * mf + pw.p_mm * (n - mf)) \
        + kw[None, :] * (pw.p_w * mf + pw.p_mw * (n - mf))
    chunk = e_pass.sum(axis=1)    # row-wise: identical to charge_run's 1D sum

    # --- absolute event cycles (post-increment, as eager appends them)
    round_delta = 2 * Pc + delta.sum(axis=1)
    c_start = eng.cycles + np.concatenate(
        [[0], np.cumsum(round_delta)[:-1]]).astype(np.int64)
    pass_cyc = c_start[:, None] + 2 * np.arange(1, Pc + 1, dtype=np.int64)
    scal_cyc = c_start[:, None] + 2 * Pc + np.cumsum(delta, axis=1)

    ev_present = present & is_trace[None, :]
    all_present = np.hstack([np.ones((Ru, Pc), bool), ev_present])
    trace_c = np.hstack([pass_cyc, scal_cyc])[all_present]
    trace_e = np.hstack([e_pass, e_scal])[all_present]
    terms = np.hstack([chunk[:, None], e_scal])[
        np.hstack([np.ones((Ru, 1), bool), ev_present])]

    m1s = tr.m1[:Ru].astype(np.int64)
    m2s = tr.m2[:Ru].astype(np.int64)
    n_cmp = int(present[:, c1].sum() + present[:, c2].sum()
                + present[:, ci].sum()
                + (present[:, rc].sum() if readout else 0))
    n_wr_ev = int(present[:, wr].sum() + present[:, rt].sum())
    match_sc = int(m1s.sum() + m2s[take].sum() + cnt.sum()
                   + (cnt.sum() if readout else 0))
    write_sc = int(m2s[take].sum() + cnt[tailp].sum())
    eng.charge_bulk(
        cycles=int(round_delta.sum()),
        compare_cycles=Pc * Ru + n_cmp,
        write_cycles=Pc * Ru + n_wr_ev,
        read_cycles=int(cnt.sum()) if readout else 0,
        energy_terms=terms, trace_cycles=trace_c, trace_energy=trace_e,
        match=int(mf.sum()) + match_sc,
        mismatch=(Pc * Ru + n_cmp) * n - (int(mf.sum()) + match_sc),
        write=int((kw[None, :] * mf).sum()) + write_sc,
        miswrite=int((kw[None, :] * (n - mf)).sum())
        + (n_wr_ev * n - write_sc))

    weights = np.uint64(1) << (m - 1 - np.arange(m, dtype=np.uint64))
    values = ((~take) * weights[None, :]).sum(axis=1, dtype=np.uint64)
    return values, cnt, r_used


def count_probes_mk(eng: APEngine, cols, keys) -> np.ndarray:
    """Megakernel counterpart of :func:`count_probes`: the whole probe
    batch is ONE op-group launch (CMP ops, padded probes disabled via
    the ``enabled`` mask), and all compare cycles are charged in one bulk
    fold."""
    cols_p, keys_p, n_probes, k = _pad_probes(cols, keys)
    group = mk_ref.OpGroup.probes(cols_p, keys_p)
    enabled = np.arange(cols_p.shape[0]) < n_probes
    eng.planes, eng.tag, matched = mk_ops.run_group(
        eng.planes, eng.tag, group, enabled, mesh=eng.mesh)
    counts = matched.cpu().numpy()[:n_probes].astype(np.int64)

    cf = counts.astype(np.float64)
    e = k * (eng.power.p_m * cf + eng.power.p_mm * (eng.n_words - cf))
    eng.charge_bulk(
        cycles=n_probes, compare_cycles=n_probes,
        energy_terms=e,
        trace_cycles=eng.cycles + np.arange(1, n_probes + 1, dtype=np.int64),
        trace_energy=e,
        match=int(counts.sum()),
        mismatch=n_probes * eng.n_words - int(counts.sum()))
    return counts
