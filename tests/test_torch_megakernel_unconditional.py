"""The megakernel's unconditional path: a plain-PyTorch emulation of the
CUDA kernel's algorithm, held against the port's plain version and the
JAX reference's ``run_group``.

An unconditional group (``cond == 0`` everywhere) runs in independent
CTAs over slices of the lane axis, as ``ops.plan_unconditional`` plans
them.  ``_emulate`` repeats what ``op_group`` does there, from the
records ``ops.records`` decodes on the host: a slice's tile of the
tables' rows (zero-padded to the slice width), only the enabled ops, in
order; an op's first one or two compare groups (two where GC is 4 and
there are more than four compare terms) and first write group from its
record, further groups out of line; every row of a group loaded before
any is stored; the compare, tag and writes selected by the record's
masks, never by the opcode; each thread's count of an op as one byte,
summed over the threads and then over the CTAs.  It must equal
``ref.group_scan_plain`` and the reference's ``run_group`` (jnp, and its
Pallas kernel in interpret mode) bit for bit: planes, tag and matched.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ap_megakernel import OpGroup as JOpGroup
from repro.kernels.ap_megakernel import run_group as j_run_group
from repro_torch import interop
from repro_torch.kernels.ap_megakernel import ops, ref


def _emulate(planes, tag, group, enabled, plan):
    """``op_group`` for an unconditional group under ``plan``, in plain
    PyTorch -> (planes', tag', matched int32[P])."""
    assert not group.conditional and plan.cluster == 1
    P, kc = group.cmp_cols.shape
    kw = group.w_cols.shape[1]
    cols = np.concatenate([group.cmp_cols.ravel(), group.w_cols.ravel()])
    lo, hi = int(cols.min()), int(cols.max())
    rec = ops.records(group, lo)
    signed = rec.view(np.int32)
    gc, gw = ops.group_sizes(kc, kw)
    n_cg, n_wg = -(-kc // gc), -(-kw // gw)
    in_regs = 2 if gc == 4 and n_cg > 1 else 1   # compare groups registered
    en = np.ones(P, bool) if enabled is None else np.asarray(enabled, bool)
    n_bits, n = planes.shape
    out, out_tag = planes.clone(), tag.clone()
    matched = np.zeros(P, np.int64)
    threads = plan.threads
    lpt = max(plan.lpt, 1)
    for c in range(plan.ctas):
        a, b = min(c * plan.slice, n), min((c + 1) * plan.slice, n)
        tile = torch.zeros((hi - lo + 1, plan.slice), dtype=torch.int32)
        tg = torch.zeros(plan.slice, dtype=torch.int32)
        tile[:, :b - a], tg[:b - a] = planes[lo:hi + 1, a:b], tag[a:b]
        live = torch.arange(plan.slice) < b - a
        # the thread that owns each lane of the slice
        owner = torch.arange(plan.slice) // lpt if plan.path == "shared" \
            else torch.arange(plan.slice) % threads

        def group_terms(p: int, v: int, size: int):
            rows = [int(x) for x in rec[p, v, :size]]
            keys = [int(x) for x in signed[p, v + 1, :size]]
            return rows, keys

        for p in np.nonzero(en)[0]:           # only the ops that run
            head = signed[p, 0]
            a_mask, b_mask, wm_mask = (int(x) for x in head[1:4])
            t = torch.full_like(tg, -1)
            groups = [group_terms(p, 1 + 2 * g, gc) for g in range(in_regs)]
            groups += [group_terms(p, 1 + 2 * g, gc)
                       for g in range(in_regs, n_cg)]   # out of line
            for rows, keys in groups:
                old = [tile[r].clone() for r in rows]
                for row, key in zip(old, keys):
                    t = t & ~(row ^ key)
            w = (t | a_mask) & (tg | b_mask)
            wm = w & wm_mask
            bits = torch.tensor([bin(int(x) & 0xFFFFFFFF).count("1")
                                 for x in w])
            per_thread = torch.zeros(threads, dtype=torch.int64)
            per_thread.index_add_(0, owner[live], bits[live])
            assert int(per_thread.max()) <= 255     # one byte a thread
            matched[p] += int(per_thread.sum())
            for g in range(n_wg):
                rows, keys = group_terms(p, 1 + 2 * n_cg + 2 * g, gw)
                old = [tile[r].clone() for r in rows]
                for r, o, key in zip(rows, old, keys):
                    tile[r] = (o & ~wm) | (key & wm)
            tg = (w & ~wm_mask) | (tg & wm_mask)
        out[lo:hi + 1, a:b], out_tag[a:b] = tile[:, :b - a], tg[:b - a]
    return out, out_tag, torch.from_numpy(matched.astype(np.int32))


def _random_group(rng, n_bits: int, P: int, max_c: int, max_w: int):
    """Random unconditional ops of every kind, up to ``max_c`` compare and
    ``max_w`` write terms; a CMP_TAG right after a CMP; a column written
    twice in one op with different keys."""
    ops_ = []
    for _ in range(P):
        nc = int(rng.integers(1, max_c + 1))
        nw = int(rng.integers(1, max_w + 1))
        ops_.append((int(rng.integers(0, 4)), 0,
                     rng.integers(0, n_bits, nc).tolist(),
                     rng.integers(0, 2, nc).tolist(),
                     rng.integers(0, n_bits, nw).tolist(),
                     rng.integers(0, 2, nw).tolist()))
    ops_[1] = (ref.OP_CMP, 0, [1, 2], [1, 0], [], [])
    ops_[2] = (ref.OP_CMP_TAG, 0, [3], [1], [], [])
    ops_[-1] = (ref.OP_WRITE, 0, [], [], [3, 5, 3], [1, 0, 0])
    return ref.OpGroup.build(ops_)


def _state(rng, n_bits: int, n_lanes: int):
    planes = rng.integers(0, 2 ** 32, (n_bits, n_lanes),
                          dtype=np.uint64).astype(np.uint32)
    tag = rng.integers(0, 2 ** 32, n_lanes, dtype=np.uint64).astype(
        np.uint32)
    return planes, tag


def _reference(planes, tag, group, enabled, **kw):
    jgroup = JOpGroup(*group.tables())
    p, t, m = j_run_group(jnp.asarray(planes), jnp.asarray(tag), jgroup,
                          enabled, **kw)
    return (np.asarray(p), np.asarray(t), np.asarray(m))


#: (n_lanes, max compare terms, max write terms): one CTA, several, a
#: ragged last CTA, two compare groups in registers and more out of line,
#: write groups of 1, 2 and 4 terms and more out of line
CASES = [(32, 2, 1), (31, 4, 2), (33, 8, 4), (1025, 6, 2), (200, 10, 6),
         (96, 3, 3)]


@pytest.mark.parametrize("n_lanes,max_c,max_w", CASES)
def test_emulated_kernel_equals_plain_and_reference(n_lanes, max_c, max_w):
    rng = np.random.default_rng(n_lanes * 31 + max_c * 7 + max_w)
    n_bits = 12
    group = _random_group(rng, n_bits, 40, max_c, max_w)
    planes, tag = _state(rng, n_bits, n_lanes)
    enabled = rng.integers(0, 4, group.n_ops) > 0
    tp = interop.planes_from_reference(planes, "cpu")
    tt = interop.planes_from_reference(tag[None], "cpu")[0]
    want = ref.group_scan_plain(tp, tt, group.tables(), enabled)[:3]
    cols = np.concatenate([group.cmp_cols.ravel(), group.w_cols.ravel()])
    plan = ops.plan_unconditional(n_lanes, int(cols.max() - cols.min()) + 1,
                                  group.n_ops, group.cmp_cols.shape[1],
                                  group.w_cols.shape[1])
    got = _emulate(tp, tt, group, enabled, plan)
    for a, b, what in zip(got, want, ("planes", "tag", "matched")):
        assert torch.equal(a, b), what
    # the wrapper runs the plain version for CPU planes
    for a, b in zip(ops.run_group(tp, tt, group, enabled), want):
        assert torch.equal(a, b)
    # and the reference: its jnp executor
    jp, jt, jm = _reference(planes, tag, group, enabled)
    np.testing.assert_array_equal(interop.planes_to_reference(got[0]), jp)
    np.testing.assert_array_equal(
        interop.planes_to_reference(got[1][None])[0], jt)
    np.testing.assert_array_equal(got[2].numpy(), jm)


@pytest.mark.parametrize("plan_of", ["planned", "device_memory", "two_lanes",
                                     "four_lanes"])
def test_emulated_paths_and_lane_splits_agree(plan_of):
    """The same group through each path and lanes-a-thread split the kernel
    has: the answer never depends on the plan."""
    rng = np.random.default_rng(5)
    n_bits, n_lanes = 10, 300
    group = _random_group(rng, n_bits, 24, 6, 3)
    planes, tag = _state(rng, n_bits, n_lanes)
    enabled = rng.integers(0, 3, group.n_ops) > 0
    tp = interop.planes_from_reference(planes, "cpu")
    tt = interop.planes_from_reference(tag[None], "cpu")[0]
    plan = ops.plan_unconditional(n_lanes, n_bits, group.n_ops,
                                  group.cmp_cols.shape[1],
                                  group.w_cols.shape[1])
    if plan_of == "device_memory":
        plan = dataclasses.replace(plan, path="global", lpt=0, threads=64,
                                   slice=64, ctas=-(-n_lanes // 64))
    elif plan_of in ("two_lanes", "four_lanes"):
        lpt = 2 if plan_of == "two_lanes" else 4
        plan = dataclasses.replace(plan, lpt=lpt, threads=32,
                                   slice=32 * lpt,
                                   ctas=-(-n_lanes // (32 * lpt)))
    got = _emulate(tp, tt, group, enabled, plan)
    want = ref.group_scan_plain(tp, tt, group.tables(), enabled)[:3]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_emulated_kernel_equals_reference_pallas_kernel():
    """The reference's Pallas kernel, in interpret mode, on a small
    unconditional group with disabled ops."""
    rng = np.random.default_rng(17)
    n_bits, n_lanes = 8, 64
    group = _random_group(rng, n_bits, 12, 5, 3)
    planes, tag = _state(rng, n_bits, n_lanes)
    enabled = rng.integers(0, 3, group.n_ops) > 0
    tp = interop.planes_from_reference(planes, "cpu")
    tt = interop.planes_from_reference(tag[None], "cpu")[0]
    plan = ops.plan_unconditional(n_lanes, n_bits, group.n_ops,
                                  group.cmp_cols.shape[1],
                                  group.w_cols.shape[1])
    got = _emulate(tp, tt, group, enabled, plan)
    jp, jt, jm = _reference(planes, tag, group, enabled, backend="pallas",
                            block_lanes=32, interpret=True)
    np.testing.assert_array_equal(interop.planes_to_reference(got[0]), jp)
    np.testing.assert_array_equal(
        interop.planes_to_reference(got[1][None])[0], jt)
    np.testing.assert_array_equal(got[2].numpy(), jm)


def test_records_carry_the_masks_the_body_selects_by():
    """The head of a record: the opcode's masks (ignore the compare,
    ignore the tag, write), so the body never branches on the opcode."""
    group = ref.OpGroup.build([
        (ref.OP_PASS, 0, [0], [1], [1], [1]),
        (ref.OP_CMP, 0, [0], [1], [], []),
        (ref.OP_CMP_TAG, 0, [0], [1], [], []),
        (ref.OP_WRITE, 0, [], [], [1], [0])])
    head = ops.records(group, 0)[:, 0]
    ones = 0xFFFFFFFF
    assert head[:, 0].tolist() == [0, 1, 2, 3]        # no condition
    assert head[:, 1].tolist() == [0, 0, 0, ones]      # ignores the compare
    assert head[:, 2].tolist() == [ones, ones, 0, 0]   # ignores the tag
    assert head[:, 3].tolist() == [ones, 0, 0, ones]   # writes
