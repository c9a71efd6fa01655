"""PyTorch port vs the JAX reference: the AP megakernel's op-group model.

The port's plain executor ``group_scan_plain`` (what the CPU runs, and
what the CUDA kernel is held to on the card) must give the reference's
``group_scan`` results bit for bit — planes, tag, matched counts and the
executed mask — on random groups: conditional and unconditional,
lookbacks 1-4, disabled ops, repeated write columns, 1, 2 and 7 lanes.
The engine's megakernel ``run`` must match the reference's
``backend="megakernel"`` engine, counters and trace included.

Strategies draw only scalars (the vendored hypothesis shim supports no
``composite``); arrays come from a ``np.random.default_rng`` seeded by a
drawn integer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import engine as jengine
from repro.kernels.ap_megakernel import ref as jref
from repro.kernels.ap_megakernel.kernel import run_group_kernel
from repro_torch import interop
from repro_torch.core import engine as tengine
from repro_torch.kernels.ap_megakernel import ops as tops
from repro_torch.kernels.ap_megakernel import ref as tref

_group_scan = jax.jit(jref.group_scan)


def _ops(rng, n_bits, P, conditional):
    """Random op tuples of every kind; write (and compare) columns are
    drawn with replacement, so a column can be listed twice."""
    out = []
    for p in range(P):
        opc = int(rng.integers(0, 4))
        cond = (int(rng.integers(0, min(p, tref.MAX_COND) + 1))
                if conditional else 0)
        nc, nw = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        out.append((opc, cond, rng.integers(0, n_bits, nc).tolist(),
                    rng.integers(0, 2, nc).tolist(),
                    rng.integers(0, n_bits, nw).tolist(),
                    rng.integers(0, 2, nw).tolist()))
    return out


def _state(rng, n_bits, n_lanes):
    planes = rng.integers(0, 2 ** 32, (n_bits, n_lanes),
                          dtype=np.uint64).astype(np.uint32)
    tag = rng.integers(0, 2 ** 32, n_lanes, dtype=np.uint64).astype(np.uint32)
    return planes, tag


def _run_both(group_j, planes, tag, enabled):
    ref = _group_scan(jnp.asarray(planes), jnp.asarray(tag),
                      tuple(jnp.asarray(t) for t in group_j.tables()),
                      jnp.asarray(enabled))
    group_t = interop.op_group_from_reference(group_j.tables())
    got = tref.group_scan_plain(
        interop.planes_from_reference(planes, "cpu"),
        interop.planes_from_reference(tag[None], "cpu")[0],
        group_t.tables(), enabled)
    return [np.asarray(a) for a in ref], got, group_t


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n_lanes=st.sampled_from((1, 2, 7)),
       P=st.integers(1, 12), conditional=st.booleans(),
       mask=st.booleans())
def test_group_scan_plain_matches_reference(seed, n_lanes, P, conditional,
                                            mask):
    rng = np.random.default_rng(seed)
    n_bits = 6
    group = jref.OpGroup.build(_ops(rng, n_bits, P, conditional))
    planes, tag = _state(rng, n_bits, n_lanes)
    enabled = rng.integers(0, 2, P).astype(bool) if mask \
        else np.ones(P, bool)
    (p_ref, t_ref, m_ref, ex_ref), (p, t, m, ex), group_t = _run_both(
        group, planes, tag, enabled)
    np.testing.assert_array_equal(interop.planes_to_reference(p), p_ref)
    np.testing.assert_array_equal(
        interop.planes_to_reference(t[None])[0], t_ref)
    assert m.dtype == torch.int32
    np.testing.assert_array_equal(m.numpy(), m_ref)
    np.testing.assert_array_equal(ex.numpy(), ex_ref)
    # the executed mask follows from the counts alone
    dg = tops.device_group(group_t, "cpu")
    np.testing.assert_array_equal(
        tref.executed_ops(dg.cond, torch.from_numpy(enabled), m).numpy(),
        ex_ref)
    # the counter delta a group contributes
    np.testing.assert_array_equal(
        tref.counter_delta(dg.op, m, ex).numpy(),
        np.asarray(jref.counter_delta(jnp.asarray(group.op),
                                      jnp.asarray(m_ref),
                                      jnp.asarray(ex_ref))))
    # the dispatcher takes the plain version for CPU planes
    out = tops.run_group(interop.planes_from_reference(planes, "cpu"),
                         interop.planes_from_reference(tag[None], "cpu")[0],
                         dg, enabled)
    assert torch.equal(out[0], p) and torch.equal(out[2], m)


@pytest.mark.parametrize("lookback", [1, 2, 3, 4])
def test_each_lookback_branches_on_its_own_op(lookback):
    """A condition ``k`` reads the count of the op exactly k back: the op
    k back matches nothing, every op between matches, so only the
    right lookback skips."""
    planes = np.zeros((3, 1), np.uint32)
    planes[1] = 0xFFFFFFFF
    ops = [(tref.OP_CMP, 0, [0], [1], [], [])]               # matches none
    ops += [(tref.OP_CMP, 0, [1], [1], [], [])] * (lookback - 1)
    ops += [(tref.OP_PASS, lookback, [1], [1], [2], [1])]
    group = jref.OpGroup.build(ops)
    (p_ref, _, m_ref, ex_ref), (p, _, m, ex), _ = _run_both(
        group, planes, np.zeros(1, np.uint32), np.ones(len(ops), bool))
    assert not ex_ref[-1] and not bool(ex[-1])
    np.testing.assert_array_equal(m.numpy(), m_ref)
    np.testing.assert_array_equal(interop.planes_to_reference(p), p_ref)


def test_pallas_kernel_agrees_on_tiny_groups():
    """The reference's Pallas kernel (interpret mode) on two tiny groups,
    one conditional, against the port's plain executor."""
    rng = np.random.default_rng(11)
    for conditional in (False, True):
        group = jref.OpGroup.build(_ops(rng, 5, 6, conditional))
        planes, tag = _state(rng, 5, 2)
        enabled = np.array([1, 1, 0, 1, 1, 1], bool)
        p_pal, t_pal, m_pal = run_group_kernel(
            jnp.asarray(planes), jnp.asarray(tag),
            *(jnp.asarray(t) for t in group.tables()[:2]),
            jnp.asarray(enabled),
            *(jnp.asarray(t) for t in group.tables()[2:]),
            block_lanes=2, interpret=True,
            conditional=group.conditional)
        _, (p, t, m, _), _ = _run_both(group, planes, tag, enabled)
        np.testing.assert_array_equal(interop.planes_to_reference(p),
                                      np.asarray(p_pal))
        np.testing.assert_array_equal(
            interop.planes_to_reference(t[None])[0], np.asarray(t_pal))
        np.testing.assert_array_equal(m.numpy(), np.asarray(m_pal))


@pytest.mark.parametrize("ops, match", [
    ([], "empty op group"),
    ([(7, 0, [0], [1], [], [])], "unknown opcode"),
    ([(tref.OP_CMP, 5, [0], [1], [], [])], "outside"),
    ([(tref.OP_CMP, 0, [0], [1], [], []),
      (tref.OP_CMP, 2, [0], [1], [], [])], "before op 0"),
])
def test_build_errors_match_reference(ops, match):
    with pytest.raises(ValueError, match=match) as ref:
        jref.OpGroup.build(ops)
    with pytest.raises(ValueError, match=match) as got:
        tref.OpGroup.build(ops)
    assert str(got.value) == str(ref.value)


def test_group_constructors_match_reference():
    rng = np.random.default_rng(2)
    ops = _ops(rng, 9, 8, True) + [(tref.OP_WRITE, 1, [], [], [3], [1]),
                                   (tref.OP_CMP, 0, [2], [0], [], [])]
    cc = rng.integers(0, 9, (4, 3)).astype(np.int32)
    ck = rng.integers(0, 2, (4, 3)).astype(np.uint32)
    pairs = [(jref.OpGroup.build(ops), tref.OpGroup.build(ops)),
             (jref.OpGroup.from_schedule(cc, ck, cc[:, :1], ck[:, :1]),
              tref.OpGroup.from_schedule(cc, ck, cc[:, :1], ck[:, :1])),
             (jref.OpGroup.probes(cc, ck), tref.OpGroup.probes(cc, ck))]
    for j, t in pairs:
        assert (t.n_ops, t.conditional) == (j.n_ops, j.conditional)
        for a, b in zip(j.tables(), t.tables()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for make in (lambda m: m.OpGroup.from_schedule(cc[:0], ck[:0], cc[:0],
                                                   ck[:0]),
                 lambda m: m.OpGroup.probes(np.zeros((0, 1)),
                                            np.zeros((0, 1)))):
        with pytest.raises(ValueError, match="empty"):
            make(jref)
        with pytest.raises(ValueError, match="empty"):
            make(tref)


@pytest.mark.parametrize("n_words", [32, 96])
def test_engine_megakernel_run_matches_reference(n_words):
    """APEngine.run through the megakernel on random schedules: planes,
    tag, counters and the trace equal the reference's megakernel
    engine's."""
    rng = np.random.default_rng(n_words)
    vals = rng.integers(0, 1 << 10, n_words, dtype=np.uint64)
    scheds = []
    for _ in range(3):
        passes = []
        for _ in range(int(rng.integers(1, 6))):
            nc, nw = int(rng.integers(1, 4)), int(rng.integers(1, 3))
            passes.append((rng.choice(10, nc, replace=False).tolist(),
                           rng.integers(0, 2, nc).tolist(),
                           rng.choice(10, nw, replace=False).tolist(),
                           rng.integers(0, 2, nw).tolist()))
        scheds.append(passes)
    je = jengine.APEngine(n_words, 10, backend="megakernel")
    te = tengine.APEngine(n_words, 10, backend="megakernel", device="cpu")
    for eng, pkg in ((je, jengine), (te, tengine)):
        f = eng.alloc.alloc(10)
        eng.load(f, vals)
        eng.compare([0, 1], [1, 0])          # a live TAG the run keeps
        for passes in scheds:
            eng.run(pkg.PassSchedule.build(passes))
    np.testing.assert_array_equal(interop.planes_to_reference(te.planes),
                                  np.asarray(je.planes))
    np.testing.assert_array_equal(
        interop.planes_to_reference(te.tag[None])[0], np.asarray(je.tag))
    assert te.counters() == je.counters()
    for a, b in zip(te.trace_events(), je.trace_events()):
        np.testing.assert_array_equal(a, b)


def test_engine_backend_choices():
    assert tengine.APEngine.BACKENDS == jengine.APEngine.BACKENDS
    with pytest.raises(ValueError, match="backend"):
        tengine.APEngine(32, 4, backend="ap_match", device="cpu")
    # lane sharding is ported: 32 words are one lane, which two shards
    # cannot split (the reference's message)
    with pytest.raises(ValueError, match="divisible"):
        tengine.APEngine(32, 4, backend="megakernel", n_shards=2,
                         device="cpu")
