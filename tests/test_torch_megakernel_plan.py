"""The megakernel's host-side plans, and a plain-PyTorch emulation of how
the cluster kernel splits and counts a conditional group.

``ops.plan_conditional`` picks, by shape alone, the cluster size, the
threads, the lanes a CTA and a thread own, the path (the tile in shared
or in device memory) and the op-record chunk of ``op_group`` in
``csrc/ap_megakernel.cu`` for a conditional group;
``ops.plan_unconditional`` the same for an unconditional group, whose
CTAs are independent and spread over the card.  Each plan is checked
here for covering every lane exactly once, staying within the
shared-memory budget and taking the stated path at each shape.

``_emulate_cluster`` repeats the kernel's algorithm in plain PyTorch:
the lanes split into C slices (zero-padded to the slice width, their
counts dropped), each op's popcount summed over the slices' partial
counts, a branch taken on the sum of an op that a later op branches on
(the only counts the kernel exchanges), and the compare and write terms
in the records' groups (``ops.group_sizes``), padded with the op's last
term, every row of a group loaded before any is stored.  It must equal ``ref.group_scan_plain`` bit
for bit for C in {1, 2, 4, 8, 16}.
"""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import isa
from repro_torch.core.bitplane import Field
from repro_torch.kernels.ap_megakernel import ops, ref
from repro_torch.workloads import _device

#: shared memory a CTA may opt into on the H100, less the kernel's static
#: arrays
SMEM_LIMIT = 232448 - 512


def _lane_owners(n_lanes: int, plan) -> np.ndarray:
    """How many (CTA, thread, k) slots own each lane under ``plan``."""
    seen = np.zeros(n_lanes, np.int64)
    for r in range(plan.ctas):
        lanes = np.arange(r * plan.slice, (r + 1) * plan.slice)
        if plan.path == "shared":
            # thread t owns slice lanes t * lpt + k, k < lpt
            j = (plan.lpt * np.arange(plan.threads)[:, None]
                 + np.arange(plan.lpt)[None, :]).ravel()
            assert sorted(j.tolist()) == list(range(plan.slice))
            lanes = lanes[j]
        else:
            # thread t owns slice lanes t, t + threads, ...
            assert plan.lpt == 0
        lanes = lanes[lanes < n_lanes]
        np.add.at(seen, lanes, 1)
    return seen


@pytest.mark.parametrize("rows", [1, 10, 33, 200, 2000])
@pytest.mark.parametrize("n_lanes", [1, 31, 32, 33, 1024, 1025, 2047, 4096,
                                     32768, 32769, 65536, 65537, 2 ** 20])
def test_plan_covers_every_lane_once_within_budget(n_lanes, rows):
    plan = ops.plan_conditional(n_lanes, rows, 28, 2, 1)
    assert 1 <= plan.cluster <= ops.MAX_CLUSTER and plan.ctas == plan.cluster
    assert plan.cluster & (plan.cluster - 1) == 0
    assert 32 <= plan.threads <= ops.MAX_THREADS and plan.threads % 32 == 0
    assert plan.cluster * plan.slice >= n_lanes
    np.testing.assert_array_equal(_lane_owners(n_lanes, plan), 1)
    assert plan.tile_bytes + plan.table_bytes <= SMEM_LIMIT
    assert plan.table_bytes <= ops.TABLE_BYTES
    if plan.path == "shared":
        assert plan.lpt in ops.LANES_PER_THREAD
        assert plan.slice == plan.threads * plan.lpt
        assert plan.tile_bytes == 4 * rows * plan.slice
        assert plan.tile_bytes <= ops.TILE_BYTES
    else:
        assert plan.path == "global" and plan.lpt == 0
        assert plan.tile_bytes == 0
        # taken only where the shared tile would not fit a CTA
        fits = 4 * rows * -(-plan.slice // 32) * 32 <= ops.TILE_BYTES
        assert not fits or plan.slice > 4 * ops.MAX_THREADS


#: (n_lanes, rows) -> (path, cluster, threads, lanes a thread)
STATED = {
    (32, 10): ("shared", 1, 32, 1),          # a 1024-element trace round
    (33, 10): ("shared", 1, 64, 1),
    (1024, 10): ("shared", 1, 512, 2),
    (1025, 10): ("shared", 2, 288, 2),
    (2047, 10): ("shared", 2, 512, 2),
    (32768, 10): ("shared", 16, 512, 4),     # the 2^20 sort's rounds
    (32769, 10): ("shared", 16, 544, 4),
    (65536, 10): ("shared", 16, 1024, 4),
    (65537, 10): ("global", 16, 1024, 0),    # above 4 lanes a thread
    (32768, 200): ("global", 16, 1024, 0),   # tile past the budget
    (33, 2000): ("global", 1, 64, 0),
    (2 ** 20, 10): ("global", 16, 1024, 0),
}


@pytest.mark.parametrize("shape", sorted(STATED))
def test_plan_takes_the_stated_path(shape):
    plan = ops.plan_conditional(*shape, 28, 2, 1)
    assert (plan.path, plan.cluster, plan.threads, plan.lpt) == STATED[shape]


def test_plan_chunks_the_records_and_refuses_what_cannot_fit():
    # a record, the enabled word, the CTA's count and one count a warp
    # and one more record and enabled word, read ahead of the last op
    one = ops.plan_conditional(32, 10, 28, 2, 1)
    assert one.chunk == 28                   # a sort round: one chunk
    guard = ops.record_bytes(2, 1) + 4
    assert one.table_bytes == 28 * (ops.record_bytes(2, 1) + 4 * 3) + guard
    many = ops.plan_conditional(32768, 10, 5000, 9, 9)
    per_op = ops.record_bytes(9, 9) + 4 * (2 + 512 // 32)
    guard = ops.record_bytes(9, 9) + 4
    assert many.chunk == (ops.TABLE_BYTES - guard) // per_op < 5000
    assert ops.group_sizes(2, 1) == (2, 1) and ops.group_sizes(3, 2) == (4, 2)
    assert ops.group_sizes(1, 3) == (2, 4)
    assert ops.record_bytes(1, 1) == ops.record_bytes(2, 1) == 80
    assert ops.record_bytes(4, 4) == 80 and ops.record_bytes(5, 1) == 112
    assert ops.record_bytes(3, 5) == 16 * (1 + 2 * (1 + 2))
    with pytest.raises(NotImplementedError, match="table budget"):
        ops.plan_conditional(32, 10, 4, 8000, 8000)
    with pytest.raises(ValueError):
        ops.plan_conditional(0, 10, 4, 1, 1)


#: 2^20 AP words, 32 a lane: the lanes of the paper's full array
PAPER_LANES = 2 ** 20 // 32


@pytest.mark.parametrize("rows", [1, 10, 26, 200, 1536, 1537, 2000])
@pytest.mark.parametrize("n_lanes", [1, 31, 32, 33, 100, 1024, 1025, 16384,
                                     PAPER_LANES, PAPER_LANES + 1, 65536,
                                     2 ** 20])
def test_unconditional_plan_covers_every_lane_once_within_budget(n_lanes,
                                                                 rows):
    plan = ops.plan_unconditional(n_lanes, rows, 256, 4, 2)
    assert plan.cluster == 1 and plan.ctas == -(-n_lanes // plan.slice)
    assert 32 <= plan.threads <= ops.MAX_THREADS_UNCONDITIONAL
    assert plan.threads % 32 == 0
    np.testing.assert_array_equal(_lane_owners(n_lanes, plan), 1)
    assert plan.tile_bytes + plan.table_bytes <= SMEM_LIMIT
    assert plan.table_bytes <= ops.UNCONDITIONAL_TABLE_BYTES
    if plan.path == "shared":
        assert plan.lpt in ops.LANES_PER_THREAD
        assert plan.slice == plan.threads * plan.lpt
        assert plan.tile_bytes == 4 * rows * plan.slice <= ops.TILE_BYTES
    else:
        # only where no CTA can hold even one warp's tile; a lane a thread
        assert 4 * rows * 32 > ops.TILE_BYTES
        assert plan.lpt == 0 and plan.tile_bytes == 0
        assert plan.slice <= plan.threads
    # spread over the card: more than half as many CTAs as SMs where the
    # lanes allow (slices are whole warps), each at least a warp
    assert 2 * plan.ctas > min(ops.N_SMS, -(-n_lanes // 32))


#: (n_lanes, rows) -> (path, CTAs, threads, lanes a thread)
UNCONDITIONAL_STATED = {
    (32, 30): ("shared", 1, 32, 1),           # spmv's probe batch
    (31, 30): ("shared", 1, 32, 1),           # lanes not a multiple of 32
    (33, 30): ("shared", 2, 32, 1),
    (1024, 26): ("shared", 32, 32, 1),        # a 1024-element trace
    (16384, 26): ("shared", 128, 128, 1),
    (PAPER_LANES, 26): ("shared", 128, 128, 2),   # the multiply group
    (PAPER_LANES + 1, 26): ("shared", 129, 128, 2),
    (65536, 26): ("shared", 128, 256, 2),
    (2 ** 20, 26): ("shared", 1024, 256, 4),
    (PAPER_LANES, 400): ("shared", 342, 96, 1),   # the tile shrinks
    (PAPER_LANES, 1536): ("shared", 1024, 32, 1),  # one warp's tile fits
    (PAPER_LANES, 1537): ("global", 128, 256, 0),  # not even one warp's
    (1024, 2048): ("global", 32, 256, 0),
}


@pytest.mark.parametrize("shape", sorted(UNCONDITIONAL_STATED))
def test_unconditional_plan_takes_the_stated_path(shape):
    plan = ops.plan_unconditional(*shape, 256, 4, 2)
    assert (plan.path, plan.ctas, plan.threads, plan.lpt) == \
        UNCONDITIONAL_STATED[shape]


def test_unconditional_plan_chunks_what_its_tile_leaves():
    """Records, enabled words, a list slot and one count byte a thread go
    in chunks of what the tile leaves of the shared memory (at most
    UNCONDITIONAL_TABLE_BYTES), with one more record and enabled word and
    two list slots read ahead of a chunk's last op."""
    spmv = ops.plan_unconditional(32, 29, 512, 8, 1)
    assert spmv.chunk == 512                  # the probe batch: one chunk
    per_op = ops.record_bytes(8, 1) + 12 + 32
    guard = ops.record_bytes(8, 1) + 12
    assert spmv.table_bytes == 512 * per_op + guard
    many = ops.plan_unconditional(PAPER_LANES, 10, 5000, 9, 9)
    per_op = ops.record_bytes(9, 9) + 12 + many.threads
    guard = ops.record_bytes(9, 9) + 12
    assert many.chunk == (ops.UNCONDITIONAL_TABLE_BYTES - guard) // per_op
    assert many.chunk < 5000
    # a tile that leaves less than the budget leaves the table the rest
    big = ops.plan_unconditional(PAPER_LANES, 1536, 5000, 2, 1)
    budget = max(ops.TABLE_BYTES,
                 ops.TILE_BYTES + ops.TABLE_BYTES - big.tile_bytes)
    assert big.table_bytes <= budget
    assert big.chunk == (budget - ops.record_bytes(2, 1) - 12) // (
        ops.record_bytes(2, 1) + 12 + big.threads)
    with pytest.raises(NotImplementedError, match="table budget"):
        ops.plan_unconditional(32, 10, 4, 8000, 8000)
    with pytest.raises(ValueError):
        ops.plan_unconditional(32, 0, 4, 1, 1)


def test_launch_params_refuse_offsets_past_32_bits():
    group = ref.OpGroup.probes([[0]], [[1]])
    dg = ops.device_group(group, "cpu")
    ops._launch_params(dg, 32, 2 ** 25 - 1)
    with pytest.raises(NotImplementedError, match="32-bit byte offsets"):
        ops._launch_params(dg, 32, 2 ** 25)


# ---------------------------------------------------------------------------
# the kernel's algorithm in plain PyTorch
# ---------------------------------------------------------------------------

def _lane_popcounts(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (int64)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _branched(cond: np.ndarray) -> list[bool]:
    """Ops some later op branches on: q in p+1..p+4 with cond[q] == q - p
    (written out here; ``ops.branched_on`` must agree)."""
    P = len(cond)
    out = [any(p + d < P and cond[p + d] == d for d in range(1, 5))
           for p in range(P)]
    assert ops.branched_on(cond).tolist() == out
    return out


def _emulate_cluster(planes, tag, group, enabled, cluster: int,
                     slice_: int):
    """``op_group`` on a conditional group over ``cluster`` CTAs of
    ``slice_`` lanes each, in plain PyTorch, reading the op records the
    kernel reads (``ops.records``) -> (planes', tag', matched int32[P])."""
    P, kc = group.cmp_cols.shape
    kw = group.w_cols.shape[1]
    cols = np.concatenate([group.cmp_cols.ravel(), group.w_cols.ravel()])
    lo = int(cols.min())
    rec = ops.records(group, lo)
    keys = rec.view(np.int32)              # broadcast keys as lane masks
    gc, gw = ops.group_sizes(kc, kw)
    n_cg = -(-kc // gc)
    en = np.ones(P, bool) if enabled is None else np.asarray(enabled, bool)
    n_bits, n = planes.shape
    tiles, tags, live = [], [], []
    for r in range(cluster):
        a, b = min(r * slice_, n), min((r + 1) * slice_, n)
        t = torch.zeros((n_bits, slice_), dtype=torch.int32)
        g = torch.zeros(slice_, dtype=torch.int32)
        t[:, :b - a], g[:b - a] = planes[:, a:b], tag[a:b]
        tiles.append(t)
        tags.append(g)
        live.append(b - a)

    def terms(p, first, n_groups, size):
        for v in range(first, first + 2 * n_groups, 2):
            yield ([lo + int(x) for x in rec[p, v, :size]],
                   [int(x) for x in keys[p, v + 1, :size]])

    h = [0, 0, 0, 0]          # counts of ops p-1 .. p-4 branched on
    matched = np.zeros(P, np.int64)
    for p in range(P):
        f = int(rec[p, 0, 0])
        opc, c, branched = f & 3, (f >> 2) & 7, (f >> 6) & 1
        assert branched == _branched(group.cond)[p]
        total = 0
        if en[p] and (c == 0 or h[c - 1] > 0):
            parts = []
            for r in range(cluster):
                tile, w = tiles[r], tags[r]
                if opc != ref.OP_WRITE:
                    t = torch.full_like(w, -1)
                    for rows_, keys_ in terms(p, 1, n_cg, gc):
                        old = [tile[row].clone() for row in rows_]
                        for row, key in zip(old, keys_):
                            t = t & ~(row ^ key)
                    w = t & w if opc == ref.OP_CMP_TAG else t
                parts.append(int(_lane_popcounts(w)[:live[r]].sum()))
                if opc in (ref.OP_PASS, ref.OP_WRITE):
                    for rows_, keys_ in terms(p, 1 + 2 * n_cg,
                                              -(-kw // gw), gw):
                        old = [tile[row].clone() for row in rows_]
                        for row, o, key in zip(rows_, old, keys_):
                            tile[row] = (o & ~w) | (key & w)
                else:
                    tags[r] = w
            matched[p] = sum(parts)
            total = int(matched[p]) if branched else 0
        h = [total] + h[:3]
    out = torch.cat(tiles, dim=1)[:, :n]
    out_tag = torch.cat(tags)[:n]
    return out, out_tag, torch.from_numpy(matched.astype(np.int32))


def _random_group(rng, n_bits: int, P: int):
    """Random conditional ops of every kind, with lookbacks 1-4; up to
    six compare and write terms, so some ops span two groups of four and
    some list a column twice."""
    ops_ = []
    for p in range(P):
        opc = int(rng.integers(0, 4))
        cond = int(rng.integers(0, min(p, ref.MAX_COND) + 1))
        nc, nw = int(rng.integers(1, 7)), int(rng.integers(1, 7))
        ops_.append((opc, cond, rng.integers(0, n_bits, nc).tolist(),
                     rng.integers(0, 2, nc).tolist(),
                     rng.integers(0, n_bits, nw).tolist(),
                     rng.integers(0, 2, nw).tolist()))
    # a column written twice in one op, with different keys
    ops_[-1] = (ref.OP_WRITE, 0, [], [], [3, 5, 3], [1, 0, 0])
    return ref.OpGroup.build(ops_)


def _sort_round():
    val, active, cand = Field(0, 8), Field(8, 1), Field(9, 1)
    return _device._min_extract_group(isa.copy(cand, active), val, active,
                                      cand, readout=False)


def _state(rng, n_bits: int, n_lanes: int):
    planes = interop.planes_from_reference(
        rng.integers(0, 2 ** 32, (n_bits, n_lanes),
                     dtype=np.uint64).astype(np.uint32), "cpu")
    tag = interop.planes_from_reference(
        rng.integers(0, 2 ** 32, (1, n_lanes),
                     dtype=np.uint64).astype(np.uint32), "cpu")[0]
    return planes, tag


def _assert_same(got, want):
    for a, b, what in zip(got, want, ("planes", "tag", "matched")):
        assert torch.equal(a, b), what


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n_lanes", [1, 31, 32, 33, 2047, 32768, 32769])
def test_sliced_count_equals_plain(n_lanes, cluster):
    """Random conditional groups (lookbacks 1-4, disabled ops, a column
    written twice) and a sort round: the emulation with C slices, and with
    the plan's own split, equals the plain version."""
    rng = np.random.default_rng(n_lanes * 17 + cluster)
    n_bits = 10
    group = _random_group(rng, n_bits, 24)
    planes, tag = _state(rng, n_bits, n_lanes)
    enabled = rng.integers(0, 4, group.n_ops) > 0
    want = ref.group_scan_plain(planes, tag, group.tables(), enabled)[:3]
    slice_ = -(-(-(-n_lanes // cluster)) // 32) * 32
    _assert_same(_emulate_cluster(planes, tag, group, enabled, cluster,
                                  slice_), want)
    plan = ops.plan_conditional(n_lanes, n_bits, group.n_ops,
                                *group.cmp_cols.shape[1:],
                                group.w_cols.shape[1])
    _assert_same(_emulate_cluster(planes, tag, group, enabled,
                                  plan.cluster, plan.slice), want)
    # a sort round, and one with no active word, in which nothing matches
    sort = _sort_round()
    for active in (planes[8], torch.zeros_like(planes[8])):
        planes[8] = active
        want = ref.group_scan_plain(planes, tag, sort.tables())[:3]
        _assert_same(_emulate_cluster(planes, tag, sort, None, cluster,
                                      slice_), want)


@pytest.mark.parametrize("lookback", [1, 2, 3, 4])
def test_sliced_count_branches_on_the_sum_of_every_slice(lookback):
    """An op whose lookback reaches a probe that only the last slice
    matches: a CTA that branched on its own count would skip it."""
    n_lanes, cluster = 4096, 16
    planes = torch.zeros((4, n_lanes), dtype=torch.int32)
    planes[0, -1] = 1                     # one AP word in the last slice
    tag = torch.zeros(n_lanes, dtype=torch.int32)
    # passes that match nothing between the probe and the write
    pad = [(ref.OP_PASS, 0, [2], [1], [3], [1])] * (lookback - 1)
    group = ref.OpGroup.build(
        [(ref.OP_CMP, 0, [0], [1], [], [])] + pad
        + [(ref.OP_WRITE, lookback, [], [], [1], [1])])
    want = ref.group_scan_plain(planes, tag, group.tables())[:3]
    assert int(want[2][0]) == 1 and int(want[2][-1]) == 1
    for c in (1, cluster):
        _assert_same(_emulate_cluster(planes, tag, group, None, c,
                                      n_lanes // c), want)


def test_branched_ops_of_a_sort_round():
    """The ops of a sort round that the kernel exchanges counts for: the
    eight narrowing probes and the tie group, 9 of 28."""
    sort = _sort_round()
    br = _branched(sort.cond)
    assert sum(br) == 9
    assert [p for p, b in enumerate(br) if b] == \
        [2 + 3 * i for i in range(8)] + [26]
