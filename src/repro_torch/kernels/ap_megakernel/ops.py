"""The AP megakernel: CUDA kernel and dispatch.

:func:`run_group` executes an :class:`~.ref.OpGroup` against (planes,
tag).  For planes on the CPU it runs :func:`.ref.group_scan_plain`; for
planes on a CUDA device it launches the hand-written kernel
``csrc/ap_megakernel.cu`` (which replaces the TPU kernel
``run_group_kernel`` of the reference package) or raises — it never
falls back.  A group the kernel cannot take (an op past its table
budget, planes past its 32-bit offsets), which the reference runs,
raises ``NotImplementedError``; a bad argument raises ``ValueError``.
``run_group.launches`` counts kernel launches; every call also counts
``kernels/launch/ap_megakernel`` and ``kernels/launch/ap_megakernel/
<backend>`` in ``repro_torch.obs``, as the reference's dispatch does.

A device program that runs the same group many times uploads its tables
once with :func:`device_group` and passes the result instead of the
``OpGroup``: its tables and columns were checked on the host, so a launch
then checks only the planes and reads nothing back from the card.

One kernel runs both kinds of group from the op records
:func:`device_group` decodes on the host.  A conditional group runs in one
thread block cluster, whose size and path (the tile in shared or in
device memory) :func:`plan_conditional` picks by shape; an unconditional
group in independent CTAs across the card, as :func:`plan_unconditional`
picks.  ``run_group.unconditional_launches`` counts the launches of
unconditional groups (also counted in ``run_group.launches``).
:func:`cluster_probe` measures on the card the latencies that bound both.

With ``mesh`` (a tuple of devices, ``repro_torch.parallel.sharding.
ap_mesh``) a group runs lane-sharded: the planes and tag split into
equal shards of lanes, one a device, and every op's count is summed over
the shards before any op that branches on it reads it (the reference's
``shard_map`` of its jnp scan with a ``psum`` an op).  The kernel takes
no count from another device, so :func:`sharded_group` splits the group
after each op a later op branches on; each segment runs on every shard
as an unconditional group whose ``enabled`` mask is formed on the first
shard's device from the counts summed so far, and its counts are summed
there.  Nothing crosses to the host, and no plain version runs on a card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.ap_megakernel import ref
from repro_torch.kernels.ap_megakernel.ref import OpGroup


@dataclasses.dataclass(frozen=True)
class DeviceGroup:
    """An op group's tables as int32 tensors on one device (uint32 keys
    keep their bits), with what the launch needs to know about them.
    The tables are views of one tensor, ``packed``, which the kernels
    take whole."""
    op: torch.Tensor
    cond: torch.Tensor
    cmp_cols: torch.Tensor
    cmp_key: torch.Tensor
    w_cols: torch.Tensor
    w_key: torch.Tensor
    enabled: torch.Tensor     # int32[P] of ones: the default mask
    conditional: bool
    col_range: tuple[int, int]
    packed: torch.Tensor      # op, cond, enabled, cc, ck, wc, wk
    dims: tuple[int, int, int]    # P, Kc, Kw
    #: the decoded op records (:func:`records`) the kernel reads
    records: torch.Tensor
    #: the kernel's host parameters and plan by (n_bits, n_lanes)
    launch: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def n_ops(self) -> int:
        return self.dims[0]

    def tables(self) -> tuple:
        return (self.op, self.cond, self.cmp_cols, self.cmp_key,
                self.w_cols, self.w_key)


def device_group(group: OpGroup, device) -> DeviceGroup:
    """Upload ``group``'s tables to ``device`` once, in one copy: op,
    cond, the default enabled mask of ones, then the compare and write
    columns and keys, packed into one int32 tensor."""
    P = group.n_ops
    kc, kw = group.cmp_cols.shape[1], group.w_cols.shape[1]
    parts = (group.op, group.cond, np.ones(P, np.int32), group.cmp_cols,
             group.cmp_key, group.w_cols, group.w_key)
    packed = torch.from_numpy(np.concatenate(
        [np.ascontiguousarray(a).view(np.int32).ravel() for a in parts])
    ).to(device)
    op, cond, en, cc, ck, wc, wk = packed.split(
        (P, P, P, P * kc, P * kc, P * kw, P * kw))
    cols = np.concatenate([group.cmp_cols.ravel(), group.w_cols.ravel()])
    lo = int(cols.min())
    recs = torch.from_numpy(
        records(group, lo).view(np.int32).reshape(-1)).to(device)
    return DeviceGroup(op, cond, cc.view(P, kc), ck.view(P, kc),
                       wc.view(P, kw), wk.view(P, kw), enabled=en,
                       conditional=group.conditional,
                       col_range=(lo, int(cols.max())), packed=packed,
                       dims=(P, kc, kw), records=recs)


def group_sizes(kc: int, kw: int) -> tuple[int, int]:
    """Terms in one group of a record, (GC, GW): the kernel loads the rows
    of a group together, 2 or 4 compare terms and 1, 2 or 4 write terms
    (template parameters of ``op_group``, which holds up to two compare
    groups in registers)."""
    return (2 if kc <= 2 else 4), (kw if kw <= 2 else 4)


def records(group: OpGroup, lo: int) -> np.ndarray:
    """The kernel's decoded op records, uint32 ``[P, rv, 4]``: a head
    vector (flags = opcode | cond << 2 | branched on << 6, see
    :func:`branched_on`; then three masks of the opcode, all ones where
    the op ignores the compare (WRITE), where it ignores the tag (PASS,
    CMP) and where it writes (PASS, WRITE)), then for every group of GC
    compare terms a vector of rows counted from ``lo`` and one of
    broadcast keys (0 - key), then the same for every group of GW write
    terms.  A group is padded by repeating the op's last term."""
    P, kc = group.cmp_cols.shape
    kw = group.w_cols.shape[1]
    gc, gw = group_sizes(kc, kw)
    n_cg, n_wg = -(-kc // gc), -(-kw // gw)
    rec = np.zeros((P, 1 + 2 * (n_cg + n_wg), 4), np.uint32)
    op = group.op
    rec[:, 0, 0] = (op.astype(np.uint32)
                    | group.cond.astype(np.uint32) << 2
                    | branched_on(group.cond).astype(np.uint32) << 6)
    ones = np.uint32(0xFFFFFFFF)
    rec[:, 0, 1] = np.where(op == ref.OP_WRITE, ones, 0)
    rec[:, 0, 2] = np.where((op == ref.OP_PASS) | (op == ref.OP_CMP), ones, 0)
    rec[:, 0, 3] = np.where((op == ref.OP_PASS) | (op == ref.OP_WRITE), ones,
                            0)

    def put(cols, keys, g: int, n: int, at: int):
        idx = np.minimum(np.arange(n * g), cols.shape[1] - 1)
        rec[:, at:at + 2 * n:2, :g] = (cols[:, idx] - lo).reshape(P, n, g)
        rec[:, at + 1:at + 2 * n:2, :g] = (
            -np.asarray(keys, np.int64)[:, idx] & 0xFFFFFFFF).reshape(P, n, g)

    put(group.cmp_cols, group.cmp_key, gc, n_cg, 1)
    put(group.w_cols, group.w_key, gw, n_wg, 1 + 2 * n_cg)
    return rec


#: most CTAs in the cluster (16 with the non-portable cluster attribute)
MAX_CLUSTER = 16
#: lanes a CTA aims at: fewer lanes run on one CTA, with no cluster step
LANES_PER_CTA = 1024
#: most threads a CTA (a conditional group's; an unconditional group's),
#: and lanes a thread on the shared-memory path
MAX_THREADS = 1024
MAX_THREADS_UNCONDITIONAL = 256
LANES_PER_THREAD = (1, 2, 4)
#: shared memory a CTA may give the tile, and the op records and counts
#: (an unconditional group's records and counts may take what its tile
#: leaves of the two, up to UNCONDITIONAL_TABLE_BYTES)
TILE_BYTES = 196608
TABLE_BYTES = 24576
UNCONDITIONAL_TABLE_BYTES = 98304
#: SMs of the H100 SXM: an unconditional group's lanes spread over them
N_SMS = 132


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """How ``op_group`` runs a group of one shape: on ``path`` "shared"
    (the tile in shared memory) or "global" (in device memory, where a CTA
    cannot hold it), ``ctas`` CTAs of ``threads`` threads, CTA r owning
    lanes [r * slice, (r + 1) * slice); a conditional group's CTAs form one
    cluster (``cluster == ctas``), an unconditional group's are independent
    (``cluster == 1``).  On the shared-memory path a thread owns ``lpt``
    of a CTA's lanes (0 on the device-memory path); ``chunk`` op records
    are staged at a time.  ``tile_bytes`` (the tile, 0 on the
    device-memory path) and ``table_bytes`` (a chunk's records, enabled
    mask and counts) are a CTA's dynamic shared memory."""
    path: str
    cluster: int
    ctas: int
    threads: int
    slice: int
    lpt: int
    chunk: int
    tile_bytes: int
    table_bytes: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def record_bytes(kc: int, kw: int) -> int:
    """Bytes of one op's decoded record (:func:`records`): a flags vector,
    then a vector of rows and one of keys for every group of terms."""
    gc, gw = group_sizes(kc, kw)
    return 16 * (1 + 2 * (-(-kc // gc) + -(-kw // gw)))


def _chunk(n_ops: int, kc: int, kw: int, threads: int, conditional: bool,
           budget: int = TABLE_BYTES) -> tuple[int, int]:
    """Ops whose records, enabled words and counts fit ``budget`` bytes,
    and their bytes: the CTA's count and one a warp (a conditional group),
    or the CTA's count, a slot in the list of the ops that run and one
    byte a thread (an unconditional one); and the slots read ahead of the
    chunk's last op (a record and an enabled word, and two list slots)."""
    per_op = record_bytes(kc, kw) + (4 * (2 + threads // 32) if conditional
                                     else 12 + threads)
    # the slots read ahead of the last op
    guard = record_bytes(kc, kw) + (4 if conditional else 12)
    chunk = min(n_ops, (budget - guard) // per_op)
    if chunk < 1:
        raise NotImplementedError(
            f"an op of Kc={kc}, Kw={kw} terms does not fit the kernel's "
            f"{budget}-byte table budget")
    return chunk, chunk * per_op + guard


def _check_shape(what: str, n_lanes, rows, n_ops, kc, kw) -> None:
    if n_lanes < 1 or rows < 1 or n_ops < 1 or kc < 1 or kw < 1:
        raise ValueError(f"no {what} plan for {n_lanes} lanes, {rows} "
                         f"rows, {n_ops} ops, Kc={kc}, Kw={kw}")


@functools.lru_cache(maxsize=256)
def plan_conditional(n_lanes: int, rows: int, n_ops: int, kc: int,
                     kw: int) -> GroupPlan:
    """The launch of a conditional group over ``n_lanes`` lanes whose
    tables touch ``rows`` consecutive rows, chosen by shape alone.

    The cluster has the fewest CTAs, a power of two up to
    :data:`MAX_CLUSTER`, that give each about :data:`LANES_PER_CTA`
    lanes; a CTA's slice is split over at most 1024 threads, 1, 2 or 4
    lanes a thread.  Where that slice needs more than 4 lanes a thread, or
    its tile (``rows * slice`` words) exceeds :data:`TILE_BYTES`, the
    group takes the device-memory path.  The op records, the enabled mask
    and the counts of each warp and of the CTA go in chunks of ops that
    fit :data:`TABLE_BYTES`.
    """
    _check_shape("conditional", n_lanes, rows, n_ops, kc, kw)
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * LANES_PER_CTA < n_lanes:
        cluster *= 2
    need = -(-n_lanes // cluster)
    path, threads, slice_, lpt, tile = "global", 0, need, 0, 0
    for k in LANES_PER_THREAD:      # 1 or 2 lanes up to 512 threads, 4 up
        t = _round_up(-(-need // k), 32)     # to 1024
        if t <= (512 if k < LANES_PER_THREAD[-1] else MAX_THREADS):
            if 4 * rows * t * k <= TILE_BYTES:
                path, threads, slice_, lpt = "shared", t, t * k, k
                tile = 4 * rows * slice_
            break
    if path == "global":
        threads = min(MAX_THREADS, _round_up(need, 32))
    chunk, table = _chunk(n_ops, kc, kw, threads, True)
    return GroupPlan(path, cluster, cluster, threads, slice_, lpt, chunk,
                     tile, table)


@functools.lru_cache(maxsize=256)
def plan_unconditional(n_lanes: int, rows: int, n_ops: int, kc: int,
                       kw: int) -> GroupPlan:
    """The launch of an unconditional group over ``n_lanes`` lanes whose
    tables touch ``rows`` consecutive rows, chosen by shape alone.

    Lanes never interact, so the CTAs are independent and spread over the
    card: ceil(n_lanes / :data:`N_SMS`) lanes a CTA, a warp at least, on
    at most :data:`MAX_THREADS_UNCONDITIONAL` threads: a lane a thread up
    to 128 lanes a CTA, then 2 consecutive lanes a thread up to 512 and 4
    beyond (8- and 16-byte loads of a row); past 1024 lanes an SM the card
    takes more CTAs than it has SMs.  Where that slice's tile
    (``rows * slice`` words) exceeds :data:`TILE_BYTES`, the slice
    shrinks, in lanes a thread and then in warps, until it fits; where not
    even 32 lanes of the rows fit, the group takes the device-memory path:
    at most a lane a thread, in CTAs of :data:`MAX_THREADS_UNCONDITIONAL`
    threads, all of which copy the rows through.  Records go in chunks, as
    :func:`plan_conditional`'s but with what the tile leaves of the shared
    memory, up to :data:`UNCONDITIONAL_TABLE_BYTES`.
    """
    _check_shape("unconditional", n_lanes, rows, n_ops, kc, kw)
    need = -(-n_lanes // N_SMS)
    fit = TILE_BYTES // (4 * rows)          # lanes a CTA's tile holds
    if fit < 32:
        path, lpt, tile = "global", 0, 0
        threads = MAX_THREADS_UNCONDITIONAL
        slice_ = min(threads, _round_up(need, 32))
    else:
        path = "shared"
        want = 1 if need <= 128 else 2 if need <= 512 else 4
        # the widest slice that fits; on a tie, more lanes a thread
        fits = [(min(MAX_THREADS_UNCONDITIONAL, _round_up(-(-need // k), 32),
                     fit // k // 32 * 32), k)
                for k in LANES_PER_THREAD if k <= want]
        threads, lpt = max(fits, key=lambda tk: (tk[0] * tk[1], tk[1]))
        slice_ = threads * lpt
        tile = 4 * rows * slice_
    chunk, table = _chunk(n_ops, kc, kw, threads, False, max(
        TABLE_BYTES, min(UNCONDITIONAL_TABLE_BYTES,
                         TILE_BYTES + TABLE_BYTES - tile)))
    return GroupPlan(path, 1, -(-n_lanes // slice_), threads, slice_, lpt,
                     chunk, tile, table)


def branched_on(cond) -> np.ndarray:
    """bool[P]: the ops that a later op branches on (some q in p+1..p+4
    with ``cond[q] == q - p``), the only ones whose counts the cluster
    kernel exchanges between its CTAs (flagged in their records)."""
    cond = np.asarray(cond)
    P = cond.shape[0]
    out = np.zeros(P, bool)
    for d in range(1, ref.MAX_COND + 1):
        out[:max(P - d, 0)] |= cond[d:] == d
    return out


def run_group(planes: torch.Tensor, tag: torch.Tensor,
              group: OpGroup | DeviceGroup, enabled=None, *,
              backend: str = "jnp", mesh=None, block_lanes: int = 512,
              interpret: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Execute one op group -> (planes', tag', matched int32[P]).

    planes : int32[n_bits, n_lanes];  tag : int32[n_lanes]
    enabled: optional bool[P] op mask, NumPy or a tensor (default: all on)
    mesh   : optional tuple of devices — shards planes/tag over their lanes
             (backend ``"jnp"`` only; n_lanes must divide evenly), see
             :func:`run_group_sharded`; the results come back on the
             planes' device
    The inputs are left unchanged: the kernel writes new outputs, and the
    wrapper copies and fills nothing.  ``backend``, ``block_lanes`` and
    ``interpret`` are the reference's options and change nothing (beyond
    the reference's check of ``backend`` with ``mesh``): the planes'
    device picks the kernel or the plain version.  A group runs as
    :func:`plan_conditional` or :func:`plan_unconditional` plans it.
    """
    obs.count("kernels/launch/ap_megakernel")
    obs.count(f"kernels/launch/ap_megakernel/{backend}"
              + ("_sharded" if mesh is not None else ""))
    if mesh is not None:
        if backend != "jnp":
            raise ValueError(
                f"sharded megakernel execution requires backend='jnp' "
                f"(got {backend!r})")
        mesh = tuple(mesh)
        n_lanes = planes.shape[1]
        n_shards = len(mesh)
        if n_lanes % n_shards != 0:
            raise ValueError(
                f"n_lanes={n_lanes} not divisible by n_shards={n_shards}; "
                f"pick n_words a multiple of {32 * n_shards}")
        sg = group if type(group) is ShardedGroup \
            else sharded_group(group, mesh)
        pl, tg, matched = run_group_sharded(
            *split_lanes(planes, tag, mesh), sg, enabled)
        return (*gather_lanes(pl, tg, planes.device), matched)
    return _run_one(planes, tag, group, enabled)


def _run_one(planes: torch.Tensor, tag: torch.Tensor,
             group: OpGroup | DeviceGroup, enabled=None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One group on one device: the kernel on a card, the plain version
    on the CPU (:func:`run_group` without its obs counts)."""
    if not planes.is_cuda:
        if planes.device.type != "cpu":
            raise ValueError(f"unsupported device {planes.device}")
        out_planes, out_tag, matched, _ = ref.group_scan_plain(
            planes, tag, group.tables(), enabled)
        return out_planes, out_tag, matched
    if planes.dim() != 2 or planes.dtype != torch.int32:
        raise ValueError(f"planes must be int32 [n_bits, n_lanes]; got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    n_bits, n_lanes = planes.shape
    dev = planes.get_device()
    if (tag.shape != (n_lanes,) or tag.dtype != torch.int32
            or tag.get_device() != dev):
        raise ValueError(f"tag must be int32 [{n_lanes}] on {planes.device};"
                         f" got {tag.dtype} {tuple(tag.shape)} on "
                         f"{tag.device}")
    dg = group if type(group) is DeviceGroup \
        else device_group(group, planes.device)
    if dg.packed.get_device() != dev:
        raise ValueError(f"group tables on {dg.packed.device}, planes on "
                         f"{planes.device}")
    P = dg.n_ops
    lo, hi = dg.col_range
    if lo < 0 or hi >= n_bits:
        raise IndexError(f"group column outside [0, {n_bits})")
    en = None            # the kernel reads every op as enabled
    if enabled is not None:
        # the kernel reads a bool mask as it comes (no conversion on the card)
        en = torch.as_tensor(enabled, device=planes.device)
        if en.dtype != torch.bool:
            en = en != 0
        if en.shape != (P,):
            raise ValueError(f"enabled must have shape ({P},); got "
                             f"{tuple(en.shape)}")
        en = en.contiguous()
    planes = planes.contiguous()
    tag = tag.contiguous()
    out_planes = torch.empty_like(planes)
    out_tag = torch.empty_like(tag)
    matched = torch.empty(P, dtype=torch.int32, device=planes.device)
    if n_lanes == 0:
        return out_planes, out_tag, matched.zero_()
    launch = dg.launch.get((n_bits, n_lanes))
    if launch is None:
        launch = dg.launch[(n_bits, n_lanes)] = _launch_params(dg, n_bits,
                                                               n_lanes)
    prm, plan = launch
    stream = _build.stream(dev)
    acc = None
    if not dg.conditional and plan.ctas > 1:
        acc = _accumulator(dev, stream, P).data_ptr()
    rc = _fn("ap_megakernel_run_group")(
        planes.data_ptr(), out_planes.data_ptr(), tag.data_ptr(),
        out_tag.data_ptr(), dg.records.data_ptr(),
        None if en is None else en.data_ptr(), matched.data_ptr(), acc, prm,
        stream)
    if rc:
        _build.check(rc, "ap_megakernel_run_group")
    run_group.launches += 1
    if not dg.conditional:
        run_group.unconditional_launches += 1
    return out_planes, out_tag, matched


run_group.launches = 0
run_group.unconditional_launches = 0


# ---------------------------------------------------------------------------
# lane sharding
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedGroup:
    """An op group cut for lane-sharded execution on ``devices``.

    ``segments[i]`` is an op range ``(a, b)``: a segment ends after each
    op a later op branches on (:func:`branched_on`), so every condition
    of a segment reads a count of an earlier segment, summed over the
    shards by then.  ``groups[i][d]`` is the segment as an unconditional
    :class:`DeviceGroup` (conditions cleared) on device ``d``;
    ``cond``/``src`` (on the first device) give each op's condition and
    the op it reads, from which a segment's ``enabled`` is formed."""
    devices: tuple
    n_ops: int
    segments: tuple
    groups: tuple
    conditional: tuple      # bool per segment: some op of it has cond > 0
    cond: torch.Tensor
    src: torch.Tensor


def sharded_group(group: OpGroup, devices) -> ShardedGroup:
    """Cut ``group`` into segments and upload each to every distinct
    device of ``devices`` once (a device program reuses the result for
    every run of the group)."""
    devices = tuple(torch.device(d) for d in devices)
    P = group.n_ops
    ends = np.flatnonzero(branched_on(group.cond)) + 1
    bounds = [0] + [int(e) for e in ends if e < P] + [P]
    segments = tuple(zip(bounds[:-1], bounds[1:]))
    groups, conditional = [], []
    for a, b in segments:
        seg = OpGroup(group.op[a:b], np.zeros(b - a, np.int32),
                      group.cmp_cols[a:b], group.cmp_key[a:b],
                      group.w_cols[a:b], group.w_key[a:b])
        groups.append({d: device_group(seg, d) for d in set(devices)})
        conditional.append(bool(group.cond[a:b].max() > 0))
    cond = torch.from_numpy(group.cond.astype(np.int64)).to(devices[0])
    src = (torch.arange(P, device=devices[0]) - cond).clamp(min=0)
    return ShardedGroup(devices, P, segments, tuple(groups),
                        tuple(conditional), cond, src)


def split_lanes(planes: torch.Tensor, tag: torch.Tensor, devices
                ) -> tuple[list, list]:
    """Planes ``[n_bits, n_lanes]`` and tag ``[n_lanes]`` as equal lane
    shards, shard s on ``devices[s]``."""
    w = planes.shape[1] // len(devices)
    return ([planes[:, s * w:(s + 1) * w].to(d).contiguous()
             for s, d in enumerate(devices)],
            [tag[s * w:(s + 1) * w].to(d).contiguous()
             for s, d in enumerate(devices)])


def gather_lanes(planes: list, tag: list, device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The lane shards laid side by side again, on ``device``."""
    return (torch.cat([p.to(device) for p in planes], dim=1),
            torch.cat([t.to(device) for t in tag]))


def run_group_sharded(planes: list, tag: list, sg: ShardedGroup,
                      enabled=None) -> tuple[list, list, torch.Tensor]:
    """Run ``sg`` over lane shards (``planes[s]``, ``tag[s]`` on
    ``sg.devices[s]``) -> (planes' list, tag' list, matched int32[P] on
    the first device, the counts summed over the shards).

    Segment by segment: its ``enabled`` is the op mask AND, for each op
    with ``cond > 0``, (the summed count of the op it reads > 0), formed
    on the first device; it is launched on every shard before any count
    is gathered, and the shards' counts are summed on the first device.
    """
    if len(planes) != len(sg.devices):
        raise ValueError(f"{len(planes)} plane shards for "
                         f"{len(sg.devices)} devices")
    home = sg.devices[0]
    en_all = None
    if enabled is not None:
        en_all = torch.as_tensor(enabled, device=home)
        en_all = en_all if en_all.dtype == torch.bool else en_all != 0
        if en_all.shape != (sg.n_ops,):
            raise ValueError(f"enabled must have shape ({sg.n_ops},); got "
                             f"{tuple(en_all.shape)}")
    matched = torch.zeros(sg.n_ops, dtype=torch.int32, device=home)
    for (a, b), dgs, cnd in zip(sg.segments, sg.groups, sg.conditional):
        en = None if en_all is None else en_all[a:b]
        if cnd:
            ok = (sg.cond[a:b] == 0) | (matched[sg.src[a:b]] > 0)
            en = ok if en is None else en & ok
        outs = [_run_one(p, t, dgs[d], None if en is None else en.to(d))
                for p, t, d in zip(planes, tag, sg.devices)]
        planes = [o[0] for o in outs]
        tag = [o[1] for o in outs]
        total = outs[0][2].to(home)
        for o in outs[1:]:
            total = total + o[2].to(home)
        matched[a:b] = total
    return planes, tag, matched


def _launch_params(dg: DeviceGroup, n_bits: int, n_lanes: int):
    """The kernel's host parameters for ``dg`` over planes of ``n_bits x
    n_lanes`` (``ap_megakernel_run_group``'s ``prm``: the shapes, the
    records' groups of terms and the plan) and the plan."""
    if n_bits * n_lanes >= 2 ** 30:
        raise NotImplementedError(f"{n_bits} x {n_lanes} words: the kernel "
                                  f"reaches rows by 32-bit byte offsets")
    P, kc, kw = dg.dims
    lo, hi = dg.col_range
    gc, gw = group_sizes(kc, kw)
    plan_fn = plan_conditional if dg.conditional else plan_unconditional
    pl = plan_fn(n_lanes, hi - lo + 1, P, kc, kw)
    prm = (ctypes.c_int * 16)(
        n_bits, n_lanes, lo, hi - lo + 1, P, -(-kc // gc), -(-kw // gw), gc,
        gw, pl.cluster, pl.threads, pl.slice, pl.lpt, pl.chunk, pl.ctas,
        int(dg.conditional))
    return prm, pl


#: the unconditional kernel's count accumulators, by (card, stream)
_ACCUMULATORS: dict = {}


def _accumulator(dev: int, stream: int, n_ops: int) -> torch.Tensor:
    """int32 zeros ``[1 + n_ops]`` (or more) for independent CTAs' counts
    on ``stream``: the kernel leaves it zero after each launch, so it is
    zeroed only when made.  One a stream, so launches on two streams never
    share one."""
    acc = _ACCUMULATORS.get((dev, stream))
    if acc is None or acc.numel() < 1 + n_ops:
        acc = torch.zeros(1 + max(n_ops, 1024), dtype=torch.int32,
                          device=torch.device("cuda", dev))
        _ACCUMULATORS[(dev, stream)] = acc
    return acc


#: the probe's cluster: the 2^20 sort's rounds (16 CTAs of 512 threads)
PROBE_CLUSTER, PROBE_THREADS = 16, 512


def cluster_probe(device="cuda", iters: int = 4096) -> dict:
    """Cycle counts on the card, from ``ap_megakernel_probe`` launched as
    one cluster of :data:`PROBE_CLUSTER` CTAs of :data:`PROBE_THREADS`
    threads:
    ``barrier_cycles`` (the round trip of a cluster barrier),
    ``dsmem_cycles`` (a store into a peer CTA's shared memory until the
    peer's load sees it: half a ping-pong between CTAs 0 and 1),
    ``op_cycles`` (one op's chain in shared memory on one warp: load,
    logic, popcount, warp reduction, store, the next load) and ``sm_ghz``
    (the SM clock over the probe)."""
    out = torch.zeros(7, dtype=torch.int64, device=device)
    _build.check(_fn("ap_megakernel_probe")(
        out.data_ptr(), iters, PROBE_CLUSTER, PROBE_THREADS,
        _build.stream(out.get_device())), "ap_megakernel_probe")
    t = out.tolist()
    if t[6]:
        raise RuntimeError("ap_megakernel_probe: a store into a peer's "
                           "shared memory was not seen by its load")
    return dict(barrier_cycles=t[0] / iters, dsmem_cycles=t[1] / iters / 2,
                op_cycles=t[2] / iters, sm_ghz=t[3] / t[4])


_ARGTYPES = {
    "ap_megakernel_run_group": [ctypes.c_void_p] * 8
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p],
    "ap_megakernel_probe": [ctypes.c_void_p] + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}
_FNS: dict = {}


def _fn(name: str):
    """The library's C entry ``name``, typed and resolved once."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("ap_megakernel"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _FNS[name] = fn
    return fn
