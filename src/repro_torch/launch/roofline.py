"""Roofline terms from a compiled dry-run artifact, and parameter counts.

Hardware constants: one NVIDIA H100 SXM (80 GB HBM3) — 989 TFLOP/s dense
bf16, 3.35 TB/s HBM3, 450 GB/s NVLink a direction.  The three terms of a
step's per-device cost analysis are:

    compute    = flops / peak_flops
    memory     = bytes_accessed / hbm_bw
    collective = wire_bytes / link_bw

wire_bytes applies per-op ring formulas (``ring_wire_bytes``) to every
collective, in the partitioned HLO text (``parse_collectives``) or as
the port's steps issue them (``launch.costing``), result-shape R,
group size n:
    all-gather       R * (n-1)/n
    all-reduce       2R * (n-1)/n
    reduce-scatter   R * (n-1)        (R is the scattered shard)
    all-to-all       R * (n-1)/n
    collective-permute  R
These are bandwidth-optimal schedules on a ring at one card's NVLink
rate a direction.

``count_params`` and ``count_active_params`` walk the port's parameter
tree (nested dicts, per-layer lists; ``launch.steps.params_sds`` builds
it on ``"meta"``), where the reference walks a pytree.
"""
from __future__ import annotations

import dataclasses
import re

# NVIDIA H100 SXM data-sheet peaks at its 700 W limit, not measurements:
# dense bf16 tensor-core rate, HBM3 rate, NVLink 4 rate a direction
# (900 GB/s both ways).  The name ICI_BW stays the reference's.
PEAK_FLOPS = 989e12      # bf16 / card
HBM_BW = 3.35e12         # bytes/s / card
ICI_BW = 450e9           # bytes/s / card, one direction

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

#: the collectives, by the reference's (XLA's) names
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# `%x = f32[8,128]{1,0} all-gather(...)` or tuple `= (f32[..], ..) all-reduce(`
_LINE = re.compile(
    r"=\s*(\(?[a-z0-9]+\[[^=]*?)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"[.\w-]*\(")
_SHAPE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
_GROUPS_NEW = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_OLD = re.compile(r"replica_groups=\{\{([\d,]+)\}")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_NEW.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_OLD.search(line)
    if m:
        return len(m.group(1).split(","))
    return default


def ring_wire_bytes(op: str, result_bytes: float, n: int) -> float:
    """Bytes one rank sends for collective ``op`` (one of ``COLLECTIVES``)
    of result size ``result_bytes`` over a group of ``n``, by the ring
    formulas of this module's docstring.  A group of one sends nothing."""
    if n <= 1:
        return 0.0
    R = float(result_bytes)
    if op == "all-gather":
        return R * (n - 1) / n
    if op == "all-reduce":
        return 2.0 * R * (n - 1) / n
    if op == "reduce-scatter":
        return R * (n - 1)
    if op == "all-to-all":
        return R * (n - 1) / n
    if op == "collective-permute":
        return R
    raise ValueError(f"unknown collective {op!r}")


def parse_collectives(hlo_text: str, default_group: int = 16) -> dict:
    """Sum wire bytes per collective kind over the partitioned module."""
    out = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for line in hlo_text.splitlines():
        m = _LINE.search(line)
        if not m:
            continue
        type_str, op = m.group(1), m.group(2)
        R = _shape_bytes(type_str)
        n = max(_group_size(line, default_group), 2)
        wire = ring_wire_bytes(op, R, n)
        out[op] += wire
        counts[op] += 1
    out["total_wire_bytes"] = sum(out[k] for k in COLLECTIVES)
    out["counts"] = counts
    return out


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    wire_bytes: float
    model_flops: float          # 6*N*D train / 2*N*D inference (per device)
    useful_ratio: float         # model_flops / hlo_flops

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """How close the dominant term is to being the ONLY cost: the ideal
        step time is max(terms) assuming perfect overlap; the 'roofline
        fraction' we report is compute_s / bound_s (1.0 = compute-bound at
        peak; <1 = paying for memory/collectives)."""
        return self.compute_s / self.bound_s if self.bound_s > 0 else 0.0


def _leaves_with_keys(tree, keys=()):
    """(dict keys on the path, leaf) for every tensor of a tree of dicts
    and lists, in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_keys(v, keys + (k,))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves_with_keys(v, keys)
    else:
        yield keys, tree


def count_params(params_sds) -> int:
    return sum(int(_prod(l.shape)) for _, l in _leaves_with_keys(params_sds))


def count_active_params(cfg, params_sds) -> int:
    """MoE: experts count at top_k/n_routed utilization."""
    total = 0
    for keys, leaf in _leaves_with_keys(params_sds):
        n = int(_prod(leaf.shape))
        if cfg.moe is not None and "experts" in keys:
            n = int(n * cfg.moe.top_k / cfg.moe.n_routed)
        total += n
    return total


def _prod(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def model_flops_per_device(cfg, cell, params_sds, n_chips: int) -> float:
    """Reference 'useful' FLOPs per device per step."""
    n_active = count_active_params(cfg, params_sds)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens / n_chips
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens / n_chips
    tokens = cell.global_batch            # one token / sequence
    return 2.0 * n_active * tokens / n_chips


def roofline(cost: dict, coll: dict, model_flops: float) -> RooflineTerms:
    flops = float(cost.get("flops", 0.0))
    ba = float(cost.get("bytes accessed", 0.0))
    wire = float(coll["total_wire_bytes"])
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s=ba / HBM_BW,
        collective_s=wire / ICI_BW,
        flops=flops, bytes_accessed=ba, wire_bytes=wire,
        model_flops=model_flops,
        useful_ratio=(model_flops / flops) if flops else 0.0)
