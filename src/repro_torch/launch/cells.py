"""Cell enumeration + per-cell performance defaults (the port's copy of
the reference's ``launch/cells.py``).

A *cell* is (architecture x input shape).  ``default_perf`` holds the
baseline knobs; ``PERF_OVERRIDES`` carries the settings the reference
hillclimbed for three cells on its TPU roofline.  The step builders
(``launch/steps.py``) take a ``perf_for`` result as their ``perf``.
"""
from __future__ import annotations

from repro_torch.configs import (SHAPES, ArchConfig, ShapeCell,
                                 cell_is_runnable, get_config, list_configs)
from repro_torch.models.model import PerfConfig

DATA_AXIS = 16          # per-pod data-parallel width


def runnable_cells() -> list[tuple[str, str]]:
    out = []
    for arch in list_configs():
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, _ = cell_is_runnable(cfg, shape)
            if ok:
                out.append((arch, shape.name))
    return out


def default_perf(cfg: ArchConfig, cell: ShapeCell,
                 data_width: int = DATA_AXIS) -> PerfConfig:
    moe_groups = data_width if cfg.moe is not None else 1
    if cell.kind == "train":
        # microbatch = one sequence per data shard; f32 grad accumulation.
        # data_width is 16 single-pod, 32 multi-pod ('pod' x 'data').
        accum = max(1, cell.global_batch // data_width)
        return PerfConfig(remat="full", accum_steps=accum,
                          attn_chunk=512 if cell.seq_len > 8192 else None,
                          moe_groups=moe_groups)
    if cell.kind == "prefill":
        return PerfConfig(remat="none", attn_chunk=1024,
                          moe_groups=moe_groups)
    return PerfConfig(remat="none", scan_layers=True,
                      moe_groups=moe_groups)


# the reference's hillclimbed overrides, keyed (arch, shape, data_width)
PERF_OVERRIDES: dict[tuple[str, str, int], PerfConfig] = {
    # pure FSDP for a 1.6B model, single-pod only: ZeRO-3 over the whole
    # mesh needs global_batch >= the rank count (256 of 256; the 512-rank
    # multi-pod mesh keeps the 2D default)
    ("stablelm-1.6b", "train_4k", 16):
        PerfConfig(remat="full", accum_steps=1, parallelism="fsdp"),
    # group-local MoE dispatch + (G, E)-parallel expert GEMMs + accum tune
    ("deepseek-v2-lite-16b", "train_4k", 16):
        PerfConfig(remat="full", accum_steps=4, moe_groups=16),
    ("deepseek-v2-lite-16b", "train_4k", 32):
        PerfConfig(remat="full", accum_steps=8, moe_groups=32),
    # int8 KV cache (KIVI-style)
    ("codeqwen1.5-7b", "decode_32k", 16):
        PerfConfig(remat="none", kv_quant=True),
    ("codeqwen1.5-7b", "decode_32k", 32):
        PerfConfig(remat="none", kv_quant=True),
}


def perf_for(arch: str, shape_name: str,
             data_width: int = DATA_AXIS) -> PerfConfig:
    cfg = get_config(arch)
    cell = SHAPES[shape_name]
    return PERF_OVERRIDES.get((arch, shape_name, data_width),
                              default_perf(cfg, cell, data_width))


__all__ = ["DATA_AXIS", "PERF_OVERRIDES", "default_perf", "perf_for",
           "runnable_cells"]
