"""Config registry: one module per assigned architecture (+ paper AP config).

``get_config(name)`` accepts the assignment ids (e.g. 'deepseek-v2-lite-16b').
The port keeps its own copy of the reference package's pure-data configs;
``tests/test_torch_lm_serve.py`` holds the two equal.
"""
from repro_torch.configs.base import ArchConfig, MLACfg, MoECfg, SSMCfg, \
    SHAPES, ShapeCell, cell_is_runnable  # noqa: F401

from repro_torch.configs import (  # noqa: E402
    codeqwen1_5_7b, deepseek_v2_236b, deepseek_v2_lite_16b, falcon_mamba_7b,
    h2o_danube_3_4b, phi3_medium_14b, qwen2_vl_72b, stablelm_1_6b,
    whisper_base, zamba2_1_2b)

_ALL = [
    whisper_base.CONFIG,
    deepseek_v2_236b.CONFIG,
    deepseek_v2_lite_16b.CONFIG,
    stablelm_1_6b.CONFIG,
    phi3_medium_14b.CONFIG,
    codeqwen1_5_7b.CONFIG,
    h2o_danube_3_4b.CONFIG,
    qwen2_vl_72b.CONFIG,
    zamba2_1_2b.CONFIG,
    falcon_mamba_7b.CONFIG,
]
REGISTRY = {c.name: c for c in _ALL}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_configs() -> list[str]:
    return [c.name for c in _ALL]
