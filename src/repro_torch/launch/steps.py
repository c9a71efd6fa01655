"""Step builders (the port's ``launch/steps.py``): for now only the
shape-only parameter tree, ``params_sds``.

The reference's ``params_sds`` is ``jax.eval_shape`` of ``init_params``;
here ``init_params`` builds the same tree on the ``"meta"`` device, so
every leaf has its shape and dtype and no memory, and the largest
configs (``deepseek-v2-236b``, ``qwen2-vl-72b``) cost nothing to count.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M


def params_sds(cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    """The port's parameter tree of ``cfg`` with every leaf on
    ``"meta"``: shapes and dtypes, no storage."""
    return M.init_params(cfg, torch.Generator(), dtype, device="meta")


__all__ = ["params_sds"]
