"""Optimizer (PyTorch port of ``repro.optim``): AdamW with float32
moments and a global-norm clip, and int8 error-feedback compression."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]
