"""Atomic, asynchronous checkpoints (PyTorch port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            restore, save)

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
