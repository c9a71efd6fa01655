"""Fault-tolerant training loop (PyTorch port of ``repro.runtime``)."""
from repro_torch.runtime.trainer import (StragglerMonitor, TrainerConfig,
                                         train_loop)

__all__ = ["StragglerMonitor", "TrainerConfig", "train_loop"]
