"""Execution over several devices (PyTorch port of ``repro.parallel``):
the sweep-case batch and the AP lane sharding of :mod:`.sharding`."""
from repro_torch.parallel.sharding import (ap_mesh, local_devices,
                                           pad_case_batch, shard_case_batch,
                                           sweep_mesh, unpad_case_batch)

__all__ = ["ap_mesh", "local_devices", "pad_case_batch", "shard_case_batch",
           "sweep_mesh", "unpad_case_batch"]
