"""Execution over several devices (PyTorch port of ``repro.parallel``):
parameter and cache specs placed on a ``DeviceMesh``, the sweep-case
batch and the AP lane sharding of :mod:`.sharding`."""
from repro_torch.parallel.sharding import (STACK_KEYS, NamedSharding, P,
                                           ap_mesh, cache_specs, gather,
                                           local_devices, make_sharder,
                                           pad_case_batch, param_specs,
                                           place, shard_case_batch,
                                           sweep_mesh, to_named,
                                           unpad_case_batch)

__all__ = ["NamedSharding", "P", "STACK_KEYS", "ap_mesh", "cache_specs",
           "gather", "local_devices", "make_sharder", "pad_case_batch",
           "param_specs", "place", "shard_case_batch", "sweep_mesh",
           "to_named", "unpad_case_batch"]
