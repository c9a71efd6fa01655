"""Synthetic LM data (the port's copy of ``repro.data``)."""
from repro_torch.data.pipeline import SyntheticLM, make_batch

__all__ = ["SyntheticLM", "make_batch"]
