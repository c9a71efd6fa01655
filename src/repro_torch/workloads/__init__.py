"""Exact word-parallel bit-serial AP workloads (PyTorch port).

The paper's §3.1 trio — Black-Scholes (``blackscholes``), FFT (``fft``),
dense matrix multiply (``dmm``).  Every workload emits exact
``(cycle, energy)`` trace events through the
:class:`~repro_torch.core.engine.APEngine` accounting and is bound to its
calibrated analytic model entry by :mod:`.registry`.
"""
from repro_torch.workloads import registry  # noqa: F401  (self-registers)
