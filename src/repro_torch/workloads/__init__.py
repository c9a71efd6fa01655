"""Exact word-parallel bit-serial AP workloads (PyTorch port).

The paper's §3.1 trio — Black-Scholes (``blackscholes``), FFT (``fft``),
dense matrix multiply (``dmm``) — plus the suite additions: associative
sort (``sort``, min-extraction idiom), sparse matrix-vector multiply
(``spmv``, tag-masked accumulation), k-NN search (``knn``, the
CAM-native workload) and histogram (``histogram``, response-counter
binning).  Every workload emits exact ``(cycle, energy)`` trace events
through the :class:`~repro_torch.core.engine.APEngine` accounting and is
bound to its calibrated analytic model entry by :mod:`.registry`.
"""
from repro_torch.workloads import registry  # noqa: F401  (self-registers)
