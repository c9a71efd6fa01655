"""LLM-serving traffic → power → thermal interval co-simulation.

Turns per-request inference cost of the assigned ``configs/`` models
(``serving.cost``, built on ``launch/roofline.py``) and a request-trace
shape (``serving.traffic``) into per-interval stack power, replayed
through the ``stack/feedback`` closed loop with adaptive interval
coarsening (``serving.sim``; docs/serving.md walks the pipeline).  The
port of the reference's ``serving`` package, with its ``__all__``; the
replays run on the keyword-only ``device`` of ``run_serving_cosim``.
"""
from repro_torch.serving.cost import (ModelServingCost, RequestShape,
                                      kv_bytes_per_token, serving_cost)
from repro_torch.serving.sim import (QueueResult, ServingReport,
                                     ServingScenario, fluid_queue,
                                     run_serving_cosim, verdict_table)
from repro_torch.serving.traffic import SHAPES, TrafficSpec

__all__ = [
    "ModelServingCost", "RequestShape", "kv_bytes_per_token",
    "serving_cost", "QueueResult", "ServingReport", "ServingScenario",
    "fluid_queue", "run_serving_cosim", "verdict_table", "SHAPES",
    "TrafficSpec",
]
