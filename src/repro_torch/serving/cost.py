"""Per-request LLM inference cost from the roofline machinery.

Bridges the repo's two halves: the analytic LM cost model
(``launch/roofline.py`` — parameter counts from the shape-only tree of
``launch.steps.params_sds`` on ``"meta"``, MoE active-parameter
discounts, the 2·N flop/token serving rule) and the paper's AP machine
model (``core/models.py``).  The port of the reference's
``serving/cost.py``: the same host arithmetic in float64.  For one
``configs/`` entry and a request shape it produces

* per-request prefill/decode FLOPs and the per-decode-step byte
  traffic (active-parameter stream + per-sequence KV/state reads, the
  ``models/serve.py`` batching semantics: one parameter read per step is
  amortized over the whole decode batch);
* the decode arithmetic intensity AI(B) [flop/word] as a function of
  batch size — batching raises AI because the parameter stream is
  shared;
* a :class:`~repro_torch.core.models.Workload` minted from that AI by the
  same inverse-AI anchoring the suite workloads use
  (``models.derived_workload``), which gives the serving scenario its
  same-performance AP/SIMD design pair and DRAM-traffic figure.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.core import models as M

BYTES_PER_PARAM = 2.0          # bf16 serving weights (launch/steps.py dtype)
KV_BYTES_PER_EL = 2.0          # bf16 KV cache entries


@dataclasses.dataclass(frozen=True)
class RequestShape:
    """One request class: prompt length in, generated tokens out."""
    prompt_tokens: int = 1024
    output_tokens: int = 128

    def __post_init__(self):
        if self.prompt_tokens < 1 or self.output_tokens < 1:
            raise ValueError("prompt/output tokens must be >= 1")


def kv_bytes_per_token(cfg) -> float:
    """Per-token KV-cache footprint in bytes (what each decode step
    re-reads per sequence per context token).

    MLA configs cache the compressed latent (kv_lora + rope dims);
    attention-free SSM blocks keep O(1) state per sequence, so their
    per-context-token cost is 0; hybrids pay only for the shared
    attention blocks (one per ``attn_every`` layers).
    """
    if cfg.family == "ssm":
        return 0.0
    if cfg.mla is not None:
        per_layer = cfg.mla.kv_lora + cfg.mla.qk_rope
    else:
        per_layer = 2 * cfg.n_kv_heads * cfg.head_dim
    if cfg.family == "hybrid":
        n_attn = max(cfg.n_layers // max(cfg.attn_every, 1), 1)
    else:
        n_attn = cfg.n_layers
    return float(n_attn * per_layer * KV_BYTES_PER_EL)


@dataclasses.dataclass(frozen=True)
class ModelServingCost:
    """Analytic serving cost of one config for one request shape."""
    config: str
    request: RequestShape
    n_params: float             # total parameters
    n_active: float             # active per token (MoE top-k discount)
    kv_bytes_tok: float         # KV bytes per context token per sequence

    # ------------------------------------------------------------- flops
    @property
    def prefill_flops(self) -> float:
        """2·N_active per prompt token (launch/roofline.py serving rule)."""
        return 2.0 * self.n_active * self.request.prompt_tokens

    @property
    def decode_flops_per_token(self) -> float:
        return 2.0 * self.n_active

    @property
    def request_flops(self) -> float:
        """Total useful FLOPs to serve one request end to end."""
        return self.prefill_flops \
            + self.decode_flops_per_token * self.request.output_tokens

    # ------------------------------------------------------------- bytes
    @property
    def param_bytes(self) -> float:
        """Weight stream of one decode step (active parameters, read once
        per step regardless of batch — the batching amortization)."""
        return BYTES_PER_PARAM * self.n_active

    @property
    def mean_context(self) -> float:
        """Average live context length during decode."""
        return self.request.prompt_tokens + self.request.output_tokens / 2.0

    def decode_step_bytes(self, batch: int) -> float:
        """DRAM bytes of one decode step at batch size B: one shared
        parameter read + per-sequence KV/state reads."""
        if batch < 1:
            raise ValueError("batch must be >= 1")
        return self.param_bytes \
            + batch * self.kv_bytes_tok * self.mean_context

    def decode_ai(self, batch: int) -> float:
        """Decode arithmetic intensity at batch B [flop/word] — rises
        with B while the shared parameter read dominates, then saturates
        at the KV-bound ceiling."""
        flops = self.decode_flops_per_token * batch
        words = self.decode_step_bytes(batch) / M.BYTES_PER_WORD
        return flops / words

    # ---------------------------------------------------------- machines
    def workload(self, batch: int) -> M.Workload:
        """The serving Workload at batch B: inverse-AI anchoring off the
        DMM calibration (decode is MAC-dominated, so the per-PU speedup
        keeps the DMM value)."""
        return M.derived_workload(f"serve:{self.config}",
                                  self.decode_ai(batch))

    def traffic_bytes_per_s(self, batch: int, n_ap_pus: int) -> float:
        """Demand DRAM traffic at full utilization for the AP sized to
        ``n_ap_pus`` (shared by the same-performance SIMD pair)."""
        return M.traffic_bytes_per_s(self.decode_ai(batch), n_ap_pus)


@functools.lru_cache(maxsize=None)
def _params(config: str) -> tuple[float, float]:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline as RF
    from repro_torch.launch.steps import params_sds

    cfg = get_config(config)
    psds = params_sds(cfg, torch.bfloat16)    # shapes on "meta", no memory
    return RF.count_params(psds), RF.count_active_params(cfg, psds)


def serving_cost(config: str,
                 request: RequestShape = RequestShape()) -> ModelServingCost:
    """Build the analytic serving cost for one registered config."""
    from repro_torch.configs import get_config
    n_total, n_active = _params(config)
    return ModelServingCost(
        config=config, request=request, n_params=float(n_total),
        n_active=float(n_active),
        kv_bytes_tok=kv_bytes_per_token(get_config(config)))


__all__ = ["RequestShape", "ModelServingCost", "serving_cost",
           "kv_bytes_per_token", "BYTES_PER_PARAM", "KV_BYTES_PER_EL"]
