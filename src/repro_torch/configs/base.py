"""Architecture configuration schema + shape cells for the assigned pool.

Every assigned architecture gets one ``configs/<id>.py`` defining ``CONFIG``
(exact public numbers) — the registry in ``configs/__init__`` collects them.
``ArchConfig.reduced()`` returns the smoke-test scale of the same family
(small layers/width/experts/vocab) used by per-arch CPU tests; the FULL
configs are only ever lowered via ShapeDtypeStructs in the dry-run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_routed: int
    n_shared: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    first_dense: int = 1          # leading dense layers (DeepSeek-V2 style)
    d_ff_dense: int = 0           # d_ff of those dense layers (0 => 4*d)


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora: int = 512
    q_lora: Optional[int] = None  # None => direct q projection (V2-Lite)
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    version: int = 1              # 1 = Mamba, 2 = Mamba-2 (SSD)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 => ceil(d_model / 16)
    headdim: int = 64             # mamba2 head dim
    chunk: int = 256              # chunked-scan chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0               # 0 => d_model // n_heads
    rope_theta: float = 1e4
    mrope_sections: Optional[tuple] = None   # qwen2-vl M-RoPE (t, h, w) split
    sliding_window: Optional[int] = None
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    n_enc_layers: int = 0         # encdec only
    enc_seq: int = 1500           # whisper audio frames after conv stem
    attn_every: int = 0           # hybrid: shared attn block period
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm
    qkv_bias: bool = False        # qwen-style attention input biases
    frontend: Optional[str] = None  # 'audio' | 'vision' (stub embeddings)
    n_prefix_embeds: int = 0      # vlm: leading positions fed by the stub

    @property
    def head_dim(self) -> int:
        if self.mla is not None:
            return self.mla.qk_nope + self.mla.qk_rope
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (bounded state per token)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def reduced(self) -> "ArchConfig":
        """Smoke-test scale: same family/topology, tiny dims."""
        changes: dict = dict(
            n_layers=min(self.n_layers, 4 if self.attn_every == 0 else 6),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, int(round(4 * self.n_kv_heads / max(self.n_heads, 1)))),
            d_ff=256,
            vocab=512,
            d_head=32,
            sliding_window=64 if self.sliding_window else None,
            enc_seq=32,
            n_enc_layers=2 if self.n_enc_layers else 0,
            attn_every=3 if self.attn_every else 0,
            n_prefix_embeds=8 if self.n_prefix_embeds else 0,
        )
        if self.mrope_sections is not None:
            changes["mrope_sections"] = (4, 6, 6)   # sums to d_head/2 = 16
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_routed=8, n_shared=min(self.moe.n_shared, 2),
                top_k=2, d_expert=64, first_dense=min(self.moe.first_dense, 1),
                d_ff_dense=256)
        if self.mla is not None:
            changes["mla"] = dataclasses.replace(
                self.mla, kv_lora=64,
                q_lora=(96 if self.mla.q_lora else None),
                qk_nope=32, qk_rope=16, v_dim=32)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=8, headdim=16, chunk=16)
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# shape cells (assigned): every LM arch x these four
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ArchConfig, shape: ShapeCell) -> tuple[bool, str]:
    """Apply the assignment's skip rules; returns (runnable, reason)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: long_500k needs sub-quadratic"
    return True, ""
