"""stablelm-1.6b [dense]: 24L, d=2048, 32H MHA, d_ff=5632, vocab=100352.

[hf:stabilityai/stablelm-2-1_6b].  LayerNorm + RoPE + SwiGLU.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab=100352, norm_type="layernorm",
)
