"""codeqwen1.5-7b [dense]: 32L, d=4096, 32H MHA, d_ff=13440, vocab=92416.

[hf:Qwen/CodeQwen1.5-7B].  Qwen1.5 arch: QKV bias + RoPE + SwiGLU.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416, qkv_bias=True, rope_theta=1e6,
)
