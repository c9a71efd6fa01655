"""qwen2-vl-72b [vlm]: 80L, d=8192, 64H GQA(kv=8), d_ff=29568, vocab=152064.

[arXiv:2409.12191; hf].  M-RoPE (t/h/w sections 16/24/24 of the 64 rotary
half-dims) + QKV bias.  Vision frontend is a STUB: input_specs() supplies
precomputed patch embeddings for the first n_prefix_embeds positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24), frontend="vision", n_prefix_embeds=256,
)
