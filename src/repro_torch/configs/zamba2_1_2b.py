"""zamba2-1.2b [hybrid]: 38L Mamba-2 backbone + shared attn block, d=2048.

[arXiv:2411.15242; hf].  ssm_state=64, headdim=64; ONE shared attention+MLP
block (d_ff=8192, 32H) re-applied every 6 mamba layers (weight re-use, the
Zamba signature).
"""
from repro_torch.configs.base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, attn_every=6,
    ssm=SSMCfg(version=2, d_state=64, d_conv=4, expand=2, headdim=64),
)
