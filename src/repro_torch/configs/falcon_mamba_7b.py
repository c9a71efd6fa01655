"""falcon-mamba-7b [ssm]: 64L pure Mamba-1, d=4096, state=16, vocab=65024.

[arXiv:2410.05355].  Attention-free; d_inner=8192 (expand=2), d_conv=4.
"""
from repro_torch.configs.base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65024,
    ssm=SSMCfg(version=1, d_state=16, d_conv=4, expand=2),
)
