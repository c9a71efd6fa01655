"""h2o-danube-3-4b [dense]: 24L, d=3840, 32H GQA(kv=8), d_ff=10240, SWA.

[arXiv:2401.16818].  llama+mistral mix with sliding-window attention
(window 4096) -> the KV ring buffer keeps long_500k decode O(W).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000, sliding_window=4096,
)
