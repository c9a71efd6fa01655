"""deepseek-v2-lite-16b [moe]: 27L, d=2048, 16H MLA, MoE 64e top-6 + 2 shared.

[arXiv:2405.04434; hf].  MLA kv_lora=512 without q-LoRA; d_expert=1408;
first layer dense (d_ff=10944).
"""
from repro_torch.configs.base import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    mla=MLACfg(kv_lora=512, q_lora=None, qk_nope=128, qk_rope=64, v_dim=128),
    moe=MoECfg(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
               first_dense=1, d_ff_dense=10944),
)
