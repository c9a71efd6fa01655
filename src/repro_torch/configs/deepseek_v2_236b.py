"""deepseek-v2-236b [moe]: 60L, d=5120, 128H MLA, MoE 160e top-6 + 2 shared.

[arXiv:2405.04434; hf].  MLA kv_lora=512, q_lora=1536, qk_nope=128,
qk_rope=64, v=128.  First layer dense (d_ff=12288), remaining 59 MoE with
d_expert=1536.
"""
from repro_torch.configs.base import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400,
    mla=MLACfg(kv_lora=512, q_lora=1536, qk_nope=128, qk_rope=64, v_dim=128),
    moe=MoECfg(n_routed=160, n_shared=2, top_k=6, d_expert=1536,
               first_dense=1, d_ff_dense=12288),
)
