"""whisper-base [audio]: enc-dec, 6L+6L, d=512, 8H, d_ff=2048, vocab=51865.

[arXiv:2212.04356].  Audio conv frontend is a STUB per the assignment:
input_specs() supplies precomputed frame embeddings [B, 1500, 512].
Decoder uses RoPE in this implementation (deviation from Whisper's learned
absolute embeddings, noted in DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865,
    enc_seq=1500, norm_type="layernorm", frontend="audio",
)
