"""gemma3-12b [dense] — 5:1 local:global sliding-window, 128k context.

[hf:google/gemma-3-12b-pt; unverified] — per the assignment sheet.
"""
from repro_torch.configs.base import ATTN, LOCAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15_360,
    vocab_size=262_144,
    head_dim=256,
    period=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, ATTN),  # 5 local : 1 global
    sliding_window=1024,
    qk_norm=True,
    rope_theta=10_000.0,          # local layers
    rope_theta_global=1_000_000.0,  # global layers
    act="gelu",
    scale_embed=True,
    tie_embeddings=True,
))
