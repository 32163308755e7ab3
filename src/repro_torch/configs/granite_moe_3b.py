"""granite-moe-3b-a800m [moe] — 40 experts top-8.

[hf:ibm-granite/granite-3.0-3b-a800m-base; hf] — per the assignment sheet
(32L d_model=1536 24H GQA kv=8 per-expert d_ff=512 vocab=49155, 40e top-8).
"""
from repro_torch.configs.base import ATTN, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,                  # per-expert hidden size
    vocab_size=49_155,
    head_dim=64,
    period=(ATTN,),
    moe=MoEConfig(num_experts=40, experts_per_token=8, d_ff=512),
    act="silu",
    tie_embeddings=True,
))
