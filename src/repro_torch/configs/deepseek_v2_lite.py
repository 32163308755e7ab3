"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 64 routed top-6 + 2 shared.

[arXiv:2405.04434; hf] — layer 0 is dense (d_ff=10944), layers 1..26 MoE.
"""
from repro_torch.configs.base import MLA, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,           # MLA: heads share one latent; kept for bookkeeping
    d_ff=1408,                 # per-expert hidden
    vocab_size=102_400,
    head_dim=192,              # qk_nope + qk_rope
    period=(MLA,),
    prologue=(MLA,),           # dense first layer
    prologue_d_ff=10_944,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    moe=MoEConfig(num_experts=64, experts_per_token=6, num_shared_experts=2,
                  d_ff=1408),
    act="silu",
    tie_embeddings=False,
))
