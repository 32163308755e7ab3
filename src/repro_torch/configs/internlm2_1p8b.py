"""internlm2-1.8b [dense] — GQA llama-family. [arXiv:2403.17297; hf]"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92_544,
    head_dim=128,
    period=(ATTN,),
    rope_theta=1_000_000.0,
    act="silu",
    tie_embeddings=False,
))
