"""smollm-360m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-360M; hf]"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,      # GQA 3:1
    d_ff=2560,
    vocab_size=49_152,
    head_dim=64,
    period=(ATTN,),
    act="silu",
    tie_embeddings=True,
))
