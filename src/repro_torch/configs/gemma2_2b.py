"""gemma2-2b [dense] — local/global alternating + logit softcaps. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ATTN, LOCAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256_000,
    head_dim=256,
    period=(LOCAL, ATTN),      # alternating sliding-window / full
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    scale_embed=True,
    tie_embeddings=True,
))
