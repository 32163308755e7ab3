"""musicgen-medium [audio] — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a stub; inputs are 4-codebook token ids
(delay pattern applied upstream). Embeddings of the 4 codebooks are summed and
the head emits 4x2048 logits.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,           # full MHA
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    period=(ATTN,),
    num_codebooks=4,
    act="gelu",
    tie_embeddings=False,
    vocab_pad_to=128,
))
