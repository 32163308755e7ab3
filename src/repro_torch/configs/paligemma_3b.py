"""paligemma-3b [vlm] — SigLIP (stub) + gemma decoder. [arXiv:2407.07726; hf]

Backbone only: a batch may carry 256 precomputed patch embeddings (the
SigLIP frontend stub, ``prefix_embed``) before the text token ids.
Prefix-LM masking: bidirectional attention over the image prefix, causal
over text.
"""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,            # MQA
    d_ff=16_384,
    vocab_size=257_216,
    head_dim=256,
    period=(ATTN,),
    prefix_lm=True,
    num_prefix_tokens=256,
    act="gelu",
    scale_embed=True,
    tie_embeddings=True,
))
