"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block. [arXiv:2411.15242; unverified]

81 layers: 1 prologue mamba + 16 periods of (4 mamba + 1 shared attention block).
The shared-attention block re-uses a single weight copy everywhere it appears
(the Zamba signature), so the period layers carry no attention weights of
their own.
"""
from repro_torch.configs.base import (MAMBA, SHARED_ATTN, ModelConfig,
                                      SSMConfig, register)

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14_336,               # shared block MLP
    vocab_size=32_000,
    head_dim=112,
    period=(MAMBA, MAMBA, MAMBA, MAMBA, SHARED_ATTN),
    prologue=(MAMBA,),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4, chunk=256),
    act="gelu",
    tie_embeddings=True,
))
