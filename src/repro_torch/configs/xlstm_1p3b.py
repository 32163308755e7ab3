"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, 7:1 ratio. [arXiv:2405.04517; unverified]

d_ff=0 per the sheet: blocks carry their own up/down projections, no separate MLP.
"""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    head_dim=512,
    period=(MLSTM, MLSTM, MLSTM, MLSTM, MLSTM, MLSTM, MLSTM, SLSTM),
    act="gelu",
    tie_embeddings=True,
))
