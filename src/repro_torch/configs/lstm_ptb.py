"""lstm-ptb — the paper's own LSTM/PTB model (Sentinel Table 3 row 'LSTM').

Medium PTB LSTM (Zaremba et al.): 2 layers, width 650, vocab 10000, BPTT.
Included so the paper's own benchmark suite has a native member alongside the
assigned archs; not part of the 40 dry-run cells.
"""
from repro_torch.configs.base import LSTM, ModelConfig, register

CONFIG = register(ModelConfig(
    name="lstm-ptb",
    family="lstm",
    num_layers=2,
    d_model=650,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=10_000,
    head_dim=650,
    period=(LSTM,),
    act="silu",
    tie_embeddings=False,
    vocab_pad_to=16,
))
