"""The yardstick's arithmetic: the published peaks of one NVIDIA H100 SXM
and the operations and bytes a step needs, counted from shapes alone (the
same whatever implements the work): matrix products on every weight, the
LM head included; causal attention at half the square; recomputation not
counted; each input byte read once and each output byte written once."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, HBM3, and PCIe
# Gen5 x16 in one direction (the host link that cold KV pages cross)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
PEAK_PCIE_BYTES = 64e9


def layer_matmul_params(cfg: dict) -> int:
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    return d * q + 2 * d * kv + q * d + 3 * d * ff


def body_matmul_params(cfg: dict) -> int:
    return cfg["num_hidden_layers"] * layer_matmul_params(cfg)


def head_params(cfg: dict) -> int:
    return cfg["vocab_size"] * cfg["hidden_size"]


def attn_pair_flops(cfg: dict) -> int:
    """FLOPs of one (query, key) pair over every layer: the score and the
    weighted value, 2 * 2 * H * hd a layer."""
    return 4 * cfg["num_attention_heads"] * cfg["head_dim"] * \
        cfg["num_hidden_layers"]


def forward_flops(cfg: dict, tokens: int, pairs: float,
                  head_rows: int = None) -> float:
    """A forward over ``tokens`` rows with ``pairs`` (query, key) pairs in
    all, the head on ``head_rows`` rows (every row by default)."""
    head_rows = tokens if head_rows is None else head_rows
    return 2.0 * (tokens * body_matmul_params(cfg) +
                  head_rows * head_params(cfg)) + pairs * attn_pair_flops(cfg)


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Forward and backward (twice the forward) of B sequences of S, causal
    attention at S^2 / 2 pairs a sequence."""
    return 3.0 * forward_flops(cfg, batch * seq, batch * seq * seq / 2.0)


def decode_step_flops(cfg: dict, lengths) -> float:
    """One token for each slot whose context (the new token included) is
    ``lengths[s]`` tokens long."""
    lengths = list(lengths)
    return forward_flops(cfg, len(lengths), float(sum(lengths)))


def kv_bytes_per_token(cfg: dict, dtype_bytes: int = 2) -> int:
    """K and V of one token in one layer."""
    return 2 * cfg["num_key_value_heads"] * cfg["head_dim"] * dtype_bytes


def paged_decode_bound_s(cfg: dict, hot_tokens, cold_tokens,
                         dtype_bytes: int = 2) -> float:
    """The least time of one layer's paged decode attention (kernel K1) over
    the slots' hot and cold tokens: its hot KV, the queries and the output
    at HBM's rate, its cold KV at the host link's, its FLOPs at the tensor
    cores' peak; the largest of the three (hot and cold take different
    paths)."""
    hot_tokens = list(hot_tokens)
    hot, cold, slots = sum(hot_tokens), sum(cold_tokens), len(hot_tokens)
    kv = kv_bytes_per_token(cfg, dtype_bytes)
    qo = 2 * slots * cfg["num_attention_heads"] * cfg["head_dim"] * \
        dtype_bytes
    flops = 4 * cfg["num_attention_heads"] * cfg["head_dim"] * (hot + cold)
    return max((hot * kv + qo) / PEAK_HBM_BYTES, cold * kv / PEAK_PCIE_BYTES,
               flops / PEAK_BF16_FLOPS)
