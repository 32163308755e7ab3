"""Kernel dispatch by the device of the query: the plain PyTorch version
(kernels/ref.py) for a CPU query, the hand-written CUDA kernel for a CUDA
query.  There is no switch and no fallback: a CUDA query runs the kernel or
raises."""
from __future__ import annotations

from repro_torch.kernels import paged_decode as _pd
from repro_torch.kernels import ref as _ref


def paged_decode_attention(q, k_hot, v_hot, k_cold, v_cold, page_table,
                           page_tier, lengths, *, window=0, softcap_val=0.0):
    """Flash-decode over paged, tiered KV pools (hot = device, cold = host).
    See kernels/paged_decode.py for the layout.  The pools may be larger
    than the table addresses (the engine's pools carry free pages and a
    trailing garbage page); only pages the table maps for each slot's
    length are visited.  On a CUDA query the cold pools must be pinned host
    tensors."""
    fn = _pd.paged_decode_attention if q.is_cuda \
        else _ref.paged_decode_attention_ref
    return fn(q, k_hot, v_hot, k_cold, v_cold, page_table, page_tier,
              lengths, window=window, softcap_val=softcap_val)
