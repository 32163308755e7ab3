"""Kernel dispatch by the device of the input (the query for attention, x
for the SSD scan): the plain PyTorch version (kernels/ref.py) for a CPU
tensor, the hand-written CUDA kernel for a CUDA tensor.  There is no switch
and no fallback: a CUDA input runs the kernel or raises."""
from __future__ import annotations

from repro_torch.kernels import paged_decode as _pd
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd


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


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 256, h0=None):
    """Mamba2 SSD chunked scan: x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm
    (B,S,N), optional start state h0 (B,H,P,N).  Returns (y (B,S,H,P) in
    x's dtype, final state (B,H,P,N) float32).  A CUDA x runs the kernel,
    with or without h0."""
    fn = _ssd.ssd if x.is_cuda else _ref.ssd_chunked_ref
    return fn(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
