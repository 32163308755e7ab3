"""Kernel dispatch by the device of the input (the query for attention, x
for the SSD scan): the plain PyTorch version (kernels/ref.py) for a CPU
tensor, the hand-written CUDA kernel for a CUDA tensor.  There is no switch
and no fallback: a CUDA input runs the kernel or raises.  The signatures
are the reference's (``repro/kernels/ops.py``).  ``ssd_decode``, one
token's state update, and the xLSTM recurrences (``mlstm``, ``slstm``) have
no kernel in either package: they are plain torch on every device."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_decode as _pd
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd


def flash_attention(q, k, v, *, causal=True, window=0, softcap_val=0.0):
    """Flash attention: q (B, Sq, H, D), k and v (B, Skv, KVH, D), queries
    right-aligned to the end of the KV timeline; returns (B, Sq, H, D) in
    q's dtype.  A CUDA q runs K2 (kernels/flash_attention.py), which
    refuses k or v anywhere but on q's card."""
    fn = _fa.flash_attention if q.is_cuda else _ref.attention_ref
    return fn(q, k, v, causal=causal, window=window, softcap_val=softcap_val)


def decode_attention(q, k_cache, v_cache, lengths, *, window=0,
                     softcap_val=0.0):
    """Flash decode of one query token per slot: q (B, H, D) against
    contiguous caches (B, S, KVH, D) holding ``lengths`` (B,) int32 valid
    entries each; returns (B, H, D) in q's dtype.  A CUDA q runs K3
    (kernels/decode_attention.py), which refuses caches or lengths anywhere
    but on q's card."""
    fn = _da.decode_attention if q.is_cuda else _ref.decode_attention_ref
    return fn(q, k_cache, v_cache, lengths, window=window,
              softcap_val=softcap_val)


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
    with or without h0.  The kernel takes whole chunks (S a multiple of
    min(chunk, S)), so a ragged S is padded here, on every device, with
    dt = 0, which leaves the state as it is (decay 1, no input), and y is
    cut back to S.  Differentiable on every device: the CPU (and the meta
    device a profile traces on) runs the plain version under autograd; a
    CUDA x runs the kernel forward and the plain version's backward
    (kernels/ssd.py)."""
    S = x.shape[1]
    pad = (-S) % min(chunk, S)
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    fn = _ssd.ssd if x.is_cuda else _ref.ssd_chunked_ref
    y, h = fn(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    return (y[:, :S] if pad else y), h


ssd_decode = _ref.ssd_decode_ref     # one token: plain torch is the op
slstm = _ref.slstm_ref

# the mLSTM's execution mode: 0 = the sequential scan, N = chunkwise-parallel
# with chunks of N tokens (``mlstm_chunk_mode``)
_MLSTM = {"chunk": 0}


def mlstm_chunk_mode(chunk: int):
    """Run ``mlstm`` chunkwise-parallel with chunks of ``chunk`` tokens
    where a sequence is whole chunks of it (0: always sequential)."""
    _MLSTM["chunk"] = int(chunk)


def mlstm(q, k, v, log_i, log_f, *, state=None):
    """The stabilized mLSTM (``ref.mlstm_ref``'s I/O): chunkwise-parallel
    when a chunk mode is set, S > 1 and S is whole chunks, else the
    sequential scan, as the reference selects."""
    c = _MLSTM["chunk"]
    if c and q.shape[1] > 1 and q.shape[1] % c == 0:
        return _ref.mlstm_chunked_ref(q, k, v, log_i, log_f, chunk=c,
                                      state=state)
    return _ref.mlstm_ref(q, k, v, log_i, log_f, state=state)
