"""The layer stack (port of ``repro/models/transformer.py`` for ATTN/LOCAL
stacks and the zamba2 hybrid).  The reference lowers the stack as a
``lax.scan`` over stacked periods; here it is a plain loop over the prologue
layers, then over the period layers, period layer ``j`` being slot
``j % period_len`` of period ``j // period_len``.  A SHARED_ATTN slot holds
the one shared block object itself, so all its layers use one set of
weights.  Caches are one entry per layer: attention layers write theirs in
place; a MAMBA layer's new state replaces the entries of its cache dict."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ATTN, MAMBA, SHARED_ATTN
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, frozen, rmsnorm
from repro_torch.models.ssm import MambaBlock


class Block(nn.Module):
    """One ATTN/LOCAL layer (and zamba2's shared block, with kind ATTN):
    pre-norm attention and pre-norm gated MLP."""

    def __init__(self, cfg, kind: str, *, device, dtype):
        super().__init__()
        self.kind = kind
        self.ln1 = frozen(torch.empty(cfg.d_model, device=device, dtype=dtype))
        self.attn = Attention(cfg, device=device, dtype=dtype)
        self.ln2 = frozen(torch.empty(cfg.d_model, device=device, dtype=dtype))
        self.mlp = MLP(cfg.d_model, cfg.d_ff, device=device, dtype=dtype)

    def forward(self, cfg, x, positions, *, cache=None, cache_index=None,
                decode=False, paged_view=None):
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        x = x + self.attn(cfg, h, positions, kind=self.kind, cache=cache,
                          cache_index=cache_index, paged_view=paged_view)
        h = rmsnorm(x, self.ln2, cfg.norm_eps)
        return x + self.mlp(h, cfg.act)


class MambaLayer(nn.Module):
    """One MAMBA layer: pre-norm Mamba2 block and the residual."""

    kind = MAMBA

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        self.ln1 = frozen(torch.empty(cfg.d_model, device=device, dtype=dtype))
        self.mamba = MambaBlock(cfg, device=device, dtype=dtype)

    def forward(self, cfg, x, positions, *, cache=None, cache_index=None,
                decode=False, paged_view=None):
        """With a cache {"h", "conv"}: a prefill scans from its state, a
        decode steps it; either way the new state replaces the dict's
        entries (the rows of every slot, active or not, as the reference's
        lockstep decode does)."""
        y, state = self.mamba(cfg, rmsnorm(x, self.ln1, cfg.norm_eps),
                              cache=cache, decode=decode)
        if cache is not None:
            cache.update(state)
        return x + y


def make_layer(cfg, kind: str, *, device, dtype):
    """A new layer of ``kind``; SHARED_ATTN builds zamba2's shared block
    (full causal attention and a d_ff MLP), which the model builds once."""
    if kind == MAMBA:
        return MambaLayer(cfg, device=device, dtype=dtype)
    if kind == SHARED_ATTN:
        return Block(cfg, ATTN, device=device, dtype=dtype)
    return Block(cfg, kind, device=device, dtype=dtype)


def stack_forward(layers, cfg, x, positions, *, caches=None,
                  cache_index=None, decode=False, paged_view=None):
    """Run every layer in order (prologue first); ``caches`` is one cache
    entry per layer (a dense cache, or ``PagedKVPools.tree``), updated in
    place."""
    for l, block in enumerate(layers):
        x = block(cfg, x, positions,
                  cache=caches[l] if caches is not None else None,
                  cache_index=cache_index, decode=decode,
                  paged_view=paged_view)
    return x
