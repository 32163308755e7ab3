"""The layer stack (port of ``repro/models/transformer.py`` for ATTN/LOCAL
stacks and the zamba2 hybrid).  The reference lowers the stack as a
``lax.scan`` over stacked periods; here it is a plain loop over the prologue
layers, then over the period layers, period layer ``j`` being slot
``j % period_len`` of period ``j // period_len``.  A SHARED_ATTN slot holds
the one shared block object itself, so all its layers use one set of
weights."""
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
                paged_view=None):
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
                paged_view=None):
        if cache is not None:
            raise NotImplementedError(
                "MAMBA layers run without a cache only; the cached zamba2 "
                "path is not ported yet (ROADMAP, modules to port: items 7 "
                "and 9)")
        y, _ = self.mamba(cfg, rmsnorm(x, self.ln1, cfg.norm_eps))
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
                  cache_index=None, paged_view=None):
    """Run every layer in order (prologue first); ``caches`` is one pool
    entry per layer."""
    for l, block in enumerate(layers):
        x = block(cfg, x, positions,
                  cache=caches[l] if caches is not None else None,
                  cache_index=cache_index, paged_view=paged_view)
    return x
