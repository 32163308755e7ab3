"""The layer stack (port of ``repro/models/transformer.py`` for ATTN/LOCAL
stacks).  The reference lowers the stack as a ``lax.scan`` over stacked
periods; here it is a plain loop over ``num_layers`` blocks, layer ``l``
being slot ``l % period_len`` of period ``l // period_len``."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, frozen, rmsnorm


class Block(nn.Module):
    """One ATTN/LOCAL layer: pre-norm attention and pre-norm gated MLP."""

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


def stack_forward(layers, cfg, x, positions, *, caches=None,
                  cache_index=None, paged_view=None):
    """Run every block in order; ``caches`` is one pool entry per layer."""
    for l, block in enumerate(layers):
        x = block(cfg, x, positions,
                  cache=caches[l] if caches is not None else None,
                  cache_index=cache_index, paged_view=paged_view)
    return x
