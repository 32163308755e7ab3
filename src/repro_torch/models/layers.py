"""Core layers: norms, rotary embeddings, the gated MLP, embeddings, and the
seeded initialisation (port of ``repro/models/layers.py``).

Weights keep the reference's (d_in, d_out) orientation, so a projection is
``x @ w`` in both packages and parameters copy across unchanged.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter for inference: no autograd graph is ever built."""
    return nn.Parameter(t, requires_grad=False)


def rmsnorm(x, w, eps: float = 1e-6):
    """RMS norm with the weight stored as its offset from one (the
    reference's ``plus_one=True``, the form of every norm the port has)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(dt)


def softcap(x, cap: float):
    return cap * torch.tanh(x / cap) if cap else x


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


# ---------------------------------------------------------------- rotary ----

def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (hd/2,)
    ang = positions[..., None].float() * freqs                  # (..., seq, hd/2)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- MLP ----

class MLP(nn.Module):
    """Gated MLP: (act(x @ wg) * (x @ wi)) @ wo."""

    def __init__(self, d_model: int, d_ff: int, *, device, dtype):
        super().__init__()
        self.wi = frozen(torch.empty(d_model, d_ff, device=device, dtype=dtype))
        self.wg = frozen(torch.empty(d_model, d_ff, device=device, dtype=dtype))
        self.wo = frozen(torch.empty(d_ff, d_model, device=device, dtype=dtype))

    def forward(self, x, act: str):
        return (act_fn(act)(x @ self.wg) * (x @ self.wi)) @ self.wo


# ------------------------------------------------------------- embedding ----

def embed(table, tokens):
    """tokens: (B, S) integer ids -> (B, S, d)."""
    return F.embedding(tokens, table)


def unembed(table, x):
    """x: (B, S, d) -> logits (B, S, padded_vocab)."""
    return x @ table.T


# ------------------------------------------------------------------ init ----

_ZERO_INIT = ("ln1", "ln2", "final_norm")     # rmsnorm weights (offset from 1)


@torch.no_grad()
def init_weights(module: nn.Module, cfg, generator: torch.Generator):
    """Fill every parameter in registration order from ``generator``, with
    the reference's initialisers: norms 0, embedding tables N(0, d^-1),
    projections N(0, 1/fan_in)."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _ZERO_INIT:
            p.zero_()
            continue
        scale = cfg.d_model ** -0.5 if leaf in ("table", "head") \
            else 1.0 / math.sqrt(p.shape[0])
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32) * scale)
