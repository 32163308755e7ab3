"""Mamba2 (SSD) block, zamba2's backbone mixer, for forwards without a cache
(port of ``repro/models/ssm.py``; the cached prefill and the single-token
decode, ``ssd_decode_ref``, come with the cached zamba2 path).

Weights keep the reference's names and (d_in, d_out) orientation:
``w_in`` emits [z (d_inner) | xBC (d_conv) | dt (H)] with d_conv =
d_inner + 2N, the depthwise causal conv runs over the x, B and C channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import frozen, rmsnorm


def dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = s.num_heads or d_inner // s.head_dim
    return d_inner, H, s.head_dim, s.state_dim, s.conv_kernel


def _causal_conv(x, w, b):
    """x: (B, S, C); w: (K, C) depthwise; a zero left context of K-1."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return F.silu(out + b)


class MambaBlock(nn.Module):
    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        d_inner, H, P, N, K = dims(cfg)
        d_conv = d_inner + 2 * N

        def w(*shape):
            return frozen(torch.empty(*shape, device=device, dtype=dtype))

        self.w_in = w(d, d_inner + d_conv + H)
        self.conv_w, self.conv_b = w(K, d_conv), w(d_conv)
        self.dt_bias, self.A_log, self.D = w(H), w(H), w(H)
        self.norm = w(d_inner)
        self.w_out = w(d_inner, d)

    def ssd_inputs(self, cfg, x):
        """x: (B, S, d) -> the gate z (B, S, d_inner) and the SSD scan's
        inputs (xh (B, S, H, P), dt (B, S, H), A (H,) float32, Bm, Cm
        (B, S, N)), as ``forward`` hands them to ``ops.ssd``."""
        B, S, _ = x.shape
        d_inner, H, P, N, K = dims(cfg)
        d_conv = d_inner + 2 * N
        z, xBC, dt = (x @ self.w_in).split([d_inner, d_conv, H], dim=-1)
        dt = F.softplus(dt + self.dt_bias)                    # (B,S,H)
        A = -torch.exp(self.A_log.float())                    # (H,)
        xBC = _causal_conv(xBC, self.conv_w, self.conv_b)
        xs, Bm, Cm = xBC.split([d_inner, N, N], dim=-1)
        xh = xs.reshape(B, S, H, P)           # a strided view, no copy
        return z, (xh, dt, A, Bm, Cm)

    def forward(self, cfg, x):
        """x: (B, S, d) -> (out (B, S, d), final SSM state (B, H, P, N)
        float32)."""
        z, (xh, dt, A, Bm, Cm) = self.ssd_inputs(cfg, x)
        y, h = kernel_ops.ssd(xh, dt, A, Bm, Cm, chunk=cfg.ssm.chunk)
        y = y + self.D[None, None, :, None].to(y.dtype) * xh
        y = y.reshape(z.shape)
        y = rmsnorm(y * F.silu(z), self.norm, cfg.norm_eps, plus_one=False)
        return y @ self.w_out, h
