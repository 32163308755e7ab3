"""Mamba2 (SSD) block, zamba2's backbone mixer (port of
``repro/models/ssm.py``): the cache-free forward, the cached prefill (the
scan starts from the cache's state) and the single-token decode.

State per layer: {"h": (B, H, P, N) float32 SSM state, "conv": (B, K-1,
d_conv) the conv's left context}, d_conv = d_inner + 2N.  Weights keep the
reference's names and (d_in, d_out) orientation: ``w_in`` emits
[z (d_inner) | xBC (d_conv) | dt (H)], and the depthwise causal conv runs
over the x, B and C channels.
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


def _causal_conv(x, w, b, tail=None):
    """x: (B, S, C); w: (K, C) depthwise; tail: (B, K-1, C) left context
    (zeros when None).  Returns (silu(conv + b), the new tail: the last K-1
    rows of the context and x, a copy that holds no more of them)."""
    K = w.shape[0]
    if tail is None:
        tail = x.new_zeros(x.shape[0], K - 1, x.shape[-1])
    xp = torch.cat([tail, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return F.silu(out + b), xp[:, -(K - 1):].clone()


def init_mamba_cache(cfg, batch: int, dtype, device) -> dict:
    d_inner, H, P, N, K = dims(cfg)
    return {"h": torch.zeros(batch, H, P, N, dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(batch, K - 1, d_inner + 2 * N, dtype=dtype,
                                device=device)}


class MambaBlock(nn.Module):
    AXES = {"w_in": ("embed", "ssm_heads"), "conv_w": (None, "ssm_heads"),
            "conv_b": ("ssm_heads",), "dt_bias": ("ssm_heads",),
            "A_log": ("ssm_heads",), "D": ("ssm_heads",),
            "norm": ("ssm_heads",), "w_out": ("ssm_heads", "embed")}
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

    def ssd_inputs(self, cfg, x, tail=None):
        """x: (B, S, d) -> the gate z (B, S, d_inner), the SSD scan's inputs
        (xh (B, S, H, P), dt (B, S, H), A (H,) float32, Bm, Cm (B, S, N)),
        as ``forward`` hands them to ``ops.ssd``, and the conv's new tail."""
        B, S, _ = x.shape
        d_inner, H, P, N, K = dims(cfg)
        d_conv = d_inner + 2 * N
        z, xBC, dt = (x @ self.w_in).split([d_inner, d_conv, H], dim=-1)
        dt = F.softplus(dt + self.dt_bias)                    # (B,S,H)
        A = -torch.exp(self.A_log.float())                    # (H,)
        xBC, tail = _causal_conv(xBC, self.conv_w, self.conv_b, tail)
        xs, Bm, Cm = xBC.split([d_inner, N, N], dim=-1)
        xh = xs.reshape(B, S, H, P)           # a strided view, no copy
        return z, (xh, dt, A, Bm, Cm), tail

    def forward(self, cfg, x, cache=None, decode: bool = False):
        """x: (B, S, d) -> (out (B, S, d), the new state {"h", "conv"}).

        Without a cache the scan starts from zero.  With one, a prefill
        starts the scan from ``cache["h"]`` (the conv's left context is
        zero, as the reference's); ``decode`` (S == 1) continues the conv
        from ``cache["conv"]`` and steps the state with ``ops.ssd_decode``.
        """
        if decode and (cache is None or x.shape[1] != 1):
            raise ValueError("Mamba decode takes one token and a cache")
        z, (xh, dt, A, Bm, Cm), tail = self.ssd_inputs(
            cfg, x, cache["conv"] if decode else None)
        if decode:
            y, h = kernel_ops.ssd_decode(cache["h"], xh[:, 0], dt[:, 0], A,
                                         Bm[:, 0], Cm[:, 0])
            y = y[:, None]
        else:
            y, h = kernel_ops.ssd(xh, dt, A, Bm, Cm, chunk=cfg.ssm.chunk,
                                  h0=None if cache is None else cache["h"])
        y = y + self.D[None, None, :, None].to(y.dtype) * xh
        y = y.reshape(z.shape)
        y = rmsnorm(y * F.silu(z), self.norm, cfg.norm_eps, plus_one=False)
        return y @ self.w_out, {"h": h, "conv": tail}
