"""Mamba2 (SSD) block, zamba2's backbone mixer (port of
``repro/models/ssm.py``): the cache-free forward, the cached prefill (the
scan starts from the cache's state) and the single-token decode.

State per layer: {"h": (B, H, P, N) float32 SSM state, "conv": (B, K-1,
d_conv) the conv's left context}, d_conv = d_inner + 2N.  Weights keep the
reference's names and (d_in, d_out) orientation: ``w_in`` emits
[z (d_inner) | xBC (d_conv) | dt (H)], and the depthwise causal conv runs
over the x, B and C channels.

Under a rank context every ``ssm_heads`` dim is cut into contiguous
blocks, and those of ``w_in``'s columns, ``conv_w``/``conv_b`` and the
conv cache do not follow the heads (zamba2-7b's 14,576 columns of ``w_in``
split at 7,288 over two ranks: rank 0 holds z and 120 x channels).  So
the rank's block of ``x @ w_in`` is gathered whole over ``model``, and so
are the conv's weights (and the conv cache in a decode); the rank takes
its heads' z, x and dt and the shared B and C, runs the conv on those
channels and the SSD scan (``ops.ssd``, K4 on a card) on its heads, whose
``A_log``, ``dt_bias``, ``D``, ``norm`` and ``w_out`` rows are its blocks.
The gated RMS norm spans the whole d_inner: its sum of squares is
all-reduced (summed over the ranks backward too).  The output of ``w_out``
is a partial sum, all-reduced (reduce-scattered onto the rank's block of
the sequence under Megatron-SP).  The state it returns is its heads' ``h``
and its block of the conv cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import frozen, rmsnorm
from repro_torch.sharding import (constrain, current_rank, local_shape,
                                  rank_block, to_residual, to_split)

H_AXES = ("batch", "ssm_heads", None, None)      # the cache's state
CONV_AXES = ("batch", None, "ssm_heads")        # the cache's conv tail


def dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = s.num_heads or d_inner // s.head_dim
    return d_inner, H, s.head_dim, s.state_dim, s.conv_kernel


def _w_in_cols(cfg) -> int:
    """``w_in``'s columns: z, the conv's x, B and C, and dt."""
    d_inner, H, P, N, K = dims(cfg)
    return 2 * d_inner + 2 * N + H


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
    """Zero state; under a rank context the rank's blocks of it."""
    d_inner, H, P, N, K = dims(cfg)
    return {"h": torch.zeros(local_shape((batch, H, P, N), H_AXES),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros(local_shape((batch, K - 1, d_inner + 2 * N),
                                            CONV_AXES),
                                dtype=dtype, device=device)}


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
        if current_rank() is not None and (
                self.w_in.shape[1] < _w_in_cols(cfg)
                or self.w_out.shape[0] < dims(cfg)[0]):
            return self._rank_forward(cfg, x, cache, decode)
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

    def _rank_forward(self, cfg, x, cache, decode):
        """``forward`` on the rank's block of the heads (see the module's
        docstring)."""
        B, S, _ = x.shape
        d_inner, H, P, N, K = dims(cfg)
        d_conv = d_inner + 2 * N
        Hl = self.dt_bias.shape[0]
        if Hl == H or self.norm.shape[0] != Hl * P or \
                self.w_out.shape[0] != Hl * P or \
                self.w_in.shape[1] == _w_in_cols(cfg) or \
                self.conv_w.shape[1] == d_conv:
            raise NotImplementedError(
                f"a Mamba block whose leaves the model axis does not all "
                f"split ({H} heads, d_inner {d_inner})")
        h0 = rank_block("ssm_heads") * Hl       # the rank's first head
        c0, c1 = h0 * P, (h0 + Hl) * P          # its z and x channels
        zxd = constrain(to_split(x) @ self.w_in, ("batch", "seq", None),
                        held=("batch", "seq", "ssm_heads"))
        cw = constrain(self.conv_w, (None, None), held=(None, "ssm_heads"))
        cb = constrain(self.conv_b, (None,), held=("ssm_heads",))
        xBC = zxd[..., d_inner:d_inner + d_conv]

        def mine(t):
            """The rank's x channels, then B and C, of a tensor over the
            conv's d_conv channels (its last dim)."""
            return torch.cat([t[..., c0:c1], t[..., d_inner:]], dim=-1)

        tail = None
        if decode:
            tail = cache["conv"]
            if tail.shape[-1] < d_conv:
                tail = constrain(tail, ("batch", None, None),
                                 held=CONV_AXES)
        xc, _ = _causal_conv(mine(xBC), mine(cw), mine(cb),
                             None if tail is None else mine(tail))
        new_tail = None
        if cache is not None:
            # the whole tail, then the rank's block of its channels
            new_tail = torch.cat([xBC.new_zeros(B, K - 1, d_conv)
                                  if tail is None else tail,
                                  xBC[:, -(K - 1):]], dim=1)[:, -(K - 1):]
            if cache["conv"].shape[-1] < d_conv:
                new_tail = constrain(new_tail, CONV_AXES,
                                     held=("batch", None, None))
        xs, Bm, Cm = xc.split([Hl * P, N, N], dim=-1)
        xh = xs.reshape(B, S, Hl, P)          # a strided view, no copy
        dt = zxd[..., d_inner + d_conv + h0:d_inner + d_conv + h0 + Hl]
        dt = F.softplus(dt + self.dt_bias)
        A = -torch.exp(self.A_log.float())
        if decode:
            y, h = kernel_ops.ssd_decode(cache["h"], xh[:, 0], dt[:, 0], A,
                                         Bm[:, 0], Cm[:, 0])
            y = y[:, None]
        else:
            y, h = kernel_ops.ssd(xh, dt, A, Bm, Cm, chunk=cfg.ssm.chunk,
                                  h0=None if cache is None else cache["h"])
        y = y + self.D[None, None, :, None].to(y.dtype) * xh
        # the gated norm over the whole d_inner
        y = rmsnorm(y.reshape(B, S, Hl * P) * F.silu(zxd[..., c0:c1]),
                    self.norm, cfg.norm_eps, plus_one=False, width=d_inner)
        out = to_residual(y @ self.w_out, partial=True)
        return out, {"h": h, "conv": new_tail}
