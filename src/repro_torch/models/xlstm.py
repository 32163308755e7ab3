"""xLSTM blocks, mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory, a true recurrence), per xLSTM [arXiv:2405.04517], and the classic
LSTM of the paper's PTB model (port of ``repro/models/xlstm.py``).

The blocks carry their own up and down projections (xlstm-1.3b's d_ff is
0: there is no separate MLP).  Each takes x (B, S, d) and an optional
cache and returns (out, the new state); the layer that holds the block
(``transformer.StateLayer``) writes the state into its cache dict.  The
state is float32 where the reference keeps it so, and flat dict leaves
here where the reference holds a tuple: mLSTM {"C" (B,H,Dk,Dv), "n"
(B,H,Dk), "m" (B,H), "conv" (B,3,d_inner)}, sLSTM {"c", "n", "m", "h"
(B,H,D), "conv" (B,3,d)}, LSTM {"h" (B,d) in the activation dtype, "c"
(B,d)}.  m starts at -inf (the stabilizer's empty state).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import frozen, rmsnorm
from repro_torch.models.ssm import _causal_conv
from repro_torch.sharding import refuse_partitioned

CONV_K = 4
PROJ = 2          # mLSTM up-projection factor
QK_FACTOR = 2     # qk dim = d_inner // QK_FACTOR (official qk_dim_factor=0.5)


def mlstm_dims(cfg):
    """(d_inner, heads, qk head dim, v head dim) of an mLSTM block."""
    d_inner = PROJ * cfg.d_model
    H = cfg.num_heads
    return d_inner, H, d_inner // QK_FACTOR // H, d_inner // H


def slstm_dims(cfg):
    """(heads, head dim) of an sLSTM block."""
    return cfg.num_heads, cfg.d_model // cfg.num_heads


def _weights(device, dtype):
    return lambda *shape: frozen(torch.empty(*shape, device=device,
                                             dtype=dtype))


class MLSTMBlock(nn.Module):
    AXES = {"w_up": ("embed", "mlp"), "w_gate": ("embed", "mlp"),
            "conv_w": (None, "mlp"), "conv_b": ("mlp",),
            "wq": ("mlp", "heads"), "wk": ("mlp", "heads"),
            "wv": ("mlp", "heads"), "w_if": ("mlp", None), "norm": ("mlp",),
            "w_down": ("mlp", "embed")}
    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        d_inner, H, dk, dv = mlstm_dims(cfg)
        w = _weights(device, dtype)
        self.w_up, self.w_gate = w(d, d_inner), w(d, d_inner)
        self.conv_w, self.conv_b = w(CONV_K, d_inner), w(d_inner)
        self.wq, self.wk = w(d_inner, H * dk), w(d_inner, H * dk)
        self.wv = w(d_inner, H * dv)
        self.w_if = w(d_inner, 2 * H)
        self.norm = w(d_inner)
        self.w_down = w(d_inner, d)

    def forward(self, cfg, x, cache=None, decode: bool = False):
        """A prefill or forward starts the conv from zeros and the
        recurrence from the cache's state (the empty state without one);
        ``decode`` continues the conv from ``cache["conv"]``."""
        refuse_partitioned("an mLSTM block")
        B, S, _ = x.shape
        d_inner, H, dk, dv = mlstm_dims(cfg)
        xm = x @ self.w_up
        z = x @ self.w_gate
        tail = cache["conv"] if cache is not None and decode else None
        xc, tail = _causal_conv(xm, self.conv_w, self.conv_b, tail)
        q = (xc @ self.wq).reshape(B, S, H, dk)
        k = (xc @ self.wk).reshape(B, S, H, dk)
        v = (xm @ self.wv).reshape(B, S, H, dv)
        gates = (xc @ self.w_if).float()
        log_i, log_f = gates[..., :H], F.logsigmoid(gates[..., H:])
        state = None if cache is None else (cache["C"], cache["n"],
                                            cache["m"])
        h, (C, n, m) = kernel_ops.mlstm(q, k, v, log_i, log_f, state=state)
        h = rmsnorm(h.reshape(B, S, d_inner), self.norm, cfg.norm_eps,
                    plus_one=False)
        out = (h * F.silu(z)) @ self.w_down
        return out, {"C": C, "n": n, "m": m, "conv": tail}


class SLSTMBlock(nn.Module):
    AXES = {"conv_w": (None, "mlp"), "conv_b": ("mlp",),
            "w_ifzo": ("embed", "heads"), "r_ifzo": ("heads", None, None, None),
            "norm": ("mlp",), "w_out": ("embed", "embed")}
    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        H, D = slstm_dims(cfg)
        w = _weights(device, dtype)
        self.conv_w, self.conv_b = w(CONV_K, d), w(d)
        self.w_ifzo = w(d, H * 4 * D)
        self.r_ifzo = w(H, 4, D, D)
        self.norm = w(d)
        self.w_out = w(d, d)

    def forward(self, cfg, x, cache=None, decode: bool = False):
        refuse_partitioned("an sLSTM block")
        B, S, d = x.shape
        H, D = slstm_dims(cfg)
        tail = cache["conv"] if cache is not None and decode else None
        xc, tail = _causal_conv(x, self.conv_w, self.conv_b, tail)
        pre = (xc @ self.w_ifzo).reshape(B, S, H, 4, D)
        state = None if cache is None else tuple(
            cache[k] for k in ("c", "n", "m", "h"))
        h, (c, n, m, hl) = kernel_ops.slstm(pre, state=state,
                                            r_ifzo=self.r_ifzo)
        out = rmsnorm(h.reshape(B, S, d), self.norm, cfg.norm_eps,
                      plus_one=False) @ self.w_out
        return out, {"c": c, "n": n, "m": m, "h": hl, "conv": tail}


class LSTMBlock(nn.Module):
    AXES = {"w": ("embed", "heads"), "b": ("heads",)}
    """The classic LSTM of the paper's PTB model: one gate matrix ``w``
    (2d, 4d) over [x_t, h_{t-1}] and its bias ``b``; h in the activation
    dtype, c in float32, cast where the reference casts them."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        w = _weights(device, dtype)
        self.w, self.b = w(2 * d, 4 * d), w(4 * d)

    def forward(self, cfg, x, cache=None, decode: bool = False):
        refuse_partitioned("an LSTM block")
        B, S, d = x.shape
        if cache is not None:
            h, c = cache["h"], cache["c"]
        else:
            h = x.new_zeros(B, d)
            c = torch.zeros(B, d, dtype=torch.float32, device=x.device)
        hs = []
        for t in range(S):
            gates = torch.cat([x[:, t], h], dim=-1) @ self.w + self.b
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f).float() * c + \
                (torch.sigmoid(i) * torch.tanh(g)).float()
            h = torch.sigmoid(o) * torch.tanh(c).to(x.dtype)
            hs.append(h)
        return torch.stack(hs, dim=1), {"h": h, "c": c}


def init_mlstm_cache(cfg, batch: int, dtype, device) -> dict:
    d_inner, H, dk, dv = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(batch, H, dk, dv, **f32),
            "n": torch.zeros(batch, H, dk, **f32),
            "m": torch.full((batch, H), float("-inf"), **f32),
            "conv": torch.zeros(batch, CONV_K - 1, d_inner, dtype=dtype,
                                device=device)}


def init_slstm_cache(cfg, batch: int, dtype, device) -> dict:
    H, D = slstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(batch, H, D, **f32),
            "n": torch.zeros(batch, H, D, **f32),
            "m": torch.full((batch, H, D), float("-inf"), **f32),
            "h": torch.zeros(batch, H, D, **f32),
            "conv": torch.zeros(batch, CONV_K - 1, cfg.d_model, dtype=dtype,
                                device=device)}


def init_lstm_cache(cfg, batch: int, dtype, device) -> dict:
    return {"h": torch.zeros(batch, cfg.d_model, dtype=dtype, device=device),
            "c": torch.zeros(batch, cfg.d_model, dtype=torch.float32,
                             device=device)}
