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

Under a rank context each block runs on the rank's parameter blocks
(``sharding.shard_params``, cut by ``sharding_for``):

  * mLSTM: ``mlp`` takes the model axis, so ``w_up``, ``w_gate`` and the
    conv split their d_inner channels, and ``wq``, ``wk``, ``wv`` and
    ``w_if`` their rows (``heads`` finds the axis used).  The rank's
    channel block of ``x @ w_up`` runs the depthwise conv on its own
    channels (the conv's channels are ``w_up``'s columns); q, k, v and
    the gates are partial sums.  Where the model axis divides the heads
    each is reduce-scattered onto the rank's heads, whose h block is its
    block of d_inner, aligned with ``norm``, ``z`` and ``w_down``'s rows;
    otherwise each is all-reduced, every rank runs every head, and the
    rank takes its block of h (through ``to_split``, so the recurrence's
    gradient is the whole one on every rank).  The norm's sum of squares
    is all-reduced (summed backward too), and ``w_down``'s output is a
    partial sum, all-reduced (reduce-scattered onto the rank's block of
    the sequence under Megatron-SP).  State: the rank's heads (or every head),
    its conv channels.
  * sLSTM: ``w_ifzo``'s columns, laid out (H, 4, D), split.  The conv's
    weights are gathered and it runs whole; where the model axis divides
    the heads a column block is the rank's heads' gates, its heads run
    the recurrence (``r_ifzo`` is its block) and h is gathered; otherwise
    a block falls inside a head, so the pre-activations are gathered and
    every rank runs every head.  The norm and ``w_out`` (whole on the
    model axis) then run whole on every rank.  State: the rank's heads
    (or every head), its conv channels.
  * LSTM: ``w`` and ``b`` split the columns [i | f | g | o], which cut
    the gates of every unit, so both are gathered once a call and the
    recurrence runs whole on every rank.

A gather that feeds a computation every rank runs whole has the rank's
block of the gradient as its backward (``all_gather(grad="split")``):
every rank's gradient there is already the whole one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import step_loop
from repro_torch.models.layers import frozen, rmsnorm
from repro_torch.models.ssm import _causal_conv
from repro_torch.sharding import (all_gather_over, all_reduce_over,
                                  local_shape, rank_block,
                                  reduce_scatter_over, to_residual, to_split)

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


# the logical axes of each cache leaf (the reference's tuple members')
MLSTM_AXES = {"C": ("batch", "heads", None, None),
              "n": ("batch", "heads", None), "m": ("batch", "heads"),
              "conv": ("batch", None, "mlp")}
SLSTM_AXES = {"c": ("batch", "heads", None), "n": ("batch", "heads", None),
              "m": ("batch", "heads", None), "h": ("batch", "heads", None),
              "conv": ("batch", None, "mlp")}
LSTM_AXES = {"h": ("batch", "embed"), "c": ("batch", "embed")}
MODEL = ("model",)


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
        ``decode`` continues the conv from ``cache["conv"]``.  Under a
        rank context whose ``w_up`` is a block of d_inner's channels, on
        that block (see the module's docstring)."""
        B, S, _ = x.shape
        d_inner, H, dk, dv = mlstm_dims(cfg)
        Dl = self.w_up.shape[1]                 # the rank's channels
        split = Dl < d_inner
        n = d_inner // Dl
        own = H % n == 0                        # the rank's heads alone
        Hl = H // n if own else H
        if split:
            x = to_split(x)
        xm = x @ self.w_up
        z = x @ self.w_gate
        tail = cache["conv"] if cache is not None and decode else None
        xc, tail = _causal_conv(xm, self.conv_w, self.conv_b, tail)

        def heads(t):
            """A partial sum over d_inner, its last dim over the heads:
            the rank's heads' block of the sum, or the whole sum."""
            if not split:
                return t
            return reduce_scatter_over(t, MODEL, -1) if own else \
                all_reduce_over(t, MODEL)

        q = heads(xc @ self.wq).reshape(B, S, Hl, dk)
        k = heads(xc @ self.wk).reshape(B, S, Hl, dk)
        v = heads(xm @ self.wv).reshape(B, S, Hl, dv)
        # w_if's columns are [i for H heads | f for H heads]
        gates = heads((xc @ self.w_if).reshape(B, S, 2, H)).float()
        log_i, log_f = gates[..., 0, :], F.logsigmoid(gates[..., 1, :])
        state = None if cache is None else (cache["C"], cache["n"],
                                            cache["m"])
        h, (C, n_, m) = kernel_ops.mlstm(q, k, v, log_i, log_f, state=state)
        h = h.reshape(B, S, Hl * dv)
        if split and not own:
            h = to_split(h).narrow(-1, rank_block("mlp") * Dl, Dl)
        h = rmsnorm(h, self.norm, cfg.norm_eps, plus_one=False,
                    width=d_inner)
        out = to_residual((h * F.silu(z)) @ self.w_down, partial=split)
        return out, {"C": C, "n": n_, "m": m, "conv": tail}


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
        """Under a rank context whose ``w_ifzo`` is a block of its
        columns, on that block (see the module's docstring)."""
        B, S, d = x.shape
        H, D = slstm_dims(cfg)
        if self.w_ifzo.shape[1] < 4 * d:
            x = to_split(x)
        # the conv's weights whole: xc feeds the rank's columns only, so
        # its gradient is a partial sum, which the gathers' backward sums
        cw, cb = self.conv_w, self.conv_b
        if cb.shape[0] < d:
            cw = all_gather_over(cw, MODEL, 1)
            cb = all_gather_over(cb, MODEL, 0)
        cut_tail = cache is not None and cache["conv"].shape[-1] < d
        tail = cache["conv"] if cache is not None and decode else None
        if tail is not None and cut_tail:
            tail = all_gather_over(tail, MODEL, -1)
        xc, tail = _causal_conv(x, cw, cb, tail)
        if cut_tail:
            c = cache["conv"].shape[-1]
            tail = tail.narrow(-1, rank_block("mlp") * c, c).contiguous()
        pre = xc @ self.w_ifzo
        Hl = self.r_ifzo.shape[0]
        state = None if cache is None else tuple(
            cache[k] for k in ("c", "n", "m", "h"))
        if Hl < H:
            # the rank's columns are its heads' four gates
            h, (c, n, m, hl) = kernel_ops.slstm(
                pre.reshape(B, S, Hl, 4, D), state=state, r_ifzo=self.r_ifzo)
            h = all_gather_over(h.reshape(B, S, Hl * D), MODEL, -1,
                                grad="split")
        else:
            if pre.shape[-1] < 4 * d:
                # the columns cut a head: every head on every rank
                pre = all_gather_over(pre, MODEL, -1, grad="split")
            h, (c, n, m, hl) = kernel_ops.slstm(
                pre.reshape(B, S, H, 4, D), state=state, r_ifzo=self.r_ifzo)
            h = h.reshape(B, S, d)
        norm = self.norm
        if norm.shape[0] < d:
            norm = all_gather_over(norm, MODEL, 0, grad="split")
        out = rmsnorm(h, norm, cfg.norm_eps, plus_one=False) @ self.w_out
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
        B, S, d = x.shape
        w, b = self.w, self.b
        if b.shape[0] < 4 * d:
            # the rank's columns cut every unit's gates: both whole, and
            # the recurrence whole on every rank
            w = all_gather_over(w, MODEL, 1, grad="split")
            b = all_gather_over(b, MODEL, 0, grad="split")
        if cache is not None:
            h, c = cache["h"], cache["c"]
        else:
            h = x.new_zeros(B, d)
            c = torch.zeros(B, d, dtype=torch.float32, device=x.device)

        def step(t, carry, xt, consts):
            h, c = carry
            w, b = consts
            gates = torch.cat([xt[0], h], dim=-1) @ w + b
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f).float() * c + \
                (torch.sigmoid(i) * torch.tanh(g)).float()
            h = torch.sigmoid(o) * torch.tanh(c).to(x.dtype)
            return (h, c), h

        (h, c), hs = step_loop(step, (h, c), (x.transpose(0, 1),), S,
                               (w, b))
        return torch.stack(hs, dim=1), {"h": h, "c": c}


def _zeros(shape, axes, **kw):
    """Zeros of ``shape``, the rank's block of it under a rank context."""
    return torch.zeros(local_shape(shape, axes), **kw)


def init_mlstm_cache(cfg, batch: int, dtype, device) -> dict:
    d_inner, H, dk, dv = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    a = MLSTM_AXES
    return {"C": _zeros((batch, H, dk, dv), a["C"], **f32),
            "n": _zeros((batch, H, dk), a["n"], **f32),
            "m": _zeros((batch, H), a["m"], **f32).fill_(float("-inf")),
            "conv": _zeros((batch, CONV_K - 1, d_inner), a["conv"],
                           dtype=dtype, device=device)}


def init_slstm_cache(cfg, batch: int, dtype, device) -> dict:
    H, D = slstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    a = SLSTM_AXES
    state = {k: _zeros((batch, H, D), a[k], **f32) for k in "cnmh"}
    state["m"].fill_(float("-inf"))
    state["conv"] = _zeros((batch, CONV_K - 1, cfg.d_model), a["conv"],
                           dtype=dtype, device=device)
    return state


def init_lstm_cache(cfg, batch: int, dtype, device) -> dict:
    a = LSTM_AXES
    return {"h": _zeros((batch, cfg.d_model), a["h"], dtype=dtype,
                        device=device),
            "c": _zeros((batch, cfg.d_model), a["c"], dtype=torch.float32,
                        device=device)}
