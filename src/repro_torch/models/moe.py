"""Mixture-of-Experts: a top-k router and grouped, capacity-bounded
dispatch and combine (port of ``repro/models/moe.py``).

Tokens are split into groups of ``group_size``; in each group an expert
takes at most C = max(k, int(capacity_factor * group_size * k / E))
tokens, in the order of the token-major, k-minor flattening, and a choice
past its expert's capacity is dropped.  The reference dispatches and
combines through one-hot einsums; here the same selection is a gather into
the (G, E, C, d) expert buffers and a weighted gather back, which give the
same kept tokens, drops and combine weights.  Shared experts (DeepSeek) run
as one dense MLP on every token.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import MLP, act_fn, frozen


class MoE(nn.Module):
    """The router (d, E), the expert banks ``wi``/``wg`` (E, d, F) and
    ``wo`` (E, F, d), and the optional shared MLP of width
    F x num_shared_experts, named as the reference's tree."""
    AXES = {"router": ("embed", None),
            "wi": ("experts", "embed", "expert_mlp"),
            "wg": ("experts", "embed", "expert_mlp"),
            "wo": ("experts", "expert_mlp", "embed")}

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        m, d = cfg.moe, cfg.d_model
        E, F = m.num_experts, m.d_ff

        def w(*shape):
            return frozen(torch.empty(*shape, device=device, dtype=dtype))

        self.router = w(d, E)
        self.wi, self.wg, self.wo = w(E, d, F), w(E, d, F), w(E, F, d)
        self.shared = MLP(d, F * m.num_shared_experts, device=device,
                          dtype=dtype) if m.num_shared_experts else None

    def forward(self, cfg, x, act: str):
        return moe_mlp(self, cfg, x, act)


def route_topk(logits, k: int):
    """(weights (..., k) softmaxed over the chosen k, indices (..., k)).
    Ties keep the lower expert index first, as ``jax.lax.top_k`` does
    (``torch.topk`` does not promise it): a stable descending sort."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[..., :k], dim=-1), idx[..., :k]


def capacity(cfg, tokens: int) -> tuple:
    """(group size, groups, capacity C) for ``tokens`` tokens, with the
    reference's assertion when the tokens do not fill whole groups."""
    m = cfg.moe
    gsz = min(m.group_size, tokens)
    assert tokens % gsz == 0, \
        f"tokens {tokens} not divisible by moe group size {gsz}"
    C = max(m.experts_per_token,
            int(m.capacity_factor * gsz * m.experts_per_token
                / m.num_experts))
    return gsz, tokens // gsz, C


def moe_mlp(params, cfg, x, act: str):
    """x: (B, S, d) -> (out (B, S, d), aux loss, a float32 scalar)."""
    m = cfg.moe
    B, S, d = x.shape
    gsz, G, C = capacity(cfg, B * S)
    E, K = m.num_experts, m.experts_per_token

    xt = x.reshape(G, gsz, d)
    # the router's logits in the activation dtype, then float32
    logits = (xt @ params.router).float()                      # (G, gsz, E)
    gates = torch.softmax(logits, dim=-1)
    weights, idx = route_topk(logits, K)                       # (G, gsz, K)

    # each choice's position in its expert's buffer: the choices before it
    # in the token-major, k-minor order that went to the same expert
    onehot = nn.functional.one_hot(idx, E).reshape(G, gsz * K, E)
    pos = ((onehot.cumsum(dim=1) - onehot) * onehot).sum(-1)   # (G, gsz*K)
    keep = pos < C

    # dispatch: buffer row (g, e, c) holds the one token kept there, zeros
    # where no token landed; dropped choices write a spare last row, so no
    # step waits on the host to count them
    e_flat = idx.reshape(G, gsz * K)
    slot = torch.where(keep, e_flat * C + pos, E * C)          # (G, gsz*K)
    g_idx = torch.arange(G, device=x.device)[:, None].expand_as(slot)
    tok = torch.arange(gsz, device=x.device).repeat_interleave(K)
    ex_in = x.new_zeros(G, E * C + 1, d)
    ex_in[g_idx, slot] = xt[:, tok]
    ex_in = ex_in[:, :E * C].reshape(G, E, C, d)

    h = act_fn(act)(torch.einsum("gecd,edf->gecf", ex_in, params.wg)) * \
        torch.einsum("gecd,edf->gecf", ex_in, params.wi)
    ex_out = torch.einsum("gecf,efd->gecd", h, params.wo).reshape(G, E * C, d)

    # combine: each kept choice's expert output at its weight (cast to the
    # activation dtype, as the reference's), summed over the k choices in
    # float32 and rounded once
    w = weights.to(x.dtype).reshape(G, gsz * K) * keep
    picked = ex_out[g_idx, slot.clamp(max=E * C - 1)].float() * \
        w.float()[..., None]
    out = picked.reshape(G, gsz, K, d).sum(dim=2).to(x.dtype) \
        .reshape(B, S, d)
    if params.shared is not None:
        out = out + params.shared(x, act)

    # Switch-style load-balance aux: E * sum(frac_tokens_e * frac_prob_e),
    # every choice counted, dropped or not
    frac_tokens = onehot.float().mean(dim=(0, 1))
    frac_prob = gates.mean(dim=(0, 1))
    aux = E * (frac_tokens * frac_prob).sum() * m.router_aux_weight
    return out, aux
