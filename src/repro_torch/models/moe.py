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

Under a rank context (``sharding.rank_context``) a rank holding a block of
the experts routes every token as one device does (the router is whole),
fills and runs its own experts' buffers only, and its combine is a partial
sum, all-reduced (reduce-scattered onto the rank's block of the
sequence under Megatron-SP, as the shared MLP's).  Where the experts do not divide over the ranks the
expert hidden dim takes the axis (``sharding_for``, as the reference's
train cell lays the banks out): each rank fills every expert's buffer,
runs its block of the hidden dim, and the combine of its ``wo`` rows is
again a partial sum.  Under grad the dispatched
tokens and the combine weights pass ``sharding.to_split``, since each
rank holds only its share of their gradient, so the replicated
router's gradient comes out whole and the same on every model rank.  A
rank whose batch is one block over the data axes averages the aux's
``frac_tokens`` and ``frac_prob`` over them before their product, as the
reference's means over the global batch; a dispatch group must lie
within one rank's rows.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import MLP, act_fn, frozen
from repro_torch.sharding import (all_reduce_over, current_rank,
                                  rank_block, to_residual, to_split)


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
    ctx = current_rank()
    shards = 1 if ctx is None else ctx.batch_shards
    if shards > 1 and (B * S) % min(m.group_size, B * S * shards):
        raise ValueError(f"a rank's {B * S} tokens do not hold whole "
                         f"dispatch groups of the {B * S * shards}-token "
                         f"batch (group size {m.group_size})")
    gsz, G, C = capacity(cfg, B * S)
    E, K = m.num_experts, m.experts_per_token

    # the experts this rank holds: [e0, e0 + El) (all of them on one
    # device, or where the rank holds a block of every expert's hidden dim)
    El = params.wi.shape[0]
    e0 = rank_block("experts") * El if El < E else 0
    split = El < E or params.wi.shape[2] < m.d_ff

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
    e_flat = idx.reshape(G, gsz * K)
    if El < E:                                 # another rank's experts
        keep = keep & (e_flat >= e0) & (e_flat < e0 + El)

    # dispatch: buffer row (g, e, c) holds the one token kept there, zeros
    # where no token landed; dropped choices write a spare last row, so no
    # step waits on the host to count them
    slot = torch.where(keep, (e_flat - e0) * C + pos, El * C)  # (G, gsz*K)
    g_idx = torch.arange(G, device=x.device)[:, None].expand_as(slot)
    tok = torch.arange(gsz, device=x.device).repeat_interleave(K)
    ex_in = x.new_zeros(G, El * C + 1, d)
    ex_in[g_idx, slot] = (to_split(xt) if split else xt)[:, tok]
    # the buffers are the rank's experts' (the reference's constrain sites
    # at its moe.py:63-87 name that layout)
    ex_in = ex_in[:, :El * C].reshape(G, El, C, d)

    h = act_fn(act)(torch.einsum("gecd,edf->gecf", ex_in, params.wg)) * \
        torch.einsum("gecd,edf->gecf", ex_in, params.wi)
    ex_out = torch.einsum("gecf,efd->gecd", h, params.wo).reshape(G, El * C, d)

    # combine: each kept choice's expert output at its weight (cast to the
    # activation dtype, as the reference's), summed over the k choices in
    # float32 and rounded once
    if split:
        weights = to_split(weights)
    w = weights.to(x.dtype).reshape(G, gsz * K) * keep
    picked = ex_out[g_idx, slot.clamp(max=El * C - 1)].float() * \
        w.float()[..., None]
    out = picked.reshape(G, gsz, K, d).sum(dim=2).to(x.dtype) \
        .reshape(B, S, d)
    out = to_residual(out, partial=split)
    if params.shared is not None:
        out = out + params.shared(x, act)

    # Switch-style load-balance aux: E * sum(frac_tokens_e * frac_prob_e),
    # every choice counted, dropped or not
    frac_tokens = onehot.float().mean(dim=(0, 1))
    frac_prob = gates.mean(dim=(0, 1))
    if shards > 1:
        # every data rank's loss holds the product of the global means:
        # the all-reduce's backward sums their gradients
        frac_tokens, frac_prob = (all_reduce_over(
            torch.stack([frac_tokens, frac_prob]), ctx.batch_axes,
            grad="sum") / shards).unbind(0)
    aux = E * (frac_tokens * frac_prob).sum() * m.router_aux_weight
    return out, aux
