"""Core layers: norms, rotary embeddings, the gated MLP, embeddings, and the
seeded initialisation (port of ``repro/models/layers.py``).

Weights keep the reference's (d_in, d_out) orientation, so a projection is
``x @ w`` in both packages and parameters copy across unchanged.

Under a rank context (``sharding.rank_context``) the MLP and the
embeddings run on the rank's parameter blocks: the MLP column-parallel in
and row-parallel out (its output a partial sum, all-reduced, or under
Megatron-SP reduce-scattered onto the rank's block of the sequence), the
embedding vocab-parallel (a masked lookup, all-reduced or
reduce-scattered likewise), the unembedding leaving the logits
vocab-local, as the reference's ``constrain`` sites
lay them out.  Under grad the replicated input of a split product passes
``sharding.to_split`` (its gradient all-reduced over ``model``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import (all_reduce_over, constrain, rank_block,
                                  seq_whole, to_residual, to_split)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter that takes no gradient until the model is built for
    training (``init_params(requires_grad=True)``): serving builds no
    autograd graph."""
    return nn.Parameter(t, requires_grad=False)


def rmsnorm(x, w, eps: float = 1e-6, plus_one: bool = True,
            width: int = None):
    """RMS norm.  ``plus_one`` (the layer norms): the weight is stored as
    its offset from one; otherwise (the Mamba gate's norm) it scales
    directly, as the reference's ``plus_one=False``.  ``width``: the
    norm's whole width, of which ``x`` and ``w`` may be the rank's block
    on the model axis (a d_inner the model axis splits); then each rank's
    sum of squares is all-reduced over ``model`` and its gradient summed
    back."""
    dt = x.dtype
    x = x.float()
    if width is None or x.shape[-1] == width:
        var = x.square().mean(dim=-1, keepdim=True)
    else:
        var = all_reduce_over(x.square().sum(dim=-1, keepdim=True),
                              ("model",), grad="sum") / width
    y = x * torch.rsqrt(var + eps)
    w = w.float()
    return (y * (1.0 + w) if plus_one else y * w).to(dt)


def pre_norm(x, w, eps: float, rows: int):
    """A pre-norm on the residual stream, its output over the whole
    sequence of ``rows`` rows (the reference's full-sequence constrain at
    each norm).  Under Megatron-SP the rank holds a block of the rows
    (``x.shape[1] < rows``): it normalises its block, its weight through
    ``to_split`` (applied to the rank's tokens alone, its gradient is a
    partial sum over ``model``), and gathers the rows
    (``sharding.seq_whole``)."""
    if x.shape[1] == rows:
        return rmsnorm(x, w, eps)
    return seq_whole(rmsnorm(x, to_split(w), eps), rows)


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
    AXES = {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
            "wo": ("mlp", "embed")}

    def __init__(self, d_model: int, d_ff: int, *, device, dtype):
        super().__init__()
        self.d_ff = d_ff
        self.wi = frozen(torch.empty(d_model, d_ff, device=device, dtype=dtype))
        self.wg = frozen(torch.empty(d_model, d_ff, device=device, dtype=dtype))
        self.wo = frozen(torch.empty(d_ff, d_model, device=device, dtype=dtype))

    def forward(self, x, act: str):
        # h stays the rank's d_ff block (the reference's layers.py:98); its
        # row block of wo then gives a partial sum
        split = self.wo.shape[0] < self.d_ff
        if split:
            x = to_split(x)
        h = act_fn(act)(x @ self.wg) * (x @ self.wi)
        return to_residual(h @ self.wo, partial=split)


# ------------------------------------------------------------- embedding ----

def embed(table, cfg, tokens, *, whole: bool = False):
    """tokens: (B, S) integer ids -> (B, S, d), or (B, S, K) codes of K
    codebooks (musicgen: ``table`` (K, V, d)), whose K rows are summed in
    codebook order, as the reference's Python ``sum``.  With
    ``cfg.scale_embed`` (gemma) the result is scaled by sqrt(d) rounded to
    the table's dtype first, as the reference's ``jnp.asarray(sqrt(d),
    x.dtype)``.  A rank holding a block of the vocab looks up the ids in
    its block, zeros elsewhere, and the ranks' rows are summed (one id's
    row is nonzero on one rank only, so the sum is exact, and each rank's
    block of the table takes the gradient of its own rows only).  The
    rows come in the residual stream's layout (``sharding.to_residual``:
    under Megatron-SP the rank's block of the sequence, reduce-scattered),
    or with ``whole`` over the whole sequence (a prefix is joined before
    it is cut)."""
    V = table.shape[-2]
    split = V < cfg.padded_vocab
    v0 = rank_block("vocab") * V

    def lookup(ids, t):
        if not split:
            return F.embedding(ids, t)
        local = ids - v0
        mine = (local >= 0) & (local < V)
        rows = F.embedding(torch.where(mine, local, 0), t)
        return rows * mine[..., None].to(rows.dtype)

    if cfg.num_codebooks:
        x = lookup(tokens[..., 0], table[0])
        for k in range(1, cfg.num_codebooks):
            x = x + lookup(tokens[..., k], table[k])
    else:
        x = lookup(tokens, table)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if whole:
        return constrain(x, ("batch", "seq", "embed"), partial=split)
    return to_residual(x, partial=split)


def unembed(table, cfg, x):
    """x: (B, S, d) -> logits (B, S, padded_vocab), or (B, S, K,
    padded_vocab) for K codebooks (``table`` (K, V, d)), under the final
    softcap where the config has one (gemma2).  A rank holding a block of
    the vocab gives the logits of its block (the softcap is elementwise)."""
    if table.shape[-2] < cfg.padded_vocab:
        x = to_split(x)
    if cfg.num_codebooks:
        return softcap(torch.einsum("bsd,kvd->bskv", x, table),
                       cfg.final_softcap)
    return softcap(x @ table.T, cfg.final_softcap)


# ---------------------------------------------------------- logical axes ----

def param_axes(module: nn.Module) -> dict:
    """``{name: logical axes}`` for every parameter of ``module``, from the
    ``AXES`` table of the module class that owns it (the reference's
    ``Param`` axes, leaf by leaf; a per-layer leaf has no stacked
    ``layers`` axis).  A leaf with more dims than its entry (musicgen's
    codebook table and head) takes leading ``None``s, as the reference's
    ``(None, "vocab", "embed")``."""
    out = {}
    for prefix, m in module.named_modules(remove_duplicate=True):
        for pname, p in m.named_parameters(recurse=False):
            axes = type(m).AXES[pname]
            name = f"{prefix}.{pname}" if prefix else pname
            out[name] = (None,) * (p.dim() - len(axes)) + tuple(axes)
    return out


# ------------------------------------------------------------------ init ----

# constant leaves: the plus-one norms' offsets (0), the QK-norm weights
# (1, reference models/attention.py), the Mamba block's dt bias, conv
# bias, skip D and gate norm (reference models/ssm.py), and the xLSTM
# blocks' norms and the LSTM's bias (reference models/xlstm.py)
_CONST_INIT = {"ln1": 0.0, "ln2": 0.0, "final_norm": 0.0, "q_norm": 1.0,
               "k_norm": 1.0, "dt_bias": 0.0, "conv_b": 0.0, "D": 1.0,
               "norm": 1.0, "b": 0.0}


@torch.no_grad()
def init_weights(module: nn.Module, cfg, generator: torch.Generator):
    """Fill every parameter in registration order from ``generator``, with
    the reference's initialisers: norms and biases constant, the Mamba
    ``A_log = log(linspace(1, 16, H))``, embedding tables and heads (one
    a codebook where the config has codebooks) N(0, d^-1), the Mamba and
    xLSTM convs N(0, 1/K), projections (``vision_proj`` among them)
    N(0, 1/fan_in), expert
    banks (E, din, dout) N(0, 1/din) and the sLSTM's recurrent weights
    (H, 4, D, D) N(0, 1/D)."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _CONST_INIT:
            p.fill_(_CONST_INIT[leaf])
            continue
        if leaf == "A_log":
            p.copy_(torch.linspace(1.0, 16.0, p.shape[0], device=p.device)
                    .to(p.dtype).log())
            continue
        # conv_w is (K, channels): 1/fan_in is the reference's K^-0.5 too
        if leaf in ("table", "head"):
            scale = cfg.d_model ** -0.5
        else:
            scale = 1.0 / math.sqrt(p.shape[-2] if p.dim() >= 3
                                    else p.shape[0])
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32) * scale)
