"""The layer stack (port of ``repro/models/transformer.py`` for ATTN/LOCAL
and MLA stacks with dense or MoE MLPs, the zamba2 hybrid, and the xLSTM and
LSTM stacks).  The reference lowers the stack as a
``lax.scan`` over stacked periods; here it is a plain loop over the prologue
layers, then over the period layers, period layer ``j`` being slot
``j % period_len`` of period ``j // period_len``.  A SHARED_ATTN slot holds
the one shared block object itself, so all its layers use one set of
weights.  Caches are one entry per layer: attention layers write theirs in
place; a recurrent layer's (MAMBA, MLSTM, SLSTM, LSTM) new state replaces
the entries of its cache dict.
A MoE layer's auxiliary loss is appended to the ``aux`` list a caller
passes (``model.loss_fn`` sums it), as the reference's stack sums it; in
Sentinel's blocks each block appends one float32 sum of its layers'
losses, a second output of the block with its own gradient.

A train step runs the period layers as Sentinel's blocks of ``mi_periods``
periods (``stack_forward``, ``core/offload.py``)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import (ATTN, LSTM, MAMBA, MLA, MLSTM,
                                      SHARED_ATTN, SLSTM)
from repro_torch.core import profiler
from repro_torch.core.offload import CarryStore
from repro_torch.models import xlstm
from repro_torch.models.attention import MLA as MLAttention
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, frozen, rmsnorm
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import MambaBlock
from repro_torch.sharding import current_rank, fsdp_call, rank_context


class Block(nn.Module):
    """One ATTN/LOCAL layer (and zamba2's shared block, with kind ATTN) or
    MLA layer: pre-norm attention (``attn``, or ``mla``) and a pre-norm
    MLP, MoE (``moe``) where the config has one and ``dense_ff`` is 0,
    else a gated MLP (``mlp``) of width ``dense_ff`` or ``cfg.d_ff``, as
    the reference's ``init_block``."""
    AXES = {"ln1": ("embed",), "ln2": ("embed",)}

    def __init__(self, cfg, kind: str, *, device, dtype, dense_ff: int = 0):
        super().__init__()
        self.kind = kind
        self.ln1 = frozen(torch.empty(cfg.d_model, device=device, dtype=dtype))
        if kind == MLA:
            self.mla = MLAttention(cfg, device=device, dtype=dtype)
        else:
            self.attn = Attention(cfg, device=device, dtype=dtype)
        self.ln2 = frozen(torch.empty(cfg.d_model, device=device, dtype=dtype))
        self.mlp = self.moe = None
        if cfg.moe is not None and not dense_ff:
            self.moe = MoE(cfg, device=device, dtype=dtype)
        else:
            self.mlp = MLP(cfg.d_model, dense_ff or cfg.d_ff, device=device,
                           dtype=dtype)

    def forward(self, cfg, x, positions, *, cache=None, cache_index=None,
                decode=False, paged_view=None, aux=None):
        # the reference's constrain sites at the norms and the residual
        # (its transformer.py:106-138) move no data under a rank context:
        # serve_rules keep the sequence and d_model whole
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        if self.kind == MLA:
            a = self.mla(cfg, h, positions, cache=cache,
                         cache_index=cache_index)
        else:
            a = self.attn(cfg, h, positions, kind=self.kind, cache=cache,
                          cache_index=cache_index, paged_view=paged_view)
        x = x + a
        h = rmsnorm(x, self.ln2, cfg.norm_eps)
        if self.moe is None:
            return x + self.mlp(h, cfg.act)
        f, layer_aux = self.moe(cfg, h, cfg.act)
        if aux is not None:
            aux.append(layer_aux)
        return x + f


class StateLayer(nn.Module):
    """One layer of a recurrent kind: MAMBA, MLSTM or SLSTM (the pre-norm
    block, ``mamba``, ``mlstm`` or ``slstm``, and the residual), or LSTM
    (the block ``lstm`` alone: no norm and no residual), as the
    reference's ``apply_block``."""
    AXES = {"ln1": ("embed",)}

    BLOCKS = {MAMBA: MambaBlock, MLSTM: xlstm.MLSTMBlock,
              SLSTM: xlstm.SLSTMBlock, LSTM: xlstm.LSTMBlock}

    def __init__(self, cfg, kind: str, *, device, dtype):
        super().__init__()
        self.kind = kind
        if kind != LSTM:
            self.ln1 = frozen(torch.empty(cfg.d_model, device=device,
                                          dtype=dtype))
        self.add_module(kind, self.BLOCKS[kind](cfg, device=device,
                                                dtype=dtype))

    def forward(self, cfg, x, positions, *, cache=None, cache_index=None,
                decode=False, paged_view=None, aux=None):
        """With a cache: a prefill runs from its state, a decode steps it;
        either way the new state replaces the dict's entries (the rows of
        every slot, active or not, as the reference's lockstep decode
        does)."""
        block = getattr(self, self.kind)
        if self.kind == LSTM:
            y, state = block(cfg, x, cache=cache, decode=decode)
        else:
            y, state = block(cfg, rmsnorm(x, self.ln1, cfg.norm_eps),
                             cache=cache, decode=decode)
            y = x + y
        if cache is not None:
            cache.update(state)
        return y


def make_layer(cfg, kind: str, *, device, dtype, dense_ff: int = 0):
    """A new layer of ``kind``; SHARED_ATTN builds zamba2's shared block
    (full causal attention and a d_ff MLP), which the model builds once;
    ``dense_ff`` > 0 forces a dense MLP of that width (deepseek's
    prologue)."""
    if kind in StateLayer.BLOCKS:
        return StateLayer(cfg, kind, device=device, dtype=dtype)
    if kind == SHARED_ATTN:
        return Block(cfg, ATTN, device=device, dtype=dtype,
                     dense_ff=cfg.d_ff)
    return Block(cfg, kind, device=device, dtype=dtype, dense_ff=dense_ff)


def stack_forward(layers, cfg, x, positions, *, caches=None,
                  cache_index=None, decode=False, paged_view=None,
                  remat_policy=None, unroll_periods: bool = False,
                  mi_periods: int = 1, tag_block_out: bool = False,
                  aux=None):
    """Run every layer in order (prologue first); ``caches`` is one cache
    entry per layer (a dense cache, or ``PagedKVPools.tree``), updated in
    place; each MoE layer appends its auxiliary loss to ``aux`` when a
    list is given.

    Sentinel (core/offload.py), for a step that builds the autograd graph
    without caches:
      - remat_policy: a blocked mode ("offload", "save_hbm", "remat";
        None runs the layers as they are and autograd saves everything).
        The prologue runs first, unblocked, as the reference's does; then
        the period layers run as ``num_periods / mi_periods`` blocks (a
        count that does not divide is refused), each a ``_Block``: its
        forward keeps its carry-in (the previous block's output, or the
        prologue's) and nothing else, its backward recomputes it.
        On a MoE config a block also returns the float32 sum of its
        layers' auxiliary losses (a list local to the block, so the
        backward's recompute appends nowhere else), which ``stack_forward``
        appends to ``aux``; the aux is no carry, each block's starts at 0.
      - tag_block_out: the carry is named for the policy, so "offload"
        keeps it in pinned host memory (``CarryStore``); otherwise it
        stays on the device.
      - unroll_periods: mark each period for ``profiler.trace_profile``
        (the reference's ``period_{i}`` scopes); no blocks.
    """
    def run(lo, hi, x, aux=aux):
        for l in range(lo, hi):
            # FSDP gathers the layer's leaves for its call
            x = fsdp_call(layers[l], (cfg, x, positions), dict(
                cache=caches[l] if caches is not None else None,
                cache_index=cache_index, decode=decode,
                paged_view=paged_view, aux=aux))
        return x

    n_pro, span = len(cfg.prologue), cfg.period_len
    P = cfg.num_periods
    if unroll_periods:
        x = profiler.mark(x, 0, 2 * P + 2)           # embedding gradient
        x = run(0, n_pro, x)
        for p in range(P):
            # forward period p at step p + 1; below this mark the backward
            # moves on to period p - 1 (the prologue's belongs to period 0's)
            x = profiler.mark(x, p + 1, 2 * P + 1 - max(p - 1, 0))
            x = run(n_pro + p * span, n_pro + (p + 1) * span, x)
        return profiler.mark(x, P + 1, P + 2)        # head and loss
    if remat_policy is None or caches is not None or \
            not torch.is_grad_enabled():
        return run(0, len(layers), x)
    if mi_periods < 1 or P % mi_periods:
        raise ValueError(f"num_periods {P} not divisible by migration "
                         f"interval {mi_periods}")
    x = run(0, n_pro, x)
    store = CarryStore("host" if remat_policy == "offload" and tag_block_out
                       else "device")
    width = mi_periods * span
    moe = cfg.moe is not None
    for b in range(P // mi_periods):
        lo = n_pro + b * width
        weights = {id(w): w for layer in layers[lo:lo + width]
                   for w in layer.parameters() if w.requires_grad}
        if not moe:
            x = _Block.apply(lambda x, lo=lo: run(lo, lo + width, x), store,
                             b, x, *weights.values())
            continue
        x, block_aux = _Block.apply(
            lambda x, lo=lo: _run_with_aux(run, lo, lo + width, x), store, b,
            x, *weights.values())
        if aux is not None:
            aux.append(block_aux)
    return x


def _run_with_aux(run, lo, hi, x):
    """(the layers' output, the float32 sum of their auxiliary losses, in
    layer order, from 0)."""
    local = []
    y = run(lo, hi, x, local)
    total = torch.zeros((), dtype=torch.float32, device=y.device)
    for a in local:
        total = total + a
    return y, total


class _Block(torch.autograd.Function):
    """One Sentinel block of the period layers: the forward runs them
    without a graph and keeps only the carry-in (``CarryStore.put``); the
    backward fetches it back (``CarryStore.get``, which starts the
    previous block's fetch), runs the layers again with grad and returns
    the gradients of the carry-in and of the block's weights.  A weight
    that several blocks use (zamba2's shared block) gets each block's
    share, which autograd sums.  ``run`` returns the output, or on a MoE
    config (output, aux sum): the backward then differentiates both, a
    missing aux gradient taken as zero.  Under a rank context the forward
    keeps it and the backward's recompute runs under it again, so the
    recompute's collectives meet the rank's groups wherever autograd runs
    the backward (a partitioned step runs each rank's on the rank's own
    thread: ``train/loop.py``)."""

    @staticmethod
    def forward(ctx, run, store, b, x, *weights):
        ctx.run, ctx.store, ctx.b, ctx.weights = run, store, b, weights
        ctx.rank = current_rank()
        store.put(b, x)
        return run(x)

    @staticmethod
    def backward(ctx, gy, gaux=None):
        need_x = ctx.needs_input_grad[3]
        with rank_context(ctx.rank), torch.enable_grad():
            x = ctx.store.get(ctx.b).detach().requires_grad_(need_x)
            out = ctx.run(x)
            if isinstance(out, tuple):
                gy = (gy, torch.zeros_like(out[1]) if gaux is None else gaux)
            wrt = ((x,) if need_x else ()) + ctx.weights
            grads = torch.autograd.grad(out, wrt, gy, allow_unused=True)
        return (None, None, None) + ((None,) if not need_x else ()) + grads
