"""Top-level language model: embeddings -> layer stack -> head, the
forward / prefill / decode-step / suffix-prefill entry points the serving
engine calls, and the causal LM loss the train step differentiates (port of
``repro/models/model.py`` for ATTN/LOCAL and MLA stacks with dense or MoE
MLPs, the zamba2 hybrid, and the xLSTM and LSTM stacks).

The modality stubs are the reference's: musicgen's tokens are (B, S, K)
ids of K EnCodec codebooks, embedded by K summed tables, with (B, S, K, V)
logits; paligemma's batch may carry ``prefix_embed`` (B, P, d), the stub's
SigLIP patch embeddings, projected by ``vision_proj`` and put before the
text under a bidirectional prefix mask, and its loss counts the text rows
only.

``forward`` updates the caches it is given in place (dense KV rows, the
recurrent layers' state entries, pool pages) and returns the logits; ``prefill`` and
``decode_step`` return ``(logits, caches)``, as the reference's do.  They
serve: ``forward`` runs under ``no_grad``.  ``loss_fn`` shares its body
and builds the autograd graph, with Sentinel's block structure
(``transformer.stack_forward``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import SHARED_ATTN
from repro_torch.device import resolve
from repro_torch.models import kvcache, transformer
from repro_torch.models.layers import (embed, frozen, init_weights, rmsnorm,
                                       unembed)
from repro_torch.models.layers import param_axes as module_axes
from repro_torch.sharding import (all_reduce_over, current_rank,
                                  fsdp_call, rank_block)


def param_dtype(cfg):
    return torch.float32 if cfg.dtype == "float32" else torch.bfloat16


class Model(nn.Module):
    """Parameters of the whole model, named as the reference's tree:
    ``table`` (embed/table), ``prologue.<i>.*`` (stack/prologue[i], with
    a dense MLP of ``prologue_d_ff`` where the config has one),
    ``shared.*`` (stack/shared, zamba2's one shared block), ``layers.<j>.*``
    (slot ``j % period_len`` of the stacked tree at period
    ``j // period_len``), ``final_norm``, ``head`` when embeddings are
    untied, and ``vision_proj`` (d, d) where the config has a prefix.
    ``table`` and ``head`` are (padded_vocab, d), or (K, padded_vocab, d)
    for K codebooks.  A SHARED_ATTN slot of ``layers`` is the ``shared``
    module itself, so ``named_parameters`` lists its weights once, as
    ``shared.*``."""
    AXES = {"table": ("vocab", "embed"), "head": ("vocab", "embed"),
            "final_norm": ("embed",), "vision_proj": ("embed", "embed")}

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        table = (cfg.num_codebooks,) if cfg.num_codebooks else ()
        table += (cfg.padded_vocab, cfg.d_model)
        self.table = frozen(torch.empty(table, device=device, dtype=dtype))
        self.prologue = nn.ModuleList(
            transformer.make_layer(cfg, kind, device=device, dtype=dtype,
                                   dense_ff=cfg.prologue_d_ff)
            for kind in cfg.prologue)
        self.shared = transformer.make_layer(
            cfg, SHARED_ATTN, device=device, dtype=dtype) \
            if SHARED_ATTN in cfg.period else None
        # every SHARED_ATTN slot is the one shared block itself
        self.layers = nn.ModuleList(
            self.shared if kind == SHARED_ATTN else
            transformer.make_layer(cfg, kind, device=device, dtype=dtype)
            for _ in range(cfg.num_periods) for kind in cfg.period)
        self.final_norm = frozen(torch.empty(cfg.d_model, device=device,
                                             dtype=dtype))
        self.head = None if cfg.tie_embeddings else frozen(
            torch.empty(table, device=device, dtype=dtype))
        self.vision_proj = frozen(torch.empty(
            cfg.d_model, cfg.d_model, device=device, dtype=dtype)) \
            if cfg.num_prefix_tokens else None

    def forward(self, cfg, tokens, positions, *, prefix=None, caches=None,
                cache_index=None, decode=False, paged_view=None, aux=None,
                **sentinel):
        """``prefix``: the patch embeddings (B, P, d) put before the text's
        embeddings, cast to the parameters' dtype and projected by
        ``vision_proj`` (not scaled); ``sentinel``: ``stack_forward``'s
        ``remat_policy``, ``unroll_periods``, ``mi_periods`` and
        ``tag_block_out``; ``aux``: a list the MoE layers append their
        auxiliary losses to."""
        x = embed(self.table, cfg, tokens)
        if prefix is not None:
            x = torch.cat([prefix.to(x.dtype) @ self.vision_proj, x], dim=1)
        x = transformer.stack_forward([*self.prologue, *self.layers], cfg,
                                      x, positions,
                                      caches=caches, cache_index=cache_index,
                                      decode=decode, paged_view=paged_view,
                                      aux=aux, **sentinel)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        # a rank's logits stay vocab-local, as the reference's constrain
        # (its model.py:94) leaves them
        return unembed(self.table if self.head is None else self.head, cfg,
                       x)


def init_params(cfg, seed: int = 0, device=None, *,
                requires_grad: bool = False) -> Model:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default: the CUDA card; raises without one unless ``device="cpu"``).
    ``requires_grad``: parameters a train step differentiates (serving
    leaves them off).  On ``device="meta"`` the model holds shapes only,
    for ``core.profiler.trace_profile``."""
    dev = resolve(device)
    params = Model(cfg, device=dev, dtype=param_dtype(cfg))
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init_weights(params, cfg, gen)
    return params.requires_grad_(requires_grad)


def param_axes(cfg) -> dict:
    """``{name: logical axes}`` for every parameter of ``cfg``'s model, named
    as ``Model.named_parameters`` names them (built on the meta device)."""
    return module_axes(Model(cfg, device=torch.device("meta"),
                             dtype=param_dtype(cfg)))


def _logits(params, cfg, batch, *, caches=None, cache_index=None,
            decode: bool = False, positions=None, paged_view=None, aux=None,
            **sentinel):
    """The body of ``forward`` and ``loss_fn``.  Outside decode a
    ``batch["prefix_embed"]`` goes before the tokens (where the config has
    a prefix), and the default positions run over both."""
    tokens = batch["tokens"]
    B, S = tokens.shape[:2]
    prefix = batch.get("prefix_embed") \
        if cfg.num_prefix_tokens and not decode else None
    if prefix is not None:
        S += prefix.shape[1]
    if positions is None:
        if decode:
            ci = torch.as_tensor(cache_index, device=tokens.device)
            positions = ci[:, None] if ci.dim() >= 1 else ci.expand(B, S)
        else:
            positions = torch.arange(S, device=tokens.device).expand(B, S)
    # the model's own leaves; stack_forward gathers each layer's
    return fsdp_call(params, (cfg, tokens, positions),
                     dict(prefix=prefix, caches=caches,
                          cache_index=cache_index, decode=decode,
                          paged_view=paged_view, aux=aux, **sentinel),
                     recurse=False)


@torch.no_grad()
def forward(params, cfg, batch, *, caches=None, cache_index=None,
            decode: bool = False, positions=None, paged_view=None):
    """Logits (B, S, padded_vocab) for ``batch["tokens"]`` (B, S), or (B,
    S, K, padded_vocab) for (B, S, K) codebook tokens; with a
    ``batch["prefix_embed"]`` (B, P, d) the rows are P + S, prefix first.

    ``caches`` (one entry per layer: ``kvcache.init_cache`` or
    ``PagedKVPools.tree``) are updated in place.  decode=True: one token
    per slot at positions ``cache_index`` (a scalar, or a (B,) tensor of
    per-slot write offsets); ``paged_view`` carries the pools' page table,
    or with ``cfg.use_paged_decode`` the per-slot boundaries a dense cache
    is read through.  Otherwise positions default to 0..S-1 (suffix
    prefill passes its own)."""
    return _logits(params, cfg, batch, caches=caches,
                   cache_index=cache_index, decode=decode,
                   positions=positions, paged_view=paged_view)


def loss_fn(params, cfg, batch, *, remat_policy=None, unroll_periods=False,
            mi_periods: int = 1, tag_block_out: bool = False):
    """Causal LM loss: the mean NLL of ``batch["labels"]`` (B, S), or (B,
    S, K) for codebooks, under the forward's logits, with the padded vocab
    entries masked out of the softmax, plus the MoE layers' auxiliary
    losses.  A config with a prefix counts the rows after its
    ``num_prefix_tokens`` only (labels (B, P + S), the prefix's rows
    padding), as the reference's does whether or not the batch carries
    ``prefix_embed``.  It builds the
    autograd graph when grad is enabled and the parameters require it; the
    keywords are the reference's (``core.offload.loss_kwargs`` gives them
    for a ``SentinelConfig``) and change memory, never the value.

    Under a rank context whose logits are its block of the vocab the loss
    is vocab-parallel: the max and the sum of exps all-reduced over
    ``model``, the gold logit from the rank that holds it, the padded
    entries masked in the rank's block; no rank gathers the logits."""
    aux = []
    logits = _logits(params, cfg, batch, remat_policy=remat_policy,
                     unroll_periods=unroll_periods, mi_periods=mi_periods,
                     tag_block_out=tag_block_out, aux=aux).float()
    labels = batch["labels"].long()
    V = logits.shape[-1]
    if current_rank() is not None and V < cfg.padded_vocab:
        nll = _vocab_parallel_nll(cfg, logits, labels, rank_block("vocab") * V)
    else:
        if cfg.padded_vocab != cfg.vocab_size:
            pad = torch.zeros(cfg.padded_vocab, device=logits.device)
            pad[cfg.vocab_size:] = -1e9
            logits = logits + pad
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[..., None])[..., 0]
        nll = logz - gold
    if cfg.num_prefix_tokens:                 # the text suffix only
        nll = nll[:, cfg.num_prefix_tokens:]
    return nll.mean() + sum(aux)


def _vocab_parallel_nll(cfg, logits, labels, v0: int):
    """The NLL of ``labels`` from this rank's logits of vocab entries [v0,
    v0 + V): the padded entries masked, the max all-reduced (no
    gradient), then the sum of exps and the gold logit (nonzero on the
    rank holding the label only) in one all-reduce whose backward is the
    identity."""
    V = logits.shape[-1]
    if cfg.padded_vocab != cfg.vocab_size:
        ids = torch.arange(v0, v0 + V, device=logits.device)
        logits = logits + torch.where(ids >= cfg.vocab_size, -1e9, 0.0)
    m = all_reduce_over(logits.detach().amax(dim=-1), ("model",), op="max")
    local = labels - v0
    mine = (local >= 0) & (local < V)
    gold = logits.gather(-1, local.clamp(0, V - 1)[..., None])[..., 0] * mine
    sums = torch.stack([torch.exp(logits - m[..., None]).sum(dim=-1), gold])
    total, gold = all_reduce_over(sums, ("model",)).unbind(0)
    return m + torch.log(total) - gold


def prefill(params, cfg, batch, max_seq=None):
    """Run the whole prompt into a fresh dense cache of ``max_seq`` (default
    S, or P + S with a ``prefix_embed``) rows.  Returns (last row's logits
    (B, V) or (B, K, V), caches)."""
    tokens = batch["tokens"]
    B, S = tokens.shape[:2]
    if "prefix_embed" in batch:
        S += cfg.num_prefix_tokens
    caches = kvcache.init_cache(cfg, B, max_seq or S, param_dtype(cfg),
                                tokens.device)
    logits = forward(params, cfg, batch, caches=caches)
    return logits[:, -1], caches


def decode_step(params, cfg, tokens, caches, cache_index):
    """One token for every sequence: ``tokens`` (B, 1), or (B, 1, K) for
    codebooks, at ``cache_index`` (a scalar or (B,)).  Returns (logits
    (B, V) or (B, K, V), caches)."""
    logits = forward(params, cfg, {"tokens": tokens}, caches=caches,
                     cache_index=cache_index, decode=True)
    return logits[:, -1], caches


def prefill_suffix(params, cfg, batch, *, caches, start: int, paged_view):
    """Run prefill over a prompt *suffix* (``batch["tokens"]`` holds
    ``tokens[start:]``) against KV already in the pools: positions and
    cache writes begin at ``start`` and each row attends back over the
    whole valid prefix.  ``paged_view`` carries the slot's page-table row
    and ``{"prefill": True}``.  Returns the last row's logits (B, V)."""
    tokens = batch["tokens"]
    B, L = tokens.shape
    positions = torch.arange(L, device=tokens.device).expand(B, L) + start
    logits = forward(params, cfg, batch, caches=caches, cache_index=start,
                     positions=positions, paged_view=paged_view)
    return logits[:, -1]
