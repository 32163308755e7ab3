"""GQA attention with causal / sliding-window / prefix-LM masks, logit
softcap, QK-norm, per-kind RoPE and KV caches, and DeepSeek's multi-head
latent attention (port of ``repro/models/attention.py``).

Forms: no cache (a full-sequence forward); a dense cache {"k", "v"}
(B, Smax, KV*hd), written at a scalar offset (prefill, lockstep decode) or
at a per-slot offset (continuous batching) and read whole under the mask,
or, with ``cfg.use_paged_decode`` and a page view of per-slot boundaries,
read through the pool layout by ``ops.paged_decode_attention``
(``_paged_decode_core``); and the persistent page pools, in pool prefill
(one admitted slot's prompt chunk written into its physical pages) and pool
decode (one token per slot, read back through
``ops.paged_decode_attention``).  MLA keeps a dense latent cache {"ckv",
"krope"} in every layout, as the reference's (it has no paged path).
Caches are updated in place where the reference used ``.at[].set``.

Under a rank context (``sharding.rank_context``) GQA runs on the rank's
blocks of wq, wk, wv (column-split) and wo (row-split), and ``_RankHeads``
says how: where the split lands on whole heads the rank runs its own
query heads against the KV heads they read; where it cuts a head (or
leaves the rank's queries without their KV heads whole) the projections
are gathered, attention runs whole, and the rank takes its block of the
output back before its row block of wo, as XLA partitions the
reference's program.  The output of wo is a partial sum, all-reduced, or
under Megatron-SP reduce-scattered onto the rank's block of the rows
(``sharding.to_residual``).  Under ``serve_rules(seq_shard=True)``
(``long_500k``) a rank's dense cache holds its block of the rows over
the data axes, and a decode runs flash-decoding's way
(``_seq_split_decode``): the new row written where its block holds it,
the block scored at its true positions, the ranks' partial softmaxes
merged exactly over the data axes.
Under grad, whatever is replicated and enters the rank's share of the
heads passes ``sharding.to_split`` (its gradient all-reduced over
``model``): the input of a split projection, k and v where wk and wv stay
whole, and the QK-norm weights of a split q or k.  MLA's rank program is
its class's (``MLA``).  The pool layouts refuse a rank context
(``sharding.refuse_partitioned``): the reference runs them on one device
only.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ATTN, LOCAL
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.paged_decode import gather_pools, pool_layout
from repro_torch.models.layers import apply_rope, frozen, rmsnorm, softcap
from repro_torch.sharding import (all_reduce_over, constrain, current_rank,
                                  kv_seq_block, rank_block,
                                  refuse_partitioned, to_residual, to_split)

NEG_INF = -2.0 ** 20


def attn_bias(q_pos, kv_pos, *, window: int = 0, prefix_len: int = 0):
    """Additive bias (..., Sq, Skv) from position vectors.
    q_pos: (B, Sq) or (Sq,); kv_pos: (Skv,).  window > 0: sliding-window.
    prefix_len > 0: every key below it is visible to every query (the
    bidirectional prefix), as the reference's: over a cache that includes
    rows not yet written, where a prompt is shorter than the prefix
    (ROADMAP R9)."""
    q = q_pos[..., :, None].to(torch.int32)
    k = kv_pos[None, :].to(torch.int32)
    ok = k <= q
    if window:
        ok &= (q - k) < window
    if prefix_len:
        ok |= k < prefix_len
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def write_rows(buf, rows, cache_index):
    """Write ``rows`` (B, Sq, ...) into the dense cache buffer ``buf`` (B,
    Smax, ...) in place (the reference's ``.at[].set`` and
    ``dynamic_update_slice``): one row a slot at a (B,) tensor of per-slot
    offsets, or Sq rows at a scalar offset (0 when None).

    A per-slot offset at or past Smax is dropped, as JAX's scatter drops
    it: a finished slot keeps its stale length, which may equal Smax, and
    the lockstep decode still writes its row.  So is a negative one (a
    rank's block of a sequence-split cache that does not hold the slot's
    row; it must not wrap).  The index is clamped and the row rewritten
    with its own value there, on the device, with no read back to the
    host.  A scalar offset keeps the slice write: Sq rows
    must fit at ``off`` (torch raises where they do not).  The engines
    never reach that: a one-shot admission writes its prompt at 0 into a
    cache of max_seq rows (a longer prompt raises in both packages, where
    ``dynamic_update_slice`` meets an update larger than its operand), and
    ``generate`` sizes its cache to the prompt plus its tokens."""
    ci = 0 if cache_index is None else cache_index
    if torch.is_tensor(ci) and ci.dim() >= 1:
        Smax = buf.shape[1]
        rows_b = torch.arange(buf.shape[0], device=buf.device)
        idx = ci.long().clamp(0, Smax - 1)
        keep = ((ci >= 0) & (ci < Smax)).view(-1, *([1] * (rows.dim() - 2)))
        buf[rows_b, idx] = torch.where(keep, rows[:, 0].to(buf.dtype),
                                       buf[rows_b, idx])
    else:
        off = int(ci)
        buf[:, off:off + rows.shape[1]] = rows


def _scores(q, k, bias, softcap_val: float):
    """The f32 scores (B,KV,G,Sq,Skv) of q (B,Sq,KV,G,hd) against k
    (B,Skv,KV,hd): scaled, softcapped, biased by ``bias`` (B|1, Sq,
    Skv)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    return softcap(scores, softcap_val) + bias[:, None, None, :, :]


def _gqa_core(q, k, v, bias, softcap_val: float):
    """q: (B,Sq,KV,G,hd); k,v: (B,Skv,KV,hd); bias: (B|1, Sq, Skv)."""
    probs = torch.softmax(_scores(q, k, bias, softcap_val), dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)


def _gqa_partial(q, k, v, bias, softcap_val: float):
    """``_gqa_core``'s softmax over the keys given, unnormalised: (the row
    max m (B,KV,G,Sq), the sum of exponentials l (B,KV,G,Sq), and the
    output o (B,Sq,KV,G,hd) of exp(score - m), f32), flash-decoding's
    partial of one block of the keys."""
    scores = _scores(q, k, bias, softcap_val)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype), v).float()
    return m, p.sum(dim=-1), o


def _merge_partials(m, l, o, axes, dtype):
    """The softmax over every block of the keys from each rank's partial
    (``_gqa_partial``) over the mesh ``axes`` the keys are split on: the
    row max all-reduced (max), then each rank's l and o weighted by
    exp(m - max) and summed in one all-reduce (rank order).  A block that
    sees no key (its max at NEG_INF's bias: a LOCAL layer's window in
    another block, or keys past the query) weighs exactly 0."""
    mx = all_reduce_over(m, axes, op="max")
    w = torch.where(m > NEG_INF / 2, torch.exp(m - mx), 0.0)
    w_o = w.permute(0, 3, 1, 2)[..., None]             # (B, Sq, KV, G, 1)
    part = torch.cat([o * w_o, l.permute(0, 3, 1, 2)[..., None] * w_o], -1)
    tot = all_reduce_over(part, axes)
    return (tot[..., :-1] / tot[..., -1:]).to(dtype)


class _RankHeads:
    """One rank's view of a GQA layer under a rank context.

    ``H`` query heads from ``h0`` and the ``KV`` KV heads from ``kv0``
    that they read.  ``gather_q``: the rank's block of wq cuts a head (or
    its heads do not fall in whole KV groups), so q is gathered and every
    head runs.  ``gather_kv``: the rank's block of wk and wv is not
    exactly the KV heads its queries read, so k and v are gathered (and
    the ``KV`` heads from ``kv0`` picked from them).
    ``q_split``/``kv_split``: the rules split wq (and wo) / wk and wv."""

    def __init__(self, cfg, attn):
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        G = H // KV
        qc, kc = attn.wq.shape[1], attn.wk.shape[1]
        self.q_split, self.kv_split = qc < H * hd, kc < KV * hd
        Hl = qc // hd
        whole = self.q_split and qc % hd == 0 and \
            (Hl % G == 0 or G % Hl == 0)
        self.gather_q = self.q_split and not whole
        self.h0, self.H = (rank_block("heads") * Hl, Hl) if whole else (0, H)
        self.KV = max(1, self.H // G)
        self.kv0 = self.h0 // G
        own = self.kv_split and kc == self.KV * hd and \
            rank_block("kv_heads") * self.KV == self.kv0
        self.gather_kv = self.kv_split and not own
        self.pick = not own and self.KV < KV

    def kv_heads(self, t):
        """The KV heads this rank's queries read, of whole-head k or v
        (B, S, KV, hd)."""
        return t[:, :, self.kv0:self.kv0 + self.KV] if self.pick else t


class Attention(nn.Module):
    AXES = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
            "q_norm": (None,), "k_norm": (None,)}
    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        H, KV, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model

        def w(*shape):
            return frozen(torch.empty(*shape, device=device, dtype=dtype))

        self.wq, self.wk, self.wv = w(d, H * hd), w(d, KV * hd), w(d, KV * hd)
        self.wo = w(H * hd, d)
        if cfg.qk_norm:
            self.q_norm, self.k_norm = w(hd), w(hd)

    def qkv(self, cfg, x, positions, kind: str = ATTN, tp=None):
        """q (B, Sq, H, hd) and k, v (B, Sq, KV, hd) of x (B, Sq, d): with
        QK-norm (a plain RMS norm, the reference's ``plus_one=False``)
        where the config has it, then the rotary embedding on q and k at
        the layer kind's theta (global layers take ``rope_theta_global``
        when it is set).  Under a rank context (``tp``, a ``_RankHeads``)
        H and KV are the heads the rank holds, or every head where its
        blocks were gathered."""
        B, Sq, _ = x.shape
        hd = cfg.head_dim
        theta = cfg.rope_theta_global \
            if kind != LOCAL and cfg.rope_theta_global else cfg.rope_theta
        q_split = tp is not None and tp.q_split
        kv_split = tp is not None and tp.kv_split
        xq = to_split(x) if q_split else x
        xk = xq if kv_split else x
        q, k, v = xq @ self.wq, xk @ self.wk, xk @ self.wv
        if tp is not None:
            if tp.gather_q:
                q = constrain(q, ("batch", "seq", None),
                              held=("batch", "seq", "heads"))
            if tp.gather_kv:
                k, v = (constrain(t, ("batch", "seq", None),
                                  held=("batch", "seq", "kv_heads"))
                        for t in (k, v))
        q = q.reshape(B, Sq, -1, hd)
        k = k.reshape(B, Sq, -1, hd)
        v = v.reshape(B, Sq, -1, hd)
        if cfg.qk_norm:
            qn, kn = self.q_norm, self.k_norm
            q = rmsnorm(q, to_split(qn) if q_split else qn, cfg.norm_eps,
                        plus_one=False)
            k = rmsnorm(k, to_split(kn) if kv_split else kn, cfg.norm_eps,
                        plus_one=False)
        q, k = apply_rope(q, positions, theta), apply_rope(k, positions,
                                                           theta)
        if q_split and not kv_split:
            # whole k and v serve the rank's share of the heads only
            k, v = to_split(k), to_split(v)
        return q, k, v

    def forward(self, cfg, x, positions, *, kind: str = ATTN, cache=None,
                cache_index=None, paged_view=None):
        """x: (B, Sq, d).  ``cache``: None, a dense {"k", "v"} cache, or one
        layer's pools {"k_hot", "v_hot", "k_cold", "v_cold"}
        (kvcache.PagedKVPools), for which ``paged_view["prefill"]`` selects
        pool prefill, else pool decode.  ``cache_index``: the write offset,
        a scalar or a (B,) tensor of per-slot offsets (0 when None)."""
        B, Sq, _ = x.shape
        hd = cfg.head_dim
        window = cfg.sliding_window if kind == LOCAL else 0
        tp = None
        if current_rank() is not None:
            if paged_view is not None:
                refuse_partitioned("paged or pooled attention")
            tp = _RankHeads(cfg, self)

        q, k, v = self.qkv(cfg, x, positions, kind, tp)
        KV = k.shape[2] if tp is None else tp.KV
        q = q.reshape(B, Sq, KV, -1, hd)

        if cache is not None and "k_hot" in cache:
            core = _pool_prefill_core if paged_view.get("prefill") \
                else _pool_decode_core
            out = core(cfg, q, k, v, cache, cache_index, paged_view, window,
                       positions)
        elif cache is not None:
            out = _dense_core(cfg, q, k, v, cache, cache_index, paged_view,
                              window, positions, tp)
        else:
            if tp is not None:
                k, v = tp.kv_heads(k), tp.kv_heads(v)
            pos = positions[0] if positions.dim() > 1 else positions
            bias = attn_bias(positions, pos, window=window,
                             prefix_len=_prefix_len(cfg))
            if bias.dim() == 2:
                bias = bias[None]
            out = _gqa_core(q, k, v, bias, cfg.attn_softcap)
        out = out.reshape(B, Sq, -1)
        # where every head ran, the rank takes its block back for its row
        # block of wo, whose product is then a partial sum
        out = constrain(out, ("batch", "seq", "heads"),
                        held=("batch", "seq", None)
                        if tp is not None and tp.gather_q else None)
        return to_residual(out @ self.wo,
                           partial=tp is not None and tp.q_split)


def _dense_core(cfg, q, k, v, cache, cache_index, paged_view, window,
                positions, tp=None):
    """Attention over a dense cache {"k", "v"} (B, Smax, KV*hd): the new
    rows are written in place, row-wise at a (B,) ``cache_index`` (each
    slot at its own length) or as one slice at a scalar offset, then every
    query attends over the whole buffer under ``attn_bias`` (rows past a
    query's position are masked, except below a prefix-LM's prefix).  With
    ``cfg.use_paged_decode``, a ``paged_view`` and one query token, the
    updated cache is read through the pool layout instead
    (``_paged_decode_core``), except under ``cfg.prefix_lm``: K1 has no
    prefix mask, so the reference keeps such a decode on the dense
    path.

    Under a rank context (``tp``) the cache holds the rank's block of the
    KV heads wherever the rules split them.  Where k and v were gathered,
    the rank writes its block of them and attends over whole heads: the
    gathered new rows after the cache's earlier rows gathered (at a scalar
    offset only those before it, so a prefill gathers no row twice), or the
    whole cache gathered after a per-slot write."""
    B, Sq, KV, G, hd = q.shape
    k_all, v_all = cache["k"], cache["v"]
    kf, vf = k.reshape(B, Sq, -1), v.reshape(B, Sq, -1)
    gathered = tp is not None and tp.gather_kv
    if gathered:
        kf, vf = (constrain(t, ("batch", "seq", "kv_heads"),
                            held=("batch", "seq", None)) for t in (kf, vf))
    split = kv_seq_block(k_all.shape[1])
    if split is not None:
        return _seq_split_decode(cfg, q, kf, vf, k_all, v_all, cache_index,
                                 split, window, positions, tp)
    write_rows(k_all, kf, cache_index)
    write_rows(v_all, vf, cache_index)
    if (paged_view is not None and cfg.use_paged_decode and Sq == 1
            and cache_index is not None and not cfg.prefix_lm):
        return _paged_decode_core(cfg, q, k_all, v_all, cache_index,
                                  paged_view, window)
    k_use, v_use = k_all, v_all
    if gathered:
        def whole(t):
            return constrain(t, ("batch", "kv_seq", None),
                             held=("batch", "kv_seq", "kv_heads"))

        if torch.is_tensor(cache_index) and cache_index.dim() >= 1:
            k_use, v_use = whole(k_all), whole(v_all)
        else:
            off = 0 if cache_index is None else int(cache_index)
            k_use, v_use = k.reshape(B, Sq, -1), v.reshape(B, Sq, -1)
            if off:
                k_use = torch.cat([whole(k_all[:, :off]), k_use], 1)
                v_use = torch.cat([whole(v_all[:, :off]), v_use], 1)
    S_use = k_use.shape[1]
    bias = attn_bias(positions, torch.arange(S_use, device=q.device),
                     window=window, prefix_len=_prefix_len(cfg))
    if bias.dim() == 2:
        bias = bias[None]
    k_use = k_use.reshape(B, S_use, -1, hd)
    v_use = v_use.reshape(B, S_use, -1, hd)
    if tp is not None:
        k_use, v_use = tp.kv_heads(k_use), tp.kv_heads(v_use)
    return _gqa_core(q, k_use, v_use, bias, cfg.attn_softcap)


def _seq_split_decode(cfg, q, kf, vf, k_all, v_all, cache_index, split,
                      window, positions, tp):
    """One decode token a slot over a cache whose rows the rules split over
    the data axes (``long_500k``: ``serve_rules(seq_shard=True)``; the
    rank holds rows [r * S_l, (r + 1) * S_l) of every slot, ``split`` =
    (the axes, r * S_l)), flash-decoding's way: the new row is written on
    the rank whose block holds the slot's index, at the local offset
    (``write_rows`` drops an offset outside the block, on the device); the
    rank scores its block at the keys' true positions under the layer's
    causal, window and softcap rules, and the ranks' partial softmaxes are
    merged exactly (``_merge_partials``).  The heads are the rank's, as
    in ``_dense_core``; ``kf``/``vf`` the new rows of the heads its cache
    holds.  The index is a scalar or a (B,) tensor, on any device (meta
    included), never read on the host."""
    B, Sq, KV, G, hd = q.shape
    if Sq != 1:
        raise NotImplementedError(
            f"{Sq} rows into a cache whose sequence the rules split over "
            f"{split[0]}: only a decode (one row a slot) runs there, as the "
            f"reference's long_500k cell")
    ci = cache_index
    if not torch.is_tensor(ci):
        ci = torch.full((B,), int(ci), device=q.device)
    elif ci.dim() == 0:
        ci = ci.expand(B)
    axes, start = split
    write_rows(k_all, kf, ci - start)
    write_rows(v_all, vf, ci - start)
    S_l = k_all.shape[1]
    k_use, v_use = k_all, v_all
    if tp is not None and tp.gather_kv:
        k_use, v_use = (constrain(t, ("batch", "kv_seq", None),
                                  held=("batch", "kv_seq", "kv_heads"))
                        for t in (k_all, v_all))
    k_use = k_use.reshape(B, S_l, -1, hd)
    v_use = v_use.reshape(B, S_l, -1, hd)
    if tp is not None:
        k_use, v_use = tp.kv_heads(k_use), tp.kv_heads(v_use)
    kv_pos = start + torch.arange(S_l, device=q.device)
    bias = attn_bias(positions, kv_pos, window=window,
                     prefix_len=_prefix_len(cfg))
    if bias.dim() == 2:
        bias = bias[None]
    m, l, o = _gqa_partial(q, k_use, v_use, bias, cfg.attn_softcap)
    return _merge_partials(m, l, o, axes, v_use.dtype)


def _prefix_len(cfg) -> int:
    """Keys every query sees: the prefix of a prefix-LM config."""
    return cfg.num_prefix_tokens if cfg.prefix_lm else 0


def _paged_decode_core(cfg, q, k_all, v_all, cache_index, paged_view,
                       window):
    """Decode attention over a dense cache read through the pool layout:
    the updated cache is split at each slot's cold boundary into hot pools
    (on the cache's device) and cold pools (pinned host memory on a card),
    addressed by a per-slot page table, and read by
    ``ops.paged_decode_attention``.  ``paged_view`` carries the per-slot
    ``boundaries`` (ints) and ``page_tokens``, or a precomputed
    ``layout`` (``paged_decode.pool_layout``), shared by every layer of a
    step."""
    B, Sq, KV, G, hd = q.shape
    Smax = k_all.shape[1]
    page = paged_view["page_tokens"]
    layout = paged_view.get("layout")
    if layout is None:
        layout = pool_layout(paged_view["boundaries"], Smax // page, page,
                             device=q.device)
    k_hot, v_hot, k_cold, v_cold = gather_pools(
        k_all.reshape(B, Smax, KV, hd), v_all.reshape(B, Smax, KV, hd),
        layout, page)
    ci = torch.as_tensor(cache_index, dtype=torch.int32, device=q.device)
    lengths = (ci if ci.dim() >= 1 else ci.expand(B)) + 1
    return kernel_ops.paged_decode_attention(
        q.reshape(B, KV * G, hd), k_hot, v_hot, k_cold, v_cold, layout[0],
        layout[1], lengths, window=window,
        softcap_val=cfg.attn_softcap)


def _pool_prefill_core(cfg, q, k, v, cache, cache_index, paged_view, window,
                       positions):
    """Suffix/chunk prefill straight into the persistent page pools.

    One admitted slot (B == 1), ``Sq`` prompt tokens starting at logical
    position ``cache_index`` (an int).  ``paged_view`` carries the slot's
    page-table row on the device (``page_table``/``page_tier``, (1, NP)) and
    on the host (``page_table_host``/``page_tier_host``).  The new rows are
    written into the slot's physical hot pages, then attention gathers the
    FULL table row back (Skv = NP * page = max_seq): hot pages from the
    device pool, cold pages by a host-side index into the pinned pool,
    copied to the card.  Rows beyond the valid region are finite stale data
    masked to exactly zero probability by ``attn_bias``.  The caller makes
    sure pending stream-ordered writes into the cold pool have landed
    before this host-side read (``PagedKVPools.sync_cold``).  Never
    reached under ``cfg.prefix_lm``: the engine builds no pools for such a
    config, so the mask here has no prefix term.
    """
    B, Sq, KV, G, hd = q.shape
    if B != 1:
        raise ValueError("pool prefill admits one slot at a time")
    page = paged_view["page_tokens"]
    row = paged_view["page_table"][0].long()             # (NP,) device
    pos = cache_index + torch.arange(Sq, device=q.device)
    phys = row[pos // page]                              # hot page per token
    off = pos % page
    k_hot, v_hot = cache["k_hot"], cache["v_hot"]
    # in place (the reference's .at[phys, off].set): the chunk's KV lands in
    # the slot's private hot pages
    k_hot[phys, off] = k.reshape(Sq, KV * hd)
    v_hot[phys, off] = v.reshape(Sq, KV * hd)

    k_all = k_hot[row.clamp(0, k_hot.shape[0] - 1)]      # (NP, page, KV*hd)
    v_all = v_hot[row.clamp(0, v_hot.shape[0] - 1)]
    tier_host = paged_view["page_tier_host"][0]
    cold = (tier_host == 1).nonzero().squeeze(1)         # logical cold pages
    if cold.numel():
        src = paged_view["page_table_host"][0][cold]
        dst = cold.to(q.device)
        k_all[dst] = cache["k_cold"][src].to(q.device, non_blocking=True)
        v_all[dst] = cache["v_cold"][src].to(q.device, non_blocking=True)
    Skv = k_all.shape[0] * page
    k_all = k_all.reshape(1, Skv, KV, hd)
    v_all = v_all.reshape(1, Skv, KV, hd)
    bias = attn_bias(positions, torch.arange(Skv, device=q.device),
                     window=window)
    if bias.dim() == 2:
        bias = bias[None]
    return _gqa_core(q, k_all, v_all, bias, cfg.attn_softcap)


def _pool_decode_core(cfg, q, k, v, cache, cache_index, paged_view, window,
                      positions=None):
    """Decode attention with the persistent page pools as the cache.

    ``paged_view`` carries the layer-independent page table / tier (B, NP)
    on the device, the active-slot mask and the garbage-page index.  The
    new token's KV is written into each slot's physical write page
    (inactive slots are redirected to the garbage page, so lockstep decode
    never corrupts a page a live slot references), then attention reads the
    pools through ops.paged_decode_attention.  Decode never writes below a
    cold boundary, so the cold pools are only read.  Never reached under
    ``cfg.prefix_lm`` (the engine builds no pools for it): K1 has no
    prefix mask.
    """
    B, Sq, KV, G, hd = q.shape
    if Sq != 1 or paged_view is None or cache_index is None:
        raise ValueError("pool decode takes one token per slot with a "
                         "paged_view and per-slot cache_index")
    page = paged_view["page_tokens"]
    table_arr = paged_view["page_table"]
    tier_arr = paged_view["page_tier"]
    ci = cache_index.to(torch.int32)
    rows = torch.arange(B, device=q.device)
    # stale lengths of finished slots may point one past the table: clamp,
    # as the reference's gather does (those slots write the garbage page)
    page_idx = (ci // page).clamp(max=table_arr.shape[1] - 1).long()
    phys = table_arr[rows, page_idx].long()
    active = paged_view.get("active")
    if active is not None:
        phys = torch.where(active, phys, paged_view["garbage_page"])
    off = (ci % page).long()
    k_hot, v_hot = cache["k_hot"], cache["v_hot"]
    # in place (the reference's .at[phys, off].set)
    k_hot[phys, off] = k.reshape(B, KV * hd)
    v_hot[phys, off] = v.reshape(B, KV * hd)

    def pool4(a):
        return a.view(a.shape[0], page, KV, hd)

    return kernel_ops.paged_decode_attention(
        q.reshape(B, KV * G, hd), pool4(k_hot), pool4(v_hot),
        pool4(cache["k_cold"]), pool4(cache["v_cold"]), table_arr, tier_arr,
        ci + 1, window=window, softcap_val=cfg.attn_softcap)


class MLA(nn.Module):
    AXES = {"wq": ("embed", "heads"), "w_dkv": ("embed", None),
            "w_krope": ("embed", None), "w_uk": (None, "heads"),
            "w_uv": (None, "heads"), "wo": ("heads", "embed")}
    """DeepSeek-V2 multi-head latent attention.  The cache holds the
    compressed latent {"ckv": (B, S, kv_lora_rank), "krope": (B, S,
    qk_rope_dim)} (one rope key shared by the heads); K and V are expanded
    from the latent at use time, as the reference's ``mla_attention``.

    Under a rank context the head-carrying leaves (``wq``, ``w_uk``,
    ``w_uv`` and ``wo``'s rows, each laid out head by head) are the rank's
    blocks, and ``w_dkv`` and ``w_krope`` are whole, so every rank
    computes the latent and the rope key whole.  Where the split falls on
    whole heads the rank runs its own heads; where it
    cuts one, the split products are gathered, every head runs, and the
    rank takes its block of the output back for its rows of ``wo``.  The
    output of ``wo`` is a partial sum, all-reduced.  The cache's latent is
    the rank's block of its columns (``kv_latent`` on ``model``): the rank
    writes its block of the new rows, then gathers the latent whole before
    the up-projections, as XLA gathers it for the reference's
    ``("batch", "kv_seq", None)`` constraint; the rope key is whole.  Under
    grad the replicated tensors entering the rank's share of the heads
    pass ``sharding.to_split``: ``x`` before ``wq``, the latent before
    ``w_uk`` and ``w_uv``, and the rope key (``_rank_latent``).  MLA is
    not subquadratic, so no ``long_500k`` cell reaches its latent cache:
    a cache whose rows the rules split over the data axes
    (``seq_shard``) raises, and no program is built for it."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
        dv, dc = cfg.v_head_dim, cfg.kv_lora_rank

        def w(*shape):
            return frozen(torch.empty(*shape, device=device, dtype=dtype))

        self.wq = w(d, H * (dn + dr))
        self.w_dkv, self.w_krope = w(d, dc), w(d, dr)
        self.w_uk, self.w_uv = w(dc, H * dn), w(dc, H * dv)
        self.wo = w(H * dv, d)

    def forward(self, cfg, x, positions, *, cache=None, cache_index=None):
        """x: (B, Sq, d).  ``cache``: None, or a dense {"ckv", "krope"}
        cache whose new rows are written in place at ``cache_index`` (a
        scalar offset, 0 when None, or a (B,) tensor of per-slot offsets)
        and which every query then reads whole under the causal mask."""
        B, Sq, _ = x.shape
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        tp = _rank_latent(cfg, self)
        q = (x if tp is None else to_split(x)) @ self.wq
        if tp == "gather":
            q = _heads_whole(q)
        q = q.reshape(B, Sq, -1, dn + dr)
        q_nope = q[..., :dn]
        q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
        ckv = x @ self.w_dkv                                   # (B, Sq, dc)
        krope = apply_rope((x @ self.w_krope)[:, :, None, :], positions,
                           cfg.rope_theta)[:, :, 0, :]         # (B, Sq, dr)
        if cache is not None:
            ckv_all, kr_all = cache["ckv"], cache["krope"]
            if kv_seq_block(ckv_all.shape[1]) is not None:
                raise NotImplementedError(
                    "MLA over a cache whose sequence the rules split "
                    "(seq_shard): MLA is not subquadratic, so no long_500k "
                    "cell reaches its latent cache")
            blocked = ckv_all.shape[-1] < ckv.shape[-1]
            # the rank's block of the latent's columns, as its cache holds
            # them
            write_rows(ckv_all, constrain(
                ckv, ("batch", "kv_seq", "kv_latent"),
                held=("batch", "kv_seq", None)) if blocked else ckv,
                cache_index)
            write_rows(kr_all, krope, cache_index)
            if blocked:
                ckv_all, kr_all = _whole_latent(ckv_all, kr_all, ckv,
                                                cache_index)
            kv_pos = torch.arange(ckv_all.shape[1], device=x.device)
        else:
            ckv_all, kr_all = ckv, krope
            kv_pos = positions[0] if positions.dim() > 1 else positions
        Skv = ckv_all.shape[1]
        if tp is not None:
            # replicated, entering the rank's share of the heads
            ckv_all, kr_all = to_split(ckv_all), to_split(kr_all)
        k_nope, v = ckv_all @ self.w_uk, ckv_all @ self.w_uv
        if tp == "gather":
            k_nope, v = _heads_whole(k_nope), _heads_whole(v)
        k_nope = k_nope.reshape(B, Skv, -1, dn)
        v = v.reshape(B, Skv, -1, dv)
        scale = (dn + dr) ** -0.5
        scores = (torch.einsum("bqhd,bshd->bhqs", q_nope.float(),
                               k_nope.float())
                  + torch.einsum("bqhd,bsd->bhqs", q_rope.float(),
                                 kr_all.float())) * scale
        bias = attn_bias(positions, kv_pos)
        scores = scores + (bias[None] if bias.dim() == 2 else bias[:, None])
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype), v)
        out = out.reshape(B, Sq, -1)
        if tp == "gather":
            # every head ran: the rank's block for its rows of wo
            out = constrain(out, ("batch", "seq", "heads"),
                            held=("batch", "seq", None))
        return to_residual(out @ self.wo, partial=tp is not None)


def _rank_latent(cfg, mla):
    """How an MLA layer runs under the current rank context: None where
    there is none or the rules split none of its head-carrying leaves;
    "heads" where they split into the same whole heads (the rank runs its
    own); "gather" where the split cuts a head (the model axis does not
    divide the heads), so q, k and v are gathered and every head runs."""
    if current_rank() is None:
        return None
    H, dn, dr, dv = (cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    cols = (mla.wq.shape[1], mla.w_uk.shape[1], mla.w_uv.shape[1],
            mla.wo.shape[0])
    split = [c < f for c, f in zip(cols, (H * (dn + dr), H * dn, H * dv,
                                          H * dv))]
    if not any(split):
        return None
    if not all(split):
        raise NotImplementedError(
            f"an MLA layer whose head-carrying leaves the model axis splits "
            f"only in part ({cols} columns)")
    Hl = cols[0] // (dn + dr)
    whole = cols == (Hl * (dn + dr), Hl * dn, Hl * dv, Hl * dv)
    return "heads" if whole else "gather"


def _heads_whole(t):
    """The rank's block of a split head-carrying product, gathered whole
    over ``model``."""
    return constrain(t, ("batch", "seq", None),
                     held=("batch", "seq", "heads"))


def _whole_latent(ckv_cache, kr_cache, ckv, cache_index):
    """The latent and rope key to attend over, from a cache whose latent
    is the rank's block of the columns (the new rows already written):
    after a per-slot write the whole cache, its latent gathered; at a
    scalar offset the rows up to the new ones' end, the earlier rows'
    latent gathered and the new rows' whole latent after them (rows past
    them are masked, so a prefill gathers nothing)."""
    def gathered(t):
        return constrain(t, ("batch", "kv_seq", None),
                         held=("batch", "kv_seq", "kv_latent"))

    if torch.is_tensor(cache_index) and cache_index.dim() >= 1:
        return gathered(ckv_cache), kr_cache
    off = 0 if cache_index is None else int(cache_index)
    end = off + ckv.shape[1]
    if off:
        ckv = torch.cat([gathered(ckv_cache[:, :off]), ckv], dim=1)
    return ckv, kr_cache[:, :end]
