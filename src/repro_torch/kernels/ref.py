"""Plain PyTorch versions of the kernels (the CPU execution path, and what
each CUDA kernel is held against on the card).

Ports of the oracles ``repro/kernels/ref.py::attention_ref`` (flash
attention) and ``decode_attention_ref`` (flash decode), with the same
finite ``NEG_INF``, f32 scores and p cast to v's dtype before P.V; of
``repro/kernels/decode_attention.py::masked_scores`` /
``online_softmax_update`` and ``repro/kernels/ref.py::
paged_decode_attention_ref``, with the same op order, the same ``NEG_INF``
and the same clipping of physical page indices (with, beside it, the split
over page ranges and the merge that the paged decode kernel computes); and
of the Mamba2 SSD oracles ``ssd_ref`` (sequential), ``ssd_chunked_ref``
(the chunked algorithm the SSD kernel computes) and ``ssd_decode_ref`` (one
decode step, which has no kernel in either package); and of the xLSTM
oracles ``mlstm_ref`` (sequential), ``mlstm_chunked_ref`` and ``slstm_ref``,
which are the op itself on every device, in both packages.  And the
algorithm of the fused AdamW pass ``csrc/adamw.cu`` (``adamw_fused_ref``),
which replaces no Pallas kernel: the JAX package's update is XLA's.

``step_loop`` runs the token-by-token loops (the sequential mLSTM and the
sLSTM here, the LSTM in ``models/xlstm.py``): every trip, except under
``launch/costing.step_cost``'s op counter or the dry run's collective
``Trips`` (``launch/dryrun.rank_collectives``), which have it count one
trip as many, as the reference's costing multiplies a scan body by its
length.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels import adamw as fused

NEG_INF = -2.0 ** 20

# launch/costing.py's op counter while one is active on this thread
# (``counting``); None otherwise
_COUNTER = threading.local()


def counting(counter):
    """Register ``counter`` (an object with a ``scale`` attribute that
    multiplies what it counts), or None, as this thread's op counter."""
    _COUNTER.active = counter


def step_loop(step, carry: tuple, xs: tuple, n: int, consts: tuple = ()):
    """``carry, out = step(t, carry, x_t, consts)`` for t < n, x_t the
    tuple of each ``xs`` tensor's row t (dim 0, time first); returns (the
    last carry, the n outputs).  ``consts``: the tensors ``step`` reads
    that may take a gradient (``step`` may read others from its closure).

    Under an op counter (``counting``) trip 0 runs, then trip 1 once under
    the counter's scale n - 1, its backward too (``_ScaledTrip``), and
    trip 1's carry and output stand for the rest: the counts are a whole
    loop's, the values are not."""
    counter = getattr(_COUNTER, "active", None)
    outs = []
    for t in range(n if counter is None else min(n, 1)):
        carry, out = step(t, carry, tuple(x[t] for x in xs), consts)
        outs.append(out)
    if counter is None or n < 2:
        return carry, outs
    flat = _ScaledTrip.apply(step, counter, n - 1, len(carry), len(xs),
                             *carry, *(x[1] for x in xs), *consts)
    carry, out = tuple(flat[:len(carry)]), flat[-1]
    # the n - 1 outputs as views of one expanded tensor: a backward through
    # them sums their gradients in one op, where n - 1 references to
    # ``out`` itself would accumulate them in n - 2 adds
    rest = out.unsqueeze(0).expand(n - 1, *out.shape).unbind(0)
    return carry, outs + list(rest)


class _ScaledTrip(torch.autograd.Function):
    """Trip 1 of a ``step_loop`` counted ``times`` times: its forward under
    the counter's scale ``times``; its backward recomputes the trip
    uncounted (scale 0) and runs the trip's backward under the scale
    ``times`` again."""

    @staticmethod
    def forward(ctx, step, counter, times, n_carry, n_x, *tensors):
        ctx.set_materialize_grads(False)
        ctx.step, ctx.counter, ctx.times = step, counter, times
        ctx.split = (n_carry, n_x)
        ctx.save_for_backward(*tensors)
        with _scaled(counter, times):
            return _trip(step, tensors, n_carry, n_x)

    @staticmethod
    def backward(ctx, *grads):
        n_carry, n_x = ctx.split
        need = ctx.needs_input_grad[5:]
        ins = [t.detach().requires_grad_(r)
               for t, r in zip(ctx.saved_tensors, need)]
        with _scaled(ctx.counter, 0), torch.enable_grad():
            outs = _trip(ctx.step, ins, n_carry, n_x)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [t for t in ins if t.requires_grad]
        got = iter(())
        if pairs and wrt:
            with _scaled(ctx.counter, ctx.times):
                got = iter(torch.autograd.grad(
                    [o for o, _ in pairs], wrt, [g for _, g in pairs],
                    allow_unused=True))
        return (None,) * 5 + tuple(next(got, None) if t.requires_grad
                                   else None for t in ins)


def _trip(step, tensors, n_carry: int, n_x: int) -> tuple:
    carry = tuple(tensors[:n_carry])
    x = tuple(tensors[n_carry:n_carry + n_x])
    carry, out = step(1, carry, x, tuple(tensors[n_carry + n_x:]))
    return (*carry, out)


@contextlib.contextmanager
def _scaled(counter, times):
    """The counter's scale multiplied by ``times`` for the body."""
    prev = counter.scale
    counter.scale = prev * times
    try:
        yield
    finally:
        counter.scale = prev


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap_val: float = 0.0, scale: float | None = None):
    """Plain softmax attention, the oracle of flash attention.  q: (B, Sq,
    H, D); k, v: (B, Skv, KVH, D) with H % KVH == 0; queries right-aligned
    to the end of the KV timeline.  Scores in f32; p is cast to v's dtype
    before P.V.  A row with no visible key (causal, Sq > Skv) scores NEG_INF
    everywhere, so its softmax is uniform: the mean of v over all Skv keys."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = D ** -0.5 if scale is None else scale
    qg = q.reshape(B, Sq, KVH, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if softcap_val:
        s = softcap_val * torch.tanh(s / softcap_val)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= (qpos - kpos) < window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, D)


def decode_attention_ref(q, k_cache, v_cache, lengths, *, window: int = 0,
                         softcap_val: float = 0.0):
    """Single-token decode, the oracle of flash decode.  q: (B, H, D);
    caches (B, S, KVH, D); lengths (B,) int32, the valid cache entries per
    slot.  A slot with no visible key (length 0) takes the mean of v over
    all S rows, as the oracle's uniform softmax gives."""
    B, H, D = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) \
        * (D ** -0.5)
    if softcap_val:
        s = softcap_val * torch.tanh(s / softcap_val)
    kpos = torch.arange(S, device=q.device)[None, :]
    length = lengths[:, None]
    ok = kpos < length
    if window:
        ok &= kpos >= (length - window)
    s = torch.where(ok[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, H, D)


def masked_scores(q, k, base, length, *, window: int, softcap_val: float):
    """QK^T scores for one KV block, scaled/softcapped/length-masked.

    q: (..., G, D); k: (..., bk, D); base: first key position of the block;
    length: scalar or a tensor broadcast over the leading dims of q.
    """
    s = torch.matmul(q, k.transpose(-1, -2))
    s = s * (q.shape[-1] ** -0.5)
    if softcap_val:
        s = softcap_val * torch.tanh(s / softcap_val)
    kpos = base + torch.arange(s.shape[-1], dtype=torch.int32, device=s.device)
    length = torch.as_tensor(length, device=s.device)
    length = length.reshape(length.shape + (1,) * (s.ndim - length.ndim))
    ok = kpos < length
    if window:
        ok &= kpos >= (length - window)
    return torch.where(ok, s, NEG_INF)


def online_softmax_update(s, v, acc, m, l):
    """One online-softmax block update. s: (..., G, bk); v: (..., bk, D);
    state acc: (..., G, D), m/l: (..., G). Returns (acc, m, l)."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.matmul(p, v)
    return acc_new, m_new, l_new


def _page(pool_hot, pool_cold, page_table, page_tier, i):
    """Logical page i of every slot, (B, KVH, page, D) in f32: tier 0 from
    the hot pool, any other tier from the cold pool, each physical index
    clipped into its pool."""
    phys = page_table[:, i].long()
    hot = pool_hot[phys.clamp(0, pool_hot.shape[0] - 1)]
    cold = pool_cold[phys.clamp(0, pool_cold.shape[0] - 1)]
    pg = torch.where((page_tier[:, i] == 0)[:, None, None, None], hot, cold)
    return pg.transpose(1, 2).float()


def paged_decode_attention_ref(q, k_hot, v_hot, k_cold, v_cold, page_table,
                               page_tier, lengths, *, window: int = 0,
                               softcap_val: float = 0.0):
    """The flash-decode page loop of kernels/paged_decode.py in plain torch,
    vectorized over (batch, kv_head).  All tensors on one device.

    q: (B, H, D); pools (n, page, KVH, D); page_table/page_tier (B, NP);
    lengths (B,).  Every logical page is visited: a fully masked page scores
    NEG_INF everywhere, whose exp underflows to exactly 0.0 in float32 once
    a valid page has set the running max, so unmapped pages (and, under
    ``window``, the skipped cold prefix) contribute nothing.
    """
    B, H, D = q.shape
    page, KVH = k_hot.shape[1], k_hot.shape[2]
    NP = page_table.shape[1]
    G = H // KVH
    qg = q.reshape(B, KVH, G, D).float()
    lengths = lengths.to(torch.int32)

    acc = torch.zeros(B, KVH, G, D, dtype=torch.float32, device=q.device)
    m = torch.full((B, KVH, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(B, KVH, G, dtype=torch.float32, device=q.device)
    for i in range(NP):
        k = _page(k_hot, k_cold, page_table, page_tier, i)
        v = _page(v_hot, v_cold, page_table, page_tier, i)
        s = masked_scores(qg, k, i * page, lengths, window=window,
                          softcap_val=softcap_val)
        acc, m, l = online_softmax_update(s, v, acc, m, l)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype).reshape(B, H, D)


def paged_decode_split_ref(q, k_hot, v_hot, k_cold, v_cold, page_table,
                           page_tier, lengths, *, n_split: int,
                           window: int = 0, softcap_val: float = 0.0):
    """The split-and-combine algorithm of the paged decode kernel
    (csrc/paged_decode.cu) in plain torch: split s of ``n_split`` owns
    logical pages [s P, s P + P), P = ceil(NP / n_split), and visits those
    of them in the slot's [lo, npages) (lo the first page in the window);
    its partial (o, m, l) starts at (0, NEG_INF, 0) and takes the online
    softmax update of each visited page.  The partials merge as the combine
    kernel merges them: m = max m_i, o = sum exp(m_i - m) o_i / max(sum
    exp(m_i - m) l_i, 1e-30).  Equal to ``paged_decode_attention_ref`` to
    f32 rounding wherever a slot sees a key."""
    B, H, D = q.shape
    page, KVH = k_hot.shape[1], k_hot.shape[2]
    NP = page_table.shape[1]
    G = H // KVH
    qg = q.reshape(B, KVH, G, D).float()
    lengths = lengths.to(torch.int32)
    npages = torch.clamp((lengths + page - 1) // page, max=NP)
    lo = torch.clamp((lengths - window) // page, min=0) if window \
        else torch.zeros_like(lengths)

    per = -(-NP // n_split)
    parts = []
    for s in range(n_split):
        acc = torch.zeros(B, KVH, G, D, dtype=torch.float32, device=q.device)
        m = torch.full((B, KVH, G), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(B, KVH, G, dtype=torch.float32, device=q.device)
        for i in range(s * per, min(NP, s * per + per)):
            visit = ((i >= lo) & (i < npages))[:, None, None]      # (B,1,1)
            k = _page(k_hot, k_cold, page_table, page_tier, i)
            v = _page(v_hot, v_cold, page_table, page_tier, i)
            sc = masked_scores(qg, k, i * page, lengths, window=window,
                               softcap_val=softcap_val)
            a2, m2, l2 = online_softmax_update(sc, v, acc, m, l)
            acc = torch.where(visit[..., None], a2, acc)
            m, l = torch.where(visit, m2, m), torch.where(visit, l2, l)
        parts.append((acc, m, l))
    m_all = torch.stack([p[1] for p in parts]).amax(dim=0)
    o = torch.zeros_like(parts[0][0])
    l_all = torch.zeros_like(parts[0][2])
    for acc, m, l in parts:
        w = torch.exp(m - m_all)
        o = o + w[..., None] * acc
        l_all = l_all + w * l
    out = o / torch.clamp(l_all, min=1e-30)[..., None]
    return out.to(q.dtype).reshape(B, H, D)


def decode_attention_split_ref(q, k_cache, v_cache, lengths, *,
                               n_split: int, window: int = 0,
                               softcap_val: float = 0.0):
    """The split-and-merge algorithm of the flash decode kernel
    (csrc/decode_attention.cu) in plain torch: split s of ``n_split`` owns
    keys [s per, s per + per), per = ceil(S / n_split), and its partial
    (o, m, l) folds the keys of that range in the slot's visible range
    [lo, hi) (lo = max(0, len - window) with a window, else 0; hi =
    min(len, S)), p kept in f32.  A split whose range misses [lo, hi)
    gives the empty partial, o = 0, m = NEG_INF, l = 0, which adds nothing
    to the merge's sums.  A slot with no visible key
    (R5) sums every split's range of v with weight p = 1/S rounded to v's
    dtype, m = 0 and l = 1 on split 0 only, so the merge gives the oracle's
    mean of v over all S rows.  The merge: m = max m_i, o = sum exp(m_i -
    m) o_i / max(sum exp(m_i - m) l_i, 1e-30).  Equal to
    ``decode_attention_ref`` to f32 rounding in f32."""
    B, H, D = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, D).float()
    k, v = k_cache.float(), v_cache.float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * (D ** -0.5)
    if softcap_val:
        s = softcap_val * torch.tanh(s / softcap_val)
    n = lengths.to(torch.int64)
    hi = torch.clamp(n, max=S)
    lo = torch.clamp(n - window, min=0) if window else torch.zeros_like(n)
    uniform = hi <= lo                                       # (B,)
    dev = q.device
    p_u = torch.tensor(1.0 / S, device=dev).to(v_cache.dtype).float()
    kpos = torch.arange(S, device=dev)
    per = -(-S // n_split)
    m_all = torch.full((B, KVH, G), NEG_INF, device=dev)
    parts = []
    for i in range(n_split):
        a, e = i * per, min(S, i * per + per)
        if a >= e:
            continue
        pos = kpos[None, a:e]
        vis = (pos >= lo[:, None]) & (pos < hi[:, None])
        sc = torch.where(vis[:, None, None], s[..., a:e], NEG_INF)
        m = sc.amax(dim=-1)
        p = torch.where(vis[:, None, None], torch.exp(sc - m[..., None]), 0.0)
        l = p.sum(dim=-1)
        o = torch.einsum("bkgs,bskd->bkgd", p, v[:, a:e])
        o_u = (p_u * v[:, a:e].sum(dim=1))[:, :, None, :].expand_as(o)
        u = uniform[:, None, None]
        o = torch.where(u[..., None], o_u, o)
        m = torch.where(u, 0.0, m)
        l = torch.where(u, 1.0 if i == 0 else 0.0, l)
        parts.append((o, m, l))      # no visible key: (0, NEG_INF, 0)
        m_all = torch.maximum(m_all, m)
    o_sum = torch.zeros(B, KVH, G, D, device=dev)
    l_sum = torch.zeros(B, KVH, G, device=dev)
    for o, m, l in parts:
        w = torch.exp(m - m_all)
        o_sum = o_sum + w[..., None] * o
        l_sum = l_sum + w * l
    out = o_sum / torch.clamp(l_sum, min=1e-30)[..., None]
    return out.to(q.dtype).reshape(B, H, D)


# ------------------------------------------------------------ mamba2 SSD ----

def ssd_ref(x, dt, A, Bm, Cm, *, h0=None):
    """Sequential oracle.  x: (B,S,H,P); dt: (B,S,H); A: (H,) (negative);
    Bm, Cm: (B,S,N).  Returns (y (B,S,H,P) in x's dtype, h_final (B,H,P,N)
    in float32)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    A = A.float()
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].float(), dt[:, t].float()
        bt, ct = Bm[:, t].float(), Cm[:, t].float()
        a = torch.exp(dtt * A)                                  # (B,H)
        h = h * a[..., None, None] + torch.einsum("bhp,bn,bh->bhpn", xt, bt,
                                                  dtt)
        ys.append(torch.einsum("bhpn,bn->bhp", h, ct))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunked_ref(x, dt, A, Bm, Cm, *, chunk: int = 64, h0=None):
    """Chunked (SSD-algorithm) oracle, the matmul-heavy formulation: same
    I/O as ``ssd_ref`` and equal to it to float tolerance.  A ragged tail is
    padded with dt = 0, which is neutral (decay 1, no state contribution)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    K = (S + pad) // Q
    xc = x.reshape(B, K, Q, H, P).float()
    dtc = dt.reshape(B, K, Q, H).float()
    Bc = Bm.reshape(B, K, Q, N).float()
    Cc = Cm.reshape(B, K, Q, N).float()

    l = torch.cumsum(dtc * A.float(), dim=2)            # inclusive, (B,K,Q,H)
    total = l[:, :, -1, :]                              # (B,K,H)

    # intra-chunk: G[t,s] = (C_t . B_s) exp(l_t - l_s) dt_s, s <= t.  The
    # exponent is masked BEFORE the exp: for s > t it is positive and can
    # overflow.
    CB = torch.einsum("bktn,bksn->bkts", Cc, Bc)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    diff = l[:, :, :, None, :] - l[:, :, None, :, :]    # (B,K,t,s,H)
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  float("-inf")))
    G = CB[..., None] * decay * dtc[:, :, None, :, :]
    y = torch.einsum("bktsh,bkshp->bkthp", G, xc)

    # inter-chunk: the state h (B,H,P,N) carried across chunks in order
    h = torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    y_inter = []
    for k in range(K):
        lk, tot = l[:, k], total[:, k]
        y_inter.append(torch.einsum("btn,bhpn->bthp", Cc[:, k], h)
                       * torch.exp(lk)[..., None])
        w = torch.exp(tot[:, None, :] - lk) * dtc[:, k]       # (B,Q,H)
        h = h * torch.exp(tot)[:, :, None, None] + \
            torch.einsum("bthp,btn,bth->bhpn", xc[:, k], Bc[:, k], w)
    y = (y + torch.stack(y_inter, dim=1)).reshape(B, K * Q, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_decode_ref(h, xt, dtt, A, bt, ct):
    """One decode step.  h: (B,H,P,N); xt: (B,H,P); dtt: (B,H); bt, ct:
    (B,N).  Returns (y (B,H,P) in xt's dtype, h' float32)."""
    a = torch.exp(dtt.float() * A)
    h = h.float() * a[..., None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", xt.float(), bt.float(), dtt.float())
    y = torch.einsum("bhpn,bn->bhp", h, ct.float())
    return y.to(xt.dtype), h


def round_operand(t, operands: str):
    """An f32 operand of the SSD kernel's tensor-core products as the
    kernel rounds it: "f32" as it is; "bf16x2" split into a bf16 high part
    and a bf16 low part (t - high), their sum (each part multiplies the
    bf16 operand exactly; the pair keeps about 2**-16 of t); "tf32" rounded
    to 10 mantissa bits, to nearest."""
    if operands == "f32":
        return t
    if operands == "bf16x2":
        hi = t.to(torch.bfloat16).float()
        return hi + (t - hi).to(torch.bfloat16).float()
    if operands == "tf32":
        i = t.float().contiguous().view(torch.int32)
        return ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    raise ValueError(f"operands {operands!r} is not f32, bf16x2 or tf32")


def _ssd_chunk(x, dt, A, Bm, Cm, h, operands, want_y):
    """One chunk of the SSD kernel's scan, f32, its f32 operands rounded by
    ``operands``: x (B,Q,H,P), dt (B,Q,H), Bm/Cm (B,Q,N), state h (B,H,P,N)
    at the chunk's start.  Returns (y (B,Q,H,P) or None, h at its end, the
    chunk's total log-decay (B,H))."""
    l = torch.cumsum(dt * A, dim=1)                      # inclusive, (B,Q,H)
    lT = l[:, -1]
    y = None
    if want_y:
        Q = x.shape[1]
        CB = torch.einsum("btn,bsn->bts", Cm, Bm)
        mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
        diff = l[:, :, None, :] - l[:, None, :, :]        # (B,t,s,H)
        decay = torch.exp(torch.where(mask[None, :, :, None], diff,
                                      float("-inf")))
        G = round_operand(CB[..., None] * decay * dt[:, None], operands)
        y = torch.einsum("btsh,bshp->bthp", G, x) + torch.exp(l)[..., None] \
            * torch.einsum("btn,bhpn->bthp", Cm, round_operand(h, operands))
    w = torch.exp(lT[:, None, :] - l) * dt                # (B,Q,H)
    wx = round_operand(w[..., None] * x, operands)
    h = h * torch.exp(lT)[:, :, None, None] + \
        torch.einsum("bshp,bsn->bhpn", wx, Bm)
    return y, h, lT


def ssd_split_ref(x, dt, A, Bm, Cm, *, segments: int, chunk: int = 64,
                  h0=None, operands: str = "f32"):
    """The segmented scan of the SSD tensor-core kernel (csrc/ssd.cu) in
    plain torch.  The sequence is cut into ``chunk``-token chunks (a ragged
    tail padded with dt = 0) and the chunks into segments of cps =
    ceil(chunks / segments) chunks (so ceil(chunks / cps) segments):
      1. each segment but the last runs the state update alone from a zero
         state, giving its state dS_k and its total log-decay L_k;
      2. h runs through those segments in order from h0 (or 0), h =
         exp(L_k) h + dS_k, and a segment starts from the h the segments
         before it give;
      3. each segment runs the full chunked scan from its start state and
         writes its y; the last one's end state is h.
    ``operands`` rounds the f32 operands of the kernel's products (the
    masked weights G, the decay-weighted x of the state update, and h in
    C h^T) as ``round_operand`` does.  Same I/O as ``ssd_chunked_ref``,
    and equal to it to f32 rounding with ``operands="f32"``."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    xc = x.reshape(B, nc, chunk, H, P).float()
    dtc = dt.reshape(B, nc, chunk, H).float()
    Bc = Bm.reshape(B, nc, chunk, N).float()
    Cc = Cm.reshape(B, nc, chunk, N).float()
    A = A.float()
    cps = -(-nc // max(1, min(segments, nc)))
    n_seg = -(-nc // cps)

    def run(c0, c1, h, want_y):
        ys, total = [], torch.zeros(B, H, device=x.device)
        for c in range(c0, min(nc, c1)):
            y, h, lT = _ssd_chunk(xc[:, c], dtc[:, c], A, Bc[:, c], Cc[:, c],
                                  h, operands, want_y)
            ys.append(y)
            total = total + lT
        return ys, h, total

    zero = torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device)
    h = zero if h0 is None else h0.float()
    starts = [h]
    for k in range(n_seg - 1):                            # passes 1 and 2
        _, dS, L = run(k * cps, k * cps + cps, zero, False)
        h = torch.exp(L)[:, :, None, None] * h + dS
        starts.append(h)
    ys = []
    for k in range(n_seg):                                # pass 3
        y, h, _ = run(k * cps, k * cps + cps, starts[k], True)
        ys += y
    y = torch.stack(ys, dim=1).reshape(B, nc * chunk, H, P)[:, :S]
    return y.to(x.dtype), h


# ----------------------------------------------------------------- xLSTM ----

def _mlstm_state(B, H, Dk, Dv, device, state):
    """(C, n, m) float32: the given state, or the empty one (m = -inf)."""
    if state is not None:
        return tuple(s.float() for s in state)
    return (torch.zeros(B, H, Dk, Dv, dtype=torch.float32, device=device),
            torch.zeros(B, H, Dk, dtype=torch.float32, device=device),
            torch.full((B, H), float("-inf"), dtype=torch.float32,
                       device=device))


def mlstm_ref(q, k, v, log_i, log_f, *, state=None):
    """Sequential stabilized mLSTM oracle (xLSTM eq. 19-27).

    q, k: (B,S,H,Dk); v: (B,S,H,Dv); log_i, log_f: (B,S,H) pre-activation
    gate logs (log_f = logsigmoid(f_pre), log_i = i_pre).  Returns (h
    (B,S,H,Dv) in v's dtype, the final state (C, n, m)) with C (B,H,Dk,Dv),
    n (B,H,Dk) and m (B,H), all float32.  The first step from the empty
    state (m = -inf) defines the forget weight f_p as 0."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    scale = Dk ** -0.5

    def step(t, carry, x, consts):
        C, n, m = carry
        qt, kt, vt = x[0].float(), x[1].float() * scale, x[2].float()
        li, lf = x[3].float(), x[4].float()
        m_new = torch.maximum(lf + m, li)
        i_p = torch.exp(li - m_new)
        f_p = torch.where(torch.isfinite(m), torch.exp(lf + m - m_new), 0.0)
        # the outer product as a batched product of inner dim 1, the
        # reference's dot_general (an einsum without a contracted dim is a
        # broadcast multiply here, which the costing counts as elementwise)
        kv = torch.bmm(kt.reshape(B * H, Dk, 1), vt.reshape(B * H, 1, Dv))
        C = C * f_p[..., None, None] + i_p[..., None, None] * \
            kv.view(B, H, Dk, Dv)
        n = n * f_p[..., None] + i_p[..., None] * kt
        num = torch.einsum("bhkv,bhk->bhv", C, qt)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qt).abs(),
                            torch.exp(-m_new))
        return (C, n, m_new), num / den[..., None]

    (C, n, m), hs = step_loop(
        step, _mlstm_state(B, H, Dk, Dv, q.device, state),
        tuple(t.transpose(0, 1) for t in (q, k, v, log_i, log_f)), S)
    return torch.stack(hs, dim=1).to(v.dtype), (C, n, m)


def mlstm_chunked_ref(q, k, v, log_i, log_f, *, chunk: int = 64,
                      state=None):
    """Chunkwise-parallel stabilized mLSTM, equal to ``mlstm_ref`` to float
    tolerance (the reference's ``mlstm_chunked_ref``).  Per chunk of length
    L, with the cumulative forget F_t, u_s = li_s - F_s, the running max
    g_t of u and M_t = max(m_prev, g_t):

        h_t = exp(m_prev - M_t) (q_t C_prev)
              + sum_{s<=t} exp(u_s - M_t) (q_t . k_s) v_s
        den_t = max(|n_t . q_t|, exp(-(F_t + M_t)))
        C' = exp(m_prev - M_L) C_prev + sum_s exp(u_s - M_L) k_s v_s^T
        m' = F_L + M_L

    so only one state a chunk is carried (and saved by autograd), and the
    work inside a chunk is (L x L) masked products.  S must be whole
    chunks of min(chunk, S)."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    L = min(chunk, S)
    assert S % L == 0
    K = S // L
    scale = Dk ** -0.5
    C, n, m = _mlstm_state(B, H, Dk, Dv, q.device, state)
    qc = q.reshape(B, K, L, H, Dk).float()
    kc = k.reshape(B, K, L, H, Dk).float() * scale
    vc = v.reshape(B, K, L, H, Dv).float()
    F_ = torch.cumsum(log_f.reshape(B, K, L, H).float(), dim=2)
    u = log_i.reshape(B, K, L, H).float() - F_
    g = torch.cummax(u, dim=2).values
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=q.device))
    hs = []
    for c in range(K):
        qk_, kk, vk = qc[:, c], kc[:, c], vc[:, c]
        Fk, uk, gk = F_[:, c], u[:, c], g[:, c]
        M = torch.maximum(m[:, None, :], gk)                  # (B,L,H)
        w_state = torch.where(torch.isfinite(m)[:, None, :],
                              torch.exp(m[:, None, :] - M), 0.0)
        # W[t, s] = exp(u_s - M_t) for s <= t (masked before the exp)
        diff = uk[:, None, :, :] - M[:, :, None, :]           # (B,t,s,H)
        W = torch.exp(torch.where(mask[None, :, :, None], diff,
                                  float("-inf")))
        scores = torch.einsum("bthd,bshd->btsh", qk_, kk)
        num = torch.einsum("btsh,bshv->bthv", scores * W, vk) + \
            torch.einsum("bthd,bhdv->bthv", qk_, C) * w_state[..., None]
        nvec = torch.einsum("btsh,bshd->bthd", W, kk) + \
            n[:, None] * w_state[..., None]
        den = torch.maximum(torch.einsum("bthd,bthd->bth", nvec, qk_).abs(),
                            torch.exp(-(Fk + M)))
        hs.append(num / den[..., None])
        ML = torch.maximum(m, gk[:, -1])                      # (B,H)
        ws = torch.exp(torch.where(torch.isfinite(m), m - ML,
                                   float("-inf")))
        wk = torch.exp(uk - ML[:, None, :])                   # (B,L,H)
        # two operands: a three-operand einsum may contract k and v first,
        # into an (L, H, Dk, Dv) outer product
        C = C * ws[..., None, None] + torch.einsum(
            "bshd,bshv->bhdv", kk * wk[..., None], vk)
        n = n * ws[..., None] + torch.einsum("bshd,bsh->bhd", kk, wk)
        m = Fk[:, -1] + ML
    h = torch.stack(hs, dim=1).reshape(B, S, H, Dv)
    return h.to(v.dtype), (C, n, m)


def slstm_ref(x_ifzo, *, state=None, r_ifzo=None):
    """Sequential sLSTM with the exponential input gate and the
    normalizer/stabilizer.  x_ifzo: (B,S,H,4,D) pre-activations of i, f, z,
    o per head; r_ifzo: optional recurrent weights (H,4,D,D) applied to
    h_{t-1}.  Returns (h (B,S,H,D) in x_ifzo's dtype, the final state (c,
    n, m, h), each (B,H,D) float32, m = -inf in the empty state).

    The loop runs heads first, (H, B, D), with the recurrent weights laid
    out once as one (H, D, 4D) matrix a head, so a step's slices and its
    recurrent product copy nothing (an einsum over the (H, 4, D, D) tensor
    would copy it into that layout at every step, and autograd would keep
    every copy).  Only the first step can meet m = -inf: its forget weight
    is defined as 0 there, and every later m is finite."""
    B, S, H, _, D = x_ifzo.shape
    dev = x_ifzo.device
    if state is None:
        z = torch.zeros(H, B, D, dtype=torch.float32, device=dev)
        c, n, h = z, z, z
        m = torch.full((H, B, D), float("-inf"), dtype=torch.float32,
                       device=dev)
    else:
        c, n, m, h = (s.float().transpose(0, 1) for s in state)
    xs = x_ifzo.float().permute(1, 2, 0, 3, 4)           # (S, H, B, 4, D)
    r = None if r_ifzo is None else \
        r_ifzo.float().permute(0, 2, 1, 3).reshape(H, D, 4 * D)
    one = torch.ones((), dtype=torch.float32, device=dev)

    def step(t, carry, x, consts):
        c, n, m, h = carry
        pre = x[0]
        if consts:
            pre = pre + torch.bmm(h, consts[0]).view(H, B, 4, D)
        i_p, f_p, z_p, o_p = pre.unbind(dim=2)
        lfm = F.logsigmoid(f_p) + m
        m_new = torch.maximum(lfm, i_p)
        i_g = torch.exp(i_p - m_new)
        f_g = torch.exp(lfm - m_new)
        if t == 0:
            f_g = torch.where(torch.isfinite(m), f_g, 0.0)
        c = f_g * c + i_g * torch.tanh(z_p)
        n = f_g * n + i_g
        h = torch.sigmoid(o_p) * c / torch.maximum(n, one)
        return (c, n, m_new, h), h

    (c, n, m, h), hs = step_loop(step, (c, n, m, h), (xs,), S,
                                 () if r is None else (r,))
    out = torch.stack(hs, dim=0).permute(2, 0, 1, 3)     # (B, S, H, D)
    return out.to(x_ifzo.dtype), tuple(s.transpose(0, 1)
                                       for s in (c, n, m, h))


# ---------------------------------------------------------------- AdamW ----

def _strided(x, threads: int):
    """Thread t's sum of x[t], x[t + threads], ... in that order, for every
    t < threads (float32)."""
    rows = -(-x.numel() // threads)
    pad = torch.zeros(rows * threads, dtype=torch.float32, device=x.device)
    pad[:x.numel()] = x
    acc = torch.zeros(threads, dtype=torch.float32, device=x.device)
    for r in pad.view(rows, threads):
        acc = acc + r
    return acc


def _tree(acc):
    """The kernel's halving tree over the threads' sums."""
    s = acc.numel()
    while s > 1:
        s //= 2
        acc = acc[:s] + acc[s:2 * s]
    return acc[0]


def _chunk_sumsq(x, threads: int, vector: bool):
    """One chunk's sum of squares (x float32) in the kernel's order: thread
    t sums its vectors t, t + threads, ... element by element, then its
    element of the tail past the last whole vector; then the tree."""
    sq = x * x
    nvec = x.numel() // fused.VEC if vector else 0
    acc = torch.zeros(threads, dtype=torch.float32, device=x.device)
    if nvec:
        rows = -(-nvec // threads)
        body = torch.zeros(rows * threads * fused.VEC, dtype=torch.float32,
                           device=x.device)
        body[:nvec * fused.VEC] = sq[:nvec * fused.VEC]
        for r in body.view(rows, threads, fused.VEC):
            for k in range(fused.VEC):
                acc = acc + r[:, k]
    tail = sq[nvec * fused.VEC:]
    if tail.numel():
        acc = acc + _strided(tail, threads)
    return _tree(acc)


def adamw_fused_ref(params, grads, ms, vs, count, cfg, *,
                    chunk: int = fused.CHUNK, threads: int = fused.THREADS):
    """The fused AdamW pass (``csrc/adamw.cu``) in plain torch, the same
    chunks and every sum in the same order: each leaf's gradient cut into
    chunks of ``chunk`` elements, each chunk's sum of squares, those partials
    summed by ``threads`` threads strided and a halving tree; then the clip's
    scale, the schedule and the update in ``optim/adamw.eager_update``'s
    float32 operations.  ``params``, ``grads``, ``ms``, ``vs``: lists of one
    leaf's tensors each, the parameters float32 or bfloat16, the moments
    float32; ``count``: the int32 step count; ``cfg``: an
    ``optim.adamw.OptConfig`` without the compressor.  Writes the parameters
    and the moments in place; returns (count + 1, the norm before the clip,
    lr)."""
    if chunk % fused.VEC or threads & (threads - 1):
        raise ValueError(f"chunk {chunk} is not a multiple of {fused.VEC}, "
                         f"or {threads} threads not a power of two")
    parts = []
    for p, g, m, v in zip(params, grads, ms, vs):
        vector = fused.vector_path(p, g, m, v)
        x = g.reshape(-1).float()
        for lo in range(0, x.numel(), chunk):
            parts.append(_chunk_sumsq(x[lo:lo + chunk], threads, vector))
    norm = torch.sqrt(_tree(_strided(torch.stack(parts), threads)))
    (lr0, inv_warm, warmup, inv_prog, pi, b1, b2, omb1, omb2, eps, wd,
     clip) = fused.constants(cfg)
    scale = torch.clamp(torch.reciprocal(torch.clamp(norm, min=1e-8)) * clip,
                        max=1.0)
    count = count + 1
    step = count.float()
    warm = torch.clamp(step * inv_warm, max=1.0)
    prog = torch.clamp((step - warmup) * inv_prog, 0.0, 1.0)
    lr = lr0 * warm * 0.5 * (1 + torch.cos(pi * prog))
    b1c, b2c = 1 - torch.pow(b1, step), 1 - torch.pow(b2, step)
    for p, g, m, v in zip(params, grads, ms, vs):
        g = g.float() * scale
        m.copy_(b1 * m + omb1 * g)
        v.copy_(b2 * v + omb2 * (g * g))
        upd = (m / b1c) / (torch.sqrt(v / b2c) + eps) + wd * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
    return count, norm, lr
