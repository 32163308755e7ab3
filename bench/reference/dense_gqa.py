"""Plain reference of a dense GQA decoder (Llama's layer equations), its
causal LM loss and the AdamW step the training cells state.

Written from the published description, independent of the program: plain
``torch`` operations in float32 with TF32 off, no kernel, no cache, no
batching across sequences.  It takes the benchmark's own weights
(``benchkit.weights``) by the benchmark's own names.

Per layer, with RMSNorm(x; g) = x / sqrt(mean(x^2) + eps) * (1 + g):

    h = RMSNorm(x; attn_norm)
    q, k, v = h Wq, h Wk, h Wv       (H query heads, KV key/value heads)
    q, k = RoPE(q), RoPE(k)          (rotate-half, theta^(-2i/hd))
    x = x + softmax(q k^T / sqrt(hd) + causal) v Wo   (head h reads KV head
                                                       h // (H / KV))
    h = RMSNorm(x; mlp_norm)
    x = x + (silu(h W_gate) * (h W_up)) W_down

then RMSNorm(x; final_norm) and the head (the embedding table when tied).

``prec="fp8"`` is the control: every matrix product's operands are rounded
to float8 e4m3 with a per-tensor scale (the step below the bfloat16 the
configurations state), the rest as in float32.  The rounding passes
gradients straight through.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for the duration (a float32 product may otherwise run in
    TF32 on the card)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8(x):
    """x rounded to float8 e4m3 under a per-tensor scale, gradient passed
    straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def mm(a, b, prec):
    if prec == "fp8":
        a, b = fp8(a), fp8(b)
    return a @ b


def rmsnorm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + g)


def rope(x, pos, theta):
    """x (S, heads, hd), pos (S,)."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=x.device) / hd)
    ang = pos[:, None].float() * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def attention(q, k, v, prec, block=1024):
    """Causal attention of one sequence: q (S, H, hd), k and v (S, KV, hd),
    in blocks of ``block`` query rows."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)                  # head h -> KV h // G
    v = v.repeat_interleave(G, dim=1)
    kt = k.permute(1, 2, 0)                            # (H, hd, S)
    vh = v.permute(1, 0, 2)                            # (H, S, hd)
    out = []
    for r0 in range(0, S, block):
        r1 = min(S, r0 + block)
        qb = q[r0:r1].permute(1, 0, 2)                 # (H, b, hd)
        s = mm(qb, kt[:, :, :r1], prec) / math.sqrt(hd)
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        cols = torch.arange(r1, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out.append(mm(p, vh[:, :r1], prec).permute(1, 0, 2))
    return torch.cat(out, 0)


def layer(x, w, i, cfg, pos, prec):
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps = cfg["head_dim"], cfg["rms_norm_eps"]
    p = f"layers.{i}."
    S = x.shape[0]
    h = rmsnorm(x, w[p + "attn_norm"], eps)
    q = rope(mm(h, w[p + "wq"], prec).view(S, H, hd), pos, cfg["rope_theta"])
    k = rope(mm(h, w[p + "wk"], prec).view(S, KV, hd), pos,
             cfg["rope_theta"])
    v = mm(h, w[p + "wv"], prec).view(S, KV, hd)
    x = x + mm(attention(q, k, v, prec).reshape(S, H * hd), w[p + "wo"],
               prec)
    h = rmsnorm(x, w[p + "mlp_norm"], eps)
    f = F.silu(mm(h, w[p + "w_gate"], prec)) * mm(h, w[p + "w_up"], prec)
    return x + mm(f, w[p + "w_down"], prec)


def hidden(w, cfg, tokens, prec="fp32"):
    """The final normed hidden rows (S, d) of one sequence ``tokens`` (S,)."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = w["embed"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        x = layer(x, w, i, cfg, pos, prec)
    return rmsnorm(x, w["final_norm"], cfg["rms_norm_eps"])


def head(w, cfg):
    return w["embed"] if cfg["tie_word_embeddings"] else w["head"]


def logits(w, cfg, tokens, rows=None, prec="fp32"):
    """Logits (len(rows), vocab) of one sequence at ``rows`` (all rows when
    None)."""
    h = hidden(w, cfg, tokens, prec)
    if rows is not None:
        h = h[rows]
    return mm(h, head(w, cfg).T, prec)


def sequence_nll_sum(w, cfg, tokens, labels, prec="fp32"):
    """The summed next-token NLL of one sequence."""
    lg = logits(w, cfg, tokens, prec=prec)
    return (torch.logsumexp(lg, -1)
            - lg.gather(-1, labels[:, None].long())[:, 0]).sum()


def loss_and_grads(w, cfg, batch, prec="fp32", rows=None):
    """(mean NLL over the batch's tokens, {name: gradient}) for ``batch``
    {"tokens", "labels"} (B, S); a sequence at a time, gradients summed.
    ``rows``: the batch rows that count (all by default)."""
    tokens, labels = batch["tokens"], batch["labels"]
    rows = range(tokens.shape[0]) if rows is None else rows
    n = len(rows) * tokens.shape[1]
    leaves = {k: t.detach().requires_grad_(True) for k, t in w.items()}
    total = 0.0
    grads = {k: torch.zeros_like(t) for k, t in w.items()}
    for b in rows:
        nll = sequence_nll_sum(leaves, cfg, tokens[b], labels[b], prec) / n
        gs = torch.autograd.grad(nll, list(leaves.values()),
                                 allow_unused=True)
        for (k, _), g in zip(leaves.items(), gs):
            if g is not None:
                grads[k] += g
        total += float(nll.detach())
    return total, grads


def lr_at(opt, count):
    warm = min(count / max(1.0, opt["warmup_steps"]), 1.0)
    prog = min(max((count - opt["warmup_steps"]) /
                   max(1.0, opt["total_steps"] - opt["warmup_steps"]), 0.0),
               1.0)
    return opt["lr"] * warm * 0.5 * (1 + math.cos(math.pi * prog))


@torch.no_grad()
def adamw(w, grads, state, opt):
    """One AdamW step in place: global-norm clip, bias-corrected moments,
    decoupled weight decay ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd *
    p)``.  Returns the clipped gradient (what the moments took)."""
    count = state["count"] = state.get("count", 0) + 1
    norm = math.sqrt(sum(float(g.double().square().sum())
                         for g in grads.values()))
    scale = min(opt["clip_norm"] / max(norm, 1e-8), 1.0)
    lr = lr_at(opt, count)
    b1, b2 = opt["b1"], opt["b2"]
    clipped = {}
    for k, p in w.items():
        g = grads[k] * scale
        clipped[k] = g
        m = state.setdefault("m", {}).setdefault(k, torch.zeros_like(p))
        v = state.setdefault("v", {}).setdefault(k, torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m / (1 - b1 ** count)) / \
            ((v / (1 - b2 ** count)).sqrt() + opt["eps"]) + \
            opt["weight_decay"] * p
        p.sub_(lr * upd)
    return clipped
