"""The benchmark's weights: made from the seed on the device in one large
draw, in the type they are served in, under the benchmark's own names, and
loaded into the program's model by parameter name.

Every weight of a dense GQA decoder is N(0, 1) from one seeded draw, scaled
by 1 / sqrt(fan_in) (the embedding table and the head by 1 / sqrt(d)); the
norms' gains are 1 + g with g ~ 0.1 N(0, 1), so that a norm whose gain were
dropped would show.
"""
from __future__ import annotations

import math

import torch

NORM_STD = 0.1


def layout(cfg: dict) -> list:
    """[(name, shape, std)] of every weight, in draw order."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    H, KV, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    ff = cfg["intermediate_size"]
    out = [("embed", (V, d), d ** -0.5)]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out += [(p + "attn_norm", (d,), NORM_STD),
                (p + "wq", (d, H * hd), d ** -0.5),
                (p + "wk", (d, KV * hd), d ** -0.5),
                (p + "wv", (d, KV * hd), d ** -0.5),
                (p + "wo", (H * hd, d), (H * hd) ** -0.5),
                (p + "mlp_norm", (d,), NORM_STD),
                (p + "w_gate", (d, ff), d ** -0.5),
                (p + "w_up", (d, ff), d ** -0.5),
                (p + "w_down", (ff, d), ff ** -0.5)]
    out.append(("final_norm", (d,), NORM_STD))
    if not cfg["tie_word_embeddings"]:
        out.append(("head", (V, d), d ** -0.5))
    return out


def count(cfg: dict) -> int:
    return sum(math.prod(s) for _, s, _ in layout(cfg))


@torch.no_grad()
def make(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{name: tensor}, views into one buffer drawn from ``seed`` on
    ``device``: the same seed and device give the same weights."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty(count(cfg), dtype=dtype, device=device)
    flat.normal_(generator=gen)
    out, at = {}, 0
    for name, shape, std in layout(cfg):
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    return out


def port_names(cfg: dict) -> dict:
    """{the program's parameter name: the benchmark's name} for the port's
    dense ``Model`` (``repro_torch.models.model``): its norms hold the
    gain's offset g, as the benchmark's do."""
    out = {"table": "embed", "final_norm": "final_norm"}
    if not cfg["tie_word_embeddings"]:
        out["head"] = "head"
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out.update({p + "ln1": p + "attn_norm", p + "attn.wq": p + "wq",
                    p + "attn.wk": p + "wk", p + "attn.wv": p + "wv",
                    p + "attn.wo": p + "wo", p + "ln2": p + "mlp_norm",
                    p + "mlp.wg": p + "w_gate", p + "mlp.wi": p + "w_up",
                    p + "mlp.wo": p + "w_down"})
    return out


@torch.no_grad()
def load_into(model, cfg: dict, w: dict) -> None:
    """Copy the benchmark's weights into the program's model by name; rows
    of a padded vocabulary past ``vocab_size`` are zero."""
    names = port_names(cfg)
    params = dict(model.named_parameters())
    if set(params) != set(names):
        raise ValueError(f"the program's parameters differ from the "
                         f"benchmark's: {sorted(set(params) ^ set(names))}")
    for pname, p in params.items():
        src = w[names[pname]]
        if p.shape == src.shape:
            p.copy_(src)
        else:                                  # padded vocabulary rows
            p.zero_()
            p[:src.shape[0]].copy_(src)


def as_fp32(w: dict) -> dict:
    return {k: t.float() for k, t in w.items()}
