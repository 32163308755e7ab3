"""Shape-only stand-ins for every dry-run cell (port of
``repro/launch/specs.py``): each cell's step function, its example
arguments as tensors on the meta device (shapes and dtypes, no storage)
and a sharding for every argument leaf under the cell's rules.

A tree here is nested dicts and lists whose leaves are tensors,
shardings or axes; the parameters are the ``Model`` on the meta device,
whose leaves are its named parameters (``tree_leaves``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch import sharding as shd
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, \
    get_config
from repro_torch.core.offload import SentinelConfig, opt_state_sharding
from repro_torch.models import kvcache, model
from repro_torch.optim import adamw
from repro_torch.train import loop

META = torch.device("meta")


def tree_leaves(tree) -> dict:
    """``{path: leaf}`` of a tree of dicts, lists and tuples (an axes tuple
    is a leaf), a module's leaves its named parameters, paths joined by
    "/"."""
    out = {}

    def walk(t, path):
        if isinstance(t, nn.Module):
            t = dict(t.named_parameters())
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else str(k))
        elif isinstance(t, (list, tuple)) and not shd.is_axes_leaf(t):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}" if path else str(i))
        else:
            out[path] = t
    walk(tree, "")
    return out


def param_structs(cfg: ModelConfig):
    """(the ``Model`` on the meta device, ``{name: logical axes}``) without
    allocating; the parameters take gradients, as a train step needs."""
    params = model.init_params(cfg, device=META, requires_grad=True)
    return params, model.param_axes(cfg)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                decode: bool = False) -> Dict[str, Any]:
    B = shape.global_batch
    S = 1 if decode else shape.seq_len
    tok_shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks else (B, S)
    out = {"tokens": torch.empty(tok_shape, dtype=torch.int32, device=META)}
    if not decode:
        if cfg.num_codebooks:
            lab_shape = tok_shape
        elif cfg.num_prefix_tokens:
            lab_shape = (B, S + cfg.num_prefix_tokens)
        else:
            lab_shape = (B, S)
        out["labels"] = torch.empty(lab_shape, dtype=torch.int32,
                                    device=META)
        if cfg.num_prefix_tokens:
            out["prefix_embed"] = torch.empty(
                (B, cfg.num_prefix_tokens, cfg.d_model), dtype=torch.float32,
                device=META)
    return out


def batch_shardings(cfg, shape, rules, *, decode=False):
    tok = ("batch", None, None) if cfg.num_codebooks else ("batch", None)
    out = {"tokens": rules.sharding(tok)}
    if not decode:
        out["labels"] = rules.sharding(tok)
        if cfg.num_prefix_tokens:
            out["prefix_embed"] = rules.sharding(("batch", None, None))
    return out


def shardings_from_axes(axes_tree, rules, like=None):
    """A sharding per axes leaf; with ``like`` (the tree of tensors, or the
    ``Model``, the axes describe) each takes its leaf's shape, and a
    mesh-axis product that does not divide a dim leaves it replicated (kv
    = 5 heads, 40 experts, odd vocab sizes...)."""
    if like is None:
        return shd.map_axes(lambda _, ax: rules.sharding(ax), axes_tree)
    shapes = {path: tuple(t.shape) for path, t in tree_leaves(like).items()}
    out = shd.map_axes(lambda path, ax: shd.sharding_for(shapes[path], ax,
                                                         rules), axes_tree)
    if len(tree_leaves(out)) != len(shapes):
        raise ValueError("the axes name fewer leaves than the tensors hold")
    return out


def build_train_cell(cfg: ModelConfig, shape: ShapeConfig, rules,
                     scfg: SentinelConfig, opt_cfg=None):
    """(step_fn, (state, batch) on meta, their shardings) for one training
    step: ``loop.make_train_step`` in ``scfg``'s mode; the AdamW moments'
    shardings from ``opt_state_sharding``, in ``pinned_host`` under
    ``offload_opt_state``."""
    opt_cfg = opt_cfg or adamw.OptConfig()
    params, axes = param_structs(cfg)
    state = {"params": params, "opt": adamw.init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device=META)}
    p_sh = shardings_from_axes(axes, rules, params)
    # each moment leaf: its parameter's divisible spec, placed where
    # opt_state_sharding places it
    placed = opt_state_sharding(rules, axes,
                                offload=scfg.offload_opt_state)
    opt_sh = {k: {n: s.with_memory_kind(placed[n].memory_kind)
                  for n, s in p_sh.items()}
              for k in ("m", "v", "ef") if k in state["opt"]}
    opt_sh["count"] = rules.sharding(())
    state_sh = {"params": p_sh, "opt": opt_sh, "step": rules.sharding(())}
    batch = batch_specs(cfg, shape)
    b_sh = batch_shardings(cfg, shape, rules)
    return (loop.make_train_step(cfg, scfg, opt_cfg), (state, batch),
            (state_sh, b_sh))


def build_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, rules):
    """Prefill: the whole prompt's forward and its cache writes."""
    params, axes = param_structs(cfg)
    params.requires_grad_(False)
    p_sh = shardings_from_axes(axes, rules, params)
    b = {"tokens": batch_specs(cfg, shape)["tokens"]}
    if cfg.num_prefix_tokens:
        b["prefix_embed"] = torch.empty(
            (shape.global_batch, cfg.num_prefix_tokens, cfg.d_model),
            dtype=torch.float32, device=META)
    b_sh = {k: v for k, v in batch_shardings(cfg, shape, rules).items()
            if k in b}

    def prefill_step(params, batch):
        return model.prefill(params, cfg, batch)

    return prefill_step, (params, b), (p_sh, b_sh)


def build_decode_cell(cfg: ModelConfig, shape: ShapeConfig, rules):
    """serve_step: one new token against a ``seq_len`` dense cache."""
    params, axes = param_structs(cfg)
    params.requires_grad_(False)
    p_sh = shardings_from_axes(axes, rules, params)
    B, S = shape.global_batch, shape.seq_len
    caches = kvcache.init_cache(cfg, B, S, model.param_dtype(cfg), META)
    c_sh = shardings_from_axes(kvcache.cache_logical_axes(cfg), rules,
                               caches)
    tok = torch.empty((B, 1, cfg.num_codebooks) if cfg.num_codebooks
                      else (B, 1), dtype=torch.int32, device=META)
    t_sh = rules.sharding(("batch", None, None) if cfg.num_codebooks
                          else ("batch", None))
    index = torch.zeros((), dtype=torch.int32, device=META)

    def serve_step(params, tokens, caches, index):
        # every slot at the one offset, as per-slot offsets: a scalar
        # offset is a host int to the dense write, and a meta tensor has
        # no value to give
        return model.decode_step(params, cfg, tokens, caches,
                                 index.expand(tokens.shape[0]))

    return (serve_step, (params, tok, caches, index),
            (p_sh, t_sh, c_sh, rules.sharding(())))


def build_cell(arch: str, shape_name: str, rules, scfg=None):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    scfg = scfg or SentinelConfig(mode="offload",
                                  mi_periods=default_mi(cfg))
    if shape.kind == "train":
        return build_train_cell(cfg, shape, rules, scfg)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, rules)
    return build_decode_cell(cfg, shape, rules)


def default_mi(cfg: ModelConfig) -> int:
    """The reference's default: about 1/8 of the depth, rounded to a
    divisor of num_periods (the planner's value comes from
    ``runtime.plan``; this keeps the dry-run self-contained)."""
    P = cfg.num_periods
    target = max(1, P // 8)
    divs = [d for d in range(1, P + 1) if P % d == 0]
    return min(divs, key=lambda d: abs(d - target))


def argument_bytes(args, shardings) -> int:
    """Each device's bytes of ``args`` laid out by ``shardings`` (trees of
    the same paths): every leaf's ``shard_shape`` times its element
    size."""
    leaves, specs = tree_leaves(args), tree_leaves(shardings)
    if set(leaves) != set(specs):
        raise ValueError(f"arguments and shardings differ: "
                         f"{sorted(set(leaves) ^ set(specs))[:4]}")
    total = 0
    for path, t in leaves.items():
        block = specs[path].shard_shape(tuple(t.shape))
        n = 1
        for d in block:
            n *= d
        total += n * t.element_size()
    return total
