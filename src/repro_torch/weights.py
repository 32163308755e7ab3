"""Carry the reference's parameters across to the port."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models.model import Model, param_dtype


def _reference_leaf(cfg, tree, name: str):
    """The reference leaf for the port's parameter ``name``."""
    path = name.split(".")
    stack = tree["stack"]
    if path[0] == "layers":
        # period layer j: slot j % period_len of the stacked slot trees, at
        # period j // period_len (the prologue is not in ``layers``)
        period, slot = divmod(int(path[1]), cfg.period_len)
        leaf = stack["slots"][slot]
        for key in path[2:]:
            leaf = leaf[key]
        return leaf[period]
    if path[0] == "prologue":
        leaf = stack["prologue"][int(path[1])]
        rest = path[2:]
    elif path[0] == "shared":
        leaf, rest = stack["shared"], path[1:]
    elif path[0] == "table":
        leaf, rest = tree["embed"], path
    else:                                      # final_norm, head
        leaf, rest = tree, path
    for key in rest:
        leaf = leaf[key]
    return leaf


@torch.no_grad()
def params_from_jax(cfg, tree, device=None) -> Model:
    """The port's parameters from the reference's
    ``split_params(model.init_params(...))[0]`` given as nested dicts of
    numpy arrays: the prologue layers, the shared block, and the stacked
    slot leaves ``(num_periods, ...)`` unstacked into the period layers (a
    SHARED_ATTN slot is weightless there; its layers are the shared block).
    Every shape is checked.  Copied to ``device`` (default: the CUDA card)
    in the config's dtype."""
    params = Model(cfg, device=resolve(device), dtype=param_dtype(cfg))
    for name, p in params.named_parameters():
        value = np.asarray(_reference_leaf(cfg, tree, name),
                           dtype=np.float32)
        if value.shape != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {value.shape} != "
                             f"{tuple(p.shape)}")
        p.copy_(torch.tensor(value))
    return params
