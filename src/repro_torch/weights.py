"""Carry the reference's parameters across to the port."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models.model import Model, param_dtype


@torch.no_grad()
def params_from_jax(cfg, tree, device=None) -> Model:
    """The port's parameters from the reference's
    ``split_params(model.init_params(...))[0]`` given as nested dicts of
    numpy arrays.  Stacked slot leaves ``(num_periods, ...)`` unstack into
    layers: layer ``l`` is slot ``l % period_len`` at period
    ``l // period_len``.  Copied to ``device`` (default: the CUDA card) in
    the config's dtype."""
    params = Model(cfg, device=resolve(device), dtype=param_dtype(cfg))
    slots = tree["stack"]["slots"]
    for name, p in params.named_parameters():
        path = name.split(".")
        if path[0] == "layers":
            period, slot = divmod(int(path[1]), cfg.period_len)
            leaf = slots[slot]
            for key in path[2:]:
                leaf = leaf[key]
            leaf = leaf[period]
        elif path[0] == "table":
            leaf = tree["embed"]["table"]
        else:                                  # final_norm, head
            leaf = tree[path[0]]
        value = np.asarray(leaf, dtype=np.float32)
        if value.shape != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {value.shape} != "
                             f"{tuple(p.shape)}")
        p.copy_(torch.tensor(value))
    return params
