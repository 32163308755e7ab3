"""Carry the reference's parameters across to the port."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models.model import Model, param_dtype


def reference_leaf(cfg, tree, name: str):
    """The leaf for the port's parameter ``name`` of a reference tree
    shaped as the parameters (the parameters themselves, their gradients or
    an AdamW moment)."""
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
def params_from_jax(cfg, tree, device=None, *,
                    requires_grad: bool = False) -> Model:
    """The port's parameters from the reference's
    ``split_params(model.init_params(...))[0]`` given as nested dicts of
    numpy arrays: the prologue layers (deepseek's dense one among them),
    the shared block, and the stacked slot leaves ``(num_periods, ...)``
    unstacked into the period layers, MoE expert banks ``(num_periods, E,
    din, dout)``, shared experts and the xLSTM/LSTM blocks' leaves (the
    sLSTM's recurrent ``r_ifzo`` (H, 4, D, D) among them) included (a
    SHARED_ATTN slot is weightless there; its layers are the shared
    block).
    Every shape is checked.  Copied to ``device`` (default: the CUDA card)
    in the config's dtype; ``requires_grad`` as ``init_params``'s."""
    params = Model(cfg, device=resolve(device), dtype=param_dtype(cfg))
    for name, p in params.named_parameters():
        p.copy_(_leaf_for(cfg, tree, name, p))
    return params.requires_grad_(requires_grad)


def _leaf_for(cfg, tree, name: str, like: torch.Tensor) -> torch.Tensor:
    """The reference leaf of parameter ``name`` as a float32 CPU tensor of
    ``like``'s shape."""
    value = np.asarray(reference_leaf(cfg, tree, name), dtype=np.float32)
    if value.shape != tuple(like.shape):
        raise ValueError(f"{name}: reference shape {value.shape} != "
                         f"{tuple(like.shape)}")
    return torch.tensor(value)


@torch.no_grad()
def opt_state_from_jax(cfg, params: Model, state, *, offload: bool = False):
    """The port's AdamW state (``optim.adamw.init``'s layout: ``m`` and
    ``v`` keyed by parameter name, float32, and the int32 ``count``) from
    the reference's ``{"m", "v", "count"}`` given as nested numpy arrays,
    placed as ``adamw.init(params, ..., offload=offload)`` places it."""
    from repro_torch.core.offload import opt_state_placement
    place = opt_state_placement(params.table.device, offload=offload)
    out = {key: {name: place.put(_leaf_for(cfg, state[key], name, p))
                 for name, p in params.named_parameters()}
           for key in ("m", "v")}
    out["count"] = torch.tensor(int(np.asarray(state["count"])),
                                dtype=torch.int32, device=params.table.device)
    return out
