"""AdamW with global-norm clipping, a warm-up then cosine schedule, and an
optional int8 error-feedback gradient compressor (port of
``repro/optim/adamw.py``): plain functions on tensors with the reference's
semantics, not ``torch.optim.AdamW`` (whose update differs: it scales the
weight decay by the learning rate before the Adam step and has no clip).

Trees are mappings of parameter name -> tensor (an ``nn.Module`` stands
for its ``named_parameters()``).  The state is the reference's
``{"m", "v", "count"}`` (+ ``"ef"`` with ``compress_grads``): float32
moments keyed by parameter name and an int32 step count.  ``update``
writes the parameters and the state in place and returns them, where the
reference returns new ones.

With ``init(..., offload=True)`` on a CUDA card the moments live in pinned
host memory (``core.offload.opt_state_placement``) and ``update`` streams
them through the device leaf by leaf on the card's side stream: leaf i + 1
comes in while leaf i is updated, and leaf i goes back out after.

Under a rank context (a partitioned step, ``train/loop.py``) the
parameters, gradients and moments are the rank's blocks and the
gradients are already reduced over the data axes: the clip's norm is the
whole gradient's (each block's squared sum all-reduced over the axes it
is split over, a replicated leaf counted once), and the compressor's
scale the whole leaf's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Mapping

import torch
from torch import nn

from repro_torch.core.offload import opt_state_placement, side_stream
from repro_torch.sharding import all_reduce_over, split_axes


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False    # int8 + error feedback on the DP reduce


def _named(tree) -> dict:
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (float32): linear warm-up, then a cosine
    decay to 0 at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(1.0, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(1.0, cfg.total_steps - cfg.warmup_steps), 0, 1)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))


def init(params, cfg: OptConfig, *, offload: bool = False) -> dict:
    """Zero moments (and error-feedback residual) for every parameter,
    placed by ``opt_state_placement`` (``offload``: pinned host memory on
    a CUDA card)."""
    params = _named(params)
    device = next(iter(params.values())).device
    place = opt_state_placement(device, offload=offload)
    keys = ("m", "v", "ef") if cfg.compress_grads else ("m", "v")
    state = {k: {n: place.zeros(p.shape) for n, p in params.items()}
             for k in keys}
    state["count"] = torch.zeros((), dtype=torch.int32, device=device)
    return state


def global_norm(tree, axes=None) -> torch.Tensor:
    """The L2 norm of every leaf together.  ``axes`` (a mapping like
    ``tree``): the mesh axes each leaf is a rank's block over; the blocks'
    squared sums are then all-reduced over their axes, one all-reduce per
    set of axes, in a fixed order."""
    if axes is None:
        leaves: Iterable = tree.values() if isinstance(tree, Mapping) \
            else tree
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves))
    by_axes = {}
    for name, x in tree.items():
        by_axes.setdefault(axes[name], []).append(
            torch.sum(torch.square(x.float())))
    total = 0.0
    for ax in sorted(by_axes):
        part = sum(by_axes[ax])
        total = total + (all_reduce_over(part, ax) if ax else part)
    return torch.sqrt(total)


def compress_decompress(g, ef, axes=()):
    """int8 quantize + error feedback: g_q = q(g + ef); ef' = g + ef - g_q.
    Models the compressed cross-pod all-reduce payload (quantizing before
    the reduce shrinks its bytes 4x).  ``axes``: the mesh axes ``g`` is a
    rank's block over, whose whole leaf sets the scale."""
    t = g.float() + ef
    amax = t.abs().max()
    if axes:
        amax = all_reduce_over(amax, axes, op="max")
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.round(t / scale).to(torch.int8)
    deq = q.float() * scale
    return deq, t - deq


@torch.no_grad()
def update(grads, state: dict, params, cfg: OptConfig):
    """One AdamW step.  Returns (params, state, metrics), the first two
    updated in place; ``metrics["grad_norm"]`` is the norm before the
    clip."""
    params, grads = _named(params), _named(grads)
    count = state["count"] + 1
    axes = {n: split_axes(p) for n, p in params.items()}
    gnorm = global_norm(grads, axes if any(axes.values()) else None)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-8),
                        max=1.0)
    lr = schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    keys = [k for k in ("m", "v", "ef") if k in state]

    def step(name, p, moments):
        g = grads[name].float() * scale
        new = {}
        if cfg.compress_grads:
            g, new["ef"] = compress_decompress(g, moments["ef"], axes[name])
        m = cfg.b1 * moments["m"] + (1 - cfg.b1) * g
        v = cfg.b2 * moments["v"] + (1 - cfg.b2) * torch.square(g)
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + \
            cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
        new["m"], new["v"] = m, v
        return new

    names = list(params)
    if names and state["m"][names[0]].device != params[names[0]].device:
        _streamed(names, params, state, keys, step)
    else:
        for name in names:
            moments = {k: state[k][name] for k in keys}
            for k, t in step(name, params[name], moments).items():
                moments[k].copy_(t)
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _streamed(names, params, state, keys, step):
    """``update``'s loop over moments in pinned host memory: each leaf's
    moments come to the device on the side stream one leaf ahead of its
    update and go back on it after, ordered by events; the host waits for
    the last copy back before it returns (a caller may read the moments
    from the host next, as a checkpoint does)."""
    device = params[names[0]].device
    side, main = side_stream(device), torch.cuda.current_stream(device)

    def fetch(name):
        with torch.cuda.stream(side):
            dev = {k: state[k][name].to(device, non_blocking=True)
                   for k in keys}
            ready = torch.cuda.Event()
            ready.record(side)
        return dev, ready

    ahead = fetch(names[0])
    for i, name in enumerate(names):
        dev, ready = ahead
        if i + 1 < len(names):
            ahead = fetch(names[i + 1])
        main.wait_event(ready)
        for t in dev.values():
            t.record_stream(main)
        new = step(name, params[name], dev)
        done = torch.cuda.Event()
        done.record(main)
        side.wait_event(done)
        with torch.cuda.stream(side):
            for k, t in new.items():
                state[k][name].copy_(t, non_blocking=True)
                t.record_stream(side)
    back = torch.cuda.Event()
    back.record(side)
    back.synchronize()
