"""Training loop: step factory + fault-tolerant runner (port of
``repro/train/loop.py``).

``make_train_step`` builds the (state, batch) -> (state, metrics) step with
Sentinel's block structure (``core.offload.loss_kwargs``); ``run`` drives
it with periodic checkpoints, retry-on-failure (replaying the deterministic
pipeline) and straggler detection via a step-time EWMA.

The state is ``{"params": Model, "opt": adamw state, "step": int32}``.  A
step writes the parameters and the optimizer state in place (the reference
returns new ones), so a step that fails inside the optimizer update leaves
the state part-updated: the retry restores the latest checkpoint, as the
reference's does.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.offload import SentinelConfig, loss_kwargs
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import resolve
from repro_torch.models import model
from repro_torch.optim import adamw


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    max_retries: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0   # step slower than factor*EWMA -> warn


def make_train_step(cfg, scfg: SentinelConfig,
                    opt_cfg: adamw.OptConfig) -> Callable:
    kw = loss_kwargs(scfg)

    def step(state, batch):
        params = state["params"]
        named = dict(params.named_parameters())
        loss = model.loss_fn(params, cfg, batch, **kw)
        grads = torch.autograd.grad(loss, list(named.values()))
        _, opt, om = adamw.update(dict(zip(named, grads)), state["opt"],
                                  named, opt_cfg)
        metrics = {"loss": loss.detach(), **om}
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics

    return step


def init_state(cfg, opt_cfg: adamw.OptConfig, *, seed: int = 0, device=None,
               offload_opt_state: bool = False) -> dict:
    """Parameters from ``seed`` that take gradients, zero AdamW state
    (moments in pinned host memory with ``offload_opt_state`` on a card)
    and step 0, on ``device`` (default: the CUDA card; raises without one
    unless ``device="cpu"``)."""
    dev = resolve(device)
    params = model.init_params(cfg, seed, dev, requires_grad=True)
    return {"params": params,
            "opt": adamw.init(params, opt_cfg, offload=offload_opt_state),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def run(cfg, tcfg: TrainConfig, scfg: SentinelConfig,
        opt_cfg: adamw.OptConfig, dcfg: DataConfig,
        state=None, step_fn=None, log: Callable = print,
        device=None) -> Dict[str, Any]:
    """Fault-tolerant loop. Any step that raises is retried after restoring
    the latest checkpoint (the deterministic pipeline replays identical
    batches, so recovery is bit-exact).  Without a ``state`` it starts from
    ``init_state(seed=dcfg.seed)`` on ``device``; batches go to the
    parameters' device."""
    if state is None:
        state = init_state(cfg, opt_cfg, seed=dcfg.seed, device=device,
                           offload_opt_state=scfg.offload_opt_state)
    step_fn = step_fn or make_train_step(cfg, scfg, opt_cfg)
    dev = state["params"].table.device

    start = ckpt.latest_step(tcfg.ckpt_dir)
    if start is not None:
        state = ckpt.restore(state, tcfg.ckpt_dir, start)
        log(f"[train] resumed from step {start}")

    ewma = None
    retries = 0
    history = []
    step = int(state["step"])
    while step < tcfg.steps:
        batch = make_batch(dcfg, step, dev)
        t0 = time.perf_counter()
        try:
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
        except Exception as e:  # node failure / OOM: restore + retry
            retries += 1
            if retries > tcfg.max_retries:
                raise
            log(f"[train] step {step} failed ({type(e).__name__}); "
                f"retry {retries}/{tcfg.max_retries}")
            last = ckpt.latest_step(tcfg.ckpt_dir)
            if last is not None:
                state = ckpt.restore(state, tcfg.ckpt_dir, last)
                step = int(state["step"])
            continue
        dt = time.perf_counter() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > tcfg.straggler_factor * ewma and step > 3:
            log(f"[train] straggler: step {step} took {dt:.3f}s "
                f"(ewma {ewma:.3f}s)")
        step = int(state["step"])
        history.append(loss)
        if step % tcfg.log_every == 0:
            log(f"[train] step {step} loss {loss:.4f} ({dt*1e3:.1f} ms)")
        if tcfg.ckpt_every and step % tcfg.ckpt_every == 0:
            ckpt.save(state, tcfg.ckpt_dir, step)
    return {"state": state, "losses": history}
