"""Training loop: step factory + fault-tolerant runner (port of
``repro/train/loop.py``).

``make_train_step`` builds the (state, batch) -> (state, metrics) step with
Sentinel's block structure (``core.offload.loss_kwargs``); ``run`` drives
it with periodic checkpoints, retry-on-failure (replaying the deterministic
pipeline) and straggler detection via a step-time EWMA.

Given ``rules`` over a mesh (``sharding.tp_dp_rules``) it builds the
partitioned step instead (``PartitionedStep``, the reference's sharded
``train_step``): one rank thread per mesh position, each running the
one-device step on its parameter blocks and its rows of the batch under
its rank context.  Under a rank context the step runs the rank's
backward on the rank's own thread (autograd's device threads would run
every aliased rank's CUDA backward on one thread, and a rank waiting at a
collective would block the rest), scaled by 1 / the batch's shards, then
sums over the data axes the gradients that FSDP's reduce-scatters did not
already sum (one all-reduce of them all), and averages the loss there.

The state is ``{"params": Model, "opt": adamw state, "step": int32}``.  A
step writes the parameters and the optimizer state in place (the reference
returns new ones), so a step that fails inside the optimizer update leaves
the state part-updated: the retry restores the latest checkpoint, as the
reference's does.
"""
from __future__ import annotations

import math
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import torch

from repro_torch import collectives, telemetry
from repro_torch import sharding as shd
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


def make_train_step(cfg, scfg: SentinelConfig, opt_cfg: adamw.OptConfig,
                    rules=None) -> Callable:
    """The (state, batch) -> (state, metrics) step; with ``rules``, a
    ``PartitionedStep`` over their mesh."""
    if rules is not None:
        return PartitionedStep(cfg, scfg, opt_cfg, rules)
    kw = loss_kwargs(scfg)

    def step(state, batch):
        params = state["params"]
        named = dict(params.named_parameters())
        with telemetry.span("train.forward"):
            loss = model.loss_fn(params, cfg, batch, **kw)
        with telemetry.span("train.backward"):
            grads, loss = _gradients(loss, named)
        with telemetry.span("train.adamw"):
            _, opt, om = adamw.update(grads, state["opt"], named, opt_cfg)
        metrics = {"loss": loss, **om}
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics

    return step


def _gradients(loss, named: dict) -> tuple:
    """(the gradient of every parameter by name, the loss).  Under a rank
    context: the rank's backward on its own thread, of the loss over the
    batch's shards; the gradients of the leaves FSDP does not gather
    summed over the data axes in one all-reduce (FSDP's own came summed
    out of its reduce-scatters); the loss averaged there."""
    leaves = list(named.values())
    ctx = shd.current_rank()
    if ctx is None:
        return dict(zip(named, torch.autograd.grad(loss, leaves))), \
            loss.detach()
    n = ctx.batch_shards
    with torch.autograd.set_multithreading_enabled(False):
        grads = dict(zip(named, torch.autograd.grad(
            loss, leaves, torch.full_like(loss, 1.0 / n))))
    loss = loss.detach()
    split = set(ctx.batch_axes) if n > 1 else set()
    for name, p in named.items():
        axes = shd.fsdp_axes(p)
        if axes and set(axes) != split:
            raise NotImplementedError(
                f"{name} is gathered over {axes}, but the batch splits over "
                f"{tuple(split) or 'no axis'}")
    if n == 1:
        return grads, loss
    dense = [name for name, p in named.items() if not shd.fsdp_axes(p)]
    for dtype in sorted({grads[k].dtype for k in dense}, key=str):
        names = [k for k in dense if grads[k].dtype == dtype]
        flat = shd.all_reduce_over(
            torch.cat([grads[k].reshape(-1) for k in names]),
            ctx.batch_axes)
        for k, part in zip(names, flat.split(
                [grads[k].numel() for k in names])):
            grads[k] = part.view_as(grads[k])
    return grads, shd.all_reduce_over(loss, ctx.batch_axes) / n


class PartitionedStep:
    """The train step over ``rules.mesh`` (axes ``("data", "model")`` or
    ``("pod", "data", "model")``; its devices, default the CUDA card at
    every position, may repeat): a ``collectives.MeshGroup`` runs the
    one-device step at every mesh position at once, each on its own
    thread under its rank context, on its state (``init_states``: its
    blocks of the parameters, their AdamW moments on its device or in
    pinned host memory with ``scfg.offload_opt_state``) and its rows of
    the batch.  A call returns (the ranks' states, rank 0's metrics, with
    every rank's under ``"ranks"``: the loss and ``grad_norm`` agree
    across ranks).  ``gather`` puts the parameters back together;
    ``ledger`` is what the collectives moved; ``close`` stops the rank
    threads.  A rank that fails raises, and so does the call."""

    def __init__(self, cfg, scfg: SentinelConfig, opt_cfg: adamw.OptConfig,
                 rules):
        mesh = rules.mesh
        if mesh.devices is None:
            mesh = shd.Mesh(list(mesh.shape.values()), mesh.axis_names,
                            [resolve(None)] * mesh.size)
            rules = shd.AxisRules(mesh, rules.rules)
        self.cfg, self.scfg, self.opt_cfg, self.rules = cfg, scfg, opt_cfg, \
            rules
        self.devices = [resolve(d) for d in mesh.devices]
        self.groups = collectives.MeshGroup(mesh)
        self.positions = self.groups.positions
        self._step = make_train_step(cfg, scfg, opt_cfg)
        self._like = model.init_params(cfg, device="meta")

    @property
    def ledger(self) -> dict:
        return self.groups.ledger

    def close(self):
        self.groups.close()

    def init_states(self, params) -> list:
        """Each mesh position's state from the whole ``params`` (a
        ``Model``): its blocks as leaves of their own on its device, zero
        moments, step 0."""
        states = []
        for pos, dev in zip(self.positions, self.devices):
            blocks = shd.shard_params(params, self.rules, pos, device=dev,
                                      train=True)
            states.append({
                "params": blocks,
                "opt": adamw.init(blocks, self.opt_cfg,
                                  offload=self.scfg.offload_opt_state),
                "step": torch.zeros((), dtype=torch.int32, device=dev)})
        return states

    def gather(self, states, device=None):
        """The whole parameters of ``states`` as one frozen ``Model``."""
        return shd.gather_params([s["params"] for s in states],
                                 self.positions, self.rules, self._like,
                                 device)

    def __call__(self, states, batch):
        B = batch["tokens"].shape[0]

        def rank(i):
            pos, dev = self.positions[i], self.devices[i]
            axes, blk = shd.batch_split(self.rules, pos, B)
            rows = B // math.prod(self.rules.mesh.shape[a] for a in axes)
            mine = {k: v.narrow(0, blk * rows, rows).to(dev)
                    for k, v in batch.items()}
            ctx = shd.mesh_rank(self.groups, self.rules, pos,
                                batch_axes=axes, params=states[i]["params"])
            with shd.rank_context(ctx):
                return self._step(states[i], mine)

        outs = self.groups.run(rank)
        metrics = dict(outs[0][1])
        metrics["ranks"] = [m for _, m in outs]
        return [s for s, _ in outs], metrics


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
