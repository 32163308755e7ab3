"""Sentinel's runtime on the card: migration-interval-blocked activation
offload (port of ``repro/core/offload.py``).

The paper's mechanism maps onto the port as follows:

  - long-lived data objects  = block carries (the residual stream where one
    block of ``mi_periods`` periods hands over to the next) and the
    optimizer's moments.  ``models/transformer.py::stack_forward`` runs the
    period layers as blocks, each one ``torch.autograd.Function`` that
    keeps nothing of its inside for the backward but its carry: in
    device memory, or, in mode "offload", in pinned host memory (the slow
    tier), copied out on a side stream in the forward and prefetched one
    block ahead on that stream in the backward (``CarryStore``), so the
    copies overlap the blocks' compute.
  - short-lived data objects = everything inside a block: recomputed in
    the backward from the carry, so it lives in device memory only for the
    block's recompute (the reserved pool, realised by rematerialisation).
  - the migration interval   = ``mi_periods``.  A small MI: more carries,
    more host-link traffic, less recompute.  A large MI: less traffic,
    more recompute and a larger working set inside a block.  The planner
    (``runtime.plan``) picks it from the profiled step
    (``core/profiler.py::trace_profile``).

Modes:
  "offload"   Sentinel: each block's carry goes to pinned host memory.
  "save_hbm"  the same blocks; the carries stay in device memory.
  "remat"     the same blocks, nothing named for saving: a block keeps the
              input it recomputes from on the device, as the reference's
              scan keeps its block input.  So on the port "remat" and
              "save_hbm" hold the same bytes.
  "full"      no blocks: autograd saves everything (the speed ceiling and
              the memory peak).

A mode changes memory and time, never a value.  The reference names a
block's carry only when ``mi_periods`` > 1 (at an MI of one it checkpoints
each period with nothing named, so "offload" moves nothing there); the
port blocks at every MI, so a mode keeps its meaning at an MI of one.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.profiler import TraceProfile
from repro_torch.sharding import current_rank, map_axes
from repro_torch.runtime import PlacementPlan, mi_to_periods

MODES = ("offload", "save_hbm", "remat", "full")


@dataclass(frozen=True)
class SentinelConfig:
    mode: str = "offload"            # offload | save_hbm | remat | full
    mi_periods: int = 1
    offload_opt_state: bool = False  # optimizer moments live in pinned host

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} is not one of {MODES}")

    @property
    def uses_blocks(self) -> bool:
        return self.mode in ("offload", "save_hbm", "remat")


def remat_policy(scfg: SentinelConfig) -> Optional[str]:
    """The block policy ``stack_forward`` takes: the mode for the blocked
    modes, None for "full" (no blocks)."""
    return scfg.mode if scfg.uses_blocks else None


def loss_kwargs(scfg: SentinelConfig) -> dict:
    """kwargs for model.loss_fn implementing this Sentinel config."""
    if scfg.mode == "full":
        return {}
    return {
        "remat_policy": remat_policy(scfg),
        "mi_periods": scfg.mi_periods,
        "tag_block_out": scfg.mode in ("offload", "save_hbm"),
    }


def from_plan(profile: TraceProfile, plan: PlacementPlan, *,
              offload_opt_state: bool = False) -> SentinelConfig:
    """Planner output (``runtime.plan``) -> runtime config.  The plan's MI
    is in timeline steps, which map 1:1 to periods inside the fwd/bwd
    regions; it is rounded to the nearest divisor of ``num_periods`` so the
    blocks tile the stack exactly.  (The reference's ``cost_model`` and
    deprecated ``hw`` keywords change nothing there and are not ported:
    the plan already encodes the machine it was priced on.)"""
    mi = mi_to_periods(profile, plan.mi)
    P = profile.num_periods
    divisors = [d for d in range(1, P + 1) if P % d == 0]
    mi = min(divisors, key=lambda d: abs(d - mi))
    return SentinelConfig(mode="offload", mi_periods=mi,
                          offload_opt_state=offload_opt_state)


@dataclass(frozen=True)
class Placement:
    """Where the optimizer's float32 state of parameters on ``device``
    lives: ``device`` itself, or pinned host memory (``pinned``)."""
    device: torch.device
    pinned: bool

    def zeros(self, shape) -> torch.Tensor:
        if not self.pinned:
            return torch.zeros(shape, dtype=torch.float32, device=self.device)
        return _pinned(torch.zeros(shape, dtype=torch.float32,
                                   pin_memory=True))

    def put(self, t: torch.Tensor) -> torch.Tensor:
        if not self.pinned:
            return t.to(device=self.device, dtype=torch.float32)
        out = _pinned(torch.empty(t.shape, dtype=torch.float32,
                                  pin_memory=True))
        return out.copy_(t)


def _pinned(t: torch.Tensor) -> torch.Tensor:
    if not t.is_pinned():
        raise RuntimeError("a pinned host allocation came back pageable")
    return t


def opt_state_placement(device, *, offload: bool) -> Placement:
    """Where the AdamW moments (and the error-feedback residual) of
    parameters on ``device`` live.  With ``offload`` on a CUDA device:
    pinned host memory (Sentinel: rarely-accessed long-lived objects live
    in slow memory), streamed through the device leaf by leaf by
    ``optim.adamw.update``; a failed pinning raises.  Otherwise
    ``device`` (on the CPU, host memory is the device).  Their layout
    over a mesh is ``opt_state_sharding``'s."""
    device = torch.device(device)
    return Placement(device, offload and device.type == "cuda")


def opt_state_sharding(rules, logical_axes, *, offload: bool):
    """The sharding of each optimizer-moment leaf of ``logical_axes`` (a
    tree of axes leaves) under ``rules``, placed in ``"pinned_host"``
    memory when ``offload`` (Sentinel: rarely-accessed long-lived objects
    live in slow memory), else on the device (``memory_kind`` None)."""
    def one(_, ax):
        s = rules.sharding(ax)
        return s.with_memory_kind("pinned_host") if offload else s
    return map_axes(one, logical_axes)


def estimate_offload_traffic(profile: TraceProfile, mi_periods: int,
                             carry_bytes: int) -> dict:
    """Napkin numbers for the planner/benchmarks: bytes offloaded per step
    (each block's carry out in the forward and back in the backward)."""
    P = profile.num_periods
    nb = max(1, P // max(1, mi_periods))
    bytes_off = 2 * nb * carry_bytes           # out in fwd, back in bwd
    return {"blocks": nb, "bytes_offloaded": bytes_off}


# ------------------------------------------------------------ carries ----

# Since the last reset_traffic(): the block carries handed to the host
# store in forwards ("out") and taken back in backwards ("in"), and the
# bytes of the copies issued for them, to pinned host memory ("d2h") and
# back to the card ("h2d"), over every rank; ``rank_traffic`` holds the
# same per mesh position of a partitioned step (its coordinates in mesh
# axis order), so ``estimate_offload_traffic`` holds rank by rank.  On a
# CPU run the carry already lies in host memory and is kept as it is: it
# counts as a carry, and moves no byte.
traffic = {"out": 0, "in": 0, "d2h": 0, "h2d": 0}
rank_traffic = {}
_lock = threading.Lock()


def reset_traffic():
    with _lock:
        for k in traffic:
            traffic[k] = 0
        rank_traffic.clear()


def _position() -> Optional[tuple]:
    ctx = current_rank()
    return None if ctx is None else \
        tuple(ctx.coords.get(a, 0) for a in ctx.rules.mesh.axis_names)


def _count(key: str, n: int):
    pos = _position()
    with _lock:
        traffic[key] += n
        if pos is not None:
            rank_traffic.setdefault(pos, dict.fromkeys(traffic, 0))[key] += n


_streams = {}


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The copy stream of CUDA card ``device`` that carries and optimizer
    moments move on: one per card, and one per rank of a partitioned
    step on it (ranks aliased on one card copy on streams of their
    own)."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), _position())
    with _lock:
        if key not in _streams:
            _streams[key] = torch.cuda.Stream(device=key[0])
        return _streams[key]


class CarryStore:
    """The block carries one forward keeps for its backward, ``where`` =
    "device" (kept as they are) or "host" (pinned host memory).

    Host copies run on the card's side stream and are ordered by events
    only: a carry leaves after the work that produced it (the side stream
    waits for the compute stream), its device memory is not reused before
    the copy is done (``record_stream``), it is fetched back only after
    its copy out completed (the fetch waits on that event), and the
    compute stream waits on the fetch's event before the recompute reads
    it.  ``get(b)`` starts block b - 1's fetch before it returns block b's
    carry, so the copy runs under block b's recompute."""

    def __init__(self, where: str):
        if where not in ("device", "host"):
            raise ValueError(f"where {where!r}")
        self.where = where
        self._saved = {}      # block -> carry (device) | (host, copy event)
        self._fetched = {}    # block -> (device tensor, copy event)

    def put(self, b: int, x: torch.Tensor):
        if self.where == "device":
            self._saved[b] = x
            return
        _count("out", 1)
        if not x.is_cuda:
            self._saved[b] = (x, None, x.device)
            return
        _count("d2h", x.numel() * x.element_size())
        buf = _pinned(torch.empty(x.shape, dtype=x.dtype, pin_memory=True))
        side = side_stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            buf.copy_(x, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        x.record_stream(side)
        self._saved[b] = (buf, done, x.device)

    def get(self, b: int) -> torch.Tensor:
        """Block b's carry on the device; starts block b - 1's fetch."""
        if self.where == "device":
            return self._saved.pop(b)
        if b not in self._fetched:
            self._fetch(b)
        if b - 1 in self._saved:
            self._fetch(b - 1)
        x, done = self._fetched.pop(b)
        if done is not None:
            main = torch.cuda.current_stream(x.device)
            main.wait_event(done)
            x.record_stream(main)
        return x

    def _fetch(self, b: int):
        buf, d2h, device = self._saved.pop(b)
        _count("in", 1)
        if d2h is None:
            self._fetched[b] = (buf, None)
            return
        _count("h2d", buf.numel() * buf.element_size())
        side = side_stream(device)
        with torch.cuda.stream(side):
            side.wait_event(d2h)
            x = torch.empty(buf.shape, dtype=buf.dtype, device=device)
            x.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        self._fetched[b] = (x, done)
