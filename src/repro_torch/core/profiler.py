"""Sentinel's data-object profiler (port of ``repro/core/profiler.py``).

A ``TraceProfile`` lists every data object (tensor) of one training step —
its size, its defining and last-consuming layer step and its access count —
with per-step FLOPs and bytes.  The planner and the policies read only these
values.  ``trace_profile`` fills it from one traced forward and backward:
the paper profiles a step by poisoning pages; the reference walks the
step's jaxpr; the port watches every aten op of the step through a
``TorchDispatchMode`` on the meta device, so nothing is allocated.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import telemetry

PAGE = 4096

# elementwise / layout primitives the compiler fuses into their consumer
# when single-use (the primitive names the profiled step records)
_FUSIBLE = frozenset({
    "add", "sub", "mul", "div", "neg", "exp", "log", "tanh", "logistic",
    "rsqrt", "sqrt", "pow", "integer_pow", "max", "min", "abs", "sign",
    "convert_element_type", "select_n", "broadcast_in_dim", "reshape",
    "transpose", "squeeze", "expand_dims", "slice", "concatenate", "pad",
    "stop_gradient", "custom_jvp_call", "erf", "floor", "ceil", "round",
    "is_finite", "and", "or", "not", "xor", "eq", "ne", "lt", "le", "gt",
    "ge", "rem", "clamp", "real", "imag", "iota", "copy",
})


@dataclass
class DataObject:
    uid: int
    size: int                 # bytes
    birth: int                # layer-step index (-1 = pre-model / boundary)
    death: int                # last read step
    reads: int                # number of consuming equations
    kind: str                 # "weight" | "activation"
    shape: Tuple[int, ...] = ()
    dtype: str = ""
    accesses: List[int] = field(default_factory=list)  # distinct steps touched
    prim: str = ""            # producing primitive

    # The compiler fuses single-consumer elementwise chains into their
    # consumer: those values never hit main memory. The memory-relevant
    # object set excludes them (mirrors the paper's "data object" = an actual allocation).
    @property
    def fused(self) -> bool:
        return self.prim in _FUSIBLE and self.reads <= 1

    @property
    def lifetime(self) -> int:
        return max(0, self.death - self.birth)

    @property
    def small(self) -> bool:
        return self.size < PAGE


@dataclass
class LayerStats:
    step: int
    flops: float = 0.0
    bytes_accessed: float = 0.0
    produced_long: float = 0.0   # bytes of long-lived objects born here
    produced_short: float = 0.0
    reads_long: float = 0.0      # bytes of long-lived objects last-read here


@dataclass
class TraceProfile:
    num_periods: int
    num_steps: int               # 2 * num_periods (fwd + bwd timeline)
    objects: List[DataObject] = field(default_factory=list)
    layers: Dict[int, LayerStats] = field(default_factory=dict)
    total_flops: float = 0.0
    matmul_flops: float = 0.0    # the products' share of total_flops (the
                                 # port's tracer fills it; the reference's
                                 # profile has no such field)

    # ---------------- aggregate views used by planner / benchmarks ----------
    def short_lived(self, max_span: int = 1, include_fused: bool = False) -> List[DataObject]:
        return [o for o in self.objects if o.kind == "activation"
                and o.lifetime <= max_span and (include_fused or not o.fused)]

    def long_lived(self, min_span: int = 2) -> List[DataObject]:
        return [o for o in self.objects
                if o.kind == "activation" and o.lifetime >= min_span
                and not o.fused]

    def weights(self) -> List[DataObject]:
        return [o for o in self.objects if o.kind == "weight"]

    def peak_bytes(self) -> float:
        """Peak concurrently-live bytes over the step timeline."""
        deltas = defaultdict(float)
        for o in self.objects:
            if o.kind == "activation" and o.fused:
                continue
            deltas[o.birth] += o.size
            deltas[o.death + 1] -= o.size
        peak = cur = 0.0
        for s in sorted(deltas):
            cur += deltas[s]
            peak = max(peak, cur)
        return peak

    def rs_bytes(self, mi: int) -> float:
        """RS(MI): the reserved fast-memory pool of paper §4.3 — peak
        *concurrently alive* short-lived bytes within any MI-step interval.
        The pool is reused as objects free (paper: "the space is dynamically
        shrunk ... when a page in the space is freed"), so RS is nearly
        MI-independent — matching the paper's observation that RS is stable.
        """
        alive = defaultdict(float)
        for o in self.short_lived():
            for s in range(o.birth, o.death + 1):
                alive[s] += o.size
        if not alive:
            return 0.0
        # max over intervals of (max alive within the interval) == global max
        return max(alive.values())

    def step_flops(self, s: int) -> float:
        ls = self.layers.get(s)
        return ls.flops if ls else 0.0

    def step_bytes(self, s: int) -> float:
        ls = self.layers.get(s)
        return ls.bytes_accessed if ls else 0.0


# Timeline layout (P = num_periods):
#   0            embed / input boundary (forward)
#   1 .. P       forward periods
#   P+1          head + loss (fwd & bwd — same point in time)
#   P+2 .. 2P+1  backward periods (period p -> 2P+1-p)
#   2P+2         embedding gradient + optimizer update


def timeline_steps(num_periods: int) -> int:
    return 2 * num_periods + 3


# ----------------------------------------------------------------- tracer ----

# aten ops under the reference's primitive names, where one exists, so that
# DataObject.fused and _FUSIBLE mean the same on both packages' profiles;
# other ops keep their aten name
_PRIM = {
    "mm": "dot_general", "bmm": "dot_general", "addmm": "dot_general",
    "baddbmm": "dot_general", "sigmoid": "logistic", "maximum": "max",
    "minimum": "min", "_to_copy": "convert_element_type",
    "where": "select_n", "cat": "concatenate", "constant_pad_nd": "pad",
    "clone": "copy", "remainder": "rem", "arange": "iota",
    "bitwise_and": "and", "logical_and": "and", "bitwise_or": "or",
    "logical_or": "or", "bitwise_not": "not", "logical_not": "not",
    "bitwise_xor": "xor", "isfinite": "is_finite", "rsub": "sub",
    "full": "broadcast_in_dim", "full_like": "broadcast_in_dim",
    "zeros_like": "broadcast_in_dim", "ones_like": "broadcast_in_dim",
    "new_zeros": "broadcast_in_dim", "zeros": "broadcast_in_dim",
    "ones": "broadcast_in_dim", "new_ones": "broadcast_in_dim",
    "scalar_tensor": "broadcast_in_dim", "sum": "reduce_sum",
    "amax": "reduce_max", "embedding": "gather", "gather": "gather",
}
_DOTS = ("mm", "bmm", "addmm", "baddbmm")


def _dot_flops(name: str, args) -> float:
    """2 M N K of one (batched) product: the last operand pair's shapes."""
    a, b = args[-2], args[-1]
    batch = a.shape[0] if name in ("bmm", "baddbmm") else 1
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_TRACER: Optional["_Tracer"] = None


class _StepMark(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd: int, bwd: int):
        ctx.bwd = bwd
        _TRACER.step = fwd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if _TRACER is not None:
            _TRACER.step = ctx.bwd
        return g, None, None


def mark(x: torch.Tensor, fwd: int, bwd: int) -> torch.Tensor:
    """A timeline mark on the residual stream while ``trace_profile``
    runs (x itself otherwise): the ops after it in the forward belong to
    step ``fwd``; the backward ops after its gradient passes (the ones of
    the layers before it) to step ``bwd``.  ``stack_forward`` puts one
    before each period when ``unroll_periods`` is set, in place of the
    reference's ``named_scope("period_{i}")``: the port's periods are not
    modules (zamba2's shared block is one module in all of them), so a
    module's hooks could not tell its periods apart."""
    return x if _TRACER is None else _StepMark.apply(x, fwd, bwd)


class _Tracer(TorchDispatchMode):
    """Every aten op of the traced step: its outputs with storage of their
    own are data objects born at the current step; every tensor it reads
    (a view through its base's storage) is a read of that object."""

    def __init__(self, prof: TraceProfile):
        super().__init__()
        self.prof, self.step = prof, 0
        self.objects: Dict[int, DataObject] = {}
        self.keep = []            # storages stay alive: their keys stay unique

    def birth(self, t: torch.Tensor, kind: str, prim: str = ""):
        size = t.untyped_storage().nbytes()
        if size == 0:
            return
        self.keep.append(t.untyped_storage())
        self.objects[_key(t)] = DataObject(
            len(self.objects), size, self.step, self.step, 0, kind,
            tuple(t.shape), str(t.dtype).replace("torch.", ""),
            [] if kind == "weight" else [self.step], prim)

    def read(self, t: torch.Tensor):
        o = self.objects.get(_key(t))
        if o is not None:
            o.reads += 1
            o.death = max(o.death, self.step)
            if not o.accesses or o.accesses[-1] != self.step:
                o.accesses.append(self.step)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in ins:
            self.read(t)
        fresh = [t for t in outs if _key(t) not in self.objects]
        if not fresh and not func._schema.is_mutable:
            return out            # a view or an alias: a read of its base
        name = func.overloadpacket.__name__
        for t in fresh:
            self.birth(t, "activation", _PRIM.get(name, name))
        ls = self.prof.layers.setdefault(self.step, LayerStats(self.step))
        if name in _DOTS:
            f = _dot_flops(name, args)
            self.prof.matmul_flops += f
        else:
            f = float(sum(t.numel() for t in outs))
        ls.flops += f
        self.prof.total_flops += f
        ls.bytes_accessed += sum(_bytes(t) for t in ins + outs)
        return out


def trace_profile(fn: Callable, params: torch.nn.Module, batch: dict, *,
                  num_periods: int) -> TraceProfile:
    """Trace one forward and backward of ``fn(params, batch)`` (a scalar
    loss, typically ``model.loss_fn(..., unroll_periods=True)``) and build
    the data-object profile.  ``params`` and ``batch`` are normally on the
    meta device (``init_params(cfg, device="meta", requires_grad=True)``),
    so the trace allocates nothing, as the reference traces
    ``ShapeDtypeStruct``s.

    Objects: every parameter and batch tensor is a weight born at step 0
    (the reference's jaxpr inputs); every op output with storage of its own
    is an activation, named by its aten op or, where one exists, the
    reference's primitive; views and in-place results are reads of their
    storage's object, not births; the gradients are read at the last step.
    Steps follow the reference's timeline (``timeline_steps``): 0 the
    embedding, p + 1 forward period p, P + 1 the head and the loss,
    2P + 1 - p the backward of period p, 2P + 2 the embedding gradient;
    the prologue's ops go with the embedding forward and period 0's
    backward, as the reference's unscoped ops inherit the step before
    them.  FLOPs: 2 M N K for mm, bmm, addmm and baddbmm, output elements
    for every other op; bytes: inputs and outputs once each; views count
    neither.

    On the meta device ``ops.ssd`` takes the plain version (its input is
    not a CUDA tensor), so the SSD scan's own tensors are objects here,
    where the reference's jaxpr holds the kernel's call."""
    global _TRACER
    with telemetry.span("plan.profile"):
        P = num_periods
        prof = TraceProfile(num_periods=P, num_steps=timeline_steps(P))
        tracer = _Tracer(prof)
        weights = list(params.parameters()) + [
            t for t in tree_leaves(batch) if isinstance(t, torch.Tensor)]
        for t in weights:
            if _key(t) not in tracer.objects:
                tracer.birth(t, "weight")
        wrt = [w for w in params.parameters() if w.requires_grad]
        if _TRACER is not None:
            raise RuntimeError("trace_profile does not nest")
        _TRACER = tracer
        try:
            with tracer:
                grads = torch.autograd.grad(fn(params, batch), wrt)
                tracer.step = timeline_steps(P) - 1
                for g in grads:
                    tracer.read(g)
        finally:
            _TRACER = None
        prof.objects = list(tracer.objects.values())

        # per-layer long/short production aggregates
        for o in prof.objects:
            if o.kind != "activation":
                continue
            ls = prof.layers.setdefault(max(o.birth, 0),
                                        LayerStats(max(o.birth, 0)))
            if o.lifetime <= 1:
                ls.produced_short += o.size
            else:
                ls.produced_long += o.size
                d = max(o.death, 0)
                prof.layers.setdefault(d, LayerStats(d)).reads_long += o.size
        return prof
