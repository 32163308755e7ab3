"""Sentinel's data-object model of one profiled training step (port of
the dataclasses of ``repro/core/profiler.py``).

A ``TraceProfile`` lists every data object (tensor) of one step — its size,
its defining and last-consuming layer step and its access count — with
per-step FLOPs and bytes.  The planner and the policies read only these
values.  The tracer that fills them from a traced step waits for the
training side of the port (ROADMAP, modules to port: item 10).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

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
