"""Tier graphs: the memory system as a topology, not a pair.

Everything before this module assumed exactly two tiers — fast HBM over an
unbounded slow host — because that is the machine the source paper measures.
Production serving runs on a *mesh*: device-A HBM ↔ device-B HBM ↔ host,
with distinct bandwidth on every link (NVLink between devices, PCIe to the
host, DDR inside it).  Following RIMMS and Unimem (PAPERS.md), this module
models that memory system as a directed graph of ``MemoryTier`` nodes with
per-edge bandwidths, while keeping every registered policy unchanged:

  TierGraph     frozen graph of ``MemoryTier`` nodes + ``TierEdge`` links.
                ``two_tier(hw, fast_bytes)`` is the trivial 2-node instance
                — ``objects.tiers_from_hw`` now routes through it, so the
                whole existing planner/policy surface is the special case.
  path_bw       max-bottleneck (widest-path) bandwidth between two tiers:
                what a transfer can actually sustain end to end.
  GraphHW       a duck-typed ``HWSpec`` view of the graph as seen from one
                compute node.  Policies only consume ``peak_flops`` /
                ``fast_bw`` / ``slow_bw`` / ``mig_bw`` / ``mig_overhead``,
                so any graph folds to the two tiers the compute node sees:
                its own HBM, and the spill tier with the widest path in.
                On a ``two_tier`` graph the fold reproduces the underlying
                machine's numbers exactly — bit-identical simulation.

Node bandwidth vs edge bandwidth: ``MemoryTier.bandwidth`` is the *read*
bandwidth compute sees against that tier (the roofline denominator).  The
bandwidth of *moving* data between tiers is a property of the link, not the
node — that is what ``TierEdge.bandwidth`` carries, sourced from the
``CostModel`` migration fields (``mig_read_bw``/``mig_write_bw``/
``link_bw``).  The old two-tier model conflated the two through
``hw.mig_bw``; the graph keeps them distinct.

Serialization: ``PlacementPlan`` carries ``graph.to_dict()`` when the graph
is non-trivial; canonical two-tier plans keep the field ``None`` so
``objective="bytes"`` plan JSONs stay byte-identical to the goldens.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.objects import MemoryTier

__all__ = ["TierEdge", "TierGraph", "GraphHW"]


@dataclass(frozen=True)
class TierEdge:
    """One directed transfer link ``src -> dst`` at ``bandwidth`` B/s.

    Edge bandwidth is the DMA/interconnect rate of the link itself —
    distinct from the endpoints' read bandwidths (see module doc)."""
    src: str
    dst: str
    bandwidth: float


@dataclass(frozen=True)
class TierGraph:
    """A directed graph of memory tiers with per-edge bandwidths.

    ``nodes[0]`` is the compute tier by convention — the tier whose
    bandwidth is the roofline denominator (override per-view via
    ``hw_view(compute=...)``).  Capacity ``None`` marks an unbounded node
    (the host).  The graph is frozen and hashable so plans and caches can
    key on it.
    """
    nodes: Tuple[MemoryTier, ...]
    edges: Tuple[TierEdge, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "nodes", tuple(self.nodes))
        object.__setattr__(self, "edges", tuple(self.edges))
        names = [n.name for n in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        if not names:
            raise ValueError("a TierGraph needs at least one node")
        known = set(names)
        for e in self.edges:
            if e.src not in known or e.dst not in known:
                raise ValueError(f"edge {e.src}->{e.dst} references an "
                                 f"unknown tier (nodes: {sorted(known)})")
            if e.src == e.dst:
                raise ValueError(f"self-edge on {e.src}")
            if e.bandwidth <= 0:
                raise ValueError(f"edge {e.src}->{e.dst}: non-positive "
                                 f"bandwidth {e.bandwidth}")

    # ------------------------------------------------------------ queries --
    @property
    def names(self) -> List[str]:
        return [n.name for n in self.nodes]

    @property
    def tiers(self) -> List[MemoryTier]:
        """The node list in ``PlacementPlan.tiers`` order (compute first)."""
        return list(self.nodes)

    def node(self, name: str) -> MemoryTier:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(f"unknown tier {name!r}; nodes: {self.names}")

    def capacity(self, name: str) -> Optional[float]:
        """Capacity of one tier (None = unbounded)."""
        return self.node(name).capacity

    def edge_bw(self, src: str, dst: str) -> float:
        """Direct-link bandwidth ``src -> dst``; 0.0 when no edge exists."""
        for e in self.edges:
            if e.src == src and e.dst == dst:
                return e.bandwidth
        return 0.0

    def path_bw(self, src: str, dst: str) -> float:
        """Max-bottleneck bandwidth from ``src`` to ``dst``: the widest
        path's narrowest link — what one transfer can sustain end to end.
        ``inf`` for src == dst, 0.0 when unreachable."""
        self.node(src), self.node(dst)
        if src == dst:
            return math.inf
        # widest-path Dijkstra: expand the frontier by best bottleneck
        best = {src: math.inf}
        heap = [(-math.inf, src)]
        while heap:
            neg_w, u = heapq.heappop(heap)
            w = -neg_w
            if u == dst:
                return w
            if w < best.get(u, 0.0):
                continue
            for e in self.edges:
                if e.src != u:
                    continue
                cand = min(w, e.bandwidth)
                if cand > best.get(e.dst, 0.0):
                    best[e.dst] = cand
                    heapq.heappush(heap, (-cand, e.dst))
        return best.get(dst, 0.0)

    @property
    def is_two_tier(self) -> bool:
        """The trivial instance: exactly the fast/slow pair."""
        return self.names == ["fast", "slow"]

    def matches_two_tier(self, hw, fast_bytes: float) -> bool:
        """True when this graph *is* the canonical two-tier fold of ``hw``
        — the case where a plan's serialized graph carries no information
        beyond the plan's existing ``tiers``/``cost_model`` fields."""
        try:
            return self == TierGraph.two_tier(hw, fast_bytes)
        except Exception:
            return False

    # ------------------------------------------------------- constructors --
    @classmethod
    def two_tier(cls, hw, fast_bytes: float) -> "TierGraph":
        """The legacy fast/slow pair as a 2-node graph.  Node bandwidths
        and capacities are byte-identical to what ``tiers_from_hw`` always
        produced; edge bandwidths come from the machine's migration DMA
        fields (``CostModel.mig_read_bw``/``mig_write_bw``; a plain
        ``HWSpec`` collapses both to ``mig_bw``)."""
        promote = float(getattr(hw, "mig_read_bw", hw.mig_bw))
        demote = float(getattr(hw, "mig_write_bw", hw.mig_bw))
        return cls(
            nodes=(MemoryTier("fast", hw.fast_bw, float(fast_bytes)),
                   MemoryTier("slow", hw.slow_bw, None)),
            edges=(TierEdge("slow", "fast", promote),
                   TierEdge("fast", "slow", demote)))

    @classmethod
    def mesh(cls, num_devices: int, hw, fast_bytes_per_device: float,
             link_bw: Optional[float] = None) -> "TierGraph":
        """A device mesh: ``dev0..devN-1`` HBM nodes over one shared host.

        Device HBMs are fully connected at ``link_bw`` (default: the
        machine's ``link_bw`` — NVLink between GPUs of one host); every device
        reaches the host at the migration DMA bandwidths.  ``dev0`` is the
        compute/decode tier by the nodes[0] convention."""
        if num_devices < 1:
            raise ValueError("mesh needs >= 1 device")
        link = float(link_bw if link_bw is not None
                     else getattr(hw, "link_bw", 0.0))
        promote = float(getattr(hw, "mig_read_bw", hw.mig_bw))
        demote = float(getattr(hw, "mig_write_bw", hw.mig_bw))
        nodes = [MemoryTier(f"dev{d}", hw.fast_bw,
                            float(fast_bytes_per_device))
                 for d in range(num_devices)]
        nodes.append(MemoryTier("host", hw.slow_bw, None))
        edges: List[TierEdge] = []
        for d in range(num_devices):
            edges.append(TierEdge("host", f"dev{d}", promote))
            edges.append(TierEdge(f"dev{d}", "host", demote))
            if link > 0:
                for o in range(num_devices):
                    if o != d:
                        edges.append(TierEdge(f"dev{d}", f"dev{o}", link))
        return cls(nodes=tuple(nodes), edges=tuple(edges))

    # -------------------------------------------------------------- views --
    def hw_view(self, machine, compute: Optional[str] = None,
                spill: Optional[str] = None) -> "GraphHW":
        """Fold the graph to the duck-typed ``HWSpec`` one compute node
        sees; every registered policy runs on it unchanged."""
        return GraphHW(self, machine, compute=compute, spill=spill)

    # --------------------------------------------------------------- json --
    def to_dict(self) -> dict:
        return {
            "nodes": [{"name": n.name, "bandwidth": n.bandwidth,
                       "capacity": n.capacity} for n in self.nodes],
            "edges": [{"src": e.src, "dst": e.dst,
                       "bandwidth": e.bandwidth} for e in self.edges],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TierGraph":
        return cls(nodes=tuple(MemoryTier(**n) for n in d["nodes"]),
                   edges=tuple(TierEdge(**e) for e in d.get("edges", ())))


class GraphHW:
    """A tier graph folded to the two-tier machine one compute node sees.

    Policies and simulators consume only ``hw.peak_flops`` / ``fast_bw`` /
    ``slow_bw`` / ``mig_bw`` / ``mig_overhead`` / ``fast_bytes`` (plus the
    ``CostModel`` extras via delegation), so the fold is:

      fast_bw   the compute node's own read bandwidth
      slow_bw   the spill node's read bandwidth
      mig_bw    ``path_bw(spill -> compute)`` — the widest path a promotion
                can stream through, which on a mesh may route *via a
                neighbor device* when the device link beats the host DMA
      fast_bytes  the compute node's capacity (machine's when unbounded)

    ``spill`` defaults to the non-compute node with the widest path into
    compute, preferring unbounded (host) nodes on ties — on ``two_tier``
    graphs this reproduces the wrapped machine's numbers exactly, so the
    graph path is bit-identical to the legacy two-tier path.  Everything
    else (``peak_flops``, ``mig_overhead``, ``step_time``, pricing) is
    delegated to the wrapped machine.
    """

    def __init__(self, graph: TierGraph, machine,
                 compute: Optional[str] = None,
                 spill: Optional[str] = None):
        self.graph = graph
        self.machine = machine
        self.compute = compute or graph.nodes[0].name
        graph.node(self.compute)
        if spill is None:
            others = [n for n in graph.nodes if n.name != self.compute]
            if not others:
                raise ValueError("hw_view needs a non-compute tier to "
                                 "spill to")
            # widest path in wins; unbounded (host-like) nodes break ties
            spill = max(others, key=lambda n: (
                graph.path_bw(n.name, self.compute),
                n.capacity is None)).name
        else:
            graph.node(spill)
        self.spill = spill

    # ------------------------------------------------- the two-tier fold --
    @property
    def fast_bw(self) -> float:
        return self.graph.node(self.compute).bandwidth

    @property
    def slow_bw(self) -> float:
        return self.graph.node(self.spill).bandwidth

    @property
    def mig_bw(self) -> float:
        return self.graph.path_bw(self.spill, self.compute)

    @property
    def fast_bytes(self) -> float:
        cap = self.graph.capacity(self.compute)
        return float(cap) if cap is not None else self.machine.fast_bytes

    def __getattr__(self, name):
        # peak_flops, mig_overhead, slow/mig DMA fields, step_time, price...
        return getattr(self.machine, name)

    def __repr__(self):
        return (f"GraphHW({self.compute!r} over {self.spill!r}, "
                f"nodes={self.graph.names})")
