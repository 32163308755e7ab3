"""Unified tier/trace model: the one object-granular view of a workload.

Sentinel's core claim is a single idea — repeatable workloads let the runtime
place *data objects* (not pages) across memory tiers using known lifetimes.
This module is the shared vocabulary both workload families speak:

  MemoryTier      a named tier (bandwidth + capacity) derived from an HWSpec.
  DataObject      one placeable allocation: bytes, birth/death, and a
                  step-indexed access schedule.  Training long-lived
                  activations/weights and serving KV blocks are both
                  DataObjects (serving reuses ``hmsim.KVObject`` directly —
                  anything with uid/bytes/birth/death/accesses qualifies).
  AccessTimeline  the fully resolved replayable timeline: per-step compute
                  and traffic, object birth/free/read events, and the
                  reserve-pool accounting of paper §4.3.
  Workload        the protocol both stacks adapt into: ``TrainingWorkload``
                  wraps a profiler ``TraceProfile`` (timeline steps = layer
                  steps of one training iteration), ``ServingWorkload`` wraps
                  an ``hmsim.ServeTrace`` (timeline steps = decode tokens).
                  Phase/step semantics of each source are preserved — the
                  adapters translate, they do not approximate.

Every placement policy in ``runtime/policies.py`` and the unified planner in
``runtime/plan.py`` consume only this model, which is what makes every policy
benchmarkable on every workload.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Dict, List, Optional, Protocol, Sequence,
                    runtime_checkable)

from repro_torch.core.hardware import HWSpec


@dataclass(frozen=True)
class MemoryTier:
    """One memory tier. ``capacity`` None means unbounded (the slow tier).

    ``bandwidth`` is the *read* bandwidth compute sees against this tier
    (the roofline denominator) — NOT the rate of moving data in or out of
    it.  The two-tier model historically conflated the two through
    ``hw.mig_bw``; transfer rates are a property of the link, carried by
    ``tiergraph.TierEdge`` and sourced from the ``CostModel`` migration
    fields (``mig_read_bw``/``mig_write_bw``/``link_bw``).
    """
    name: str
    bandwidth: float                 # read bandwidth, B/s (see docstring)
    capacity: Optional[float] = None


def tiers_from_hw(hw: HWSpec, fast_bytes: float) -> List[MemoryTier]:
    """The two-tier model every policy assumes: fast (HBM / near DRAM,
    capacity-limited) over slow (host / far DRAM, unbounded).

    Since the tier-graph generalization this is the trivial 2-node
    ``TierGraph`` instance — the node list is byte-identical to what this
    helper always returned."""
    from repro_torch.runtime.tiergraph import TierGraph   # avoid import cycle
    return TierGraph.two_tier(hw, fast_bytes).tiers


@dataclass
class DataObject:
    """A placeable data object on the unified timeline.

    Serving KV blocks (``hmsim.KVObject``) are consumed duck-typed — the
    policies only touch ``uid``/``bytes``/``birth``/``death``/``accesses``
    (and optionally ``shared_key``) — so this class is instantiated for
    training-derived timelines and any synthetic workloads.

    ``shared_key``: objects carrying the same non-None key are aliases of
    ONE physical allocation (a shared prompt prefix mapped to the same
    refcounted pages).  Sharing-aware policies and the capacity accounting
    charge the group's bytes once; reads still charge per access (each
    reader streams the bytes through its own attention)."""
    uid: int
    bytes: int
    birth: int
    death: int
    accesses: List[int] = field(default_factory=list)   # sorted step indices
    kind: str = "object"            # "weight" | "activation" | "kv" | ...
    meta: dict = field(default_factory=dict)
    shared_key: Optional[tuple] = None
    tenant: Optional[str] = None    # owning tenant id (multi-tenant runs)

    @property
    def lifetime(self) -> int:
        return max(0, self.death - self.birth)


def peak_object_bytes(objects) -> float:
    """Peak concurrently-live bytes over a set of objects, counting every
    shared group (equal non-None ``shared_key``) once: the group's bytes are
    live exactly over the union of its members' [birth, death] intervals —
    physical pages exist while any reference does, like a
    ``kvcache.PageTable`` refcount."""
    deltas: Dict[int, float] = {}

    def add(t, b):
        deltas[t] = deltas.get(t, 0.0) + b

    groups: Dict[tuple, List[Any]] = {}
    for o in objects:
        k = getattr(o, "shared_key", None)
        if k is None:
            add(o.birth, o.bytes)
            add(o.death + 1, -o.bytes)
        else:
            groups.setdefault(k, []).append(o)
    for objs in groups.values():
        b = objs[0].bytes
        ivs = sorted((o.birth, o.death) for o in objs)
        lo, hi = ivs[0]
        for lo2, hi2 in ivs[1:]:
            if lo2 <= hi + 1:                     # refcount never hit zero
                hi = max(hi, hi2)
            else:
                add(lo, b)
                add(hi + 1, -b)
                lo, hi = lo2, hi2
        add(lo, b)
        add(hi + 1, -b)
    peak = cur = 0.0
    for t in sorted(deltas):
        cur += deltas[t]
        peak = max(peak, cur)
    return peak


@dataclass
class AccessTimeline:
    """The resolved replayable timeline of one workload.

    Per-step scalars (length ``num_steps``):
      flops            compute issued at the step
      total_bytes      all memory traffic of the step (roofline numerator)
      fixed_fast_bytes traffic always charged to the fast tier no matter the
                       placement (KV writes + weight streaming in serving;
                       reserve-pool/fused traffic in training) — the policies
                       only ever move ``total - fixed`` between tiers
      tokens           units of work completed (decode tokens; 0 in training)
      extra_flops/extra_fast_bytes
                       off-timeline work folded into the step (slot-refill
                       prefill in serving; zero in training)

    ``admits``/``births``/``frees``/``reads`` are the per-step event lists the
    event-driven policies replay, in the exact order the source trace resolved
    them.  ``reserved_bytes`` is fast memory pre-committed outside the object
    set (training short-lived pool, §4.3); serving reserves through the open
    KV blocks which *are* timeline objects, so it is 0 there.
    """
    kind: str                       # "training" | "serving"
    num_steps: int
    objects: List[Any]
    flops: List[float]
    total_bytes: List[float]
    fixed_fast_bytes: List[float]
    tokens: List[int]
    extra_flops: List[float]
    extra_fast_bytes: List[float]
    admits: Dict[int, List[Any]]
    births: Dict[int, List[Any]]
    frees: Dict[int, List[Any]]
    reads: Dict[int, List[Any]]
    reserved_bytes: float = 0.0
    source: Any = None              # the TraceProfile / ServeTrace adapted
    # shared KV bytes the cache-aware prefill reads back instead of
    # recomputing (serving only; None = no skip information in the source).
    # extra_flops/extra_fast_bytes are then *net of the compute skip*.
    prefill_read_bytes: Optional[List[float]] = None

    def timeline(self) -> "AccessTimeline":
        """A timeline is its own Workload (lets policies re-dispatch)."""
        return self

    def reserve_bytes(self, mi: int = 1) -> float:
        """RS(MI) of paper §4.3 on this timeline's native reserve model."""
        if self.kind == "training" and self.source is not None:
            return self.source.rs_bytes(mi)
        if self.kind == "serving" and self.source is not None:
            return self.source.rs_bytes()
        return self.reserved_bytes

    def peak_bytes(self) -> float:
        """Peak concurrently-live object bytes over the timeline (shared
        groups counted once — see ``peak_object_bytes``)."""
        if self.kind == "serving" and hasattr(self.source, "peak_kv_bytes"):
            return self.source.peak_kv_bytes()   # same object set, one impl
        return peak_object_bytes(self.objects)

    def step_time_all_fast(self, s: int, hw: HWSpec) -> float:
        """Roofline step time with every byte in the fast tier."""
        return max(self.flops[s] / hw.peak_flops,
                   self.total_bytes[s] / hw.fast_bw)

    def extra_time(self, s: int, hw: HWSpec) -> float:
        """Off-timeline add-on (prefill) at step s; always fast-tier."""
        pread = self.prefill_read_bytes[s] if self.prefill_read_bytes else 0.0
        if not self.extra_flops[s] and not self.extra_fast_bytes[s] \
                and not pread:
            return 0.0
        return max(self.extra_flops[s] / hw.peak_flops,
                   (self.extra_fast_bytes[s] + pread) / hw.fast_bw)


@runtime_checkable
class Workload(Protocol):
    """Anything the unified runtime can plan for."""
    kind: str

    def timeline(self) -> AccessTimeline: ...


class TrainingWorkload:
    """Adapter: profiler ``TraceProfile`` -> unified timeline.

    Timeline steps are the profiler's layer steps of one training iteration
    (forward periods, head/loss, backward periods, optimizer boundary).  The
    placeable objects are the long-lived activations and accessed weights —
    exactly the paper's migration candidates; short-lived objects stay in the
    reserved pool (``reserved_bytes``) and their traffic rides in
    ``fixed_fast_bytes``.
    """

    kind = "training"

    def __init__(self, profile):
        self.profile = profile
        self._tl: Optional[AccessTimeline] = None

    def timeline(self) -> AccessTimeline:
        if self._tl is not None:
            return self._tl
        prof = self.profile
        steps = prof.num_steps
        objects: List[DataObject] = []
        for o in prof.objects:
            if not o.accesses or getattr(o, "fused", False):
                continue
            if o.kind == "activation" and o.lifetime < 2:
                continue                      # reserve pool, never placed
            objects.append(DataObject(o.uid, o.size, max(0, o.birth),
                                      max(0, o.death),
                                      sorted(set(o.accesses)), o.kind))
        admits: Dict[int, List[Any]] = {}
        births: Dict[int, List[Any]] = {}
        frees: Dict[int, List[Any]] = {}
        reads: Dict[int, List[Any]] = {}
        obj_read_bytes = [0.0] * steps
        for o in objects:
            (admits if o.kind == "weight" else births).setdefault(
                o.birth if o.kind != "weight" else 0, []).append(o)
            frees.setdefault(o.death + 1, []).append(o)
            for s in o.accesses:
                if 0 <= s < steps:
                    reads.setdefault(s, []).append(o)
                    obj_read_bytes[s] += o.bytes
        flops = [prof.step_flops(s) for s in range(steps)]
        total = [prof.step_bytes(s) for s in range(steps)]
        fixed = [max(0.0, total[s] - obj_read_bytes[s]) for s in range(steps)]
        self._tl = AccessTimeline(
            kind=self.kind, num_steps=steps, objects=objects, flops=flops,
            total_bytes=total, fixed_fast_bytes=fixed, tokens=[0] * steps,
            extra_flops=[0.0] * steps, extra_fast_bytes=[0.0] * steps,
            admits=admits, births=births, frees=frees, reads=reads,
            reserved_bytes=prof.rs_bytes(1), source=prof)
        return self._tl


class ServingWorkload:
    """Adapter: ``hmsim.ServeTrace`` -> unified timeline.

    Timeline steps are decode-token steps; the objects are the trace's KV
    blocks (used directly — identity-preserving, so event order and therefore
    simulated numbers are bit-identical to the pre-unification serve
    simulator).  Prefill work at slot refills rides in the ``extra_*``
    channels, KV writes + weight streaming in ``fixed_fast_bytes``.
    """

    kind = "serving"

    def __init__(self, trace):
        self.trace = trace
        self._tl: Optional[AccessTimeline] = None

    def timeline(self) -> AccessTimeline:
        if self._tl is not None:
            return self._tl
        tr = self.trace
        steps = tr.num_steps
        flops, fixed, total = [], [], []
        tokens, eflops, ebytes, pread = [], [], [], []
        skip_tok = getattr(tr, "prefill_skip_tokens", None) or {}
        for t in range(steps):
            act = tr.active.get(t, 0)
            flops.append(act * tr.flops_per_token)
            fx = tr.write_bytes(t) + tr.weight_bytes
            fixed.append(fx)
            total.append(fx + sum(o.bytes for o in tr.reads.get(t, ())))
            tokens.append(act)
            # cache-aware prefill: shared-prefix rows a donor already
            # materialized are skipped (net flops/writes), their KV read
            # back through the fast tier instead
            p_tok = tr.prefill_tokens.get(t, 0)
            skip = min(skip_tok.get(t, 0), p_tok)
            eflops.append((p_tok - skip) * tr.flops_per_token)
            ebytes.append((p_tok - skip) * tr.num_layers * tr.kv_token_bytes)
            pread.append(skip * tr.num_layers * tr.kv_token_bytes)
        self._tl = AccessTimeline(
            kind=self.kind, num_steps=steps, objects=tr.objects, flops=flops,
            total_bytes=total, fixed_fast_bytes=fixed, tokens=tokens,
            extra_flops=eflops, extra_fast_bytes=ebytes, admits=tr.admits,
            births=tr.births, frees=tr.frees, reads=tr.reads,
            reserved_bytes=0.0, source=tr,
            prefill_read_bytes=pread if any(pread) else None)
        return self._tl


@dataclass(frozen=True)
class Tenant:
    """One tenant of a multi-tenant serving deployment.

    ``id``               stable string identity (JSON-safe: it keys the plan's
                         per-tenant accounting dicts).
    ``fast_quota_frac``  the tenant's *guaranteed* share of the fast-memory
                         placement budget, as a fraction.  None means
                         "unspecified": ``normalized_quotas`` grants such
                         tenants an equal split of whatever fraction the
                         explicit quotas leave unreserved.
    ``slo_slack``        allowed decode slowdown versus all-fast (the
                         decode-latency SLO, expressed as a ratio >= 1).  It
                         orders *graceful degradation*: when guaranteed
                         capacity must be reclaimed from borrowers, tenants
                         with the loosest SLO give pages back first.
    ``arrival``          decode step the tenant's request stream starts at —
                         its arrival trace offset on the merged timeline.
    """
    id: str
    fast_quota_frac: Optional[float] = None
    slo_slack: float = 1.0
    arrival: int = 0


def normalized_quotas(tenants: Sequence[Tenant]) -> Dict[str, float]:
    """Per-tenant guaranteed fast-memory fractions, summing to <= 1.

    Explicit ``fast_quota_frac`` values are kept (rescaled only if they
    oversubscribe); tenants with an unspecified quota (None) split the
    leftover fraction evenly — every tenant ends up with a guarantee.
    """
    fixed = {t.id: float(t.fast_quota_frac) for t in tenants
             if t.fast_quota_frac is not None}
    total_fixed = sum(fixed.values())
    if total_fixed > 1.0:
        fixed = {k: v / total_fixed for k, v in fixed.items()}
        total_fixed = 1.0
    rest = [t.id for t in tenants if t.id not in fixed]
    out = dict(fixed)
    if rest:
        share = max(0.0, 1.0 - total_fixed) / len(rest)
        for tid in rest:
            out[tid] = share
    return out


def merge_tenant_traces(tenants: Sequence[Tenant], traces: Sequence[Any],
                        shared_prefix_ids: Sequence[Any] = ()):
    """Interleave N tenants' ``hmsim.ServeTrace``s into ONE trace.

    Each tenant's trace is shifted by its ``arrival`` offset and mapped onto
    a disjoint slot range (the tenant's private continuous-batching slots —
    one model instance serves everyone, so weight streaming is charged
    once); every KV object is re-uid'ed and tagged with its tenant id.
    ``shared_key``s are *namespaced per tenant* by default — two tenants'
    traces built independently with the conventional ``prefix_id`` 0 hold
    physically distinct prompts, and coalescing them would undercount
    capacity and migration.  Prefix ids listed in ``shared_prefix_ids`` are
    declared platform-wide (one system prompt serving every tenant) and
    keep their keys verbatim, so they stay ONE physical allocation across
    tenants.  Returns ``(merged_trace, slot_tenants)`` where
    ``slot_tenants[s]`` names the tenant owning merged slot ``s``.
    """
    import copy

    from repro_torch.core.hmsim import ServeTrace
    if len(tenants) != len(traces) or not tenants:
        raise ValueError("merge_tenant_traces needs one trace per tenant")
    t0 = traces[0]
    for tr in traces[1:]:
        same = all(getattr(tr, f) == getattr(t0, f) for f in
                   ("num_layers", "block_tokens", "recent_window",
                    "history_period", "kv_token_bytes", "weight_bytes",
                    "flops_per_token"))
        if not same:
            raise ValueError("tenant traces must share one model geometry "
                             "(layers/block/window/period/kv/weight/flops)")
    merged = ServeTrace(
        num_slots=sum(tr.num_slots for tr in traces),
        num_layers=t0.num_layers, block_tokens=t0.block_tokens,
        recent_window=t0.recent_window, history_period=t0.history_period,
        kv_token_bytes=t0.kv_token_bytes, weight_bytes=t0.weight_bytes,
        flops_per_token=t0.flops_per_token)
    shared_ids = set(shared_prefix_ids)
    slot_tenants: List[str] = []
    uid = slot_off = 0
    for tn, tr in zip(tenants, traces):
        dt = max(0, int(tn.arrival))
        slot_tenants += [tn.id] * tr.num_slots
        remap: Dict[int, Any] = {}
        for o in tr.objects:
            c = copy.copy(o)
            c.uid, uid = uid, uid + 1
            c.slot = o.slot + slot_off
            c.birth, c.death = o.birth + dt, o.death + dt
            c.accesses = [a + dt for a in o.accesses]
            c.tenant = tn.id
            if c.shared_key is not None and \
                    c.shared_key[0] not in shared_ids:
                c.shared_key = (tn.id,) + tuple(c.shared_key)
            remap[o.uid] = c
            merged.objects.append(c)
        for src, dst in ((tr.admits, merged.admits),
                         (tr.births, merged.births),
                         (tr.frees, merged.frees), (tr.reads, merged.reads)):
            for t, objs in src.items():
                dst.setdefault(t + dt, []).extend(remap[o.uid] for o in objs)
        for t, n in tr.active.items():
            merged.active[t + dt] = merged.active.get(t + dt, 0) + n
        for t, n in tr.prefill_tokens.items():
            merged.prefill_tokens[t + dt] = \
                merged.prefill_tokens.get(t + dt, 0) + n
        for t, n in tr.prefill_skip_tokens.items():
            merged.prefill_skip_tokens[t + dt] = \
                merged.prefill_skip_tokens.get(t + dt, 0) + n
        merged.num_steps = max(merged.num_steps, tr.num_steps + dt)
        slot_off += tr.num_slots
    return merged, slot_tenants


class MultiTenantWorkload:
    """Adapter: N tenants x N ``ServeTrace``s -> one unified timeline.

    The third scenario on the unified surface: capacity pressure comes from
    *competing* request streams instead of one model's phases.  The merged
    trace is a plain ``ServeTrace`` whose objects carry tenant tags, so every
    registered policy runs on it unchanged; the SLO-aware planner half reads
    ``tenants`` / ``tenant_quotas`` / ``slot_tenants`` off this adapter to
    enforce per-tenant shares.
    """

    kind = "serving"

    def __init__(self, tenants: Sequence[Tenant], traces: Sequence[Any],
                 shared_prefix_ids: Sequence[Any] = ()):
        self.tenants = list(tenants)
        if len({t.id for t in self.tenants}) != len(self.tenants):
            raise ValueError("tenant ids must be unique")
        self.trace, self.slot_tenants = merge_tenant_traces(
            tenants, traces, shared_prefix_ids)
        self.tenant_quotas = normalized_quotas(self.tenants)
        self.tenant_slack = {t.id: float(t.slo_slack) for t in self.tenants}
        self._tl: Optional[AccessTimeline] = None

    def timeline(self) -> AccessTimeline:
        if self._tl is None:
            self._tl = ServingWorkload(self.trace).timeline()
        return self._tl


def as_workload(w: Any):
    """Coerce a TraceProfile / ServeTrace / Workload into a Workload.

    Dispatch is structural (no imports of the source modules): a training
    profile exposes ``num_periods``, a serving trace ``num_slots``.
    """
    if isinstance(w, (TrainingWorkload, ServingWorkload)):
        return w
    if hasattr(w, "timeline") and hasattr(w, "kind"):
        return w
    if hasattr(w, "num_periods") and hasattr(w, "objects"):
        return TrainingWorkload(w)
    if hasattr(w, "num_slots") and hasattr(w, "kv_token_bytes"):
        return ServingWorkload(w)
    raise TypeError(f"cannot adapt {type(w).__name__} into a runtime "
                    "Workload (expected TraceProfile, ServeTrace, or an "
                    "object implementing the Workload protocol)")
