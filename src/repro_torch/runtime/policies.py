"""The unified placement-policy registry: every policy, every workload.

A **policy** decides which memory tier each data object lives in and what
migrates between timeline steps.  Policies register by name and are simulated
through one entry point::

    result = runtime.simulate(workload, hw, fast_bytes, "sentinel", lookahead=8)

``workload`` may be a training ``TraceProfile``, a serving ``ServeTrace``, or
anything implementing the ``Workload`` protocol (runtime/objects.py) — every
registered policy runs on every workload, which is what makes the baselines
comparable across scenarios.

Two families share the registry:

  event-driven   subclass the ``PlacementPolicy`` hook protocol
                 (on_free/on_admit/on_birth/on_reads/migrate); the shared
                 event loop replays the timeline step by step.  These are the
                 serving-native policies: ``prefer_fast``, ``lru_page``,
                 ``sentinel``.
  interval/static  override ``simulate`` directly.  These are the
                 training-native simulators re-expressed as policies:
                 ``sentinel_mi`` (the paper's MI-interval prefetch/evict
                 engine with §4.4 test-and-trial), ``ial``/``lru`` (the
                 page-grain reactive daemons), ``all_fast``/``all_slow``
                 (static placement bounds).

All of them return a ``PlacementResult``.  Per-policy semantics and the
incumbent tie-breaking rule live in ``docs/POLICIES.md``.
"""
from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Type

from repro_torch.core.hardware import HWSpec
from repro_torch.runtime.costmodel import StepTraffic
from repro_torch.runtime.objects import AccessTimeline, as_workload


def _pread(tl: AccessTimeline, s: int) -> float:
    """Shared-KV read-back bytes of the cache-aware prefill at step ``s``
    (StepTraffic.prefill_read); 0 for timelines without skip information."""
    return tl.prefill_read_bytes[s] if tl.prefill_read_bytes else 0.0

PAGE_BYTES = 2 << 20          # huge-page granularity for page-grain baselines


# ==================================================================== result ==

@dataclass
class PlacementResult:
    """One simulated run of a policy over a workload timeline.

    ``time`` is seconds for the whole timeline (one training step, or the
    full decode schedule); ``compute_time`` the all-fast lower bound;
    ``tokens`` the decode tokens produced (0 for training).  The legacy
    ``SimResult``/``ServeSimResult`` names alias this class.
    """
    policy: str
    time: float
    compute_time: float
    tokens: int = 0
    migrations: int = 0
    bytes_s2f: float = 0.0
    bytes_f2s: float = 0.0
    stall_time: float = 0.0
    slow_bytes_accessed: float = 0.0
    cases: Dict[int, int] = field(default_factory=lambda: {1: 0, 2: 0, 3: 0})
    mi: int = 0
    detail: dict = field(default_factory=dict)
    # multi-tenant accounting (empty on untenanted runs): peak fast bytes a
    # tenant's objects occupied, and quota-violation events per tenant (a
    # within-guarantee read served from slow memory while another tenant
    # squatted beyond its own share) — see docs/POLICIES.md#sentinel_slo
    tenant_fast_bytes: Dict[str, float] = field(default_factory=dict)
    tenant_violations: Dict[str, int] = field(default_factory=dict)

    @property
    def step_time(self) -> float:          # legacy training alias
        return self.time

    @step_time.setter
    def step_time(self, v: float) -> None:
        self.time = v

    @property
    def slowdown(self) -> float:
        return self.time / max(self.compute_time, 1e-30)

    @property
    def throughput(self) -> float:         # timelines / second (training)
        return 1.0 / max(self.time, 1e-30)

    @property
    def decode_throughput(self) -> float:  # tokens / second (serving)
        return self.tokens / max(self.time, 1e-30)


# ================================================================== registry ==

POLICIES: Dict[str, Type["PlacementPolicy"]] = {}


def register_policy(name: str):
    """Class decorator: add a PlacementPolicy subclass to the registry."""
    def deco(cls):
        cls.name = name
        POLICIES[name] = cls
        return cls
    return deco


def get_policy(name: str) -> Type["PlacementPolicy"]:
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown placement policy {name!r}; "
                       f"registered: {sorted(POLICIES)}") from None


def list_policies() -> List[str]:
    return sorted(POLICIES)


def simulate(workload, hw: HWSpec, fast_bytes: float,
             policy: str = "sentinel", *, tier_graph=None,
             **knobs) -> PlacementResult:
    """Replay ``workload`` under a registered policy — the one simulation
    entry point for training and serving alike.

    ``tier_graph`` runs the policy on an arbitrary memory topology
    (``runtime.tiergraph.TierGraph``): the graph folds to the duck-typed
    two-tier machine its compute node sees (``TierGraph.hw_view``), so
    every registered policy runs unchanged — on the canonical two-tier
    graph the fold reproduces ``hw`` exactly and the result is
    bit-identical to the legacy path."""
    if tier_graph is not None:
        hw = tier_graph.hw_view(hw)
    tl = as_workload(workload).timeline()
    return get_policy(policy).simulate(tl, hw, fast_bytes, **knobs)


# ======================================================= event-driven family ==

class PlacementPolicy:
    """Base: tracks placement (uid -> in fast?) and fast occupancy; charges
    migrations.  Subclasses override the hooks they care about.

    Hook order per timeline step t (driven by the shared event loop):
      on_free(t, objs)      objects at end of life disappear
      on_admit(t, objs)     pre-existing objects enter the timeline
                            (weights; prefill blocks of a refilled slot)
      on_birth(t, objs)     objects produced this step are born
      on_reads(t, objs)     -> (bytes_fast, bytes_slow) for this step's reads
      migrate(t, budget)    -> #migrations, off-critical-path volume capped
                               by budget (= step_time * mig_bw)
    """

    name = "base"
    granularity = "object"
    # Does the policy know the access schedule ahead of time?  Planned slow
    # reads stream behind compute (priced inside the pipe maximum); reactive
    # policies discover misses at touch time, so the cost model serializes
    # their slow reads (StepTraffic.demand_read).
    plans_ahead = False
    # Online re-planning (runtime/online.py): a policy supports incremental
    # ``PlacementPlan`` deltas when its entire decision state is re-derivable
    # from the plan's knobs — the replanner can then swap plans mid-stream
    # and the policy behaves as if it had been planned that way.  Reactive
    # policies (LRU paging, the caching daemons) and the MI-interval engine
    # carry history a delta cannot re-parameterize, so they opt out; the
    # online loop refuses them up front.  See docs/POLICIES.md.
    supports_replan = False

    @classmethod
    def replan_knobs(cls, plan) -> dict:
        """Simulation knobs that re-parameterize this policy from a plan —
        what the online replayer passes to ``simulate`` when pricing a
        traffic window under ``plan``.  Meaningful only when
        ``supports_replan`` is set."""
        return {}

    def __init__(self, timeline, hw, fast_bytes: float, **knobs):
        self.timeline = timeline
        # legacy attribute: policies written against the serve-only registry
        # stored the raw trace here
        self.trace = getattr(timeline, "source", timeline)
        self.hw, self.fast_bytes = hw, float(fast_bytes)
        self.knobs = knobs
        self.in_fast: Dict[int, bool] = {}
        self.live: Dict[int, object] = {}
        self.fast_used = 0.0
        self.peak_fast_used = 0.0
        self.migrations = 0
        self.bytes_s2f = 0.0
        self.bytes_f2s = 0.0
        self.slow_bytes_accessed = 0.0
        self.stall_time = 0.0
        # shared-object groups (equal non-None ``shared_key``): one physical
        # allocation, one tier, one capacity/migration charge for the group
        self._shared: Dict[tuple, dict] = {}
        # per-tenant accounting.  ``tenant_quotas`` (knob: tenant -> fraction
        # of the placement budget) turns on the violation metric for ANY
        # policy — quota-blind policies are measured against the same
        # guarantees the SLO-aware policy enforces.
        self.tenant_fast: Dict[str, float] = {}
        self.tenant_fast_peak: Dict[str, float] = {}
        self.tenant_violations: Dict[str, int] = {}
        q = knobs.get("tenant_quotas") or {}
        self.tenant_quotas: Dict[str, float] = \
            {str(k): float(v) * self.fast_bytes for k, v in q.items()}

    # ------------------------------------------------------------- helpers --
    @staticmethod
    def _group_key(o):
        return getattr(o, "shared_key", None)

    @staticmethod
    def _tenant_of(o) -> Optional[str]:
        tn = getattr(o, "tenant", None)
        return None if tn is None else str(tn)

    def _tenant_add(self, tn: Optional[str], b: float) -> None:
        if tn is None:
            return
        v = self.tenant_fast.get(tn, 0.0) + b
        self.tenant_fast[tn] = v
        if v > self.tenant_fast_peak.get(tn, 0.0):
            self.tenant_fast_peak[tn] = v

    def _group(self, o):
        """Live shared group of ``o``, or None (unshared / first member)."""
        k = self._group_key(o)
        if k is None:
            return None
        g = self._shared.get(k)
        return g if g and g["uids"] else None

    def _charge_bytes(self, o) -> float:
        """Capacity charge of placing ``o``: zero when its shared group is
        already resident (the physical pages exist exactly once)."""
        return 0.0 if self._group(o) is not None else o.bytes

    def _place(self, o, fast: bool):
        self.live[o.uid] = o
        k = self._group_key(o)
        if k is not None:
            g = self._group(o)
            if g is not None:              # adopt the group's placement, free
                g["uids"].add(o.uid)
                self.in_fast[o.uid] = g["fast"]
                return
            # the group's one capacity charge goes to the tenant that first
            # materialized the physical pages
            self._shared[k] = {"fast": fast, "uids": {o.uid},
                               "tn": self._tenant_of(o)}
        self.in_fast[o.uid] = fast
        if fast:
            self.fast_used += o.bytes
            self._tenant_add(self._tenant_of(o), o.bytes)

    def _demote(self, o):
        g = self._group(o)
        if g is not None:
            if g["fast"]:                  # whole group moves, bytes once
                g["fast"] = False
                for uid in g["uids"]:
                    self.in_fast[uid] = False
                self.fast_used -= o.bytes
                self._tenant_add(g.get("tn"), -o.bytes)
                self.migrations += 1
                self.bytes_f2s += o.bytes
            return
        if self.in_fast.get(o.uid):
            self.in_fast[o.uid] = False
            self.fast_used -= o.bytes
            self._tenant_add(self._tenant_of(o), -o.bytes)
            self.migrations += 1
            self.bytes_f2s += o.bytes

    def _promote(self, o):
        g = self._group(o)
        if g is not None:
            if not g["fast"]:
                g["fast"] = True
                for uid in g["uids"]:
                    self.in_fast[uid] = True
                self.fast_used += o.bytes
                self._tenant_add(g.get("tn"), o.bytes)
                self.migrations += 1
                self.bytes_s2f += o.bytes
            return
        if not self.in_fast.get(o.uid):
            self.in_fast[o.uid] = True
            self.fast_used += o.bytes
            self._tenant_add(self._tenant_of(o), o.bytes)
            self.migrations += 1
            self.bytes_s2f += o.bytes

    # --------------------------------------------------------------- hooks --
    def on_free(self, t: int, objs: Iterable) -> None:
        for o in objs:
            k = self._group_key(o)
            fast = self.in_fast.pop(o.uid, False)
            self.live.pop(o.uid, None)
            if k is not None:
                g = self._shared.get(k)
                if g is not None:
                    g["uids"].discard(o.uid)
                    if g["uids"]:
                        continue           # pages survive via other refs
                    self._shared.pop(k, None)
                    if g["fast"]:
                        self.fast_used -= o.bytes
                        self._tenant_add(g.get("tn"), -o.bytes)
                continue
            if fast:
                self.fast_used -= o.bytes
                self._tenant_add(self._tenant_of(o), -o.bytes)

    def on_admit(self, t: int, objs: Iterable) -> None:
        for o in objs:
            self._place(o, self.fast_used + self._charge_bytes(o)
                        <= self.fast_bytes)

    def on_birth(self, t: int, objs: Iterable) -> None:
        # objects just written by compute (fast-resident at production);
        # they stay fast if room remains, else they spill at birth
        self.on_admit(t, objs)

    def on_reads(self, t: int, objs: Iterable):
        bf = bs = 0.0
        for o in objs:
            if self.in_fast.get(o.uid, False):
                bf += o.bytes
            else:
                bs += o.bytes
                self._note_slow_read(o)
        self.slow_bytes_accessed += bs
        return bf, bs

    def _note_slow_read(self, o) -> None:
        """SLO accounting: a slow read is a quota *violation* when the
        reading tenant was still inside its guaranteed fast share (it was
        entitled to the capacity) while some other tenant occupied fast
        memory beyond its own share.  Quotas summing to <= 1 make the two
        conditions jointly imply a squatter denied the entitled tenant."""
        if not self.tenant_quotas:
            return
        tn = self._tenant_of(o)
        q = self.tenant_quotas.get(tn)
        if q is None or self.tenant_fast.get(tn, 0.0) + o.bytes > q:
            return                         # no guarantee, or demand beyond it
        if any(self.tenant_fast.get(j, 0.0) > qj + 1e-6
               for j, qj in self.tenant_quotas.items() if j != tn):
            self.tenant_violations[tn] = self.tenant_violations.get(tn, 0) + 1

    def migrate(self, t: int, budget_bytes: float) -> int:
        return 0

    # ------------------------------------------------------------ simulate --
    @classmethod
    def simulate(cls, workload, hw: HWSpec, fast_bytes: float,
                 **knobs) -> PlacementResult:
        """Replay the timeline through this policy's hooks (the shared
        event loop; interval/static policies override this instead)."""
        tl = as_workload(workload).timeline()
        # fast memory pre-committed to the reserve pool (training short-lived
        # objects) is off-limits to the policy; its traffic is in fixed_fast
        pol = cls(tl, hw, max(0.0, fast_bytes - tl.reserved_bytes), **knobs)
        total = compute_lb = 0.0
        tokens = 0
        traffic: List[StepTraffic] = []
        for t in range(tl.num_steps):
            s2f0, f2s0 = pol.bytes_s2f, pol.bytes_f2s
            stall0 = pol.stall_time
            pol.on_free(t, tl.frees.get(t, ()))
            pol.on_admit(t, tl.admits.get(t, ()))
            pol.on_birth(t, tl.births.get(t, ()))
            pol.peak_fast_used = max(pol.peak_fast_used, pol.fast_used)
            bf, bs = pol.on_reads(t, tl.reads.get(t, ()))
            fixed = tl.fixed_fast_bytes[t]
            t_step = max(tl.flops[t] / hw.peak_flops,
                         (bf + fixed) / hw.fast_bw + bs / hw.slow_bw)
            t_step += tl.extra_time(t, hw)
            migs = pol.migrate(t, t_step * hw.mig_bw)
            pol.peak_fast_used = max(pol.peak_fast_used, pol.fast_used)
            total += t_step + migs * hw.mig_overhead
            compute_lb += max(tl.flops[t] / hw.peak_flops,
                              (bf + bs + fixed) / hw.fast_bw)
            compute_lb += tl.extra_time(t, hw)
            tokens += tl.tokens[t]
            traffic.append(StepTraffic(
                flops=tl.flops[t], fast_read=bf + fixed, slow_read=bs,
                demand_read=0.0 if cls.plans_ahead else bs,
                mig_in=pol.bytes_s2f - s2f0, mig_out=pol.bytes_f2s - f2s0,
                tokens=tl.tokens[t], migs=migs,
                extra_flops=tl.extra_flops[t],
                extra_fast=tl.extra_fast_bytes[t],
                stall=pol.stall_time - stall0,
                prefill_flops=tl.extra_flops[t],
                prefill_read=_pread(tl, t)))
        total += pol.stall_time          # SLO repairs stall the decode stream
        res = PlacementResult(
            policy=cls.name, time=total, compute_time=compute_lb,
            tokens=tokens, migrations=pol.migrations, bytes_s2f=pol.bytes_s2f,
            bytes_f2s=pol.bytes_f2s, stall_time=pol.stall_time,
            slow_bytes_accessed=pol.slow_bytes_accessed,
            tenant_fast_bytes=dict(sorted(pol.tenant_fast_peak.items())),
            tenant_violations=dict(sorted(pol.tenant_violations.items())),
            detail={"fast_bytes": fast_bytes, "peak_kv": tl.peak_bytes(),
                    "peak_fast_used": pol.peak_fast_used, **knobs})
        # dynamic attribute (not a dataclass field): the per-step traffic a
        # CostModel prices; kept off asdict() so plan JSON stays byte-stable
        res.step_traffic = traffic
        return res


@register_policy("prefer_fast")
class PreferFast(PlacementPolicy):
    """Static PreferHBM: fast while room remains, no migration ever."""
    plans_ahead = True       # placement is fixed -> slow reads are streamable
    supports_replan = True   # stateless: any plan re-parameterizes it


@register_policy("lru_page")
class LRUPage(PlacementPolicy):
    """Page-grain reactive LRU with bump allocation (false sharing).

    Objects are packed into ``page_bytes`` pages in birth order, interleaving
    producers exactly like a bump allocator does.  Placement and migration
    are per *page*: a promoted page carries every byte it packs, dead or
    alive; a page's fast space is only reclaimed when all members died or
    when the page is demoted.  Promotion is reactive: a slow page touched
    since the last step becomes a candidate; the least-recently-touched fast
    pages are demoted to make room.
    """

    granularity = "page"

    class _Page:
        __slots__ = ("pid", "members", "live_bytes", "in_fast", "last_touch")

        def __init__(self, pid):
            self.pid = pid
            self.members: list = []
            self.live_bytes = 0.0
            self.in_fast = False
            self.last_touch = -1

    def __init__(self, timeline, hw, fast_bytes, *,
                 page_bytes: int = PAGE_BYTES, **knobs):
        super().__init__(timeline, hw, fast_bytes, **knobs)
        self.page_bytes = float(page_bytes)
        self.pages: List[LRUPage._Page] = []
        self.page_of: Dict[int, LRUPage._Page] = {}
        self._open: Optional[LRUPage._Page] = None
        self._open_fill = 0.0
        self._touched_slow: "collections.OrderedDict" = collections.OrderedDict()

    def _alloc(self, o):
        if self._open is None or self._open_fill + o.bytes > self.page_bytes:
            pg = LRUPage._Page(len(self.pages))
            pg.in_fast = self.fast_used + self.page_bytes <= self.fast_bytes
            if pg.in_fast:
                self.fast_used += self.page_bytes
            self.pages.append(pg)
            self._open, self._open_fill = pg, 0.0
        pg = self._open
        pg.members.append(o)
        pg.live_bytes += o.bytes
        self._open_fill += o.bytes
        self.page_of[o.uid] = pg
        self.live[o.uid] = o
        self.in_fast[o.uid] = pg.in_fast

    def on_admit(self, t, objs):
        for o in objs:
            self._alloc(o)

    on_birth = on_admit

    def on_free(self, t, objs):
        for o in objs:
            pg = self.page_of.pop(o.uid, None)
            self.live.pop(o.uid, None)
            self.in_fast.pop(o.uid, None)
            if pg is None:
                continue
            pg.live_bytes -= o.bytes
            if pg.live_bytes <= 0 and pg is not self._open:
                # fully dead page: space reclaimed (only now — false sharing
                # kept the dead bytes resident until the last member died)
                if pg.in_fast:
                    self.fast_used -= self.page_bytes
                pg.in_fast = False

    def on_reads(self, t, objs):
        bf = bs = 0.0
        for o in objs:
            pg = self.page_of[o.uid]
            pg.last_touch = t
            if pg.in_fast:
                bf += o.bytes
            else:
                bs += o.bytes
                self._touched_slow[pg.pid] = pg
        self.slow_bytes_accessed += bs
        return bf, bs

    def migrate(self, t, budget_bytes):
        moved = 0
        # most recently touched slow pages first (reactive promotion)
        for pid in reversed(list(self._touched_slow)):
            pg = self._touched_slow.pop(pid)
            if pg.live_bytes <= 0 or budget_bytes < self.page_bytes:
                continue
            # demote LRU fast pages until the candidate fits
            while self.fast_used + self.page_bytes > self.fast_bytes and \
                    budget_bytes >= self.page_bytes:
                victims = [p for p in self.pages
                           if p.in_fast and p.live_bytes > 0]
                if not victims:
                    break
                v = min(victims, key=lambda p: p.last_touch)
                if v.last_touch >= pg.last_touch:
                    break                      # nothing colder than candidate
                v.in_fast = False
                self.fast_used -= self.page_bytes
                for m in v.members:
                    if m.uid in self.in_fast:
                        self.in_fast[m.uid] = False
                budget_bytes -= self.page_bytes
                self.migrations += 1
                self.bytes_f2s += self.page_bytes
                moved += 1
            if self.fast_used + self.page_bytes <= self.fast_bytes and \
                    budget_bytes >= self.page_bytes:
                pg.in_fast = True
                self.fast_used += self.page_bytes
                for m in pg.members:
                    if m.uid in self.in_fast:
                        self.in_fast[m.uid] = True
                budget_bytes -= self.page_bytes
                self.migrations += 1
                self.bytes_s2f += self.page_bytes
                moved += 1
        self._touched_slow.clear()
        return moved


@register_policy("sentinel")
class SentinelLifetime(PlacementPolicy):
    """Lifetime-aware object policy with look-ahead prefetch.

    The access schedule is known (decode repeats per token, training repeats
    per step — the paper's repeatability), so each object's exact next access
    is available.  Every step the policy (a) prefetches objects whose next
    access falls within ``lookahead`` steps, (b) evicts the objects whose
    next access is farthest away (or never) to make room — Belady at object
    granularity, bandwidth-capped like the paper's migration threads.
    """

    plans_ahead = True
    # the whole decision state is (lookahead, windows) — all plan knobs, so
    # an online delta fully re-parameterizes the policy mid-stream
    supports_replan = True

    def __init__(self, timeline, hw, fast_bytes, *, lookahead: int = 8,
                 **knobs):
        super().__init__(timeline, hw, fast_bytes, **knobs)
        self.lookahead = max(1, int(lookahead))

    @classmethod
    def replan_knobs(cls, plan) -> dict:
        return {"lookahead": int(plan.lookahead)} if plan.lookahead else {}

    @staticmethod
    def _next_access(o, t: int) -> Optional[int]:
        i = bisect.bisect_right(o.accesses, t)
        return o.accesses[i] if i < len(o.accesses) else None

    def _score(self, o, t: int) -> int:
        """Known accesses within the look-ahead horizon (per-token Eq. 2:
        this is the reuse the migration bandwidth can still buy back)."""
        lo = bisect.bisect_right(o.accesses, t)
        hi = bisect.bisect_right(o.accesses, t + self.lookahead)
        return hi - lo

    def _group_members(self, o):
        """Live members of ``o``'s shared group (just ``o`` when unshared) —
        a shared page's placement serves every sharer, so eviction decisions
        must consider the whole group."""
        g = self._group(o)
        if g is None:
            return [o]
        return [self.live[uid] for uid in g["uids"] if uid in self.live]

    def _group_next_access(self, o, t: int) -> Optional[int]:
        """Soonest next access across the group (Belady on shared pages)."""
        nas = [self._next_access(m, t) for m in self._group_members(o)]
        nas = [x for x in nas if x is not None]
        return min(nas) if nas else None

    def _evict_for(self, need: float, t: int) -> None:
        """Make room by evicting farthest-next-access fast objects (Belady
        on the known schedule; shared groups judged by their most-urgent
        member, since demoting one member moves the whole group)."""
        if self.fast_used + need <= self.fast_bytes:
            return
        victims = [o for o in self.live.values() if self.in_fast.get(o.uid)]
        victims.sort(key=lambda o: -(self._group_next_access(o, t) or 10 ** 12))
        for v in victims:
            if self.fast_used + need <= self.fast_bytes:
                break
            self._demote(v)

    def on_admit(self, t, objs):
        # placement at birth is free (data is written to its tier directly):
        # hot-window objects displace colder incumbents, cold history is born
        # slow — the serving analogue of "born in fast" vs residual offload
        for o in objs:
            if self._group(o) is not None:
                self._place(o, True)        # pages already resident: free ride
                continue
            if self._score(o, t - 1) == 0:
                self._place(o, False)
                continue
            self._evict_for(o.bytes, t)
            self._place(o, self.fast_used + o.bytes <= self.fast_bytes)

    on_birth = on_admit

    def _desired_fast_set(self, t, scored) -> set:
        """Greedy-by-score fast set (Belady with known schedules); shared
        groups charge capacity once.  ``sentinel_slo`` overrides this with a
        quota-partitioned construction — the promote/demote machinery in
        ``migrate`` is shared."""
        target = set()
        used = 0.0
        seen_groups = set()
        for sc, o in scored:
            if sc <= 0:
                break
            k = self._group_key(o)
            eff = o.bytes if k is None or k not in seen_groups else 0.0
            if used + eff <= self.fast_bytes:
                target.add(o.uid)
                used += eff
                if k is not None:
                    seen_groups.add(k)
        return target

    def migrate(self, t, budget_bytes):
        migs0 = self.migrations
        live = list(self.live.values())
        scored = [(self._score(o, t), o) for o in live]
        # desired fast set: greedy by score; incumbents win ties so
        # equal-rate history objects never ping-pong between tiers
        scored.sort(key=lambda p: (-p[0], not self.in_fast.get(p[1].uid),
                                   p[1].uid))
        target = self._desired_fast_set(t, scored)
        promotes = [o for sc, o in scored
                    if o.uid in target and not self.in_fast.get(o.uid)]
        promotes.sort(key=lambda o: self._next_access(o, t) or 10 ** 12)
        for o in promotes:
            if self.in_fast.get(o.uid):
                continue                    # shared group already moved
            if o.bytes > budget_bytes:
                break
            while self.fast_used + o.bytes > self.fast_bytes:
                # demoting any member moves its whole shared group, so a
                # group with a member in the target set is never a victim
                # (else demote/promote would ping-pong the group's bytes)
                victims = [v for v in live if self.in_fast.get(v.uid)
                           and not any(m.uid in target
                                       for m in self._group_members(v))]
                if not victims:
                    break
                v = min(victims, key=lambda v: max(
                    self._score(m, t) for m in self._group_members(v)))
                if v.bytes > budget_bytes:
                    budget_bytes = -1.0
                    break
                self._demote(v)
                budget_bytes -= v.bytes
            if budget_bytes < 0 or self.fast_used + o.bytes > self.fast_bytes:
                break
            self._promote(o)
            budget_bytes -= o.bytes
        return self.migrations - migs0


@register_policy("sentinel_slo")
class SentinelSLO(SentinelLifetime):
    """SLO-aware multi-tenant variant of ``sentinel``.

    Same lifetime knowledge (Belady on the known access schedule), but the
    fast tier is partitioned by per-tenant *guarantees*:

      quotas         ``tenant_quotas`` (tenant -> fraction of the placement
                     budget, summing to <= 1) are each tenant's guaranteed
                     share.  Default: equal shares over the tenants tagged in
                     the timeline.
      work-conserving borrowing
                     capacity a tenant leaves idle is lent out — the desired
                     fast set is built in two passes, first each tenant's
                     best objects within its own quota, then global Belady
                     over whatever room remains.
      graceful degradation
                     borrowed capacity is revocable: when a within-guarantee
                     placement needs room, borrowers are demoted first,
                     ordered by SLO slack (``tenant_slack``; loosest SLO
                     degrades first), never a tenant inside its own share.
      repair-on-read as a backstop, an entitled read about to hit slow
                     memory is promoted first (the migration stalls the
                     stream — charged to ``stall_time``), so a tenant inside
                     its guarantee never reads from slow memory while a
                     squatter holds its share: ``tenant_violations`` is zero
                     by construction whenever the quotas sum to <= 1.
    """

    def __init__(self, timeline, hw, fast_bytes, *, tenant_quotas=None,
                 tenant_slack=None, lookahead: int = 8, **knobs):
        if tenant_quotas is None:
            tenants = sorted({str(o.tenant) for o in timeline.objects
                              if getattr(o, "tenant", None) is not None})
            tenant_quotas = {tn: 1.0 / len(tenants) for tn in tenants} \
                if tenants else {}
        super().__init__(timeline, hw, fast_bytes, lookahead=lookahead,
                         tenant_quotas=tenant_quotas, **knobs)
        self.tenant_slack: Dict[str, float] = \
            {str(k): float(v) for k, v in (tenant_slack or {}).items()}

    # --------------------------------------------------------- quota state --
    def _quota_of(self, tn: Optional[str]) -> Optional[float]:
        return None if tn is None else self.tenant_quotas.get(tn)

    def _within_quota(self, o) -> bool:
        """Would placing ``o`` fast keep its tenant inside its guarantee?"""
        tn = self._tenant_of(o)
        q = self._quota_of(tn)
        return q is not None and \
            self.tenant_fast.get(tn, 0.0) + self._charge_bytes(o) <= q

    def _is_borrower(self, o) -> bool:
        """Fast-resident beyond (or outside) any guarantee: revocable."""
        g = self._group(o)
        tn = g.get("tn") if g is not None else self._tenant_of(o)
        q = self._quota_of(tn)
        return q is None or self.tenant_fast.get(tn, 0.0) > q + 1e-6

    def _slack_of(self, o) -> float:
        g = self._group(o)
        tn = g.get("tn") if g is not None else self._tenant_of(o)
        if tn is None:
            return float("inf")            # untenanted: degrades first
        return self.tenant_slack.get(tn, 1.0)

    def _reclaim_for(self, need: float, t: int, protect: Optional[str]):
        """Make room for a within-guarantee placement: demote borrowers
        first (loosest SLO first, then farthest next access), falling back
        to plain Belady only if no borrower remains.  When every tenant is
        inside its quota and the quotas sum to <= 1, the borrower pass alone
        always finds the room."""
        if self.fast_used + need <= self.fast_bytes:
            return
        victims = [o for o in self.live.values() if self.in_fast.get(o.uid)
                   and self._tenant_of(o) != protect]
        victims.sort(key=lambda o: (
            -self._slack_of(o),
            -(self._group_next_access(o, t) or 10 ** 12), o.uid))
        for v in victims:
            if self.fast_used + need <= self.fast_bytes:
                return
            if self._is_borrower(v):
                self._demote(v)
        self._evict_for(need, t)

    # ----------------------------------------------------------- placement --
    def on_admit(self, t, objs):
        for o in objs:
            if self._group(o) is not None:
                self._place(o, True)       # pages already resident: free ride
                continue
            within = self._within_quota(o)
            if not within and self._score(o, t - 1) == 0:
                self._place(o, False)      # cold and beyond guarantee
                continue
            if within:
                self._reclaim_for(o.bytes, t, self._tenant_of(o))
            else:
                self._evict_for(o.bytes, t)
            self._place(o, self.fast_used + o.bytes <= self.fast_bytes)

    on_birth = on_admit

    def on_reads(self, t, objs):
        # repair-on-read: an entitled access about to hit slow memory pulls
        # the object in first, reclaiming lent capacity; the copy is on the
        # critical path (the paper's Case-3 stall, per object)
        for o in objs:
            if self.in_fast.get(o.uid, False) or not self._within_quota(o):
                continue
            self._reclaim_for(o.bytes, t, self._tenant_of(o))
            if self.fast_used + self._charge_bytes(o) <= self.fast_bytes:
                self._promote(o)
                self.stall_time += o.bytes / self.hw.mig_bw
        return super().on_reads(t, objs)

    # ----------------------------------------------------------- migration --
    def _desired_fast_set(self, t, scored) -> set:
        """Two-pass target: guaranteed shares first (each tenant's best
        objects within its own quota), then work-conserving borrowing of
        whatever capacity is left, by global score order."""
        target = set()
        used = 0.0
        tenant_used: Dict[str, float] = {}
        seen_groups = set()
        for sc, o in scored:               # pass 1: inside the guarantees
            if sc <= 0:
                break
            tn = self._tenant_of(o)
            q = self._quota_of(tn)
            if q is None:
                continue
            k = self._group_key(o)
            eff = o.bytes if k is None or k not in seen_groups else 0.0
            if tenant_used.get(tn, 0.0) + eff <= q and \
                    used + eff <= self.fast_bytes:
                target.add(o.uid)
                used += eff
                tenant_used[tn] = tenant_used.get(tn, 0.0) + eff
                if k is not None:
                    seen_groups.add(k)
        for sc, o in scored:               # pass 2: borrow the idle rest
            if sc <= 0:
                break
            if o.uid in target:
                continue
            k = self._group_key(o)
            eff = o.bytes if k is None or k not in seen_groups else 0.0
            if used + eff <= self.fast_bytes:
                target.add(o.uid)
                used += eff
                if k is not None:
                    seen_groups.add(k)
        return target


# ===================================================== interval/static units ==

@dataclass
class Unit:
    """The migration unit of the interval/page simulators: one object, or one
    page packing many objects."""
    uid: int
    bytes: int
    accesses: Sequence[int]     # sorted step indices
    long_lived: bool
    short_lived_resident: bool  # lives in the reserved pool (Sentinel)


def build_units(profile, granularity: str = "object",
                page_mode: str = "sentinel") -> List[Unit]:
    """Units from a training TraceProfile.  granularity 'object': Sentinel's
    view.  'page': pack objects into pages (page_mode 'original' reproduces
    false sharing)."""
    from repro_torch.core.allocator import pack_pages
    acts = [o for o in profile.objects
            if o.kind == "activation" and o.accesses and not o.fused]
    weights = [o for o in profile.objects if o.kind == "weight" and o.accesses]
    units: List[Unit] = []
    if granularity == "object":
        for o in acts:
            units.append(Unit(o.uid, o.size, sorted(set(o.accesses)),
                              o.lifetime >= 2, o.lifetime <= 1))
        for o in weights:
            units.append(Unit(o.uid, o.size, sorted(set(o.accesses)), True, False))
    else:
        pages, _ = pack_pages(acts + weights, page_mode)
        for p in pages:
            accesses = p.accesses
            if not accesses:
                continue
            long_lived = p.death - p.birth >= 2 or \
                any(o.kind == "weight" for o in p.objects)
            units.append(Unit(100_000_000 + p.pid, p.bytes, accesses,
                              long_lived, not long_lived))
    return units


def _timeline_units(tl: AccessTimeline, granularity: str,
                    page_mode: str) -> List[Unit]:
    """Units for the interval/page simulators on any workload timeline."""
    if tl.kind == "training" and tl.source is not None:
        return build_units(tl.source, granularity, page_mode)
    objs = [o for o in tl.objects if o.accesses]
    if granularity == "object":
        return [Unit(o.uid, o.bytes, sorted(set(o.accesses)),
                     o.death - o.birth >= 2, o.death - o.birth < 2)
                for o in objs]
    # page granularity on a non-training workload: generic bump packing in
    # birth order (the same false-sharing regime as allocator 'original')
    units: List[Unit] = []
    cur_access: set = set()
    cur_fill = 0.0
    cur_long = False
    pid = 0

    def flush():
        nonlocal pid, cur_access, cur_fill, cur_long
        if cur_access:
            units.append(Unit(100_000_000 + pid, int(PAGE_BYTES),
                              sorted(cur_access), cur_long, not cur_long))
            pid += 1
        cur_access, cur_fill, cur_long = set(), 0.0, False

    for o in sorted(objs, key=lambda o: (o.birth, o.uid)):
        if cur_fill + o.bytes > PAGE_BYTES and cur_fill > 0:
            flush()
        cur_access.update(o.accesses)
        cur_fill += o.bytes
        cur_long = cur_long or (o.death - o.birth >= 2)
    flush()
    return units


def _all_fast_times(tl: AccessTimeline, hw: HWSpec) -> List[float]:
    """All-fast compute time per timeline step (roofline max of the two)."""
    return [tl.step_time_all_fast(s, hw) for s in range(tl.num_steps)]


@register_policy("alpha_migration")
class AlphaMigration(SentinelLifetime):
    """Sentinel with a bandwidth-optimal stopping rule for promotion.

    Splitting a read stream alpha fast / (1-alpha) slow equalizes the two
    memory pipes' service times at ``alpha* = B_fast / (B_fast + B_ext)``
    (fangyunh's AlphaMigration; derivation in docs/POLICIES.md): reads
    promoted beyond that split cannot shorten the step — the fast pipe is
    already the slower of the two — they only add migration traffic.  So
    this policy builds the same greedy-by-score fast set as ``sentinel`` but
    stops admitting objects once the covered look-ahead read bytes reach
    alpha* of the horizon's total, deliberately leaving the cold tail slow.

    Under the byte-domain clock it can only tie or lose to ``sentinel``
    (slow reads always cost there); under a ``CostModel`` with a real host
    tier the saved migration traffic wins — which is exactly the
    ``objective="latency"`` planner's reason to consider it.

    Knobs: ``lookahead`` (inherited), ``alpha`` (override the derived
    split; default ``B_fast / (B_fast + min(slow_read_bw, host_internal))``
    from the hw/CostModel it runs on).
    """

    def __init__(self, timeline, hw, fast_bytes, *,
                 alpha: Optional[float] = None, **knobs):
        super().__init__(timeline, hw, fast_bytes, **knobs)
        if alpha is None:
            ext = min(getattr(hw, "slow_read_bw", hw.slow_bw),
                      getattr(hw, "host_internal_bw", float("inf")))
            alpha = hw.fast_bw / (hw.fast_bw + ext)
        self.alpha = min(1.0, max(0.0, float(alpha)))

    def _desired_fast_set(self, t, scored) -> set:
        # goal: cover alpha* of the horizon's placeable read bytes
        # (score * bytes = known reads of the object within the look-ahead)
        goal = self.alpha * sum(sc * o.bytes for sc, o in scored if sc > 0)
        target = set()
        used = covered = 0.0
        seen_groups = set()
        for sc, o in scored:
            if sc <= 0 or covered >= goal:
                break
            k = self._group_key(o)
            eff = o.bytes if k is None or k not in seen_groups else 0.0
            if used + eff <= self.fast_bytes:
                target.add(o.uid)
                used += eff
                covered += sc * o.bytes
                if k is not None:
                    seen_groups.add(k)
        return target


# ====================================================== interval (sentinel) ==

@register_policy("sentinel_mi")
class SentinelMI(PlacementPolicy):
    """The paper's training runtime (§4.4) as a registered policy:
    MI-interval prefetch slow->fast overlapped with compute, mid-interval
    eviction of units not needed soon, Case 1/2/3 accounting, and optional
    test-and-trial over the Case-3 resolution.

    Knobs: ``mi`` (migration interval in timeline steps; default num_steps/8),
    ``test_and_trial``, ``stall_on_case3``, ``reserve_pool``,
    ``granularity``/``page_mode`` (object vs page units).
    """

    plans_ahead = True

    @classmethod
    def simulate(cls, workload, hw: HWSpec, fast_bytes: float, *,
                 mi: Optional[int] = None, test_and_trial: bool = True,
                 stall_on_case3: bool = True, reserve_pool: bool = True,
                 granularity: str = "object",
                 page_mode: str = "sentinel") -> PlacementResult:
        tl = as_workload(workload).timeline()
        if mi is None:
            mi = max(1, tl.num_steps // 8)
        kw = dict(reserve_pool=reserve_pool, granularity=granularity,
                  page_mode=page_mode)
        if not test_and_trial:
            return cls._run(tl, hw, fast_bytes, mi,
                            stall_on_case3=stall_on_case3, **kw)
        # test-and-trial (§4.4): try both Case-3 resolutions, keep the winner
        a = cls._run(tl, hw, fast_bytes, mi, stall_on_case3=True, **kw)
        if a.cases[3] == 0:
            a.detail["tt_choice"] = "n/a"
            return a
        b = cls._run(tl, hw, fast_bytes, mi, stall_on_case3=False, **kw)
        best = a if a.time <= b.time else b
        best.detail["tt_choice"] = "stall" if best is a else "slow-access"
        best.detail["tt_steps_used"] = 2
        return best

    @classmethod
    def _run(cls, tl: AccessTimeline, hw: HWSpec, fast_bytes: float, mi: int,
             *, stall_on_case3: bool, reserve_pool: bool, granularity: str,
             page_mode: str) -> PlacementResult:
        """One MI run: at the start of interval A the data needed by interval
        B is prefetched slow->fast overlapped with A's compute; long-lived
        units not needed soon are evicted fast->slow mid-interval (this is
        what frees space for the residual-offload pattern).  Newly produced
        long-lived units are always born in fast."""
        units = _timeline_units(tl, granularity, page_mode)
        steps = tl.num_steps
        t_step = _all_fast_times(tl, hw)
        res = PlacementResult(cls.name, 0.0, sum(t_step),
                              tokens=sum(tl.tokens), mi=mi)
        # per-step traffic for CostModel pricing: demand reads are exact;
        # interval-level migration/stall is spread evenly over the
        # interval's steps (the DMA runs concurrently with all of them)
        records: List[StepTraffic] = []
        snap = [0.0, 0.0, 0, 0.0]      # bytes_s2f, bytes_f2s, migs, stall

        access_map: Dict[int, List[Unit]] = collections.defaultdict(list)
        for u in units:
            for s in u.accesses:
                access_map[s].append(u)

        rs = tl.reserve_bytes(mi) if reserve_pool else 0.0
        budget = max(0.0, fast_bytes - rs)

        movable = [u for u in units if u.long_lived]
        in_fast: Dict[int, bool] = {u.uid: False for u in movable}
        fast_used = 0.0

        def next_access_after(u: Unit, s: int) -> Optional[int]:
            for a in u.accesses:
                if a > s:
                    return a
            return None

        slow_resident = {u.uid for u in movable if u.bytes > budget}
        # (paper §4.5: fast memory must at least fit RS + the largest
        # long-lived object; units violating that are pinned slow)

        def force_evict(need: float, now: int, horizon: int) -> float:
            """Make room for `need` bytes by evicting farthest-next-access
            units.  Returns bytes evicted (charged to the eviction channel)."""
            nonlocal fast_used
            victims = [u for u in movable if in_fast.get(u.uid, False)]
            victims.sort(key=lambda u: -(next_access_after(u, now) or 10 ** 9))
            freed = 0.0
            for u in victims:
                if fast_used + need <= budget:
                    break
                in_fast[u.uid] = False
                fast_used -= u.bytes
                freed += u.bytes
                res.migrations += 1
                res.bytes_f2s += u.bytes
            return freed

        # initial prefetch: units needed by interval 0, by first-use order
        first = [u for u in movable if any(a < mi for a in u.accesses)
                 and u.uid not in slow_resident]
        peak_fast = 0.0

        def bump(b: float) -> None:
            nonlocal fast_used, peak_fast
            fast_used += b
            peak_fast = max(peak_fast, fast_used)

        first.sort(key=lambda u: u.accesses[0])
        for u in first:
            if fast_used + u.bytes <= budget:
                in_fast[u.uid] = True
                bump(u.bytes)
                res.migrations += 1
                res.bytes_s2f += u.bytes

        intervals = [(i, min(i + mi, steps)) for i in range(0, steps, mi)]
        total = 0.0

        for (lo, hi) in intervals:
            nxt_lo, nxt_hi = hi, min(hi + mi, steps)
            migs_before = res.migrations

            # -- execute interval: compute + penalties + births + evictions --
            interval_compute = 0.0
            forced_evict_bytes = 0.0
            for s in range(lo, hi):
                bytes_slow = 0.0
                for u in access_map.get(s, ()):
                    if not u.long_lived:
                        continue
                    if u.uid in slow_resident:
                        bytes_slow += u.bytes
                        res.slow_bytes_accessed += u.bytes
                        continue
                    if u.accesses[0] == s and not in_fast.get(u.uid, False):
                        # birth: produced into fast, forcing eviction if full
                        if fast_used + u.bytes > budget:
                            forced_evict_bytes += force_evict(u.bytes, s,
                                                              nxt_hi)
                        if fast_used + u.bytes <= budget:
                            in_fast[u.uid] = True
                            bump(u.bytes)
                        else:                    # truly no room: spills slow
                            slow_resident.add(u.uid)
                            bytes_slow += u.bytes
                            res.slow_bytes_accessed += u.bytes
                    elif not in_fast.get(u.uid, False):
                        bytes_slow += u.bytes    # read from slow
                        res.slow_bytes_accessed += u.bytes
                if not reserve_pool:
                    # "no space reservation" ablation: short-lived units
                    # demand fast space; the shortfall is slow-accessed
                    short_here = sum(u.bytes for u in access_map.get(s, ())
                                     if u.short_lived_resident)
                    free = fast_bytes - fast_used
                    overflow = max(0.0, short_here - max(0.0, free))
                    bytes_slow += overflow
                    res.slow_bytes_accessed += overflow
                t_fast = max(0.0, tl.total_bytes[s] - bytes_slow)
                t = max(tl.flops[s] / hw.peak_flops,
                        t_fast / hw.fast_bw + bytes_slow / hw.slow_bw)
                t += tl.extra_time(s, hw)
                interval_compute += t
                records.append(StepTraffic(
                    flops=tl.flops[s], fast_read=t_fast,
                    slow_read=bytes_slow, tokens=tl.tokens[s],
                    extra_flops=tl.extra_flops[s],
                    extra_fast=tl.extra_fast_bytes[s],
                    prefill_flops=tl.extra_flops[s],
                    prefill_read=_pread(tl, s)))

            # -- eviction channel accounting (fast->slow, full duplex) --
            evict_capacity = interval_compute * hw.mig_bw - forced_evict_bytes
            if evict_capacity < 0:                # write-back pressure stalls
                stall = -evict_capacity / hw.mig_bw
                res.stall_time += stall
                total += stall
                evict_capacity = 0.0
            # scheduled mid-interval eviction: units not needed before nxt_hi
            candidates = [u for u in movable if in_fast.get(u.uid, False)]
            candidates.sort(
                key=lambda u: -(next_access_after(u, hi - 1) or 10 ** 9))
            for u in candidates:
                na = next_access_after(u, hi - 1)
                if na is not None and na < nxt_hi:
                    continue                      # needed soon: keep
                if u.bytes > evict_capacity:
                    break
                evict_capacity -= u.bytes
                in_fast[u.uid] = False
                fast_used -= u.bytes
                res.migrations += 1
                res.bytes_f2s += u.bytes

            # -- prefetch for the next interval (slow->fast channel) --
            pending = [u for u in movable
                       if not in_fast[u.uid] and u.uid not in slow_resident
                       and any(nxt_lo <= a < nxt_hi for a in u.accesses)]
            pending.sort(
                key=lambda u: next_access_after(u, nxt_lo - 1) or nxt_lo)
            capacity = interval_compute * hw.mig_bw
            space_blocked = False
            while pending:
                u = pending[0]
                if fast_used + u.bytes > budget:
                    space_blocked = True
                    break
                if u.bytes > capacity:
                    break
                capacity -= u.bytes
                bump(u.bytes)
                in_fast[u.uid] = True
                res.migrations += 1
                res.bytes_s2f += u.bytes
                pending.pop(0)

            # per-migration fixed overhead (move_pages/TLB shootdown on CPU
            # HM, copy dispatch on an accelerator) — exposed on the
            # critical path
            interval_migs = res.migrations - migs_before
            total += interval_migs * hw.mig_overhead

            total += interval_compute
            if nxt_lo >= steps:
                pass                              # no next interval: no case
            elif not pending:
                res.cases[1] += 1
            elif space_blocked:
                res.cases[2] += 1                 # leave in slow
            else:
                res.cases[3] += 1
                if stall_on_case3:
                    stall = 0.0
                    for u in list(pending):
                        if fast_used + u.bytes <= budget:
                            stall += u.bytes / hw.mig_bw
                            bump(u.bytes)
                            in_fast[u.uid] = True
                            res.migrations += 1
                            res.bytes_s2f += u.bytes
                            pending.remove(u)
                    res.stall_time += stall
                    total += stall
                # else: leave in slow, pay access penalty next interval

            n = hi - lo
            for r in records[-n:]:
                r.mig_in += (res.bytes_s2f - snap[0]) / n
                r.mig_out += (res.bytes_f2s - snap[1]) / n
                r.migs += (res.migrations - snap[2]) / n
                r.stall += (res.stall_time - snap[3]) / n
            snap = [res.bytes_s2f, res.bytes_f2s,
                    res.migrations, res.stall_time]

        res.time = total
        res.detail = {"fast_budget": budget, "rs": rs,
                      "peak_fast_used": peak_fast}
        res.step_traffic = records
        return res


# ================================================= page-grain reactive (HM) ==

class _CachingDaemon(PlacementPolicy):
    """Page-grain reactive baselines (IAL from Yan et al. ASPLOS'19, LRU).

    Two FIFO lists (active/inactive).  Pages are *not* demand-migrated — a
    periodic optimization pass (the every-5-seconds daemon; here
    ``opts_per_step`` passes per timeline replay) promotes recently
    re-accessed slow pages into fast memory and demotes inactive-list pages
    when fast memory is full.  Between passes, slow pages are accessed in
    slow memory — the detection *lag* is exactly the paper's criticism, and
    page-grain false sharing (page_mode='original') makes the promoted bytes
    partly useless.

    The timeline repeats identically (training steps; decode schedules), so
    we replay ``repeats`` times and report the last (steady state: recurring
    pages have been classified).
    """

    granularity = "page"
    recency = False               # IAL: FIFO; LRU subclass: recency ordering

    @classmethod
    def simulate(cls, workload, hw: HWSpec, fast_bytes: float, *,
                 page_mode: str = "original", repeats: int = 3,
                 opts_per_step: int = 4) -> PlacementResult:
        tl = as_workload(workload).timeline()
        units = _timeline_units(tl, "page", page_mode)
        steps = tl.num_steps
        res = PlacementResult(cls.name, 0.0, sum(_all_fast_times(tl, hw)),
                              tokens=sum(tl.tokens))

        access_map: Dict[int, List[Unit]] = collections.defaultdict(list)
        for u in units:
            for s in u.accesses:
                access_map[s].append(u)

        in_fast: Dict[int, bool] = {u.uid: False for u in units}
        fast_used = 0.0
        by_uid = {u.uid: u for u in units}
        # list state: uid -> last-touch tick; FIFO order by insertion
        active: collections.OrderedDict = collections.OrderedDict()
        inactive: collections.OrderedDict = collections.OrderedDict()
        touched_since_opt: collections.OrderedDict = collections.OrderedDict()
        seen_before: set = set()

        opt_every = max(1, steps // max(1, opts_per_step))

        def optimization_pass(bw_budget: float):
            """Promote recently re-touched slow pages; demote FIFO-head
            pages.  Migration volume per pass is bounded by the elapsed-time
            bandwidth product (parallel copy threads, Yan et al.)."""
            nonlocal fast_used
            moved = 0
            for uid in list(touched_since_opt):
                if bw_budget <= 0:
                    break
                u = by_uid[uid]
                if in_fast[uid]:
                    # fast page touched again: inactive -> active promotion
                    if uid in inactive:
                        inactive.pop(uid)
                        active[uid] = True
                    elif cls.recency and uid in active:
                        active.move_to_end(uid)
                    continue
                if uid not in seen_before:
                    continue  # second-touch rule: first sighting classifies
                # slow page was re-touched: candidate for promotion
                while fast_used + u.bytes > fast_bytes and bw_budget > 0:
                    src = inactive if inactive else active
                    if not src:
                        break
                    vid, _ = src.popitem(last=False)      # FIFO/LRU head
                    v = by_uid[vid]
                    if in_fast[vid]:
                        in_fast[vid] = False
                        fast_used -= v.bytes
                        res.migrations += 1
                        res.bytes_f2s += v.bytes
                        bw_budget -= v.bytes
                        moved += 1
                if fast_used + u.bytes <= fast_bytes and bw_budget > 0:
                    in_fast[uid] = True
                    fast_used += u.bytes
                    res.detail["peak_fast_used"] = max(
                        res.detail.get("peak_fast_used", 0.0), fast_used)
                    inactive[uid] = True
                    res.migrations += 1
                    res.bytes_s2f += u.bytes
                    bw_budget -= u.bytes
                    moved += 1
            seen_before.update(touched_since_opt)
            touched_since_opt.clear()
            return moved

        last_rep_time = 0.0
        traffic: List[StepTraffic] = []
        for rep in range(repeats):
            rep_time = 0.0
            since_opt = 0.0
            last_rep = rep == repeats - 1
            for s in range(steps):
                s2f0, f2s0, migs0 = res.bytes_s2f, res.bytes_f2s, \
                    res.migrations
                bytes_slow = 0.0
                for u in access_map.get(s, ()):
                    touched_since_opt[u.uid] = True
                    if not in_fast[u.uid]:
                        bytes_slow += u.bytes
                        res.slow_bytes_accessed += u.bytes
                t_fast = max(0.0, tl.total_bytes[s] - bytes_slow)
                t = max(tl.flops[s] / hw.peak_flops,
                        t_fast / hw.fast_bw + bytes_slow / hw.slow_bw)
                t += tl.extra_time(s, hw)
                rep_time += t
                since_opt += t
                if (s + 1) % opt_every == 0:
                    # daemon runs on dedicated helper threads (Yan et al. use
                    # 4 copy + 8 migration threads): off the critical path
                    optimization_pass(since_opt * hw.mig_bw)
                    since_opt = 0.0
                if last_rep:
                    # steady-state traffic only (matches the reported time)
                    traffic.append(StepTraffic(
                        flops=tl.flops[s], fast_read=t_fast,
                        slow_read=bytes_slow, demand_read=bytes_slow,
                        mig_in=res.bytes_s2f - s2f0,
                        mig_out=res.bytes_f2s - f2s0,
                        tokens=tl.tokens[s],
                        migs=res.migrations - migs0,
                        extra_flops=tl.extra_flops[s],
                        extra_fast=tl.extra_fast_bytes[s],
                        prefill_flops=tl.extra_flops[s],
                        prefill_read=_pread(tl, s)))
            last_rep_time = rep_time
        res.time = last_rep_time
        res.step_traffic = traffic
        return res


@register_policy("ial")
class IAL(_CachingDaemon):
    """Yan et al. ASPLOS'19 two-FIFO-list daemon."""


@register_policy("lru")
class LRUDaemon(_CachingDaemon):
    """Same daemon skeleton with recency ordering."""
    recency = True


# ==================================================================== static ==

class _Static(PlacementPolicy):
    where = "fast"
    plans_ahead = True       # fixed placement: every read is streamable
    supports_replan = True   # stateless: a delta just re-prices it

    @classmethod
    def simulate(cls, workload, hw: HWSpec, fast_bytes: float,
                 **_ignored) -> PlacementResult:
        tl = as_workload(workload).timeline()
        fast = cls.where == "fast"
        bw = hw.fast_bw if fast else hw.slow_bw
        t = sum(max(tl.flops[s] / hw.peak_flops, tl.total_bytes[s] / bw)
                + tl.extra_time(s, hw)
                for s in range(tl.num_steps))
        res = PlacementResult(cls.name, t, sum(_all_fast_times(tl, hw)),
                              tokens=sum(tl.tokens))
        res.step_traffic = [StepTraffic(
            flops=tl.flops[s],
            fast_read=tl.total_bytes[s] if fast else 0.0,
            slow_read=0.0 if fast else tl.total_bytes[s],
            tokens=tl.tokens[s], extra_flops=tl.extra_flops[s],
            extra_fast=tl.extra_fast_bytes[s],
            prefill_flops=tl.extra_flops[s], prefill_read=_pread(tl, s))
            for s in range(tl.num_steps)]
        return res


@register_policy("all_fast")
class AllFast(_Static):
    """Everything in the fast tier: the speed ceiling."""
    where = "fast"


@register_policy("all_slow")
class AllSlow(_Static):
    """Everything in the slow tier: the floor every policy must beat."""
    where = "slow"
