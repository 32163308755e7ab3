"""Online re-planning under traffic drift: the continuous profile→re-plan loop.

``runtime.plan()`` is offline — profile once, place forever — which leans on
the paper's repeatability assumption.  Production serving traffic drifts
(diurnal tenant mix, prompt-length shifts, flash crowds), so this module
closes the loop the way "Online Application Guidance for Heterogeneous
Memory Systems" (PAPERS.md) does: keep profiling the live stream, detect
distribution shift, and re-plan *incrementally*.

    OnlineReplanner   sliding-window drift detector + incremental planner.
                      Consumes per-step stats shaped like the live engine's
                      counters (``ContinuousBatcher.step_migration_bytes``,
                      decode tokens, per-tenant read activity — the same
                      series ``predict_pool_counters`` replays), prices each
                      window with the ``CostModel``, and triggers when the
                      windowed traffic moves more than ``threshold`` against
                      the reference window captured at the last plan.  A
                      trigger re-plans on the freshly observed workload and
                      emits a ``PlanDelta`` (plan.py) — only the fields that
                      changed — whose application is byte-identical to the
                      fresh ``runtime.plan()``.  Hysteresis bounds churn:
                      ``min_dwell`` steps must pass between re-plans, and
                      the cumulative re-layout bytes (shrinking hot windows
                      demote pages) must stay under ``churn_budget_bytes``
                      or the delta is suppressed.  Idle tenants' batch slots
                      are lent to the busiest active tenant (and reclaimed
                      when they wake), the slot-level analogue of
                      ``sentinel_slo`` lending idle quota.
    DriftWorkload     a piecewise-stationary workload: a sequence of
                      stationary segments sharing one slot/KV geometry
                      (runtime/synthetic.py builds the canonical three).
    replay_drift      the simulator-level online loop: walk a DriftWorkload
                      step by step, price the current plan's traffic, feed
                      the replanner, apply its deltas, and report online vs
                      per-segment clairvoyant vs static-stale predicted
                      time — the clairvoyant-regret differential the test
                      suite and ``bench_runtime --drift`` gate.

Regret is defined in the time domain: ``online_s / clairvoyant_s - 1``,
where clairvoyant re-plans each segment with full knowledge at its first
step and pays no detection lag or churn.  Deltas apply to a live engine
through ``ContinuousBatcher.apply_plan`` — demotions toward the new plan's
boundaries go through the ``PageTable`` version machinery, and
``predict_pool_counters(..., plan_schedule=...)`` replays them
integer-exactly.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import json

from repro_torch.runtime.costmodel import CostModel, as_cost_model
from repro_torch.runtime.objects import as_workload
from repro_torch.runtime.plan import (PlacementPlan, PlanDelta, _tenant_knobs,
                                      plan as _plan, plan_delta)
from repro_torch.runtime.policies import get_policy, simulate

DEFAULT_LOOKAHEADS = (2, 4, 8, 16, 32)


# ============================================================ drift workloads ==

def _trace_of(workload):
    tr = getattr(workload, "trace", None)
    if tr is None:
        tr = as_workload(workload).timeline().source
    if tr is None or not hasattr(tr, "num_slots"):
        raise TypeError("drift segments need serving workloads (a ServeTrace "
                        "or MultiTenantWorkload)")
    return tr


@dataclass(frozen=True)
class DriftSegment:
    """One stationary phase of a piecewise-stationary workload."""
    name: str
    workload: Any

    @property
    def trace(self):
        return _trace_of(self.workload)

    @property
    def num_steps(self) -> int:
        return self.trace.num_steps


@dataclass(frozen=True)
class DriftWorkload:
    """A sequence of stationary segments over one serving geometry.  The
    online planner sees the segments only through their step-by-step traffic;
    the clairvoyant oracle plans each segment with full knowledge."""
    name: str
    segments: Tuple[DriftSegment, ...]

    def __post_init__(self):
        if not self.segments:
            raise ValueError("a DriftWorkload needs at least one segment")
        t0 = self.segments[0].trace
        for seg in self.segments[1:]:
            tr = seg.trace
            if (tr.num_slots, tr.num_layers, tr.kv_token_bytes,
                    tr.block_tokens) != (t0.num_slots, t0.num_layers,
                                         t0.kv_token_bytes, t0.block_tokens):
                raise ValueError(
                    f"segment {seg.name!r} changes the slot/KV geometry — "
                    "plans would not be compatible across segments")

    @property
    def num_steps(self) -> int:
        return sum(s.num_steps for s in self.segments)

    def peak_kv_bytes(self) -> float:
        return max(s.trace.peak_kv_bytes() for s in self.segments)

    def row_bytes(self) -> float:
        """KV bytes per token across all layers — the unit hot-window
        changes are converted to churn bytes with."""
        t = self.segments[0].trace
        return t.num_layers * t.kv_token_bytes


# ============================================================== window stats ==

@dataclass
class StepStat:
    """One decode step's observed counters — the engine-shaped unit the
    replanner consumes (``step_migration_bytes[t]``, tokens decoded, priced
    step seconds, per-tenant read bytes)."""
    time_s: float = 0.0
    tokens: float = 0.0
    mig_bytes: float = 0.0
    tenant_reads: Dict[str, float] = field(default_factory=dict)


@dataclass
class WindowStats:
    """A sliding window of StepStats folded to means."""
    start: int
    end: int
    step_time: float
    tokens: float
    migration: float
    tenant_share: Dict[str, float] = field(default_factory=dict)

    @classmethod
    def fold(cls, start: int, stats: Sequence[StepStat]) -> "WindowStats":
        n = max(1, len(stats))
        per: Dict[str, float] = {}
        for st in stats:
            for tn, b in st.tenant_reads.items():
                per[tn] = per.get(tn, 0.0) + b
        total = sum(per.values())
        share = {tn: b / total for tn, b in sorted(per.items())} \
            if total > 0 else {}
        return cls(start=start, end=start + len(stats),
                   step_time=sum(s.time_s for s in stats) / n,
                   tokens=sum(s.tokens for s in stats) / n,
                   migration=sum(s.mig_bytes for s in stats) / n,
                   tenant_share=share)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def drift_score(ws: WindowStats, ref: WindowStats) -> Tuple[float, str]:
    """How far the window moved from the reference, and which signal moved
    most: relative priced step time / token rate / migration rate, plus the
    absolute per-tenant read-share shift (a mix flip can hide inside a flat
    aggregate)."""
    cands = [(_rel(ws.step_time, ref.step_time), "step_time"),
             (_rel(ws.tokens, ref.tokens), "tokens")]
    if ws.migration > 0 or ref.migration > 0:
        cands.append((_rel(ws.migration, ref.migration), "migration"))
    tenants = set(ws.tenant_share) | set(ref.tenant_share)
    if tenants:
        mix = max(abs(ws.tenant_share.get(tn, 0.0)
                      - ref.tenant_share.get(tn, 0.0)) for tn in tenants)
        cands.append((mix, "tenant_mix"))
    score, label = max(cands)
    return min(score, 99.0), label


# ==================================================================== events ==

@dataclass
class ReplanEvent:
    """One replanner decision: a drift re-plan, a slot lend/reclaim, or a
    churn-budget suppression (``applied=False``)."""
    step: int
    segment: int
    reason: str
    churn_bytes: float
    applied: bool
    delta: PlanDelta
    plan: Optional[PlacementPlan] = None      # applied plan; not serialized

    def to_dict(self) -> dict:
        return {"step": self.step, "segment": self.segment,
                "reason": self.reason, "churn_bytes": self.churn_bytes,
                "applied": self.applied, "delta": self.delta.to_dict()}


def plan_churn_bytes(old: PlacementPlan, new: PlacementPlan,
                     row_bytes: float) -> float:
    """Bytes a steady-state engine demotes to adopt ``new``: every token a
    slot's hot window shrinks by is a page-table demotion at the boundary
    (grown windows cost nothing — cold pages are never promoted back)."""
    slots = max(len(old.slot_hot_windows or ()),
                len(new.slot_hot_windows or ()), 1)
    return float(sum(
        max(0, old.slot_window(s) - new.slot_window(s)) * row_bytes
        for s in range(slots)))


# ================================================================= replanner ==

class OnlineReplanner:
    """The continuous profile→re-plan loop's decision core.

    Drive it with ``record(step, StepStat)`` per decode step; it keeps a
    ``window``-step sliding window and a reference window captured at the
    last (re-)plan.  ``drift_reason`` answers whether the windowed traffic
    moved beyond ``threshold`` (and the hysteresis dwell passed);
    ``replan`` diffs a fresh plan on the re-profiled workload into a
    ``PlanDelta`` and applies it unless the cumulative churn budget would be
    exceeded; ``maybe_lend`` emits slot-reassignment deltas for idle
    tenants.  All decisions are recorded in ``events``."""

    def __init__(self, cost_model, fast_bytes: float, *, window: int = 8,
                 threshold: float = 0.2, min_dwell: int = 16,
                 churn_budget_bytes: Optional[float] = None,
                 row_bytes: float = 0.0, policy: Optional[str] = None,
                 lookaheads: Sequence[int] = DEFAULT_LOOKAHEADS,
                 lend_idle: bool = True):
        self.cm = as_cost_model(cost_model)
        self.fast_bytes = float(fast_bytes)
        self.window = max(1, int(window))
        self.threshold = float(threshold)
        self.min_dwell = max(0, int(min_dwell))
        self.churn_budget_bytes = (4.0 * self.fast_bytes
                                   if churn_budget_bytes is None
                                   else float(churn_budget_bytes))
        self.row_bytes = float(row_bytes)
        self.policy = policy
        self.lookaheads = tuple(lookaheads)
        self.lend_idle = bool(lend_idle)
        self.plan: Optional[PlacementPlan] = None
        self.events: List[ReplanEvent] = []
        self.churn_spent = 0.0
        self._recent: deque = deque(maxlen=self.window)
        self._recent_start = 0
        self._ref: Optional[WindowStats] = None
        self._owner: Optional[List[str]] = None   # true slot ownership
        self._last_replan = 0
        self._last_lend = -(1 << 30)

    # ------------------------------------------------------------ feeding --
    def adopt(self, plan: PlacementPlan, step: int = 0) -> None:
        """Install a plan (the initial offline plan, or an external one).
        Refuses policies that cannot be re-parameterized by a delta."""
        if not get_policy(plan.policy).supports_replan:
            raise ValueError(
                f"policy {plan.policy!r} does not support incremental "
                "re-planning (PlacementPolicy.supports_replan is False; "
                "see docs/POLICIES.md)")
        self.plan = plan
        if plan.slot_tenants:
            self._owner = list(plan.slot_tenants)
        self._last_replan = step
        self._ref = None                   # re-captured on the next full window

    def record(self, step: int, stat: StepStat) -> None:
        if not self._recent:
            self._recent_start = step
        elif len(self._recent) == self.window:
            self._recent_start += 1
        self._recent.append(stat)
        if self._ref is None and len(self._recent) == self.window:
            self._ref = self.window_stats()

    def window_stats(self) -> Optional[WindowStats]:
        if not self._recent:
            return None
        return WindowStats.fold(self._recent_start, list(self._recent))

    # ----------------------------------------------------------- deciding --
    def drift_reason(self, step: int) -> Optional[str]:
        """Non-None when the windowed traffic drifted beyond ``threshold``
        against the reference window and the min-dwell hysteresis passed."""
        if self._ref is None or len(self._recent) < self.window:
            return None
        if step - self._last_replan < self.min_dwell:
            return None
        score, label = drift_score(self.window_stats(), self._ref)
        if score <= self.threshold:
            return None
        return f"{label}:{score:.2f}"

    def replan(self, workload, step: int, reason: str,
               segment: int = -1) -> Optional[ReplanEvent]:
        """Re-plan on the freshly observed workload, emit the delta, apply
        it within the churn budget.  Returns None when the fresh plan equals
        the current one (the traffic moved; the placement didn't)."""
        fresh = _plan(workload, self.cm, self.fast_bytes, policy=self.policy,
                      lookaheads=self.lookaheads, objective="latency")
        self._last_replan = step
        self._ref = self.window_stats()    # rebaseline on today's traffic
        # a lend in effect is the replanner's own state, not drift: when the
        # fresh plan differs only in slot tenancy, the placement did not
        # actually move — rebaseline silently instead of thrashing the lend
        probe = fresh
        if list(fresh.slot_tenants or ()) != list(self.plan.slot_tenants
                                                  or ()):
            probe = replace(fresh, slot_tenants=self.plan.slot_tenants)
        if plan_delta(self.plan, probe) is None:
            return None
        delta = plan_delta(self.plan, fresh, step=step, reason=reason)
        churn = plan_churn_bytes(self.plan, fresh, self.row_bytes)
        applied = self.churn_spent + churn <= self.churn_budget_bytes
        ev = ReplanEvent(step=step, segment=segment, reason=reason,
                         churn_bytes=churn, applied=applied, delta=delta,
                         plan=fresh if applied else None)
        if applied:
            self.plan = self.plan.apply_delta(delta)
            assert self.plan.to_json() == fresh.to_json()   # the contract
            if fresh.slot_tenants:
                self._owner = list(fresh.slot_tenants)
            self.churn_spent += churn
        self.events.append(ev)
        return ev

    def maybe_lend(self, step: int, segment: int = -1) -> \
            Optional[ReplanEvent]:
        """Elastic slot reassignment: an owner tenant with zero read
        activity across the whole window lends its slots to the busiest
        active tenant; a woken owner reclaims them.  Pure ``slot_tenants``
        deltas — no pages move, so churn is zero and the budget/dwell
        hysteresis does not apply (only a one-window spacing)."""
        if not self.lend_idle or self._owner is None or \
                len(self._recent) < self.window:
            return None
        if step - self._last_lend < self.window:
            return None
        ws = self.window_stats()
        activity = {tn: ws.tenant_share.get(tn, 0.0)
                    for tn in sorted(set(self._owner))}
        busy = [tn for tn, a in activity.items() if a > 0.0]
        if not busy:
            return None
        top = max(busy, key=lambda tn: (activity[tn], tn))
        desired = [tn if activity[tn] > 0.0 else top for tn in self._owner]
        if desired == list(self.plan.slot_tenants or ()):
            return None
        idle = sorted(tn for tn, a in activity.items() if a <= 0.0)
        reason = (f"lend:{','.join(idle)}->{top}" if idle
                  else "reclaim:owners")
        delta = PlanDelta(step=step, reason=reason,
                          base_digest=self.plan.digest(),
                          changes={"slot_tenants": desired})
        self.plan = self.plan.apply_delta(delta)
        self._last_lend = step
        ev = ReplanEvent(step=step, segment=segment, reason=reason,
                         churn_bytes=0.0, applied=True, delta=delta,
                         plan=self.plan)
        self.events.append(ev)
        return ev


# ==================================================================== report ==

@dataclass
class SegmentReport:
    name: str
    steps: int
    tokens: int
    online_s: float
    clairvoyant_s: float
    static_s: float
    online_mig_bytes: float
    clairvoyant_mig_bytes: float
    static_mig_bytes: float

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in (
            "name", "steps", "tokens", "online_s", "clairvoyant_s",
            "static_s", "online_mig_bytes", "clairvoyant_mig_bytes",
            "static_mig_bytes")}


@dataclass
class OnlineReport:
    """The clairvoyant-regret differential: online vs per-segment oracle vs
    static-stale, plus the full re-plan event sequence.  ``to_json`` is the
    golden-fixture serialization (deterministic bytes)."""
    workload: str
    policy: str
    knobs: Dict[str, float]
    segments: List[SegmentReport]
    events: List[ReplanEvent]
    churn_bytes: float
    churn_budget_bytes: float
    tenant_violations: Dict[str, int]
    plan0: Optional[PlacementPlan] = None     # not serialized

    @property
    def online_s(self) -> float:
        return sum(s.online_s for s in self.segments)

    @property
    def clairvoyant_s(self) -> float:
        return sum(s.clairvoyant_s for s in self.segments)

    @property
    def static_s(self) -> float:
        return sum(s.static_s for s in self.segments)

    @property
    def tokens(self) -> int:
        return sum(s.tokens for s in self.segments)

    @property
    def regret(self) -> float:
        """Predicted-time regret vs the clairvoyant plan sequence (equals
        the tokens/sec regret — every plan serves the same tokens)."""
        return self.online_s / max(self.clairvoyant_s, 1e-30) - 1.0

    @property
    def online_mig_bytes(self) -> float:
        return sum(s.online_mig_bytes for s in self.segments) \
            + self.churn_bytes

    @property
    def clairvoyant_mig_bytes(self) -> float:
        return sum(s.clairvoyant_mig_bytes for s in self.segments)

    @property
    def online_tokens_per_s(self) -> float:
        return self.tokens / max(self.online_s, 1e-30)

    @property
    def static_tokens_per_s(self) -> float:
        return self.tokens / max(self.static_s, 1e-30)

    def to_dict(self) -> dict:
        return {"workload": self.workload, "policy": self.policy,
                "knobs": self.knobs,
                "segments": [s.to_dict() for s in self.segments],
                "events": [e.to_dict() for e in self.events],
                "churn_bytes": self.churn_bytes,
                "churn_budget_bytes": self.churn_budget_bytes,
                "tenant_violations": self.tenant_violations,
                "online_s": self.online_s,
                "clairvoyant_s": self.clairvoyant_s,
                "static_s": self.static_s,
                "regret": self.regret,
                "online_mig_bytes": self.online_mig_bytes,
                "clairvoyant_mig_bytes": self.clairvoyant_mig_bytes}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=2)


# ==================================================================== replay ==

def _price_plan(wl, cm: CostModel, fast_bytes: float, plan: PlacementPlan):
    """Simulate ``wl`` under ``plan``'s policy/knobs and price the traffic:
    (per-step seconds, per-step migration bytes, PlacementResult)."""
    knobs = dict(get_policy(plan.policy).replan_knobs(plan))
    knobs.update(_tenant_knobs(wl, plan.policy))
    res = simulate(wl, cm, fast_bytes, plan.policy, **knobs)
    rep = cm.price(res.step_traffic)
    mig = [tr.mig_in + tr.mig_out for tr in res.step_traffic]
    return rep.step_times, mig, res


def _tenant_read_series(wl) -> List[Dict[str, float]]:
    """Per-step per-tenant read bytes from the timeline — the replay's stand-
    in for the engine's per-tenant counters (a tenant reads only while it
    decodes, so zero reads across a window means an idle tenant)."""
    tl = as_workload(wl).timeline()
    out: List[Dict[str, float]] = []
    for t in range(tl.num_steps):
        per: Dict[str, float] = {}
        for o in tl.reads.get(t, ()):
            tn = getattr(o, "tenant", None)
            if tn is not None:
                per[str(tn)] = per.get(str(tn), 0.0) + o.bytes
        out.append(per)
    return out


def replay_drift(drift: DriftWorkload, cost_model, fast_bytes: float, *,
                 policy: Optional[str] = None, window: int = 8,
                 threshold: float = 0.2, min_dwell: int = 16,
                 churn_budget_bytes: Optional[float] = None,
                 lookaheads: Sequence[int] = DEFAULT_LOOKAHEADS,
                 lend_idle: bool = True) -> OnlineReport:
    """Walk a piecewise-stationary workload through the online loop.

    Per segment, the replay prices each step under the plan in effect (the
    same per-step traffic the engine's counters report), feeds the replanner,
    and applies its deltas; a mid-segment re-plan re-prices the remaining
    steps under the fresh plan and pays the re-layout churn as a stall
    (``churn_bytes / mig_bw``) on the trigger step.  The report compares
    against the per-segment clairvoyant oracle (fresh ``runtime.plan`` at
    each segment's first step, no lag, no churn) and the static-stale
    baseline (segment-0's plan forever)."""
    cm = as_cost_model(cost_model)
    segs = drift.segments
    plan0 = _plan(segs[0].workload, cm, fast_bytes, policy=policy,
                  lookaheads=lookaheads, objective="latency")
    rpl = OnlineReplanner(cm, fast_bytes, window=window, threshold=threshold,
                          min_dwell=min_dwell,
                          churn_budget_bytes=churn_budget_bytes,
                          row_bytes=drift.row_bytes(), policy=policy,
                          lookaheads=lookaheads, lend_idle=lend_idle)
    rpl.adopt(plan0, step=0)
    seg_reports: List[SegmentReport] = []
    violations: Dict[str, int] = {}
    gstep = 0

    def note_violations(res) -> None:
        for tn, n in (res.tenant_violations or {}).items():
            violations[tn] = violations.get(tn, 0) + n

    for si, seg in enumerate(segs):
        wl = seg.workload
        steps = seg.num_steps
        tenant_reads = _tenant_read_series(wl)
        # the clairvoyant oracle: full knowledge at the segment's first step
        clair = plan0 if si == 0 else _plan(wl, cm, fast_bytes, policy=policy,
                                            lookaheads=lookaheads,
                                            objective="latency")
        clair_times = list(clair.predicted_step_times)
        clair_mig = [tr.mig_in + tr.mig_out for tr in clair.sim.step_traffic]
        # the static-stale baseline: segment-0's plan forever
        if si == 0:
            static_times, static_mig = clair_times, clair_mig
        else:
            static_times, static_mig, _ = _price_plan(wl, cm, fast_bytes,
                                                      plan0)
        # the online walk: price under the plan in effect, feed the
        # replanner, switch series when a delta lands
        cache: Dict[str, tuple] = {clair.digest(): (clair_times, clair_mig)}
        cur = None
        online_s = online_mig = 0.0
        local = 0
        while local < steps:
            if cur is None:
                key = rpl.plan.digest()
                if key not in cache:
                    t, m, res = _price_plan(wl, cm, fast_bytes, rpl.plan)
                    note_violations(res)
                    cache[key] = (t, m)
                cur = cache[key]
            online_s += cur[0][local]
            online_mig += cur[1][local]
            rpl.record(gstep, StepStat(
                time_s=cur[0][local], tokens=clair.sim.step_traffic[local]
                .tokens, mig_bytes=cur[1][local],
                tenant_reads=tenant_reads[local]))
            rpl.maybe_lend(gstep, segment=si)      # pricing is unchanged
            reason = rpl.drift_reason(gstep)
            if reason is not None:
                ev = rpl.replan(wl, gstep, reason, segment=si)
                if ev is not None and ev.applied:
                    # the re-layout copies stall the trigger step; the rest
                    # of the segment prices under the fresh plan
                    online_s += ev.churn_bytes / cm.mig_bw
                    if ev.plan.predicted_step_times:
                        cache.setdefault(ev.plan.digest(), (
                            list(ev.plan.predicted_step_times),
                            [tr.mig_in + tr.mig_out
                             for tr in ev.plan.sim.step_traffic]))
                    cur = None
            local += 1
            gstep += 1
        note_violations(clair.sim)
        seg_reports.append(SegmentReport(
            name=seg.name, steps=steps,
            tokens=int(sum(tr.tokens for tr in clair.sim.step_traffic)),
            online_s=online_s, clairvoyant_s=sum(clair_times),
            static_s=sum(static_times), online_mig_bytes=online_mig,
            clairvoyant_mig_bytes=sum(clair_mig),
            static_mig_bytes=sum(static_mig)))
    return OnlineReport(
        workload=drift.name, policy=plan0.policy,
        knobs={"window": rpl.window, "threshold": rpl.threshold,
               "min_dwell": rpl.min_dwell, "fast_bytes": fast_bytes},
        segments=seg_reports, events=rpl.events,
        churn_bytes=rpl.churn_spent,
        churn_budget_bytes=rpl.churn_budget_bytes,
        tenant_violations=dict(sorted(violations.items())), plan0=plan0)
