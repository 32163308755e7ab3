"""The unified planner: ``runtime.plan(workload, cost_model, fast_bytes)``
for both training and serving, returning one serializable ``PlacementPlan``.

The machine is a ``CostModel`` (runtime/costmodel.py); a legacy ``HWSpec``
passed positionally is upgraded in place via ``CostModel.from_hw`` (the
upgraded model simulates identically).  ``objective`` selects what the
measured sweep optimizes: ``"bytes"`` (default) keeps the legacy byte-domain
clock and its golden plans byte-stable; ``"latency"`` selects the candidate whose recorded
per-step traffic the CostModel prices fastest — and, for serving, also
auditions the ``alpha_migration`` policy against the default, since holding
the read split at the bandwidth-optimal alpha can win in the time domain
while losing in the byte domain.

Training (paper §4.4) — given one profiled training step:
  1. compute RS(MI), Data(MI), T(MI) for every candidate interval,
  2. prune by the paper's two constraints,
       space (Eq. 1):  Data(MI) < S - RS(MI)
       time  (Eq. 2):  T(MI)    > (S - RS(MI)) / BW
  3. measure surviving candidates through the registered policy (the runtime
     system would use one real training step per candidate — same procedure,
     measured instead of simulated), resolving Case 3 by test-and-trial,
  4. return the sweet spot.

Serving — the same Eq. 1/2 restated per decode *token*: the reserve pool RS
is the set of open (still-filling) KV blocks, the candidates are prefetch
look-aheads, and the per-slot hot windows are sized from each slot's own
decode schedule.

The resulting ``PlacementPlan`` subsumes the legacy training ``Plan`` and
serving ``ServePlan``: it drives the training offload engine (``mi`` is the
layer-scan block size; ROADMAP item 10), the serving engine
(``serve/engine.ContinuousBatcher`` — ``cold_len_slot`` /
``page_tokens``), and the benchmarks; ``to_json`` / ``from_json`` round-trip
it bit-identically for storage beside benchmark artifacts.  Where each paper equation lands in the code is mapped in
``docs/RUNTIME_API.md``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from repro_torch import telemetry
from repro_torch.core.hardware import HWSpec
from repro_torch.runtime.costmodel import CostModel, CostReport
from repro_torch.runtime.objects import (MemoryTier, TrainingWorkload,
                                         as_workload, tiers_from_hw)
from repro_torch.runtime.policies import PlacementResult, get_policy, simulate

OBJECTIVES = ("bytes", "latency")


def _resolve_cost_model(cost_model, caller: str) -> CostModel:
    """The machine as one CostModel: ``cost_model`` accepts a CostModel or
    a legacy HWSpec (upgraded silently — they simulate identically)."""
    if cost_model is None:
        raise TypeError(f"runtime.{caller}() needs a machine: pass a "
                        "CostModel (or an HWSpec) as the second argument")
    return CostModel.from_hw(cost_model)


def _check_objective(objective: str, caller: str) -> None:
    if objective not in OBJECTIVES:
        raise ValueError(f"runtime.{caller}(objective={objective!r}): "
                         f"expected one of {OBJECTIVES}")


def _graph_fold(cm, tier_graph, fast_bytes):
    """Resolve the machine the simulations run on.  With a ``tier_graph``
    the policies see its two-tier fold (``TierGraph.hw_view`` — on the
    canonical fast/slow graph the fold IS ``cm``, value for value), and a
    missing ``fast_bytes`` defaults to the compute node's capacity."""
    if tier_graph is None:
        return cm, fast_bytes
    view = tier_graph.hw_view(cm)
    if fast_bytes is None:
        cap = tier_graph.capacity(view.compute)
        if cap is None:
            raise ValueError("plan(tier_graph=...) needs fast_bytes when "
                             "the compute tier is unbounded")
        fast_bytes = float(cap)
    return view, fast_bytes


def _graph_dict(tier_graph, cm, fast_bytes):
    """The plan's serialized topology: None for the canonical two-tier
    graph (already described by ``tiers``/``cost_model``; keeps golden
    JSONs byte-identical), the full node/edge dict otherwise."""
    if tier_graph is None or tier_graph.matches_two_tier(cm, fast_bytes):
        return None
    return tier_graph.to_dict()


# ================================================================ candidates ==

@dataclass
class Candidate:
    """A training migration-interval candidate."""
    mi: int
    rs: float
    data: float          # max prefetch bytes over intervals
    t: float             # min compute seconds over intervals
    space_ok: bool
    time_ok: bool
    sim: Optional[PlacementResult] = None


@dataclass
class ServeCandidate:
    """A serving look-ahead candidate."""
    lookahead: int
    hot_window: int          # tokens of KV kept fast per slot
    prefetch_bytes: float    # per-step slow->fast demand at this look-ahead
    t_token: float           # all-fast decode step time
    space_ok: bool
    time_ok: bool
    sim: Optional[PlacementResult] = None


# ====================================================================== plan ==

@dataclass
class PlacementPlan:
    """The one tiering decision both runtimes consume.

    ``kind`` selects which half is meaningful: training plans carry ``mi``
    (migration interval in timeline steps) and the Case-3 resolution;
    serving plans carry the hot window / look-ahead / per-slot windows.
    ``slot_hot_windows`` refines the single global window per *slot*: each
    slot's window is sized from its own decode schedule (the byte-seconds its
    KV objects occupy in the trace), so a slot serving short requests never
    pins the same hot budget as one serving long ones.  ``page_tokens`` is
    the page granularity those per-slot boundaries are quantized to — the
    unit the paged decode kernel and the PageTable move.
    """
    kind: str = "serving"            # "training" | "serving"
    policy: str = "sentinel"
    fast_bytes: float = 0.0
    rs: float = 0.0
    # ---- training half ----
    mi: int = 0
    stall_on_case3: bool = True
    steps_used: int = 0              # "p, m & t" budget consumed (Table 3)
    # ---- serving half ----
    hot_window: int = 0
    lookahead: int = 0
    slot_hot_windows: Optional[List[int]] = None
    page_tokens: int = 0
    # per-step prompt-token budget the engine's prefill scheduler drains
    # before each decode dispatch (0 = one-shot prefill, the legacy
    # behavior; the key is dropped from the JSON then, keeping every
    # earlier golden plan byte-identical)
    prefill_chunk_tokens: int = 0
    # slot_devices[s] is the decode shard owning batch slot s
    # (``plan_serving(..., decode_devices=N)``).  None on single-device
    # plans, and the key is dropped from the JSON then — the trivial
    # placement folds away and every earlier golden plan stays
    # byte-identical.
    slot_devices: Optional[List[int]] = None
    # ---- multi-tenant accounting (None on single-tenant plans) ----
    # slot_tenants[s] names the tenant owning batch slot s (the engine admits
    # a request only into its own tenant's slots); tenant_quotas are the
    # guaranteed fast-share fractions the windows were sized under;
    # tenant_fast_bytes / tenant_violations echo the winning simulation's
    # per-tenant peaks and quota-violation counts (the SLO report card).
    slot_tenants: Optional[List[str]] = None
    tenant_quotas: Optional[Dict[str, float]] = None
    tenant_fast_bytes: Optional[Dict[str, float]] = None
    tenant_violations: Optional[Dict[str, int]] = None
    # ---- shared ----
    tiers: Optional[List[MemoryTier]] = None
    candidates: List[Any] = field(default_factory=list)
    sim: Optional[PlacementResult] = None
    # ---- time-domain half (populated by objective="latency" only; the
    # bytes default serializes without these keys, keeping golden plan JSON
    # from earlier PRs byte-identical) ----
    objective: str = "bytes"
    cost_model: Optional[CostModel] = None
    predicted_step_times: Optional[List[float]] = None
    # ---- tier-graph half (``runtime.plan(..., tier_graph=)``): the
    # serialized memory topology the plan was made for.  None on two-tier
    # plans — the canonical fast/slow graph is already fully described by
    # ``tiers``/``cost_model``, and dropping the key keeps every golden
    # plan JSON byte-identical. ----
    tier_graph: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------ queries --
    @property
    def throughput(self) -> float:
        return self.sim.throughput if self.sim else 0.0

    @property
    def decode_throughput(self) -> float:
        return self.sim.decode_throughput if self.sim else 0.0

    @property
    def predicted_time(self) -> float:
        """CostModel-predicted seconds for the whole timeline (0.0 on
        bytes-objective plans, which carry no prediction)."""
        return sum(self.predicted_step_times) if self.predicted_step_times \
            else 0.0

    @property
    def predicted_decode_throughput(self) -> float:
        """Predicted tokens/second under the plan's CostModel."""
        t = self.predicted_time
        return self.sim.tokens / t if (self.sim and t) else 0.0

    def cold_len(self, max_seq: int) -> int:
        """Cold-prefix length for a ``max_seq``-token cache buffer (global
        boundary — the concat path)."""
        return max(0, max_seq - self.hot_window)

    def slot_window(self, slot: int) -> int:
        """Hot-window tokens for ``slot`` (falls back to the global window)."""
        if not self.slot_hot_windows:
            return self.hot_window
        return self.slot_hot_windows[slot % len(self.slot_hot_windows)]

    def cold_len_slot(self, slot: int, seq_len: int,
                      page_tokens: Optional[int] = None) -> int:
        """Cold boundary for ``slot`` at its *current* sequence length,
        quantized down to page granularity: tokens older than the slot's own
        hot window, in whole pages.  Monotone in ``seq_len``, so within one
        residency a slot's boundary only ever advances.  ``page_tokens``
        overrides the plan's page size (the engine adjusts it to divide its
        cache buffer)."""
        cold = max(0, seq_len - self.slot_window(slot))
        page = max(1, page_tokens if page_tokens else self.page_tokens)
        return (cold // page) * page

    # --------------------------------------------------------------- json --
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for c, cd in zip(self.candidates, d["candidates"]):
            cd["_type"] = "interval" if isinstance(c, Candidate) else "serve"
        if self.objective == "bytes":
            # legacy serialization: bytes-objective plans predate the time
            # domain, and their golden JSON must stay byte-for-byte stable
            del d["objective"], d["cost_model"], d["predicted_step_times"]
        elif self.cost_model is not None:
            d["cost_model"] = self.cost_model.to_dict()   # inf -> None
        if self.tier_graph is None:
            # two-tier plans predate the graph; dropping the key keeps their
            # golden JSON byte-identical
            del d["tier_graph"]
        if not self.prefill_chunk_tokens:
            # one-shot prefill predates the chunk knob — same golden-JSON
            # stability pattern as tier_graph
            del d["prefill_chunk_tokens"]
        if self.slot_devices is None:
            # single-device plans predate slot placement — same pattern
            del d["slot_devices"]
        return d

    def to_json(self) -> str:
        """Deterministic serialization: same plan -> same bytes (the golden
        round-trip contract ``from_json(p.to_json()).to_json() == p.to_json()``
        guards against silent planner drift)."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "PlacementPlan":
        d = dict(d)
        cands = []
        for cd in d.get("candidates") or []:
            cd = dict(cd)
            typ = cd.pop("_type", "serve")
            cd["sim"] = _result_from_dict(cd.get("sim"))
            cands.append((Candidate if typ == "interval"
                          else ServeCandidate)(**cd))
        d["candidates"] = cands
        d["sim"] = _result_from_dict(d.get("sim"))
        if d.get("tiers") is not None:
            d["tiers"] = [MemoryTier(**t) for t in d["tiers"]]
        if d.get("cost_model") is not None:
            d["cost_model"] = CostModel.from_dict(d["cost_model"])
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "PlacementPlan":
        return cls.from_dict(json.loads(s))

    # ------------------------------------------------------------- deltas --
    def digest(self) -> str:
        """Content digest of the serialized plan — the identity a
        ``PlanDelta`` is pinned against, so deltas can only be applied to
        the exact plan they were diffed from (and in emission order)."""
        return hashlib.sha1(self.to_json().encode()).hexdigest()[:16]

    def apply_delta(self, delta: "PlanDelta") -> "PlacementPlan":
        """Apply an incremental re-plan.  The contract (pinned by
        tests/test_online_replan.py): for any two plans,
        ``old.apply_delta(plan_delta(old, new)).to_json() == new.to_json()``
        byte-for-byte — an applied delta IS the fresh plan."""
        if delta.base_digest and delta.base_digest != self.digest():
            raise ValueError(
                f"delta (step {delta.step}) was diffed against plan "
                f"{delta.base_digest}, not {self.digest()} — apply deltas "
                "in emission order")
        d = self.to_dict()
        for k in delta.removed:
            d.pop(k, None)
        # normalize through JSON so an in-memory delta and one reloaded from
        # disk apply identically (tuples -> lists, int dict keys -> str; the
        # from_dict path re-types both forms)
        d.update(json.loads(json.dumps(delta.changes)))
        return PlacementPlan.from_dict(d)


@dataclass
class PlanDelta:
    """An incremental re-plan: only the serialized plan fields that changed.

    ``changes`` maps top-level ``PlacementPlan.to_dict()`` keys to their new
    serialized values; ``removed`` lists keys the new plan no longer
    serializes (an objective downgrade).  ``base_digest`` pins the plan the
    delta was diffed against — ``apply_delta`` refuses a mismatched base, so
    a delta stream replays deterministically or not at all.  ``step`` is the
    decode step the online replanner emitted it at and ``reason`` the drift
    trigger (``docs/RUNTIME_API.md#online-re-planning``)."""
    step: int = 0
    reason: str = ""
    base_digest: str = ""
    changes: Dict[str, Any] = field(default_factory=dict)
    removed: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"step": self.step, "reason": self.reason,
                "base_digest": self.base_digest,
                "changes": self.changes, "removed": list(self.removed)}

    def to_json(self) -> str:
        """Deterministic bytes: ``from_json(d.to_json()).to_json()`` is
        byte-identical (the same round-trip contract plans carry)."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "PlanDelta":
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "PlanDelta":
        return cls.from_dict(json.loads(s))


def plan_delta(old: PlacementPlan, new: PlacementPlan, *, step: int = 0,
               reason: str = "") -> Optional[PlanDelta]:
    """Diff two plans into an incremental delta (None when nothing changed —
    traffic moved but the planner landed on the same placement)."""
    od, nd = old.to_dict(), new.to_dict()
    changes = {k: v for k, v in nd.items() if k not in od or od[k] != v}
    removed = sorted(k for k in od if k not in nd)
    if not changes and not removed:
        return None
    return PlanDelta(step=step, reason=reason, base_digest=old.digest(),
                     changes=changes, removed=removed)


def _result_from_dict(d: Optional[dict]) -> Optional[PlacementResult]:
    if d is None:
        return None
    d = dict(d)
    d["cases"] = {int(k): v for k, v in d.get("cases", {}).items()}
    return PlacementResult(**d)


# ========================================================== training planner ==

def interval_stats(profile, mi: int, hw: HWSpec):
    """(Data(MI), T(MI)) per interval: prefetch bytes needed by each interval
    and compute time available in the preceding one."""
    steps = profile.num_steps
    acts = [o for o in profile.objects if o.accesses]
    data_per: Dict[int, float] = {}
    t_per: Dict[int, float] = {}
    n_int = (steps + mi - 1) // mi
    for i in range(n_int):
        lo, hi = i * mi, min((i + 1) * mi, steps)
        t_per[i] = sum(max(profile.step_flops(s) / hw.peak_flops,
                           profile.step_bytes(s) / hw.fast_bw)
                       for s in range(lo, hi))
        data_per[i] = 0.0
    # the final boundary step (embedding grad + optimizer) touches every
    # weight/moment, but elementwise: it streams tile-by-tile and never needs
    # them resident together (ZeRO-Offload-style), so it is exempt from the
    # Eq. 1 capacity constraint (it still costs migration *time*).
    opt_step = steps - 1
    for o in acts:
        if o.kind == "weight" or o.lifetime >= 2:
            touched = sorted({a // mi for a in o.accesses if a != opt_step})
            for i in touched:
                # fetched for interval i (unless it was just produced there)
                if o.kind == "weight" or o.birth // mi != i:
                    data_per[i] += o.size
    return data_per, t_per


def enumerate_candidates(profile, hw: HWSpec, fast_bytes: float,
                         max_mi: Optional[int] = None) -> List[Candidate]:
    out = []
    steps = profile.num_steps
    max_mi = max_mi or max(1, steps // 2)
    for mi in range(1, max_mi + 1):
        rs = profile.rs_bytes(mi)
        data_per, t_per = interval_stats(profile, mi, hw)
        data = max(data_per.values()) if data_per else 0.0
        t = min(t_per.values()) if t_per else 0.0
        space_ok = data < fast_bytes - rs
        time_ok = t > data / hw.mig_bw      # tight form of Eq. 2 (see note)
        out.append(Candidate(mi, rs, data, t, space_ok, time_ok))
    return out


def plan_training(workload, cost_model=None, fast_bytes: float = None, *,
                  policy: str = "sentinel_mi", max_mi: Optional[int] = None,
                  sim_all: bool = False, objective: str = "bytes",
                  tier_graph=None) -> PlacementPlan:
    """Pick the optimal migration interval.

    Note on Eq. 2: the paper states T(MI) > (S - RS)/BW — the worst case of a
    full fast-memory refill.  We prune with the tighter per-interval form
    T(MI) > Data(MI)/BW (a superset of the paper's surviving candidates) and
    let the measured sweep decide, exactly as the paper's runtime does.

    ``objective="latency"`` keeps the same candidate pool but selects the MI
    whose recorded traffic the CostModel prices fastest (migration copies
    contend with the training step's own reads there, which the byte-domain
    clock cannot see).
    """
    cm = _resolve_cost_model(cost_model, "plan_training")
    _check_objective(objective, "plan_training")
    sim_hw, fast_bytes = _graph_fold(cm, tier_graph, fast_bytes)
    wl = as_workload(workload)
    profile = getattr(wl, "profile", None)
    if profile is None:                      # protocol workloads / timelines
        profile = wl.timeline().source
    if profile is None or not hasattr(profile, "num_periods"):
        raise TypeError("plan_training needs a workload whose timeline "
                        "sources a TraceProfile (candidate enumeration reads "
                        "the profiled objects)")
    pol = get_policy(policy)
    cands = enumerate_candidates(profile, sim_hw, fast_bytes, max_mi)
    survivors = [c for c in cands if c.space_ok and c.time_ok]
    if not survivors:                        # fall back: least-bad candidates
        survivors = [c for c in cands if c.space_ok] or cands
    steps_used = 1                           # the profiling step
    best: Optional[Candidate] = None
    best_pred: Optional[CostReport] = None
    pool = survivors if not sim_all else cands
    for c in pool:
        c.sim = pol.simulate(wl, sim_hw, fast_bytes, mi=c.mi)
        steps_used += 1 + c.sim.detail.get("tt_steps_used", 0)
        if objective == "latency":
            pred = cm.price_result(c.sim, tier_graph=tier_graph)
            if best is None or pred.time < best_pred.time:
                best, best_pred = c, pred
        elif best is None or c.sim.time < best.sim.time:
            best = c
    stall = best.sim.detail.get("tt_choice", "stall") != "slow-access"
    return PlacementPlan(
        kind="training", policy=policy, fast_bytes=fast_bytes,
        rs=best.sim.detail.get("rs", 0.0), mi=best.mi, stall_on_case3=stall,
        steps_used=steps_used,
        tiers=list(tier_graph.tiers) if tier_graph is not None
        else tiers_from_hw(cm, fast_bytes),
        candidates=cands, sim=best.sim, objective=objective,
        cost_model=cm if objective == "latency" else None,
        predicted_step_times=list(best_pred.step_times)
        if best_pred else None,
        tier_graph=_graph_dict(tier_graph, cm, fast_bytes))


def mi_to_periods(profile, mi: int) -> int:
    """Convert a timeline-step MI to layer-scan block size (periods per block)
    for the offload engine.  Timeline steps map 1:1 to periods inside the
    forward/backward regions."""
    return max(1, min(mi, profile.num_periods))


# =========================================================== serving planner ==
# Decode-phase planning: the paper's Eq. 1/2 restated per *token* instead of
# per migration interval.  During decode the timeline unit is one token step,
# the reserve pool RS is the set of open (still-filling) KV blocks, and the
# prefetchable data per step is bounded by one token's compute time times the
# migration bandwidth:
#
#   space (Eq. 1 per-token):  hot_bytes = B * W * kv_tok < S - RS_serve
#   time  (Eq. 2 per-token):  t_token   > prefetch_bytes(L) / BW_mig
#
# where W is the per-slot hot window (tokens kept in fast memory) and L the
# look-ahead (token steps of prefetch lead).  Like the training planner, the
# candidates surviving both constraints are measured on the simulator and the
# sweet spot wins.


def slot_kv_weights(trace) -> List[float]:
    """Per-slot share of KV byte-seconds over the timeline: how much cache
    each slot's decode schedule actually keeps alive.  The per-slot analogue
    of the paper's per-object lifetime profile.

    Sharing-aware: blocks aliasing one physical allocation (equal
    ``shared_key``) contribute their byte-seconds once, split evenly across
    the sharers' slots — a tenant does not get a bigger hot window for
    holding a reference to the same system prompt everyone else holds."""
    w = [0.0] * max(1, trace.num_slots)
    group_size: dict = {}
    for o in trace.objects:
        k = getattr(o, "shared_key", None)
        if k is not None:
            group_size[k] = group_size.get(k, 0) + 1
    for o in trace.objects:
        k = getattr(o, "shared_key", None)
        share = group_size.get(k, 1) if k is not None else 1
        w[o.slot % len(w)] += o.bytes * (o.death - o.birth + 1) / share
    total = sum(w) or 1.0
    return [x / total for x in w]


def serve_token_stats(trace, hw: HWSpec) -> tuple:
    """(t_token, read_bytes): all-fast decode-step time and mean per-step KV
    read volume over the timeline — the serving analogue of interval_stats."""
    steps = max(1, trace.num_steps)
    read_bytes = sum(o.bytes * len(o.accesses) for o in trace.objects) / steps
    act = sum(trace.active.get(t, 0) for t in range(steps)) / steps
    flops = act * trace.flops_per_token
    bw_bytes = read_bytes + trace.weight_bytes + act * trace.num_layers \
        * trace.kv_token_bytes
    return max(flops / hw.peak_flops, bw_bytes / hw.fast_bw), read_bytes


def _tenant_knobs(wl, policy: str) -> dict:
    """Per-tenant simulation knobs for a tenanted workload: quotas turn on
    the violation accounting for any event-driven policy (quota-blind ones
    are *measured* against the same guarantees ``sentinel_slo`` enforces);
    the slack ordering only feeds the SLO policy."""
    from repro_torch.runtime.policies import PlacementPolicy
    quotas = getattr(wl, "tenant_quotas", None)
    cls = get_policy(policy)
    if not quotas or \
            cls.simulate.__func__ is not PlacementPolicy.simulate.__func__:
        return {}
    knobs = {"tenant_quotas": dict(sorted(quotas.items()))}
    slack = getattr(wl, "tenant_slack", None)
    if slack and policy == "sentinel_slo":
        knobs["tenant_slack"] = dict(sorted(slack.items()))
    return knobs


def validate_slot_devices(slot_devices, slots: int,
                          decode_devices: int) -> List[int]:
    """Check a slot->decode-shard mapping's geometry: one entry per batch
    slot, every entry a valid shard index.  Shared by ``plan_serving`` (at
    emission) and ``DisaggregatedEngine`` (at adoption), so a malformed
    placement is rejected identically at both ends."""
    sd = list(slot_devices)
    if len(sd) != slots:
        raise ValueError(f"slot_devices has {len(sd)} entries for "
                         f"{slots} batch slots")
    for s, d in enumerate(sd):
        if not isinstance(d, int) or isinstance(d, bool) \
                or not 0 <= d < decode_devices:
            raise ValueError(f"slot_devices[{s}] = {d!r}: expected a shard "
                             f"index in [0, {decode_devices})")
    return sd


def pack_slots(weights: Sequence[float], decode_devices: int,
               slot_tenants: Optional[Sequence[str]] = None) -> List[int]:
    """Tenant-aware LPT bin-packing of slots onto decode shards.

    Heaviest slot first (weight = planned hot-window bytes), each slot lands
    on the shard minimizing (same-tenant slots already there, load, index):
    load balance with an anti-affinity tie-break that spreads a tenant's
    slots across shards, so one device failure cannot take out a whole
    tenant.  Deterministic — equal keys resolve by slot then shard index."""
    load = [0.0] * decode_devices
    tenant_count = [dict() for _ in range(decode_devices)]
    out = [0] * len(weights)
    order = sorted(range(len(weights)), key=lambda s: (-weights[s], s))
    for s in order:
        tn = slot_tenants[s] if slot_tenants else None
        d = min(range(decode_devices),
                key=lambda i: (tenant_count[i].get(tn, 0) if tn is not None
                               else 0, load[i], i))
        out[s] = d
        load[d] += weights[s]
        if tn is not None:
            tenant_count[d][tn] = tenant_count[d].get(tn, 0) + 1
    return out


def _price_packing(cm: CostModel, graph, traffic, slot_devices, weights,
                   n_devices: int, kv_row: float,
                   flops_per_token: float) -> CostReport:
    """Price a slot->shard packing on the mesh graph: each shard's share of
    every step's reads/compute (proportional to the hot-window bytes it
    hosts) becomes its own HBM pipe, the prefill group's add-on runs as the
    prefill device's concurrent pipe, and the prefill->shard KV streams
    ride the dev<->dev edges — so a skewed packing surfaces as a slower
    slowest shard and the latency objective can reject it."""
    total = sum(weights) or 1.0
    frac = [sum(w for s, w in enumerate(weights)
                if slot_devices[s] == d) / total for d in range(n_devices)]
    prefill = f"dev{n_devices}"
    dev_series, edge_series = [], []
    for tr in traffic:
        per_dev = {}
        flows = {}
        # admitted-prefill tokens behind this step's KV stream: the flops
        # channel attributes them when the trace prices compute; the admit
        # byte channel (extra_fast = computed tokens x KV row) covers
        # flops-less traces
        if flops_per_token:
            ptok = tr.extra_flops / flops_per_token
        elif kv_row:
            ptok = tr.extra_fast / kv_row
        else:
            ptok = 0.0
        for d in range(n_devices):
            f = frac[d]
            per_dev[f"dev{d}"] = dataclasses.replace(
                tr, flops=tr.flops * f, fast_read=tr.fast_read * f,
                slow_read=tr.slow_read * f, demand_read=tr.demand_read * f,
                mig_in=tr.mig_in * f, mig_out=tr.mig_out * f,
                migs=tr.migs * f, extra_flops=0.0, extra_fast=0.0,
                prefill_flops=0.0, prefill_read=0.0)
            flow = ptok * kv_row * f
            if flow:
                flows[(prefill, f"dev{d}")] = flow
        # the prefill group's own pipe: prompt compute runs concurrently
        # with the shards, so the prefill add-on is one more max() arm
        # instead of serializing after the step
        per_dev[prefill] = dataclasses.replace(
            tr, flops=0.0, fast_read=0.0, slow_read=0.0, demand_read=0.0,
            mig_in=0.0, mig_out=0.0, migs=0.0, stall=0.0)
        dev_series.append(per_dev)
        edge_series.append(flows)
    return cm.price_on_graph(traffic, graph, edge_series,
                             device_traffic=dev_series)


def plan_serving(workload, cost_model=None, fast_bytes: float = None, *,
                 policy: Optional[str] = None,
                 lookaheads: Sequence[int] = (2, 4, 8, 16, 32),
                 objective: str = "bytes", tier_graph=None,
                 prefill_chunk_tokens: int = 0,
                 decode_devices: int = 1,
                 disagg: bool = False) -> PlacementPlan:
    """Pick the hot window and prefetch look-ahead for serving-time tiering.

    On a multi-tenant workload (one exposing ``tenants`` — see
    ``MultiTenantWorkload``) the default policy is ``sentinel_slo``, the
    per-slot hot windows are sized inside each tenant's guaranteed share,
    and the plan carries the per-tenant accounting
    (``slot_tenants`` / ``tenant_quotas`` / ``tenant_fast_bytes`` /
    ``tenant_violations``).

    ``objective="latency"`` selects by CostModel-predicted decode time and
    (when no explicit policy is forced and the workload is untenanted) also
    auditions ``alpha_migration`` against the default policy — every
    byte-objective candidate stays in the pool, so the latency winner is
    never priced slower than the bytes winner.  Tenanted workloads keep
    ``sentinel_slo`` (the SLO guarantees outrank raw predicted time).

    ``prefill_chunk_tokens > 0`` plans for the engine's *chunked* prefill:
    the prefill add-on is priced under the step's pipe maximum (chunks
    interleave with decode) instead of serializing after it, and the knob
    rides in the plan for ``ContinuousBatcher`` to adopt.

    ``disagg=True`` plans for the disaggregated engine and rejects knob
    combinations it cannot execute up front — chunked prefill interleaves
    prompt chunks with decode on ONE device, the opposite of prefill/decode
    disaggregation, so ``prefill_chunk_tokens > 0`` raises here instead of
    at ``DisaggregatedEngine.__init__``.  ``decode_devices=N`` (N > 1,
    implies ``disagg``) additionally places slots onto decode shards: the
    plan gains ``slot_devices`` (tenant-aware LPT packing by planned
    hot-window bytes — see ``pack_slots``), the serialized ``tier_graph``
    becomes the (N+1)-device mesh (dev0..dev{N-1} decode shards, devN the
    prefill group), and under the latency objective competing packings are
    priced per shard via ``CostModel.price_on_graph`` so a skewed packing
    loses to a balanced one."""
    cm = _resolve_cost_model(cost_model, "plan_serving")
    _check_objective(objective, "plan_serving")
    if decode_devices < 1:
        raise ValueError(f"plan_serving(decode_devices={decode_devices}): "
                         "need at least one decode device")
    disagg = disagg or decode_devices > 1
    if disagg and prefill_chunk_tokens:
        raise ValueError(
            "plan_serving(disagg=True) cannot plan chunked prefill "
            f"(prefill_chunk_tokens={prefill_chunk_tokens}): the "
            "disaggregated engine runs whole prompts on the prefill group "
            "and would reject the plan at DisaggregatedEngine.__init__")
    sim_hw, fast_bytes = _graph_fold(cm, tier_graph, fast_bytes)
    wl = as_workload(workload)
    trace = getattr(wl, "trace", None)
    if trace is None:                        # protocol workloads / timelines
        trace = wl.timeline().source
    if trace is None or not hasattr(trace, "num_slots"):
        raise TypeError("plan_serving needs a workload whose timeline "
                        "sources a ServeTrace (window sizing reads the slot "
                        "geometry)")
    tenants = getattr(wl, "tenants", None)
    forced_policy = policy is not None
    policy = policy or ("sentinel_slo" if tenants else "sentinel")
    knobs = _tenant_knobs(wl, policy)
    rs = trace.rs_bytes()
    budget = max(0.0, fast_bytes - rs)
    kv_tok_all = trace.num_layers * trace.kv_token_bytes
    slots = max(1, trace.num_slots)
    # floor: the open, still-filling block per slot is fast by construction
    # (it IS the reserve pool), so the hot window is never below one block
    hot_window = max(trace.block_tokens,
                     int(budget / (slots * kv_tok_all))) if kv_tok_all else 0
    t_token, _ = serve_token_stats(trace, sim_hw)
    cold_bytes = max(0.0, trace.peak_kv_bytes() - budget)
    # Eq. 1 per-token: the hot windows plus the reserve pool must fit (the
    # floor above can violate this when fast memory is tiny)
    space_ok = rs + slots * hot_window * kv_tok_all <= fast_bytes

    cands: List[ServeCandidate] = []
    for la in sorted(set(lookaheads)):
        # history blocks re-read every history_period steps: within a
        # look-ahead of L steps, L/period of the cold set must be prefetched,
        # against L steps' worth of migration bandwidth (Eq. 2 per-token)
        prefetch = cold_bytes * min(1.0, la / max(1, trace.history_period))
        cands.append(ServeCandidate(la, hot_window, prefetch, t_token,
                                    space_ok=space_ok,
                                    time_ok=t_token * la * sim_hw.mig_bw
                                    >= prefetch))
    # measure survivors on the simulator (fall back to everything when the
    # constraints kill all candidates, mirroring the training planner)
    pool = [c for c in cands if c.space_ok and c.time_ok] or cands
    best: Optional[ServeCandidate] = None
    best_pred: Optional[CostReport] = None
    win_policy, win_sim = policy, None
    for c in pool:
        c.sim = simulate(wl, sim_hw, fast_bytes, policy,
                         lookahead=c.lookahead, **knobs)
        if objective == "latency":
            pred = cm.price_result(c.sim, tier_graph=tier_graph,
                                   chunked_prefill=prefill_chunk_tokens > 0)
            if best is None or pred.time < best_pred.time:
                best, best_pred, win_sim = c, pred, c.sim
        elif best is None or \
                c.sim.decode_throughput > best.sim.decode_throughput:
            best = c
    if objective == "latency" and not forced_policy and not tenants:
        # audition alpha_migration over the same pool: it can only win under
        # the time-domain clock (it deliberately leaves cold-tail reads
        # slow), so the byte-domain sweep would never surface it
        for c in pool:
            alt = simulate(wl, sim_hw, fast_bytes, "alpha_migration",
                           lookahead=c.lookahead, **knobs)
            pred = cm.price_result(alt, tier_graph=tier_graph,
                                   chunked_prefill=prefill_chunk_tokens > 0)
            if pred.time < best_pred.time:
                best, best_pred = c, pred
                win_policy, win_sim = "alpha_migration", alt
    if win_sim is None:
        win_sim = best.sim

    # Eq. 1 refined per slot: distribute the hot-token budget in proportion
    # to each slot's own decode schedule (KV byte-seconds), floor one block
    # (its open block is the reserve pool), quantized to block==page units.
    blk = max(1, trace.block_tokens)
    budget_tokens = budget / kv_tok_all if kv_tok_all else 0.0
    weights = slot_kv_weights(trace)
    slot_tenants = getattr(wl, "slot_tenants", None)
    quotas = getattr(wl, "tenant_quotas", None)
    if tenants and slot_tenants and quotas:
        # quota-partitioned sizing: each tenant's guaranteed token share is
        # split over its own slots by their decode schedules, so one
        # tenant's long-context burst can never widen another's windows away
        tenant_w = {tn: sum(w for s, w in zip(slot_tenants, weights)
                            if s == tn) or 1.0 for tn in set(slot_tenants)}
        slot_windows = []
        for s, (tn, w) in enumerate(zip(slot_tenants, weights)):
            share = budget_tokens * quotas.get(tn, 0.0) * (w / tenant_w[tn])
            slot_windows.append(max(blk, (int(share) // blk) * blk))
    else:
        slot_windows = [max(blk, (int(budget_tokens * w) // blk) * blk)
                        for w in weights]

    # ---- slot -> decode-shard placement (decode_devices > 1) ----
    slot_devices = None
    graph_out = _graph_dict(tier_graph, cm, fast_bytes)
    if decode_devices > 1:
        from repro_torch.runtime.tiergraph import TierGraph
        mesh = TierGraph.mesh(decode_devices + 1, cm,
                              fast_bytes / decode_devices)
        pack_weights = [w * kv_tok_all for w in slot_windows]
        st = list(slot_tenants) if tenants and slot_tenants else None
        slot_devices = pack_slots(pack_weights, decode_devices, st)
        traffic = getattr(win_sim, "step_traffic", None)
        if objective == "latency" and traffic:
            # audition the balanced packing against a contiguous split —
            # the per-shard HBM pipes and prefill->shard streams make a
            # skewed packing visibly slower, which the byte clock cannot see
            contiguous = [min(decode_devices - 1,
                              s * decode_devices // len(pack_weights))
                          for s in range(len(pack_weights))]
            kv_row = trace.num_layers * trace.kv_token_bytes
            fpt = getattr(trace, "flops_per_token", 0.0)
            priced = sorted(
                (_price_packing(cm, mesh, traffic, p, pack_weights,
                                decode_devices, kv_row, fpt).time, i, p)
                for i, p in enumerate([slot_devices, contiguous]))
            slot_devices = priced[0][2]
        slot_devices = validate_slot_devices(slot_devices,
                                             len(slot_windows),
                                             decode_devices)
        if graph_out is None:
            graph_out = mesh.to_dict()

    return PlacementPlan(
        kind="serving", policy=win_policy, fast_bytes=fast_bytes, rs=rs,
        hot_window=best.hot_window, lookahead=best.lookahead,
        slot_hot_windows=slot_windows, page_tokens=blk,
        prefill_chunk_tokens=int(prefill_chunk_tokens),
        slot_devices=slot_devices,
        slot_tenants=list(slot_tenants) if tenants and slot_tenants else None,
        tenant_quotas=dict(sorted(quotas.items()))
        if tenants and quotas else None,
        tenant_fast_bytes=dict(win_sim.tenant_fast_bytes) or None
        if tenants else None,
        tenant_violations=dict(win_sim.tenant_violations)
        if tenants and win_sim.tenant_violations else None,
        tiers=list(tier_graph.tiers) if tier_graph is not None
        else tiers_from_hw(cm, fast_bytes),
        candidates=cands, sim=win_sim,
        objective=objective,
        cost_model=cm if objective == "latency" else None,
        predicted_step_times=list(best_pred.step_times)
        if best_pred else None,
        tier_graph=graph_out)


# ================================================================ entrypoint ==

def plan(workload, cost_model=None, fast_bytes: float = None, *,
         policy: Optional[str] = None, max_mi: Optional[int] = None,
         sim_all: bool = False,
         lookaheads: Sequence[int] = (2, 4, 8, 16, 32),
         objective: str = "bytes", tier_graph=None,
         prefill_chunk_tokens: int = 0,
         decode_devices: int = 1,
         disagg: bool = False) -> PlacementPlan:
    """THE entry point: profile -> plan for any workload.

    ``workload`` is a training ``TraceProfile``, a serving ``ServeTrace``, a
    ``MultiTenantWorkload``, or a ``Workload`` adapter.  ``cost_model`` is
    the machine — a ``CostModel``, or a legacy ``HWSpec`` upgraded in
    place.  ``policy`` names a registered
    placement policy (default: ``sentinel_mi`` for training, ``sentinel``
    for serving, ``sentinel_slo`` for multi-tenant serving); ``objective``
    is ``"bytes"`` (legacy clock, default) or ``"latency"`` (select by
    CostModel-predicted time); the remaining knobs apply to the matching
    planner half only.

    ``tier_graph`` plans against an arbitrary memory topology
    (``runtime.TierGraph``): the policies simulate on the graph's two-tier
    fold, pricing runs per edge, ``fast_bytes`` defaults to the compute
    node's capacity, and the plan serializes the graph when it is anything
    other than the canonical fast/slow pair (two-tier plans stay
    byte-identical to their goldens).
    """
    cm = _resolve_cost_model(cost_model, "plan")
    wl = as_workload(workload)
    with telemetry.span("plan.place"):
        if wl.kind == "training":
            return plan_training(wl, cm, fast_bytes,
                                 policy=policy or "sentinel_mi",
                                 max_mi=max_mi, sim_all=sim_all,
                                 objective=objective, tier_graph=tier_graph)
        return plan_serving(wl, cm, fast_bytes, policy=policy,
                            lookaheads=lookaheads, objective=objective,
                            tier_graph=tier_graph,
                            prefill_chunk_tokens=prefill_chunk_tokens,
                            decode_devices=decode_devices, disagg=disagg)
