"""Sentinel's unified runtime API: one profile -> plan -> migrate surface.

The repo implements the paper's idea for two workload families — training
(activation/weight offload over migration intervals) and serving (KV-cache
tiering over decode tokens).  This package is the single surface both dispatch
through:

    from repro_torch import runtime

    # any workload: a profiler TraceProfile or an hmsim ServeTrace
    plan   = runtime.plan(workload, cost_model, fast_bytes)  # PlacementPlan
    plan   = runtime.plan(workload, cost_model, fast_bytes,
                          objective="latency")   # select by predicted time
    result = runtime.simulate(workload, cost_model, fast_bytes, "sentinel")

    plan.to_json()                 # bit-stable round trip via from_json
    runtime.list_policies()        # every policy runs on every workload

The machine argument is a ``CostModel`` (``H100_COST``, an NVIDIA H100
measured by ``chip_smoke.py``, is the default instance); a legacy
``HWSpec`` passed in its place is upgraded via ``CostModel.from_hw`` and
behaves identically.

Layout:
  objects.py   MemoryTier / DataObject / AccessTimeline / Workload protocol
               (+ the TraceProfile / ServeTrace adapters)
  costmodel.py CostModel / StepTraffic / CostReport — the time-domain model
               pricing each policy's recorded per-step traffic
  tiergraph.py TierGraph / TierEdge / GraphHW — the memory system as a
               directed graph of tiers with per-edge bandwidths; every
               policy runs on any graph via the two-tier fold
               (``plan(..., tier_graph=)``, the fast/slow pair is the
               trivial instance)
  policies.py  the one policy registry and the PlacementResult they return
  plan.py      runtime.plan and the serializable PlacementPlan (+ PlanDelta
               incremental re-plans: apply == fresh plan, byte-for-byte)
  online.py    the continuous profile->re-plan loop: OnlineReplanner drift
               detection + hysteresis + elastic slot lending, and
               replay_drift's clairvoyant-regret differential
  synthetic.py deterministic synthetic workloads (golden tests, benchmarks,
               piecewise-stationary drift trio)

This is the API of ``repro.runtime`` (the port's own copy: the same names
and signatures, so the same call works on either package); the reference's
deprecation shims (``core.planner``, ``core.policies``,
``core.hmsim.simulate_*`` and the ``hw=`` keyword) are not carried over.
"""
from repro_torch.runtime.objects import (AccessTimeline, DataObject,
                                         MemoryTier, MultiTenantWorkload,
                                         ServingWorkload, Tenant,
                                         TrainingWorkload, Workload,
                                         as_workload, merge_tenant_traces,
                                         normalized_quotas, peak_object_bytes,
                                         tiers_from_hw)
from repro_torch.runtime.costmodel import (H100_COST, CostModel, CostReport,
                                           StepTraffic, as_cost_model)
from repro_torch.runtime.tiergraph import GraphHW, TierEdge, TierGraph
from repro_torch.runtime.plan import (Candidate, PlacementPlan, PlanDelta,
                                      ServeCandidate, enumerate_candidates,
                                      interval_stats, mi_to_periods,
                                      pack_slots, plan, plan_delta,
                                      plan_serving, plan_training,
                                      serve_token_stats, slot_kv_weights,
                                      validate_slot_devices)
from repro_torch.runtime.policies import (PAGE_BYTES, POLICIES,
                                          PlacementPolicy, PlacementResult,
                                          Unit, build_units, get_policy,
                                          list_policies, register_policy,
                                          simulate)
from repro_torch.runtime.online import (DriftSegment, DriftWorkload,
                                        OnlineReplanner, OnlineReport,
                                        ReplanEvent, SegmentReport, StepStat,
                                        WindowStats, drift_score,
                                        plan_churn_bytes, replay_drift)

__all__ = [
    "AccessTimeline", "Candidate", "CostModel", "CostReport", "DataObject",
    "DriftSegment", "DriftWorkload", "MemoryTier", "MultiTenantWorkload",
    "OnlineReplanner", "OnlineReport", "PAGE_BYTES", "POLICIES",
    "PlacementPlan", "PlacementPolicy", "PlacementResult", "PlanDelta",
    "GraphHW", "ReplanEvent", "SegmentReport", "ServeCandidate",
    "ServingWorkload", "StepStat", "StepTraffic", "H100_COST", "Tenant",
    "TierEdge", "TierGraph", "TrainingWorkload",
    "Unit", "WindowStats", "Workload", "as_cost_model", "as_workload",
    "build_units", "drift_score", "enumerate_candidates", "get_policy",
    "interval_stats", "list_policies", "merge_tenant_traces", "mi_to_periods",
    "normalized_quotas", "pack_slots", "peak_object_bytes", "plan",
    "plan_churn_bytes", "plan_delta", "plan_serving", "plan_training",
    "register_policy", "replay_drift", "serve_token_stats", "simulate",
    "slot_kv_weights", "tiers_from_hw", "validate_slot_devices",
]
