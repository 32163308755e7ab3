"""The port's online loop and its engine under re-plans, against the
reference on the CPU.

Replays: ``replay_drift`` on the same synthetic drift workload, built by
each package's own ``runtime.synthetic``, at 20 % of its peak KV on the
reference's TPU_V5E_COST (crossed over by ``to_dict``), gives the same
report JSON on both packages in this interpreter (not the checked-in trace:
ROADMAP R6).  Cases, each under about 15 s a package here:
  * tenant_flip: ``synthetic_drift_tenant_flip()``, default arguments;
  * flash_crowd: ``synthetic_drift_flash_crowd(num_layers=2)``, where the
    replanner lends and reclaims slots (``maybe_lend``);
  * prompt_shift: ``synthetic_drift_prompt_shift(num_layers=2)``, where it
    re-plans on step-time drift.

The engine half mirrors the reference's tests/test_online_replan.py engine
cases on the port's ContinuousBatcher (``device="cpu"``, smollm-360m
reduced in fp32, parameters exported from the reference): a multi-tenant
plan made by each package's planner, a PlanDelta (window shrink) applied
before engine step 3 and a whole plan (shrink and tenancy swap) before step
6.  The port's plan bytes equal the reference's; its tokens equal the
reference engine's and its own all-hot run's; every integer counter equals
both packages' ``predict_pool_counters(plan_schedule=...)``.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as R
from repro.configs.base import get_config as ref_config
from repro.models import kvcache as ref_kvcache
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro.runtime import synthetic as R_syn
from repro.serve import engine as R_engine
from repro_torch import runtime as T
from repro_torch.configs import get_config
from repro_torch.runtime import synthetic as T_syn
from repro_torch.serve import engine as T_engine
from repro_torch.serve.engine import ContinuousBatcher
from repro_torch.weights import params_from_jax

REF = types.SimpleNamespace(rt=R, syn=R_syn, engine=R_engine,
                            cfg=ref_config, cost=R.TPU_V5E_COST)
PORT = types.SimpleNamespace(
    rt=T, syn=T_syn, engine=T_engine, cfg=get_config,
    cost=T.CostModel.from_dict(R.TPU_V5E_COST.to_dict()))

DRIFT = {
    "tenant_flip": lambda syn: syn.synthetic_drift_tenant_flip(),
    "flash_crowd": lambda syn: syn.synthetic_drift_flash_crowd(num_layers=2),
    "prompt_shift": lambda syn: syn.synthetic_drift_prompt_shift(
        num_layers=2),
}


@pytest.mark.parametrize("name", sorted(DRIFT))
def test_replay_drift_report_equals_the_reference(name):
    reps = []
    for ns in (REF, PORT):
        wl = DRIFT[name](ns.syn)
        reps.append(ns.rt.replay_drift(wl, ns.cost, 0.2 * wl.peak_kv_bytes()))
    ref, port = reps
    assert isinstance(port, T.OnlineReport)
    assert port.to_json() == ref.to_json()
    assert [e.applied for e in port.events if e.applied]
    if name == "flash_crowd":
        assert any(e.reason.startswith("lend:") for e in port.events)


# ------------------------------------------ engine: apply_plan agreement ---

MAX_SEQ, SLOTS = 32, 4
CHATTY = [(5, 5), (6, 4), (7, 5), (5, 4)]
BURSTY = [(12, 6), (11, 5), (10, 4)]
INT_COUNTERS = ("step_migration_bytes", "migration_bytes", "page_copies",
                "admit_page_writes", "tenant_hot_peak")


@pytest.fixture(scope="module")
def r1_patch():
    """The reference's tiered pools fail on this JAX (ROADMAP R1): its host
    memory kind cannot mix with device arrays in eager ops.  Patched for
    this module only, before any reference engine is built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_kvcache, "host_memory_kind", lambda: None)
        yield


def _plans(ns):
    """plan_a from the package's multi-tenant planner, then the reference
    test's schedule: a window-shrink delta before step 3 and a whole plan
    (shrink and tenancy swap) before step 6."""
    rt = ns.rt
    tenants = [rt.Tenant("chatty", fast_quota_frac=0.5, slo_slack=1.05),
               rt.Tenant("bursty", fast_quota_frac=0.5, slo_slack=2.0)]
    traces = [ns.engine.serve_trace_for(ns.cfg("smollm-360m"), rs, slots=2,
                                        layer_group=8)
              for rs in (CHATTY, BURSTY)]
    wl = rt.MultiTenantWorkload(tenants, traces)
    plan_a = rt.plan(wl, ns.cost, 0.2 * wl.trace.peak_kv_bytes())
    plan_a = dataclasses.replace(plan_a, hot_window=16,
                                 slot_hot_windows=[8, 8, 8, 8],
                                 page_tokens=4)
    plan_b = dataclasses.replace(plan_a, slot_hot_windows=[4, 8, 4, 8])
    delta_b = rt.plan_delta(plan_a, plan_b, step=3, reason="test:shrink")
    plan_c = dataclasses.replace(plan_b, slot_hot_windows=[4, 4, 4, 4],
                                 slot_tenants=["bursty", "bursty",
                                               "chatty", "chatty"])
    return plan_a, [(3, delta_b), (6, plan_c)]


def _drive(b, reqs, schedule=()):
    for t, d, tn in reqs:
        b.submit(t, d, tenant=tn)
    results, moved = [], []
    pending = sorted(schedule, key=lambda e: e[0])
    while b.queue or b._jobs or any(b.active):
        while pending and pending[0][0] <= len(b.step_migration_bytes):
            moved.append(b.apply_plan(pending.pop(0)[1]))
        if not b.step():
            break
        for i in range(b.B):
            if not b.active[i] and b.outputs[i]:
                results.append(tuple(int(x) for x in b.outputs[i]))
                b.outputs[i] = []
    return sorted(results), moved


@pytest.fixture(scope="module")
def replan_run(r1_patch):
    cfg_j = dataclasses.replace(ref_config("smollm-360m").reduced(),
                                use_paged_decode=True)
    params_j, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                     cfg_j))
    cfg_t = dataclasses.replace(get_config("smollm-360m").reduced(),
                                use_paged_decode=True)
    params_t = params_from_jax(cfg_t, jax.tree.map(np.asarray, params_j),
                               device="cpu")
    rng = np.random.default_rng(3)
    toks = [(rng.integers(0, cfg_t.vocab_size, p), d, tn)
            for tn, stream in (("chatty", CHATTY), ("bursty", BURSTY))
            for p, d in stream]
    (ref_a, ref_sched), (plan_a, sched) = _plans(REF), _plans(PORT)

    b_j = R_engine.ContinuousBatcher(params_j, cfg_j, SLOTS, MAX_SEQ,
                                     plan=ref_a, paged=True,
                                     slot_tenants=ref_a.slot_tenants)
    out_j, moved_j = _drive(b_j, [(jnp.asarray(t, jnp.int32), d, tn)
                                  for t, d, tn in toks], ref_sched)
    reqs_t = [(torch.from_numpy(t), d, tn) for t, d, tn in toks]
    b = ContinuousBatcher(params_t, cfg_t, SLOTS, MAX_SEQ, plan=plan_a,
                          paged=True, device="cpu")
    out, moved = _drive(b, reqs_t, sched)
    all_hot = dataclasses.replace(plan_a, slot_hot_windows=[MAX_SEQ] * SLOTS)
    out_h, _ = _drive(ContinuousBatcher(params_t, cfg_t, SLOTS, MAX_SEQ,
                                        plan=all_hot, paged=True,
                                        device="cpu"), reqs_t)
    lens = [(len(t), d, tn) for t, d, tn in toks]
    pred = {}
    for name, ns, p, s in (("ref", REF, ref_a, ref_sched),
                           ("port", PORT, plan_a, sched)):
        pred[name] = ns.engine.predict_pool_counters(
            lens, p, slots=SLOTS, max_seq=MAX_SEQ, page_tokens=b.page_tokens,
            row_bytes=b._row_bytes, plan_schedule=s)
    return dict(b=b, out=out, moved=moved, out_h=out_h, b_j=b_j, out_j=out_j,
                moved_j=moved_j, plan_a=plan_a, ref_a=ref_a, pred=pred)


def test_port_plan_a_bytes_equal_the_reference(replan_run):
    assert replan_run["plan_a"].to_json() == replan_run["ref_a"].to_json()


def test_replanned_tokens_equal_the_reference_and_the_all_hot_run(
        replan_run):
    """Re-planning only moves KV between tiers: the decoded tokens are the
    reference engine's and the port's all-hot run's (as multisets — the
    tenancy swap may reorder completions across slots)."""
    assert replan_run["out"] == replan_run["out_j"]
    assert replan_run["out"] == replan_run["out_h"]


def test_engine_counters_equal_both_replays(replan_run):
    b = replan_run["b"]
    got = {"step_migration_bytes": b.step_migration_bytes,
           "migration_bytes": b.sim_migration_bytes,
           "page_copies": b.pool.stats["page_copies"],
           "admit_page_writes": b.pool.stats["admit_page_writes"],
           "tenant_hot_peak": b.tenant_hot_peak}
    for name in ("ref", "port"):
        pred = replan_run["pred"][name]
        assert {k: pred[k] for k in INT_COUNTERS} == got, name
    assert sum(b.step_migration_bytes) == b.sim_migration_bytes
    c, c_j = b.counters(), replan_run["b_j"].counters()
    for k in ("sim_migration_bytes", "step_migration_bytes", "page_copies",
              "admit_page_writes", "tenant_hot_peak"):
        assert c[k] == c_j[k], k


def test_apply_plan_moves_bytes_and_stays_consistent(replan_run):
    """Both adoptions landed, the shrink delta demoted pages, the tenancy
    swap took effect, and the page table is green."""
    b, moved = replan_run["b"], replan_run["moved"]
    assert len(moved) == 2 and moved[0] > 0
    assert moved == replan_run["moved_j"]
    assert b.slot_tenants == ["bursty", "bursty", "chatty", "chatty"]
    b.ptable.check()


def test_apply_plan_validates_geometry(replan_run):
    b, plan_a = replan_run["b"], replan_run["plan_a"]
    with pytest.raises(ValueError, match="geometry mismatch"):
        b.apply_plan(dataclasses.replace(plan_a,
                                         slot_tenants=["chatty"] * 3))
    with pytest.raises(ValueError, match="re-paged in place"):
        b.apply_plan(dataclasses.replace(plan_a, page_tokens=3))
