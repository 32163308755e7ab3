"""The port's planning half (repro_torch.runtime, repro_torch.core and the
engine's serve_trace_for) against the reference (repro.runtime, repro.core,
repro.serve.engine) on the CPU.

Every case builds its inputs with each package's own functions from the
same arguments and compares serialized bytes (``to_json``) or whole
dataclass values.  The machine is the reference's TPU_V5E_COST crossed over
as ``CostModel.from_dict(TPU_V5E_COST.to_dict())``, or an HWSpec built from
the reference's fields: the port defines neither.  Nothing is compared with
the checked-in re-plan trace, whose last float digits miss on this
interpreter (ROADMAP R6); the golden plans are checked by round trip and
digest.
"""
import dataclasses
import importlib.util
import json
import math
import pathlib
import types

import numpy as np
import pytest
import torch

from repro import runtime as R
from repro.configs.base import get_config as ref_config
from repro.core import allocator as R_alloc
from repro.core import hardware as R_hw
from repro.runtime import synthetic as R_syn
from repro.serve import engine as R_engine
from repro_torch import runtime as T
from repro_torch.configs import get_config
from repro_torch.core import allocator as T_alloc
from repro_torch.core import hardware as T_hw
from repro_torch.runtime import synthetic as T_syn
from repro_torch.serve import engine as T_engine

GOLDEN = pathlib.Path(__file__).parent / "golden"

REF = types.SimpleNamespace(
    rt=R, syn=R_syn, cost=R.TPU_V5E_COST, tpu=R_hw.TPU_V5E,
    paper=R_hw.PAPER_HM)
PORT = types.SimpleNamespace(
    rt=T, syn=T_syn, cost=T.CostModel.from_dict(R.TPU_V5E_COST.to_dict()),
    tpu=T_hw.HWSpec(**dataclasses.asdict(R_hw.TPU_V5E)),
    paper=T_hw.PAPER_HM)


def _both(fn):
    """``fn`` run on the reference and on the port: (ref, port)."""
    return fn(REF), fn(PORT)


def test_machines_cross_over_exactly():
    assert dataclasses.asdict(PORT.cost) == dataclasses.asdict(REF.cost)
    assert dataclasses.asdict(T_hw.PAPER_HM) == \
        dataclasses.asdict(R_hw.PAPER_HM)


# ------------------------------------------------------------ golden plans --

@pytest.mark.parametrize("name", ["latency_plan.json",
                                  "multi_tenant_plan.json"])
def test_golden_plan_round_trip_and_digest(name):
    text = (GOLDEN / name).read_text().rstrip("\n")
    back = T.PlacementPlan.from_json(text)
    assert back.to_json() == text
    assert back.digest() == R.PlacementPlan.from_json(text).digest()
    assert isinstance(back.sim, T.PlacementResult)


# ----------------------------------------------------------------- planners --

def _serve_trace(ns):
    return ns.syn.synthetic_serve_trace()


PLAN_CASES = {
    "training": lambda ns: ns.rt.plan(
        ns.syn.synthetic_profile(), ns.paper,
        0.3 * ns.syn.synthetic_profile().peak_bytes()),
    "training_latency": lambda ns: ns.rt.plan(
        ns.syn.synthetic_profile(), ns.cost,
        0.3 * ns.syn.synthetic_profile().peak_bytes(), objective="latency"),
    "serving_hwspec": lambda ns: ns.rt.plan(
        _serve_trace(ns), ns.tpu, 0.2 * _serve_trace(ns).peak_kv_bytes()),
    "serving_latency": lambda ns: ns.rt.plan(
        _serve_trace(ns), ns.cost, 0.2 * _serve_trace(ns).peak_kv_bytes(),
        objective="latency"),
    "shared_prefix": lambda ns: ns.rt.plan(
        ns.syn.synthetic_shared_prefix_trace(), ns.cost,
        0.2 * ns.syn.synthetic_shared_prefix_trace(
            shared=False).peak_kv_bytes()),
    "multi_tenant": lambda ns: ns.rt.plan(
        ns.syn.synthetic_multi_tenant_trace(), ns.tpu,
        0.2 * ns.syn.synthetic_multi_tenant_trace().trace.peak_kv_bytes()),
    "prefill_chunk": lambda ns: ns.rt.plan(
        _serve_trace(ns), ns.cost, 0.2 * _serve_trace(ns).peak_kv_bytes(),
        objective="latency", prefill_chunk_tokens=64),
    "decode_devices_2": lambda ns: ns.rt.plan(
        _serve_trace(ns), ns.cost, 0.2 * _serve_trace(ns).peak_kv_bytes(),
        objective="latency", decode_devices=2),
    "tier_graph_mesh": lambda ns: ns.rt.plan(
        _serve_trace(ns), ns.cost, 0.2 * _serve_trace(ns).peak_kv_bytes(),
        tier_graph=ns.rt.TierGraph.mesh(
            2, ns.cost, 0.2 * _serve_trace(ns).peak_kv_bytes())),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_bytes_equal_the_reference(case):
    ref, port = _both(PLAN_CASES[case])
    assert isinstance(port, T.PlacementPlan)
    assert port.to_json() == ref.to_json()
    assert port.digest() == ref.digest()
    assert T.PlacementPlan.from_json(port.to_json()).to_json() == \
        port.to_json()


def test_latency_golden_plan_is_the_ports_fresh_plan():
    text = (GOLDEN / "latency_plan.json").read_text().rstrip("\n")
    assert PLAN_CASES["serving_latency"](PORT).to_json() == text


# ------------------------------------------------------------------- deltas --

@pytest.fixture(scope="module")
def delta_plans():
    def mk(ns):
        tr = _serve_trace(ns)
        a = ns.rt.plan(tr, ns.cost, 0.2 * tr.peak_kv_bytes(),
                       objective="latency")
        b = ns.rt.plan(tr, ns.cost, 0.1 * tr.peak_kv_bytes(),
                       objective="latency")
        return a, b, ns.rt.plan_delta(a, b, step=7, reason="test:shrink")
    return _both(mk)


def test_delta_equals_the_reference_and_applies_to_the_fresh_plan(
        delta_plans):
    (ra, rb, rd), (a, b, d) = delta_plans
    assert d is not None and "hot_window" in d.changes
    assert d.to_json() == rd.to_json()
    assert a.apply_delta(d).to_json() == b.to_json()
    assert T.plan_delta(a, a) is None


def test_delta_survives_json_and_refuses_a_wrong_base(delta_plans):
    _, (a, b, d) = delta_plans
    back = T.PlanDelta.from_json(d.to_json())
    assert back.to_json() == d.to_json()
    assert a.apply_delta(back).to_json() == b.to_json()
    with pytest.raises(ValueError, match="emission order"):
        b.apply_delta(d)


# ----------------------------------------------------------------- policies --

def _workload(ns, kind):
    if kind == "profile":
        prof = ns.syn.synthetic_profile()
        return prof, ns.paper, 0.2 * prof.peak_bytes()
    tr = _serve_trace(ns)
    return tr, ns.cost, 0.2 * tr.peak_kv_bytes()


def test_policy_registry_is_the_reference_registry():
    assert T.list_policies() == R.list_policies()


@pytest.mark.parametrize("kind", ["profile", "serve_trace"])
@pytest.mark.parametrize("policy", R.list_policies())
def test_simulate_equals_the_reference(policy, kind):
    """The whole PlacementResult: time, throughput, migrations, per-step
    traffic and the policy's detail."""
    def run(ns):
        wl, machine, fast = _workload(ns, kind)
        return ns.rt.simulate(wl, machine, fast, policy)
    ref, port = _both(run)
    assert isinstance(port, T.PlacementResult)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.throughput == ref.throughput
    assert port.migrations == ref.migrations


# ------------------------------------------------- cost model and tier graph --

@pytest.mark.parametrize("chunked", [False, True])
def test_cost_model_price_equals_the_reference(chunked):
    def run(ns):
        tr = _serve_trace(ns)
        res = ns.rt.simulate(tr, ns.cost, 0.2 * tr.peak_kv_bytes(),
                             "sentinel", lookahead=6)
        graph = ns.rt.TierGraph.mesh(2, ns.cost, 0.2 * tr.peak_kv_bytes())
        return (ns.cost.price(res.step_traffic, chunked_prefill=chunked),
                ns.cost.price_on_graph(res.step_traffic, graph,
                                       chunked_prefill=chunked),
                ns.cost.optimal_alpha())
    ref, port = _both(run)
    assert [dataclasses.asdict(r) for r in port[:2]] == [dataclasses.asdict(r) for r in ref[:2]]
    assert port[2] == ref[2]


def test_tier_graph_round_trip_equals_the_reference():
    def run(ns):
        g = ns.rt.TierGraph.mesh(3, ns.cost, 1e9, link_bw=40e9)
        two = ns.rt.TierGraph.two_tier(ns.cost, 1e9)
        view = g.hw_view(ns.cost)
        return (g.to_dict(), ns.rt.TierGraph.from_dict(g.to_dict()) == g,
                g.path_bw("dev2", "dev0"), two.to_dict(),
                two.matches_two_tier(ns.cost, 1e9),
                (view.compute, view.spill, view.fast_bw, view.slow_bw,
                 view.mig_bw, view.fast_bytes))
    ref, port = _both(run)
    assert port == ref
    assert port[1] is True


def test_allocator_equals_the_reference():
    def run(ns, alloc):
        prof = ns.syn.synthetic_profile()
        pages = {m: alloc.footprint(alloc.pack_pages(prof.objects, m)[0])
                 for m in ("original", "profiled", "sentinel")}
        return (pages, alloc.profiling_overhead(prof),
                alloc.false_sharing_stats(prof))
    assert run(PORT, T_alloc) == run(REF, R_alloc)


# -------------------------------------------------------------- serve trace --

def _chip_smoke_requests():
    """chip_smoke.py's twelve requests as its planned serve profiles them."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return [(len(t), cs.DECODE, k) for t, k in cs.requests(49152)]


SERVE_TRACE_CASES = {
    # four requests share a 256-token prefix; one KV object per 8 layers
    "chip_smoke": dict(reqs=_chip_smoke_requests(),
                       kw=dict(slots=8, block_tokens=16, layer_group=8,
                               shared_prefix_tokens=256)),
    "per_layer": dict(reqs=[(40, 6), (33, 9), (70, 4)],
                      kw=dict(slots=2, block_tokens=8, layer_group=1)),
}


@pytest.mark.parametrize("case", sorted(SERVE_TRACE_CASES))
@pytest.mark.parametrize("with_params", [False, True])
def test_serve_trace_for_equals_the_reference(case, with_params):
    """smollm-360m's ServeTrace, object for object.  With parameters, the
    port counts a torch module's elements and the reference a pytree's
    leaves of the same sizes."""
    c = SERVE_TRACE_CASES[case]
    shapes = [(960, 2560), (2560,), (49152, 96)]
    kw_t, kw_r = dict(c["kw"]), dict(c["kw"])
    if with_params:
        mod = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.zeros(s)) for s in shapes])
        kw_t["params"] = mod
        kw_r["params"] = {f"p{i}": np.zeros(s, np.float32)
                          for i, s in enumerate(shapes)}
    port = T_engine.serve_trace_for(get_config("smollm-360m"), c["reqs"],
                                    **kw_t)
    ref = R_engine.serve_trace_for(ref_config("smollm-360m"), c["reqs"],
                                   **kw_r)
    assert port.weight_bytes == ref.weight_bytes
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.peak_kv_bytes() == ref.peak_kv_bytes()


# ---------------------------------------------------------------- H100_COST --

def test_h100_cost_round_trips_and_is_the_default():
    cm = T.H100_COST
    d = cm.to_dict()
    json.dumps(d)
    assert d["host_internal_bw"] is None and math.isinf(cm.host_internal_bw)
    assert T.CostModel.from_dict(json.loads(json.dumps(d))) == cm
    assert T_hw.default_cost_model() is cm
    assert cm.name == T_hw.H100.name == "h100-sxm5-80gb"
    assert (cm.peak_flops, cm.fast_bw, cm.slow_bw, cm.mig_bw, cm.link_bw,
            cm.fast_bytes, cm.mig_overhead) == \
        (T_hw.H100.peak_flops, T_hw.H100.fast_bw, T_hw.H100.slow_bw,
         T_hw.H100.mig_bw, T_hw.H100.link_bw, T_hw.H100.fast_bytes,
         T_hw.H100.mig_overhead)


# ---------------------------------------------------- predict_pool_counters --

def _toks(seed, n):
    return tuple(int(t) for t in np.random.default_rng(seed).integers(
        0, 512, n))


_SYS = _toks(1, 9)
PREDICT_CASES = {
    # prefix sharing (token sequences and keys), chunked prefill, a delta
    # shrinking the windows mid-run
    "shared_prefix_chunked": dict(
        reqs=[(_SYS + _toks(10 + i, 3 + i), 6, None, "sys")
              for i in range(3)] + [(_toks(20, 13), 5)],
        plan=dict(hot_window=16, slot_hot_windows=[8, 12]),
        kw=dict(prefill_chunk_tokens=8),
        after=dict(slot_hot_windows=[4, 4]), at=4),
    # the one-shot dense admission's shared-page cap
    "dense_admit": dict(
        reqs=[(_SYS + _toks(30 + i, 2 + i), 5, None, "sys")
              for i in range(3)],
        plan=dict(hot_window=8, slot_hot_windows=[4, 8]),
        kw=dict(dense_admit=True), after=dict(slot_hot_windows=[4, 4]),
        at=3),
    # two tenants, then a tenancy swap
    "tenants": dict(
        reqs=[(7, 5, "chatty"), (12, 6, "bursty"), (6, 4, "chatty"),
              (11, 5, "bursty")],
        plan=dict(hot_window=8, slot_hot_windows=[4, 8],
                  slot_tenants=["chatty", "bursty"]),
        kw={}, after=dict(slot_tenants=["bursty", "chatty"]), at=3),
    # two decode shards, then the slots re-homed across them
    "two_shards": dict(
        reqs=[(9, 6), (14, 5), (5, 7), (11, 4), (8, 5)],
        plan=dict(hot_window=8, slot_hot_windows=[4, 8, 4, 8],
                  slot_devices=[0, 0, 1, 1]),
        kw={}, after=dict(slot_devices=[1, 0, 0, 1]), at=2),
}


@pytest.mark.parametrize("case", sorted(PREDICT_CASES))
def test_predict_pool_counters_equals_the_reference(case):
    """The engine/simulator contract's replay, under a PlanDelta schedule:
    every counter, the per-device peaks and edge ledgers included."""
    c = PREDICT_CASES[case]

    def run(ns, engine):
        a = ns.rt.PlacementPlan(page_tokens=4, **c["plan"])
        b = dataclasses.replace(a, **c["after"])
        delta = ns.rt.plan_delta(a, b, step=c["at"], reason="test")
        slots = len(a.slot_hot_windows)
        return engine.predict_pool_counters(
            c["reqs"], a, slots=slots, max_seq=32, page_tokens=4,
            row_bytes=96.0, plan_schedule=[(c["at"], delta)], **c["kw"])
    ref, port = run(REF, R_engine), run(PORT, T_engine)
    assert port == ref
    assert sum(port["step_migration_bytes"]) == port["migration_bytes"]
