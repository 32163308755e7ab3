"""Multi-shard disaggregation of the port against the reference on the CPU.

The reference's two-shard scenario (tests/test_disagg_multidev.py) needs
four JAX host devices, forced by ``XLA_FLAGS`` before JAX is imported, so
it runs in a subprocess of its own that prints one JSON record.  Its
tiered pools need the R1 patch (ROADMAP R1), which the scenario script
applies before it builds an engine; it leaves out the reference's
tensor-parallel prefill, which the port does not have (ROADMAP item 11b).
The port runs the same scenario in this process with
``devices=[cpu] * 4`` (two decode shards and two prefill devices, all
aliases of the CPU): its group sizes, shard count, tokens, per-edge ledger,
per-shard hot peaks, migration series and ``mesh_table.check()`` must equal
the reference's record and both packages' ``predict_pool_counters``, and
its tokens the colocated all-hot run's.

The reference file's in-process cases (slot-device validation, the
planner's slot placement and its chunked-prefill refusal, ``price_disagg``'s
token recovery, its refusals and its multi-shard mesh, the packing replay
fuzz) run here on both packages, the machine crossed over from the
reference's TPU_V5E_COST (``CostModel.from_dict``) or its HWSpec fields.
"""
import dataclasses
import json
import os
import random
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch

from repro import runtime as R
from repro.configs.base import get_config as ref_config
from repro.core import hardware as R_hw
from repro.core import hmsim as R_hmsim
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro.serve import disagg as R_disagg
from repro.serve import engine as R_engine
from repro_torch import runtime as T
from repro_torch.configs import get_config
from repro_torch.core import hardware as T_hw
from repro_torch.core import hmsim as T_hmsim
from repro_torch.launch.mesh import disagg_groups
from repro_torch.serve import disagg as T_disagg
from repro_torch.serve import engine as T_engine
from repro_torch.weights import params_from_jax

REF = types.SimpleNamespace(rt=R, hmsim=R_hmsim, engine=R_engine,
                            disagg=R_disagg, cost=R.TPU_V5E_COST,
                            tpu=R_hw.TPU_V5E)
PORT = types.SimpleNamespace(
    rt=T, hmsim=T_hmsim, engine=T_engine, disagg=T_disagg,
    cost=T.CostModel.from_dict(R.TPU_V5E_COST.to_dict()),
    tpu=T_hw.HWSpec(**dataclasses.asdict(R_hw.TPU_V5E)))

MAX_SEQ, SLOTS, REPLAN_AT = 32, 4, 3

SCENARIO = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax
    import jax.numpy as jnp
    from repro import runtime
    from repro.configs.base import get_config
    from repro.core.hardware import TPU_V5E
    from repro.launch.mesh import disagg_groups
    from repro.models import kvcache, model
    from repro.models.layers import split_params
    from repro.serve import engine
    from repro.serve.disagg import DisaggregatedEngine
    from repro.serve.engine import predict_pool_counters, serve_trace_for

    # ROADMAP R1: this JAX's host memory kind cannot mix with device
    # arrays in eager ops; the pools fall back to device memory
    kvcache.host_memory_kind = lambda: None

    rec = {}
    devs = jax.devices()
    pre, dec = disagg_groups(devs)
    rec["groups"] = [len(pre), len(dec)]

    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              use_paged_decode=True)
    params, _ = split_params(model.init_params(jax.random.PRNGKey(0), cfg))
    max_seq, slots = 32, 4
    key = jax.random.PRNGKey(3)
    key, kp = jax.random.split(key)
    pref = [int(t) for t in jax.device_get(
        jax.random.randint(kp, (9,), 0, cfg.vocab_size))]
    reqs = []
    for plen, gen in [(12, 6), (13, 5), (11, 6), (12, 5), (14, 4), (12, 6)]:
        key, k = jax.random.split(key)
        tail = [int(t) for t in jax.device_get(
            jax.random.randint(k, (plen - 9,), 0, cfg.vocab_size))]
        reqs.append((tuple(pref + tail), gen, None, "sys"))
    rec["reqs"] = [[list(r[0]), r[1]] for r in reqs]
    trace = serve_trace_for(get_config("smollm-360m"),
                            [(len(r[0]), r[1]) for r in reqs],
                            slots=slots, layer_group=8)
    plan = runtime.plan(trace, TPU_V5E, 0.2 * trace.peak_kv_bytes())
    plan = dataclasses.replace(plan, hot_window=16, page_tokens=4,
                               slot_hot_windows=[8, 8, 8, 8],
                               slot_devices=[0, 0, 1, 1])
    plan2 = dataclasses.replace(plan, slot_hot_windows=[4, 8, 4, 8],
                                slot_devices=[1, 0, 1, 0])
    rec["plan"], rec["plan2"] = plan.to_json(), plan2.to_json()

    def drive(b, replan_at=None):
        for toks, gen, tn, pk in reqs:
            b.submit(jnp.asarray(toks, jnp.int32), gen,
                     prefix_key=pk, tenant=tn)
        outs, step = [], 0
        while b.queue or b._jobs or any(b.active):
            if step == replan_at:
                b.apply_plan(plan2)
            if not b.step():
                break
            step += 1
            for i in range(b.B):
                if not b.active[i] and b.outputs[i]:
                    outs.append([int(t) for t in b.outputs[i]])
                    b.outputs[i] = []
        return outs

    ref = engine.ContinuousBatcher(
        params, cfg, slots, max_seq, paged=True,
        plan=dataclasses.replace(plan, hot_window=max_seq,
                                 slot_hot_windows=None, slot_devices=None))
    rec["out_ref"] = drive(ref)
    b2 = DisaggregatedEngine(params, cfg, slots, max_seq, plan=plan,
                             devices=devs)
    rec["n_shards"] = b2.n_shards
    rec["out_2"] = drive(b2, replan_at=REPLAN_AT)
    b2.mesh_table.check()
    c = b2.counters()
    pred = predict_pool_counters(
        reqs, plan, slots=slots, max_seq=max_seq,
        page_tokens=b2.page_tokens, row_bytes=b2._row_bytes,
        dense_admit=True, plan_schedule=[(REPLAN_AT, plan2)])
    rec["repacks"] = c["repacks"]
    rec["edges_eng"] = {f"{s}->{d}": v
                        for (s, d), v in c["edge_migration_bytes"].items()}
    rec["edges_pred"] = {f"{s}->{d}": v for (s, d), v in
                         pred["edge_migration_bytes"].items()}
    rec["xdev_eng"] = b2.xdev_migration_bytes
    rec["dev_peak_eng"] = c["device_hot_peak"]
    rec["mig_eng"] = b2.sim_migration_bytes
    rec["series_eng"] = c["step_migration_bytes"]
    rec["host_internal"] = b2.mesh_table.host_internal_bytes
    print(json.dumps(rec))
""").replace("REPLAN_AT", str(REPLAN_AT))


def _edges(d):
    return {f"{s}->{t}": v for (s, t), v in d.items()}


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    out = subprocess.run([sys.executable, "-c", SCENARIO],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port(reference):
    cfg_j = dataclasses.replace(ref_config("smollm-360m").reduced(),
                                use_paged_decode=True)
    params_j, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                     cfg_j))
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              use_paged_decode=True)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, params_j),
                             device="cpu")
    reqs = [(tuple(t), g, None, "sys") for t, g in reference["reqs"]]
    trace = T_engine.serve_trace_for(get_config("smollm-360m"),
                                     [(len(r[0]), r[1]) for r in reqs],
                                     slots=SLOTS, layer_group=8)
    plan = T.plan(trace, PORT.tpu, 0.2 * trace.peak_kv_bytes())
    plan = dataclasses.replace(plan, hot_window=16, page_tokens=4,
                               slot_hot_windows=[8, 8, 8, 8],
                               slot_devices=[0, 0, 1, 1])
    plan2 = dataclasses.replace(plan, slot_hot_windows=[4, 8, 4, 8],
                                slot_devices=[1, 0, 1, 0])

    def drive(b, replan_at=None):
        for toks, gen, tn, pk in reqs:
            b.submit(torch.tensor(toks), gen, prefix_key=pk, tenant=tn)
        outs, step = [], 0
        while b.queue or b._jobs or any(b.active):
            if step == replan_at:
                b.apply_plan(plan2)
            if not b.step():
                break
            step += 1
            for i in range(b.B):
                if not b.active[i] and b.outputs[i]:
                    outs.append([int(t) for t in b.outputs[i]])
                    b.outputs[i] = []
        return outs

    all_hot = dataclasses.replace(plan, hot_window=MAX_SEQ,
                                  slot_hot_windows=None, slot_devices=None)
    out_ref = drive(T_engine.ContinuousBatcher(
        params, cfg, SLOTS, MAX_SEQ, paged=True, plan=all_hot, device="cpu"))
    devices = [torch.device("cpu")] * 4
    b2 = T_disagg.DisaggregatedEngine(params, cfg, SLOTS, MAX_SEQ, plan=plan,
                                      devices=devices)
    out_2 = drive(b2, replan_at=REPLAN_AT)
    common = dict(slots=SLOTS, max_seq=MAX_SEQ, page_tokens=b2.page_tokens,
                  row_bytes=b2._row_bytes, dense_admit=True)
    preds = [T_engine.predict_pool_counters(
                 reqs, plan, plan_schedule=[(REPLAN_AT, plan2)], **common),
             R_engine.predict_pool_counters(
                 reqs, R.PlacementPlan.from_json(reference["plan"]),
                 plan_schedule=[(REPLAN_AT, R.PlacementPlan.from_json(
                     reference["plan2"]))], **common)]
    return dict(b2=b2, out_2=out_2, out_ref=out_ref, plans=(plan, plan2),
                preds=preds, groups=[len(g) for g in disagg_groups(devices)],
                params=params, cfg=cfg)


def test_plans_equal_the_reference(reference, port):
    plan, plan2 = port["plans"]
    assert plan.to_json() == reference["plan"]
    assert plan2.to_json() == reference["plan2"]


def test_groups_split_two_two(reference, port):
    assert reference["groups"] == port["groups"] == [2, 2]
    assert reference["n_shards"] == port["b2"].n_shards == 2
    b = port["b2"]
    assert b.mesh_table.names == ["prefill", "dev0", "dev1"]
    assert len(b.pools) == 2 and b.pools[0] is b.pool
    # aliased shards share the module and hold pools of their own
    assert all(p is b.params for p in b.params_shards)
    assert b.pools[1].k_hot.data_ptr() != b.pools[0].k_hot.data_ptr()


def test_two_shards_tokens_equal_the_reference_and_the_colocated_run(
        reference, port):
    assert port["out_2"] == reference["out_2"]
    assert port["out_2"] == port["out_ref"]
    assert reference["out_2"] == reference["out_ref"]
    assert port["b2"].counters()["repacks"] == reference["repacks"] == 0


def test_edge_ledger_equals_the_reference_and_both_replays(reference, port):
    """Every (src, dst) edge -- shared-prefix admit streams and the
    apply_plan re-homings -- against the reference engine's record and
    both packages' predict_pool_counters."""
    b = port["b2"]
    b.mesh_table.check()
    edges = _edges(b.edge_migration_bytes)
    assert edges == reference["edges_eng"] == reference["edges_pred"]
    for pred in port["preds"]:
        assert edges == _edges(pred["edge_migration_bytes"])
        assert b.xdev_migration_bytes == pred["xdev_migration_bytes"]
    assert b.xdev_migration_bytes == reference["xdev_eng"]
    assert b.mesh_table.host_internal_bytes == reference["host_internal"]
    assert "dev0->dev1" in edges and "dev1->dev0" in edges


def test_replay_parity_across_shards(reference, port):
    b = port["b2"]
    c = b.counters()
    assert c["device_hot_peak"] == reference["dev_peak_eng"]
    assert b.sim_migration_bytes == reference["mig_eng"]
    assert c["step_migration_bytes"] == reference["series_eng"]
    for pred in port["preds"]:
        assert c["device_hot_peak"] == pred["device_hot_peak"]
        assert b.sim_migration_bytes == pred["migration_bytes"]
        assert c["step_migration_bytes"] == pred["step_migration_bytes"]
    assert sum(c["step_migration_bytes"]) == b.sim_migration_bytes
    # the shards' pool counters are summed
    assert c["admit_page_writes"] == sum(p.stats["admit_page_writes"]
                                         for p in b.pools) > 0


def test_tp_prefill_waits_for_the_sharding_rules(port):
    """Tensor-parallel prefill over two prefill devices raises, naming
    ROADMAP item 11b; with one prefill device it is ignored, as in the
    reference."""
    params, cfg = port["params"], port["cfg"]
    plan = port["plans"][0]
    with pytest.raises(NotImplementedError, match="item 11b"):
        T_disagg.DisaggregatedEngine(params, cfg, SLOTS, MAX_SEQ, plan=plan,
                                     devices=[torch.device("cpu")] * 4,
                                     tp_prefill=True)
    b = T_disagg.DisaggregatedEngine(
        params, cfg, SLOTS, MAX_SEQ, plan=plan,
        devices=[torch.device("cpu")] * 3, tp_prefill=True)
    assert b.n_shards == 2 and len(b.prefill_devices) == 1


# ---------------------------------------------------- in-process cases ----

def _both(fn):
    return fn(REF), fn(PORT)


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("sd, legal", [
    ([0, 1, 0], True), ([0, 1], False),         # wrong length
    ([0, 2, 0], False),                         # shard out of range
    ([0, True, 0], False)])                     # a bool is not a shard id
def test_validate_slot_devices_equals_the_reference(sd, legal):
    ref, port = _both(lambda ns: _outcome(
        lambda: ns.rt.validate_slot_devices(sd, 3, 2)))
    assert port == ref
    assert (port[0] == "ok") == legal


def test_plan_serving_disagg_rejects_chunked():
    def run(ns):
        trace = ns.hmsim.build_serve_trace([(16, 8), (20, 6)], num_slots=2,
                                           num_layers=4, kv_token_bytes=64)
        return _outcome(lambda: ns.rt.plan_serving(
            trace, ns.cost, 0.5 * trace.peak_kv_bytes(), disagg=True,
            prefill_chunk_tokens=8))
    ref, port = _both(run)
    assert port == ref and "chunked" in port[1]


def test_plan_serving_places_slots_on_shards():
    def run(ns):
        trace = ns.hmsim.build_serve_trace(
            [(48, 12), (64, 8), (40, 16), (56, 10)], num_slots=4,
            num_layers=4, kv_token_bytes=64)
        return ns.rt.plan_serving(trace, ns.cost,
                                  0.5 * trace.peak_kv_bytes(),
                                  decode_devices=2)
    ref, port = _both(run)
    assert port.to_json() == ref.to_json()
    assert len(port.slot_devices) == 4
    assert set(port.slot_devices) == {0, 1}


def _heavy_trace(ns, **kw):
    reqs = [(480, 24), (512, 16), (448, 32), (500, 20)]
    return ns.hmsim.build_serve_trace(reqs, num_slots=4, num_layers=8,
                                      kv_token_bytes=256, **kw)


def test_price_disagg_recovers_tokens_without_flops():
    def run(ns):
        trace = _heavy_trace(ns)
        fast = 0.25 * trace.peak_kv_bytes()
        attributed = ns.disagg.price_disagg(trace, ns.cost, fast)
        flopless = ns.disagg.price_disagg(
            dataclasses.replace(trace, flops_per_token=0.0), ns.cost, fast)
        return (attributed["edge_bytes"], flopless["edge_bytes"],
                dataclasses.asdict(attributed["disagg"]),
                dataclasses.asdict(flopless["disagg"]))
    ref, port = _both(run)
    assert port == ref
    assert port[0] > 0 and port[1] == port[0]


def test_price_disagg_raises_on_unattributable_stream():
    def run(ns):
        trace = ns.hmsim.build_serve_trace([(64, 8)], num_slots=1,
                                           num_layers=4, kv_token_bytes=64)
        dead = dataclasses.replace(trace, flops_per_token=0.0,
                                   kv_token_bytes=0)
        return _outcome(lambda: ns.disagg.price_disagg(dead, ns.cost, 1e6))
    ref, port = _both(run)
    assert port == ref and "cannot attribute" in port[1]


def test_price_disagg_multi_shard_mesh():
    def run(ns):
        trace = _heavy_trace(ns)
        fast = 0.25 * trace.peak_kv_bytes()
        r = ns.disagg.price_disagg(trace, ns.cost, fast, decode_devices=2)
        refused = _outcome(lambda: ns.disagg.price_disagg(
            trace, ns.cost, fast, decode_devices=0))
        return (r["graph"].to_dict(), dataclasses.asdict(r["disagg"]),
                dataclasses.asdict(r["colocated"]), r["edge_bytes"],
                refused)
    ref, port = _both(run)
    assert port == ref
    names = {n["name"] for n in port[0]["nodes"]}
    assert names == {"dev0", "dev1", "dev2", "host"}
    assert port[1]["tokens"] > 0 and port[4][0] == "ValueError"


def test_replay_edge_ledger_under_random_packings():
    """The reference's seeded packing sweep over the pure replay, on both
    packages: equal counters, and every admit stream on the slot's owning
    shard, summing to xdev_migration_bytes."""
    rng = random.Random(7)
    for _ in range(25):
        slots = rng.randint(2, 4)
        n_dev = rng.randint(1, 3)
        packing = [rng.randrange(n_dev) for _ in range(slots)]
        reqs = [(rng.randint(5, 14), rng.randint(3, 7))
                for _ in range(rng.randint(slots, slots + 3))]

        def run(ns):
            trace = ns.hmsim.build_serve_trace(reqs, num_slots=slots,
                                               num_layers=4,
                                               kv_token_bytes=64)
            plan = ns.rt.plan(trace, ns.tpu, 0.3 * trace.peak_kv_bytes())
            plan = dataclasses.replace(plan, page_tokens=4, hot_window=8,
                                       slot_hot_windows=None)
            return ns.engine.predict_pool_counters(
                reqs, plan, slots=slots, max_seq=32, page_tokens=4,
                row_bytes=64.0, dense_admit=True, slot_devices=packing)
        ref, pred = _both(run)
        assert pred == ref
        used = {f"dev{d}" for d in packing}
        for (src, dst), v in pred["edge_migration_bytes"].items():
            assert src == "prefill" and dst in used
            assert v >= 0 and v == int(v)
        assert sum(pred["edge_migration_bytes"].values()) == \
            pred["xdev_migration_bytes"]
        assert set(pred["device_hot_peak"]) <= used


def test_pack_slots_equals_the_reference():
    rng = random.Random(11)
    for _ in range(60):
        slots = rng.randint(1, 8)
        n_dev = rng.randint(1, 4)
        weights = [rng.uniform(0.0, 1e6) for _ in range(slots)]
        out = T.pack_slots(weights, n_dev)
        assert out == R.pack_slots(weights, n_dev)
        assert T.validate_slot_devices(out, slots, n_dev) == out
