"""Multi-shard disaggregation of the port against the reference on the CPU.

The reference's two-shard scenario (tests/test_disagg_multidev.py) needs
four JAX host devices, forced by ``XLA_FLAGS`` before JAX is imported, so
it runs in a subprocess of its own that prints one JSON record.  Its
tiered pools need the R1 patch (ROADMAP R1), which the scenario script
applies before it builds an engine.  The same subprocess runs the
reference's tensor-parallel prefill (its engine's and each reduced
family's over 2 and 4 devices) and compiles the dry run's serve cells, so
the port's TP prefill and its collective ledger are held to them.
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
import copy
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
# the reduced families the tensor-parallel prefill runs on, and the dry
# run's serve cells (arch, kind, (data, model) mesh, global batch) whose
# collectives the reference's compiled programs are held to
FAMILIES = ("smollm-360m", "gemma2-2b", "gemma3-12b", "internlm2-1.8b",
            "granite-moe-3b-a800m")
CELLS = [(a, k, (2, 2), 4) for a in FAMILIES for k in ("prefill", "decode")] \
    + [("smollm-360m", "prefill", (1, 4), 1)]
# the reduced smollm with 3/1 heads of 16: a 2- or 4-way split of its 48
# query and 16 KV columns cuts a head, as it cuts full-width smollm's 15/5
# heads of 64, so the TP prefill gathers q, k and v
CUT = "smollm-360m+cut"
CUT_HEADS = {"num_heads": 3, "num_kv_heads": 1}
TP_ARCHS = FAMILIES + (CUT,)

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
    TP_ARCHS = TP_ARCHS_LIST
    CUT_HEADS = CUT_HEADS_DICT
    CELLS = CELLS_LIST

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

    # tensor-parallel prefill over the prefill group, and what the
    # compiled programs' collectives move (dryrun.collective_bytes; its
    # module forces 512 host devices on import, which no longer applies
    # once the backend has started)
    import numpy as np
    from repro import sharding as shd
    from repro.configs.base import ShapeConfig
    from repro.launch import specs
    from repro.launch.dryrun import collective_bytes
    from repro.launch.mesh import make_rules

    def coll(c, txt):
        return collective_bytes(
            txt, loop_trips=float(c.num_periods + len(c.prologue)))["bytes"]

    b_tp = DisaggregatedEngine(params, cfg, slots, max_seq, plan=plan,
                               devices=devs, tp_prefill=True)
    rec["tp_on"] = bool(b_tp.tp_prefill)
    toks = jnp.asarray(reqs[0][0], jnp.int32)[None]
    rec["tp_last"] = np.asarray(
        b_tp._prefill(None, {"tokens": toks})[0]).tolist()
    rec["one_last"] = np.asarray(
        b2._prefill(None, {"tokens": toks})[0]).tolist()
    f = jax.jit(lambda p, b: model.prefill(p, cfg, b, max_seq=max_seq))
    with b_tp._prefill_mesh, shd.axis_rules(b_tp._prefill_rules):
        rec["tp_coll"] = coll(cfg, f.lower(b_tp.params_prefill,
                                           {"tokens": toks}).compile()
                              .as_text())
    rec["out_tp"] = drive(b_tp)
    rec["edges_tp"] = {f"{s}->{d}": v for (s, d), v in
                       b_tp.counters()["edge_migration_bytes"].items()}

    fam = {}
    for name in TP_ARCHS:
        arch, _, cut = name.partition("+")
        c = get_config(arch).reduced()
        if cut:
            c = dataclasses.replace(c, **CUT_HEADS)
        p, _ = split_params(model.init_params(jax.random.PRNGKey(0), c))
        t = jax.random.randint(jax.random.PRNGKey(5), (1, 12), 0,
                               c.vocab_size)
        f = jax.jit(lambda p, b, c=c: model.prefill(p, c, b, max_seq=32))
        sds, axes = specs.param_structs(c)
        for n in (2, 4):
            mesh = jax.sharding.Mesh(np.asarray(devs[:n]), ("model",))
            rules = shd.serve_rules(mesh)
            ptp = jax.device_put(p, specs.shardings_from_axes(axes, rules,
                                                              sds))
            with mesh, shd.axis_rules(rules):
                last, _ = f(ptp, {"tokens": t})
                txt = f.lower(ptp, {"tokens": t}).compile().as_text()
            fam[f"{name}/{n}"] = {"tokens": np.asarray(t).tolist(),
                                  "last": np.asarray(last).tolist(),
                                  "coll": coll(c, txt)}
    rec["families_tp"] = fam

    cells = {}
    for arch, kind, mesh_shape, batch in CELLS:
        c = get_config(arch).reduced()
        mesh = jax.sharding.Mesh(
            np.asarray(devs[:mesh_shape[0] * mesh_shape[1]])
            .reshape(mesh_shape), ("data", "model"))
        rules = make_rules(mesh, kind=kind)
        shape = ShapeConfig("tiny", 16, batch, kind)
        build = specs.build_prefill_cell if kind == "prefill" \
            else specs.build_decode_cell
        with mesh, shd.axis_rules(rules):
            fn, args, in_sh = build(c, shape, rules)
            txt = jax.jit(fn, in_shardings=in_sh).lower(*args).compile() \
                .as_text()
        cells[f"{arch}/{kind}/{mesh_shape}"] = coll(c, txt)
    rec["cells"] = cells
    print(json.dumps(rec))
""").replace("REPLAN_AT", str(REPLAN_AT)) \
    .replace("TP_ARCHS_LIST", repr(TP_ARCHS)) \
    .replace("CUT_HEADS_DICT", repr(CUT_HEADS)) \
    .replace("CELLS_LIST", repr(CELLS))


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
    b_tp = T_disagg.DisaggregatedEngine(params, cfg, SLOTS, MAX_SEQ,
                                        plan=plan, devices=devices,
                                        tp_prefill=True)
    toks = torch.tensor(reqs[0][0])[None]
    tp_last = b_tp._prefill(None, {"tokens": toks})[0]
    one_last = b2._prefill(None, {"tokens": toks})[0]
    tp_coll = copy.deepcopy(b_tp.collectives)
    out_tp = drive(b_tp)
    pred_tp = T_engine.predict_pool_counters(reqs, plan, **common)
    yield dict(b2=b2, out_2=out_2, out_ref=out_ref, plans=(plan, plan2),
                preds=preds, groups=[len(g) for g in disagg_groups(devices)],
                params=params, cfg=cfg, b_tp=b_tp, tp_last=tp_last,
                one_last=one_last, tp_coll=tp_coll, out_tp=out_tp,
                pred_tp=pred_tp)
    b_tp.close()


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
    """Tensor-parallel prefill runs under the sharding rules over two
    prefill devices (a ("model",) mesh under ``serve_rules``); with one
    prefill device it is ignored, as in the reference."""
    b = port["b_tp"]
    assert b.tp_prefill and len(b.prefill_devices) == 2
    assert b._tp.rules.mesh.shape == {"model": 2}
    assert b.counters()["collectives"]["bytes"]["all-reduce"] > 0
    params, cfg = port["params"], port["cfg"]
    one = T_disagg.DisaggregatedEngine(
        params, cfg, SLOTS, MAX_SEQ, plan=port["plans"][0],
        devices=[torch.device("cpu")] * 3, tp_prefill=True)
    assert one.n_shards == 2 and len(one.prefill_devices) == 1
    assert not one.tp_prefill
    assert one.counters()["collectives"] == \
        {"bytes": dict.fromkeys(one.collectives["bytes"], 0.0),
         "counts": dict.fromkeys(one.collectives["counts"], 0)}


def _nonzero(ledger_bytes):
    return {k: v for k, v in ledger_bytes.items() if v}


def test_tp_prefill_equals_the_reference_and_one_device(reference, port):
    """The 12-token prompt's last-row logits from the port's TP prefill
    over two ranks against the reference's TP prefill and the port's
    one-device prefill (1e-4), and its collectives against the
    reference's compiled program: 15,360 B of all-reduce (5 executions of
    a (1, 12, 64) f32 tensor: the embedding and each layer's two row-split
    products), nothing else."""
    tp, one = port["tp_last"], port["one_last"]
    ref_tp = torch.tensor(reference["tp_last"])
    assert reference["tp_on"]
    torch.testing.assert_close(tp, ref_tp, atol=1e-4, rtol=0)
    torch.testing.assert_close(tp, one, atol=1e-4, rtol=0)
    # the reference's docstring says "~1e-6"; on this prompt its drift
    # measured 2.15e-6 and 2.26e-6 on two CPU hosts (ROADMAP R12)
    drift = float((ref_tp - torch.tensor(reference["one_last"])).abs().max())
    assert 0 < drift < 1e-5
    assert _nonzero(reference["tp_coll"]) == {"all-reduce": 15360.0}
    assert _nonzero(port["tp_coll"]["bytes"]) == {"all-reduce": 15360.0}
    assert port["tp_coll"]["counts"]["all-reduce"] == 5


def test_tp_engine_tokens_and_ledger_equal_the_reference(reference, port):
    """With ``tp_prefill=True`` the engine's greedy tokens are the
    reference's (its ``tp_tokens_equal``: the colocated all-hot run's) and
    its per-edge ledger is the reference's and the replay's, exactly."""
    assert port["out_tp"] == reference["out_tp"] == reference["out_ref"]
    b = port["b_tp"]
    b.mesh_table.check()
    edges = _edges(b.edge_migration_bytes)
    assert edges == reference["edges_tp"] == \
        _edges(port["pred_tp"]["edge_migration_bytes"])
    assert b.collectives["counts"]["all-reduce"] > 5


# XLA's own resharding, pinned (ROADMAP R12): at 4 ranks the reduced
# configs' 32 KV columns split into 8, half a 16-wide head; the port
# gathers k and v (2 layers a period x (k + v) x (1, 12, 32) f32), XLA
# reshards with all-gather, all-to-all and collective-permute, and on
# gemma3 adds 576 B to its all-reduce.  Where the split cuts CUT's query
# heads, at 2 and 4 ranks, the port gathers q, k and v ((1, 12, 48 + 16 +
# 16) f32 a layer) and XLA reshards too, its all-reduce 24,576 B to the
# port's 15,360 (at full width it runs the port's program: ROADMAP R12)
XLA_OWN = {
    ("smollm-360m", 4): {"all-gather": 8192.0, "all-to-all": 1536.0,
                         "collective-permute": 768.0},
    ("internlm2-1.8b", 4): {"all-gather": 8192.0, "all-to-all": 1536.0,
                            "collective-permute": 768.0},
    ("granite-moe-3b-a800m", 4): {"all-gather": 8192.0, "all-to-all": 1536.0,
                                  "collective-permute": 768.0},
    ("gemma2-2b", 4): {"all-gather": 16384.0, "all-to-all": 3072.0,
                       "collective-permute": 1536.0},
    ("gemma3-12b", 4): {"all-gather": 49152.0, "all-to-all": 9216.0,
                        "collective-permute": 4608.0,
                        "all-reduce": 77376.0},
    (CUT, 2): {"all-gather": 9216.0, "all-to-all": 6144.0,
               "collective-permute": 3072.0, "all-reduce": 24576.0},
    (CUT, 4): {"all-gather": 9216.0, "all-to-all": 3072.0,
               "collective-permute": 3840.0, "all-reduce": 24576.0},
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", TP_ARCHS)
def test_family_tp_prefill_equals_the_reference(reference, name, n):
    """Each reduced family's TP prefill of a 12-token prompt on ``[cpu] *
    n`` against the reference's over n forced devices (1e-4), and the
    ledger against the reference's ``collective_bytes``: equal type for
    type at 2 ranks; at 4, the all-reduce bytes equal where XLA does not
    reshard them and both sides pinned where it does.  ``CUT``'s heads
    are cut at both counts: its q, k and v are gathered."""
    rec = reference["families_tp"][f"{name}/{n}"]
    arch, _, cut = name.partition("+")
    cfg_j = ref_config(arch).reduced()
    cfg = get_config(arch).reduced()
    if cut:
        cfg_j = dataclasses.replace(cfg_j, **CUT_HEADS)
        cfg = dataclasses.replace(cfg, **CUT_HEADS)
    params_j, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                     cfg_j))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, params_j),
                             device="cpu")
    tp = T_disagg.TensorParallelPrefill(params, cfg,
                                        [torch.device("cpu")] * n, 32)
    last, _ = tp({"tokens": torch.tensor(rec["tokens"])})
    tp.close()
    torch.testing.assert_close(last, torch.tensor(rec["last"]), atol=1e-4,
                               rtol=0)
    port = _nonzero(tp.ledger["bytes"])
    ref = _nonzero(rec["coll"])
    layers = cfg.num_layers
    row = 12 * cfg.d_model * 4
    assert port["all-reduce"] == (2 * layers + 1) * row
    pinned = XLA_OWN.get((name, n))
    if pinned is None:
        assert port == ref
        return
    # the port gathers q, k and v where the split cuts a query head, else
    # k and v: (1, 12, their columns) f32 a layer
    heads = cfg.num_heads + 2 * cfg.num_kv_heads if cut \
        else 2 * cfg.num_kv_heads
    assert port == {"all-reduce": (2 * layers + 1) * row,
                    "all-gather": layers * 12 * heads * cfg.head_dim * 4}
    assert ref == {"all-reduce": port["all-reduce"], **pinned}


# the reference gathers granite's MoE tokens over the data axis (a
# dispatch group spans the global batch); the port's rank keeps its own
# batch's groups
XLA_OWN_CELLS = {
    "granite-moe-3b-a800m/prefill/(2, 2)": {"all-gather": 169984.0},
    "granite-moe-3b-a800m/decode/(2, 2)": {"all-gather": 2944.0},
    "smollm-360m/prefill/(1, 4)": {"all-gather": 4096.0,
                                   "all-to-all": 2048.0,
                                   "collective-permute": 1024.0},
}


@pytest.mark.parametrize("arch,kind,mesh_shape,batch", CELLS)
def test_dryrun_cell_collectives_equal_the_reference(reference, arch, kind,
                                                     mesh_shape, batch):
    """The dry run's serve cells on a (data, model) mesh under
    ``make_rules``, reduced fp32, S 16: the port's ``collectives`` of mesh
    position (0, 0) against the reference's ``collective_bytes`` of the
    compiled cell, type for type (40,960 B and 2,560 B on the 2 x 2
    mesh for smollm-360m and internlm2-1.8b); XLA's own resharding
    pinned beside the port's."""
    from repro_torch import sharding as shd
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_rules
    key = f"{arch}/{kind}/{mesh_shape}"
    ref = _nonzero(reference["cells"][key])
    cfg = get_config(arch).reduced()
    rules = make_rules(shd.Mesh(mesh_shape, ("data", "model")), kind=kind)
    build = specs.build_prefill_cell if kind == "prefill" \
        else specs.build_decode_cell
    fn, args, in_sh = build(cfg, ShapeConfig("tiny", 16, batch, kind), rules)
    port = _nonzero(dryrun.rank_collectives(fn, args, in_sh, rules)["bytes"])
    rows = (batch // mesh_shape[0]) * (16 if kind == "prefill" else 1)
    reduce = (2 * cfg.num_layers + 1) * rows * cfg.d_model * 4
    assert port["all-reduce"] == ref["all-reduce"] == reduce
    if mesh_shape == (2, 2) and arch in ("smollm-360m", "internlm2-1.8b"):
        assert port == {"all-reduce": 40960.0 if kind == "prefill"
                        else 2560.0}
    pinned = XLA_OWN_CELLS.get(key)
    if pinned is None:
        assert port == ref
        return
    assert ref == {"all-reduce": reduce, **pinned}
    # the port gathers the reduced smollm's k and v at 4 ranks, as in its
    # TP prefill
    assert port == ({"all-reduce": reduce, "all-gather": 8192.0}
                    if mesh_shape == (1, 4) else {"all-reduce": reduce})


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
