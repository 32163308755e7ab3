"""The port's prefill/decode disaggregation (repro_torch.serve.disagg, the
mesh page table, disagg_groups) against the reference on the CPU.

Mirrors the reference's tests/test_disagg.py:
  * ``MeshPageTable``'s unit cases, run on both packages' tables in
    lockstep: the same errors, tables, edge ledgers and host-internal
    bytes after every operation;
  * a differential version of tests/test_disagg_properties.py's
    Hypothesis op programs on both tables;
  * the engine pair (a colocated pools ContinuousBatcher and a
    one-shard DisaggregatedEngine, smollm-360m reduced in fp32, parameters
    exported from the reference's ``model.init_params``): the port's
    tokens equal the reference engine's and the port's own colocated
    run's, and its ledgers equal the reference engine's and both
    packages' ``predict_pool_counters``.  The reference's tiered pools
    need the R1 patch (ROADMAP R1), applied for this module only;
  * the refusals, ``disagg_groups``, and ``price_disagg`` against the
    reference's on its machine crossed over as
    ``CostModel.from_dict(TPU_V5E_COST.to_dict())``.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import runtime as R
from repro.configs.base import get_config as ref_config
from repro.models import kvcache as R_kv
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro.serve import disagg as R_disagg
from repro.serve import engine as R_engine
from repro_torch import runtime as T
from repro_torch.configs import get_config
from repro_torch.launch.mesh import disagg_groups
from repro_torch.models import kvcache as T_kv
from repro_torch.models import model as T_model
from repro_torch.serve import disagg as T_disagg
from repro_torch.serve import engine as T_engine
from repro_torch.weights import params_from_jax

DEVS, SLOTS, NP, PG = 3, 2, 4, 8
PAGE_BYTES = float(PG * 64)

REF = types.SimpleNamespace(kv=R_kv, rt=R, engine=R_engine, disagg=R_disagg,
                            cfg=ref_config, cost=R.TPU_V5E_COST)
PORT = types.SimpleNamespace(
    kv=T_kv, rt=T, engine=T_engine, disagg=T_disagg, cfg=get_config,
    cost=T.CostModel.from_dict(R.TPU_V5E_COST.to_dict()))


# ------------------------------------------------- the mesh page table ----

class Lockstep:
    """One MeshPageTable per package, driven by the same calls: each call's
    result (or error type and message) and the whole state after it must
    be equal on both."""

    def __init__(self, devs=DEVS, slots=SLOTS, np_=NP, pg=PG):
        self.m = [ns.kv.MeshPageTable(
            [ns.kv.PageTable(slots, np_, pg) for _ in range(devs)],
            page_bytes=PAGE_BYTES) for ns in (REF, PORT)]

    @property
    def port(self):
        return self.m[1]

    def __call__(self, name, *args):
        outs = []
        for m in self.m:
            try:
                outs.append(("ok", getattr(m, name)(*args)))
            except ValueError as e:
                outs.append(("ValueError", str(e)))
        assert outs[1] == outs[0], (name, args)
        assert state(self.m[1]) == state(self.m[0]), (name, args)
        if outs[1][0] != "ok":
            raise ValueError(outs[1][1])
        return outs[1][1]


def state(m):
    tables = [(t.table, t.tier, t.n_pages, t.hot_ref, t.cold_ref,
               sorted(t.hot_free), sorted(t.cold_free), t.cold_twin,
               t.version) for t in m.tables]
    return (tables, m.names, m.offsets, m.edge_bytes, m.host_internal_bytes,
            m.bytes_out, m.bytes_in, m.pages_in_use())


def test_global_namespace_unique():
    m = Lockstep()
    seen = set()
    for d in range(DEVS):
        for s in range(SLOTS):
            g = m("gslot", d, s)
            assert g not in seen
            seen.add(g)
            assert m("owner", g) == (d, s)
    assert seen == set(range(m.port.slots))
    with pytest.raises(ValueError):
        m("gslot", 0, SLOTS)
    with pytest.raises(ValueError):
        m("owner", m.port.slots)


def test_share_refused_across_devices():
    m = Lockstep()
    src = m("gslot", 0, 0)
    m("alloc", src, 0)
    with pytest.raises(ValueError):
        m("share", m("gslot", 1, 0), src, 1)
    m("share", m("gslot", 0, 1), src, 1)
    assert m("refcount", src, 0) == 2


def test_migrate_within_device_refused():
    m = Lockstep()
    g = m("gslot", 0, 0)
    m("alloc", g, 0)
    with pytest.raises(ValueError):
        m("migrate_slot", g, m("gslot", 0, 1))


def test_migrate_validates_before_mutating():
    """A refused migration leaves both tables and every ledger alone."""
    m = Lockstep()
    src = m("gslot", 0, 0)
    for _ in range(NP):
        m("alloc", src, 0)
    dst = m("gslot", 1, 0)
    m("alloc", dst, 0)                       # NP + 1 > pages_per_slot
    with pytest.raises(ValueError):
        m("migrate_slot", src, dst)
    assert m("n_pages", src) == NP and m("n_pages", dst) == 1
    assert m.port.edge_bytes == {} and m.port.host_internal_bytes == 0.0
    m("check")


def test_migrate_moves_shared_page_as_private_copy():
    m = Lockstep()
    src, sharer, dst = m("gslot", 0, 0), m("gslot", 0, 1), m("gslot", 1, 0)
    m("alloc", src, 0)
    m("share", sharer, src, 1)
    assert m("refcount", src, 0) == 2
    out = m("migrate_slot", src, dst)
    assert out == {"pages": 1, "hot_bytes": PAGE_BYTES, "cold_bytes": 0.0}
    assert m("refcount", sharer, 0) == 1
    assert m("refcount", dst, 0) == 1
    assert m.port.edge_bytes == {("dev0", "dev1"): PAGE_BYTES}
    m("check")


def test_cold_pages_rehome_inside_host_memory():
    m = Lockstep()
    src, dst = m("gslot", 0, 0), m("gslot", 1, 0)
    m("alloc", src, 0)
    m("alloc", src, 0)
    m("demote", src, 0)
    m("free_slot", src)
    m("alloc", src, 1)
    out = m("migrate_slot", src, dst)
    assert out["cold_bytes"] == PAGE_BYTES and out["hot_bytes"] == 0.0
    assert m.port.edge_bytes == {}
    assert m.port.host_internal_bytes == PAGE_BYTES
    m("check")


def test_mesh_table_refusals_equal_the_reference():
    for ns in (REF, PORT):
        with pytest.raises(ValueError, match="at least one"):
            ns.kv.MeshPageTable([])
        t = [ns.kv.PageTable(1, 2, 4), ns.kv.PageTable(1, 2, 4)]
        with pytest.raises(ValueError, match="names"):
            ns.kv.MeshPageTable(t, names=["a"])
        with pytest.raises(ValueError, match="duplicate"):
            ns.kv.MeshPageTable(t, names=["a", "a"])
        with pytest.raises(ValueError, match="page_tokens"):
            ns.kv.MeshPageTable([t[0], ns.kv.PageTable(1, 2, 8)])


def test_mesh_check_catches_a_broken_ledger():
    m = Lockstep().port
    m.bytes_out["dev0"] += 1.0
    with pytest.raises(AssertionError, match="departed"):
        m.check()


@st.composite
def mesh_ops(draw, max_ops=40):
    ops = []
    for _ in range(draw(st.integers(1, max_ops))):
        ops.append((draw(st.sampled_from(
            ["refill", "share", "write", "demote", "free", "migrate"])),
            draw(st.integers(0, DEVS * SLOTS - 1)),
            draw(st.integers(0, DEVS * SLOTS - 1)),
            draw(st.integers(0, NP - 1))))
    return ops


def _forget_written_twin(mesh, gslot: int, page_idx: int):
    """ROADMAP R11 applied to the reference's table before a write: where
    the page written is exclusive (written in place), the twin memo that
    holds it is dropped, as the port's ``cow`` drops it."""
    t, _, s = mesh._at(gslot)
    if t.is_shared(s, page_idx):
        return
    phys = t.table[s][page_idx]
    if t.tier[s][page_idx] == 0:
        twin = t.cold_twin.pop(phys, None)
        if twin is not None:
            t._twin_of.pop(twin, None)
    else:
        src = t._twin_of.pop(phys, None)
        if src is not None:
            t.cold_twin.pop(src, None)


@given(mesh_ops())
@settings(max_examples=40, deadline=None)
def test_mesh_page_table_programs_equal_the_reference(ops):
    """The reference property suite's legal op programs on both tables in
    lockstep: every result and the whole state equal after every op, the
    ledgers balanced and equal to the program's own account.  A write
    drops the memo of a twin it writes in place on the reference's table
    too (ROADMAP R11: the port drops it, the reference keeps it)."""
    m = Lockstep()
    p = m.port
    my_edges, my_host = {}, 0.0
    for op, a, b, i in ops:
        if op == "refill":
            m("free_slot", a)
            for _ in range(i + 1):
                t, _, _ = p._at(a)
                if not t.hot_free:
                    break
                m("alloc", a, 0)
        elif op == "share":
            if p.owner(a)[0] == p.owner(b)[0] and a != b \
                    and p.n_pages(a) == 0 and p.n_pages(b) > 0:
                m("share", a, b, min(i + 1, p.n_pages(b)))
        elif op == "write":
            if i < p.n_pages(a):
                _forget_written_twin(m.m[0], a, i)
                m("cow", a, i)
        elif op == "demote":
            t, _, s = p._at(a)
            if t.cold_pages(s) < t.n_pages[s] and t.cold_free:
                m("demote", a, t.cold_pages(s))
        elif op == "free":
            m("free_slot", a)
        elif op == "migrate":
            da, db = p.owner(a)[0], p.owner(b)[0]
            n, n_cold = p.n_pages(a), p.cold_pages(a)
            dt, _, ds = p._at(b)
            fits = (da != db and n > 0
                    and dt.n_pages[ds] + n <= dt.pages_per_slot
                    and not (n_cold and dt.n_pages[ds] > dt.cold_pages(ds))
                    and len(dt.hot_free) >= n - n_cold
                    and len(dt.cold_free) >= n_cold)
            if fits:
                out = m("migrate_slot", a, b)
                assert out["pages"] == n
                if n - n_cold:
                    key = (p.names[da], p.names[db])
                    my_edges[key] = my_edges.get(key, 0.0) \
                        + (n - n_cold) * PAGE_BYTES
                my_host += n_cold * PAGE_BYTES
        m("check")
        assert p.edge_bytes == my_edges
        assert p.host_internal_bytes == my_host
        for g in range(p.slots):
            assert p.gslot(*p.owner(g)) == g


# ------------------------------------------------------------ the engines ----

MAX_SEQ, B = 32, 2
REQUESTS = [(7, 6), (9, 5), (6, 7), (8, 6)]


@pytest.fixture(scope="module")
def r1_patch():
    """The reference's tiered pools fail on this JAX (ROADMAP R1): its host
    memory kind cannot mix with device arrays in eager ops.  Patched for
    this module only, before any reference engine is built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R_kv, "host_memory_kind", lambda: None)
        yield


def _plan(ns):
    trace = ns.engine.serve_trace_for(ns.cfg("smollm-360m"), REQUESTS,
                                      slots=B, layer_group=8)
    plan = ns.rt.plan(trace, ns.cost, 0.2 * trace.peak_kv_bytes())
    return dataclasses.replace(plan, hot_window=MAX_SEQ // 2,
                               slot_hot_windows=[4, 8], page_tokens=4)


def _drive(b, toks):
    for t, (_, d) in zip(toks, REQUESTS):
        b.submit(t, d)
    return b.run(), b


@pytest.fixture(scope="module")
def engines(r1_patch):
    cfg_j = dataclasses.replace(ref_config("smollm-360m").reduced(),
                                use_paged_decode=True)
    params_j, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                     cfg_j))
    cfg_t = dataclasses.replace(get_config("smollm-360m").reduced(),
                                use_paged_decode=True)
    params_t = params_from_jax(cfg_t, jax.tree.map(np.asarray, params_j),
                               device="cpu")
    rng = np.random.default_rng(3)
    toks = [rng.integers(0, cfg_t.vocab_size, p) for p, _ in REQUESTS]
    plan_j, plan_t = _plan(REF), _plan(PORT)
    ref_in = [jnp.asarray(t, jnp.int32) for t in toks]
    port_in = [torch.from_numpy(t) for t in toks]
    out = {
        "ref_c": _drive(R_engine.ContinuousBatcher(
            params_j, cfg_j, B, MAX_SEQ, plan=plan_j, paged=True), ref_in),
        "ref_d": _drive(R_disagg.DisaggregatedEngine(
            params_j, cfg_j, B, MAX_SEQ, plan=plan_j), ref_in),
        "port_c": _drive(T_engine.ContinuousBatcher(
            params_t, cfg_t, B, MAX_SEQ, plan=plan_t, paged=True,
            device="cpu"), port_in),
        "port_d": _drive(T_disagg.DisaggregatedEngine(
            params_t, cfg_t, B, MAX_SEQ, plan=plan_t, devices=["cpu"]),
            port_in)}
    out["plans"] = (plan_j, plan_t)
    out["params_t"], out["cfg_t"] = params_t, cfg_t
    return out


def test_plan_bytes_equal_the_reference(engines):
    plan_j, plan_t = engines["plans"]
    assert plan_t.to_json() == plan_j.to_json()


def test_disagg_tokens_equal_the_reference_and_the_colocated_run(engines):
    out = {k: [tuple(int(x) for x in o) for o in v[0]]
           for k, v in engines.items() if k.startswith(("ref_", "port_"))}
    assert out["port_d"] == out["ref_d"]
    assert out["port_d"] == out["port_c"]
    assert out["ref_d"] == out["ref_c"]
    assert len(out["port_d"]) == len(REQUESTS)


def test_disagg_one_shard_shape(engines):
    b = engines["port_d"][1]
    assert b.n_shards == 1 and b.slot_devices is None
    assert b.prefill_device == b.decode_device == torch.device("cpu")
    assert b.mesh_table.names == ["prefill", "decode"]
    assert b.counters()["repacks"] == 0
    # one shard shares the caller's module: nothing was copied or moved
    assert b.params is engines["params_t"]
    assert b.params_prefill is b.params


def test_disagg_ledger_equals_the_reference_and_both_replays(engines):
    b, b_j = engines["port_d"][1], engines["ref_d"][1]
    bc = engines["port_c"][1]
    preds = [ns.engine.predict_pool_counters(
        REQUESTS, p, slots=B, max_seq=MAX_SEQ, page_tokens=b.page_tokens,
        row_bytes=b._row_bytes) for ns, p in zip((REF, PORT),
                                                 engines["plans"])]
    c, c_j = b.counters(), b_j.counters()
    for k in ("xdev_migration_bytes", "edge_migration_bytes",
              "device_hot_peak", "sim_migration_bytes",
              "step_migration_bytes", "page_copies", "admit_page_writes",
              "table_version"):
        assert c[k] == c_j[k], k
    for pred in preds:
        assert b.xdev_migration_bytes == pred["xdev_migration_bytes"]
        assert b.edge_migration_bytes == pred["edge_migration_bytes"]
        assert b.device_hot_peak == pred["device_hot_peak"]
    assert b.xdev_migration_bytes > 0
    # the decode side's tiering is untouched by disaggregation
    assert b.sim_migration_bytes == bc.sim_migration_bytes
    b.mesh_table.check()


def test_disagg_refusals(engines):
    """As the reference: no plan, no pools layout, a chunked prefill; and
    multi-shard decode on a stack that is not pure attention."""
    params, cfg = engines["params_t"], engines["cfg_t"]
    plan = engines["plans"][1]
    E = T_disagg.DisaggregatedEngine
    with pytest.raises(ValueError, match="requires a plan"):
        E(params, cfg, B, MAX_SEQ, plan=None, devices=["cpu"])
    with pytest.raises(ValueError, match="persistent pools"):
        E(params, dataclasses.replace(cfg, use_paged_decode=False), B,
          MAX_SEQ, plan=plan, devices=["cpu"])
    with pytest.raises(ValueError, match="chunked prefill"):
        E(params, cfg, B, MAX_SEQ, devices=["cpu"],
          plan=dataclasses.replace(plan, prefill_chunk_tokens=8))
    with pytest.raises(ValueError, match="slot_devices"):
        E(params, cfg, B, MAX_SEQ, devices=["cpu"],
          plan=dataclasses.replace(plan, slot_devices=[0, 1]))
    hybrid = dataclasses.replace(get_config("zamba2-7b").reduced(),
                                 use_paged_decode=True)
    hp = T_model.init_params(hybrid, device="cpu")
    with pytest.raises(ValueError, match="pure-attention"):
        E(hp, hybrid, B, MAX_SEQ, plan=plan,
          devices=[torch.device("cpu")] * 4)


def test_disagg_requires_pools_layout_in_both_packages(engines):
    """The reference test's two refusals, on both packages."""
    plan_j, plan_t = engines["plans"]
    cfg_j = ref_config("smollm-360m").reduced()
    params_j, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                     cfg_j))
    cfg_t = get_config("smollm-360m").reduced()
    params_t = T_model.init_params(cfg_t, device="cpu")
    for p in (plan_j, None):
        with pytest.raises(ValueError):
            R_disagg.DisaggregatedEngine(params_j, cfg_j, B, MAX_SEQ, plan=p)
    for p in (plan_t, None):
        with pytest.raises(ValueError):
            T_disagg.DisaggregatedEngine(params_t, cfg_t, B, MAX_SEQ,
                                         plan=p, devices=["cpu"])


def test_disagg_groups_split():
    dev = [torch.device("cuda", i) for i in range(4)]
    p, d = disagg_groups(dev[:1])
    assert p == d == dev[:1]                  # degenerate single device
    p, d = disagg_groups(dev[:3])
    assert d == dev[:2] and p == dev[2:3]
    p, d = disagg_groups(dev)
    assert d == dev[:2] and p == dev[2:]
    # repeated entries alias: two shards and two prefill devices on one
    p, d = disagg_groups([torch.device("cpu")] * 4)
    assert p == d == [torch.device("cpu")] * 2
    assert disagg_groups(["cpu"]) == ([torch.device("cpu")],) * 2


def test_disagg_groups_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        disagg_groups()


def _heavy(ns):
    heavy = [(480, 24), (512, 16), (448, 32), (500, 20)]
    trace = ns.engine.serve_trace_for(ns.cfg("smollm-360m"), heavy, slots=4,
                                      layer_group=8)
    return ns.disagg.price_disagg(trace, ns.cost,
                                  0.2 * trace.peak_kv_bytes())


def test_price_disagg_equals_the_reference():
    """The prefill-heavy mix priced on the reference's machine: both
    reports, the edge bytes and the mesh equal the reference's, and
    disaggregation wins there, as the reference's gate says."""
    ref, port = _heavy(REF), _heavy(PORT)
    for k in ("colocated", "disagg"):
        assert dataclasses.asdict(port[k]) == dataclasses.asdict(ref[k])
    assert port["edge_bytes"] == ref["edge_bytes"] > 0
    assert port["graph"].to_dict() == ref["graph"].to_dict()
    assert set(port["graph"].names) == {"dev0", "dev1", "host"}
    assert port["disagg"].tokens_per_s >= port["colocated"].tokens_per_s


def test_price_disagg_on_the_h100():
    """On the card's machine: the colocated report is the trace simulated
    and priced at twice the decode memory, the graph is the two-device
    mesh at the decode memory, and the prefill->decode stream carries
    every prompt token's KV row once."""
    cm = T.H100_COST
    trace = T_engine.serve_trace_for(get_config("smollm-360m"),
                                     [(480, 24), (512, 16)], slots=2,
                                     layer_group=8)
    fast = 0.2 * trace.peak_kv_bytes()
    got = T_disagg.price_disagg(trace, cm, fast)
    colocated = cm.price(T.simulate(trace, cm, 2.0 * fast,
                                    "sentinel").step_traffic)
    assert dataclasses.asdict(got["colocated"]) == \
        dataclasses.asdict(colocated)
    assert got["graph"].to_dict() == T.TierGraph.mesh(2, cm, fast).to_dict()
    kv_row = trace.num_layers * trace.kv_token_bytes
    assert kv_row > 0
    assert got["edge_bytes"] == pytest.approx((480 + 512) * kv_row,
                                              rel=1e-12)
