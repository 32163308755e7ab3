"""The disaggregated engine on the attention families (gemma2-2b,
gemma3-12b, internlm2-1.8b, granite-moe-3b, deepseek-v2-lite), each on its
``.reduced()`` config in fp32 with the reference's parameters carried
across, against the reference's ``DisaggregatedEngine`` on the same plan:

  * one shard, all five (deepseek's MLA latent admitted by one dense
    prefill, as on the colocated pools): the port's tokens, per-edge
    ledger, per-shard hot peaks and integer counters equal the reference
    engine's in this process, and the port's ledger equals its own
    ``predict_pool_counters(dense_admit=True)``;
  * two shards, the four GQA families: the reference's scenario runs for
    every family once in a subprocess of four forced JAX devices that
    prints one JSON record (as ``tests/test_torch_disagg_multidev.py``
    does), with a re-plan that re-homes two live slots; the port runs it
    with ``devices=[cpu] * 4`` and must give the same tokens, ledgers,
    migration series, host-internal bytes and hot peaks, and its ledger
    its own replay's;
  * deepseek-v2-lite at two shards is refused by both packages, with the
    same error and message.

The reference's tiered pools need the R1 patch (ROADMAP R1), applied for
this module only and in the subprocess's script; the reference's forwards
run jitted there and here (one compile per shape), as in
``tests/test_torch_families_serve.py``."""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import textwrap

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
from repro.serve import disagg as ref_disagg
from repro_torch.configs import get_config
from repro_torch.runtime.plan import PlacementPlan
from repro_torch.serve import disagg, engine
from repro_torch.weights import params_from_jax

GQA_ARCHS = ("gemma2-2b", "gemma3-12b", "internlm2-1.8b",
             "granite-moe-3b-a800m")
MLA_ARCH = "deepseek-v2-lite-16b"
ARCHS = GQA_ARCHS + (MLA_ARCH,)
MAX_SEQ, PAGE, REPLAN_AT = 32, 4, 3
INT_COUNTERS = ("sim_migration_bytes", "step_migration_bytes", "page_copies",
                "admit_page_writes", "table_uploads", "repacks",
                "prefill_compute_tokens", "prefill_skipped_tokens",
                "table_version", "xdev_migration_bytes")


def _toks(seed, n):
    return np.random.default_rng(seed).integers(0, 512, n)


# three requests share a 9-token prompt prefix, one does not
_SYS = _toks(7, 9)
REQUESTS = [(np.concatenate([_SYS, _toks(11 + i, 3 + 2 * i)]), d, "sys")
            for i, d in enumerate((6, 4, 5))] + [(_toks(20, 15), 5, None)]

# one shard: 2 slots; two shards: 4 slots, two a shard, then a re-plan
# that moves slots 0 and 3 to the other shard
PLAN_1 = R.PlacementPlan(hot_window=MAX_SEQ // 2, slot_hot_windows=[4, 8],
                         page_tokens=PAGE)
PLAN_2 = R.PlacementPlan(hot_window=MAX_SEQ // 2,
                         slot_hot_windows=[8, 8, 8, 8], page_tokens=PAGE,
                         slot_devices=[0, 0, 1, 1])
REPLAN_2 = dataclasses.replace(PLAN_2, slot_hot_windows=[4, 8, 4, 8],
                               slot_devices=[1, 0, 1, 0])

def _jit_forward(orig):
    """orig under jax.jit, one compiled function per config, tree structure
    and non-array argument values; arrays are traced (the reference's
    forward retraces its period scan on every eager call)."""
    compiled = {}

    def forward(params, cfg, batch, **kw):
        leaves, tree = jax.tree.flatten((params, batch, kw))
        is_arr = tuple(isinstance(l, (jax.Array, np.ndarray)) for l in leaves)
        key = (tree, cfg, is_arr,
               tuple(None if a else l for a, l in zip(is_arr, leaves)))
        fn = compiled.get(key)
        if fn is None:
            def run(arrays, leaves=leaves):
                it = iter(arrays)
                p, b, k = jax.tree.unflatten(
                    tree, [next(it) if a else l
                           for a, l in zip(is_arr, leaves)])
                return orig(p, cfg, b, **k)
            fn = compiled[key] = jax.jit(run)
        return fn([l for a, l in zip(is_arr, leaves) if a])
    return forward


SCENARIO = textwrap.dedent('''
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro import runtime
    from repro.configs.base import get_config
    from repro.models import kvcache, model
    from repro.models.layers import split_params
    from repro.serve.disagg import DisaggregatedEngine
    ''') + inspect.getsource(_jit_forward) + textwrap.dedent('''
    # ROADMAP R1: this JAX's host memory kind cannot mix with device
    # arrays in eager ops; the pools fall back to device memory
    kvcache.host_memory_kind = lambda: None
    model.forward = _jit_forward(model.forward)
    assert len(jax.devices()) == 4

    spec = json.loads(SPEC)
    plan = runtime.PlacementPlan.from_json(spec["plan"])
    plan2 = runtime.PlacementPlan.from_json(spec["plan2"])
    rec = {}
    for arch in spec["archs"]:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  use_paged_decode=True)
        params, _ = split_params(model.init_params(jax.random.PRNGKey(0),
                                                   cfg))
        try:
            b = DisaggregatedEngine(params, cfg, 4, spec["max_seq"],
                                    plan=plan, devices=jax.devices())
        except ValueError as e:
            rec[arch] = {"refused": ["ValueError", str(e)]}
            continue
        for toks, gen, key in spec["reqs"]:
            b.submit(jnp.asarray(toks, jnp.int32), gen, prefix_key=key)
        outs, step = [], 0
        while b.queue or b._jobs or any(b.active):
            if step == spec["replan_at"]:
                b.apply_plan(plan2)
            if not b.step():
                break
            step += 1
            for i in range(b.B):
                if not b.active[i] and b.outputs[i]:
                    outs.append([int(t) for t in b.outputs[i]])
                    b.outputs[i] = []
        b.mesh_table.check()
        c = b.counters()
        rec[arch] = {
            "n_shards": b.n_shards, "outs": sorted(outs),
            "edges": {f"{s}->{d}": v for (s, d), v in
                      c["edge_migration_bytes"].items()},
            "xdev": b.xdev_migration_bytes,
            "dev_peak": c["device_hot_peak"],
            "mig": b.sim_migration_bytes,
            "series": c["step_migration_bytes"],
            "host_internal": b.mesh_table.host_internal_bytes,
            "repacks": c["repacks"]}
    print(json.dumps(rec))
''')


def _reqs_json():
    return [[[int(t) for t in toks], d, key] for toks, d, key in REQUESTS]


@pytest.fixture(scope="module")
def reference_two_shards():
    """The subprocess, started first so it runs beside this module's own
    engine runs; its record is read on first use."""
    spec = json.dumps({"archs": list(ARCHS), "reqs": _reqs_json(),
                       "plan": PLAN_2.to_json(), "plan2": REPLAN_2.to_json(),
                       "max_seq": MAX_SEQ, "replan_at": REPLAN_AT})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", SCENARIO.replace("SPEC", repr(spec))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    record = {}

    def get():
        if not record:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            record.update(json.loads(out.strip().splitlines()[-1]))
        return record
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def r1_patch(reference_two_shards):
    """ROADMAP R1 for the reference engine in this process, with its
    forward jitted; the subprocess is started before it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_kvcache, "host_memory_kind", lambda: None)
        mp.setattr(ref_model, "forward", _jit_forward(ref_model.forward))
        yield


@pytest.fixture(scope="module")
def params():
    out = {}
    for arch in ARCHS:
        cfg_j = dataclasses.replace(ref_config(arch).reduced(),
                                    use_paged_decode=True)
        cfg_t = dataclasses.replace(get_config(arch).reduced(),
                                    use_paged_decode=True)
        params_j, _ = split_params(ref_model.init_params(
            jax.random.PRNGKey(0), cfg_j))
        params_t = params_from_jax(cfg_t, jax.tree.map(np.asarray, params_j),
                                   device="cpu")
        out[arch] = (cfg_j, params_j, cfg_t, params_t)
    return out


def _drive(b, submit, plan2=None):
    """Submit the requests, run to the end (adopting ``plan2`` before step
    REPLAN_AT when given) and return the sorted outputs."""
    for toks, d, key in REQUESTS:
        submit(b, toks, d, key)
    outs, step = [], 0
    while b.queue or b._jobs or any(b.active):
        if plan2 is not None and step == REPLAN_AT:
            b.apply_plan(plan2)
        if not b.step():
            break
        step += 1
        for i in range(b.B):
            if not b.active[i] and b.outputs[i]:
                outs.append([int(t) for t in b.outputs[i]])
                b.outputs[i] = []
    return sorted(outs)


def _submit_port(b, toks, d, key):
    b.submit(torch.from_numpy(toks), d, prefix_key=key)


def _submit_ref(b, toks, d, key):
    b.submit(jnp.asarray(toks, jnp.int32), d, prefix_key=key)


def _prediction(b, plan, schedule=None):
    requests = [(tuple(int(t) for t in toks), d, None, key)
                for toks, d, key in REQUESTS]
    return engine.predict_pool_counters(
        requests, plan, slots=b.B, max_seq=MAX_SEQ,
        page_tokens=b.page_tokens, row_bytes=b._row_bytes, dense_admit=True,
        plan_schedule=schedule or [])


@pytest.mark.parametrize("arch", ARCHS)
def test_one_shard_matches_reference(params, r1_patch, arch):
    """Tokens, ledgers and counters of the one-shard engine equal the
    reference engine's on the same plan and its own replay's."""
    cfg_j, params_j, cfg_t, params_t = params[arch]
    b_j = ref_disagg.DisaggregatedEngine(params_j, cfg_j, 2, MAX_SEQ,
                                         plan=PLAN_1)
    plan_t = PlacementPlan.from_dict(PLAN_1.to_dict())
    b_t = disagg.DisaggregatedEngine(params_t, cfg_t, 2, MAX_SEQ,
                                     plan=plan_t, devices=["cpu"])
    assert b_t.n_shards == b_j.n_shards == 1
    out_j = _drive(b_j, _submit_ref)
    out_t = _drive(b_t, _submit_port)
    assert out_t == out_j and len(out_t) == len(REQUESTS)
    c_t, c_j = b_t.counters(), b_j.counters()
    for key in INT_COUNTERS:
        assert c_t[key] == c_j[key], key
    assert c_t["edge_migration_bytes"] == c_j["edge_migration_bytes"]
    assert c_t["device_hot_peak"] == c_j["device_hot_peak"]
    assert c_t["xdev_migration_bytes"] > 0 and c_t["page_copies"] > 0
    pred = _prediction(b_t, plan_t)
    assert c_t["edge_migration_bytes"] == pred["edge_migration_bytes"]
    assert c_t["xdev_migration_bytes"] == pred["xdev_migration_bytes"]
    assert c_t["sim_migration_bytes"] == pred["migration_bytes"]
    b_t.mesh_table.check()


@pytest.mark.parametrize("arch", GQA_ARCHS)
def test_two_shards_match_reference(params, reference_two_shards, arch):
    """Two aliased shards with a re-homing re-plan: the reference's
    tokens, per-edge ledger, migration series, host-internal bytes and
    hot peaks, and the port's own replay's ledger."""
    want = reference_two_shards()[arch]
    _, _, cfg_t, params_t = params[arch]
    plan = PlacementPlan.from_dict(PLAN_2.to_dict())
    plan2 = PlacementPlan.from_dict(REPLAN_2.to_dict())
    b = disagg.DisaggregatedEngine(params_t, cfg_t, 4, MAX_SEQ, plan=plan,
                                   devices=[torch.device("cpu")] * 4)
    assert b.n_shards == want["n_shards"] == 2
    out = _drive(b, _submit_port, plan2)
    b.mesh_table.check()
    c = b.counters()
    assert out == want["outs"] and len(out) == len(REQUESTS)
    edges = {f"{s}->{d}": v for (s, d), v in
             c["edge_migration_bytes"].items()}
    assert edges == want["edges"]
    assert "dev0->dev1" in edges and "dev1->dev0" in edges
    assert b.xdev_migration_bytes == want["xdev"]
    assert c["device_hot_peak"] == want["dev_peak"]
    assert b.sim_migration_bytes == want["mig"]
    assert c["step_migration_bytes"] == want["series"]
    assert b.mesh_table.host_internal_bytes == want["host_internal"]
    assert c["repacks"] == want["repacks"] == 0
    pred = _prediction(b, plan, [(REPLAN_AT, plan2)])
    assert {f"{s}->{d}": v for (s, d), v in
            pred["edge_migration_bytes"].items()} == edges
    assert pred["device_hot_peak"] == c["device_hot_peak"]


def test_mla_refused_at_two_shards_as_the_reference(params,
                                                    reference_two_shards):
    """deepseek-v2-lite's latent is not paged: both packages refuse it at
    two shards with the same error and message, and serve it at one."""
    want = reference_two_shards()[MLA_ARCH]["refused"]
    _, _, cfg_t, params_t = params[MLA_ARCH]
    plan = PlacementPlan.from_dict(PLAN_2.to_dict())
    with pytest.raises(ValueError) as e:
        disagg.DisaggregatedEngine(params_t, cfg_t, 4, MAX_SEQ, plan=plan,
                                   devices=[torch.device("cpu")] * 4)
    assert ["ValueError", str(e.value)] == want
    assert "pure-attention stack" in want[1]
