"""The attention families on the serving engine, against the reference
engine, each on its ``.reduced()`` config in fp32 with the reference's
parameters and plans carried across:

  * the pools layout (``paged=True``, ``use_paged_decode``): the port's
    greedy tokens and integer counters equal the reference engine's for
    gemma2-2b, gemma3-12b, internlm2-1.8b and granite-moe-3b, with one-shot
    and chunked pool prefill, and for deepseek-v2-lite (MLA keeps its
    latent dense, so the pools admit it by one dense prefill and refuse a
    prefill chunk, as the reference does);
  * deepseek-v2-lite's concat and paged-merged layouts give the all-HBM
    layout's tokens in both packages, and the port's equal the reference's;
  * serve_trace_for and runtime.plan for each full config equal the
    reference's byte for byte.

The reference's tiered pools need the R1 patch (ROADMAP §3), applied for
this module only.  The reference engine's forwards run jitted here, one
compile per shape (``_jit_forward``): eager, its scan retraces and
recompiles the period body on every call, several seconds a forward for
gemma3's six-layer period."""
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
from repro.serve import engine as ref_engine
from repro_torch import runtime as T
from repro_torch.configs import get_config
from repro_torch.runtime.plan import PlacementPlan
from repro_torch.serve import engine
from repro_torch.weights import params_from_jax

POOL_ARCHS = ("gemma2-2b", "gemma3-12b", "internlm2-1.8b",
              "granite-moe-3b-a800m")
MLA_ARCH = "deepseek-v2-lite-16b"
MAX_SEQ, SLOTS, PAGE = 32, 2, 4
INT_COUNTERS = ("sim_migration_bytes", "step_migration_bytes", "page_copies",
                "admit_page_writes", "table_uploads", "repacks",
                "prefill_compute_tokens", "prefill_skipped_tokens",
                "table_version")


def _toks(seed, n):
    return np.random.default_rng(seed).integers(0, 512, n)


# three requests share a 9-token prompt prefix (two whole pages map onto
# the donor's), one does not; the windows make pages demote
_SYS = _toks(7, 9)
REQUESTS = [(np.concatenate([_SYS, _toks(11 + i, 3 + 2 * i)]), d, "sys")
            for i, d in enumerate((6, 4, 5))] + [(_toks(20, 15), 5, None)]
WINDOWS = [4, 8]


def _jit_forward(orig):
    """``orig`` (the reference's ``model.forward``) under ``jax.jit``, one
    compiled function per config, tree structure and non-array argument
    values (page size, the prefill flag, ...); arrays are traced."""
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


@pytest.fixture(scope="module")
def r1_patch():
    """The reference's tiered pools fail on this JAX (ROADMAP R1): its host
    memory kind cannot mix with device arrays in eager ops.  Patched for
    this module only, before any reference engine is built, with the
    reference's forward jitted."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_kvcache, "host_memory_kind", lambda: None)
        mp.setattr(ref_model, "forward", _jit_forward(ref_model.forward))
        yield


@pytest.fixture(scope="module")
def params():
    """Each arch's reduced config and parameters in both packages, built
    once."""
    out = {}
    for arch in POOL_ARCHS + (MLA_ARCH,):
        cfg_j, cfg_t = ref_config(arch).reduced(), get_config(arch).reduced()
        params_j, _ = split_params(ref_model.init_params(
            jax.random.PRNGKey(0), cfg_j))
        params_t = params_from_jax(cfg_t, jax.tree.map(np.asarray, params_j),
                                   device="cpu")
        out[arch] = (cfg_j, params_j, cfg_t, params_t)
    return out


def _plans(chunk):
    plan_j = R.PlacementPlan(hot_window=MAX_SEQ // 2,
                             slot_hot_windows=list(WINDOWS),
                             page_tokens=PAGE, prefill_chunk_tokens=chunk)
    return plan_j, PlacementPlan.from_dict(plan_j.to_dict())


def _run(b, reqs):
    results = []
    while b.queue or b._jobs or any(b.active):
        if not b.step():
            break
        for i in range(b.B):
            if not b.active[i] and b.outputs[i]:
                results.append(tuple(int(t) for t in b.outputs[i]))
                b.outputs[i] = []
    return sorted(results)


def _serve_both(params, arch, *, plan, paged, pools, chunk=None, keys=True):
    """The request stream through the reference engine and the port's on
    one layout: (reference engine, its outputs, port engine, its
    outputs)."""
    cfg_j, params_j, cfg_t, params_t = params[arch]
    plan_j, plan_t = plan if plan is not None else (None, None)
    b_j = ref_engine.ContinuousBatcher(
        params_j, dataclasses.replace(cfg_j, use_paged_decode=pools),
        SLOTS, MAX_SEQ, plan=plan_j, paged=paged,
        prefill_chunk_tokens=chunk)
    b_t = engine.ContinuousBatcher(
        params_t, dataclasses.replace(cfg_t, use_paged_decode=pools),
        SLOTS, MAX_SEQ, plan=plan_t, paged=paged,
        prefill_chunk_tokens=chunk, device="cpu")
    for toks, d, key in REQUESTS:
        key = key if keys else None
        b_j.submit(jnp.asarray(toks, jnp.int32), d, prefix_key=key)
        b_t.submit(torch.from_numpy(toks), d, prefix_key=key)
    out_j = sorted(tuple(int(t) for t in o) for o in b_j.run())
    return b_j, out_j, b_t, _run(b_t, REQUESTS)


POOL_CASES = [(arch, chunk) for arch in POOL_ARCHS for chunk in (0, 2 * PAGE)]


@pytest.fixture(scope="module")
def pools_runs(params, r1_patch):
    out = {}
    for arch, chunk in POOL_CASES + [(MLA_ARCH, 0)]:
        out[arch, chunk] = _serve_both(params, arch, plan=_plans(chunk),
                                       paged=True, pools=True)
    return out


@pytest.mark.parametrize("arch,chunk", POOL_CASES + [(MLA_ARCH, 0)])
def test_pools_tokens_and_counters_match_reference(pools_runs, arch, chunk):
    b_j, out_j, b_t, out_t = pools_runs[arch, chunk]
    assert out_t == out_j
    assert len(out_t) == len(REQUESTS)
    c_t, c_j = b_t.counters(), b_j.counters()
    for key in INT_COUNTERS:
        assert c_t[key] == c_j[key], key
    assert c_t["page_copies"] > 0
    # pool-direct prefill skips the shared pages' compute; a dense
    # admission computes them and maps the donor's pages
    assert (c_t["prefill_skipped_tokens"] > 0) == b_t._pool_prefill_ok
    b_t.ptable.check()


@pytest.mark.parametrize("arch,chunk", POOL_CASES + [(MLA_ARCH, 0)])
def test_pools_counters_match_prediction(pools_runs, arch, chunk):
    """The port's counters equal its own predict_pool_counters replay;
    deepseek's one-shot dense admission replays as the hybrid's does."""
    _, _, b_t, _ = pools_runs[arch, chunk]
    requests = [(tuple(int(t) for t in toks), d, None, key)
                for toks, d, key in REQUESTS]
    pred = engine.predict_pool_counters(
        requests, b_t.plan, slots=SLOTS, max_seq=MAX_SEQ,
        page_tokens=b_t.page_tokens, row_bytes=b_t._row_bytes,
        prefill_chunk_tokens=chunk, dense_admit=not b_t._pool_prefill_ok)
    c = b_t.counters()
    assert pred["migration_bytes"] == c["sim_migration_bytes"]
    assert pred["step_migration_bytes"] == c["step_migration_bytes"]
    assert pred["page_copies"] == c["page_copies"]
    assert pred["admit_page_writes"] == c["admit_page_writes"]


def test_pool_prefill_follows_the_stack(pools_runs):
    """Pure GQA stacks prefill straight into the pages, chunk by chunk;
    the all-MLA stack admits by one dense prefill."""
    for arch in POOL_ARCHS:
        assert pools_runs[arch, 0][2]._pool_prefill_ok
        steps = pools_runs[arch, 2 * PAGE][2].step_prefill_tokens
        assert max(steps) <= 2 * 2 * PAGE
    assert not pools_runs[MLA_ARCH, 0][2]._pool_prefill_ok


def test_mla_pools_refuse_a_prefill_chunk(params):
    """As the reference: a chunk needs pool-direct prefill, which an MLA
    stack's dense latent cannot take."""
    cfg_j, params_j, cfg_t, params_t = params[MLA_ARCH]
    plan_j, plan_t = _plans(2 * PAGE)
    msg = "pure-attention stack"
    with pytest.raises(ValueError, match=msg):
        ref_engine.ContinuousBatcher(
            params_j, dataclasses.replace(cfg_j, use_paged_decode=True),
            SLOTS, MAX_SEQ, plan=plan_j, paged=True)
    with pytest.raises(ValueError, match=msg):
        engine.ContinuousBatcher(
            params_t, dataclasses.replace(cfg_t, use_paged_decode=True),
            SLOTS, MAX_SEQ, plan=plan_t, paged=True, device="cpu")


MLA_LAYOUTS = {"all-HBM": (None, False), "concat": ("plan", False),
               "paged-merged": ("plan", True)}


@pytest.fixture(scope="module")
def mla_layouts(params, r1_patch):
    plan = _plans(0)
    return {name: _serve_both(params, MLA_ARCH,
                              plan=plan if p else None, paged=paged,
                              pools=False, keys=False)
            for name, (p, paged) in MLA_LAYOUTS.items()}


@pytest.mark.parametrize("layout", sorted(MLA_LAYOUTS))
def test_mla_layouts_match_all_hbm_in_both_packages(mla_layouts, layout):
    b_j, out_j, b_t, out_t = mla_layouts[layout]
    base = mla_layouts["all-HBM"]
    assert out_t == out_j == base[3] == base[1]
    assert b_t.sim_migration_bytes == b_j.sim_migration_bytes
    if layout != "all-HBM":
        assert b_t.sim_migration_bytes > 0


def test_mla_paged_merged_moves_fewer_bytes_than_concat(mla_layouts):
    """The latent tiers as KV does: per-slot boundaries move less than one
    global boundary."""
    paged = mla_layouts["paged-merged"][2].sim_migration_bytes
    concat = mla_layouts["concat"][2].sim_migration_bytes
    assert 0 < paged < concat
    cold = mla_layouts["concat"][2].tiered.cold
    assert all(set(k for k, v in layer.items() if v is not None)
               == {"ckv", "krope"} for layer in cold)


# -------------------------------------------------------- the planning half --

TRACE_REQS = [(300, 16, 0), (600, 16, None), (400, 16, 0)]
PORT_COST = T.CostModel.from_dict(R.TPU_V5E_COST.to_dict())


@pytest.mark.parametrize("arch", POOL_ARCHS + (MLA_ARCH, "musicgen-medium",
                                  "paligemma-3b"))
def test_serve_trace_and_plan_equal_the_reference(arch):
    """The full config's ServeTrace (KV bytes a token from its cache
    geometry, weights from its dense dimensions) and the latency plan at
    20 % of its peak KV, on the same cost model, serialised; the modality
    stubs' configs too."""
    kw = dict(slots=2, block_tokens=16, layer_group=8,
              shared_prefix_tokens=256)
    ns = {"ref": types.SimpleNamespace(engine=ref_engine, rt=R,
                                       cfg=ref_config(arch),
                                       cost=R.TPU_V5E_COST),
          "port": types.SimpleNamespace(engine=engine, rt=T,
                                        cfg=get_config(arch),
                                        cost=PORT_COST)}
    got = {}
    for side, n in ns.items():
        trace = n.engine.serve_trace_for(n.cfg, TRACE_REQS, **kw)
        plan = n.rt.plan(trace, n.cost, 0.2 * trace.peak_kv_bytes(),
                         objective="latency", prefill_chunk_tokens=256)
        got[side] = (dataclasses.asdict(trace), plan.to_json())
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]
