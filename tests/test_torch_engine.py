"""The port's paged-pool ContinuousBatcher against the reference engine on
smollm-360m.reduced() in fp32, with the reference's parameters and plan
carried across (params_from_jax, PlacementPlan.to_dict):

  * greedy tokens identical, and at every compared forward the logits agree
    within TOL while the top-1/top-2 margin of every row whose argmax is
    used exceeds 10 x TOL (so the exact-token claim across frameworks is
    honest);
  * every integer counter equal to the reference engine's and to what the
    reference's predict_pool_counters replays;
  * the port's tiered run gives the tokens of its all-hot run.

Cases: shared-prefix admission forking at a page edge and mid-page, chunked
prefill, small hot windows so pages demote during prefill and decode, and
slots partitioned between two tenants.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime
from repro.configs.base import get_config as ref_config
from repro.core.hardware import TPU_V5E
from repro.models import kvcache as ref_kvcache
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.models import model
from repro_torch.serve.engine import ContinuousBatcher
from repro_torch.runtime.plan import PlacementPlan
from repro_torch.weights import params_from_jax

MAX_SEQ, SLOTS, PAGE = 32, 2, 4
TOL = 1e-4
INT_COUNTERS = ("sim_migration_bytes", "step_migration_bytes", "page_copies",
                "admit_page_writes", "table_uploads", "repacks",
                "prefill_compute_tokens", "prefill_skipped_tokens")


def _toks(seed, n):
    return np.random.default_rng(seed).integers(0, 512, n)


def _shared(prefix_len):
    sys_p = _toks(7, prefix_len)
    return dict(reqs=[(np.concatenate([sys_p, _toks(11 + i, 2 + i)]), 5,
                       "sys", None) for i in range(3)],
                windows=(16, 16), chunk=0)


CASES = {
    "shared_page_edge": _shared(2 * PAGE),
    "shared_mid_page": _shared(2 * PAGE + 1),
    "chunked": dict(reqs=[(_toks(3, 5), 14, None, None),
                          (_toks(4, 18), 4, None, None),
                          (_toks(5, 15), 4, None, None)],
                    windows=(16, 16), chunk=2 * PAGE),
    "demotions": dict(reqs=[(_toks(20 + i, p), d, None, None) for i, (p, d)
                            in enumerate([(5, 9), (17, 4), (14, 5), (9, 6)])],
                      windows=(4, 8), chunk=PAGE),
    # one slot per tenant: admission follows tenancy, peaks per tenant
    "tenants": dict(reqs=[(_toks(30 + i, p), d, None, tn) for i, (p, d, tn)
                          in enumerate([(5, 5, "chatty"), (12, 6, "bursty"),
                                        (6, 4, "chatty"), (11, 5, "bursty"),
                                        (7, 5, "chatty")])],
                    windows=(4, 8), chunk=0, tenants=["chatty", "bursty"]),
}


@pytest.fixture(scope="module")
def r1_patch():
    """The reference's tiered pools fail on this JAX (ROADMAP R1): its host
    memory kind cannot mix with device arrays in eager ops.  Patched for
    this module only, before any reference engine is built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_kvcache, "host_memory_kind", lambda: None)
        yield


@pytest.fixture(scope="module")
def setup(r1_patch):
    cfg_j = dataclasses.replace(ref_config("smollm-360m").reduced(),
                                use_paged_decode=True)
    params_j, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                     cfg_j))
    cfg_t = dataclasses.replace(get_config("smollm-360m").reduced(),
                                use_paged_decode=True)
    params_t = params_from_jax(cfg_t, jax.tree.map(np.asarray, params_j),
                               device="cpu")
    trace = ref_engine.serve_trace_for(ref_config("smollm-360m"),
                                       [(7, 6), (9, 5)], slots=SLOTS,
                                       layer_group=8)
    base_plan = runtime.plan(trace, TPU_V5E, 0.2 * trace.peak_kv_bytes())
    return cfg_j, params_j, cfg_t, params_t, base_plan


def _recording(module, log, unpack):
    """Wrap ``module.forward`` so each call's logits (and the rows whose
    argmax the engine uses) are logged."""
    orig = module.forward

    def forward(*args, **kw):
        res = orig(*args, **kw)
        view = kw.get("paged_view") or {}
        logits = np.array(unpack(res), np.float32)
        if view.get("prefill"):
            used = [(0, logits.shape[1] - 1)]
        else:
            active = np.array(view["active"])
            used = [(b, 0) for b in range(logits.shape[0]) if active[b]]
        log.append((logits, used))
        return res
    return forward


def _drive(batcher):
    results = []
    while batcher.queue or batcher._jobs or any(batcher.active):
        if not batcher.step():
            break
        for i in range(batcher.B):
            if not batcher.active[i] and batcher.outputs[i]:
                results.append(tuple(int(t) for t in batcher.outputs[i]))
                batcher.outputs[i] = []
    return sorted(results)


@pytest.fixture(scope="module")
def runs(setup):
    """Each case run once: the reference engine and the port (tiered and
    all-hot), with every forward's logits logged."""
    cfg_j, params_j, cfg_t, params_t, base_plan = setup
    out = {}
    for name, case in CASES.items():
        plan_j = dataclasses.replace(base_plan, hot_window=MAX_SEQ // 2,
                                     slot_hot_windows=list(case["windows"]),
                                     page_tokens=PAGE,
                                     prefill_chunk_tokens=case["chunk"],
                                     slot_tenants=case.get("tenants"))
        plan_t = PlacementPlan.from_dict(plan_j.to_dict())
        all_hot = dataclasses.replace(plan_t,
                                      slot_hot_windows=[MAX_SEQ] * SLOTS)
        log_j, log_t = [], []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref_model, "forward",
                       _recording(ref_model, log_j, lambda r: r[0]))
            b_j = ref_engine.ContinuousBatcher(
                params_j, cfg_j, SLOTS, MAX_SEQ, plan=plan_j, paged=True)
            for toks, d, key, tn in case["reqs"]:
                b_j.submit(jnp.asarray(toks, jnp.int32), d, prefix_key=key,
                           tenant=tn)
            out_j = _drive(b_j)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(model, "forward", _recording(model, log_t, lambda r: r))
            b_t = ContinuousBatcher(params_t, cfg_t, SLOTS, MAX_SEQ,
                                    plan=plan_t, paged=True, device="cpu")
            for toks, d, key, tn in case["reqs"]:
                b_t.submit(torch.from_numpy(toks), d, prefix_key=key,
                           tenant=tn)
            out_t = _drive(b_t)
        b_h = ContinuousBatcher(params_t, cfg_t, SLOTS, MAX_SEQ, plan=all_hot,
                                paged=True, device="cpu")
        for toks, d, key, tn in case["reqs"]:
            b_h.submit(torch.from_numpy(toks), d, prefix_key=key, tenant=tn)
        out_h = _drive(b_h)
        b_t.ptable.check()
        out[name] = dict(case=case, plan_j=plan_j, out_j=out_j, out_t=out_t,
                         out_h=out_h, b_j=b_j, b_t=b_t, b_h=b_h, log_j=log_j,
                         log_t=log_t)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_tokens_match_reference(runs, case):
    r = runs[case]
    assert r["out_t"] == r["out_j"]
    assert len(r["out_t"]) == len(r["case"]["reqs"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_logits_match_with_margin(runs, case):
    r = runs[case]
    assert len(r["log_t"]) == len(r["log_j"]) > 0
    for (got, used_t), (want, used_j) in zip(r["log_t"], r["log_j"]):
        assert got.shape == want.shape and used_t == used_j
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        for b, row in used_t:
            top2 = np.sort(want[b, row, :512])[-2:]
            assert top2[1] - top2[0] > 10 * TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_counters_match_reference(runs, case):
    r = runs[case]
    c_t, c_j = r["b_t"].counters(), r["b_j"].counters()
    for key in INT_COUNTERS:
        assert c_t[key] == c_j[key], key
    assert c_t["tenant_hot_peak"] == c_j["tenant_hot_peak"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_counters_match_prediction(runs, case):
    r = runs[case]
    b_t = r["b_t"]
    requests = [(tuple(int(t) for t in toks), d, tn, key)
                for toks, d, key, tn in r["case"]["reqs"]]
    pred = ref_engine.predict_pool_counters(
        requests, r["plan_j"], slots=SLOTS, max_seq=MAX_SEQ,
        page_tokens=b_t.page_tokens, row_bytes=b_t._row_bytes,
        prefill_chunk_tokens=r["case"]["chunk"])
    c = b_t.counters()
    assert pred["migration_bytes"] == c["sim_migration_bytes"]
    assert pred["step_migration_bytes"] == c["step_migration_bytes"]
    assert pred["page_copies"] == c["page_copies"]
    assert pred["admit_page_writes"] == c["admit_page_writes"]
    assert pred["tenant_hot_peak"] == c["tenant_hot_peak"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_tiered_equals_all_hot(runs, case):
    r = runs[case]
    assert r["out_t"] == r["out_h"]
    assert r["b_h"].counters()["page_copies"] == 0


def test_engine_cases_exercise_the_mechanisms(runs):
    """The cases reach what they are for: skipped shared-prefix pages,
    split prefill, and demotions with decode reading cold pages."""
    assert all(runs[c]["b_t"].prefill_skipped_tokens > 0
               for c in ("shared_page_edge", "shared_mid_page"))
    assert max(runs["chunked"]["b_t"].step_prefill_tokens) <= 2 * 2 * PAGE
    assert runs["demotions"]["b_t"].counters()["page_copies"] > 0
    assert runs["demotions"]["b_t"].decode_steps > 0
    assert set(runs["tenants"]["b_t"].tenant_hot_peak) == {"chatty",
                                                            "bursty"}
