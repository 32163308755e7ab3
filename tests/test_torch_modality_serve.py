"""The modality stubs on the serving engine, against the reference engine,
on the ``.reduced()`` configs in fp32 with the reference's parameters and
plans carried across:

  * paligemma-3b's text-only prompts on the all-HBM, concat and
    paged-merged layouts, with ``use_paged_decode`` set so that
    ``paged=True`` would take the pools for any other config: the greedy
    tokens and integer counters equal the reference engine's on each
    layout, and the tiered layouts' tokens equal the all-HBM run's.  One
    prompt is shorter than the prefix (ROADMAP R9), so its prefill reads
    a cache row below P that it never wrote, in both packages alike;
  * paligemma never builds the pools and never reaches
    ``_paged_decode_core`` (K1 has no prefix mask), even handed a page
    view;
  * ROADMAP R10: the reference's batcher takes a musicgen config and
    fails at ``submit`` on a codebook prompt; the port's refuses it at
    construction, naming ``generate``;
  * the disaggregated engine refuses paligemma (it needs the pools), and
    both archs at two decode shards, in both packages.

The reference's tiered layouts need the R1 patch (ROADMAP §3), applied for
this module only, with its forward jitted
(``test_torch_families_serve._jit_forward``).  Torch runs on one thread
here."""
import dataclasses

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
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.models import attention, model
from repro_torch.runtime.plan import PlacementPlan
from repro_torch.serve import disagg, engine
from repro_torch.weights import params_from_jax
from test_torch_families_serve import _jit_forward
from test_torch_xlstm import one_torch_thread  # noqa: F401 (autouse)

VLM, AUDIO = "paligemma-3b", "musicgen-medium"
MAX_SEQ, SLOTS, PAGE = 32, 2, 4
INT_COUNTERS = ("sim_migration_bytes", "step_migration_bytes", "page_copies",
                "admit_page_writes", "table_uploads", "repacks",
                "prefill_compute_tokens", "prefill_skipped_tokens",
                "table_version")


def _toks(seed, n):
    return np.random.default_rng(seed).integers(0, 512, n)


# five text-only prompts, one of 3 tokens, below the reduced prefix of 4:
# its admission's prefill attends to row 3 of the max_seq-row cache, which
# no token has written (R9), so its first token depends on max_seq in both
# packages alike; the windows make rows demote
REQUESTS = [(_toks(1, 9), 6), (_toks(2, 14), 4), (_toks(3, 3), 7),
            (_toks(4, 6), 5), (_toks(5, 11), 3)]
WINDOWS = [4, 8]
LAYOUTS = {"all-HBM": (False, False), "concat": (True, False),
           "paged-merged": (True, True)}


@pytest.fixture(scope="module")
def r1_patch():
    """ROADMAP R1, for this module only, with the reference's forward
    jitted."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_kvcache, "host_memory_kind", lambda: None)
        mp.setattr(ref_model, "forward", _jit_forward(ref_model.forward))
        yield


def _both(arch, **fields):
    """The reduced config (with ``fields``) in both packages and the
    reference's parameters carried across."""
    cfg_j = dataclasses.replace(ref_config(arch).reduced(), **fields)
    cfg_t = dataclasses.replace(get_config(arch).reduced(), **fields)
    params_j, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                     cfg_j))
    params_t = params_from_jax(cfg_t, jax.tree.map(np.asarray, params_j),
                               device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def vlm():
    return _both(VLM, use_paged_decode=True)


def _plans():
    plan_j = R.PlacementPlan(hot_window=MAX_SEQ // 2,
                             slot_hot_windows=list(WINDOWS),
                             page_tokens=PAGE)
    return plan_j, PlacementPlan.from_dict(plan_j.to_dict())


def _run(b):
    results = []
    while b.queue or b._jobs or any(b.active):
        if not b.step():
            break
        for i in range(b.B):
            if not b.active[i] and b.outputs[i]:
                results.append(tuple(int(t) for t in b.outputs[i]))
                b.outputs[i] = []
    return sorted(results)


@pytest.fixture(scope="module")
def layouts(vlm, r1_patch):
    """Each layout's (reference engine, its tokens, port engine, its
    tokens, the port's ``_paged_decode_core`` calls)."""
    cfg_j, params_j, cfg_t, params_t = vlm
    plan_j, plan_t = _plans()
    out = {}
    for name, (tiered, paged) in LAYOUTS.items():
        b_j = ref_engine.ContinuousBatcher(
            params_j, cfg_j, SLOTS, MAX_SEQ, plan=plan_j if tiered else None,
            paged=paged)
        b_t = engine.ContinuousBatcher(
            params_t, cfg_t, SLOTS, MAX_SEQ, plan=plan_t if tiered else None,
            paged=paged, device="cpu")
        for toks, d in REQUESTS:
            b_j.submit(jnp.asarray(toks, jnp.int32), d)
            b_t.submit(torch.from_numpy(toks), d)
        out_j = sorted(tuple(int(t) for t in o) for o in b_j.run())
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(attention, "_paged_decode_core",
                       lambda *a, **k: calls.append(1))
            out_t = _run(b_t)
        out[name] = (b_j, out_j, b_t, out_t, len(calls))
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_vlm_tokens_and_counters_match_reference(layouts, layout):
    b_j, out_j, b_t, out_t, calls = layouts[layout]
    assert out_t == out_j
    assert len(out_t) == len(REQUESTS)
    c_t, c_j = b_t.counters(), b_j.counters()
    for key in INT_COUNTERS:
        if key in c_j:
            assert c_t[key] == c_j[key], key
    assert calls == 0


@pytest.mark.parametrize("layout", ["concat", "paged-merged"])
def test_vlm_tiered_matches_all_hbm(layouts, layout):
    """Tiering moves rows to host memory and changes no token, in both
    packages."""
    b_j, out_j, b_t, out_t, _ = layouts[layout]
    base = layouts["all-HBM"]
    assert out_t == out_j == base[3] == base[1]
    assert b_t.sim_migration_bytes == b_j.sim_migration_bytes > 0


def test_vlm_never_builds_pools(layouts):
    """``paged=True`` with ``use_paged_decode`` takes paged-merged under
    ``prefix_lm`` in both packages, and admits by one dense prefill."""
    b_j, _, b_t, _, _ = layouts["paged-merged"]
    assert b_t.cfg.use_paged_decode and b_t.cfg.prefix_lm
    assert b_j.pool is None and b_t.pool is None
    assert b_j.paged is not None and b_t.paged is not None
    assert not b_t._pool_prefill_ok and not b_j._pool_prefill_ok


def test_vlm_decode_stays_dense_given_a_page_view(vlm):
    """Handed a page view, a prefix-LM decode attends over the dense cache
    under the prefix mask, not through ``_paged_decode_core``; the same
    call on a config without the prefix does take it."""
    _, _, cfg_t, params_t = vlm
    toks = torch.from_numpy(_toks(8, (2, 9)))
    view = {"boundaries": [4, 8], "page_tokens": PAGE}
    for cfg, want in ((cfg_t, 0),
                      (dataclasses.replace(cfg_t, prefix_lm=False), 1)):
        _, caches = model.prefill(params_t, cfg, {"tokens": toks},
                                  max_seq=16)
        plain = [{k: v.clone() for k, v in c.items()} for c in caches]
        nxt = torch.from_numpy(_toks(9, (2, 1)))
        index = torch.tensor([9, 9], dtype=torch.int32)
        calls = []
        orig = attention._paged_decode_core
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(attention, "_paged_decode_core",
                       lambda *a, **k: calls.append(1) or orig(*a, **k))
            got = model.forward(params_t, cfg, {"tokens": nxt},
                                caches=caches, cache_index=index,
                                decode=True, paged_view=view)
        want_logits = model.forward(params_t, cfg, {"tokens": nxt},
                                    caches=plain, cache_index=index,
                                    decode=True)
        assert len(calls) == want * cfg.num_layers
        torch.testing.assert_close(got, want_logits, atol=1e-5, rtol=0.0)


# ------------------------------------------------------------------ R10 ----

def test_codebook_batcher_refused(r1_patch):
    """ROADMAP R10: the reference's batcher builds on a musicgen config and
    fails at ``submit``, where it reads a (S, K) prompt as one id a token
    (``int(t)`` on a row of K codes); the port's refuses the config at
    construction, on every layout, and serves codebooks through
    ``generate``."""
    cfg_j, params_j, cfg_t, params_t = _both(AUDIO)
    prompt = np.random.default_rng(3).integers(0, 512, (6, 4))
    b_j = ref_engine.ContinuousBatcher(params_j, cfg_j, SLOTS, MAX_SEQ)
    with pytest.raises(TypeError, match="length-1 arrays"):
        b_j.submit(jnp.asarray(prompt, jnp.int32), 4)
    plan_j, plan_t = _plans()
    for plan, paged in ((None, False), (plan_t, False), (plan_t, True)):
        with pytest.raises(ValueError, match="one token id a slot.*"
                                             "generate"):
            engine.ContinuousBatcher(params_t, cfg_t, SLOTS, MAX_SEQ,
                                     plan=plan, paged=paged, device="cpu")
    out = engine.generate(params_t, cfg_t,
                          {"tokens": torch.from_numpy(prompt[None])}, 4)
    assert tuple(out.shape) == (1, 4, 4)


# ---------------------------------------------------------------- disagg ----

@pytest.mark.parametrize("shards", [1, 2])
def test_disagg_refuses_the_vlm(vlm, shards):
    """No pools under ``prefix_lm``, so the disaggregated engine refuses
    paligemma at one shard and at two, in both packages, naming the
    pools."""
    cfg_j, params_j, cfg_t, params_t = vlm
    plan_j, plan_t = _plans()
    n = 2 * shards
    with pytest.raises(ValueError, match="persistent pools layout"):
        ref_disagg.DisaggregatedEngine(params_j, cfg_j, SLOTS, MAX_SEQ,
                                       plan=plan_j,
                                       devices=[jax.devices()[0]] * n)
    with pytest.raises(ValueError, match=r"persistent pools layout.*"
                                         r"prefix_lm"):
        disagg.DisaggregatedEngine(params_t, cfg_t, SLOTS, MAX_SEQ,
                                   plan=plan_t, devices=["cpu"] * n)


def test_disagg_refuses_two_shards_of_codebooks():
    """The reference refuses musicgen at two decode shards (its
    multi-shard rule names codebooks); the port refuses it before, as
    every batcher of it."""
    cfg_j, params_j, cfg_t, params_t = _both(AUDIO, use_paged_decode=True)
    plan_j, plan_t = _plans()
    with pytest.raises(ValueError, match="multi-shard decode"):
        ref_disagg.DisaggregatedEngine(params_j, cfg_j, SLOTS, MAX_SEQ,
                                       plan=plan_j,
                                       devices=[jax.devices()[0]] * 4)
    with pytest.raises(ValueError, match="one token id a slot"):
        disagg.DisaggregatedEngine(params_t, cfg_t, SLOTS, MAX_SEQ,
                                   plan=plan_t, devices=["cpu"] * 4)


def test_disagg_multi_shard_rule_names_the_stubs():
    """The port's multi-shard rule refuses a prefix or codebooks on a
    config that reaches it (the refusals above come first for both archs):
    a prefix without the prefix-LM mask, on two shards."""
    cfg_t = dataclasses.replace(get_config(VLM).reduced(), prefix_lm=False,
                                use_paged_decode=True)
    params_t = model.init_params(cfg_t, device="cpu")
    _, plan_t = _plans()
    with pytest.raises(ValueError, match="multi-shard decode"):
        disagg.DisaggregatedEngine(params_t, cfg_t, SLOTS, MAX_SEQ,
                                   plan=plan_t, devices=["cpu"] * 4)
