"""xlstm-1.3b and lstm-ptb on the serving engine, against the reference
engine, each on its ``.reduced()`` config in fp32 with the reference's
parameters and plan carried across:

  * the four layouts (all-HBM, concat, paged-merged, pools): the port's
    greedy tokens and integer counters equal the reference engine's, the
    tiered layouts give the all-HBM tokens, the pools' counters equal the
    port's ``predict_pool_counters`` (a dense admission: these stacks have
    no attention layer, so no pool prefill, no KV and no migration bytes);
  * a ``prefix_key`` shared by requests maps pages but reuses no other
    slot's recurrent state: each request's tokens are its own;
  * ``prefill_chunk_tokens`` is refused, as the reference refuses it;
  * ROADMAP R8: at max_seq equal to the mLSTM's qk head dim (16 reduced),
    the reference's shape rule takes the mLSTM state C for a sequence and
    splits it at the cold boundary; the port keys sequence leaves by name,
    so its concat and paged-merged layouts still give its all-HBM tokens.

The parity runs use max_seq 32, where no state leaf's second-to-last dim
equals max_seq, so both packages mean the same by every layout.  The
reference's tiered layouts need the R1 patch (ROADMAP §3), applied for
this module only, and its forward runs jitted (test_torch_families_serve's
``_jit_forward``): eager, its scan retraces the eight-layer period on
every call."""
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
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.models.xlstm import mlstm_dims
from repro_torch.runtime.plan import PlacementPlan
from repro_torch.serve import engine
from repro_torch.weights import params_from_jax
from test_torch_families_serve import _jit_forward
from test_torch_xlstm import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("lstm-ptb", "xlstm-1.3b")
LAYOUTS = {"base": (False, False, False), "concat": (True, False, False),
           "paged": (True, True, False), "pools": (True, True, True)}
MAX_SEQ, SLOTS, PAGE = 32, 2, 4
REQUESTS = [(8, 5), (17, 7), (7, 4)]          # (prompt tokens, decode tokens)
INT_COUNTERS = ("sim_migration_bytes", "step_migration_bytes", "page_copies",
                "admit_page_writes", "table_uploads", "repacks",
                "prefill_compute_tokens", "prefill_skipped_tokens",
                "table_version", "step_prefill_tokens")


def _toks(seed, n):
    return np.random.default_rng(seed).integers(0, 512, n)


@pytest.fixture(scope="module")
def r1_patch():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_kvcache, "host_memory_kind", lambda: None)
        mp.setattr(ref_model, "forward", _jit_forward(ref_model.forward))
        yield


@pytest.fixture(scope="module")
def params():
    out = {}
    for arch in ARCHS:
        cfg_j, cfg_t = ref_config(arch).reduced(), get_config(arch).reduced()
        params_j, _ = split_params(ref_model.init_params(
            jax.random.PRNGKey(0), cfg_j))
        params_t = params_from_jax(cfg_t, jax.tree.map(np.asarray, params_j),
                                   device="cpu")
        out[arch] = (cfg_j, params_j, cfg_t, params_t)
    return out


def _plans(max_seq=MAX_SEQ, chunk=0):
    plan_j = R.PlacementPlan(hot_window=max_seq // 2,
                             slot_hot_windows=[4, 8], page_tokens=PAGE,
                             prefill_chunk_tokens=chunk)
    return plan_j, PlacementPlan.from_dict(plan_j.to_dict())


def _engines(params, arch, layout, max_seq=MAX_SEQ):
    """The reference's and the port's engine of one layout."""
    cfg_j, params_j, cfg_t, params_t = params[arch]
    planned, paged, pools = LAYOUTS[layout]
    plan_j, plan_t = _plans(max_seq) if planned else (None, None)
    b_j = ref_engine.ContinuousBatcher(
        params_j, dataclasses.replace(cfg_j, use_paged_decode=pools),
        SLOTS, max_seq, plan=plan_j, paged=paged)
    b_t = engine.ContinuousBatcher(
        params_t, dataclasses.replace(cfg_t, use_paged_decode=pools),
        SLOTS, max_seq, plan=plan_t, paged=paged, device="cpu")
    return b_j, b_t


def _serve(b, prompts, key=None):
    """Submit (prompt, decode tokens) pairs and run; sorted outputs."""
    for toks, d in prompts:
        if isinstance(b, engine.ContinuousBatcher):
            b.submit(torch.from_numpy(toks), d, prefix_key=key)
        else:
            b.submit(jnp.asarray(toks, jnp.int32), d, prefix_key=key)
    return sorted(tuple(int(t) for t in o) for o in b.run())


PROMPTS = [(_toks(20 + i, p), d) for i, (p, d) in enumerate(REQUESTS)]
CASES = [(arch, layout) for arch in ARCHS for layout in LAYOUTS]


@pytest.fixture(scope="module")
def served(params, r1_patch):
    out = {}
    for arch, layout in CASES:
        b_j, b_t = _engines(params, arch, layout)
        out[arch, layout] = (b_j, _serve(b_j, PROMPTS), b_t,
                             _serve(b_t, PROMPTS))
    return out


@pytest.mark.parametrize("arch,layout", CASES)
def test_tokens_and_counters_match_reference(served, arch, layout):
    b_j, out_j, b_t, out_t = served[arch, layout]
    assert out_t == out_j
    assert sorted(len(o) for o in out_t) == sorted(d for _, d in REQUESTS)
    c_t, c_j = b_t.counters(), b_j.counters()
    for key in INT_COUNTERS:
        if key in c_j:
            assert c_t[key] == c_j[key], key
    assert c_t["sim_migration_bytes"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_tiered_layouts_give_all_hbm_tokens(served, arch):
    outs = [served[arch, layout][3] for layout in LAYOUTS]
    assert all(o == outs[0] for o in outs)


@pytest.mark.parametrize("arch", ARCHS)
def test_pools_counters_match_prediction(served, arch):
    """The pools admit these stacks by one dense prefill each: the page
    books replay as predict_pool_counters(dense_admit=True) predicts."""
    b_t = served[arch, "pools"][2]
    assert not b_t._pool_prefill_ok
    requests = [(len(toks), d) for toks, d in PROMPTS]
    pred = engine.predict_pool_counters(
        requests, b_t.plan, slots=SLOTS, max_seq=MAX_SEQ,
        page_tokens=b_t.page_tokens, row_bytes=b_t._row_bytes,
        dense_admit=True)
    c = b_t.counters()
    assert pred["migration_bytes"] == c["sim_migration_bytes"] == 0
    assert pred["step_migration_bytes"] == c["step_migration_bytes"]
    assert pred["page_copies"] == c["page_copies"] > 0
    assert pred["admit_page_writes"] == c["admit_page_writes"]
    b_t.ptable.check()


@pytest.mark.parametrize("layout", ["base", "pools"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_key_reuses_no_state(params, r1_patch, arch, layout):
    """Three prompts that open with one 9-token prefix, under one
    prefix_key: the pools map the donor's full pages, but every request
    decodes from its own prefill's state, so the tokens equal a run
    without the key, one request at a time, and the reference's."""
    sys_p = _toks(7, 9)
    prompts = [(np.concatenate([sys_p, _toks(11 + i, 3 + 2 * i)]), d)
               for i, d in enumerate((6, 4, 5))]
    b_j, b_t = _engines(params, arch, layout)
    out_t = _serve(b_t, prompts, key="sys")
    assert out_t == _serve(b_j, prompts, key="sys")
    singles = []
    for p in prompts:
        one = _engines(params, arch, layout)[1]
        singles += _serve(one, [p])
    assert out_t == sorted(singles)
    if layout == "pools":
        c = b_t.counters()
        # pages were mapped onto the donor's (fewer written than the
        # prompts fill), and no prompt row was skipped
        assert c["admit_page_writes"] < sum(-(-len(t) // PAGE)
                                            for t, _ in prompts)
        assert c["prefill_skipped_tokens"] == 0
        b_t.ptable.check()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_is_refused(params, r1_patch, arch):
    """No attention layer takes a pool prefill chunk: both engines refuse
    a prefill budget on the pools."""
    cfg_j, params_j, cfg_t, params_t = params[arch]
    plan_j, plan_t = _plans(chunk=8)
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        ref_engine.ContinuousBatcher(
            params_j, dataclasses.replace(cfg_j, use_paged_decode=True),
            SLOTS, MAX_SEQ, plan=plan_j, paged=True)
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        engine.ContinuousBatcher(
            params_t, dataclasses.replace(cfg_t, use_paged_decode=True),
            SLOTS, MAX_SEQ, plan=plan_t, paged=True, device="cpu")


def test_state_is_never_a_sequence_leaf(params, r1_patch):
    """ROADMAP R8 at max_seq 16, the reduced mLSTM's qk head dim: the
    port's concat and paged-merged layouts give its all-HBM tokens.  The
    reference's do not (its concat layout splits C along Dk and keeps a
    stale cold half; its paged-merged masks C as if Dk were positions):
    that is the reference's, pinned here, and nothing in it changes."""
    arch = "xlstm-1.3b"
    R8_SEQ = mlstm_dims(params[arch][2])[2]
    assert R8_SEQ == 16
    prompts = [(_toks(30 + i, p), d)
               for i, (p, d) in enumerate([(6, 5), (9, 6), (5, 7)])]
    outs = {}
    for layout in ("base", "concat", "paged"):
        b_j, b_t = _engines(params, arch, layout, max_seq=R8_SEQ)
        outs[layout] = _serve(b_t, prompts)
        if layout == "base":
            ref_base = _serve(b_j, prompts)
        elif layout == "concat":
            assert _serve(b_j, prompts) != ref_base
    assert outs["base"] == ref_base
    assert outs["concat"] == outs["paged"] == outs["base"]
