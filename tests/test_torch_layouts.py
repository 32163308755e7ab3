"""The port's dense-cache paths and engine layouts against the reference on
smollm-360m.reduced() in fp32, with the reference's parameters and plans
carried across (params_from_jax, PlacementPlan.to_dict):

  * the cache helpers (split/merge, splice_slot, copy_slot_rows, the
    paged-merged view, pool_layout/gather_pools) give the reference's
    arrays exactly;
  * prefill and decode_step give the full forward's logits and the
    reference's within TOL, and _paged_decode_core the dense decode's;
  * all four engine layouts (all-HBM, concat, paged-merged, pools) give the
    reference's greedy tokens and migration bytes; inside the port they
    agree with each other, and the per-slot boundaries move fewer bytes
    than the global one;
  * generate gives the reference's greedy tokens, and the batcher gives
    each request's single-request tokens;
  * ROADMAP F1: a slot that finished at max_seq keeps its stale length and
    the lockstep decode writes its row at index max_seq; the port drops
    that write, as JAX's scatter does, on all three dense layouts for
    smollm-360m's GQA and deepseek-v2-lite's MLA latent: the reference's
    tokens and counters, the finished slot's rows untouched.

Tolerance: TOL = 1e-4 absolute on logits (the same fp32 math in another
order).  Where a token claim rests on logits, every row whose argmax is
used has a top-1/top-2 margin above 10 x TOL, so an error within TOL cannot
flip it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.kernels import paged_decode as ref_pd
from repro.models import kvcache as ref_kvcache
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro.runtime.plan import PlacementPlan as RefPlan
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.kernels import paged_decode as pd
from repro_torch.models import kvcache, model
from repro_torch.runtime.plan import PlacementPlan
from repro_torch.serve import engine
from repro_torch.weights import params_from_jax
from test_torch_families_serve import _jit_forward
from test_torch_xlstm import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4
ARCH = "smollm-360m"
MAX_SEQ, SLOTS, PAGE = 32, 2, 4
REQUESTS = [(7, 6), (9, 5), (6, 7)]          # (prompt tokens, decode tokens)
LAYOUTS = ("base", "concat", "paged", "pools")


@pytest.fixture(scope="module")
def r1_patch():
    """The reference's tiered layouts fail on this JAX (ROADMAP R1): its
    host memory kind cannot mix with device arrays in eager ops.  Patched
    for this module only, before any reference engine is built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_kvcache, "host_memory_kind", lambda: None)
        yield


@pytest.fixture(scope="module")
def setup():
    cfg_j = ref_config(ARCH).reduced()
    params_j, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                     cfg_j))
    cfg_t = get_config(ARCH).reduced()
    params_t = params_from_jax(cfg_t, jax.tree.map(np.asarray, params_j),
                               device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def port_tree(cfg, tree):
    """The reference's cache tree ({"prologue": [...], "slots": [stacked
    (P, ...)]}) as the port's per-layer list of numpy dicts."""
    out = [dict(layer) for layer in tree["prologue"]]
    for p in range(cfg.num_periods):
        for s in range(cfg.period_len):
            out.append({k: None if a is None else np.asarray(a[p])
                        for k, a in tree["slots"][s].items()})
    return out


def to_torch(tree):
    return [{k: None if a is None else torch.from_numpy(np.array(a))
             for k, a in layer.items()} for layer in tree]


def assert_trees_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if w[k] is None:
                assert g[k] is None, k
            else:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def random_cache(cfg, batch, seed):
    """A reference-layout cache of ``batch`` rows filled from numpy."""
    rng = np.random.default_rng(seed)
    shape = ref_kvcache.init_cache(cfg, batch, MAX_SEQ, jnp.float32)
    return jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape, np.float32)), shape)


# ------------------------------------------------------------- helpers ----

def test_split_merge_round_trip_matches_reference(setup):
    cfg_j, _, cfg_t, _ = setup
    full = random_cache(cfg_j, SLOTS, 1)
    for cold_len in (0, 12, MAX_SEQ):
        cold_j, hot_j = ref_kvcache.split_seq_cache(full, MAX_SEQ, cold_len)
        cold_t, hot_t = kvcache.split_seq_cache(
            to_torch(port_tree(cfg_j, full)), cold_len)
        assert_trees_equal(cold_t, port_tree(cfg_j, cold_j))
        assert_trees_equal(hot_t, port_tree(cfg_j, hot_j))
        assert_trees_equal(kvcache.merge_seq_cache(cold_t, hot_t),
                           port_tree(cfg_j, full))


def test_init_cache_and_host_moves(setup):
    """init_cache holds one zeroed entry per layer in the reference's
    shapes; to_host keeps CPU tensors as they are (the reference's identity
    without a host memory kind) and None leaves as None; to_device copies
    onto the device asked for."""
    cfg_j, _, cfg_t, _ = setup
    caches = kvcache.init_cache(cfg_t, SLOTS, MAX_SEQ, torch.float32, "cpu")
    want = port_tree(cfg_j, ref_kvcache.init_cache(cfg_j, SLOTS, MAX_SEQ,
                                                   jnp.float32))
    assert_trees_equal(caches, want)
    cold, _ = kvcache.split_seq_cache(caches, 8)
    cold[0]["extra"] = None
    host = kvcache.to_host(cold)
    assert host[0]["k"] is cold[0]["k"] and host[0]["extra"] is None
    back = kvcache.to_device(host, "cpu")
    assert torch.equal(back[1]["v"], cold[1]["v"]) and back[0]["extra"] is None


def test_splice_slot_matches_reference(setup):
    cfg_j = setup[0]
    big, one = random_cache(cfg_j, 3, 2), random_cache(cfg_j, 1, 3)
    want = ref_kvcache.splice_slot(big, one, 1, 3)
    got = kvcache.splice_slot(to_torch(port_tree(cfg_j, big)),
                              to_torch(port_tree(cfg_j, one)), 1)
    assert_trees_equal(got, port_tree(cfg_j, want))


def test_copy_slot_rows_matches_reference(setup):
    cfg_j = setup[0]
    dst, src = random_cache(cfg_j, SLOTS, 4), random_cache(cfg_j, SLOTS, 5)
    want = ref_kvcache.copy_slot_rows(dst, src, 1, 4, 12, MAX_SEQ)
    got = kvcache.copy_slot_rows(to_torch(port_tree(cfg_j, dst)),
                                 to_torch(port_tree(cfg_j, src)), 1, 4, 12)
    assert_trees_equal(got, port_tree(cfg_j, want))


def test_paged_tiered_merged_matches_reference(setup, r1_patch):
    """Rows below each slot's boundary read the cold tree, the rest the
    hot one, in both packages; demote_rows moves only the slot's rows."""
    cfg_j, _, cfg_t, _ = setup
    hot, cold = random_cache(cfg_j, SLOTS, 6), random_cache(cfg_j, SLOTS, 7)
    ref = ref_kvcache.PagedTieredCache(cold, hot, jnp.asarray([8, 0]),
                                       PAGE, MAX_SEQ, [8, 0])
    port = kvcache.PagedTieredCache(
        to_torch(port_tree(cfg_j, cold)), to_torch(port_tree(cfg_j, hot)),
        torch.tensor([8, 0], dtype=torch.int32), PAGE, MAX_SEQ, [8, 0])
    assert_trees_equal(port.merged(), port_tree(cfg_j, ref.merged()))
    assert ref.demote_rows(1, 12) == port.demote_rows(1, 12) == 12
    assert port.host_boundaries == [8, 12] == port.boundaries.tolist()
    assert_trees_equal(port.merged(), port_tree(cfg_j, ref.merged()))


@pytest.mark.parametrize("cold", [[0, 0], [16, 0], [8, 24], [32, 32]])
def test_pool_layout_and_gather_match_reference(cold):
    """Table, tier, pool order and every gathered pool, table for table."""
    rng = np.random.default_rng(8)
    k = rng.standard_normal((2, MAX_SEQ, 2, 16), np.float32)
    v = rng.standard_normal((2, MAX_SEQ, 2, 16), np.float32)
    want = ref_pd.pool_layout(cold, MAX_SEQ // PAGE, PAGE)
    got = pd.pool_layout(cold, MAX_SEQ // PAGE, PAGE)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2:] == want[2:]
    pools_j = ref_pd.gather_pools(jnp.asarray(k), jnp.asarray(v), want, PAGE)
    pools_t = pd.gather_pools(torch.from_numpy(k), torch.from_numpy(v), got,
                              PAGE)
    for g, w in zip(pools_t, pools_j):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------- prefill, decode_step ----

def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, shape)


def test_prefill_decode_match_full_forward_and_reference(setup):
    """Decode-step logits at position t == full-forward logits at t, and ==
    the reference's prefill and decode_step (scalar and per-slot
    cache_index)."""
    cfg_j, params_j, cfg_t, params_t = setup
    B, S = 2, 12
    toks = _tokens(9, (B, S))
    full = model.forward(params_t, cfg_t, {"tokens": torch.from_numpy(toks)})
    tj = jnp.asarray(toks, jnp.int32)
    last_j, caches_j = ref_model.prefill(params_j, cfg_j,
                                         {"tokens": tj[:, :S - 2]},
                                         max_seq=S)
    last, caches = model.prefill(params_t, cfg_t,
                                 {"tokens": torch.from_numpy(toks[:, :S - 2])},
                                 max_seq=S)
    assert len(caches) == cfg_t.num_layers
    assert caches[0]["k"].shape == (B, S, cfg_t.num_kv_heads * cfg_t.head_dim)
    np.testing.assert_allclose(last.numpy(), full[:, S - 3].numpy(),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(last.numpy(), np.asarray(last_j), atol=TOL,
                               rtol=0)
    for t, index in ((S - 2, S - 2),
                     (S - 1, torch.full((B,), S - 1, dtype=torch.int32))):
        lg_j, caches_j = ref_model.decode_step(
            params_j, cfg_j, tj[:, t:t + 1], caches_j,
            jnp.asarray(np.asarray(index), jnp.int32))
        lg, caches = model.decode_step(
            params_t, cfg_t, torch.from_numpy(toks[:, t:t + 1]), caches,
            index)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_j), atol=TOL,
                                   rtol=0)
    for got, want in zip(caches, port_tree(cfg_j, caches_j)):
        for k in ("k", "v"):
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=TOL,
                                       rtol=0)


def _paged_case(setup, seed, prompt):
    cfg_j, params_j, cfg_t, params_t = setup
    toks = _tokens(seed, (2, prompt))
    _, caches = model.prefill(params_t, cfg_t,
                              {"tokens": torch.from_numpy(toks)},
                              max_seq=16)
    _, caches_j = ref_model.prefill(params_j, cfg_j,
                                    {"tokens": jnp.asarray(toks, jnp.int32)},
                                    max_seq=16)
    lengths = torch.full((2,), prompt, dtype=torch.int32)
    tok = torch.tensor([[3], [5]])
    return caches, caches_j, lengths, tok


def test_paged_decode_core_matches_dense_decode(setup):
    """One decode step through the pool layout (cold pages below the
    boundaries [4, 0]) gives the dense decode's logits within TOL and the
    reference's paged logits; the flag alone, with no page view, keeps the
    dense path exactly."""
    cfg_j, params_j, cfg_t, params_t = setup
    caches, caches_j, lengths, tok = _paged_case(setup, 1, 7)
    cfg_p = dataclasses.replace(cfg_t, use_paged_decode=True)
    view = {"boundaries": [4, 0], "page_tokens": PAGE}
    dense = model.forward(params_t, cfg_t, {"tokens": tok}, caches=caches,
                          cache_index=lengths, decode=True)
    paged = model.forward(params_t, cfg_p, {"tokens": tok}, caches=caches,
                          cache_index=lengths, decode=True, paged_view=view)
    flag_only = model.forward(params_t, cfg_p, {"tokens": tok},
                              caches=caches, cache_index=lengths,
                              decode=True)
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), atol=TOL,
                               rtol=0)
    assert torch.equal(flag_only, dense)
    want, _, _ = ref_model.forward(
        params_j, dataclasses.replace(cfg_j, use_paged_decode=True),
        {"tokens": jnp.asarray(tok.numpy(), jnp.int32)}, caches=caches_j,
        cache_index=jnp.asarray(lengths.numpy()), decode=True,
        paged_view=view)
    np.testing.assert_allclose(paged.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_paged_decode_core_reads_the_pools(setup):
    """The pool path reads through the page table: wiping the dense rows
    the slots attend to changes its output."""
    _, _, cfg_t, params_t = setup
    caches, _, lengths, tok = _paged_case(setup, 2, 9)
    cfg_p = dataclasses.replace(cfg_t, use_paged_decode=True)
    view = {"boundaries": [8, 4], "page_tokens": PAGE}
    a = model.forward(params_t, cfg_p, {"tokens": tok}, caches=caches,
                      cache_index=lengths, decode=True, paged_view=view)
    for c in caches:
        c["k"][:, :9] = 0.0
    b = model.forward(params_t, cfg_p, {"tokens": tok}, caches=caches,
                      cache_index=lengths, decode=True, paged_view=view)
    assert not torch.allclose(a, b, atol=TOL)


# --------------------------------------------------------------- engine ----

def _recording(log):
    """model.forward of the port, logging each call's logits and the rows
    whose argmax the engine reads."""
    orig = model.forward

    def forward(*args, **kw):
        logits = orig(*args, **kw)
        used = [(b, 0) for b in range(logits.shape[0])] if kw.get("decode") \
            else [(b, logits.shape[1] - 1) for b in range(logits.shape[0])]
        log.append((logits.numpy().copy(), used))
        return logits
    return forward


def _run(b, requests, log_bounds=False):
    results, bounds = [], []
    while b.queue or b._jobs or any(b.active):
        if not b.step():
            break
        if log_bounds:
            bounds.append((b.lengths.tolist(), list(b.paged.host_boundaries)))
        for i in range(b.B):
            if not b.active[i] and b.outputs[i]:
                results.append(tuple(int(t) for t in b.outputs[i]))
                b.outputs[i] = []
    return sorted(results), bounds


@pytest.fixture(scope="module")
def served(setup, r1_patch):
    """The same request stream through the four layouts of both engines;
    small per-slot windows so decode crosses page boundaries."""
    cfg_j, params_j, cfg_t, params_t = setup
    plan_j = RefPlan(hot_window=MAX_SEQ // 2, slot_hot_windows=[4, 8],
                     page_tokens=PAGE)
    plan_t = PlacementPlan.from_dict(plan_j.to_dict())
    prompts = [_tokens(20 + i, p) for i, (p, _) in enumerate(REQUESTS)]
    layouts = {"base": (None, False, False), "concat": ("plan", False, False),
               "paged": ("plan", True, False), "pools": ("plan", True, True)}
    out = {}
    for name, (plan, paged, pools) in layouts.items():
        b_j = ref_engine.ContinuousBatcher(
            params_j, dataclasses.replace(cfg_j, use_paged_decode=pools),
            SLOTS, MAX_SEQ, plan=plan_j if plan else None, paged=paged)
        b_t = engine.ContinuousBatcher(
            params_t, dataclasses.replace(cfg_t, use_paged_decode=pools),
            SLOTS, MAX_SEQ, plan=plan_t if plan else None, paged=paged,
            device="cpu")
        for toks, (_, d) in zip(prompts, REQUESTS):
            b_j.submit(jnp.asarray(toks, jnp.int32), d)
            b_t.submit(torch.from_numpy(toks), d)
        out_j = sorted(tuple(int(t) for t in o) for o in b_j.run())
        log = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(model, "forward", _recording(log))
            out_t, bounds = _run(b_t, REQUESTS, log_bounds=paged and not pools)
        out[name] = dict(b_j=b_j, b_t=b_t, out_j=out_j, out_t=out_t,
                         bounds=bounds, log=log)
    return out, prompts, plan_t


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_tokens_match_reference(served, layout):
    r = served[0][layout]
    assert r["out_t"] == r["out_j"]
    assert len(r["out_t"]) == len(REQUESTS)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_migration_bytes_match_reference(served, layout):
    r = served[0][layout]
    c_t, c_j = r["b_t"].counters(), r["b_j"].counters()
    for key in ("sim_migration_bytes", "step_migration_bytes",
                "prefill_compute_tokens", "step_prefill_tokens",
                "table_version"):
        assert c_t[key] == c_j[key], key


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_token_margins(served, layout):
    """Every argmax the port's engine reads has a top-1/top-2 margin above
    10 x TOL, so the tokens above stand on logits that agree within TOL
    (test_prefill_decode_match_full_forward_and_reference)."""
    log = served[0][layout]["log"]
    assert log
    for logits, used in log:
        for b, row in used:
            top2 = np.sort(logits[b, row, :512])[-2:]
            assert top2[1] - top2[0] > 10 * TOL


def test_layouts_agree_within_port(served):
    out = served[0]
    assert out["base"]["out_t"] == out["concat"]["out_t"] == \
        out["paged"]["out_t"] == out["pools"]["out_t"]
    assert out["base"]["b_t"].sim_migration_bytes == 0


def test_paged_moves_fewer_bytes_than_concat(served):
    out = served[0]
    for side in ("b_t", "b_j"):
        paged = out["paged"][side].sim_migration_bytes
        assert 0 < paged < out["concat"][side].sim_migration_bytes
    assert out["paged"]["b_t"].sim_migration_bytes == \
        out["pools"]["b_t"].sim_migration_bytes


def test_per_slot_boundary_monotone_under_refill(served):
    """Within one residency a slot's boundary only advances, page-aligned
    and at or below its length; it resets only on a refill."""
    r = served[0]["paged"]
    b, log = r["b_t"], r["bounds"]
    assert any(any(bd > 0 for bd in bounds) for _, bounds in log)
    for (len_prev, bd_prev), (len_now, bd_now) in zip(log, log[1:]):
        for s in range(len(bd_now)):
            assert bd_now[s] % b.page_tokens == 0
            assert bd_now[s] <= len_now[s]
            if len_now[s] == len_prev[s] + 1:
                assert bd_now[s] >= bd_prev[s]
    b.ptable.check()


def test_paged_table_consistent_with_boundaries(served):
    b = served[0]["paged"]["b_t"]
    assert b.paged.boundaries.tolist() == b.paged.host_boundaries
    for s in range(b.B):
        assert b.ptable.cold_tokens(s) == b.paged.host_boundaries[s]


# ------------------------------------------------------------- generate ----

def test_generate_greedy_matches_reference(setup):
    cfg_j, params_j, cfg_t, params_t = setup
    toks = _tokens(30, (2, 6))
    want = ref_engine.generate(params_j, cfg_j,
                               {"tokens": jnp.asarray(toks, jnp.int32)}, 4)
    got = engine.generate(params_t, cfg_t, {"tokens": torch.from_numpy(toks)},
                          4)
    again = engine.generate(params_t, cfg_t,
                            {"tokens": torch.from_numpy(toks)}, 4)
    assert got.shape == (2, 4)
    assert got.tolist() == np.asarray(want).tolist() == again.tolist()
    first, _ = engine.make_prefill(cfg_t)(params_t,
                                          {"tokens": torch.from_numpy(toks)})
    assert got[:, 0].tolist() == \
        first[:, :cfg_t.vocab_size].argmax(-1).tolist()


def test_generate_samples_from_a_generator(setup):
    """Temperature sampling draws from the generator it is given: the same
    seed gives the same tokens, all in the real vocabulary."""
    _, _, cfg_t, params_t = setup
    prompts = {"tokens": torch.from_numpy(_tokens(31, (2, 5)))}
    scfg = engine.ServeConfig(temperature=1.5)
    runs = [engine.generate(params_t, cfg_t, prompts, 6, scfg,
                            generator=torch.Generator().manual_seed(4))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (2, 6)
    assert int(runs[0].max()) < cfg_t.vocab_size


def test_continuous_batching_matches_single_request(setup):
    """Ragged prompts through the all-HBM batcher == per-request greedy
    generate; an eos id stops a slot early."""
    _, _, cfg_t, params_t = setup
    prompts = [torch.tensor([3, 5, 7, 2]), torch.tensor([9, 1, 4, 4, 8, 2]),
               torch.tensor([2, 2, 6])]
    b = engine.ContinuousBatcher(params_t, cfg_t, 2, MAX_SEQ, device="cpu")
    for p in prompts:
        b.submit(p, 6)
    results = b.run()
    assert len(results) == 3
    singles = [engine.generate(params_t, cfg_t, {"tokens": p[None]},
                               6)[0].tolist() for p in prompts]
    assert sorted(results) == sorted(singles)
    eos = singles[0][2]
    b = engine.ContinuousBatcher(params_t, cfg_t, 2, MAX_SEQ,
                                 scfg=engine.ServeConfig(eos_id=eos),
                                 device="cpu")
    b.submit(prompts[0], 6)
    assert b.run() == [singles[0][:singles[0].index(eos, 1) + 1]]


# ------------------------------------------------- F1: stale slot length ----

# ROADMAP §3 F1: one request fills its slot to max_seq (28 prompt tokens,
# 5 decoded: its last write lands at row 31), the other decodes 7 steps
# more, so the lockstep decode writes the finished slot's row at index
# max_seq.  JAX's scatter drops that write; the port must drop it too.
F1_ARCHS = (ARCH, "deepseek-v2-lite-16b")
F1_REQUESTS = [(28, 5), (8, 12)]
F1_LAYOUTS = ("base", "concat", "paged")


def _dense_view(b):
    """The engine's whole dense cache, cold rows included."""
    if b.paged is not None:
        return b.paged.merged()
    return b.tiered.merged() if b.tiered is not None else b.caches


@pytest.fixture(scope="module")
def f1_runs(r1_patch):
    """F1's requests through the three dense layouts of both engines, for
    smollm-360m's GQA and deepseek-v2-lite's MLA latent (the reference's
    forward jitted for these runs, as test_torch_families_serve.py does).
    The port's engine is stepped by hand: when a slot finishes at max_seq,
    its rows are copied, and the steps it then spends inactive are
    counted."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_model, "forward", _jit_forward(ref_model.forward))
        return _f1_runs()


def _f1_runs():
    out = {}
    for arch in F1_ARCHS:
        cfg_j, cfg_t = ref_config(arch).reduced(), get_config(arch).reduced()
        params_j, _ = split_params(ref_model.init_params(
            jax.random.PRNGKey(0), cfg_j))
        params_t = params_from_jax(cfg_t, jax.tree.map(np.asarray, params_j),
                                   device="cpu")
        plan_j = RefPlan(hot_window=MAX_SEQ // 2, slot_hot_windows=[4, 8],
                         page_tokens=PAGE)
        plan_t = PlacementPlan.from_dict(plan_j.to_dict())
        prompts = [_tokens(40 + i, p) for i, (p, _) in enumerate(F1_REQUESTS)]
        for layout in F1_LAYOUTS:
            plan = None if layout == "base" else (plan_j, plan_t)
            b_j = ref_engine.ContinuousBatcher(
                params_j, cfg_j, SLOTS, MAX_SEQ, plan=plan and plan[0],
                paged=layout == "paged")
            b_t = engine.ContinuousBatcher(
                params_t, cfg_t, SLOTS, MAX_SEQ, plan=plan and plan[1],
                paged=layout == "paged", device="cpu")
            for toks, (_, d) in zip(prompts, F1_REQUESTS):
                b_j.submit(jnp.asarray(toks, jnp.int32), d)
                b_t.submit(torch.from_numpy(toks), d)
            out_j = sorted(tuple(int(t) for t in o) for o in b_j.run())
            results, frozen, after = [], {}, 0
            while b_t.queue or any(b_t.active):
                b_t.step()
                after += bool(frozen)
                for s in range(b_t.B):
                    if not b_t.active[s] and b_t.outputs[s]:
                        results.append(tuple(int(t) for t in b_t.outputs[s]))
                        b_t.outputs[s] = []
                        if b_t._host_len[s] == MAX_SEQ:
                            frozen[s] = [{k: a[s].clone() for k, a in
                                          layer.items()
                                          if k in kvcache.SEQ_KEYS}
                                         for layer in _dense_view(b_t)]
            out[arch, layout] = dict(b_j=b_j, out_j=out_j, b_t=b_t,
                                     out_t=sorted(results), frozen=frozen,
                                     after=after)
    return out


@pytest.mark.parametrize("layout", F1_LAYOUTS)
@pytest.mark.parametrize("arch", F1_ARCHS)
def test_stale_length_write_matches_reference(f1_runs, arch, layout):
    """The port serves F1's case where it used to raise IndexError: the
    reference's tokens and integer counters."""
    r = f1_runs[arch, layout]
    assert r["out_t"] == r["out_j"]
    assert sorted(len(o) for o in r["out_t"]) == \
        sorted(d for _, d in F1_REQUESTS)
    c_t, c_j = r["b_t"].counters(), r["b_j"].counters()
    for key in ("sim_migration_bytes", "step_migration_bytes",
                "prefill_compute_tokens", "step_prefill_tokens",
                "table_version"):
        assert c_t[key] == c_j[key], key
    assert c_t["decode_steps"] == len(c_j["step_migration_bytes"])


@pytest.mark.parametrize("layout", F1_LAYOUTS)
@pytest.mark.parametrize("arch", F1_ARCHS)
def test_stale_length_write_leaves_rows(f1_runs, arch, layout):
    """The finished slot decoded on at index max_seq for several steps, and
    every one of its in-range rows is as it was when it finished."""
    r = f1_runs[arch, layout]
    assert list(r["frozen"]) == [0] and r["after"] >= 6
    view = _dense_view(r["b_t"])
    for layer, rows in zip(view, r["frozen"][0]):
        assert rows
        for k, a in rows.items():
            assert torch.equal(layer[k][0], a), k


def test_write_rows_drops_out_of_range_slots():
    """write_rows at per-slot offsets: a slot at max_seq keeps its rows, the
    others take theirs; a scalar offset writes its slice."""
    from repro_torch.models.attention import write_rows
    buf = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    before = buf.clone()
    rows = -torch.ones(2, 1, 3)
    write_rows(buf, rows, torch.tensor([4, 1], dtype=torch.int32))
    assert torch.equal(buf[0], before[0])
    assert torch.equal(buf[1, 1], rows[1, 0])
    assert torch.equal(buf[1, [0, 2, 3]], before[1, [0, 2, 3]])
    write_rows(buf, -2 * torch.ones(2, 2, 3), 2)
    assert (buf[:, 2:] == -2).all() and torch.equal(buf[0, :2], before[0, :2])
