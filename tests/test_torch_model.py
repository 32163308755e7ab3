"""The port's model against the reference's on smollm-360m.reduced() in
fp32, with the reference's parameters carried across by params_from_jax:
a full forward without a cache, suffix prefill into the page pools forking
at a page edge and mid-page (with a cold page below the fork), and three
decode steps through the pools (hot and cold pages).  Each also runs on the
same config with a sliding-window layer, an attention softcap and gelu.
Logits agree at atol 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro_torch.configs.base import ATTN, LOCAL
from repro.models import kvcache as ref_kvcache
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro_torch.configs import get_config
from repro_torch.models import kvcache, model
from repro_torch.weights import params_from_jax

MAX_SEQ, SLOTS, PAGE = 32, 2, 4
TOL = dict(atol=1e-4, rtol=0.0)


@pytest.fixture(scope="module")
def r1_patch():
    """The reference's tiered pools fail on this JAX (ROADMAP R1): its host
    memory kind cannot mix with device arrays in eager ops.  Patched for
    this module only, before any reference pool is built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_kvcache, "host_memory_kind", lambda: None)
        yield


def _both(**fields):
    """The reduced config in both packages (with ``fields`` replaced) and
    the reference's parameters carried across."""
    cfg_j = dataclasses.replace(ref_config("smollm-360m").reduced(), **fields)
    params_j, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                     cfg_j))
    cfg_t = dataclasses.replace(get_config("smollm-360m").reduced(), **fields)
    params_t = params_from_jax(cfg_t, jax.tree.map(np.asarray, params_j),
                               device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def setup():
    return _both()


@pytest.fixture(scope="module")
def setup_local():
    """A sliding-window layer before a global one, with an attention softcap
    and gelu: the window and the softcap reach the decode kernel, and the
    window skips whole cold pages there."""
    return _both(period=(LOCAL, ATTN), sliding_window=5, attn_softcap=2.0,
                 act="gelu")


def _toks(seed, shape, cfg):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(got, want):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL)


def test_config_copy_matches_reference():
    for name in ("smollm-360m",):
        a, b = ref_config(name), get_config(name)
        for cfg_j, cfg_t in ((a, b), (a.reduced(), b.reduced())):
            for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                      "d_ff", "vocab_size", "head_dim", "period",
                      "padded_vocab", "num_periods", "dtype", "rope_theta",
                      "norm_eps", "act", "tie_embeddings"):
                assert getattr(cfg_j, f) == getattr(cfg_t, f), f


def _full_forward(cfg_j, params_j, cfg_t, params_t):
    toks = _toks(1, (2, 13), cfg_t)
    want, _, _ = ref_model.forward(params_j, cfg_j,
                                   {"tokens": jnp.asarray(toks, jnp.int32)})
    got = model.forward(params_t, cfg_t, {"tokens": torch.from_numpy(toks)})
    _close(got, want)


def test_full_forward_matches_reference(setup):
    _full_forward(*setup)


def test_local_layers_full_forward_matches_reference(setup_local):
    _full_forward(*setup_local)


def _pool_chunk(pool, params, cfg, slot, toks, start, end):
    """Prefill tokens[start:end] of ``slot`` into the port's pools."""
    for _ in range(pool.table.n_pages[slot], -(-end // PAGE)):
        pool.table.alloc(slot, 0)
    table, tier = pool.arrays()
    th, ti = pool.host_row(slot)
    view = {"page_table": table[slot][None], "page_tier": tier[slot][None],
            "page_table_host": th, "page_tier_host": ti, "page_tokens": PAGE,
            "active": None, "prefill": True}
    return model.prefill_suffix(
        params, cfg, {"tokens": torch.from_numpy(toks[start:end])[None]},
        caches=pool.tree, start=start, paged_view=view)


def _prefill_fork(cfg_j, params_j, cfg_t, params_t, fork):
    """Prefix then suffix into the pools (the first page demoted to the
    cold pool in between) gives the reference full prefill's logits: the
    prefix chunk's last row and the suffix's last row."""
    S = 3 * PAGE + 1
    toks = _toks(3, (S,), cfg_t)
    full, _, _ = ref_model.forward(params_j, cfg_j,
                                   {"tokens": jnp.asarray(toks[None],
                                                          jnp.int32)})
    pool = kvcache.PagedKVPools(cfg_t, SLOTS, MAX_SEQ, PAGE, torch.float32,
                                "cpu")
    first = _pool_chunk(pool, params_t, cfg_t, 1, toks, 0, fork)
    assert pool.demote_boundary(1)
    last = _pool_chunk(pool, params_t, cfg_t, 1, toks, fork, S)
    _close(first, full[:, fork - 1])
    _close(last, full[:, -1])
    assert pool.stats["page_copies"] == 1
    pool.table.check()


@pytest.mark.parametrize("fork", [PAGE, 2 * PAGE, PAGE + 2, 2 * PAGE + 3])
def test_prefill_suffix_into_pools_matches_reference(setup, fork):
    _prefill_fork(*setup, fork)


@pytest.mark.parametrize("fork", [PAGE, 2 * PAGE + 3])
def test_local_layers_prefill_suffix_matches_reference(setup_local, fork):
    _prefill_fork(*setup_local, fork)


def test_pools_copy_on_write_and_shared_demotion_move_page_data(setup):
    """Two sharers demoting one page copy its bytes once (a cold twin);
    copy-on-write of a shared cold page and of a shared hot page gives the
    writer a private page holding the same data."""
    cfg_t = setup[2]
    pool = kvcache.PagedKVPools(cfg_t, SLOTS, MAX_SEQ, PAGE, torch.float32,
                                "cpu")
    for _ in range(3):
        pool.table.alloc(0, 0)
    g = torch.Generator().manual_seed(0)
    pool.k_hot.copy_(torch.randn(pool.k_hot.shape, generator=g))
    pool.v_hot.copy_(torch.randn(pool.v_hot.shape, generator=g))
    want = [(pool.k_hot[:, p].clone(), pool.v_hot[:, p].clone())
            for p in pool.table.table[0][:3]]
    pool.table.share(1, 0, 2)
    assert pool.demote_boundary(0)          # the first sharer copies a twin
    assert not pool.demote_boundary(1)      # the second reuses it
    t = pool.table
    assert t.table[1][0] == t.table[0][0] and t.tier[1][0] == 1
    assert pool.cow_for_write(1, 0)         # shared cold page
    assert pool.cow_for_write(1, PAGE)      # shared hot page
    assert not pool.cow_for_write(1, PAGE)  # now private
    for i in (0, 1):
        k, v = (pool.k_cold, pool.v_cold) if t.tier[1][i] else \
            (pool.k_hot, pool.v_hot)
        assert t.table[1][i] != t.table[0][i]
        assert torch.equal(k[:, t.table[1][i]], want[i][0])
        assert torch.equal(v[:, t.table[1][i]], want[i][1])
    assert torch.equal(pool.k_cold[:, t.table[0][0]], want[0][0])
    assert pool.stats["page_copies"] == 3
    t.check()


def _ref_decode(cfg_j, params_j, prompts, demote, steps):
    """Reference: prefill each slot into PagedKVPools, demote, decode."""
    cfg = dataclasses.replace(cfg_j, use_paged_decode=True)
    pool = ref_kvcache.PagedKVPools(cfg, SLOTS, MAX_SEQ, PAGE, jnp.float32)
    for slot, toks in enumerate(prompts):
        for _ in range(-(-len(toks) // PAGE)):
            pool.table.alloc(slot, 0)
        table, tier = pool.arrays()
        view = {"page_table": table[slot][None],
                "page_tier": tier[slot][None], "page_tokens": PAGE,
                "active": None, "prefill": True}
        _, pool.tree = ref_model.prefill_suffix(
            params_j, cfg, {"tokens": jnp.asarray(toks[None], jnp.int32)},
            caches=pool.tree, start=0, paged_view=view)
        for _ in range(demote[slot]):
            pool.demote_boundary(slot)
    lengths = [len(t) for t in prompts]
    out = []
    for tok in steps:
        for s in range(SLOTS):
            pool.ensure_write_page(s, lengths[s])
        view = pool.paged_view(jnp.ones((SLOTS,), bool))
        logits, pool.tree, _ = ref_model.forward(
            params_j, cfg, {"tokens": jnp.asarray(tok[:, None], jnp.int32)},
            caches=pool.tree, cache_index=jnp.asarray(lengths, jnp.int32),
            decode=True, paged_view=view)
        out.append(np.array(logits))
        lengths = [n + 1 for n in lengths]
    return out


def _pool_decode(cfg_j, params_j, cfg_t, params_t):
    """Three decode steps through the pools, two slots of different
    lengths with cold prefixes, fed the same tokens in both packages."""
    prompts = [_toks(4, (6,), cfg_t), _toks(5, (11,), cfg_t)]
    demote = [1, 2]
    steps = [_toks(6 + i, (SLOTS,), cfg_t) for i in range(3)]
    want = _ref_decode(cfg_j, params_j, prompts, demote, steps)

    pool = kvcache.PagedKVPools(cfg_t, SLOTS, MAX_SEQ, PAGE, torch.float32,
                                "cpu")
    for slot, toks in enumerate(prompts):
        _pool_chunk(pool, params_t, cfg_t, slot, toks, 0, len(toks))
        for _ in range(demote[slot]):
            pool.demote_boundary(slot)
    lengths = torch.tensor([len(t) for t in prompts], dtype=torch.int32)
    for tok, ref_logits in zip(steps, want):
        for s in range(SLOTS):
            pool.ensure_write_page(s, int(lengths[s]))
        view = pool.paged_view(torch.ones(SLOTS, dtype=torch.bool))
        logits = model.forward(params_t, cfg_t,
                               {"tokens": torch.from_numpy(tok)[:, None]},
                               caches=pool.tree, cache_index=lengths,
                               decode=True, paged_view=view)
        _close(logits, ref_logits)
        lengths = lengths + 1
    assert any(t == 1 for row in pool.table.tier for t in row)


def test_pool_decode_matches_reference(setup, r1_patch):
    _pool_decode(*setup)


def test_local_layers_pool_decode_matches_reference(setup_local, r1_patch):
    _pool_decode(*setup_local)
