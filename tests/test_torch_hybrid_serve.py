"""The port's cached zamba2 path against the reference on
zamba2-7b.reduced() in fp32, with the reference's parameters and plan
carried across (params_from_jax, PlacementPlan.to_dict):

  * the single-token SSD step (ssd_decode_ref, ops.ssd_decode) and the
    chunked scan on a ragged S with a start state (ops.ssd), which pads to
    whole chunks before its dispatch, give the reference's y and state;
  * prefill and decode_step give the reference's logits and Mamba
    {"h", "conv"} state, and the full forward's logits;
  * the hybrid on the pools layout (a dense prefill, then admit_rows and
    splice_other) gives the reference engine's greedy tokens and integer
    counters, and both packages' predict_pool_counters(dense_admit=True);
    its tiered run gives its all-hot run's tokens.

Tolerances: TOL = 1e-4 absolute on logits and states (the same fp32 math
in another order), 1e-5 on one SSD step.  The engine's tokens stand on a
top-1/top-2 margin above 10 x TOL in every row whose argmax is read.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.models import kvcache as ref_kvcache
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro.runtime.plan import PlacementPlan as RefPlan
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.configs.base import MAMBA
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd as k4
from repro_torch.models import model
from repro_torch.runtime.plan import PlacementPlan
from repro_torch.serve import engine
from repro_torch.weights import params_from_jax

TOL = 1e-4
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "zamba2-7b"
MAX_SEQ, SLOTS, PAGE = 32, 2, 4


@pytest.fixture(scope="module")
def r1_patch():
    """The reference's tiered pools fail on this JAX (ROADMAP R1).  Patched
    for this module only, before any reference engine is built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_kvcache, "host_memory_kind", lambda: None)
        yield


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(ref_config(ARCH).reduced(),
                                use_paged_decode=True)
    params_j, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                     cfg_j))
    cfg_t = dataclasses.replace(get_config(ARCH).reduced(),
                                use_paged_decode=True)
    params_t = params_from_jax(cfg_t, jax.tree.map(np.asarray, params_j),
                               device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)


def _ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.5):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    dt = np.log1p(np.exp(r(B, S, H, scale=1.0)))          # softplus
    A = -np.exp(r(H, scale=0.3))
    return [r(B, S, H, P), dt, A, r(B, S, N), r(B, S, N)], r(B, H, P, N)


# ------------------------------------------------------------------ SSD ----

def test_ssd_decode_matches_reference():
    (x, dt, A, Bm, Cm), h = _ssd_inputs(1, 2, 1, 4, 8, 16)
    args = (h, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
    y_j, h_j = ref_kernels.ssd_decode_ref(*map(jnp.asarray, args))
    y, h2 = ref.ssd_decode_ref(*map(torch.from_numpy, args))
    assert ops.ssd_decode is ref.ssd_decode_ref
    assert y.shape == (2, 4, 8) and h2.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **STEP_TOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h_j), **STEP_TOL)


@pytest.mark.parametrize("S", [13, 20, 8, 5])
def test_ragged_ssd_with_h0_matches_reference(S):
    """A ragged S (13, 20 against a chunk of 8), a whole one and S < chunk,
    each from a start state: the reference's ops.ssd (its chunked oracle)
    and the port's give the same y and state."""
    args, h0 = _ssd_inputs(2, 2, S, 4, 8, 16)
    y_j, h_j = ref_ops.ssd(*map(jnp.asarray, args), chunk=8,
                           h0=jnp.asarray(h0))
    y, h = ops.ssd(*map(torch.from_numpy, args), chunk=8,
                   h0=torch.from_numpy(h0))
    assert y.shape == (2, S, 4, 8)
    _close(y, y_j)
    _close(h, h_j)


def test_ssd_dispatch_sees_whole_chunks(monkeypatch):
    """ops.ssd hands its dispatch target only whole chunks, the kernel's
    contract (ssd.check_chunk), and cuts y back to S."""
    seen = []
    plain = ref.ssd_chunked_ref

    def strict(x, *rest, chunk, h0):
        seen.append(k4.check_chunk(x.shape[1], chunk))
        return plain(x, *rest, chunk=chunk, h0=h0)

    monkeypatch.setattr(ref, "ssd_chunked_ref", strict)
    args, h0 = _ssd_inputs(3, 1, 21, 2, 8, 16)
    t = [torch.from_numpy(a) for a in args]
    y, h = ops.ssd(*t, chunk=8, h0=torch.from_numpy(h0))
    y_want, h_want = plain(*t, chunk=8, h0=torch.from_numpy(h0))
    assert seen == [8] and y.shape == (1, 21, 2, 8)
    assert torch.equal(y, y_want) and torch.equal(h, h_want)


# ------------------------------------------------ prefill, decode_step ----

def _mamba_layers(cfg):
    return [l for l in range(cfg.num_layers) if cfg.layer_kind(l) == MAMBA]


def _ref_layer(cfg, caches, l):
    """Layer l's entry of the reference's cache tree."""
    n = len(cfg.prologue)
    if l < n:
        return caches["prologue"][l]
    p, s = divmod(l - n, cfg.period_len)
    return jax.tree.map(lambda a: a[p], caches["slots"][s])


def test_prefill_decode_match_reference(setup):
    """Logits after a ragged prefill (S 10 against a chunk of 8) and two
    decode steps equal the reference's and the full forward's; so does
    every Mamba layer's {"h", "conv"} state and every shared-block KV."""
    cfg_j, params_j, cfg_t, params_t = setup
    cfg_j = dataclasses.replace(cfg_j, use_paged_decode=False)
    B, S = 2, 12
    toks = np.random.default_rng(4).integers(0, 512, (B, S))
    tj = jnp.asarray(toks, jnp.int32)
    full = model.forward(params_t, cfg_t, {"tokens": torch.from_numpy(toks)})
    last_j, c_j = ref_model.prefill(params_j, cfg_j, {"tokens": tj[:, :10]},
                                    max_seq=S)
    last, c = model.prefill(params_t, cfg_t,
                            {"tokens": torch.from_numpy(toks[:, :10])},
                            max_seq=S)
    _close(last, last_j)
    _close(last, full[:, 9].numpy())
    for t, index in ((10, 10), (11, torch.full((B,), 11, dtype=torch.int32))):
        lg_j, c_j = ref_model.decode_step(
            params_j, cfg_j, tj[:, t:t + 1], c_j,
            jnp.asarray(np.asarray(index), jnp.int32))
        lg, c = model.decode_step(params_t, cfg_t,
                                  torch.from_numpy(toks[:, t:t + 1]), c,
                                  index)
        _close(lg, lg_j)
        _close(lg, full[:, t].numpy())
    for l in range(cfg_t.num_layers):
        want = _ref_layer(cfg_j, c_j, l)
        assert set(c[l]) == set(want)
        for k in want:
            assert c[l][k].dtype == torch.float32
            _close(c[l][k], want[k])
    assert set(c[_mamba_layers(cfg_t)[0]]) == {"h", "conv"}


# ---------------------------------------------------------------- engine ----

def _requests(cfg):
    """Three requests, two sharing a prefix: ragged prompts, a shared page
    that the dense admission maps onto the donor's."""
    rng = np.random.default_rng(5)
    sys_p = rng.integers(0, cfg.vocab_size, 9)
    return [(np.concatenate([sys_p, rng.integers(0, cfg.vocab_size, 4)]),
             6, "sys"),
            (rng.integers(0, cfg.vocab_size, 11), 5, None),
            (np.concatenate([sys_p, rng.integers(0, cfg.vocab_size, 2)]),
             6, "sys")]


def _drive(b, reqs, tensor):
    for toks, d, key in reqs:
        b.submit(tensor(toks), d, prefix_key=key)
    out = []
    while b.queue or b._jobs or any(b.active):
        if not b.step():
            break
        for i in range(b.B):
            if not b.active[i] and b.outputs[i]:
                out.append(tuple(int(t) for t in b.outputs[i]))
                b.outputs[i] = []
    return sorted(out)


def _margins(log):
    """Every argmax the engine reads has a top-1/top-2 margin > 10 TOL."""
    assert log
    for logits, rows in log:
        for b, row in rows:
            top2 = np.sort(logits[b, row, :512])[-2:]
            assert top2[1] - top2[0] > 10 * TOL


@pytest.fixture(scope="module")
def served(setup, r1_patch):
    cfg_j, params_j, cfg_t, params_t = setup
    plan_j = RefPlan(hot_window=8, slot_hot_windows=[4, 8], page_tokens=PAGE)
    plan_t = PlacementPlan.from_dict(plan_j.to_dict())
    reqs = _requests(cfg_t)
    b_j = ref_engine.ContinuousBatcher(params_j, cfg_j, SLOTS, MAX_SEQ,
                                       plan=plan_j, paged=True)
    out_j = _drive(b_j, reqs, lambda t: jnp.asarray(t, jnp.int32))
    log = []
    orig = model.forward

    def recording(*args, **kw):
        logits = orig(*args, **kw)
        n = logits.shape[0]
        rows = [(b, 0) for b in range(n)] if kw.get("decode") \
            else [(b, logits.shape[1] - 1) for b in range(n)]
        log.append((logits.numpy().copy(), rows))
        return logits

    b_t = engine.ContinuousBatcher(params_t, cfg_t, SLOTS, MAX_SEQ,
                                   plan=plan_t, paged=True, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(model, "forward", recording)
        out_t = _drive(b_t, reqs, torch.from_numpy)
    all_hot = dataclasses.replace(plan_t, hot_window=MAX_SEQ,
                                  slot_hot_windows=[MAX_SEQ] * SLOTS)
    b_h = engine.ContinuousBatcher(params_t, cfg_t, SLOTS, MAX_SEQ,
                                   plan=all_hot, paged=True, device="cpu")
    out_h = _drive(b_h, reqs, torch.from_numpy)
    preq = [(tuple(int(x) for x in t), d, None, k) for t, d, k in reqs]
    pred = {ns.__name__: ns.predict_pool_counters(
        preq, p, slots=SLOTS, max_seq=MAX_SEQ, page_tokens=PAGE,
        row_bytes=b_t._row_bytes, dense_admit=True)
        for ns, p in ((ref_engine, plan_j), (engine, plan_t))}
    return dict(b_j=b_j, out_j=out_j, b_t=b_t, out_t=out_t, b_h=b_h,
                out_h=out_h, log=log, pred=pred, reqs=reqs)


def test_hybrid_engine_tokens_match_reference(served):
    assert served["out_t"] == served["out_j"]
    assert len(served["out_t"]) == 3
    _margins(served["log"])


def test_hybrid_engine_counters_match_reference(served):
    c_t, c_j = served["b_t"].counters(), served["b_j"].counters()
    for key in ("sim_migration_bytes", "step_migration_bytes", "page_copies",
                "admit_page_writes", "table_uploads", "repacks",
                "prefill_compute_tokens", "prefill_skipped_tokens",
                "table_version", "step_prefill_tokens"):
        assert c_t[key] == c_j[key], key
    assert c_t["page_copies"] > 0 and c_t["decode_steps"] > 0
    # the shared system prompt's full pages map onto the donor's: fewer
    # pages written than the prompts fill
    assert c_t["admit_page_writes"] < sum(-(-len(t) // PAGE)
                                          for t, _, _ in served["reqs"])


def test_hybrid_engine_counters_match_prediction(served):
    c = served["b_t"].counters()
    for pred in served["pred"].values():
        assert pred["migration_bytes"] == c["sim_migration_bytes"]
        assert pred["step_migration_bytes"] == c["step_migration_bytes"]
        assert pred["page_copies"] == c["page_copies"]
        assert pred["admit_page_writes"] == c["admit_page_writes"]


def test_hybrid_tiered_equals_all_hot(served):
    assert served["out_t"] == served["out_h"]
    assert served["b_h"].counters()["page_copies"] == 0
    served["b_t"].ptable.check()


def test_hybrid_pools_hold_only_attention_layers(served):
    """The pools hold the shared block's uses only; every MAMBA layer's
    dense batched state lives in the tree beside them."""
    b = served["b_t"]
    cfg = b.cfg
    attn = [l for l in range(cfg.num_layers) if cfg.layer_kind(l) != MAMBA]
    assert sorted(b.pool.pool_of) == attn
    assert b.pool.k_hot.shape[0] == len(attn) == cfg.num_periods
    for l in _mamba_layers(cfg):
        assert set(b.pool.tree[l]) == {"h", "conv"}
        assert b.pool.tree[l]["h"].shape[0] == SLOTS
