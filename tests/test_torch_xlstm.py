"""The port's xLSTM and LSTM stacks (xlstm-1.3b, the paper's lstm-ptb)
against the reference, on their ``.reduced()`` configs in fp32 with the
reference's parameters carried across by params_from_jax:

  * the oracles ``mlstm_ref``, ``mlstm_chunked_ref`` and ``slstm_ref``
    against ``repro.kernels.ref`` over test_kernels.py's sweeps (the
    long-sequence stability case, chunked == sequential with a carried
    state), and ``ops.mlstm``'s selection of the two;
  * each block's output and state, forward, prefill and decode;
  * the config facts, every parameter leaf and AdamW moment, the cache
    leaves;
  * the loss and every gradient in Sentinel's four modes at MI 1 and 2
    against the reference's jitted ``value_and_grad`` (compiled once per
    arch, in its full mode: ``reference_grads``) and the port's full mode,
    each gradient finite (the stabilizer starts at m = -inf), sequential
    and chunked;
  * (in ``tests/test_torch_xlstm_profile.py``) test_system.py's Fig. 10
    shape on the port's own profile of lstm-ptb, with the MI each package
    plans pinned, the profile through the recurrences, and the training
    and serving CLIs on both archs.

Tolerances: TOL (atol 1e-4) on logits and block outputs, the same fp32
math in another order; ORACLE_TOL (atol 2e-5, rtol 1e-5) between the two
packages' oracles on the same inputs; CHUNK_TOL (atol 2e-4), the
reference's own bound between the chunked and the sequential mLSTM; the
loss and gradients at test_torch_train.py's LOSS_TOL and GRAD_TOL.  The
mLSTM's normaliser, max(|n.q|, exp(-m)), amplifies rounding, and the
reduced xlstm in fp32 is ill-conditioned in both packages alike: its
logits lie 9.1e-5 (the port) and 1.0e-4 (the reference) from the port's
float64 forward at a logit scale of 4, its gradients up to 1.4e-3 and
2.1e-3 from float64 where a leaf's largest value is 31-37 (measured on
this case).  So where the reference's values set the scale, the mLSTM's
results are also allowed XLSTM_REL (1e-4) of the largest |value| of the
tensor compared, ORACLE_REL (2e-5) for the bare oracle, and
``test_xlstm_fp32_is_within_its_float64`` holds the port's fp32 to its own
float64 at XLSTM_REL.  The chunked mLSTM rounds more: its fp32 gradients
lie up to 1.3e-4 (the port) and 7e-5 (the reference) of a leaf's largest
|value| from float64, 1.9e-4 from each other, so the chunked training case
takes CHUNKED_REL (4e-4).  lstm-ptb is held at the plain tolerances.  Inputs
are made with numpy from a seed."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.models import kvcache as ref_kvcache
from repro.models import model as ref_model
from repro.models import xlstm as ref_xlstm
from repro.models.layers import split_params
from repro_torch.configs import get_config
from repro_torch.configs.base import LSTM, MLSTM, SLSTM
from repro_torch.core import offload
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import kvcache, model, xlstm
from repro_torch.weights import (opt_state_from_jax, params_from_jax,
                                 reference_leaf)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("lstm-ptb", "xlstm-1.3b")
MODES = ["full", "remat", "save_hbm", "offload"]
TOL = dict(atol=1e-4, rtol=0.0)
ORACLE_TOL = dict(atol=2e-5, rtol=1e-5)
CHUNK_TOL = dict(atol=2e-4, rtol=0.0)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
XLSTM_REL = 1e-4
ORACLE_REL = 2e-5
CHUNKED_REL = 4e-4
REL = {"lstm-ptb": 0.0, "xlstm-1.3b": XLSTM_REL}
# the reference's names of each cache kind's state tuple
STATE_NAMES = {MLSTM: ("C", "n", "m"), SLSTM: ("c", "n", "m", "h")}


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL, rel=0.0, msg=None):
    """``got`` within ``tol`` of ``want``, the absolute part widened to
    ``rel`` x the largest |want| where that is larger."""
    want = _t(want)
    atol = max(tol["atol"], rel * float(want.abs().max()))
    torch.testing.assert_close(got.float(), want, atol=atol,
                               rtol=tol["rtol"], msg=msg)


def _toks(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for the module, restored after: these tests
    run thousands of tiny eager ops, and under the test runner's parallel
    workers torch's own threads oversubscribe the cores (the reduced
    xlstm's remat step took 120.6 s on 8 threads beside five busy
    processes, 5.5 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def chunk_mode():
    """Set both packages' mLSTM chunk mode; both back to sequential
    after."""
    def set_mode(c):
        ops.mlstm_chunk_mode(c)
        ref_ops.mlstm_chunk_mode(c)
    yield set_mode
    set_mode(0)


@pytest.fixture(scope="module")
def both():
    """Each arch's reduced config in both packages and the reference's
    parameters carried across, built once."""
    out = {}
    for arch in ARCHS:
        cfg_j, cfg_t = ref_config(arch).reduced(), get_config(arch).reduced()
        params_j, _ = split_params(ref_model.init_params(
            jax.random.PRNGKey(0), cfg_j))
        params_t = params_from_jax(cfg_t, jax.tree.map(np.asarray, params_j),
                                   device="cpu")
        out[arch] = (cfg_j, params_j, cfg_t, params_t)
    return out


# -------------------------------------------------------------- oracles ----

def _mlstm_inputs(seed, B, S, H, Dk, Dv, li_scale=2.0, lf_shift=1.0):
    rng = np.random.default_rng(seed)
    q, k = _rand(rng, B, S, H, Dk), _rand(rng, B, S, H, Dk)
    v = _rand(rng, B, S, H, Dv)
    li = _rand(rng, B, S, H, scale=li_scale)
    lf = np.asarray(jax.nn.log_sigmoid(_rand(rng, B, S, H) + lf_shift))
    return q, k, v, li, lf


CHUNK_SWEEP = [(2, 64, 2, 8, 16, 16), (1, 128, 4, 16, 16, 32),
               (2, 96, 3, 8, 8, 8)]


@pytest.mark.parametrize("B,S,H,Dk,Dv,chunk", CHUNK_SWEEP)
def test_mlstm_oracles_match_reference(B, S, H, Dk, Dv, chunk):
    """Both mLSTM oracles against the reference's on the same inputs, from
    the empty state and from a carried one: outputs and every state
    leaf."""
    x = _mlstm_inputs(B * S + H, B, S, H, Dk, Dv)
    xt = [_t(a) for a in x]
    xj = [jnp.asarray(a) for a in x]
    _, carried = jref.mlstm_ref(*xj)
    for state_j, state_t in ((None, None),
                             (carried, tuple(_t(s) for s in carried))):
        for fn_t, fn_j, kw in ((ref.mlstm_ref, jref.mlstm_ref, {}),
                               (ref.mlstm_chunked_ref, jref.mlstm_chunked_ref,
                                {"chunk": chunk})):
            h_t, s_t = fn_t(*xt, state=state_t, **kw)
            h_j, s_j = fn_j(*xj, state=state_j, **kw)
            _close(h_t, h_j, ORACLE_TOL, ORACLE_REL)
            for a, b in zip(s_t, s_j):
                assert a.dtype == torch.float32
                _close(a, b, ORACLE_TOL, ORACLE_REL)


def test_mlstm_stability_long_sequence():
    """Stabilized gates: no overflow with extreme input-gate logits, and
    the reference's values."""
    x = _mlstm_inputs(5, 1, 64, 2, 8, 8, li_scale=10.0, lf_shift=0.0)
    h, (C, n, m) = ref.mlstm_ref(*[_t(a) for a in x])
    assert bool(torch.isfinite(h).all()) and bool(torch.isfinite(C).all())
    h_j, (C_j, _, m_j) = jref.mlstm_ref(*[jnp.asarray(a) for a in x])
    _close(h, h_j, ORACLE_TOL, ORACLE_REL)
    _close(m, m_j, ORACLE_TOL, ORACLE_REL)


@pytest.mark.parametrize("B,S,H,Dk,Dv,chunk", CHUNK_SWEEP)
def test_mlstm_chunked_matches_sequential(B, S, H, Dk, Dv, chunk):
    """test_kernels.py's case on the port: chunked == sequential, and the
    two final states, stabilizer-scaled, continue alike."""
    x = [_t(a) for a in _mlstm_inputs(7 + chunk, B, S, H, Dk, Dv)]
    h0, s0 = ref.mlstm_ref(*x)
    h1, s1 = ref.mlstm_chunked_ref(*x, chunk=chunk)
    torch.testing.assert_close(h1, h0, **CHUNK_TOL)
    h0c, _ = ref.mlstm_ref(*x, state=s0)
    h1c, _ = ref.mlstm_ref(*x, state=s1)
    torch.testing.assert_close(h1c, h0c, **CHUNK_TOL)
    h2c, _ = ref.mlstm_chunked_ref(*x, chunk=chunk, state=s1)
    torch.testing.assert_close(h2c, h0c, **CHUNK_TOL)


def test_mlstm_chunked_refuses_a_ragged_sequence():
    x = [_t(a) for a in _mlstm_inputs(3, 1, 24, 2, 8, 8)]
    with pytest.raises(AssertionError):
        ref.mlstm_chunked_ref(*x, chunk=16)


def test_ops_mlstm_selects_as_the_reference(chunk_mode):
    """Chunked only with a chunk mode, S > 1 and S whole chunks; else the
    sequential scan (the reference's rule, ops.py:85-90)."""
    x = [_t(a) for a in _mlstm_inputs(4, 2, 32, 2, 8, 8)]
    seq = ref.mlstm_ref(*x)[0]
    chunked = ref.mlstm_chunked_ref(*x, chunk=16)[0]
    assert not torch.equal(seq, chunked)
    assert torch.equal(ops.mlstm(*x)[0], seq)
    chunk_mode(16)
    assert torch.equal(ops.mlstm(*x)[0], chunked)
    for sl in (slice(0, 24), slice(0, 1)):      # ragged; one token
        part = [a[:, sl] for a in x]
        assert torch.equal(ops.mlstm(*part)[0], ref.mlstm_ref(*part)[0])


def test_slstm_matches_reference_and_is_recurrent():
    """test_kernels.py's sLSTM case on the port, against the reference's
    oracle, from the empty state and from a carried one."""
    rng = np.random.default_rng(8)
    x, r = _rand(rng, 2, 32, 2, 4, 8), _rand(rng, 2, 4, 8, 8, scale=0.1)
    h, state = ref.slstm_ref(_t(x), r_ifzo=_t(r))
    assert h.shape == (2, 32, 2, 8) and bool(torch.isfinite(h).all())
    h_j, state_j = jref.slstm_ref(jnp.asarray(x), r_ifzo=jnp.asarray(r))
    _close(h, h_j, ORACLE_TOL)
    for a, b in zip(state, state_j):
        _close(a, b, ORACLE_TOL)
    h2, _ = ref.slstm_ref(_t(x), r_ifzo=torch.zeros(2, 4, 8, 8))
    assert not torch.allclose(h, h2)
    hc, _ = ref.slstm_ref(_t(x), state=state, r_ifzo=_t(r))
    hc_j, _ = jref.slstm_ref(jnp.asarray(x), state=state_j,
                             r_ifzo=jnp.asarray(r))
    _close(hc, hc_j, ORACLE_TOL)


# --------------------------------------------------------------- configs ----

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_the_reference(arch):
    """Every field equals the reference's, full and reduced: the port has
    every field of the reference's config, the codebook and prefix-LM
    ones (at their defaults here) among them."""
    for cfg_t, cfg_j in ((get_config(arch), ref_config(arch)),
                         (get_config(arch).reduced(),
                          ref_config(arch).reduced())):
        t, j = dataclasses.asdict(cfg_t), dataclasses.asdict(cfg_j)
        assert t == j
        assert (t["prefix_lm"], t["num_codebooks"],
                t["num_prefix_tokens"]) == (False, 0, 0)
        assert cfg_t.padded_vocab == cfg_j.padded_vocab
        assert cfg_t.num_periods == cfg_j.num_periods


def test_config_facts():
    """test_configs_smoke.py's xlstm facts; lstm-ptb is the medium PTB LSTM
    (2 x 650, vocab 10000) with an untied head; xlstm-1.3b, as the
    reference builds it (dense q/k/v), holds about 2.72 B parameters."""
    x = get_config("xlstm-1.3b")
    assert x.d_ff == 0 and x.period.count("mlstm") == 7
    assert x.num_periods == 6 and x.period.count("slstm") == 1
    p = get_config("lstm-ptb")
    assert (p.num_layers, p.d_model, p.vocab_size, p.num_periods) == \
        (2, 650, 10_000, 2)
    assert not p.tie_embeddings and p.padded_vocab == 10_000
    n = sum(t.numel() for t in model.init_params(x, device="meta")
            .parameters())
    assert n == 2_723_112_960
    assert sum(t.numel() for t in model.init_params(p, device="meta")
               .parameters()) == 19_765_850


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_carry_every_leaf(both, arch):
    cfg_j, params_j, cfg_t, params_t = both[arch]
    assert sum(p.numel() for p in params_t.parameters()) == \
        sum(int(a.size) for a in jax.tree.leaves(params_j))
    for name, p in params_t.named_parameters():
        assert tuple(np.shape(reference_leaf(cfg_t, params_j, name))) == \
            tuple(p.shape), name


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_carries_every_leaf(both, arch):
    """opt_state_from_jax carries a reference AdamW state (moments shaped
    as the parameters, random here) into the port's layout, leaf for
    leaf."""
    cfg_j, params_j, cfg_t, params_t = both[arch]
    rng = np.random.default_rng(5)
    state = {k: jax.tree.map(lambda a: rng.standard_normal(a.shape)
                             .astype(np.float32), _numpy(params_j))
             for k in ("m", "v")}
    state["count"] = np.int32(3)
    got = opt_state_from_jax(cfg_t, params_t, state)
    assert int(got["count"]) == 3
    for k in ("m", "v"):
        assert set(got[k]) == {n for n, _ in params_t.named_parameters()}
        for name, t in got[k].items():
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(
                t.numpy(), reference_leaf(cfg_t, state[k], name))


def test_init_draws_the_reference_scales():
    """init_params' own draws: the norms at one, the LSTM bias at zero,
    the convs N(0, 1/4), the sLSTM's recurrent weights N(0, 1/D)."""
    cfg = get_config("xlstm-1.3b").reduced()
    params = model.init_params(cfg, device="cpu")
    H, D = xlstm.slstm_dims(cfg)
    s = params.layers[7].slstm
    assert bool((s.norm == 1).all()) and bool((s.conv_b == 0).all())
    assert abs(float(s.r_ifzo.std()) - D ** -0.5) < 0.02
    assert abs(float(params.layers[0].mlstm.conv_w.std()) - 0.5) < 0.05
    lstm = model.init_params(get_config("lstm-ptb").reduced(),
                             device="cpu").layers[0].lstm
    assert bool((lstm.b == 0).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_leaves_match_reference(arch):
    """Each layer's cache: the reference's leaves under flat names (its
    state tuples named), same shapes, dtypes and values (m at -inf); no
    sequence leaf and no KV bytes a token."""
    cfg_j, cfg_t = ref_config(arch).reduced(), get_config(arch).reduced()
    want = ref_kvcache.init_cache(cfg_j, 2, 32, jnp.float32)
    got = kvcache.init_cache(cfg_t, 2, 32, torch.float32, "cpu")
    assert len(got) == cfg_t.num_layers
    for l, layer in enumerate(got):
        kind = cfg_t.layer_kind(l)
        ref_layer = jax.tree.map(lambda a: np.asarray(a[l // cfg_t.period_len]),
                                 want["slots"][l % cfg_t.period_len])
        flat = dict(ref_layer)
        if kind in STATE_NAMES:
            flat.update(zip(STATE_NAMES[kind], flat.pop("state")))
        assert set(layer) == set(flat)
        for k, a in layer.items():
            assert a.numpy().dtype == flat[k].dtype, k
            np.testing.assert_array_equal(a.numpy(), flat[k])
        assert not set(layer) & set(kvcache.SEQ_KEYS)
    assert kvcache.kv_token_bytes(cfg_t) == \
        ref_kvcache.kv_token_bytes(cfg_j) == 0.0


# ---------------------------------------------------------------- blocks ----

def _block_case(both, arch, slot):
    cfg_j, params_j, cfg_t, params_t = both[arch]
    kind = cfg_t.period[slot]
    pj = jax.tree.map(lambda a: a[0], params_j["stack"]["slots"][slot])[kind]
    return cfg_j, cfg_t, kind, pj, getattr(params_t.layers[slot], kind)


@pytest.mark.parametrize("arch,slot", [("xlstm-1.3b", 0), ("xlstm-1.3b", 7),
                                       ("lstm-ptb", 0)])
def test_block_matches_reference(both, arch, slot):
    """One block on the same input: a cache-free forward, a prefill from
    the empty cache, then two decode steps from its state (the conv
    continuing from its tail): every output and state leaf."""
    cfg_j, cfg_t, kind, pj, block = _block_case(both, arch, slot)
    fn_j = {MLSTM: ref_xlstm.mlstm_block, SLSTM: ref_xlstm.slstm_block,
            LSTM: ref_xlstm.lstm_block}[kind]
    x = _rand(np.random.default_rng(6), 2, 12, cfg_t.d_model)
    rel = REL[arch]
    want, _ = fn_j(pj, cfg_j, jnp.asarray(x))
    got, _ = block(cfg_t, _t(x))
    _close(got, want, rel=rel)
    cache_j = jax.tree.map(lambda a: a[0], ref_kvcache.init_cache(
        cfg_j, 2, 16, jnp.float32)["slots"][slot])
    cache_t = kvcache.init_layer_cache(cfg_t, kind, 2, 16, torch.float32,
                                       "cpu")
    for lo, hi, decode in ((0, 10, False), (10, 11, True), (11, 12, True)):
        want, cache_j = fn_j(pj, cfg_j, jnp.asarray(x[:, lo:hi]),
                             cache=cache_j, decode=decode)
        got, state = block(cfg_t, _t(x[:, lo:hi]), cache=cache_t,
                           decode=decode)
        cache_t.update(state)
        _close(got, want, rel=rel)
        flat = dict(cache_j)
        if kind in STATE_NAMES:
            flat.update(zip(STATE_NAMES[kind], flat.pop("state")))
        assert set(state) == set(flat)
        for k, a in state.items():
            _close(a, flat[k], rel=rel)
        if kind == LSTM:
            assert state["c"].dtype == torch.float32


# ----------------------------------------------------------------- model ----

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(both, arch):
    cfg_j, params_j, cfg_t, params_t = both[arch]
    toks = _toks(1, (2, 16))
    want, _, _ = jax.jit(lambda p, b: ref_model.forward(p, cfg_j, b))(
        params_j, {"tokens": jnp.asarray(toks)})
    got = model.forward(params_t, cfg_t, {"tokens": torch.from_numpy(toks)})
    _close(got, want, rel=REL[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_full_forward_and_reference(both, arch):
    """test_substrates.py's case (S 12: a 10-token prefill into a 12-row
    cache, then two decode steps, at a scalar and at per-slot offsets):
    each step's logits equal the full forward's and the reference's."""
    cfg_j, params_j, cfg_t, params_t = both[arch]
    toks = _toks(2, (2, 12))
    full = model.forward(params_t, cfg_t, {"tokens": torch.from_numpy(toks)})
    lj, cj = ref_model.prefill(params_j, cfg_j,
                               {"tokens": jnp.asarray(toks[:, :10])},
                               max_seq=12)
    lt, ct = model.prefill(params_t, cfg_t,
                           {"tokens": torch.from_numpy(toks[:, :10])},
                           max_seq=12)
    torch.testing.assert_close(lt, full[:, 9], **TOL)
    _close(lt, lj, rel=REL[arch])
    for t, index in ((10, 10), (11, np.array([11, 11], np.int32))):
        lj, cj = ref_model.decode_step(params_j, cfg_j,
                                       jnp.asarray(toks[:, t:t + 1]), cj,
                                       jnp.asarray(index))
        lt, ct = model.decode_step(params_t, cfg_t,
                                   torch.from_numpy(toks[:, t:t + 1]), ct,
                                   torch.as_tensor(index))
        torch.testing.assert_close(lt, full[:, t], **TOL)
        _close(lt, lj, rel=REL[arch])


def test_chunked_forward_matches_sequential(both, chunk_mode):
    """xlstm reduced at S 16: the forward with chunks of 8 == the
    sequential forward and the reference's in the same mode."""
    cfg_j, params_j, cfg_t, params_t = both["xlstm-1.3b"]
    toks = _toks(4, (2, 16))
    seq = model.forward(params_t, cfg_t, {"tokens": torch.from_numpy(toks)})
    chunk_mode(8)
    got = model.forward(params_t, cfg_t, {"tokens": torch.from_numpy(toks)})
    want, _, _ = ref_model.forward(params_j, cfg_j,
                                   {"tokens": jnp.asarray(toks)})
    torch.testing.assert_close(got, seq, **TOL)
    _close(got, want, rel=XLSTM_REL)


# -------------------------------------------------------------- training ----

def _numpy(tree):
    return jax.tree.map(np.array, tree)


def _batch(cfg, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 17))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


@pytest.fixture(scope="module")
def reference_grads(both):
    """The reference's jitted ``value_and_grad`` of the loss, one compile
    per (arch, mLSTM chunk): its full mode.  Its blocked modes compute the
    same function (its own test_configs_smoke.py holds them to full), and
    each compile of the reduced xlstm's nested scans costs some 12 s, so
    every mode of the port is held to this one and to the port's own full
    mode."""
    cache = {}

    def get(arch, chunk):
        if (arch, chunk) not in cache:
            cfg_j, params_j, cfg_t, _ = both[arch]
            bj = {k: jnp.asarray(v) for k, v in _batch(cfg_t, 0).items()}
            ref_ops.mlstm_chunk_mode(chunk)
            try:
                loss_j, grads_j = jax.jit(jax.value_and_grad(
                    lambda p: ref_model.loss_fn(p, cfg_j, bj)))(params_j)
            finally:
                ref_ops.mlstm_chunk_mode(0)
            cache[arch, chunk] = (float(loss_j), _numpy(grads_j))
        return cache[arch, chunk]
    return get


def _port_loss_and_grads(both, arch, mode, mi):
    cfg_t = both[arch][2]
    params = params_from_jax(cfg_t, _numpy(both[arch][1]), device="cpu",
                             requires_grad=True)
    named = dict(params.named_parameters())
    loss = model.loss_fn(params, cfg_t,
                         {k: torch.from_numpy(v)
                          for k, v in _batch(cfg_t, 0).items()},
                         **offload.loss_kwargs(offload.SentinelConfig(
                             mode=mode, mi_periods=mi)))
    return loss.detach(), dict(zip(named, torch.autograd.grad(
        loss, list(named.values()))))


def _loss_and_grads(both, reference_grads, arch, mode, mi, chunk=0,
                    rel=None):
    """The port's loss and every gradient in ``mode`` at ``mi`` against
    the reference's (finite, within LOSS_TOL and GRAD_TOL widened by
    ``rel``) and against the port's full mode (to rounding, 1e-6)."""
    cfg_t = both[arch][2]
    ops.mlstm_chunk_mode(chunk)
    try:
        loss, grads = _port_loss_and_grads(both, arch, mode, mi)
        full_loss, full_grads = _port_loss_and_grads(both, arch, "full", 1)
    finally:
        ops.mlstm_chunk_mode(0)
    loss_j, grads_j = reference_grads(arch, chunk)
    torch.testing.assert_close(loss, torch.tensor(loss_j), **LOSS_TOL)
    torch.testing.assert_close(loss, full_loss, atol=1e-6, rtol=1e-6)
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), name
        _close(g, reference_leaf(cfg_t, grads_j, name), GRAD_TOL,
               REL[arch] if rel is None else rel,
               msg=lambda m: f"{arch} {mode} mi {mi} {name}: {m}")
        torch.testing.assert_close(g, full_grads[name], atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("mi", [1, 2])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(both, reference_grads, arch, mode,
                                        mi):
    """Each mode and MI gives the reference's loss and gradients, every
    gradient finite (the empty state's m = -inf passes no NaN back)."""
    _loss_and_grads(both, reference_grads, arch, mode, mi)


@pytest.mark.parametrize("mode", ["full", "offload"])
def test_chunked_loss_and_grads_match_reference(both, reference_grads, mode):
    """xlstm reduced with chunks of 8 (the card's training mode) in both
    packages: the same loss and gradients, all finite."""
    _loss_and_grads(both, reference_grads, "xlstm-1.3b", mode, 2, 8,
                    CHUNKED_REL)


def test_xlstm_fp32_is_within_its_float64(both):
    """The port's own accuracy, with no reference: the reduced xlstm's fp32
    logits and gradients (full mode) lie within XLSTM_REL of the largest
    |value| from the same model run in float64."""
    _, params_j, cfg, _ = both["xlstm-1.3b"]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    out = {}
    for dt in (torch.float32, torch.float64):
        params = params_from_jax(cfg, _numpy(params_j), device="cpu",
                                 requires_grad=True).to(dt)
        named = dict(params.named_parameters())
        logits = model.forward(params, cfg, {"tokens": batch["tokens"]})
        loss = model.loss_fn(params, cfg, batch)
        out[dt] = (logits, dict(zip(named, torch.autograd.grad(
            loss, list(named.values())))))
    _close(out[torch.float32][0], out[torch.float64][0].numpy(), TOL,
           XLSTM_REL)
    for name, g in out[torch.float32][1].items():
        _close(g, out[torch.float64][1][name].numpy(), GRAD_TOL, XLSTM_REL,
               msg=lambda m: f"{name}: {m}")
