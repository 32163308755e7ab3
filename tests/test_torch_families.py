"""The attention families the port serves beside smollm-360m and zamba2-7b
(gemma2-2b, gemma3-12b, internlm2-1.8b, granite-moe-3b, deepseek-v2-lite)
against the reference, each on its ``.reduced()`` config in fp32 with the
reference's parameters carried across by params_from_jax:

  * every config field, full and reduced, equals the reference's;
  * the forward's logits (atol 1e-4), prefill and two decode steps over a
    dense cache (atol 1e-4), and loss_fn, the mean NLL plus the MoE
    auxiliary loss (atol 1e-5);
  * moe_mlp's output and aux loss, at a capacity small enough that
    choices drop and with a planted router tie, where the lower expert
    index must win as in ``jax.lax.top_k``;
  * the gemma embedding scale in bf16 bit for bit at d 3840;
  * the architecture signatures of test_arch_fidelity.py: the MLA cache's
    576 values a token, gemma's local/global periods and softcaps, the
    sliding window's mask, QK-norm weights at one;
  * the serving CLI on each arch at reduced size on the CPU.

Inputs are made with numpy from a seed."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.models import kvcache as ref_kvcache
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.models.layers import embed as ref_embed
from repro.models.layers import split_params
from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN, LOCAL, MLA
from repro_torch.models import kvcache, model, moe
from repro_torch.models.layers import embed
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gemma2-2b", "gemma3-12b", "internlm2-1.8b", "granite-moe-3b-a800m",
         "deepseek-v2-lite-16b")
TOL = dict(atol=1e-4, rtol=0.0)
LOSS_TOL = dict(atol=1e-5, rtol=0.0)


def _toks(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _close(got, want, tol=TOL):
    torch.testing.assert_close(got.float(),
                               torch.from_numpy(np.array(want, np.float32)),
                               **tol)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_carry_every_leaf(both, arch):
    cfg_j, params_j, cfg_t, params_t = both[arch]
    assert sum(p.numel() for p in params_t.parameters()) == \
        sum(int(a.size) for a in jax.tree.leaves(params_j))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(both, arch):
    cfg_j, params_j, cfg_t, params_t = both[arch]
    toks = _toks(1, (2, 16))
    want, _, _ = ref_model.forward(params_j, cfg_j,
                                   {"tokens": jnp.asarray(toks)})
    got = model.forward(params_t, cfg_t, {"tokens": torch.from_numpy(toks)})
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(both, arch):
    """A 9-token prefill into a 16-row cache, then two decode steps, one at
    a scalar offset and one at per-slot offsets."""
    cfg_j, params_j, cfg_t, params_t = both[arch]
    toks = _toks(2, (2, 9))
    lj, cj = ref_model.prefill(params_j, cfg_j, {"tokens": jnp.asarray(toks)},
                               max_seq=16)
    lt, ct = model.prefill(params_t, cfg_t, {"tokens": torch.from_numpy(toks)},
                           max_seq=16)
    _close(lt, lj)
    for step, index in ((0, 9), (1, np.array([10, 10], np.int32))):
        nxt = _toks(10 + step, (2, 1))
        lj, cj = ref_model.decode_step(params_j, cfg_j, jnp.asarray(nxt), cj,
                                       jnp.asarray(index))
        lt, ct = model.decode_step(params_t, cfg_t, torch.from_numpy(nxt), ct,
                                   torch.as_tensor(index))
        _close(lt, lj)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(both, arch):
    """The mean NLL plus the summed MoE aux losses (zero for the dense
    archs)."""
    cfg_j, params_j, cfg_t, params_t = both[arch]
    toks = _toks(3, (2, 16))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want = ref_model.loss_fn(params_j, cfg_j,
                             jax.tree.map(jnp.asarray, batch))
    got = model.loss_fn(params_t, cfg_t,
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(got, want, LOSS_TOL)
    _, _, aux = ref_model.forward(params_j, cfg_j,
                                  {"tokens": jnp.asarray(toks)})
    assert (float(aux) > 0) == (cfg_t.moe is not None)


def _moe_pair(both, arch, **moe_fields):
    """Both configs with ``moe_fields`` replaced, and the first period
    layer's MoE parameters of each package."""
    cfg_j, params_j, cfg_t, params_t = both[arch]
    cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(
        cfg_j.moe, **moe_fields))
    cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(
        cfg_t.moe, **moe_fields))
    return cfg_j, params_j["stack"]["slots"][0]["moe"], cfg_t, \
        params_t.layers[0].moe


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("capacity_factor,group_size", [
    (4.0, 512),          # the reduced config's: dropless
    (0.5, 8),            # C = max(k, 2): choices drop in every group
])
def test_moe_mlp_matches_reference(both, arch, capacity_factor, group_size):
    cfg_j, pj, cfg_t, pt = _moe_pair(both, arch,
                                        capacity_factor=capacity_factor,
                                        group_size=group_size)
    pj = jax.tree.map(lambda a: a[0], pj)     # period 0's slice
    x = np.random.default_rng(5).standard_normal((2, 16, cfg_t.d_model)) \
        .astype(np.float32)
    out_j, aux_j = ref_moe.moe_mlp(pj, cfg_j, jnp.asarray(x), cfg_j.act)
    out_t, aux_t = moe.moe_mlp(pt, cfg_t, torch.from_numpy(x), cfg_t.act)
    _close(out_t, out_j, dict(atol=1e-5, rtol=0.0))
    _close(aux_t, aux_j, dict(atol=1e-6, rtol=0.0))
    # the drops are the reference's: the same tokens pass the capacity
    gsz, G, C = moe.capacity(cfg_t, 32)
    logits = (torch.from_numpy(x).reshape(G, gsz, -1) @ pt.router)
    _, idx = moe.route_topk(logits, cfg_t.moe.experts_per_token)
    onehot = torch.nn.functional.one_hot(idx, cfg_t.moe.num_experts)
    flat = onehot.reshape(G, -1, cfg_t.moe.num_experts)
    pos = ((flat.cumsum(1) - flat) * flat).sum(-1)
    dropped = int((pos >= C).sum())
    assert (dropped > 0) == (capacity_factor < 1.0)


def test_route_topk_keeps_the_lower_index_on_ties():
    """A planted tie: ``jax.lax.top_k`` keeps the lower expert index first,
    and so does the port (``torch.topk`` need not)."""
    logits = np.array([[1.0, 3.0, 3.0, 2.0, 3.0]], np.float32)
    wj, ij = ref_moe.route_topk(jnp.asarray(logits), 2)
    wt, it = moe.route_topk(torch.from_numpy(logits), 2)
    assert it.tolist() == np.asarray(ij).tolist() == [[1, 2]]
    _close(wt, wj, dict(atol=0.0, rtol=0.0))


def test_moe_mlp_tie_routes_as_the_reference(both):
    """Tied router logits in a whole MoE call (a router whose columns 1
    and 2 are equal, so every token ties there) with choices dropping:
    the port selects, drops and combines as the reference."""
    cfg_j, pj, cfg_t, pt = _moe_pair(both, "granite-moe-3b-a800m",
                                        capacity_factor=0.5, group_size=8)
    pj = jax.tree.map(lambda a: np.array(a[0]), pj)
    pj["router"][:, 2] = pj["router"][:, 1]
    with torch.no_grad():
        pt.router.copy_(torch.from_numpy(pj["router"]))
    x = np.random.default_rng(6).standard_normal((1, 16, cfg_t.d_model)) \
        .astype(np.float32)
    out_j, aux_j = ref_moe.moe_mlp(jax.tree.map(jnp.asarray, pj), cfg_j,
                                   jnp.asarray(x), cfg_j.act)
    out_t, aux_t = moe.moe_mlp(pt, cfg_t, torch.from_numpy(x), cfg_t.act)
    _close(out_t, out_j, dict(atol=1e-5, rtol=0.0))
    _close(aux_t, aux_j, dict(atol=1e-6, rtol=0.0))
    # rows where the tie was decided: one of the tied experts chosen, and
    # it is always expert 1; expert 2 only ever comes after expert 1
    _, idx = moe.route_topk(torch.from_numpy(x[0]) @ pt.router, 2)
    rows = [r for r in idx.tolist() if (1 in r) != (2 in r)]
    assert rows and all(1 in r for r in rows)
    assert all(r == [1, 2] for r in idx.tolist() if 2 in r)


def test_moe_group_rule_is_the_reference_assertion(both):
    _, _, cfg_t, pt = _moe_pair(both, "granite-moe-3b-a800m",
                                   group_size=8)
    with pytest.raises(AssertionError, match="not divisible by moe group"):
        moe.moe_mlp(pt, cfg_t, torch.zeros(1, 12, cfg_t.d_model), cfg_t.act)


def test_expert_banks_take_the_reference_scale():
    """N(0, 1/din) for an (E, din, dout) bank, not 1/E."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    params = model.init_params(cfg, seed=0, device="cpu")
    bank = params.layers[0].moe.wi
    E, din, _ = bank.shape
    assert abs(float(bank.float().std()) * din ** 0.5 - 1.0) < 0.05
    assert E ** -0.5 > 2 * din ** -0.5


def test_scale_embed_bf16_is_the_references_bit_for_bit():
    """sqrt(3840) rounds to 62.0 in bf16 before the multiply, as the
    reference's ``jnp.asarray(sqrt(d), x.dtype)``."""
    cfg_t = get_config("gemma3-12b")
    cfg_j = ref_config("gemma3-12b")
    table = np.random.default_rng(7).standard_normal((64, cfg_t.d_model)) \
        .astype(np.float32)
    toks = _toks(8, (2, 5), 64)
    tj = jnp.asarray(table, jnp.bfloat16)
    want = ref_embed({"table": tj}, cfg_j, jnp.asarray(toks))
    got = embed(torch.from_numpy(table).to(torch.bfloat16), cfg_t,
                torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))
    assert float(torch.tensor(3840 ** 0.5, dtype=torch.bfloat16)) == 62.0


def test_final_softcap_bounds_the_logits(both):
    cfg_j, params_j, cfg_t, params_t = both["gemma2-2b"]
    with torch.no_grad():
        params_t.final_norm.fill_(50.0)         # logits far past the cap
    try:
        got = model.forward(params_t, cfg_t,
                            {"tokens": torch.from_numpy(_toks(9, (1, 8)))})
    finally:
        with torch.no_grad():
            params_t.final_norm.zero_()
    assert float(got.abs().max()) <= cfg_t.final_softcap
    assert float(got.abs().max()) > 0.9 * cfg_t.final_softcap


# ------------------------------------------- test_arch_fidelity.py mirrors --

def test_mla_cache_is_compressed():
    """The MLA cache holds the latent, 576 values a token, not full K/V;
    kv_token_bytes counts it as the reference does."""
    cfg = get_config("deepseek-v2-lite-16b")
    layer = kvcache.init_layer_cache(cfg, MLA, 1, 4, torch.bfloat16, "meta")
    per_tok = layer["ckv"].shape[-1] + layer["krope"].shape[-1]
    full_kv = 2 * cfg.num_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
    assert per_tok == cfg.kv_lora_rank + cfg.qk_rope_dim == 576
    assert per_tok < full_kv / 7
    assert kvcache.kv_token_bytes(cfg) * cfg.num_layers == 27 * 576 * 2 == \
        ref_kvcache.kv_token_bytes(ref_config("deepseek-v2-lite-16b")) * 27
    for arch in ARCHS:
        assert kvcache.kv_token_bytes(get_config(arch)) == \
            ref_kvcache.kv_token_bytes(ref_config(arch))


def test_gemma_local_global_pattern():
    g3 = get_config("gemma3-12b")
    assert list(g3.period).count(LOCAL) == 5 and \
        list(g3.period).count(ATTN) == 1
    assert g3.rope_theta_global == 1e6 and g3.qk_norm and g3.scale_embed
    g2 = get_config("gemma2-2b")
    assert list(g2.period) == [LOCAL, ATTN]
    assert g2.attn_softcap == 50.0 and g2.final_softcap == 30.0


def test_sliding_window_actually_masks(both):
    """Flipping token 0 changes position 0's logits; within a stack of
    local layers only it changes none of the positions past the layers'
    reach, num_layers x (window - 1)."""
    cfg_j, params_j, cfg_t, params_t = both["gemma2-2b"]
    toks = _toks(11, (1, 16))
    flipped = toks.copy()
    flipped[0, 0] = (flipped[0, 0] + 1) % cfg_t.vocab_size
    local = dataclasses.replace(cfg_t, period=(LOCAL, LOCAL),
                                sliding_window=4)
    # a layer's kind is fixed when the model is built
    params_local = params_from_jax(local, jax.tree.map(np.asarray, params_j),
                                   device="cpu")
    reach = local.num_layers * (4 - 1)
    for cfg, params, same_from in (
            (dataclasses.replace(cfg_t, sliding_window=4), params_t, None),
            (local, params_local, reach + 1)):
        a = model.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
        b = model.forward(params, cfg, {"tokens": torch.from_numpy(flipped)})
        assert not torch.allclose(a[0, 0], b[0, 0])
        if same_from is not None:
            torch.testing.assert_close(a[0, same_from:], b[0, same_from:],
                                       atol=0.0, rtol=0.0)


def test_qk_norm_weights_start_at_one():
    cfg = get_config("gemma3-12b").reduced()
    params = model.init_params(cfg, seed=0, device="cpu")
    for layer in params.layers:
        assert bool((layer.attn.q_norm == 1).all())
        assert bool((layer.attn.k_norm == 1).all())
    assert not hasattr(model.init_params(get_config("gemma2-2b").reduced(),
                                         device="cpu").layers[0].attn,
                       "q_norm")


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_cli_on_each_arch(arch):
    """python -m repro_torch.launch.serve --arch <arch> --reduced on the
    CPU exits 0 with its rate line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "-n", "4"], capture_output=True,
        text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"[serve] {arch}: 16 tokens in" in res.stdout
