"""The modality stubs against the reference: musicgen-medium's codebooks
(4 summed embedding tables, (B, S, 4, V) logits) and paligemma-3b's
prefix-LM (the SigLIP stub's patch embeddings through ``vision_proj``
before the text, a bidirectional prefix mask, the loss over the text
only), each on its ``.reduced()`` config in fp32 with the reference's
parameters carried across by params_from_jax:

  * every config field, full and reduced, equals the reference's, and
    the full configs' parameter counts and KV bytes a token;
  * the parameters (the (K, V, d) table and head, ``vision_proj``) and
    the AdamW state carry across;
  * the forward's logits, with and without ``prefix_embed`` (atol 1e-5);
  * prefill and two decode steps over a dense cache (atol 1e-5);
  * loss_fn and every gradient in Sentinel's four modes at MI 1 and 2,
    against the reference's jitted ``value_and_grad`` (test_torch_train's
    limits), and four steps of the training loop from the reference's
    state;
  * ``generate``'s greedy tokens, with and without ``prefix_embed``;
  * the data pipeline's bytes and the profile's batch weights;
  * ROADMAP R9: a prompt shorter than the prefix sees rows not yet
    written, so its logits depend on the buffer's size in both packages;
  * both CLIs on each arch at reduced size on the CPU.

Inputs are made with numpy from a seed.  Torch runs on one thread here
(``test_torch_xlstm.one_torch_thread``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.core import offload as ref_offload
from repro.core import profiler as ref_profiler
from repro.data import pipeline as ref_pipeline
from repro.models import kvcache as ref_kvcache
from repro.models import model as ref_model
from repro.models.layers import embed as ref_embed
from repro.models.layers import split_params
from repro.optim import adamw as ref_adamw
from repro.serve import engine as ref_engine
from repro.train import loop as ref_loop
from repro_torch.configs import get_config
from repro_torch.core import offload
from repro_torch.core.profiler import TraceProfile
from repro_torch.data import pipeline
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import profile_step
from repro_torch.models import kvcache, model
from repro_torch.models.layers import embed
from repro_torch.optim import adamw
from repro_torch.serve import engine
from repro_torch.train import loop
from repro_torch.weights import (opt_state_from_jax, params_from_jax,
                                 reference_leaf)
from test_torch_xlstm import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("musicgen-medium", "paligemma-3b")
MODES = ["full", "remat", "save_hbm", "offload"]
TOL = dict(atol=1e-5, rtol=0.0)
# fp32 on both sides, as test_torch_train.py holds the other archs
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
# the full configs as the reference's init_params builds them
# (jax.eval_shape), and their KV bytes a token in bf16
FULL_PARAMS = {"musicgen-medium": 1_837_254_144,
               "paligemma-3b": 2_512_988_160}
FULL_KV_BYTES = {"musicgen-medium": 294_912, "paligemma-3b": 18_432}


def _close(got, want, tol=TOL, msg=None):
    torch.testing.assert_close(got.float(),
                               torch.from_numpy(np.array(want, np.float32)),
                               **tol, msg=msg)


def _numpy(tree):
    return jax.tree.map(np.array, tree)


def _data_config(cfg, **kw):
    return dict(vocab_size=cfg.vocab_size, num_codebooks=cfg.num_codebooks,
                num_prefix_tokens=cfg.num_prefix_tokens, d_model=cfg.d_model,
                **kw)


def _batch(cfg, seed=1, seq_len=8, global_batch=2):
    """The reference pipeline's batch for ``cfg``: tokens (B, S[, K]),
    labels, and ``prefix_embed`` (B, P, d) where the config has a
    prefix."""
    return ref_pipeline._host_batch(ref_pipeline.DataConfig(
        **_data_config(cfg, seed=seed, seq_len=seq_len,
                       global_batch=global_batch)), 0)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _prompts(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


@pytest.fixture(scope="module")
def both():
    """Each arch's reduced config in both packages and the reference's
    parameters carried across, built once."""
    out = {}
    for arch in ARCHS:
        cfg_j, cfg_t = ref_config(arch).reduced(), get_config(arch).reduced()
        params_j, _ = split_params(ref_model.init_params(
            jax.random.PRNGKey(0), cfg_j))
        params_t = params_from_jax(cfg_t, _numpy(params_j), device="cpu")
        out[arch] = (cfg_j, params_j, cfg_t, params_t)
    return out


# --------------------------------------------------------------- configs ----

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_the_reference(arch):
    """Every field, full and reduced (the reduced prefix is 4 patches)."""
    for cfg_t, cfg_j in ((get_config(arch), ref_config(arch)),
                         (get_config(arch).reduced(),
                          ref_config(arch).reduced())):
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
        assert cfg_t.padded_vocab == cfg_j.padded_vocab
    assert get_config(arch).reduced().num_prefix_tokens == \
        (4 if arch == "paligemma-3b" else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_sizes(arch):
    """The full config's parameters on the meta device equal the
    reference's ``init_params`` under ``jax.eval_shape`` leaf for leaf in
    number, and its KV bytes a token in bf16."""
    cfg_j, cfg_t = ref_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda: split_params(ref_model.init_params(
        jax.random.PRNGKey(0), cfg_j))[0])
    n_j = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    meta = model.init_params(cfg_t, device="meta")
    assert sum(p.numel() for p in meta.parameters()) == n_j == \
        FULL_PARAMS[arch]
    assert kvcache.kv_token_bytes(cfg_t, 2) * cfg_t.num_layers == \
        ref_kvcache.kv_token_bytes(cfg_j, 2) * cfg_j.num_layers == \
        FULL_KV_BYTES[arch]
    if arch == "musicgen-medium":
        assert tuple(meta.table.shape) == tuple(meta.head.shape) == \
            (4, 2048, 1536)
    else:
        assert meta.head is None and tuple(meta.vision_proj.shape) == \
            (2048, 2048)


# ------------------------------------------------------------ parameters ----

@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_carry_every_leaf(both, arch):
    """Every leaf, the codebook table and head and ``vision_proj`` among
    them, by value; ``vision_proj`` is the tree's top-level leaf through
    reference_leaf's last branch, and a leaf of the wrong shape is
    refused."""
    cfg_j, params_j, cfg_t, params_t = both[arch]
    tree = _numpy(params_j)
    assert sum(p.numel() for p in params_t.parameters()) == \
        sum(int(a.size) for a in jax.tree.leaves(params_j))
    for name, p in params_t.named_parameters():
        assert np.array_equal(p.numpy(), reference_leaf(cfg_t, tree, name))
    if cfg_t.num_codebooks:
        assert tuple(params_t.table.shape) == tuple(params_t.head.shape) == \
            (4, 512, 64)
        assert params_t.vision_proj is None
    else:
        assert reference_leaf(cfg_t, tree, "vision_proj") is \
            tree["vision_proj"]
        bad = dict(tree, vision_proj=np.zeros((64, 65), np.float32))
        with pytest.raises(ValueError, match="vision_proj"):
            params_from_jax(cfg_t, bad, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_weights_scales(arch):
    """The port's own seeded init draws the tables and head at d^-0.5 and
    ``vision_proj`` at 1/sqrt(fan_in), as the reference's."""
    cfg = get_config(arch).reduced()
    p = model.init_params(cfg, seed=0, device="cpu")
    d = cfg.d_model
    for t in [p.table] + [t for t in (p.head, p.vision_proj)
                          if t is not None]:
        assert float(t.std()) == pytest.approx(d ** -0.5, rel=0.05)


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_matches_reference(both, arch):
    """The codebooks' K rows summed in order, scaled after the sum where
    the config scales (bit for bit in fp32); in bf16 too."""
    cfg_j, params_j, cfg_t, params_t = both[arch]
    toks = _batch(cfg_j)["tokens"]
    want = ref_embed(params_j["embed"], cfg_j, jnp.asarray(toks))
    got = embed(params_t.table, cfg_t, torch.from_numpy(toks))
    assert np.array_equal(got.numpy(), np.asarray(want))
    table = jnp.asarray(params_j["embed"]["table"], jnp.bfloat16)
    want = ref_embed({"table": table}, cfg_j, jnp.asarray(toks))
    got = embed(torch.from_numpy(np.asarray(table, np.float32)).bfloat16(),
                cfg_t, torch.from_numpy(toks))
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want, np.float32))


# --------------------------------------------------------------- forward ----

FORWARD_CASES = [("musicgen-medium", True), ("paligemma-3b", True),
                 ("paligemma-3b", False)]


@pytest.mark.parametrize("arch,with_prefix", FORWARD_CASES)
def test_forward_matches_reference(both, arch, with_prefix):
    """Logits (B, S, K, Vpad) for codebooks; (B, P + S, Vpad) with a
    prefix, (B, S, Vpad) without."""
    cfg_j, params_j, cfg_t, params_t = both[arch]
    batch = _prompts(_batch(cfg_j))
    if not with_prefix:
        batch.pop("prefix_embed")
    want, _, _ = ref_model.forward(params_j, cfg_j, _j(batch))
    got = model.forward(params_t, cfg_t, _t(batch))
    S = 8 + (cfg_t.num_prefix_tokens if "prefix_embed" in batch else 0)
    K = (cfg_t.num_codebooks,) if cfg_t.num_codebooks else ()
    assert tuple(got.shape) == (2, S) + K + (cfg_t.padded_vocab,)
    _close(got, want)


@pytest.mark.parametrize("arch,with_prefix", FORWARD_CASES)
def test_prefill_and_decode_match_reference(both, arch, with_prefix):
    """A prefill of 9 tokens (after P patches) into a cache of 8 rows more,
    then two decode steps, one at a scalar offset and one at per-slot
    offsets; codebook tokens are (B, 1, K)."""
    cfg_j, params_j, cfg_t, params_t = both[arch]
    batch = _prompts(_batch(cfg_j, seq_len=9))
    if not with_prefix:
        batch.pop("prefix_embed")
    S = 9 + (cfg_t.num_prefix_tokens if "prefix_embed" in batch else 0)
    lj, cj = ref_model.prefill(params_j, cfg_j, _j(batch), max_seq=S + 8)
    lt, ct = model.prefill(params_t, cfg_t, _t(batch), max_seq=S + 8)
    assert ct[0]["k"].shape[1] == S + 8
    _close(lt, lj)
    K = (cfg_t.num_codebooks,) if cfg_t.num_codebooks else ()
    rng = np.random.default_rng(10)
    for index in (S, np.array([S + 1, S + 1], np.int32)):
        nxt = rng.integers(0, cfg_t.vocab_size, (2, 1) + K)
        lj, cj = ref_model.decode_step(params_j, cfg_j, jnp.asarray(nxt), cj,
                                       jnp.asarray(index))
        lt, ct = model.decode_step(params_t, cfg_t, torch.from_numpy(nxt), ct,
                                   torch.as_tensor(index))
        assert tuple(lt.shape) == (2,) + K + (cfg_t.padded_vocab,)
        _close(lt, lj)


@pytest.mark.parametrize("arch,with_prefix", FORWARD_CASES)
def test_generate_matches_reference(both, arch, with_prefix):
    """Greedy tokens (B, n) or (B, n, K), with and without the prefix."""
    cfg_j, params_j, cfg_t, params_t = both[arch]
    batch = _prompts(_batch(cfg_j, seed=4))
    if not with_prefix:
        batch.pop("prefix_embed")
    want = np.asarray(ref_engine.generate(params_j, cfg_j, _j(batch), 6))
    got = engine.generate(params_t, cfg_t, _t(batch), 6)
    K = (cfg_t.num_codebooks,) if cfg_t.num_codebooks else ()
    assert tuple(got.shape) == want.shape == (2, 6) + K
    assert np.array_equal(got.numpy(), want)


def test_generate_samples_each_codebook(both):
    """Temperature sampling draws one code a codebook, from the
    generator: the same seed gives the same codes."""
    _, _, cfg_t, params_t = both["musicgen-medium"]
    batch = _t(_prompts(_batch(cfg_t)))
    scfg = engine.ServeConfig(temperature=0.8)
    out = [engine.generate(params_t, cfg_t, batch, 4, scfg,
                           torch.Generator().manual_seed(3))
           for _ in range(2)]
    assert tuple(out[0].shape) == (2, 4, 4) and torch.equal(*out)
    assert 0 <= int(out[0].min()) and int(out[0].max()) < cfg_t.vocab_size


# ------------------------------------------------------------------- R9 ----

@pytest.mark.parametrize("n_tokens,depends", [(3, True), (6, False)])
def test_prefix_mask_sees_unwritten_rows(both, n_tokens, depends):
    """ROADMAP R9: with a cache the bias unmasks every row below P, written
    or not.  A text-only prompt of 3 tokens on the reduced paligemma (P 4)
    reads the fourth row of whatever buffer holds it: the port equals the
    reference at two buffer sizes, and in both packages the last row's
    logits depend on the size.  At 6 tokens every row below P is written
    and the sizes agree."""
    cfg_j, params_j, cfg_t, params_t = both["paligemma-3b"]
    toks = np.random.default_rng(5).integers(0, 512, (1, n_tokens))
    got = {}
    for max_seq in (n_tokens, n_tokens + 8):
        lj, _ = ref_model.prefill(params_j, cfg_j,
                                  {"tokens": jnp.asarray(toks)},
                                  max_seq=max_seq)
        lt, _ = model.prefill(params_t, cfg_t,
                              {"tokens": torch.from_numpy(toks)},
                              max_seq=max_seq)
        _close(lt, lj)
        got[max_seq] = (np.asarray(lj), lt.numpy())
    (j0, t0), (j1, t1) = got.values()
    for a, b in ((j0, j1), (t0, t1)):
        gap = float(np.abs(a - b).max())
        assert (gap > 0.1) if depends else (gap < 1e-5), gap


# -------------------------------------------------------------- training ----

@pytest.fixture(scope="module")
def reference_grads(both):
    """Each arch's loss and gradients from the reference's jitted
    ``value_and_grad`` in its full mode (its modes compute one function)
    on a 2 x 8 pipeline batch."""
    out = {}
    for arch in ARCHS:
        cfg_j, params_j, _, _ = both[arch]
        batch = _batch(cfg_j, seed=2)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: ref_model.loss_fn(p, cfg_j, _j(batch))))(params_j)
        out[arch] = (batch, float(loss), _numpy(grads))
    return out


@pytest.mark.parametrize("mi", [1, 2])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(both, reference_grads, arch, mode,
                                        mi):
    """Each mode and MI gives the reference's loss (the text suffix's NLL
    only, with a prefix) and every gradient leaf, ``vision_proj``'s
    included; offload hands each block's carry to the store once."""
    cfg_j, params_j, cfg_t, _ = both[arch]
    batch, loss_j, grads_j = reference_grads[arch]
    params = params_from_jax(cfg_t, _numpy(params_j), device="cpu",
                             requires_grad=True)
    named = dict(params.named_parameters())
    offload.reset_traffic()
    loss = model.loss_fn(params, cfg_t, _t(batch),
                         **offload.loss_kwargs(offload.SentinelConfig(
                             mode=mode, mi_periods=mi)))
    grads = torch.autograd.grad(loss, list(named.values()))
    torch.testing.assert_close(loss.detach(), torch.tensor(loss_j),
                               **LOSS_TOL)
    for (name, _), g in zip(named.items(), grads):
        _close(g, reference_leaf(cfg_t, grads_j, name), GRAD_TOL,
               msg=lambda m: f"{mode} mi {mi} {name}: {m}")
    prof = TraceProfile(num_periods=cfg_t.num_periods, num_steps=0)
    blocks = offload.estimate_offload_traffic(prof, mi, 1)["blocks"]
    assert offload.traffic["out"] == offload.traffic["in"] == \
        (blocks if mode == "offload" else 0)


def test_loss_counts_the_text_suffix_only(both):
    """With a prefix the loss is the mean NLL of the rows after P: labels
    on the prefix rows change nothing, in both packages, with or without
    ``prefix_embed`` in the batch (the reference slices either way)."""
    cfg_j, params_j, cfg_t, params_t = both["paligemma-3b"]
    batch = _batch(cfg_j, seed=6)
    other = dict(batch, labels=batch["labels"].copy())
    other["labels"][:, :cfg_t.num_prefix_tokens] = 7
    for b in (batch, other):
        _close(model.loss_fn(params_t, cfg_t, _t(b)),
               ref_model.loss_fn(params_j, cfg_j, _j(b)))
    _close(model.loss_fn(params_t, cfg_t, _t(batch)),
           model.loss_fn(params_t, cfg_t, _t(other)).detach(),
           dict(atol=0.0, rtol=0.0))
    text = {"tokens": batch["tokens"], "labels": batch["tokens"]}
    _close(model.loss_fn(params_t, cfg_t, _t(text)),
           ref_model.loss_fn(params_j, cfg_j, _j(text)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loop_matches_reference(arch, tmp_path):
    """Four steps of loop.run in offload at MI 1 from the reference's
    init_state carried across (parameters and AdamW state), on the
    pipeline's codebook or prefix batches: the same losses step by step
    (test_torch_train's limits) and the same final parameters (GRAD_TOL).
    AdamW's first step divides each gradient by its own magnitude plus
    eps 1e-8, so an element whose first gradient lies within fp32
    rounding of 0 moves by a different fraction of the learning rate in
    each package (paligemma: -1.8e-8 against -7.2e-9, of gradients up to
    0.12): where the reference's first gradient is below 1e-6 the final
    parameter is held to the learning rate (3e-4) instead."""
    cfg_j, cfg_t = ref_config(arch).reduced(), get_config(arch).reduced()
    ocfg_kw = dict(total_steps=4, warmup_steps=1)
    dcfg_kw = _data_config(cfg_t, seed=1, seq_len=8, global_batch=2)
    state_j, _ = ref_loop.init_state(jax.random.PRNGKey(1), cfg_j,
                                     ref_adamw.OptConfig(**ocfg_kw))
    state_np = _numpy(state_j)
    r_j = ref_loop.run(
        cfg_j, ref_loop.TrainConfig(steps=4, ckpt_every=0,
                                    ckpt_dir=str(tmp_path / "a")),
        ref_offload.SentinelConfig(mode="offload", mi_periods=1),
        ref_adamw.OptConfig(**ocfg_kw), ref_pipeline.DataConfig(**dcfg_kw),
        state=state_j, log=lambda *a: None)
    params = params_from_jax(cfg_t, state_np["params"], device="cpu",
                             requires_grad=True)
    state_t = {"params": params,
               "opt": opt_state_from_jax(cfg_t, params, state_np["opt"]),
               "step": torch.zeros((), dtype=torch.int32)}
    r_t = loop.run(
        cfg_t, loop.TrainConfig(steps=4, ckpt_every=0,
                                ckpt_dir=str(tmp_path / "b")),
        offload.SentinelConfig(mode="offload", mi_periods=1),
        adamw.OptConfig(**ocfg_kw), pipeline.DataConfig(**dcfg_kw),
        state=state_t, log=lambda *a: None)
    np.testing.assert_allclose(r_t["losses"], r_j["losses"], rtol=1e-5,
                               atol=2e-5)
    batch0 = _j(ref_pipeline._host_batch(ref_pipeline.DataConfig(
        **dcfg_kw), 0))
    g0 = _numpy(jax.grad(lambda p: ref_model.loss_fn(p, cfg_j, batch0))(
        jax.tree.map(jnp.asarray, state_np["params"])))
    lr = adamw.OptConfig().lr
    final_j = _numpy(r_j["state"]["params"])
    for name, p in r_t["state"]["params"].named_parameters():
        want = torch.from_numpy(np.array(reference_leaf(cfg_t, final_j,
                                                        name)))
        near0 = torch.from_numpy(
            np.abs(reference_leaf(cfg_t, g0, name)) < 1e-6)
        atol = torch.where(near0, lr, GRAD_TOL["atol"])
        err = (p.detach() - want).abs() - GRAD_TOL["rtol"] * want.abs()
        assert bool((err <= atol).all()), \
            f"{name}: {float((err - atol).max())} past the limit"


# ------------------------------------------------------------------ data ----

@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_host_batch_bytes_equal_reference(arch, reduced):
    """Tokens (B, S, K) and labels rolled on the sequence axis; the prefix
    embeddings drawn after the tokens and the labels left-padded with P
    zeros: byte for byte, and the same on the device."""
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    fields = _data_config(cfg, seed=3, seq_len=16, global_batch=2)
    for step in (0, 1, 57):
        want = ref_pipeline.make_batch(ref_pipeline.DataConfig(**fields),
                                       step)
        host = pipeline._host_batch(pipeline.DataConfig(**fields), step)
        got = pipeline.make_batch(pipeline.DataConfig(**fields), step,
                                  device="cpu")
        assert set(got) == set(want) == set(host)
        for k in want:
            w = np.asarray(want[k])
            assert host[k].dtype == w.dtype and host[k].tobytes() == \
                w.tobytes()
            assert got[k].numpy().tobytes() == w.tobytes()
    K, P = cfg.num_codebooks, cfg.num_prefix_tokens
    assert host["tokens"].shape == ((2, 16, K) if K else (2, 16))
    assert host["labels"].shape == ((2, 16, K) if K else (2, 16 + P))


@pytest.mark.parametrize("arch", ARCHS)
def test_profile_counts_the_batch_as_weights(arch):
    """The training CLI's profile takes the reference's batch shapes, and
    every batch tensor, the float prefix embeddings included, is a weight
    born at step 0: the weights' bytes and the matmul FLOPs equal the
    reference's trace of the same step."""
    from test_torch_profiler import _ref_dot_flops
    cfg_j, cfg_t = ref_config(arch).reduced(), get_config(arch).reduced()
    B, S = 2, 16
    K, P = cfg_j.num_codebooks, cfg_j.num_prefix_tokens
    params, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                   cfg_j))
    pshapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                           params)
    batch = {"tokens": jax.ShapeDtypeStruct((B, S, K) if K else (B, S),
                                            jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S, K) if K else (B, S + P),
                                            jnp.int32)}
    if P:
        batch["prefix_embed"] = jax.ShapeDtypeStruct((B, P, cfg_j.d_model),
                                                     jnp.float32)
    fn = jax.grad(lambda p, b: ref_model.loss_fn(p, cfg_j, b,
                                                 unroll_periods=True))
    prof_j = ref_profiler.trace_profile(fn, pshapes, batch,
                                        num_periods=cfg_j.num_periods)
    dots_j = _ref_dot_flops(jax.make_jaxpr(fn)(pshapes, batch).jaxpr.eqns)
    prof_t = profile_step(cfg_t, B, S)
    assert sum(o.size for o in prof_t.weights()) == \
        sum(o.size for o in prof_j.weights())
    assert all(o.birth == 0 for o in prof_t.weights())
    if P:
        assert any(o.shape == (B, P, cfg_t.d_model) and o.dtype == "float32"
                   for o in prof_t.weights())
    assert prof_t.matmul_flops == pytest.approx(dots_j, rel=0.01)


# ------------------------------------------------------------------ CLIs ----

@pytest.mark.parametrize("arch", ARCHS)
def test_clis_on_the_cpu(arch, tmp_path, capsys):
    """The serving CLI (prompts of K codes a token, or patch embeddings
    from the same generator, reproducible by seed) and the training CLI
    (profiled and planned, then the loop on the pipeline's batches), each
    at reduced size on the CPU."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "-n", "5",
            "--batch", "2"]
    out = serve_cli.main(argv)
    assert torch.equal(out, serve_cli.main(argv + ["--seed", "1"]))
    K = (4,) if arch == "musicgen-medium" else ()
    assert tuple(out.shape) == (2, 5) + K
    res = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--steps", "3", "--batch", "2", "--seq", "8",
                          "--ckpt-dir", str(tmp_path)])
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert "planned MI=" in capsys.readouterr().out
