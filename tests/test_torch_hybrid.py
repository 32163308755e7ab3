"""The port's zamba2 hybrid against the reference's on zamba2-7b.reduced()
in fp32, with the reference's parameters carried across by
params_from_jax: full-forward logits at atol 1e-4 (whole chunks and a
ragged tail), the loss (also with a padded vocab), one Mamba block's output
and final SSM state, the config copy, and the shared block's one weight
copy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.models import model as ref_model
from repro.models import ssm as ref_ssm
from repro.models.layers import split_params
from repro_torch.configs import get_config
from repro_torch.configs.base import MAMBA, SHARED_ATTN
from repro_torch.models import model, ssm
from repro_torch.weights import params_from_jax

TOL = dict(atol=1e-4, rtol=0.0)
ARCH = "zamba2-7b"


def _both(**fields):
    """The reduced config in both packages (with ``fields`` replaced) and
    the reference's parameters carried across."""
    cfg_j = dataclasses.replace(ref_config(ARCH).reduced(), **fields)
    params_j, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                     cfg_j))
    cfg_t = dataclasses.replace(get_config(ARCH).reduced(), **fields)
    params_t = params_from_jax(cfg_t, jax.tree.map(np.asarray, params_j),
                               device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture(scope="module")
def setup():
    return _both()


def _batch(seed, shape, cfg):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)
    labels = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size,
                                                      shape)
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _close(got, want):
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **TOL)


def test_config_copy_matches_reference():
    """Every field the port's config has equals the reference's, for the
    full arch and its reduced variant."""
    a, b = ref_config(ARCH), get_config(ARCH)
    for cfg_j, cfg_t in ((a, b), (a.reduced(), b.reduced())):
        for f in dataclasses.fields(cfg_t):
            want, got = getattr(cfg_j, f.name), getattr(cfg_t, f.name)
            if dataclasses.is_dataclass(got):
                want, got = dataclasses.asdict(want), dataclasses.asdict(got)
            assert want == got, f.name
        for prop in ("num_periods", "period_len", "padded_vocab"):
            assert getattr(cfg_j, prop) == getattr(cfg_t, prop), prop
        assert [cfg_t.layer_kind(l) for l in range(cfg_t.num_layers)] == \
            list(cfg_j.prologue) + list(cfg_j.period) * cfg_j.num_periods


@pytest.mark.parametrize("S", [16, 13])
def test_full_forward_matches_reference(setup, S):
    """S 16 is two whole SSD chunks of 8; S 13 leaves a ragged tail, which
    both packages' plain chunked scan pads with dt = 0."""
    cfg_j, params_j, cfg_t, params_t = setup
    bj, bt = _batch(1, (2, S), cfg_t)
    want, _, _ = ref_model.forward(params_j, cfg_j, {"tokens": bj["tokens"]})
    got = model.forward(params_t, cfg_t, {"tokens": bt["tokens"]})
    assert got.shape == (2, S, cfg_t.padded_vocab)
    _close(got, want)


def test_loss_matches_reference(setup):
    cfg_j, params_j, cfg_t, params_t = setup
    bj, bt = _batch(2, (2, 16), cfg_t)
    want = ref_model.loss_fn(params_j, cfg_j, bj)
    got = model.loss_fn(params_t, cfg_t, bt)
    assert got.dim() == 0
    _close(got, want)


def test_loss_masks_padded_vocab():
    """A vocab of 500 pads the table to 512: the 12 padded logits are
    masked out of the softmax in both packages."""
    cfg_j, params_j, cfg_t, params_t = _both(vocab_size=500)
    assert cfg_t.padded_vocab == 512
    bj, bt = _batch(3, (2, 16), cfg_t)
    want = ref_model.loss_fn(params_j, cfg_j, bj)
    got = model.loss_fn(params_t, cfg_t, bt)
    _close(got, want)


def test_mamba_block_matches_reference(setup):
    """The prologue's Mamba block on the same input: output, and the final
    SSM state (the reference returns it through a zero-state cache, which
    gives the cache-free result)."""
    cfg_j, params_j, cfg_t, params_t = setup
    x = np.random.default_rng(4).standard_normal((2, 16, cfg_t.d_model))
    x = x.astype(np.float32)
    cache = ref_ssm.init_mamba_cache(cfg_j, 2)
    want, new_cache = ref_ssm.mamba_block(
        params_j["stack"]["prologue"][0]["mamba"], cfg_j, jnp.asarray(x),
        cache=cache)
    got, state = params_t.prologue[0].mamba(cfg_t, torch.from_numpy(x))
    h = state["h"]
    _, H, P, N, _ = ssm.dims(cfg_t)
    assert h.shape == (2, H, P, N) and h.dtype == torch.float32
    _close(got, want)
    _close(h, new_cache["h"])


def test_shared_attention_is_one_weight_copy(setup):
    """Zamba's signature, as the reference checks it: every SHARED_ATTN
    layer is the one shared block, whose tensors are stored once."""
    cfg_t, params_t = setup[2], setup[3]
    slots = [j for j in range(len(params_t.layers))
             if cfg_t.layer_kind(len(cfg_t.prologue) + j) == SHARED_ATTN]
    assert len(slots) == cfg_t.num_periods == 2
    for j in slots:
        assert params_t.layers[j] is params_t.shared
        assert params_t.layers[j].attn.wq.data_ptr() == \
            params_t.shared.attn.wq.data_ptr()
    mamba = [j for j in range(len(params_t.layers)) if j not in slots]
    assert all(params_t.layers[j].kind == MAMBA for j in mamba)
    names = [n for n, _ in params_t.named_parameters()]
    assert not any(n.startswith(f"layers.{j}.") for j in slots for n in names)


def test_init_params_gives_reference_initialisers():
    """The Mamba leaves equal the reference's init_mamba where it is
    deterministic: D, dt_bias, conv_b and norm exactly, A_log = log(linspace)
    to one float32 ulp (the two libraries' log differ in the last bit);
    conv_w, drawn from the generator, has the reference's scale K^-0.5."""
    cfg = get_config(ARCH).reduced()
    params = model.init_params(cfg, seed=0, device="cpu")
    m = params.prologue[0].mamba
    want = ref_ssm.init_mamba(jax.random.PRNGKey(0), ref_config(ARCH).reduced())
    for name in ("A_log", "D", "dt_bias", "conv_b", "norm"):
        leaf = np.asarray(want[name].value)
        got = getattr(m, name).numpy()
        assert got.shape == leaf.shape and got.dtype == leaf.dtype, name
        if name == "A_log":
            np.testing.assert_allclose(got, leaf, rtol=2.0 ** -23, atol=0)
        else:
            np.testing.assert_array_equal(got, leaf, err_msg=name)
    K = ssm.dims(cfg)[-1]
    assert abs(float(m.conv_w.std()) - K ** -0.5) < 0.05


def test_dense_prologue_raises():
    """A dense prologue layer is ported (deepseek-v2-lite's): it builds its
    MLP at prologue_d_ff, not d_ff.  Every kind of the reference is ported
    (an xLSTM prologue layer builds); a prologue layer of a kind the
    reference does not have raises."""
    from repro_torch.configs.base import ATTN
    cfg = dataclasses.replace(get_config(ARCH).reduced(), prologue=(ATTN,),
                              prologue_d_ff=96)
    params = model.init_params(cfg, device="cpu")
    assert tuple(params.prologue[0].mlp.wi.shape) == (cfg.d_model, 96)
    assert tuple(params.shared.mlp.wi.shape) == (cfg.d_model, cfg.d_ff)
    xl = dataclasses.replace(get_config(ARCH).reduced(), prologue=("mlstm",))
    assert model.init_params(xl, device="meta").prologue[0].kind == "mlstm"
    with pytest.raises(ValueError, match="unknown layer kinds"):
        dataclasses.replace(get_config(ARCH).reduced(), prologue=("conv",))
