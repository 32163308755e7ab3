"""The MoE families under Sentinel's blocked modes (granite-moe-3b and
deepseek-v2-lite, reduced, fp32) against the reference on the CPU: the loss
and every gradient leaf in the four modes at migration intervals 1 and 2,
against the reference's jitted ``value_and_grad`` on the parameters
carried across by ``params_from_jax`` (``tests/test_torch_train.py``'s
tolerances), the auxiliary loss's share of both, each mode's loss and
gradient norm against full's, the carries the offload store sees against
``estimate_offload_traffic``, and the training CLI in offload mode.

A block returns its layers' aux sum beside its carry: the aux gets its
gradient through the block's backward (the router weights see it), and
the recompute appends to no list outside the block.  Inputs are made
with numpy from a seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.core import offload as ref_offload
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro_torch.configs import get_config
from repro_torch.core import offload
from repro_torch.core.profiler import TraceProfile
from repro_torch.models import model, transformer
from repro_torch.weights import params_from_jax, reference_leaf

ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
MODES = ["full", "remat", "save_hbm", "offload"]
# as tests/test_torch_train.py: fp32 on both sides
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
# each mode against full inside the port (chip_smoke.py's MODE_*_RTOL)
MODE_LOSS_RTOL = 2.0 ** -16
MODE_GNORM_RTOL = 2.0 ** -10


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for the module, restored after: the reduced
    MoE steps are many tiny eager ops, which torch's own threads slow
    under the test runner's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    return jax.tree.map(np.array, tree)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """The reduced config in both packages, the reference's parameters
    and a batch of 2 x 16 tokens."""
    cfg_j = ref_config(request.param).reduced()
    params_j, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                     cfg_j))
    toks = np.random.default_rng(3).integers(0, cfg_j.vocab_size, (2, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    return cfg_j, params_j, get_config(request.param).reduced(), batch


def _port_step(cfg_t, params, batch, mode, mi):
    """(loss, gradients by name) of the port's loss_fn in ``mode`` at MI
    ``mi``, with the offload store's traffic counted from 0."""
    named = dict(params.named_parameters())
    offload.reset_traffic()
    loss = model.loss_fn(params, cfg_t,
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         **offload.loss_kwargs(
                             offload.SentinelConfig(mode=mode,
                                                    mi_periods=mi)))
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads))


@pytest.mark.parametrize("mi", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_moe_loss_and_grads_match_reference(arch, mode, mi):
    """Each mode and MI gives the reference's loss (the NLL plus every
    MoE layer's aux) and gradients, router and expert banks included;
    "offload" hands each of estimate_offload_traffic's blocks' carries to
    the host store and takes it back once (on the CPU, no byte moves),
    the other modes none: the aux is no carry."""
    cfg_j, params_j, cfg_t, batch = arch
    kw_j = ref_offload.loss_kwargs(ref_offload.SentinelConfig(
        mode=mode, mi_periods=mi))
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss_fn(p, cfg_j, bj, **kw_j)))(params_j)
    grads_j = _numpy(grads_j)

    params = params_from_jax(cfg_t, _numpy(params_j), device="cpu",
                             requires_grad=True)
    loss, grads = _port_step(cfg_t, params, batch, mode, mi)
    torch.testing.assert_close(loss, torch.tensor(float(loss_j)),
                               **LOSS_TOL)
    for name, g in grads.items():
        torch.testing.assert_close(
            g, torch.from_numpy(np.array(reference_leaf(cfg_t, grads_j,
                                                        name))),
            **GRAD_TOL, msg=lambda m: f"{mode} mi {mi} {name}: {m}")

    prof = TraceProfile(num_periods=cfg_t.num_periods, num_steps=0)
    blocks = offload.estimate_offload_traffic(prof, mi, 1)["blocks"]
    n = blocks if mode == "offload" else 0
    assert offload.traffic == {"out": n, "in": n, "d2h": 0, "h2d": 0}


@pytest.mark.parametrize("mi", [1, 2])
def test_moe_modes_equal_full(arch, mi):
    """Inside the port, every blocked mode's loss and gradient norm equal
    full's (MODE_LOSS_RTOL, MODE_GNORM_RTOL), the gates chip_smoke.py
    holds the card's runs to."""
    cfg_j, params_j, cfg_t, batch = arch
    params = params_from_jax(cfg_t, _numpy(params_j), device="cpu",
                             requires_grad=True)
    out = {}
    for mode in MODES:
        loss, grads = _port_step(cfg_t, params, batch, mode, mi)
        gn = float(torch.sqrt(sum((g.double() ** 2).sum()
                                  for g in grads.values())))
        out[mode] = (float(loss), gn)
    lf, gf = out["full"]
    for mode in MODES[1:]:
        l, g = out[mode]
        assert abs(l - lf) <= MODE_LOSS_RTOL * abs(lf), (mode, l, lf)
        assert abs(g - gf) <= MODE_GNORM_RTOL * gf, (mode, g, gf)


@pytest.mark.parametrize("mode", ["remat", "offload"])
def test_aux_gradient_crosses_the_blocks(arch, mode):
    """The aux loss alone (the router's load-balance term, scaled up) in
    a blocked mode has the reference's gradient on every router, and a
    nonzero one: a block that dropped its aux would give the routers
    none through the load-balance term."""
    cfg_j, params_j, cfg_t, batch = arch
    scale = dict(router_aux_weight=10.0)
    cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(cfg_j.moe,
                                                               **scale))
    cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(cfg_t.moe,
                                                               **scale))
    kw_j = ref_offload.loss_kwargs(ref_offload.SentinelConfig(mode, 1))
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    _, grads_j = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss_fn(p, cfg_j, bj, **kw_j)))(params_j)
    grads_j = _numpy(grads_j)
    params = params_from_jax(cfg_t, _numpy(params_j), device="cpu",
                             requires_grad=True)
    _, grads = _port_step(cfg_t, params, batch, mode, 1)
    routers = [n for n in grads if n.endswith("moe.router")]
    assert len(routers) == cfg_t.num_periods
    for name in routers:
        want = torch.from_numpy(np.array(reference_leaf(cfg_t, grads_j,
                                                        name)))
        torch.testing.assert_close(grads[name], want, **GRAD_TOL)
        assert float(grads[name].abs().max()) > 0


def test_dense_block_keeps_one_output():
    """A dense config's block returns its carry alone (no aux output, no
    extra op); a MoE config's block returns (carry, float32 aux sum)."""
    for arch, moe in (("smollm-360m", False), ("granite-moe-3b-a800m",
                                               True)):
        cfg = get_config(arch).reduced()
        params = model.init_params(cfg, device="cpu", requires_grad=True)
        seen = []
        apply = transformer._Block.apply

        def spy(*args):
            out = apply(*args)
            seen.append(out)
            return out
        transformer._Block.apply = spy
        try:
            toks = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab_size, (1, 9)))
            loss = model.loss_fn(params, cfg, {"tokens": toks[:, :-1],
                                               "labels": toks[:, 1:]},
                                 remat_policy="remat", mi_periods=1)
            loss.backward()
        finally:
            transformer._Block.apply = apply
        assert len(seen) == cfg.num_periods
        for out in seen:
            if moe:
                y, a = out
                assert a.dtype == torch.float32 and a.dim() == 0
            else:
                assert isinstance(out, torch.Tensor)


def test_training_cli_on_moe_in_offload_mode(tmp_path):
    """python -m repro_torch.launch.train --arch granite-moe-3b-a800m
    --reduced --device cpu in offload mode profiles, plans on H100_COST and
    trains: the losses are finite."""
    from repro_torch.launch import train
    out = train.main(["--arch", "granite-moe-3b-a800m", "--reduced",
                      "--device", "cpu", "--mode", "offload", "--steps", "2",
                      "--seq", "16", "--batch", "2", "--ckpt-dir",
                      str(tmp_path)])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
