"""The partitioned training step of the port on the CPU
(``train.loop.PartitionedStep``: TP and DP over a (data, model) mesh,
FSDP, the collectives as autograd functions) against the port's
one-device step and against the reference's compiled sharded step.

Every rank is a thread on ``[cpu] * n``; torch runs on one thread in this
module, as in ``tests/test_torch_xlstm.py``.  The optimizer here takes
``lr`` 1 with ``eps`` 1 after a one-step warm-up, so AdamW's first update
is ``g / (|g| + 1)`` plus the decay: each parameter moves by about its
clipped gradient, and comparing the reassembled parameters compares the
gradients.  Tolerances are fp32's, stated with each test."""
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro_torch import collectives
from repro_torch import sharding as shd
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import offload
from repro_torch.core.offload import SentinelConfig
from repro_torch.launch import dryrun, specs
from repro_torch.models import kvcache, model, transformer
from repro_torch.optim import adamw
from repro_torch.train import loop

CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
OPT = adamw.OptConfig(lr=1.0, warmup_steps=1, eps=1.0)
# fp32 on both sides: the partitioned sums add the same terms in another
# order (measured within 6e-8 of the one-device step)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 4, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(name: str):
    """The reduced config; granite's dispatch groups cut to 16 tokens so
    that a group lies within one data rank's rows (the step refuses a
    group spanning two); "smollm-360m+wide": full-width smollm-360m at 2
    layers in fp32, whose 15/5 heads of 64 a 2-way model split cuts;
    "granite-moe-3b-a800m+e6": reduced granite with 6 experts, which a
    model axis of 4 does not divide (ROADMAP F4)."""
    if name == "smollm-360m+wide":
        return dataclasses.replace(get_config("smollm-360m"), num_layers=2,
                                   dtype="float32")
    arch, _, experts = name.partition("+e")
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, group_size=16,
            num_experts=int(experts or cfg.moe.num_experts)))
    return cfg


def _batch(cfg, b=B, s=S, seed=1):
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)))
            for k in ("tokens", "labels")}


def _one_device(cfg, params, batch, scfg):
    p = model.init_params(cfg, device="cpu", requires_grad=True)
    p.load_state_dict(params.state_dict())
    state = {"params": p, "opt": adamw.init(p, OPT),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = loop.make_train_step(cfg, scfg, OPT)(state, batch)
    return state["params"], m


def _partitioned(cfg, params, batch, shape, scfg, **rule_kw):
    mesh = shd.Mesh(shape, ("data", "model"),
                    devices=[CPU] * (shape[0] * shape[1]))
    step = loop.make_train_step(cfg, scfg, OPT,
                                shd.tp_dp_rules(mesh, **rule_kw))
    try:
        states = step.init_states(params)
        states, m = step(states, batch)
        return step, states, m
    finally:
        step.close()


def _check_equal(cfg, shape, scfg, **rule_kw):
    """The partitioned step against the one-device step from the same
    parameters and batch: the loss and grad_norm of every rank, and
    every reassembled parameter."""
    params = model.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg)
    p1, m1 = _one_device(cfg, params, batch, scfg)
    step, states, m = _partitioned(cfg, params, batch, shape, scfg,
                                   **rule_kw)
    for r in m["ranks"]:
        torch.testing.assert_close(r["loss"], m1["loss"], **LOSS_TOL)
        torch.testing.assert_close(r["grad_norm"], m1["grad_norm"],
                                   **LOSS_TOL)
        assert torch.equal(r["loss"], m["loss"])
        assert torch.equal(r["grad_norm"], m["grad_norm"])
    whole = step.gather(states)
    for (name, a), (_, b) in zip(whole.named_parameters(),
                                 p1.named_parameters()):
        torch.testing.assert_close(a, b.detach(), **PARAM_TOL, msg=name)
    return step, states


MODE_CASES = [("full", 1)] + [(m, mi) for m in ("remat", "save_hbm",
                                                 "offload")
                              for mi in (1, 2)]


@pytest.mark.parametrize("mode,mi", MODE_CASES)
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
def test_partitioned_step_equals_one_device_in_every_mode(arch, mode, mi):
    """(2, 2) under tp_dp_rules, Sentinel's four modes at MI 1 and 2:
    loss and grad_norm within 1e-5, every parameter within 1e-5 (granite:
    its aux averaged over data before the product, the router's gradient
    whole on every model rank)."""
    _check_equal(_config(arch), (2, 2),
                 SentinelConfig(mode=mode, mi_periods=mi))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 4)])
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
def test_partitioned_step_equals_one_device_on_other_meshes(arch, shape):
    """TP alone, DP alone, and a model axis of 4 (the reduced configs'
    2 KV heads cut: k and v gathered, their gathers' backward a
    reduce-scatter), in ``full``."""
    _check_equal(_config(arch), shape, SentinelConfig(mode="full"))


RULE_CASES = [({"fsdp": True}, False), ({"dp_only": True}, False),
              ({}, True)]


@pytest.mark.parametrize("mode", ["full", "offload"])
@pytest.mark.parametrize("rule_kw,moments_off", RULE_CASES)
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
def test_partitioned_step_with_fsdp_dp_only_and_offloaded_moments(
        arch, rule_kw, moments_off, mode):
    """(2, 2): FSDP (every d_model leaf gathered over data where it is
    used, its gradient reduce-scattered), ``dp_only`` (the batch over
    data x model, no TP collective) and the moments placed off the device
    (on the CPU the placement is the device itself), in full and offload
    mode."""
    _check_equal(_config(arch), (2, 2),
                 SentinelConfig(mode=mode, mi_periods=1,
                                offload_opt_state=moments_off), **rule_kw)


@pytest.mark.parametrize("shape", [(1, 4), (2, 4)])
@pytest.mark.parametrize("mode", ["full", "offload"])
def test_expert_banks_the_model_axis_does_not_divide(mode, shape):
    """Reduced granite with 6 experts on a model axis of 4 (ROADMAP F4):
    the banks split on the expert hidden dim (each rank holds every
    expert's 16 of 64 hidden columns, ``sharding_for``'s spec), the
    combine of ``wo``'s rows a partial sum; loss, grad_norm and every
    parameter within 1e-5 of one device, FSDP on at (2, 4)."""
    cfg = _config("granite-moe-3b-a800m+e6")
    step, states = _check_equal(cfg, shape,
                                SentinelConfig(mode=mode, mi_periods=1),
                                fsdp=shape[0] > 1)
    for st in states:
        wi = st["params"].layers[0].moe.wi
        assert tuple(wi.shape[::2]) == (6, 16)
    assert step.ledger["counts"]["all-reduce"] > 0


@pytest.mark.parametrize("arch", ["gemma2-2b", "gemma3-12b",
                                  "internlm2-1.8b"])
def test_partitioned_step_on_the_other_families(arch):
    """The other pure-attention families at (2, 2) with FSDP in offload
    mode: softcaps, local windows, QK-norm (its weights' gradient summed
    over the model ranks' heads), untied heads."""
    _check_equal(_config(arch), (2, 2),
                 SentinelConfig(mode="offload", mi_periods=1), fsdp=True)


@pytest.mark.parametrize("shape,mode,fsdp", [((1, 2), "full", False),
                                             ((2, 2), "offload", True)])
def test_partitioned_step_that_cuts_heads(shape, mode, fsdp):
    """Full-width smollm-360m at 2 layers, fp32, B 2 x S 16: its 960 query
    and 320 KV columns split into 7.5 and 2.5 heads a rank, so q, k and v
    are gathered and the rank's block of the output narrowed back: the
    gathers' gradient is a partial sum, reduce-scattered.  Within 1e-5 of
    one device."""
    cfg = _config("smollm-360m+wide")
    params = model.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg, b=2)
    scfg = SentinelConfig(mode=mode, mi_periods=1)
    p1, m1 = _one_device(cfg, params, batch, scfg)
    step, states, m = _partitioned(cfg, params, batch, shape, scfg,
                                   fsdp=fsdp)
    torch.testing.assert_close(m["loss"], m1["loss"], **LOSS_TOL)
    torch.testing.assert_close(m["grad_norm"], m1["grad_norm"], **LOSS_TOL)
    for (name, a), (_, b) in zip(step.gather(states).named_parameters(),
                                 p1.named_parameters()):
        torch.testing.assert_close(a, b.detach(), **PARAM_TOL, msg=name)
    assert step.ledger["counts"]["reduce-scatter"] > 0


def _positions_sharing(step, spec, axis):
    """Groups of mesh positions that hold the same block of a leaf laid
    out by ``spec`` and differ on ``axis`` only."""
    groups = {}
    for i, pos in enumerate(step.positions):
        blk = shd.block_coords(spec, pos, step.rules.mesh)
        rest = tuple(v for a, v in pos.items() if a != axis)
        groups.setdefault((blk, rest), []).append(i)
    return [g for g in groups.values() if len(g) > 1]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
def test_replicated_leaves_agree_across_ranks(arch, fsdp, monkeypatch):
    """On (2, 4) in offload mode, every leaf replicated over an axis
    (every leaf over ``data`` without FSDP; the norms, the router and any
    leaf the model axis does not divide over ``model``) holds the same
    gradient and the same updated value, bit for bit, on every rank of
    that axis."""
    cfg = _config(arch)
    grads = {}
    real = adamw.update

    def update(g, state, params, ocfg):
        ctx = shd.current_rank()
        grads[tuple(ctx.coords.values())] = {k: v.clone()
                                             for k, v in g.items()}
        return real(g, state, params, ocfg)

    monkeypatch.setattr(adamw, "update", update)
    params = model.init_params(cfg, seed=0, device="cpu")
    step, states, _ = _partitioned(
        cfg, params, _batch(cfg, b=4), (2, 4),
        SentinelConfig(mode="offload", mi_periods=1), fsdp=fsdp)
    checked = 0
    for name, spec in states[0]["params"].shard_specs.items():
        for axis in ("data", "model"):
            if any(e is not None and axis in shd._axes_of(e)
                   for e in spec):
                continue
            for group in _positions_sharing(step, spec, axis):
                first = step.positions[group[0]]
                for i in group[1:]:
                    pos = step.positions[i]
                    assert torch.equal(
                        grads[tuple(pos.values())][name],
                        grads[tuple(first.values())][name]), (name, axis)
                    assert torch.equal(
                        dict(states[i]["params"].named_parameters())[name],
                        dict(states[group[0]]["params"]
                             .named_parameters())[name]), (name, axis)
                    checked += 1
    assert checked > 0


def test_backwards_run_on_the_rank_thread_under_its_context(monkeypatch):
    """Inside every collective's backward and every ``_Block.backward``
    of an offload step with FSDP on (2, 2): the thread is the one that ran
    the forward, ``sharding.current_rank()`` is that rank's own context,
    and autograd's multithreading is off."""
    seen = []

    def wrap(cls, name):
        fwd, bwd = cls.forward, cls.backward

        def forward(ctx, *args):
            ctx.seen = (threading.get_ident(), shd.current_rank())
            return fwd(ctx, *args)

        def backward(ctx, *grads):
            seen.append((name, ctx.seen, threading.get_ident(),
                         shd.current_rank(),
                         torch._C._is_multithreading_enabled()))
            return bwd(ctx, *grads)

        monkeypatch.setattr(cls, "forward", staticmethod(forward))
        monkeypatch.setattr(cls, "backward", staticmethod(backward))

    for cls, name in ((collectives._Conjugate, "conjugate"),
                      (collectives._AllGather, "all-gather"),
                      (collectives._AllReduce, "all-reduce"),
                      (transformer._Block, "block")):
        wrap(cls, name)
    cfg = _config("granite-moe-3b-a800m")
    params = model.init_params(cfg, seed=0, device="cpu")
    _partitioned(cfg, params, _batch(cfg), (2, 2),
                 SentinelConfig(mode="offload", mi_periods=1), fsdp=True)
    assert {s[0] for s in seen} == {"conjugate", "all-gather", "all-reduce",
                                    "block"}
    for name, (tid, ctx), tid_b, ctx_b, multi in seen:
        assert ctx is not None and ctx_b is ctx, name
        assert tid_b == tid, name
        assert multi is False, name
    assert len({id(s[3]) for s in seen}) == 4       # every rank's own


def test_a_failed_rank_raises(monkeypatch):
    """No fallback: a rank whose loss raises makes the step raise its
    error, and the rank threads stop."""
    cfg = _config("smollm-360m")
    real = model.loss_fn

    def loss_fn(params, cfg, batch, **kw):
        if shd.current_rank().coords == {"data": 1, "model": 0}:
            raise RuntimeError("rank (1, 0) lost its card")
        return real(params, cfg, batch, **kw)

    monkeypatch.setattr(model, "loss_fn", loss_fn)
    params = model.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="lost its card"):
        _partitioned(cfg, params, _batch(cfg), (2, 2),
                     SentinelConfig(mode="full"))


def test_refusals():
    """A MoE dispatch group spanning two data ranks' rows, and FSDP on a
    batch the data axis does not split, raise rather than compute a
    different step; the page pools under a rank context say that the
    reference runs them on one device only.  Megatron-SP rules
    (``seq_parallel=True``), which a rank context refused until item 11b
    part 2b (ROADMAP F3), are taken: the step under them equals the
    one-device step, and a rank context over them is made
    (``tests/test_torch_tp_seqpar.py`` holds the rest).  MLA and
    Mamba run partitioned since part 2a (``tests/test_torch_tp_families.py``),
    the xLSTM layers since its items 3-4
    (``tests/test_torch_tp_recurrent.py``)."""
    cfg = get_config("granite-moe-3b-a800m").reduced()     # groups of 512
    params = model.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="dispatch groups"):
        _partitioned(cfg, params, _batch(cfg), (2, 2),
                     SentinelConfig(mode="full"))
    cfg = _config("smollm-360m")
    params = model.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="batch splits over no"):
        _partitioned(cfg, params, _batch(cfg, b=1), (2, 2),
                     SentinelConfig(mode="full"), fsdp=True)
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              use_paged_decode=True)
    params = model.init_params(cfg, seed=0, device="cpu")
    pools = kvcache.PagedKVPools(cfg, 1, 16, 4, torch.float32, CPU)
    rules = shd.serve_rules(shd.Mesh((2,), ("model",)))
    ctx = shd.RankContext(collectives.ShapeGroup(2), 0, rules, {"model": 0})
    rank = shd.shard_params(params, rules, {"model": 0})
    table, tier = pools.arrays()
    view = {"page_table": table[:1], "page_tier": tier[:1],
            "page_tokens": 4, "active": torch.ones(1, dtype=torch.bool),
            "garbage_page": pools.garbage}
    with shd.rank_context(ctx), \
            pytest.raises(NotImplementedError, match="on one device only"):
        model.forward(rank, cfg, {"tokens": torch.zeros(1, 1,
                                                        dtype=torch.long)},
                      caches=pools.tree, cache_index=torch.zeros(
                          1, dtype=torch.long), decode=True,
                      paged_view=view)
    _check_equal(_config("smollm-360m"), (2, 2),
                 SentinelConfig(mode="full"), seq_parallel=True)
    rules = shd.tp_dp_rules(shd.Mesh((2, 2), ("data", "model")),
                            seq_parallel=True)
    ctx = shd.mesh_rank(collectives.ShapeMesh(rules.mesh), rules,
                        {"data": 0, "model": 0})
    assert ctx.rules.spec(shd.RESIDUAL, (2, 16, 64)) == ("data", "model",
                                                          None)


def test_offload_carries_per_rank_equal_the_estimate():
    """Offload mode at MI 1 on (2, 2): each rank's store takes out and
    gives back one carry a block (``offload.rank_traffic``), as
    ``estimate_offload_traffic`` counts for one device."""
    cfg = _config("smollm-360m")
    params = model.init_params(cfg, seed=0, device="cpu")
    offload.reset_traffic()
    _partitioned(cfg, params, _batch(cfg), (2, 2),
                 SentinelConfig(mode="offload", mi_periods=1))
    assert len(offload.rank_traffic) == 4
    for pos, t in offload.rank_traffic.items():
        assert t["out"] == t["in"] == cfg.num_periods, pos
    assert offload.traffic["out"] == 4 * cfg.num_periods


def test_differentiable_collectives_pair_forward_and_backward():
    """On two CPU ranks: a model-group all-reduce's backward is the
    identity and a data-group one's an all-reduce; ``conjugate`` is the
    identity forward and an all-reduce backward; an all-gather's backward
    is a reduce-scatter and a reduce-scatter's an all-gather; the ledger
    counts the backward collectives too."""
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn(4, 6, generator=gen) for _ in range(2)]
    gs = [torch.randn(4, 12, generator=gen) for _ in range(2)]
    group = collectives.Group([CPU] * 2)

    def run(r):
        out = {}
        for name, fn, g in (
                ("sum", lambda x: collectives.all_reduce(x, group, r),
                 gs[r][:, :6]),
                ("sum-sum", lambda x: collectives.all_reduce(
                    x, group, r, grad="sum"), gs[r][:, :6]),
                ("f", lambda x: collectives.conjugate(x, group, r),
                 gs[r][:, :6]),
                ("gather", lambda x: collectives.all_gather(x, group, r, 1),
                 gs[r]),
                ("scatter", lambda x: collectives.reduce_scatter(
                    x, group, r, 1), gs[r][:, :3])):
            x = xs[r].clone().requires_grad_(True)
            y = fn(x)
            (y * g).sum().backward()
            out[name] = (y.detach(), x.grad)
        return out

    try:
        outs = group.run(run)
    finally:
        group.close()
    total, gsum = xs[0] + xs[1], gs[0] + gs[1]
    for r, out in enumerate(outs):
        assert torch.equal(out["sum"][0], total)
        assert torch.equal(out["sum"][1], gs[r][:, :6])
        assert torch.equal(out["sum-sum"][1], gsum[:, :6])
        assert torch.equal(out["f"][0], xs[r])
        assert torch.equal(out["f"][1], gsum[:, :6])
        assert torch.equal(out["gather"][0], torch.cat(xs, 1))
        assert torch.equal(out["gather"][1], gsum[:, 6 * r:6 * r + 6])
        assert torch.equal(out["scatter"][0], total[:, 3 * r:3 * r + 3])
        assert torch.equal(out["scatter"][1],
                           torch.cat([gs[0][:, :3], gs[1][:, :3]], 1))
    assert group.ledger["counts"] == {
        "all-gather": 2, "all-reduce": 4, "reduce-scatter": 2,
        "all-to-all": 0, "collective-permute": 0}


def test_carry_counts_hold_under_many_rank_threads():
    """Sixteen rank threads (more than the cores) each put and get 200
    carries under a rank context of a (4, 4) mesh, the interpreter
    switching threads every microsecond: no count is lost, in total or
    per rank."""
    rules = shd.tp_dp_rules(shd.Mesh((4, 4), ("data", "model")))
    n, per = 16, 200
    x = torch.ones(8)
    offload.reset_traffic()

    def rank(i):
        ctx = shd.RankContext(None, 0, rules, {"data": i // 4,
                                               "model": i % 4})
        with shd.rank_context(ctx):
            store = offload.CarryStore("host")
            for b in range(per):
                store.put(b, x)
            for b in reversed(range(per)):
                store.get(b)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=rank, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert offload.traffic["out"] == offload.traffic["in"] == n * per
    assert len(offload.rank_traffic) == n
    assert all(t["out"] == t["in"] == per
               for t in offload.rank_traffic.values())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["smollm-360m", "internlm2-1.8b"])
def test_ledger_equals_the_closed_form(arch):
    """The dry run's rank (0, 0) ledger of a train cell (full width, 2
    layers, B 8 x S 128, on meta) equals ``chip_smoke.py``'s closed form
    (``train_expected_ledger``) on (2, 2), (2, 4), (1, 2) and (2, 1),
    FSDP on and off, full and offload: smollm's cut heads gather q, k
    and v; internlm2's 16/8 heads split whole."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    for shape in ((2, 2), (2, 4), (1, 2), (2, 1)):
        for fsdp in (False, True):
            for mode in ("full", "offload"):
                rules = shd.tp_dp_rules(shd.Mesh(shape, ("data", "model")),
                                        fsdp=fsdp)
                fn, args, in_sh = specs.build_train_cell(
                    cfg, ShapeConfig("w", 128, 8, "train"), rules,
                    SentinelConfig(mode=mode, mi_periods=1))
                led = dryrun.rank_collectives(fn, args, in_sh, rules)
                got = {k: {t: v for t, v in led[k].items() if v}
                       for k in ("bytes", "counts")}
                assert got == cs.train_expected_ledger(
                    cfg, 8, 128, *shape, blocked=mode != "full",
                    fsdp=fsdp), (shape, fsdp, mode)


# ------------------------------------------------------- the reference --

# The reference's train cells compiled here: (name, arch, mesh, the
# tp_dp_rules keywords).  Plain tp_dp_rules at (2, 4) and (2, 2) is
# test_small_mesh_dryrun_subprocess's cell; FSDP, dp_only and granite
# (the MoE aux averaged over data, the vocab-parallel loss with MoE) run
# at (2, 2); granite with 6 experts at (2, 4), whose banks split on the
# expert hidden dim (ROADMAP F4).
REF_CASES = [("2x4", "smollm-360m", (2, 4), {}),
             ("2x2", "smollm-360m", (2, 2), {}),
             ("2x2-fsdp", "smollm-360m", (2, 2), {"fsdp": True}),
             ("2x2-dp_only", "smollm-360m", (2, 2), {"dp_only": True}),
             ("2x2-granite", "granite-moe-3b-a800m", (2, 2), {}),
             ("2x4-granite-e6", "granite-moe-3b-a800m+e6", (2, 4), {})]

# The reference's compiled train cells' collective_bytes on this JAX
# (0.9.0, forced CPU devices), and the port's ledger of the same step,
# pinned side by side (ROADMAP R13).  XLA reshards its own way where the
# port gathers whole KV heads and averages the data-parallel gradients
# in one all-reduce.
XLA_BYTES = {
    "2x4": {"all-gather": 131072.0, "all-reduce": 1389348.0,
            "all-to-all": 98304.0, "collective-permute": 49152.0},
    "2x2": {"all-reduce": 1463076.0},
    "2x2-fsdp": {"all-gather": 495104.0, "all-reduce": 1397584.0,
                 "all-to-all": 131072.0, "collective-permute": 1024.0},
    "2x2-dp_only": {"all-reduce": 558852.0},
    "2x2-granite": {"all-gather": 32768.0, "all-reduce": 1563524.0},
    "2x4-granite-e6": {"all-gather": 180224.0, "all-reduce": 5226420.0,
                       "all-to-all": 98304.0, "collective-permute": 49152.0},
}
PORT_BYTES = {
    "2x4": {"all-gather": 262144.0, "all-reduce": 1028360.0,
            "reduce-scatter": 32768.0},
    "2x2": {"all-reduce": 1134856.0},
    "2x2-fsdp": {"all-gather": 362752.0, "all-reduce": 920588.0,
                 "reduce-scatter": 107136.0},
    "2x2-dp_only": {"all-reduce": 427268.0},
    "2x2-granite": {"all-reduce": 1239496.0},
    "2x4-granite-e6": {"all-gather": 262144.0, "all-reduce": 1134120.0,
                       "reduce-scatter": 32768.0},
}

REFERENCE = textwrap.dedent("""
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro import sharding as shd
    from repro.configs.base import ShapeConfig, get_config
    from repro.core.offload import SentinelConfig
    from repro.launch import specs
    from repro.launch.dryrun import collective_bytes
    from repro.models import model
    from repro.models.layers import split_params
    from repro.optim import adamw

    out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
    shape = ShapeConfig("tiny", 64, 8, "train")
    opt = adamw.OptConfig(lr=1.0, warmup_steps=1, eps=1.0)
    scfg = SentinelConfig(mode="offload", mi_periods=1)
    rec = {}
    for name, arch, dims, kw in cases:
        arch, _, experts = arch.partition("+e")
        cfg = get_config(arch).reduced()
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, group_size=16,
                num_experts=int(experts or cfg.moe.num_experts)))
        rng = np.random.default_rng(0)
        batch_np = {k: rng.integers(0, cfg.vocab_size, (8, 64))
                    .astype(np.int32) for k in ("tokens", "labels")}
        np.savez(os.path.join(out_dir, f"batch_{name}.npz"), **batch_np)
        devs = np.asarray(jax.devices()[:dims[0] * dims[1]])
        mesh = jax.sharding.Mesh(devs.reshape(dims), ("data", "model"))
        rules = shd.tp_dp_rules(mesh, **kw)
        with mesh, shd.axis_rules(rules):
            fn, args, in_sh = specs.build_train_cell(cfg, shape, rules,
                                                     scfg, opt)
            compiled = jax.jit(fn, in_shardings=in_sh).lower(
                *args).compile()
            params, _ = split_params(
                model.init_params(jax.random.PRNGKey(0), cfg))
            state = {"params": params, "opt": adamw.init(params, opt),
                     "step": jnp.zeros((), jnp.int32)}
            state = jax.device_put(state, in_sh[0])
            batch = jax.device_put(
                {k: jnp.asarray(v) for k, v in batch_np.items()}, in_sh[1])
            new, m = compiled(state, batch)
            np.savez(os.path.join(out_dir, f"new_{name}.npz"),
                     **{jax.tree_util.keystr(k): np.asarray(v)
                        for k, v in jax.tree_util.tree_leaves_with_path(
                            new["params"])})
            rec[name] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "bytes": collective_bytes(
                    compiled.as_text(),
                    loop_trips=float(cfg.num_periods))["bytes"]}
    print(json.dumps(rec))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded train steps of ``REF_CASES`` (B 8 x S 64,
    offload, MI 1, which this JAX runs on its CPU devices), compiled and
    run on meshes of forced CPU devices in a subprocess: each one's batch,
    loss, grad_norm, updated parameters and collective bytes."""
    out = tmp_path_factory.mktemp("ref_train")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(out),
                          json.dumps(REF_CASES)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    return rec, out


@pytest.mark.parametrize("name,arch,dims,kw", REF_CASES,
                         ids=[c[0] for c in REF_CASES])
def test_partitioned_step_equals_the_reference(reference, name, arch, dims,
                                               kw):
    """The port's partitioned step on ``[cpu] * 8`` or ``* 4`` under the
    same rules, from the reference's parameters
    (``weights.params_from_jax``) and batch, in the reference's mode:
    loss within 1e-5, grad_norm within 1e-5 of it, every updated
    parameter within 1e-4.  XLA's collective bytes and the port's ledger
    (``chip_smoke.train_expected_ledger``'s closed form) are pinned side
    by side."""
    import jax
    from repro.configs.base import get_config as ref_config
    from repro.models import model as ref_model
    from repro.models.layers import split_params
    from repro_torch.weights import params_from_jax

    rec, out = reference
    cfg = _config(arch)
    ref_cfg = ref_config(arch.partition("+e")[0]).reduced()
    if ref_cfg.moe is not None:
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
            ref_cfg.moe, group_size=16, num_experts=cfg.moe.num_experts))
    tree, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                 ref_cfg))
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, tree),
                             device="cpu")
    batch = {k: torch.as_tensor(v.astype(np.int64))
             for k, v in np.load(out / f"batch_{name}.npz").items()}
    step, states, m = _partitioned(
        cfg, params, batch, dims, SentinelConfig(mode="offload",
                                                 mi_periods=1), **kw)
    assert abs(float(m["loss"]) - rec[name]["loss"]) <= 1e-5
    assert abs(float(m["grad_norm"]) - rec[name]["grad_norm"]) <= \
        1e-5 * rec[name]["grad_norm"]
    new = np.load(out / f"new_{name}.npz")
    new_tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [new[jax.tree_util.keystr(k)] for k, _ in leaves])
    want = params_from_jax(cfg, new_tree, device="cpu")
    for (leaf, a), (_, b) in zip(step.gather(states).named_parameters(),
                                 want.named_parameters()):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=leaf)
    nz = {k: v for k, v in rec[name]["bytes"].items() if v}
    assert nz == XLA_BYTES[name]
    assert {k: v for k, v in step.ledger["bytes"].items() if v} == \
        PORT_BYTES[name]
