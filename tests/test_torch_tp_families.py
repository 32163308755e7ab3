"""MLA and Mamba under a rank context, on the CPU: reduced deepseek-v2-lite
(MLA, its MoE and its dense prologue) and reduced zamba2-7b (Mamba2 and
its shared attention block) in the partitioned training step
(``train.loop.PartitionedStep``) against the one-device step, in the
tensor-parallel prefill (``serve.disagg.TensorParallelPrefill``) and a
decode step under a rank context against one device, and against the
reference's own partitioned programs: its compiled train cells, its TP
prefill and its compiled serve cells, all in one subprocess of forced
JAX devices, with XLA's own resharding pinned beside the port's ledger
(ROADMAP R14).

Every rank is a thread on ``[cpu] * n``; torch runs on one thread in this
module.  Tolerances are fp32's, stated with each test."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import collectives
from repro_torch import sharding as shd
from repro_torch.configs import get_config
from repro_torch.core.offload import SentinelConfig
from repro_torch.models import kvcache, model, ssm
from repro_torch.optim import adamw
from repro_torch.serve.disagg import TensorParallelPrefill
from repro_torch.train import loop

CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("deepseek-v2-lite-16b", "zamba2-7b")
OPT = adamw.OptConfig(lr=1.0, warmup_steps=1, eps=1.0)
# fp32 on both sides: the partitioned sums add the same terms in another
# order
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 4, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(arch: str):
    """The reduced config; a MoE's dispatch groups cut to 16 tokens, so
    that a group lies within one data rank's rows."""
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, group_size=16))
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


MODES = ("full", "remat", "save_hbm", "offload")


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_step_equals_one_device(arch, shape, mode, fsdp):
    """TP alone and TP with DP, in Sentinel's four modes at MI 1, FSDP off
    and on: every rank's loss and grad_norm within 1e-5 of one device's
    and equal across ranks, every reassembled parameter within 1e-5 (MLA:
    the latent and rope key whole, its heads split; Mamba: the rank's
    block of ``x @ w_in`` gathered, K4's plain version on its heads, the
    gated norm's sum of squares all-reduced; zamba2's shared block's
    gradient summed over its uses)."""
    cfg = _config(arch)
    scfg = SentinelConfig(mode=mode, mi_periods=1)
    params = model.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg)
    p1, m1 = _one_device(cfg, params, batch, scfg)
    step, states, m = _partitioned(cfg, params, batch, shape, scfg,
                                   fsdp=fsdp)
    for r in m["ranks"]:
        torch.testing.assert_close(r["loss"], m1["loss"], **LOSS_TOL)
        torch.testing.assert_close(r["grad_norm"], m1["grad_norm"],
                                   **LOSS_TOL)
        assert torch.equal(r["loss"], m["loss"])
        assert torch.equal(r["grad_norm"], m["grad_norm"])
    for (name, a), (_, b) in zip(step.gather(states).named_parameters(),
                                 p1.named_parameters()):
        torch.testing.assert_close(a, b.detach(), **PARAM_TOL, msg=name)
    assert step.ledger["counts"]["all-reduce"] > 0


@pytest.mark.parametrize("mode", ["full", "offload"])
def test_partitioned_step_that_cuts_mla_heads(mode):
    """Reduced deepseek-v2-lite on (1, 8): its 4 heads split into half
    heads (``wq``'s 96 columns in blocks of 12), so q and the
    up-projected keys and values are gathered, every head runs on every
    rank, and the rank's block of the output is taken back for its rows
    of ``wo``; the gathers' backward is a reduce-scatter.  Loss,
    grad_norm and every parameter within 1e-5 of one device."""
    cfg = _config("deepseek-v2-lite-16b")
    scfg = SentinelConfig(mode=mode, mi_periods=1)
    params = model.init_params(cfg, seed=0, device="cpu")
    batch = _batch(cfg)
    p1, m1 = _one_device(cfg, params, batch, scfg)
    step, states, m = _partitioned(cfg, params, batch, (1, 8), scfg)
    torch.testing.assert_close(m["loss"], m1["loss"], **LOSS_TOL)
    torch.testing.assert_close(m["grad_norm"], m1["grad_norm"], **LOSS_TOL)
    for (name, a), (_, b) in zip(step.gather(states).named_parameters(),
                                 p1.named_parameters()):
        torch.testing.assert_close(a, b.detach(), **PARAM_TOL, msg=name)
    assert step.ledger["counts"]["reduce-scatter"] > 0


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("scale", ["full", "reduced"])
def test_w_in_split_does_not_follow_the_heads(scale, n):
    """zamba2-7b's ``w_in`` columns [z | x, B, C | dt] cut into n blocks
    (``sharding_for``'s spec, as the rank program cuts them) that are not
    the rank's heads' z and x channels: a rank program that took its own
    columns for its heads would compute another block.  At full width the
    cuts fall inside a head at 2 and 4 ranks (7,288 = z and 120 x
    channels, 3,644 inside z); reduced, 152 is z and 24 x channels, and
    76 falls inside a head of z."""
    cfg = get_config("zamba2-7b")
    cfg = cfg if scale == "full" else cfg.reduced()
    d_inner, H, P, N, K = ssm.dims(cfg)
    cols = 2 * d_inner + 2 * N + H
    rules = shd.serve_rules(shd.Mesh((n,), ("model",)))
    spec = shd.sharding_for((cfg.d_model, cols), ("embed", "ssm_heads"),
                            rules).spec
    assert spec == (None, "model")
    blk = cols // n
    for r in range(n):
        heads_z = (r * d_inner // n, (r + 1) * d_inner // n)
        assert (r * blk, (r + 1) * blk) != heads_z
    cuts = [r * blk for r in range(1, n)]
    inside = [c for c in cuts
              if (c < d_inner and c % P) or
              (d_inner <= c < 2 * d_inner and (c - d_inner) % P)]
    if scale == "full" or n == 4:
        assert inside
    if scale == "full":
        assert cuts[0] == {2: 7288, 4: 3644}[n]


def _tp_prefill(cfg, params, tokens, n):
    tp = TensorParallelPrefill(params, cfg, [CPU] * n, max_seq=32)
    try:
        last, fresh = tp({"tokens": tokens})
    finally:
        tp.close()
    return last, fresh, tp.ledger


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_equals_the_one_device_prefill(arch, n):
    """A 12-token prompt (max_seq 32) on ``[cpu] * n`` against
    ``model.prefill`` on one device: the last row's logits and every cache
    leaf within 1e-4, the ranks' blocks joined (the MLA latent's columns,
    the Mamba state's heads and conv tail's channels) in rank order; a
    decode step from the joined caches equals one from one device's
    within 1e-4."""
    cfg = get_config(arch).reduced()
    params = model.init_params(cfg, seed=3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 12),
                           generator=torch.Generator().manual_seed(5))
    last1, fresh1 = model.prefill(params, cfg, {"tokens": tokens},
                                  max_seq=32)
    last, fresh, ledger = _tp_prefill(cfg, params, tokens, n)
    torch.testing.assert_close(last, last1, atol=1e-4, rtol=0)
    for a, b in zip(fresh, fresh1):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape, k
            torch.testing.assert_close(a[k], b[k], atol=1e-4, rtol=0)
    nxt = tokens[:, -1:]
    d1, _ = model.decode_step(params, cfg, nxt, fresh1, 12)
    d, _ = model.decode_step(params, cfg, nxt, fresh, 12)
    torch.testing.assert_close(d, d1, atol=1e-4, rtol=0)
    assert ledger["counts"]["all-reduce"] > 0


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_under_a_rank_context_equals_one_device(arch, n):
    """The dry run's decode cell with numbers: a prefilled cache cut into
    each rank's blocks (``sharding_for`` of ``cache_logical_axes``), one
    decode step of 2 slots at per-slot offsets on every rank under
    ``serve_rules``: the ranks' vocab blocks of the logits and their
    updated cache blocks, joined, within 1e-4 of one device's (MLA
    gathers its latent, Mamba its conv tail)."""
    cfg = get_config(arch).reduced()
    params = model.init_params(cfg, seed=3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 10),
                           generator=torch.Generator().manual_seed(7))
    _, caches = model.prefill(params, cfg, {"tokens": tokens}, max_seq=16)
    index = torch.tensor([10, 10])
    nxt = tokens[:, :1]
    one = [{k: v.clone() for k, v in c.items()} for c in caches]
    want, one = model.decode_step(params, cfg, nxt, one, index)
    rules = shd.serve_rules(shd.Mesh((n,), ("model",)))
    axes = kvcache.cache_logical_axes(cfg)
    specs = [{k: shd.sharding_for(tuple(v.shape), axes[l][k], rules).spec
              for k, v in c.items()} for l, c in enumerate(caches)]
    group = collectives.Group([CPU] * n)
    ranks = [shd.shard_params(params, rules, {"model": r}) for r in range(n)]

    def rank(r):
        mine = [{k: shd._block_of(v, specs[l][k], {"model": r},
                                  rules.mesh).clone()
                 for k, v in c.items()} for l, c in enumerate(caches)]
        ctx = shd.RankContext(group, r, rules, {"model": r})
        with shd.rank_context(ctx):
            return model.decode_step(ranks[r], cfg, nxt, mine, index)

    try:
        outs = group.run(rank)
    finally:
        group.close()
    torch.testing.assert_close(torch.cat([o[0] for o in outs], dim=-1),
                               want, atol=1e-4, rtol=0)
    for l, c in enumerate(one):
        for k, v in c.items():
            dims = [i for i, e in enumerate(specs[l][k]) if e is not None]
            got = torch.cat([o[1][l][k] for o in outs], dims[0]) \
                if dims else outs[0][1][l][k]
            torch.testing.assert_close(got, v, atol=1e-4, rtol=0,
                                       msg=(l, k))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_with_a_tp_prefill_group_and_one_decode_shard(arch):
    """``DisaggregatedEngine(devices=[cpu], prefill_devices=[cpu] * 2,
    tp_prefill=True)``: two TP ranks admit on the prefill group, one
    decode shard serves (deepseek's latent on the dense one-shot path,
    zamba2's shared block on the pools and its Mamba state dense).  Four
    requests, three sharing a 9-token prefix, on 2 slots: the tokens and
    the edge ledger equal the engine's without TP, and the ledger equals
    ``predict_pool_counters(dense_admit=True)``; the TP ranks' collectives
    are in ``counters()``."""
    from repro_torch.runtime.plan import PlacementPlan
    from repro_torch.serve.disagg import DisaggregatedEngine
    from repro_torch.serve.engine import predict_pool_counters

    def toks(seed, n):
        return np.random.default_rng(seed).integers(0, 512, n)

    prefix = toks(7, 9)
    reqs = [(np.concatenate([prefix, toks(11 + i, 3 + 2 * i)]), d, "sys")
            for i, d in enumerate((6, 4, 5))] + [(toks(20, 15), 5, None)]
    plan = PlacementPlan(hot_window=16, slot_hot_windows=[4, 8],
                         page_tokens=4)
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              use_paged_decode=True)
    params = model.init_params(cfg, seed=0, device="cpu")
    got = {}
    for tp in (False, True):
        b = DisaggregatedEngine(params, cfg, 2, 32, plan=plan, devices=[CPU],
                                prefill_devices=[CPU] * 2, tp_prefill=tp)
        try:
            assert b.n_shards == 1 and b.tp_prefill == tp
            for t, d, key in reqs:
                b.submit(torch.as_tensor(t), d, prefix_key=key)
            out = []
            while b.queue or b._jobs or any(b.active):
                if not b.step():
                    break
                for i in range(b.B):
                    if not b.active[i] and b.outputs[i]:
                        out.append(tuple(b.outputs[i]))
                        b.outputs[i] = []
            b.mesh_table.check()
            got[tp] = (sorted(out), dict(b.edge_migration_bytes),
                       b.counters()["collectives"], b.page_tokens,
                       b._row_bytes)
        finally:
            b.close()
    assert got[True][0] == got[False][0] and len(got[True][0]) == 4
    assert got[True][1] == got[False][1]
    pred = predict_pool_counters(
        [(tuple(int(x) for x in t), d, None, k) for t, d, k in reqs], plan,
        slots=2, max_seq=32, page_tokens=got[True][3],
        row_bytes=got[True][4], dense_admit=True)
    assert got[True][1] == pred["edge_migration_bytes"]
    assert got[True][2]["counts"]["all-reduce"] > 0
    assert not any(got[False][2]["counts"].values())


# ------------------------------------------------------- the reference --

# The reference's partitioned programs of the two reduced models, in one
# subprocess of 8 forced CPU devices: the compiled train cell at (2, 2)
# (B 8 x S 64, offload at MI 1, ``tp_dp_rules``) run once from its
# parameters, its TP prefill of a 12-token prompt over 2 and 4 devices
# (``serve_rules`` on a ("model",) mesh), and its compiled prefill and
# decode cells at (2, 2) (``make_rules``, B 4 x S 16), each with its
# ``collective_bytes``
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
    from repro.launch.mesh import make_rules
    from repro.models import model
    from repro.models.layers import split_params
    from repro.optim import adamw

    out_dir, archs = sys.argv[1], json.loads(sys.argv[2])
    train_shape = ShapeConfig("tiny", 64, 8, "train")
    opt = adamw.OptConfig(lr=1.0, warmup_steps=1, eps=1.0)
    scfg = SentinelConfig(mode="offload", mi_periods=1)
    devs = jax.devices()

    def coll(c, txt):
        return collective_bytes(
            txt, loop_trips=float(c.num_periods))["bytes"]

    rec = {}
    for arch in archs:
        c = get_config(arch).reduced()
        cfg = c
        if cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, group_size=16))
        rng = np.random.default_rng(0)
        batch_np = {k: rng.integers(0, cfg.vocab_size, (8, 64))
                    .astype(np.int32) for k in ("tokens", "labels")}
        np.savez(os.path.join(out_dir, f"batch_{arch}.npz"), **batch_np)
        mesh = jax.sharding.Mesh(np.asarray(devs[:4]).reshape(2, 2),
                                 ("data", "model"))
        rules = shd.tp_dp_rules(mesh)
        params, _ = split_params(model.init_params(jax.random.PRNGKey(0),
                                                   cfg))
        with mesh, shd.axis_rules(rules):
            fn, args, in_sh = specs.build_train_cell(cfg, train_shape,
                                                     rules, scfg, opt)
            compiled = jax.jit(fn, in_shardings=in_sh).lower(
                *args).compile()
            state = {"params": params, "opt": adamw.init(params, opt),
                     "step": jnp.zeros((), jnp.int32)}
            state = jax.device_put(state, in_sh[0])
            batch = jax.device_put(
                {k: jnp.asarray(v) for k, v in batch_np.items()}, in_sh[1])
            new, m = compiled(state, batch)
            np.savez(os.path.join(out_dir, f"new_{arch}.npz"),
                     **{jax.tree_util.keystr(k): np.asarray(v)
                        for k, v in jax.tree_util.tree_leaves_with_path(
                            new["params"])})
        r = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
             "train": coll(cfg, compiled.as_text())}

        p, _ = split_params(model.init_params(jax.random.PRNGKey(0), c))
        t = jax.random.randint(jax.random.PRNGKey(5), (1, 12), 0,
                               c.vocab_size)
        f = jax.jit(lambda p, b, c=c: model.prefill(p, c, b, max_seq=32))
        sds, axes = specs.param_structs(c)
        r["tokens"], r["tp"] = np.asarray(t).tolist(), {}
        for n in (2, 4):
            mesh = jax.sharding.Mesh(np.asarray(devs[:n]), ("model",))
            rules = shd.serve_rules(mesh)
            ptp = jax.device_put(p, specs.shardings_from_axes(axes, rules,
                                                              sds))
            with mesh, shd.axis_rules(rules):
                last, _ = f(ptp, {"tokens": t})
                txt = f.lower(ptp, {"tokens": t}).compile().as_text()
            r["tp"][str(n)] = {"last": np.asarray(last).tolist(),
                               "coll": coll(c, txt)}
        r["cells"] = {}
        for kind in ("prefill", "decode"):
            mesh = jax.sharding.Mesh(np.asarray(devs[:4]).reshape(2, 2),
                                     ("data", "model"))
            rules = make_rules(mesh, kind=kind)
            build = specs.build_prefill_cell if kind == "prefill" \\
                else specs.build_decode_cell
            with mesh, shd.axis_rules(rules):
                fn, args, in_sh = build(c, ShapeConfig("tiny", 16, 4, kind),
                                        rules)
                txt = jax.jit(fn, in_shardings=in_sh).lower(
                    *args).compile().as_text()
            r["cells"][kind] = coll(c, txt)
        rec[arch] = r
    print(json.dumps(rec))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_families")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(out),
                          json.dumps(ARCHS)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1]), out


def _nonzero(ledger_bytes):
    return {k: v for k, v in ledger_bytes.items() if v}


def _ref_params(arch, cfg):
    import jax
    from repro.configs.base import get_config as ref_config
    from repro.models import model as ref_model
    from repro.models.layers import split_params
    from repro_torch.weights import params_from_jax
    ref_cfg = ref_config(arch).reduced()
    if ref_cfg.moe is not None and cfg.moe.group_size == 16:
        ref_cfg = dataclasses.replace(
            ref_cfg, moe=dataclasses.replace(ref_cfg.moe, group_size=16))
    tree, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                 ref_cfg))
    return tree, params_from_jax(cfg, jax.tree.map(np.asarray, tree),
                                 device="cpu")


# The reference's compiled train cells' collective_bytes on this JAX
# (0.9.0, forced CPU devices), and the port's ledger of the same step,
# side by side (ROADMAP R14): XLA gathers deepseek's MoE tokens over data
# and reshards zamba2's Mamba layers its own way (all-to-all and
# collective-permute), where the port gathers the rank's block of
# ``x @ w_in`` and the conv's weights and all-reduces the norm's sum of
# squares
XLA_TRAIN = {
    "deepseek-v2-lite-16b": {"all-gather": 32768.0, "all-reduce": 2459056.0},
    "zamba2-7b": {"all-gather": 114688.0, "all-reduce": 3965284.0,
                  "all-to-all": 4276224.0, "collective-permute": 3203072.0},
}
PORT_TRAIN = {
    "deepseek-v2-lite-16b": {"all-reduce": 2298824.0},
    "zamba2-7b": {"all-gather": 5346432.0, "all-reduce": 3308712.0,
                  "reduce-scatter": 1415232.0},
}


@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_step_equals_the_reference(reference, arch):
    """The port's partitioned step on ``[cpu] * 4`` as (2, 2) under
    ``tp_dp_rules``, from the reference's parameters and batch, offload
    at MI 1: loss within 1e-5 and grad_norm within 1e-5 of it of the
    reference's compiled cell, every updated parameter within 1e-4;
    XLA's collective bytes and the port's ledger pinned side by side."""
    import jax
    from repro_torch.weights import params_from_jax
    rec, out = reference
    cfg = _config(arch)
    tree, params = _ref_params(arch, cfg)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    batch = {k: torch.as_tensor(v.astype(np.int64))
             for k, v in np.load(out / f"batch_{arch}.npz").items()}
    step, states, m = _partitioned(
        cfg, params, batch, (2, 2), SentinelConfig(mode="offload",
                                                   mi_periods=1))
    r = rec[arch]
    assert abs(float(m["loss"]) - r["loss"]) <= 1e-5
    assert abs(float(m["grad_norm"]) - r["grad_norm"]) <= \
        1e-5 * r["grad_norm"]
    new = np.load(out / f"new_{arch}.npz")
    new_tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [new[jax.tree_util.keystr(k)] for k, _ in leaves])
    want = params_from_jax(cfg, new_tree, device="cpu")
    for (leaf, a), (_, b) in zip(step.gather(states).named_parameters(),
                                 want.named_parameters()):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=leaf)
    assert _nonzero(r["train"]) == XLA_TRAIN[arch]
    assert _nonzero(step.ledger["bytes"]) == PORT_TRAIN[arch]


# the TP prefill's collectives (a 12-token prompt, f32): deepseek's all
# equal XLA's (9 all-reduces of (1, 12, 64): the embedding and each
# layer's two row-split products); zamba2's Mamba layers gather the
# rank's block of x @ w_in and the conv's weights and all-reduce the
# norm's sum of squares, where XLA reshards with collective-permute
PORT_TP = {
    ("deepseek-v2-lite-16b", 2): {"all-reduce": 27648.0},
    ("deepseek-v2-lite-16b", 4): {"all-reduce": 27648.0},
    ("zamba2-7b", 2): {"all-gather": 160128.0, "all-reduce": 43440.0},
    ("zamba2-7b", 4): {"all-gather": 166272.0, "all-reduce": 43440.0},
}
XLA_TP = {
    ("deepseek-v2-lite-16b", 2): {"all-reduce": 27648.0},
    ("deepseek-v2-lite-16b", 4): {"all-reduce": 27648.0},
    ("zamba2-7b", 2): {"all-gather": 10240.0, "all-reduce": 48048.0,
                       "collective-permute": 79488.0},
    ("zamba2-7b", 4): {"all-gather": 18432.0, "all-reduce": 48048.0,
                       "all-to-all": 1536.0, "collective-permute": 99264.0},
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_equals_the_reference(reference, arch, n):
    """The port's TP prefill on ``[cpu] * n`` against the reference's
    over n forced devices, from the reference's parameters: the last
    row's logits within 1e-4 (ROADMAP R12's limit); the ledgers pinned
    beside XLA's."""
    rec, _ = reference
    r = rec[arch]
    cfg = get_config(arch).reduced()
    _, params = _ref_params(arch, cfg)
    last, _, ledger = _tp_prefill(cfg, params, torch.tensor(r["tokens"]), n)
    torch.testing.assert_close(last, torch.tensor(r["tp"][str(n)]["last"]),
                               atol=1e-4, rtol=0)
    assert _nonzero(r["tp"][str(n)]["coll"]) == XLA_TP[arch, n]
    assert _nonzero(ledger["bytes"]) == PORT_TP[arch, n]


# the serve cells: the port gathers deepseek's latent in a decode
# (3 layers x (2, 16, 32) f32), XLA that and the MoE tokens over data
# (ROADMAP R12); zamba2's decode all-reduces equal XLA's
PORT_CELLS = {
    ("deepseek-v2-lite-16b", "prefill"): {"all-reduce": 73728.0},
    ("deepseek-v2-lite-16b", "decode"): {"all-gather": 12288.0,
                                         "all-reduce": 4608.0},
    ("zamba2-7b", "prefill"): {"all-gather": 379008.0,
                               "all-reduce": 115840.0},
    ("zamba2-7b", "decode"): {"all-gather": 85248.0, "all-reduce": 7240.0},
}
XLA_CELLS = {
    ("deepseek-v2-lite-16b", "prefill"): {"all-gather": 169984.0,
                                          "all-reduce": 73728.0},
    ("deepseek-v2-lite-16b", "decode"): {"all-gather": 15232.0,
                                         "all-reduce": 4608.0},
    ("zamba2-7b", "prefill"): {"all-gather": 20480.0, "all-reduce": 125056.0,
                               "collective-permute": 211968.0},
    ("zamba2-7b", "decode"): {"all-gather": 2304.0, "all-reduce": 7240.0,
                              "collective-permute": 13248.0},
}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_cell_collectives_beside_the_reference(reference, arch,
                                                      kind):
    """The dry run's serve cells at (2, 2) under ``make_rules``, reduced
    fp32, B 4 x S 16: the port's ``collectives`` of mesh position (0, 0)
    and the reference's ``collective_bytes`` of the compiled cell, pinned
    side by side; the all-reduce bytes of deepseek's cells equal XLA's."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_rules
    rec, _ = reference
    cfg = get_config(arch).reduced()
    rules = make_rules(shd.Mesh((2, 2), ("data", "model")), kind=kind)
    build = specs.build_prefill_cell if kind == "prefill" \
        else specs.build_decode_cell
    fn, args, in_sh = build(cfg, ShapeConfig("tiny", 16, 4, kind), rules)
    port = _nonzero(dryrun.rank_collectives(fn, args, in_sh, rules)["bytes"])
    ref = _nonzero(rec[arch]["cells"][kind])
    assert ref == XLA_CELLS[arch, kind]
    assert port == PORT_CELLS[arch, kind]
    if arch == "deepseek-v2-lite-16b":
        assert port["all-reduce"] == ref["all-reduce"]
