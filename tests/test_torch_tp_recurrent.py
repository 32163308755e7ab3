"""The mLSTM, sLSTM and LSTM layers under a rank context, on the CPU:
reduced xlstm-1.3b (4 heads, which a model axis of 2 or 4 divides), its
2-head variant on a model axis of 4 (the heads whole, every rank running
every head) and reduced lstm-ptb (the gate columns [i | f | g | o] cut
inside a gate at 4, between gates at 2) in the partitioned training step
(``train.loop.PartitionedStep``) against the one-device step, in the
tensor-parallel prefill (``serve.disagg.TensorParallelPrefill``) and a
decode step under a rank context against one device, and against the
reference's own partitioned programs: its compiled train cells, its TP
prefill and its compiled serve cells, all in one subprocess of forced
JAX devices, with XLA's own resharding pinned beside the port's ledger
(ROADMAP R15).  Also the dry run's trip scaling (a token loop's
collectives counted once a trip) and each layer's cut at full width.

Every rank is a thread on ``[cpu] * n``; torch runs on one thread in this
module.  Tolerances are fp32's, stated with each test.  The helpers here
serve ``tests/test_torch_tp_modality.py`` too."""
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
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref
from repro_torch.launch import dryrun
from repro_torch.models import kvcache, model
from repro_torch.optim import adamw
from repro_torch.serve.disagg import TensorParallelPrefill
from repro_torch.train import loop

CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("xlstm-1.3b", "lstm-ptb")
# reduced xlstm-1.3b with 2 heads: a model axis of 4 does not divide them
TWO_HEADS = "xlstm-1.3b+h2"
OPT = adamw.OptConfig(lr=1.0, warmup_steps=1, eps=1.0)
# fp32 on both sides: the partitioned sums add the same terms in another
# order
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=1e-5, rtol=1e-5)
# the reduced xLSTM's limit against the reference and float64
# (tests/test_torch_xlstm.py: 1e-4 of a tensor's largest |value|), for
# what its fp32 conditioning moves past the limits above: the 2-head
# variant's gradient norm (its partitioned program, run in float64 on a
# scratch copy, equals one device's to 1e-13 relative; in fp32 the norm
# moves 2.7e-5 relative, every leaf's gradient alike, none by more than
# 1.1e-4), the gradient norm against the reference's compiled cell
# (5.2e-5 and 7.3e-5 measured), and served logits and cache leaves, whose
# states sum exponential gates (an sLSTM normalizer near 3.6 moves 1.0e-4)
XLSTM_REL = 1e-4
# logits and cache leaves, TP against one device and the reference
SERVE_ATOL = 1e-4
MODES = ("full", "remat", "save_hbm", "offload")
B, S = 4, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(name: str):
    """The reduced config of ``name`` ("<arch>" or "<arch>+h<heads>")."""
    arch, _, heads = name.partition("+h")
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, num_heads=int(heads)) if heads else cfg


def make_batch(cfg, b=B, s=S, seed=1):
    """Tokens and labels from ``seed``: (b, s, K) codes for K codebooks;
    with a prefix, ``prefix_embed`` (b, P, d) and labels (b, P + s)."""
    rng = np.random.default_rng(seed)
    tok = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, tok))}
    lab = tok
    if cfg.num_prefix_tokens:
        P = cfg.num_prefix_tokens
        out["prefix_embed"] = torch.as_tensor(
            rng.standard_normal((b, P, cfg.d_model)).astype(np.float32))
        lab = (b, P + s)
    out["labels"] = torch.as_tensor(rng.integers(0, cfg.vocab_size, lab))
    return out


def close(got, want, name, msg=None):
    """``got`` within SERVE_ATOL of ``want``, widened to XLSTM_REL of the
    largest |want| for an xLSTM config ``name``."""
    atol = SERVE_ATOL
    if name.startswith("xlstm"):
        atol = max(atol, XLSTM_REL * float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=atol, rtol=0, msg=msg)


def one_device(cfg, params, batch, scfg):
    p = model.init_params(cfg, device="cpu", requires_grad=True)
    p.load_state_dict(params.state_dict())
    state = {"params": p, "opt": adamw.init(p, OPT),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = loop.make_train_step(cfg, scfg, OPT)(state, batch)
    return state["params"], m


def partitioned(cfg, params, batch, shape, scfg, **rule_kw):
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


_ONE_DEVICE = {}


def check_partitioned_step(name, shape, mode, fsdp, *, gnorm_rtol=None):
    """Every rank's loss and grad_norm within LOSS_TOL of one device's
    (the gradient norm within ``gnorm_rtol`` where given) and equal
    across ranks, every reassembled parameter within PARAM_TOL.  One
    device's step is kept for the other meshes and FSDP settings of the
    same mode."""
    cfg = config(name)
    scfg = SentinelConfig(mode=mode, mi_periods=1)
    params = model.init_params(cfg, seed=0, device="cpu")
    batch = make_batch(cfg)
    key = (name, mode, kernel_ops._MLSTM["chunk"])
    if key not in _ONE_DEVICE:
        _ONE_DEVICE[key] = one_device(cfg, params, batch, scfg)
    p1, m1 = _ONE_DEVICE[key]
    step, states, m = partitioned(cfg, params, batch, shape, scfg,
                                  fsdp=fsdp)
    gtol = LOSS_TOL if gnorm_rtol is None else \
        dict(atol=LOSS_TOL["atol"], rtol=gnorm_rtol)
    for r in m["ranks"]:
        torch.testing.assert_close(r["loss"], m1["loss"], **LOSS_TOL)
        torch.testing.assert_close(r["grad_norm"], m1["grad_norm"], **gtol)
        assert torch.equal(r["loss"], m["loss"])
        assert torch.equal(r["grad_norm"], m["grad_norm"])
    for (leaf, a), (_, b) in zip(step.gather(states).named_parameters(),
                                 p1.named_parameters()):
        torch.testing.assert_close(a, b.detach(), **PARAM_TOL, msg=leaf)
    assert step.ledger["counts"]["all-reduce"] > 0
    return step.ledger


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_step_equals_one_device(arch, shape, mode, fsdp):
    """TP alone and TP with DP, in Sentinel's four modes at MI 1, FSDP off
    and on: the mLSTM on the rank's heads (q, k, v and the gates
    reduce-scattered onto them, the conv on its channels, the norm's sum
    of squares all-reduced), the sLSTM on its heads (the conv's weights
    and h gathered), the LSTM whole on every rank (``w`` and ``b``
    gathered); losses and gradient norms within 1e-5 of one device's,
    every parameter within 1e-5."""
    check_partitioned_step(arch, shape, mode, fsdp)


@pytest.mark.parametrize("mode,fsdp", [("full", False), ("offload", True)])
def test_partitioned_step_where_the_heads_stay_whole(mode, fsdp):
    """The 2-head variant on (1, 4): the model axis does not divide the
    heads, so the mLSTM all-reduces q, k, v and the gates, runs every
    head and takes its block of h through ``to_split``, and the sLSTM's
    columns of ``w_ifzo`` (64 of a head's 128) are gathered before every
    head runs on every rank.  Loss and every parameter within 1e-5 of one
    device's, the gradient norm within XLSTM_REL (the reduced
    xLSTM's conditioning, measured above); a summing backward where the
    gradient is already whole would double every leaf's."""
    led = check_partitioned_step(TWO_HEADS, (1, 4), mode, fsdp,
                                 gnorm_rtol=XLSTM_REL)
    assert led["counts"]["all-gather"] > 0


def test_partitioned_step_with_chunked_mlstm():
    """The chunkwise-parallel mLSTM (``ops.mlstm_chunk_mode(8)``) under a
    rank context on (2, 2) with FSDP, offload: within 1e-5 of one device
    in the same mode, on the rank's heads and on every head (the 2-head
    variant on (1, 4), gradient norm as above)."""
    kernel_ops.mlstm_chunk_mode(8)
    try:
        check_partitioned_step("xlstm-1.3b", (2, 2), "offload", True)
        check_partitioned_step(TWO_HEADS, (1, 4), "full", False,
                               gnorm_rtol=XLSTM_REL)
    finally:
        kernel_ops.mlstm_chunk_mode(0)


# ------------------------------------------------------------ the cuts --

@pytest.mark.parametrize("n", [2, 4, 16])
def test_the_cuts_at_full_width(n):
    """xlstm-1.3b and lstm-ptb at full width under ``serve_rules`` at n
    model ranks (``sharding_for``, as the rank program cuts them): the
    mLSTM's ``wq`` (4096, 2048) splits its rows (``mlp`` takes the axis,
    so ``heads`` stays whole); the sLSTM's ``w_ifzo`` (2048, 8192) splits
    its columns, whole heads of 2048 at 2 and 4 and one gate of one head
    at 16, where ``r_ifzo`` stays whole; the LSTM's ``w`` (1300, 2600)
    splits into gates i and f | g and o at 2 and one gate a rank at 4,
    and stays whole at 16 (2600 does not divide).  Reduced lstm-ptb's
    ``w`` (128, 256) is cut the same way at 2 and 4."""
    rules = shd.serve_rules(shd.Mesh((n,), ("model",)))
    axes = model.param_axes(get_config("xlstm-1.3b"))
    params = model.init_params(get_config("xlstm-1.3b"), device="meta")
    named = dict(params.named_parameters())

    def spec(name):
        return shd.sharding_for(tuple(named[name].shape), axes[name],
                                rules).spec

    assert named["layers.0.mlstm.wq"].shape == (4096, 2048)
    assert spec("layers.0.mlstm.wq") == ("model", None)
    assert spec("layers.0.mlstm.w_up") == (None, "model")
    assert spec("layers.0.mlstm.conv_w") == (None, "model")
    assert spec("layers.7.slstm.w_ifzo") == (None, "model")
    head_cols = 4 * 512
    blk = 8192 // n
    if n < 16:
        assert blk % head_cols == 0
        assert spec("layers.7.slstm.r_ifzo")[0] == "model"
    else:
        assert blk == 512 and head_cols % blk == 0
        assert spec("layers.7.slstm.r_ifzo") == (None, None, None, None)
    assert spec("layers.7.slstm.w_out") == (None, None)
    for cfg, d in ((get_config("lstm-ptb"), 650),
                   (get_config("lstm-ptb").reduced(), 64)):
        lp = dict(model.init_params(cfg, device="meta").named_parameters())
        la = model.param_axes(cfg)
        sp = shd.sharding_for(tuple(lp["layers.0.lstm.w"].shape),
                              la["layers.0.lstm.w"], rules).spec
        if (4 * d) % n:
            assert sp == (None, None)
            continue
        assert sp == (None, "model")
        blk = 4 * d // n
        gates = [sorted({c // d for c in range(r * blk, (r + 1) * blk)})
                 for r in range(n)]
        assert gates[0] == ([0, 1] if n == 2 else [0])


# ------------------------------------------ the dry run's trips (A1) --

def test_step_loop_ledger_counts_every_trip():
    """Under the dry run's ``Trips`` counter (``rank_collectives``) a
    token loop runs trip 0 and one trip standing for the other S - 1: a
    16-trip loop whose step takes its carry through Megatron's ``f`` and
    all-reduces its new carry (a summing backward) records, forward and
    backward, 16 times the ledger of the same loop at one trip, and the
    ledger of the loop run trip by trip without the counter."""
    rules = shd.serve_rules(shd.Mesh((2,), ("model",)))

    def step(t, carry, x, consts):
        on = ctx.on(("model",))
        h = collectives.conjugate(carry[0], *on)
        h = torch.tanh(h @ consts[0] + x[0])
        h = collectives.all_reduce(h, *on, grad="sum")
        return (h,), h

    def ledger(n, counted):
        nonlocal ctx
        group = collectives.ShapeGroup(2)
        ctx = shd.RankContext(group, 0, rules, {"model": 0})
        w = torch.empty(8, 8, device="meta", requires_grad=True)
        u = torch.empty(n, 4, 8, device="meta", requires_grad=True)
        with shd.rank_context(ctx):
            ref.counting(group.trips if counted else None)
            try:
                _, hs = ref.step_loop(step, (u[0],), (u,), n, (w,))
                torch.autograd.grad(torch.stack(hs).sum(), (w, u))
            finally:
                ref.counting(None)
        return group.ledger

    ctx = None
    one, counted, plain = ledger(1, True), ledger(16, True), \
        ledger(16, False)
    assert one["counts"]["all-reduce"] == 3
    assert counted == plain
    for part in ("bytes", "counts"):
        assert counted[part] == {k: 16 * v for k, v in one[part].items()}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_xlstm_cells_carry_collectives(kind):
    """Reduced xlstm-1.3b's cells at B 16 x S 64 on the 16 x 16 mesh
    (``make_rules``, offload at its default MI for the train step) run
    their rank program on meta: 4 heads at 16 ranks stay whole, so q, k,
    v and the gates are all-reduced and the sLSTM's pre-activations
    gathered; a train step's backward adds the reduce-scatters of the
    conv's weights."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_production_mesh, make_rules
    cfg = get_config("xlstm-1.3b").reduced()
    rules = make_rules(make_production_mesh(), kind=kind)
    shape = ShapeConfig("w", 64, 16, kind)
    if kind == "train":
        fn, args, in_sh = specs.build_train_cell(
            cfg, shape, rules, SentinelConfig("offload",
                                              specs.default_mi(cfg)))
    elif kind == "prefill":
        fn, args, in_sh = specs.build_prefill_cell(cfg, shape, rules)
    else:
        fn, args, in_sh = specs.build_decode_cell(cfg, shape, rules)
    counts = dryrun.rank_collectives(fn, args, in_sh, rules)["counts"]
    assert counts["all-reduce"] > 0 and counts["all-gather"] > 0
    assert (counts["reduce-scatter"] > 0) == (kind == "train")


# -------------------------------------------------- serving partitioned --

def tp_prefill(cfg, params, batch, n):
    tp = TensorParallelPrefill(params, cfg, [CPU] * n, max_seq=32)
    try:
        last, fresh = tp(batch)
    finally:
        tp.close()
    return last, fresh, tp.ledger


def prompt(cfg, seed, b=1, s=12):
    """A prompt batch: (b, s) ids, (b, s, K) codes, and with a prefix its
    ``prefix_embed`` (b, P, d)."""
    batch = make_batch(cfg, b, s, seed)
    batch.pop("labels")
    return batch


def check_tp_prefill(name, n):
    """A 12-token prompt (max_seq 32) on ``[cpu] * n`` against
    ``model.prefill`` on one device: the last row's logits and every
    cache leaf within ``close``'s limit, the ranks' blocks joined in rank
    order; a decode step from the joined caches likewise against one from
    one device's.  Returns the TP ledger."""
    cfg = config(name)
    params = model.init_params(cfg, seed=3, device="cpu")
    batch = prompt(cfg, 5)
    last1, fresh1 = model.prefill(params, cfg, batch, max_seq=32)
    last, fresh, ledger = tp_prefill(cfg, params, batch, n)
    close(last, last1, name)
    for l, (a, b) in enumerate(zip(fresh, fresh1)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape, k
            close(a[k], b[k], name, msg=(l, k))
    nxt = batch["tokens"][:, -1:]
    at = 12 + (cfg.num_prefix_tokens if "prefix_embed" in batch else 0)
    d1, _ = model.decode_step(params, cfg, nxt, fresh1, at)
    d, _ = model.decode_step(params, cfg, nxt, fresh, at)
    close(d, d1, name)
    assert ledger["counts"]["all-reduce"] > 0
    return ledger


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ARCHS + (TWO_HEADS,))
def test_tp_prefill_equals_the_one_device_prefill(name, n):
    """xlstm-1.3b's mLSTM state joined over its heads (or whole where the
    heads stay whole), both conv tails over their channels, the sLSTM's
    state over its heads; lstm-ptb's state whole on every rank."""
    check_tp_prefill(name, n)


def check_decode(name, n):
    """The dry run's decode cell with numbers: a prefilled cache cut into
    each rank's blocks (``sharding_for`` of ``cache_logical_axes``), one
    decode step of 2 slots at per-slot offsets on every rank under
    ``serve_rules``: the ranks' vocab blocks of the logits and their
    updated cache blocks, joined, within ``close``'s limit of one
    device's."""
    cfg = config(name)
    params = model.init_params(cfg, seed=3, device="cpu")
    batch = prompt(cfg, 7, b=2, s=10)
    at = 10 + (cfg.num_prefix_tokens if "prefix_embed" in batch else 0)
    _, caches = model.prefill(params, cfg, batch, max_seq=at + 6)
    index = torch.tensor([at, at])
    nxt = batch["tokens"][:, :1]
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
    close(torch.cat([o[0] for o in outs], dim=-1), want, name)
    for l, c in enumerate(one):
        for k, v in c.items():
            dims = [i for i, e in enumerate(specs[l][k]) if e is not None]
            got = torch.cat([o[1][l][k] for o in outs], dims[0]) \
                if dims else outs[0][1][l][k]
            close(got, v, name, msg=(l, k))
    return specs


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ARCHS + (TWO_HEADS,))
def test_decode_under_a_rank_context_equals_one_device(name, n):
    """xlstm-1.3b's mLSTM continues its conv on its own channels, the
    sLSTM gathers its conv tail; at 4 ranks the 2-head variant's states
    are whole on every rank."""
    specs = check_decode(name, n)
    if name.startswith("xlstm"):
        split = {k for layer in specs for k, s in layer.items()
                 if any(e is not None for e in s)}
        assert "conv" in split
        assert ("C" in split) == (name != TWO_HEADS or n == 2)


def test_engine_with_a_tp_prefill_group_and_one_decode_shard():
    """``DisaggregatedEngine(devices=[cpu], prefill_devices=[cpu] * 2,
    tp_prefill=True)`` on reduced xlstm-1.3b: two TP ranks admit, one
    decode shard serves (the recurrent state dense).  Four requests,
    three sharing a 9-token prefix, on 2 slots: the tokens and the edge
    ledger equal the engine's without TP; the TP ranks' collectives are
    in ``counters()``."""
    from repro_torch.runtime.plan import PlacementPlan
    from repro_torch.serve.disagg import DisaggregatedEngine

    def toks(seed, n):
        return np.random.default_rng(seed).integers(0, 512, n)

    prefix = toks(7, 9)
    reqs = [(np.concatenate([prefix, toks(11 + i, 3 + 2 * i)]), d, "sys")
            for i, d in enumerate((6, 4, 5))] + [(toks(20, 15), 5, None)]
    plan = PlacementPlan(hot_window=16, slot_hot_windows=[4, 8],
                         page_tokens=4)
    cfg = dataclasses.replace(config("xlstm-1.3b"), use_paged_decode=True)
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
                       b.counters()["collectives"])
        finally:
            b.close()
    assert got[True][0] == got[False][0] and len(got[True][0]) == 4
    assert got[True][1] == got[False][1]
    assert got[True][2]["counts"]["all-reduce"] > 0
    assert not any(got[False][2]["counts"].values())


# ------------------------------------------------------- the reference --

# The reference's partitioned programs of the reduced models, in one
# subprocess of 8 forced CPU devices.  For each case (the config, the
# train cell's mesh and its B x S): the compiled train cell (offload at MI
# 1, ``tp_dp_rules``) run once from its parameters and a batch from seed
# 0, its TP prefill of a 12-token prompt over 2 and 4 devices
# (``serve_rules`` on a ("model",) mesh) and its compiled prefill and
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

    out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
    opt = adamw.OptConfig(lr=1.0, warmup_steps=1, eps=1.0)
    scfg = SentinelConfig(mode="offload", mi_periods=1)
    devs = jax.devices()

    def coll(c, txt):
        return collective_bytes(
            txt, loop_trips=float(c.num_periods))["bytes"]

    def config(name):
        arch, _, heads = name.partition("+h")
        c = get_config(arch).reduced()
        return dataclasses.replace(c, num_heads=int(heads)) if heads else c

    def batch_of(c, b, s, seed):
        rng = np.random.default_rng(seed)
        tok = (b, s, c.num_codebooks) if c.num_codebooks else (b, s)
        out = {"tokens": rng.integers(0, c.vocab_size, tok)}
        lab = tok
        if c.num_prefix_tokens:
            P = c.num_prefix_tokens
            out["prefix_embed"] = rng.standard_normal(
                (b, P, c.d_model)).astype(np.float32)
            lab = (b, P + s)
        out["labels"] = rng.integers(0, c.vocab_size, lab)
        return {k: v.astype(np.int32) if v.dtype.kind == "i" else v
                for k, v in out.items()}

    rec = {}
    for name, mesh_shape, (b, s), tp_ns in cases:
        c = config(name)
        batch_np = batch_of(c, b, s, 0)
        np.savez(os.path.join(out_dir, f"batch_{name}.npz"), **batch_np)
        mesh = jax.sharding.Mesh(
            np.asarray(devs[:mesh_shape[0] * mesh_shape[1]]).reshape(
                mesh_shape), ("data", "model"))
        rules = shd.tp_dp_rules(mesh)
        params, _ = split_params(model.init_params(jax.random.PRNGKey(0), c))
        with mesh, shd.axis_rules(rules):
            fn, args, in_sh = specs.build_train_cell(
                c, ShapeConfig("tiny", s, b, "train"), rules, scfg, opt)
            compiled = jax.jit(fn, in_shardings=in_sh).lower(
                *args).compile()
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
        r = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
             "train": coll(c, compiled.as_text())}

        prompt = batch_of(c, 1, 12, 5)
        prompt.pop("labels")
        np.savez(os.path.join(out_dir, f"prompt_{name}.npz"), **prompt)
        prompt = {k: jnp.asarray(v) for k, v in prompt.items()}
        f = jax.jit(lambda p, bt, c=c: model.prefill(p, c, bt, max_seq=32))
        sds, axes = specs.param_structs(c)
        r["tp"] = {}
        for n in tp_ns:
            mesh = jax.sharding.Mesh(np.asarray(devs[:n]), ("model",))
            rules = shd.serve_rules(mesh)
            ptp = jax.device_put(params, specs.shardings_from_axes(
                axes, rules, sds))
            with mesh, shd.axis_rules(rules):
                last, _ = f(ptp, prompt)
                txt = f.lower(ptp, prompt).compile().as_text()
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
        rec[name] = r
    print(json.dumps(rec))
""")


def start_reference(out, cases):
    """The REFERENCE script started on ``cases`` ((name, the train cell's
    mesh, its (B, S), the TP prefill's device counts)), its files in
    ``out``: the running process (``finish_reference``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("REPRO_MLSTM_CHUNK", None)
    return subprocess.Popen([sys.executable, "-c", REFERENCE, str(out),
                             json.dumps(cases)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def finish_reference(proc):
    """The record a ``start_reference`` process prints."""
    stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1])


def run_reference(out, cases):
    """The REFERENCE script's record of ``cases``, its files in ``out``."""
    return finish_reference(start_reference(out, cases))


# (name, the train cell's (data, model) mesh, its B x S, TP prefill sizes)
REF_CASES = (("xlstm-1.3b", (2, 2), (8, 32), (2, 4)),
             ("lstm-ptb", (2, 2), (8, 32), (2, 4)),
             (TWO_HEADS, (1, 4), (4, 32), (4,)))


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The REFERENCE script on REF_CASES, started when the module starts
    so that it runs beside the port's tests; ``reference`` waits for
    it."""
    out = tmp_path_factory.mktemp("ref_recurrent")
    proc = start_reference(out, REF_CASES)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_run):
    proc, out = reference_run
    return finish_reference(proc), out


def nonzero(ledger_bytes):
    return {k: v for k, v in ledger_bytes.items() if v}


def ref_params(name, cfg):
    """The reference's reduced parameters of ``name`` from PRNGKey(0), and
    the port's copy of them."""
    import jax
    from repro.configs.base import get_config as ref_config
    from repro.models import model as ref_model
    from repro.models.layers import split_params
    from repro_torch.weights import params_from_jax
    arch, _, heads = name.partition("+h")
    ref_cfg = ref_config(arch).reduced()
    if heads:
        ref_cfg = dataclasses.replace(ref_cfg, num_heads=int(heads))
    tree, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                 ref_cfg))
    return tree, params_from_jax(cfg, jax.tree.map(np.asarray, tree),
                                 device="cpu")


def check_against_reference(reference, name, mesh_shape, xla, port, *,
                            gnorm_rtol=1e-5):
    """The port's partitioned step on ``[cpu] * n`` as ``mesh_shape``
    under ``tp_dp_rules``, from the reference's parameters and batch,
    offload at MI 1: loss within 1e-5 and grad_norm within
    ``gnorm_rtol`` of the reference's compiled cell's, every updated
    parameter within 1e-4; XLA's collective bytes and the port's ledger
    pinned (``xla``, ``port``)."""
    import jax
    from repro_torch.weights import params_from_jax
    rec, out = reference
    cfg = config(name)
    tree, params = ref_params(name, cfg)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    batch = {k: torch.as_tensor(v.astype(np.int64) if v.dtype.kind == "i"
                                else v)
             for k, v in np.load(out / f"batch_{name}.npz").items()}
    step, states, m = partitioned(
        cfg, params, batch, mesh_shape, SentinelConfig(mode="offload",
                                                       mi_periods=1))
    r = rec[name]
    assert abs(float(m["loss"]) - r["loss"]) <= 1e-5
    assert abs(float(m["grad_norm"]) - r["grad_norm"]) <= \
        gnorm_rtol * r["grad_norm"]
    new = np.load(out / f"new_{name}.npz")
    new_tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [new[jax.tree_util.keystr(k)] for k, _ in leaves])
    want = params_from_jax(cfg, new_tree, device="cpu")
    for (leaf, a), (_, b) in zip(step.gather(states).named_parameters(),
                                 want.named_parameters()):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=leaf)
    assert nonzero(r["train"]) == xla
    assert nonzero(step.ledger["bytes"]) == port


def check_tp_against_reference(reference, name, n, xla, port):
    """The port's TP prefill on ``[cpu] * n`` against the reference's
    over n forced devices, from the reference's parameters and prompt:
    the last row's logits within ``close``'s limit; the ledgers
    pinned."""
    rec, out = reference
    cfg = config(name)
    _, params = ref_params(name, cfg)
    batch = {k: torch.as_tensor(v.astype(np.int64) if v.dtype.kind == "i"
                                else v)
             for k, v in np.load(out / f"prompt_{name}.npz").items()}
    last, _, ledger = tp_prefill(cfg, params, batch, n)
    r = rec[name]["tp"][str(n)]
    close(last, torch.tensor(r["last"]), name)
    assert nonzero(r["coll"]) == xla
    assert nonzero(ledger["bytes"]) == port


def check_cell_against_reference(reference, name, kind, xla, port):
    """The dry run's serve cell at (2, 2) under ``make_rules``, reduced
    fp32, B 4 x S 16: the port's ``collectives`` of mesh position (0, 0)
    and the reference's ``collective_bytes`` of the compiled cell,
    pinned side by side."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_rules
    rec, _ = reference
    cfg = config(name)
    rules = make_rules(shd.Mesh((2, 2), ("data", "model")), kind=kind)
    build = specs.build_prefill_cell if kind == "prefill" \
        else specs.build_decode_cell
    fn, args, in_sh = build(cfg, ShapeConfig("tiny", 16, 4, kind), rules)
    got = nonzero(dryrun.rank_collectives(fn, args, in_sh, rules)["bytes"])
    assert nonzero(rec[name]["cells"][kind]) == xla
    assert got == port


# XLA's collective bytes of the reference's compiled train cells on this
# JAX (0.9.0, forced CPU devices) beside the port's ledger of the same
# step (ROADMAP R15)
XLA_TRAIN = {
    "xlstm-1.3b": {"all-gather": 2088960.0, "all-reduce": 7734588.0,
        "collective-permute": 86016.0},
    "lstm-ptb": {"all-gather": 77824.0, "all-reduce": 335512.0,
        "all-to-all": 16384.0, "collective-permute": 10240.0},
    "xlstm-1.3b+h2": {"all-gather": 2063360.0, "all-reduce": 6289884.0,
        "all-to-all": 73728.0, "collective-permute": 46080.0}}
PORT_TRAIN = {
    "xlstm-1.3b": {"all-gather": 2029568.0, "all-reduce": 3372296.0,
        "reduce-scatter": 1893632.0},
    "lstm-ptb": {"all-gather": 528384.0, "all-reduce": 330504.0},
    "xlstm-1.3b+h2": {"all-gather": 530432.0, "all-reduce": 6175236.0,
        "reduce-scatter": 640.0}}


@pytest.mark.parametrize("name", [c[0] for c in REF_CASES])
def test_partitioned_step_equals_the_reference(reference, name):
    """From the reference's parameters and batch, offload at MI 1, on its
    train cell's mesh: loss within 1e-5, every updated parameter within
    1e-4, the gradient norm within 1e-5 of the reference's for lstm-ptb
    and XLSTM_REL for xlstm.  XLA reshards the mLSTM its own way
    (collective-permute, more all-reduce) where the port reduce-scatters
    q, k, v and the gates onto the rank's heads; for lstm-ptb it moves
    the gate blocks inside the token scan where the port gathers ``w``
    and ``b`` once a call (ROADMAP R15)."""
    mesh_shape = dict((c[0], c[1]) for c in REF_CASES)[name]
    check_against_reference(
        reference, name, mesh_shape, XLA_TRAIN[name], PORT_TRAIN[name],
        gnorm_rtol=XLSTM_REL if name.startswith("xlstm") else 1e-5)


XLA_TP = {
    ("xlstm-1.3b", 2): {"all-gather": 6144.0, "all-reduce": 230400.0,
        "collective-permute": 2688.0},
    ("xlstm-1.3b", 4): {"all-gather": 6144.0, "all-reduce": 230400.0,
        "collective-permute": 3360.0},
    ("lstm-ptb", 2): {"all-gather": 4096.0, "all-reduce": 3120.0,
        "collective-permute": 1024.0},
    ("lstm-ptb", 4): {"all-gather": 4096.0, "all-reduce": 3120.0,
        "collective-permute": 1536.0},
    ("xlstm-1.3b+h2", 4): {"all-gather": 6400.0, "all-reduce": 250560.0,
        "all-to-all": 1024.0, "collective-permute": 2112.0}}
PORT_TP = {
    ("xlstm-1.3b", 2): {"all-gather": 9216.0, "all-reduce": 46752.0,
        "reduce-scatter": 88704.0},
    ("xlstm-1.3b", 4): {"all-gather": 9216.0, "all-reduce": 46752.0,
        "reduce-scatter": 44352.0},
    ("lstm-ptb", 2): {"all-gather": 264192.0, "all-reduce": 3072.0},
    ("lstm-ptb", 4): {"all-gather": 264192.0, "all-reduce": 3072.0},
    ("xlstm-1.3b+h2", 4): {"all-gather": 27648.0, "all-reduce": 221472.0}}


@pytest.mark.parametrize("name,n", [(c[0], n) for c in REF_CASES
                                    for n in c[3]])
def test_tp_prefill_equals_the_reference(reference, name, n):
    """The last row's logits within ``close``'s limit of the reference's
    TP prefill over n forced devices; both ledgers pinned."""
    check_tp_against_reference(reference, name, n, XLA_TP[name, n],
                               PORT_TP[name, n])


XLA_CELLS = {
    ("xlstm-1.3b", "prefill"): {"all-gather": 16384.0, "all-reduce": 614400.0,
        "collective-permute": 7168.0},
    ("xlstm-1.3b", "decode"): {"all-gather": 1024.0, "all-reduce": 38400.0,
        "collective-permute": 448.0},
    ("lstm-ptb", "prefill"): {"all-gather": 10240.0, "all-reduce": 8320.0,
        "all-to-all": 2048.0, "collective-permute": 2048.0},
    ("lstm-ptb", "decode"): {"all-gather": 2560.0, "all-reduce": 520.0,
        "all-to-all": 2048.0, "collective-permute": 2048.0},
    ("xlstm-1.3b+h2", "prefill"): {"all-gather": 16384.0,
        "all-reduce": 607232.0, "collective-permute": 3584.0},
    ("xlstm-1.3b+h2", "decode"): {"all-gather": 1024.0, "all-reduce": 37952.0,
        "collective-permute": 224.0}}
PORT_CELLS = {
    ("xlstm-1.3b", "prefill"): {"all-gather": 19456.0, "all-reduce": 124672.0,
        "reduce-scatter": 236544.0},
    ("xlstm-1.3b", "decode"): {"all-gather": 7168.0, "all-reduce": 7792.0,
        "reduce-scatter": 14784.0},
    ("lstm-ptb", "prefill"): {"all-gather": 264192.0, "all-reduce": 8192.0},
    ("lstm-ptb", "decode"): {"all-gather": 264192.0, "all-reduce": 512.0},
    ("xlstm-1.3b+h2", "prefill"): {"all-gather": 19456.0,
        "all-reduce": 124672.0, "reduce-scatter": 232960.0},
    ("xlstm-1.3b+h2", "decode"): {"all-gather": 7168.0, "all-reduce": 7792.0,
        "reduce-scatter": 14560.0}}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", [c[0] for c in REF_CASES])
def test_dryrun_cell_collectives_beside_the_reference(reference, name,
                                                      kind):
    """The dry run's serve cells at (2, 2), B 4 x S 16, beside the
    reference's compiled cells (lstm-ptb is not a cell of the dry run;
    its cells are built all the same)."""
    check_cell_against_reference(reference, name, kind,
                                 XLA_CELLS[name, kind],
                                 PORT_CELLS[name, kind])
