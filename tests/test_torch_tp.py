"""Tensor-parallel execution in the port, on the CPU: the in-process
collectives (``collectives.Group``, ``ShapeGroup``), the rank context and
``constrain``, ``shard_params``, the partitioned prefill of the five
pure-attention families on ``[cpu] * 2`` and ``* 4`` against the
one-device prefill, and the dry run's ``collectives``.  The comparisons
with the reference's own partitioned programs (its TP prefill and its
compiled cells' ``collective_bytes``) need forced JAX devices and live in
``tests/test_torch_disagg_multidev.py``'s scenario."""
import dataclasses
import time

import pytest
import torch

from repro_torch import collectives
from repro_torch import sharding as shd
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_rules
from repro_torch.models import model
from repro_torch.serve.disagg import TensorParallelPrefill

FAMILIES = ("smollm-360m", "gemma2-2b", "gemma3-12b", "internlm2-1.8b",
            "granite-moe-3b-a800m")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for the module, restored after: each rank is a
    thread of its own, and torch's intra-op threads on top of them
    oversubscribe the runner's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the group --

def test_all_reduce_sums_in_rank_order_and_repeats():
    """Every rank gets ((x0 + x1) + x2) + x3 bit for bit, the same on
    every rank and in every run; the ledger counts one execution of the
    per-device result bytes a call."""
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(3, 257, generator=g) * 10 ** i for i in range(4)]
    want = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    assert not torch.equal(want, ((xs[3] + xs[2]) + xs[1]) + xs[0])
    group = collectives.Group([CPU] * 4)
    try:
        runs = [group.run(lambda r: group.all_reduce(r, xs[r]))
                for _ in range(3)]
    finally:
        group.close()
    for outs in runs:
        for out in outs:
            assert torch.equal(out, want)
    assert group.ledger["bytes"]["all-reduce"] == 3 * 3 * 257 * 4
    assert group.ledger["counts"] == {**dict.fromkeys(
        collectives.COLLECTIVES, 0), "all-reduce": 3}


def test_bf16_all_reduce_adds_in_float32_and_rounds_once():
    xs = [torch.full((8,), v, dtype=torch.bfloat16)
          for v in (1.0, 2 ** -9, 2 ** -9, 2 ** -9)]
    group = collectives.Group([CPU] * 4)
    try:
        outs = group.run(lambda r: group.all_reduce(r, xs[r]))
    finally:
        group.close()
    want = (1.0 + 3 * 2 ** -9)
    assert all(o.dtype == torch.bfloat16 for o in outs)
    assert torch.equal(outs[0], torch.full((8,), want).to(torch.bfloat16))
    assert group.ledger["bytes"]["all-reduce"] == 16


def test_all_gather_concatenates_in_rank_order():
    group = collectives.Group([CPU] * 3)
    try:
        outs = group.run(lambda r: group.all_gather(
            r, torch.full((2, r + 1), float(r)), dim=1))
    finally:
        group.close()
    want = torch.tensor([[0.0, 1, 1, 2, 2, 2]] * 2)
    assert all(torch.equal(o, want) for o in outs)
    assert group.ledger["bytes"]["all-gather"] == 2 * 6 * 4
    assert group.ledger["counts"]["all-gather"] == 1


def test_a_failed_rank_raises_and_never_hangs():
    """A rank that raises before a collective breaks the barrier at once:
    the call raises its error, far inside the timeout.  A rank that skips
    the collective leaves the others waiting: they raise when the timeout
    passes.  The group runs again afterwards."""
    group = collectives.Group([CPU] * 3, timeout=3.0)
    x = torch.ones(4)

    def fails(r):
        if r == 1:
            raise ValueError("rank 1 failed")
        return group.all_reduce(r, x)

    def skips(r):
        return x if r == 2 else group.all_reduce(r, x)

    try:
        t0 = time.time()
        with pytest.raises(ValueError, match="rank 1 failed"):
            group.run(fails)
        assert time.time() - t0 < group.timeout / 2
        t0 = time.time()
        with pytest.raises(collectives.CollectiveError, match="not met"):
            group.run(skips)
        assert group.timeout - 0.5 < time.time() - t0 < group.timeout + 8
        outs = group.run(lambda r: group.all_reduce(r, x))
        assert all(torch.equal(o, 3 * x) for o in outs)
    finally:
        group.close()


def test_shape_group_returns_shapes_and_records_bytes():
    g = collectives.ShapeGroup(4)
    x = torch.empty(2, 16, 60, device="meta", dtype=torch.bfloat16)
    assert g.all_reduce(0, x).shape == x.shape
    y = g.all_gather(0, x, 2)
    assert y.shape == (2, 16, 240) and y.is_meta
    assert g.ledger["bytes"]["all-reduce"] == 2 * 16 * 60 * 2
    assert g.ledger["bytes"]["all-gather"] == 2 * 16 * 240 * 2
    assert g.ledger["counts"]["all-gather"] == 1


# ------------------------------------------------- rank context, rules ----

def test_constrain_is_the_identity_without_a_rank_context():
    x = torch.randn(2, 3, 8)
    assert shd.current_rank() is None
    assert shd.constrain(x, ("batch", "seq", "heads")) is x
    assert shd.constrain(x, ("batch", "seq", None), partial=True,
                         held=("batch", "seq", "heads")) is x
    assert shd.rank_block("heads") == 0
    assert shd.local_shape((2, 3, 8), ("batch", "seq", "kv_heads")) == \
        (2, 3, 8)


def test_constrain_gathers_cuts_and_reduces_under_the_rules():
    """On a (2, 2) (data, model) mesh at position (1, 1): a dim held split
    on ``model`` that the target keeps whole is gathered, one held whole
    that it splits is cut to the rank's block, the batch (``data``) is
    the rank's own already, and a partial sum is all-reduced."""
    rules = shd.serve_rules(shd.Mesh((2, 2), ("data", "model")))
    g = collectives.ShapeGroup(2)
    ctx = shd.RankContext(g, 1, rules, {"data": 1, "model": 1})
    x = torch.arange(2 * 3 * 8.0).reshape(2, 3, 8)
    with shd.rank_context(ctx):
        assert shd.rank_block("heads") == 1
        assert shd.local_shape((2, 3, 8), ("batch", "seq", "kv_heads")) \
            == (2, 3, 4)
        cut = shd.constrain(x, ("batch", "seq", "heads"),
                            held=("batch", "seq", None))
        assert torch.equal(cut, x[..., 4:])
        got = shd.constrain(torch.empty(2, 3, 4, device="meta"),
                            ("batch", "seq", None),
                            held=("batch", "seq", "heads"))
        assert got.shape == (2, 3, 8)
        assert shd.constrain(x, ("batch", "seq", "embed"), partial=True) \
            is x
        # a dim the rules cannot split (7 over 2) stays whole
        y = torch.ones(2, 3, 7)
        assert shd.constrain(y, ("batch", "seq", "heads"),
                             held=("batch", "seq", None)) is y
    assert g.ledger["counts"]["all-gather"] == 1
    assert g.ledger["counts"]["all-reduce"] == 1
    assert shd.current_rank() is None


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_shard_params_blocks_equal_shard_shape(arch, n):
    """Every leaf's block is ``param_spec``'s ``shard_shape`` of it, at full
    width (meta) and reduced, and the reduced blocks are the full
    parameter's slices: concatenated in rank order on their split dim they
    give it back."""
    rules = shd.serve_rules(shd.Mesh((n,), ("model",)))
    for cfg, dev in ((get_config(arch), "meta"),
                     (get_config(arch).reduced(), "cpu")):
        full = model.init_params(cfg, device=dev)
        axes = model.param_axes(cfg)
        ranks = [shd.shard_params(full, rules, {"model": r})
                 for r in range(n)]
        split = 0
        for name, p in full.named_parameters():
            sh = shd.param_spec(tuple(name.split(".")), axes[name],
                                tuple(p.shape), rules)
            blocks = [dict(rk.named_parameters())[name] for rk in ranks]
            assert all(tuple(b.shape) == sh.shard_shape(p.shape)
                       for b in blocks), name
            dims = [i for i, e in enumerate(sh.spec) if e is not None]
            split += bool(dims)
            if dev == "cpu":
                back = torch.cat(blocks, dims[0]) if dims else blocks[0]
                assert torch.equal(back, p), name
                assert all(not b.requires_grad for b in blocks)
        assert split > 0
        assert type(ranks[0]) is type(full)


def test_shard_params_follows_the_divisibility_drop():
    """granite-moe-3b's 40 experts split over 4 ranks and stay whole over
    16 (``param_spec`` maps them to ``model`` before it drops the entry,
    so the expert hidden dim does not take the axis either), as the
    reference's ``_divisible``; its padded vocab splits at both."""
    cfg = get_config("granite-moe-3b-a800m")
    full = model.init_params(cfg, device="meta")
    for n, want in ((4, (10, 1536, 512)), (16, (40, 1536, 512))):
        rules = shd.serve_rules(shd.Mesh((n,), ("model",)))
        rank = shd.shard_params(full, rules, {"model": n - 1})
        assert tuple(rank.layers[0].moe.wi.shape) == want
        assert tuple(rank.table.shape) == (cfg.padded_vocab // n,
                                           cfg.d_model)


# ------------------------------------------------------ the TP prefill ----

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_tp_prefill_equals_the_one_device_prefill(arch, n):
    """The reduced family's TP prefill of a 12-token prompt (max_seq 32)
    on ``[cpu] * n`` against ``model.prefill`` on one device: the last
    row's logits and every cache leaf within 1e-4, the ranks' blocks
    gathered in rank order, and the ledger's all-reduce bytes (2 layers'
    row-split products a layer and the embedding, each (1, 12, d) f32)."""
    cfg = get_config(arch).reduced()
    params = model.init_params(cfg, seed=3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 12),
                           generator=torch.Generator().manual_seed(5))
    last1, fresh1 = model.prefill(params, cfg, {"tokens": tokens},
                                  max_seq=32)
    tp = TensorParallelPrefill(params, cfg, [CPU] * n, max_seq=32)
    try:
        last, fresh = tp({"tokens": tokens})
    finally:
        tp.close()
    assert last.shape == last1.shape == (1, cfg.padded_vocab)
    torch.testing.assert_close(last, last1, atol=1e-4, rtol=0)
    for a, b in zip(fresh, fresh1):
        assert a.keys() == b.keys()
        for k in a:
            torch.testing.assert_close(a[k], b[k], atol=1e-4, rtol=0)
    led = tp.ledger
    assert led["bytes"]["all-reduce"] == \
        (2 * cfg.num_layers + 1) * 12 * cfg.d_model * 4
    assert led["counts"]["all-reduce"] == 2 * cfg.num_layers + 1
    # 32 KV columns split into half heads at 4 ranks: k and v gathered
    assert led["bytes"]["all-gather"] == \
        (cfg.num_layers * 2 * 12 * 32 * 4 if n == 4 else 0)


@pytest.mark.parametrize("n", [2, 4])
def test_tp_prefill_that_cuts_heads_equals_the_one_device_prefill(n):
    """Full-width smollm-360m (2 layers, f32), whose 15/5 heads of 64 the
    folded-column split cuts at 2 and 4 ranks: q, k and v gathered, every
    head run on each rank, the rank's block taken back before its row
    block of wo.  The last row's logits and every cache leaf against
    ``model.prefill`` on one device within 1e-4, and the ledger: 5
    all-reduces of (1, 12, 960) and each layer's q, k and v gathered,
    (960 + 320 + 320) x 12 f32."""
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=2,
                              dtype="float32")
    params = model.init_params(cfg, seed=3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 12),
                           generator=torch.Generator().manual_seed(5))
    last1, fresh1 = model.prefill(params, cfg, {"tokens": tokens},
                                  max_seq=16)
    tp = TensorParallelPrefill(params, cfg, [CPU] * n, max_seq=16)
    try:
        last, fresh = tp({"tokens": tokens})
    finally:
        tp.close()
    torch.testing.assert_close(last, last1, atol=1e-4, rtol=0)
    for a, b in zip(fresh, fresh1):
        assert a.keys() == b.keys()
        for k in a:
            torch.testing.assert_close(a[k], b[k], atol=1e-4, rtol=0)
    assert {k: v for k, v in tp.ledger["bytes"].items() if v} == {
        "all-reduce": 5 * 12 * 960 * 4.0,
        "all-gather": 2 * 12 * (960 + 320 + 320) * 4.0}


def test_tp_prefill_raises_when_a_rank_fails(monkeypatch):
    """No fallback: a rank that fails makes the call raise."""
    cfg = get_config("smollm-360m").reduced()
    params = model.init_params(cfg, device="cpu")
    tp = TensorParallelPrefill(params, cfg, [CPU] * 2, max_seq=16)
    real = tp._rank

    def rank(batch, r):
        if r == 1:
            raise RuntimeError("rank 1 lost its card")
        return real(batch, r)

    monkeypatch.setattr(tp, "_rank", rank)
    try:
        with pytest.raises(RuntimeError, match="lost its card"):
            tp({"tokens": torch.zeros(1, 4, dtype=torch.long)})
    finally:
        tp.close()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-7b",
                                  "xlstm-1.3b"])
def test_unpartitioned_layers_refuse_a_rank_context(arch):
    """MLA, Mamba and xLSTM layers raise under a rank context, naming
    item 11b part 2, rather than run unpartitioned."""
    cfg = get_config(arch).reduced()
    rules = make_rules(shd.Mesh((1, 2), ("data", "model")), kind="prefill")
    fn, args, in_sh = specs.build_prefill_cell(
        cfg, ShapeConfig("tiny", 8, 1, "prefill"), rules)
    with pytest.raises(NotImplementedError, match="item 11b part 2"):
        dryrun.rank_collectives(fn, args, in_sh, rules)


# ------------------------------------------------------------ the dry run --

# Each pinned number is the reference's collective_bytes of the compiled
# full-width cell: `repro.launch.dryrun.collective_bytes(jax.jit(fn,
# in_shardings=in_sh).lower(*args).compile().as_text(), loop_trips=2)` for
# `specs.build_prefill_cell(replace(get_config(arch), num_layers=2,
# dtype="float32"), ShapeConfig("w", 16, 1, "prefill"), rules)` under
# `make_rules(Mesh(devices.reshape(1, m), ("data", "model")), kind=
# "prefill")`, m = 2 and 4, on forced CPU devices (JAX 0.9.0).
FULL_WIDTH = {
    "internlm2-1.8b": {"all-reduce": 655360.0},
    "smollm-360m": {"all-reduce": 307200.0, "all-gather": 204800.0},
}


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", list(FULL_WIDTH))
def test_full_width_prefill_cell_collectives(arch, m):
    """At full width, 2 layers, f32, B 1 x S 16 on a (1, m) mesh:
    internlm2-1.8b's 16/8 heads split whole (5 all-reduces of (1, 16,
    2048) f32 and nothing else); smollm-360m's 15/5 heads of 64 are cut,
    so q, k and v are gathered ((960 + 320 + 320) x 16 x 4 B a layer)
    beside its 5 all-reduces of (1, 16, 960)."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="float32")
    rules = make_rules(shd.Mesh((1, m), ("data", "model")), kind="prefill")
    fn, args, in_sh = specs.build_prefill_cell(
        cfg, ShapeConfig("w", 16, 1, "prefill"), rules)
    led = dryrun.rank_collectives(fn, args, in_sh, rules)
    assert {k: v for k, v in led["bytes"].items() if v} == FULL_WIDTH[arch]


def test_dryrun_record_carries_collectives_on_serve_cells(tmp_path):
    """The CLI on the production 16 x 16 mesh (reduced configs): a
    partitioned serve or train cell's record carries ``collectives`` in
    the reference's format; ``long_500k`` and a serve cell of an MLA stack
    carry the note naming item 11b part 2 instead."""
    got = {}
    for arch, shape in (("smollm-360m", "prefill_32k"),
                        ("granite-moe-3b-a800m", "decode_32k"),
                        ("smollm-360m", "train_4k"),
                        ("zamba2-7b", "long_500k"),
                        ("deepseek-v2-lite-16b", "decode_32k")):
        rec = dryrun.run_cell(arch, shape, cfg=get_config(arch).reduced())
        assert rec["ok"]
        got[(arch, shape)] = rec
    for key in (("smollm-360m", "prefill_32k"),
                ("granite-moe-3b-a800m", "decode_32k"),
                ("smollm-360m", "train_4k")):
        coll = got[key]["collectives"]
        assert set(coll) == {"bytes", "counts"}
        assert set(coll["bytes"]) == set(collectives.COLLECTIVES)
        assert coll["bytes"]["all-reduce"] > 0
        assert "collectives_note" not in got[key]
    for key in (("zamba2-7b", "long_500k"),
                ("deepseek-v2-lite-16b", "decode_32k")):
        assert "collectives" not in got[key]
        assert "item 11b part 2" in got[key]["collectives_note"]
