"""The port's training side against the reference's on the CPU: the loss
and every gradient leaf in Sentinel's four modes at migration intervals 1
and 2 (the reference's ``value_and_grad``, jitted, with the same
parameters carried across by ``params_from_jax``), the carries the
offload store sees against ``estimate_offload_traffic``'s blocks, AdamW step by step (with and without
the int8 compressor, moments on the host and off), the data pipeline's
bytes, checkpoints both ways, ``from_plan``, and the training loop's losses
and its bit-exact resume.  Tolerances are stated with each test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import runtime as ref_runtime
from repro.checkpoint import ckpt as ref_ckpt
from repro.configs.base import get_config as ref_config
from repro.core import offload as ref_offload
from repro.core.hardware import PAPER_HM as REF_PAPER_HM
from repro.data import pipeline as ref_pipeline
from repro.models import model as ref_model
from repro.models.layers import split_params
from repro.optim import adamw as ref_adamw
from repro.runtime import synthetic as ref_synthetic
from repro.train import loop as ref_loop
from repro_torch import runtime, telemetry
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core import offload
from repro_torch.core.hardware import PAPER_HM
from repro_torch.core.profiler import TraceProfile
from repro_torch.data import pipeline
from repro_torch.kernels import ref as kref
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.runtime import synthetic
from repro_torch.train import loop
from repro_torch.weights import (opt_state_from_jax, params_from_jax,
                                 reference_leaf)

MODES = ["full", "remat", "save_hbm", "offload"]
# fp32 on both sides; the reference's own modes test holds its modes to
# rtol 1e-5 (loss) and rtol 1e-4 + atol 1e-5 (gradients) of each other
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
OPT_TOL = dict(atol=1e-6, rtol=1e-5)     # float32 elementwise arithmetic


def _numpy(tree):
    """Copies (the reference's loop donates the arrays it is given)."""
    return jax.tree.map(np.array, tree)


def arch_case(name):
    """The reduced config of ``name`` in both packages, the reference's
    parameters and a batch of 2 x 16 tokens."""
    cfg_j = ref_config(name).reduced()
    params_j, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                     cfg_j))
    toks = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (2, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    return cfg_j, params_j, get_config(name).reduced(), batch


# zamba2-7b's cases are in tests/test_torch_train_hybrid.py
@pytest.fixture(scope="module", params=["smollm-360m"])
def arch(request):
    return arch_case(request.param)


@pytest.mark.parametrize("mi", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_loss_and_grads_match_reference(arch, mode, mi):
    """Mirrors test_configs_smoke.py::test_sentinel_modes_agree across the
    packages: each mode and MI gives the reference's loss and gradients
    (zamba2's shared block is one leaf in both, the sum over its uses);
    "offload" hands each of estimate_offload_traffic's blocks' carries to
    the host store and takes it back once, and the other modes none."""
    cfg_j, params_j, cfg_t, batch = arch
    kw_j = ref_offload.loss_kwargs(ref_offload.SentinelConfig(
        mode=mode, mi_periods=mi))
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss_fn(p, cfg_j, bj, **kw_j)))(params_j)
    grads_j = _numpy(grads_j)

    params = params_from_jax(cfg_t, _numpy(params_j), device="cpu",
                             requires_grad=True)
    named = dict(params.named_parameters())
    scfg = offload.SentinelConfig(mode=mode, mi_periods=mi)
    offload.reset_traffic()
    loss = model.loss_fn(params, cfg_t,
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         **offload.loss_kwargs(scfg))
    grads = torch.autograd.grad(loss, list(named.values()))
    torch.testing.assert_close(loss.detach(),
                               torch.tensor(float(loss_j)), **LOSS_TOL)
    for (name, _), g in zip(named.items(), grads):
        torch.testing.assert_close(
            g, torch.from_numpy(np.array(reference_leaf(cfg_t, grads_j,
                                                        name))),
            **GRAD_TOL, msg=lambda m: f"{mode} mi {mi} {name}: {m}")

    # on the CPU the host store keeps each carry where it lies: it sees
    # every block's carry once each way, and copies no byte
    prof = TraceProfile(num_periods=cfg_t.num_periods, num_steps=0)
    blocks = offload.estimate_offload_traffic(prof, mi, 1)["blocks"]
    assert offload.traffic == {"out": blocks if mode == "offload" else 0,
                               "in": blocks if mode == "offload" else 0,
                               "d2h": 0, "h2d": 0}


def test_modes_refuse_an_interval_that_does_not_tile():
    cfg = get_config("smollm-360m").reduced()           # 2 periods
    params = model.init_params(cfg, device="cpu", requires_grad=True)
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.int32),
             "labels": torch.zeros(1, 4, dtype=torch.int32)}
    with pytest.raises(ValueError, match="not divisible"):
        model.loss_fn(params, cfg, batch, **offload.loss_kwargs(
            offload.SentinelConfig(mode="remat", mi_periods=3)))
    with pytest.raises(ValueError, match="mode"):
        offload.SentinelConfig(mode="swap")


def test_serving_builds_no_graph():
    """forward serves under no_grad whatever the parameters ask."""
    cfg = get_config("smollm-360m").reduced()
    params = model.init_params(cfg, device="cpu", requires_grad=True)
    out = model.forward(params, cfg,
                        {"tokens": torch.zeros(1, 4, dtype=torch.int32)})
    assert not out.requires_grad
    assert not any(p.requires_grad for p in
                   model.init_params(cfg, device="cpu").parameters())


# -------------------------------------------------------------- offload ----

@pytest.mark.parametrize("periods", [4, 6, 12])
def test_from_plan_and_traffic_match_reference(periods):
    """from_plan rounds the planned MI to a divisor of P as the reference
    does, on the same synthetic profile planned by each package on the
    paper's machine; estimate_offload_traffic gives the same numbers."""
    prof_j = ref_synthetic.synthetic_profile(num_periods=periods)
    prof_t = synthetic.synthetic_profile(num_periods=periods)
    for frac in (0.2, 0.4, 0.8):
        plan_j = ref_runtime.plan(prof_j, REF_PAPER_HM,
                                  frac * prof_j.peak_bytes())
        plan_t = runtime.plan(prof_t, PAPER_HM, frac * prof_t.peak_bytes())
        got = offload.from_plan(prof_t, plan_t, offload_opt_state=True)
        want = ref_offload.from_plan(prof_j, plan_j, offload_opt_state=True)
        assert (got.mode, got.mi_periods, got.offload_opt_state) == \
            (want.mode, want.mi_periods, want.offload_opt_state)
        assert periods % got.mi_periods == 0
    for mi in range(1, periods + 2):
        assert offload.estimate_offload_traffic(prof_t, mi, 12345) == \
            ref_offload.estimate_offload_traffic(prof_j, mi, 12345)


def test_loss_kwargs_match_reference():
    for mode in MODES:
        for mi in (1, 2, 4):
            got = offload.loss_kwargs(offload.SentinelConfig(mode, mi))
            want = ref_offload.loss_kwargs(ref_offload.SentinelConfig(mode,
                                                                      mi))
            assert set(got) == set(want)
            assert got.get("mi_periods") == want.get("mi_periods")
            assert got.get("tag_block_out") == want.get("tag_block_out")
            assert (got.get("remat_policy") is None) == \
                (want.get("remat_policy") is None)


def test_opt_state_placement_on_the_cpu():
    """On the CPU host memory is the device: nothing is pinned."""
    place = offload.opt_state_placement("cpu", offload=True)
    assert not place.pinned
    t = place.put(torch.ones(3, dtype=torch.bfloat16))
    assert t.dtype == torch.float32 and t.device.type == "cpu"


# ---------------------------------------------------------------- AdamW ----

def _opt_case(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (0.5, 3.0, 0.1)]
    return params, grads


# the fused pass's leaves: sizes off its vector width of 4, one element, a
# matrix, and leaves over several of the test's chunks of 16 elements
FUSED_SHAPES = {"w": (6, 5), "b": (5,), "one": (1,), "long": (130,),
                "odd": (37,)}
FUSED_CHUNK, FUSED_THREADS = 16, 4
# one bf16 step apart: an element of a bf16 leaf may round the other way
# where two float32 results differ in their last place
BF16_TOL = dict(atol=0.0, rtol=2.0 ** -7)


def _fused_case(dtype, seed=1):
    """Parameters and three steps of gradients for the fused pass, float32
    arrays holding ``dtype``'s values (exact in both packages)."""
    rng = np.random.default_rng(seed)

    def held(x):
        return torch.from_numpy(x.astype(np.float32)).to(dtype).float() \
            .numpy()
    params = {k: held(rng.standard_normal(sh))
              for k, sh in FUSED_SHAPES.items()}
    grads = [{k: held(rng.standard_normal(v.shape) * s)
              for k, v in params.items()} for s in (0.5, 3.0, 0.1)]
    return params, grads


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` starting one element past a 16-byte boundary, which
    the kernel reads element by element."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


ADAMW_CASES = [pytest.param("eager", torch.float32, 2.0, c, h,
                            id=f"{c}-{h}")
               for c in (False, True) for h in (False, True)] + \
    [pytest.param("fused", dt, clip, False, False,
                  id=f"fused-{str(dt)[6:]}-{name}")
     for dt in (torch.float32, torch.bfloat16)
     for clip, name in ((2.0, "clipped"), (1e3, "unclipped"))]


@pytest.mark.parametrize("impl,dtype,clip,compress,on_host", ADAMW_CASES)
def test_adamw_update_matches_reference(impl, dtype, clip, compress,
                                        on_host):
    """Three steps from the same parameters: params, moments, error
    feedback, count, grad norm and lr equal the reference's at float32
    rounding (OPT_TOL).  ``eager``: ``update`` on the CPU (the second step
    clipped).  ``fused``: the fused pass's algorithm in plain torch
    (``kernels/ref.adamw_fused_ref``, on chunks of 16 elements summed by 4
    threads, one leaf off 16 bytes) against the reference and against
    ``update``, in float32 and bfloat16, the clip engaged on the second
    step or never; a bfloat16 parameter within one bf16 step (BF16_TOL)."""
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip,
                  compress_grads=compress)
    cfg_j, cfg_t = ref_adamw.OptConfig(**cfg_kw), adamw.OptConfig(**cfg_kw)
    params, grads = _opt_case() if impl == "eager" else _fused_case(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    pj = {k: jnp.asarray(v).astype(jdt) for k, v in params.items()}
    sj = ref_adamw.init(pj, cfg_j)
    pt = {k: torch.from_numpy(v.copy()).to(dtype) for k, v in params.items()}
    st_ = adamw.init(pt, cfg_t, offload=on_host)
    sides = [("update", pt, st_)]
    if impl == "fused":
        pf = {k: torch.from_numpy(v.copy()).to(dtype)
              for k, v in params.items()}
        pf["odd"] = _unaligned(pf["odd"])
        sides.append(("fused", pf, adamw.init(pf, cfg_t)))
    ptol = BF16_TOL if dtype == torch.bfloat16 else OPT_TOL
    for g in grads:
        gj = {k: jnp.asarray(v).astype(jdt) for k, v in g.items()}
        pj, sj, mj = ref_adamw.update(gj, sj, pj, cfg_j)
        gt = {k: torch.from_numpy(v).to(dtype) for k, v in g.items()}
        out = {}
        for side, p, s in sides:
            if side == "update":
                _, _, out[side] = adamw.update(gt, s, p, cfg_t)
                continue
            names = list(p)
            s["count"], gnorm, lr = kref.adamw_fused_ref(
                [p[k] for k in names], [gt[k] for k in names],
                [s["m"][k] for k in names], [s["v"][k] for k in names],
                s["count"], cfg_t, chunk=FUSED_CHUNK, threads=FUSED_THREADS)
            out[side] = {"grad_norm": gnorm, "lr": lr}
        for side, p, s in sides:
            for k in params:
                torch.testing.assert_close(
                    p[k].float(), torch.from_numpy(
                        np.array(pj[k].astype(jnp.float32))), **ptol)
                for key in ("m", "v") + (("ef",) if compress else ()):
                    torch.testing.assert_close(s[key][k], torch.from_numpy(
                        np.array(sj[key][k])), **OPT_TOL)
            assert int(s["count"]) == int(sj["count"])
            for key in ("grad_norm", "lr"):
                torch.testing.assert_close(out[side][key], torch.tensor(
                    float(mj[key])), **OPT_TOL)
        if impl == "fused":
            (_, pe, se), (_, pf, sf) = sides
            for k in params:
                torch.testing.assert_close(pf[k].float(), pe[k].float(),
                                           **ptol)
                for key in ("m", "v"):
                    torch.testing.assert_close(sf[key][k], se[key][k],
                                               **OPT_TOL)
            for key in ("grad_norm", "lr"):
                torch.testing.assert_close(out["fused"][key],
                                           out["update"][key], **OPT_TOL)


class _Leaf:
    """A stand-in for a tensor on a device this machine need not have: what
    ``adamw.fused_path`` reads of one."""

    def __init__(self, device, dtype=torch.float32, *, numel=6,
                 contiguous=True):
        self.device, self.dtype = torch.device(device), dtype
        self.shape = torch.Size((numel,))
        self._numel, self._contiguous = numel, contiguous

    def numel(self):
        return self._numel

    def is_contiguous(self):
        return self._contiguous


# (what differs from a step on the card with its moments there, whether
# the fused pass takes it)
FUSED_PATH_CASES = {
    "card": ({}, True),
    "card-fp32": ({"p_dtype": torch.float32, "g_dtype": torch.float32},
                  True),
    "cpu": ({"device": "cpu", "m_device": "cpu"}, False),
    "pinned-moments": ({"m_device": "cpu"}, False),
    "moments-on-another-card": ({"m_device": "cuda:1"}, False),
    "compressor": ({"compress": True}, False),
    "fp16-params": ({"p_dtype": torch.float16}, False),
    "fp16-grads": ({"g_dtype": torch.float16}, False),
    "strided-param": ({"contiguous": False}, False),
    "strided-grad": ({"g_contiguous": False}, False),
    "moments-of-another-shape": ({"m_numel": 5}, False),
    "count-on-the-host": ({"count_device": "cpu"}, False),
    "no-elements": ({"numel": 0, "m_numel": 0}, False),
}


@pytest.mark.parametrize("case", FUSED_PATH_CASES)
def test_adamw_fused_path_predicate(case):
    """``update`` takes the fused pass only for parameters on a CUDA card
    with their moments on that card (not streamed from pinned host memory)
    and no compressor, each leaf one the kernels take (float32 or bfloat16,
    one shape, contiguous: ``kernels/adamw.supports``); checked through the
    predicate with stand-in leaves, since this machine has no card."""
    kw, want = FUSED_PATH_CASES[case]
    dev = kw.get("device", "cuda:0")
    names = ("a", "b")
    numel = kw.get("numel", 6)
    params = {n: _Leaf(dev, kw.get("p_dtype", torch.bfloat16), numel=numel,
                       contiguous=kw.get("contiguous", True)) for n in names}
    grads = {n: _Leaf(dev, kw.get("g_dtype", torch.bfloat16), numel=numel,
                      contiguous=kw.get("g_contiguous", True))
             for n in names}
    state = {k: {n: _Leaf(kw.get("m_device", dev),
                          numel=kw.get("m_numel", numel)) for n in names}
             for k in ("m", "v")}
    state["count"] = _Leaf(kw.get("count_device", dev), torch.int32, numel=1)
    cfg = adamw.OptConfig(compress_grads=kw.get("compress", False))
    assert adamw.fused_path(grads, state, params, cfg) is want


def test_adamw_counts_its_path():
    """The recorder's ``adamw.eager_leaves`` counts the leaves of every
    eager step (every step on the CPU); ``adamw.fused_leaves`` stays out."""
    params, grads = _opt_case()
    pt = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    cfg = adamw.OptConfig()
    state = adamw.init(pt, cfg)
    telemetry.enable()
    try:
        for g in grads:
            adamw.update({k: torch.from_numpy(v) for k, v in g.items()},
                         state, pt, cfg)
        _, counters = telemetry.drain()
    finally:
        telemetry.disable()
    assert counters == {"adamw.eager_leaves": 3 * len(params)}


def test_adamw_fused_table():
    """The fused pass's table: a zero header, then one row a leaf with an
    element (an empty leaf has none), its first chunk the chunks before
    it, and its flags (bf16 parameter, bf16 gradient, read in vectors where
    all four tensors start on 16 bytes); a leaf ``supports`` refuses
    raises."""
    from repro_torch.kernels import adamw as fused
    leaves = [(torch.zeros(5, 7, dtype=torch.bfloat16),
               torch.zeros(5, 7, dtype=torch.bfloat16)),
              (torch.zeros(0), torch.zeros(0)),
              (_unaligned(torch.zeros(3)), torch.zeros(3)),
              (torch.zeros(40), torch.zeros(40, dtype=torch.bfloat16))]
    ps, gs = [p for p, _ in leaves], [g for _, g in leaves]
    ms = [torch.zeros(p.shape) for p in ps]
    vs = [torch.zeros(p.shape) for p in ps]
    rows, n, chunks = fused.pack_table(ps, gs, ms, vs, chunk=16)
    assert (n, chunks) == (3, 3 + 1 + 3)
    assert rows.shape == (4, 8) and not rows[0].any()
    assert [r[4:].tolist() for r in rows[1:]] == [
        [35, 0, 1 | 2 | 4, 0], [3, 3, 0, 0], [40, 4, 2 | 4, 0]]
    assert rows[1, :4].tolist() == [t.data_ptr() for t in
                                    (ps[0], gs[0], ms[0], vs[0])]
    assert fused.bytes_per_param(2, 2) == 22
    with pytest.raises(ValueError, match="do not take"):
        fused.pack_table(ps, gs[:3] + [torch.zeros(41)], ms, vs, chunk=16)


def test_adamw_optimizes_quadratic():
    cfg = adamw.OptConfig(lr=0.1, warmup_steps=1, total_steps=200,
                          weight_decay=0.0, clip_norm=10.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params, cfg)
    for _ in range(100):
        params, state, _ = adamw.update({"w": 2 * params["w"]}, state,
                                        params, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_adamw_grad_clip():
    cfg = adamw.OptConfig(clip_norm=1.0, warmup_steps=1, total_steps=10)
    params = {"w": torch.zeros(3)}
    state = adamw.init(params, cfg)
    _, _, m = adamw.update({"w": torch.full((3,), 1e6)}, state, params, cfg)
    assert float(m["grad_norm"]) > 1e6  # reported pre-clip


def test_compressed_grads_still_train():
    cfg = adamw.OptConfig(lr=0.1, warmup_steps=1, total_steps=200,
                          weight_decay=0.0, compress_grads=True)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params, cfg)
    for _ in range(100):
        params, state, _ = adamw.update({"w": 2 * params["w"]}, state,
                                        params, cfg)
    assert float(params["w"].abs().max()) < 0.6


@given(st.lists(st.floats(-1e3, 1e3), min_size=4, max_size=64),
       st.lists(st.floats(-10, 10), min_size=4, max_size=64))
@settings(max_examples=50, deadline=None)
def test_error_feedback_conservation(g, ef):
    """Mass is conserved (deq + ef' == g + ef, the reference property's
    limits) and the quantized values are the reference's (the same int8
    codes: equal to float32 rounding of the scale)."""
    n = min(len(g), len(ef))
    g = np.asarray(g[:n], np.float32)
    ef = np.asarray(ef[:n], np.float32)
    deq, ef2 = adamw.compress_decompress(torch.from_numpy(g),
                                         torch.from_numpy(ef))
    np.testing.assert_allclose((deq + ef2).numpy(), g + ef, rtol=1e-5,
                               atol=1e-4)
    deq_j, _ = ref_adamw.compress_decompress(jnp.asarray(g), jnp.asarray(ef))
    np.testing.assert_allclose(deq.numpy(), np.asarray(deq_j), rtol=1e-6,
                               atol=1e-6)


@given(st.integers(0, 20_000))
@settings(max_examples=50, deadline=None)
def test_schedule_bounded(step):
    cfg = adamw.OptConfig(lr=1e-3, warmup_steps=100, total_steps=10_000)
    lr = float(adamw.schedule(cfg, step))
    assert 0.0 <= lr <= cfg.lr * 1.0001
    want = float(ref_adamw.schedule(ref_adamw.OptConfig(
        lr=1e-3, warmup_steps=100, total_steps=10_000), step))
    # near the end of the cosine, 1 + cos(pi prog) cancels: an ulp of cos
    # in float32 (2**-24 near -1) moves lr by lr / 2 * 2**-24 whatever lr is
    assert lr == pytest.approx(want, rel=1e-6, abs=cfg.lr * 2.0 ** -23)


# ----------------------------------------------------------------- data ----

@pytest.mark.parametrize("fields", [
    dict(seed=3, vocab_size=100, seq_len=16, global_batch=4),
    dict(seed=0, vocab_size=49_152, seq_len=64, global_batch=2),
    dict(seed=7, vocab_size=2048, seq_len=8, global_batch=3),
    dict(seed=1, vocab_size=300, seq_len=1, global_batch=1)])
def test_make_batch_bytes_equal_reference(fields):
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


def test_data_determinism():
    cfg = pipeline.DataConfig(seed=3, vocab_size=100, seq_len=16,
                              global_batch=4)
    a = pipeline.make_batch(cfg, 7, "cpu")
    b = pipeline.make_batch(cfg, 7, "cpu")
    c = pipeline.make_batch(cfg, 8, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 100


def test_prefetcher_orders_batches():
    cfg = pipeline.DataConfig(seed=0, vocab_size=50, seq_len=8,
                              global_batch=2)
    pf = pipeline.Prefetcher(cfg, start_step=5, depth=2, device="cpu")
    got = [next(pf) for _ in range(4)]
    pf.close()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    assert torch.equal(got[2][1]["tokens"],
                       pipeline.make_batch(cfg, 7, "cpu")["tokens"])


# ---------------------------------------------------------- checkpoints ----

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(4), {"c": torch.zeros((), dtype=torch.int32)}],
            "h": torch.tensor([1.5, -2.25, 3.0e-3], dtype=torch.bfloat16)}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(tree, str(tmp_path), 3)
    ckpt.save(tree, str(tmp_path), 7)
    assert ckpt.latest_step(str(tmp_path)) == 7
    out = ckpt.restore(_zeros_like(tree), str(tmp_path), 3)
    for x, y in zip(_leaves(tree), _leaves(out)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_gc(tmp_path):
    tree = {"a": torch.ones(2)}
    for s in range(6):
        ckpt.save(tree, str(tmp_path), s, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [4, 5]
    assert ckpt.all_steps(str(tmp_path / "none")) == []


def test_checkpoints_cross_packages(tmp_path):
    """The port reads a checkpoint the reference's ckpt.save wrote (bf16
    from its raw bits), and the reference reads the port's."""
    tree = _tree()
    ref_tree = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
                "b": [jnp.ones(4), {"c": jnp.zeros((), jnp.int32)}],
                "h": jnp.asarray([1.5, -2.25, 3.0e-3], jnp.bfloat16)}
    ref_ckpt.save(ref_tree, str(tmp_path / "ref"), 4)
    out = ckpt.restore(_zeros_like(tree), str(tmp_path / "ref"))
    for x, y in zip(_leaves(tree), _leaves(out)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    ckpt.save(tree, str(tmp_path / "port"), 9)
    back = ref_ckpt.restore(jax.tree.map(jnp.zeros_like, ref_tree),
                            str(tmp_path / "port"))
    for x, y in zip(jax.tree.leaves(ref_tree), jax.tree.leaves(back)):
        assert x.dtype == y.dtype and np.array_equal(np.asarray(x),
                                                     np.asarray(y))


# ----------------------------------------------------------------- loop ----

def test_loop_matches_reference(tmp_path):
    """Four steps of loop.run in mode offload at MI 1 from the reference's
    init_state carried across (parameters and AdamW state): the same losses
    step by step (LOSS_TOL, a little wider after three updates) and the
    same final parameters (GRAD_TOL)."""
    cfg_j = ref_config("smollm-360m").reduced()
    cfg_t = get_config("smollm-360m").reduced()
    ocfg_kw = dict(total_steps=4, warmup_steps=1)
    dcfg_kw = dict(seed=1, vocab_size=cfg_t.vocab_size, seq_len=16,
                   global_batch=2)
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
    final_j = _numpy(r_j["state"]["params"])
    for name, p in r_t["state"]["params"].named_parameters():
        torch.testing.assert_close(p.detach(), torch.from_numpy(np.array(
            reference_leaf(cfg_t, final_j, name))), **GRAD_TOL)


def test_train_loop_resume_exact(tmp_path):
    """Crash recovery is bit-exact: 10 steps straight vs 5 + resume + 5
    (mirrors test_substrates.py::test_train_loop_resume_exact)."""
    cfg = get_config("smollm-360m").reduced()
    scfg = offload.SentinelConfig(mode="remat", mi_periods=1)
    ocfg = adamw.OptConfig(total_steps=20, warmup_steps=2)
    dcfg = pipeline.DataConfig(seed=1, vocab_size=cfg.vocab_size,
                               seq_len=16, global_batch=2)
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    quiet = dict(log=lambda *a: None, device="cpu")
    r1 = loop.run(cfg, loop.TrainConfig(steps=10, ckpt_every=10, ckpt_dir=d1,
                                        log_every=100), scfg, ocfg, dcfg,
                  **quiet)
    loop.run(cfg, loop.TrainConfig(steps=5, ckpt_every=5, ckpt_dir=d2,
                                   log_every=100), scfg, ocfg, dcfg, **quiet)
    r2 = loop.run(cfg, loop.TrainConfig(steps=10, ckpt_every=10, ckpt_dir=d2,
                                        log_every=100), scfg, ocfg, dcfg,
                  **quiet)
    assert len(r2["losses"]) == 5
    assert r1["losses"][5:] == r2["losses"]
    for a, b in zip(r1["state"]["params"].parameters(),
                    r2["state"]["params"].parameters()):
        assert torch.equal(a, b)
    for k in ("m", "v"):
        for name, t in r1["state"]["opt"][k].items():
            assert torch.equal(t, r2["state"]["opt"][k][name])


def test_loop_retries_a_failed_step_from_the_checkpoint(tmp_path):
    """A step that raises is retried after the latest checkpoint is
    restored, and the run ends where an unbroken one does."""
    cfg = get_config("smollm-360m").reduced()
    scfg = offload.SentinelConfig(mode="offload", mi_periods=2)
    ocfg = adamw.OptConfig(total_steps=6, warmup_steps=1)
    dcfg = pipeline.DataConfig(seed=2, vocab_size=cfg.vocab_size,
                               seq_len=8, global_batch=2)
    step = loop.make_train_step(cfg, scfg, ocfg)
    calls = []

    def flaky(state, batch):
        calls.append(int(state["step"]))
        if len(calls) == 4:                 # the 4th call: step 3
            raise RuntimeError("lost the card")
        return step(state, batch)

    logs = []
    tcfg = dict(steps=6, ckpt_every=2, log_every=100)
    r = loop.run(cfg, loop.TrainConfig(ckpt_dir=str(tmp_path / "a"), **tcfg),
                 scfg, ocfg, dcfg, step_fn=flaky, log=logs.append,
                 device="cpu")
    clean = loop.run(cfg, loop.TrainConfig(ckpt_dir=str(tmp_path / "b"),
                                           **tcfg), scfg, ocfg, dcfg,
                     log=lambda *a: None, device="cpu")
    assert calls == [0, 1, 2, 3, 2, 3, 4, 5]
    assert any("retry 1/3" in m for m in logs)
    for a, b in zip(r["state"]["params"].parameters(),
                    clean["state"]["params"].parameters()):
        assert torch.equal(a, b)
