"""Megatron-SP in the port's partitioned training step on the CPU
(``sharding.tp_dp_rules(seq_parallel=True)``: the residual stream's
sequence on ``model``).  The embedding's and each row-split product's
partial sum is reduce-scattered onto the rank's block of the rows, each
pre-norm's output gathered whole, each norm weight's gradient summed over
``model``.  The step against plain tensor parallelism and one device in
every arch at (1, 2) and in Sentinel's four modes, FSDP off and on, at
(2, 2); offload's carries, each rank's a block of the rows; the
reference's compiled Megatron-SP train cells, run in one subprocess of 8
forced JAX devices, with XLA's own resharding pinned beside the port's
ledger (ROADMAP R16); and the dry run's ``--seq-parallel`` train cells.

Every rank is a thread on ``[cpu] * n``; torch runs on one thread in this
module.  The optimizer takes lr 1 with eps 1 after a one-step warm-up,
so comparing the updated parameters compares the gradients.  Tolerances
are fp32's, stated with each test."""
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

from repro_torch import sharding as shd
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import offload
from repro_torch.core.offload import SentinelConfig
from repro_torch.core.profiler import TraceProfile
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh, make_rules
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.train import loop

CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
OPT = adamw.OptConfig(lr=1.0, warmup_steps=1, eps=1.0)
ARCHS = ("smollm-360m", "internlm2-1.8b", "gemma2-2b", "gemma3-12b",
         "granite-moe-3b-a800m", "deepseek-v2-lite-16b", "zamba2-7b",
         "xlstm-1.3b", "lstm-ptb", "musicgen-medium", "paligemma-3b")
MODES = ("full", "remat", "save_hbm", "offload")
# fp32 on both sides: the partitioned sums add the same terms in another
# order
TOL = dict(atol=1e-5, rtol=1e-5)
# the reduced xLSTM's gradient norm: its fp32 conditioning moves it 1e-4
# of its value between programs that are equal in float64
# (tests/test_torch_tp_recurrent.py, XLSTM_REL)
XLSTM_REL = 1e-4
B, S = 4, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(arch):
    """The reduced config; a MoE's dispatch groups cut to 16 tokens, so
    each lies within one data rank's rows."""
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, group_size=16))
    return cfg


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


def one_device(cfg, params, batch, scfg):
    p = model.init_params(cfg, device="cpu", requires_grad=True)
    p.load_state_dict(params.state_dict())
    state = {"params": p, "opt": adamw.init(p, OPT),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = loop.make_train_step(cfg, scfg, OPT)(state, batch)
    return state["params"], m


def partitioned(cfg, params, batch, shape, scfg, **rule_kw):
    """(the reassembled parameters, the metrics, the ledger) of one
    partitioned step on ``[cpu] * n``."""
    mesh = shd.Mesh(shape, ("data", "model"),
                    devices=[CPU] * (shape[0] * shape[1]))
    step = loop.make_train_step(cfg, scfg, OPT,
                                shd.tp_dp_rules(mesh, **rule_kw))
    try:
        states = step.init_states(params)
        states, m = step(states, batch)
        for r in m["ranks"]:
            assert torch.equal(r["loss"], m["loss"])
            assert torch.equal(r["grad_norm"], m["grad_norm"])
        return step.gather(states), m, step.ledger
    finally:
        step.close()


def assert_same_step(got, want, arch):
    (pa, ma), (pb, mb) = got, want
    gtol = dict(TOL, rtol=XLSTM_REL) if arch.startswith("xlstm") else TOL
    torch.testing.assert_close(ma["loss"], mb["loss"], **TOL)
    torch.testing.assert_close(ma["grad_norm"], mb["grad_norm"], **gtol)
    for (leaf, a), (_, b) in zip(pa.named_parameters(),
                                 pb.named_parameters()):
        torch.testing.assert_close(a, b.detach(), **TOL, msg=leaf)


_ONE_DEVICE = {}


def check_seq_parallel(arch, shape, mode, fsdp):
    """One Megatron-SP step against the plain TP step on the same mesh and
    FSDP setting and against one device's (kept for the other cases of
    the mode), from the same parameters and batch: the loss within 1e-5
    (and equal across ranks), the gradient norm within 1e-5 (the reduced
    xLSTM's within XLSTM_REL), every reassembled parameter within 1e-5.
    Returns the SP and the plain TP ledgers."""
    cfg = config(arch)
    scfg = SentinelConfig(mode=mode, mi_periods=1)
    params = model.init_params(cfg, seed=0, device="cpu")
    batch = make_batch(cfg)
    if (arch, mode) not in _ONE_DEVICE:
        _ONE_DEVICE[arch, mode] = one_device(cfg, params, batch, scfg)
    p1, m1 = _ONE_DEVICE[arch, mode]
    psp, msp, lsp = partitioned(cfg, params, batch, shape, scfg, fsdp=fsdp,
                                seq_parallel=True)
    ptp, mtp, ltp = partitioned(cfg, params, batch, shape, scfg, fsdp=fsdp)
    assert_same_step((psp, msp), (p1, m1), arch)
    assert_same_step((psp, msp), (ptp, mtp), arch)
    return lsp, ltp


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_parallel_step_in_every_arch(arch):
    """Every arch in full at (1, 2): the attention, MLA and MoE blocks
    gather at both norms; Mamba, the mLSTM and the sLSTM after ``ln1``
    (the sLSTM's output, which every rank computes whole, cut back to the
    rank's rows); the LSTM gathers its input and its output stays whole;
    paligemma's sequence is cut after its prefix is joined, musicgen's
    codebooks summed before.  Each partial sum the residual takes is
    reduce-scattered, so the SP step moves reduce-scatters where plain TP
    all-reduces."""
    lsp, ltp = check_seq_parallel(arch, (1, 2), "full", False)
    assert lsp["counts"]["reduce-scatter"] > ltp["counts"]["reduce-scatter"]
    assert lsp["counts"]["all-gather"] > ltp["counts"]["all-gather"]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-7b", "xlstm-1.3b"])
def test_seq_parallel_step_in_every_mode(arch, mode, fsdp):
    """TP with DP at (2, 2) in Sentinel's four modes at MI 1, FSDP off and
    on: a Sentinel block's carry is the rank's block of the rows, and
    each recompute runs the block's gathers and reduce-scatters again."""
    check_seq_parallel(arch, (2, 2), mode, fsdp)


def test_a_sequence_the_model_axis_does_not_divide():
    """S 15 on a model axis of 2: ``rules.spec`` keeps ``seq_res`` whole,
    so the step is plain TP, ledger for ledger."""
    cfg = config("smollm-360m")
    scfg = SentinelConfig(mode="full")
    params = model.init_params(cfg, seed=0, device="cpu")
    batch = make_batch(cfg, s=15)
    _, msp, lsp = partitioned(cfg, params, batch, (1, 2), scfg,
                              seq_parallel=True)
    _, mtp, ltp = partitioned(cfg, params, batch, (1, 2), scfg)
    assert torch.equal(msp["loss"], mtp["loss"])
    assert lsp == ltp


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_offload_carries_are_a_block_of_the_rows(shape, monkeypatch):
    """Offload at MI 1: each rank hands the host store one carry a block
    (``offload.rank_traffic``), as ``estimate_offload_traffic`` counts
    for one device; under Megatron-SP each carry is the rank's block of
    the rows, so a rank's carry bytes are the estimate for its batch rows
    divided by the model axis's size, and plain TP's undivided.  (On the
    CPU a carry moves no byte; its bytes are counted at the store.)"""
    cfg = config("smollm-360m")
    params = model.init_params(cfg, seed=0, device="cpu")
    batch = make_batch(cfg)
    D, M = shape
    scfg = SentinelConfig(mode="offload", mi_periods=1)
    est = offload.estimate_offload_traffic(
        TraceProfile(num_periods=cfg.num_periods, num_steps=0), 1,
        B // D * S * cfg.d_model * 4)
    put = offload.CarryStore.put
    for sp in (True, False):
        carried = {}

        def counting(self, b, x):
            pos = offload._position()
            carried[pos] = carried.get(pos, 0) + x.numel() * x.element_size()
            return put(self, b, x)

        monkeypatch.setattr(offload.CarryStore, "put", counting)
        offload.reset_traffic()
        partitioned(cfg, params, batch, shape, scfg, seq_parallel=sp)
        assert len(offload.rank_traffic) == len(carried) == D * M
        for pos, t in offload.rank_traffic.items():
            assert t["out"] == t["in"] == est["blocks"], pos
            # out in the forward and back in the backward
            assert 2 * carried[pos] == est["bytes_offloaded"] // (
                M if sp else 1), pos


# ------------------------------------------------------------ dry run --

@pytest.mark.parametrize("arch", ARCHS[:7] + ARCHS[9:])
def test_dryrun_seq_parallel_train_cells(arch):
    """The dry run's ``--seq-parallel`` train cells carry ``collectives``
    (reduced configs, the 16 x 16 mesh, offload at the default MI): the
    rank program's reduce-scatters and gathers where plain TP's all-reduce
    ran; reduced zamba2-7b's and xlstm-1.3b's train steps at B 16 x S 64
    on the same rules (their cells' S 4096 makes the reduced SSD chunk's
    and the token loops' costing minutes long: the CLI's full-width cells
    take that time)."""
    cfg = get_config(arch).reduced()
    if arch in ("zamba2-7b", "xlstm-1.3b"):
        rules = make_rules(make_production_mesh(), kind="train",
                           seq_parallel=True)
        fn, args, in_sh = specs.build_train_cell(
            cfg, ShapeConfig("w", 64, 16, "train"), rules,
            SentinelConfig("offload", specs.default_mi(cfg)))
        coll = dryrun.rank_collectives(fn, args, in_sh, rules)
    else:
        rec = dryrun.run_cell(arch, "train_4k", cfg=cfg, seq_parallel=True)
        assert rec["ok"] and rec["seq_parallel"] is True
        assert "collectives_note" not in rec
        coll = rec["collectives"]
    assert coll["counts"]["reduce-scatter"] > 0
    assert coll["counts"]["all-gather"] > 0


# ------------------------------------------------------- the reference --

# The reference's Megatron-SP train cells of the reduced models, in one
# subprocess of 8 forced CPU devices: each cell (offload at MI 1,
# ``tp_dp_rules(mesh, seq_parallel=True)`` at (2, 2), B 8 x S 32)
# compiled and run once from PRNGKey(0)'s parameters and a batch from seed
# 0: its loss, gradient norm, updated parameters and collective bytes
REF_ARCHS = ("smollm-360m", "granite-moe-3b-a800m", "zamba2-7b",
             "xlstm-1.3b")
REF_B, REF_S = 8, 32
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

    out_dir, archs, b, s = json.loads(sys.argv[1])
    opt = adamw.OptConfig(lr=1.0, warmup_steps=1, eps=1.0)
    scfg = SentinelConfig(mode="offload", mi_periods=1)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    rules = shd.tp_dp_rules(mesh, seq_parallel=True)
    rec = {}
    for arch in archs:
        c = get_config(arch).reduced()
        if c.moe is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, group_size=16))
        rng = np.random.default_rng(0)
        batch_np = {k: rng.integers(0, c.vocab_size, (b, s))
                    .astype(np.int32) for k in ("tokens", "labels")}
        np.savez(os.path.join(out_dir, f"batch_{arch}.npz"), **batch_np)
        with mesh, shd.axis_rules(rules):
            fn, args, in_sh = specs.build_train_cell(
                c, ShapeConfig("tiny", s, b, "train"), rules, scfg, opt)
            compiled = jax.jit(fn, in_shardings=in_sh).lower(
                *args).compile()
            params, _ = split_params(
                model.init_params(jax.random.PRNGKey(0), c))
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
        rec[arch] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "bytes": collective_bytes(
                compiled.as_text(), loop_trips=float(c.num_periods))["bytes"]}
    print(json.dumps(rec))
""")


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The REFERENCE script, started when the module starts so that it
    runs beside the port's tests; ``reference`` waits for it."""
    out = tmp_path_factory.mktemp("ref_seqpar")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, json.dumps(
        [str(out), REF_ARCHS, REF_B, REF_S])], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_run):
    proc, out = reference_run
    stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1]), out


# XLA's collective bytes of the reference's compiled Megatron-SP train
# cells on this JAX (0.9.0, forced CPU devices), beside the port's ledger
# of the same step (ROADMAP R16).  XLA emits no reduce-scatter on this
# backend: it gathers at the norms and keeps its all-reduces; the port
# reduce-scatters each partial sum onto the rank's rows, gathers each
# pre-norm's output (its backward the rank's block of the gradient) and
# all-reduces the gradient of each replicated input of a split product
XLA_SP = {
    "smollm-360m": {"all-gather": 459264.0, "all-reduce": 872740.0,
                    "collective-permute": 33024.0},
    "granite-moe-3b-a800m": {"all-gather": 475648.0, "all-reduce": 973188.0,
                             "collective-permute": 33024.0},
    "zamba2-7b": {"all-gather": 2126336.0, "all-reduce": 2810980.0,
                  "all-to-all": 1483776.0, "collective-permute": 1657600.0},
    "xlstm-1.3b": {"all-gather": 12260352.0, "all-reduce": 4000312.0,
                   "all-to-all": 12429312.0, "collective-permute": 256256.0}}
PORT_SP = {
    "smollm-360m": {"all-gather": 458752.0, "all-reduce": 380936.0,
                    "reduce-scatter": 147456.0},
    "granite-moe-3b-a800m": {"all-gather": 458752.0, "all-reduce": 483528.0,
                             "reduce-scatter": 147456.0},
    "zamba2-7b": {"all-gather": 4011136.0, "all-reduce": 1134760.0,
                  "reduce-scatter": 1140800.0},
    "xlstm-1.3b": {"all-gather": 3667968.0, "all-reduce": 2426376.0,
                   "reduce-scatter": 2368768.0}}


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_seq_parallel_step_equals_the_reference(reference, arch):
    """From the reference's parameters and batch, offload at MI 1 on (2,
    2): loss within 1e-5 of the reference's compiled Megatron-SP cell,
    the gradient norm within 1e-5 of it (the reduced xLSTM's within
    XLSTM_REL), every updated parameter within 1e-4; both ledgers
    pinned."""
    import jax
    from repro.configs.base import get_config as ref_config
    from repro.models import model as ref_model
    from repro.models.layers import split_params
    from repro_torch.weights import params_from_jax
    rec, out = reference
    cfg = config(arch)
    ref_cfg = ref_config(arch).reduced()
    if ref_cfg.moe is not None:
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
            ref_cfg.moe, group_size=16))
    tree, _ = split_params(ref_model.init_params(jax.random.PRNGKey(0),
                                                 ref_cfg))
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, tree),
                             device="cpu")
    batch = {k: torch.as_tensor(v.astype(np.int64))
             for k, v in np.load(out / f"batch_{arch}.npz").items()}
    got, m, led = partitioned(cfg, params, batch, (2, 2), SentinelConfig(
        mode="offload", mi_periods=1), seq_parallel=True)
    r = rec[arch]
    gtol = XLSTM_REL if arch.startswith("xlstm") else 1e-5
    assert abs(float(m["loss"]) - r["loss"]) <= 1e-5
    assert abs(float(m["grad_norm"]) - r["grad_norm"]) <= \
        gtol * r["grad_norm"]
    new = np.load(out / f"new_{arch}.npz")
    want = params_from_jax(cfg, jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree),
        [new[jax.tree_util.keystr(k)] for k, _ in leaves]), device="cpu")
    for (leaf, a), (_, b) in zip(got.named_parameters(),
                                 want.named_parameters()):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=leaf)
    port = {k: v for k, v in led["bytes"].items() if v}
    xla = {k: v for k, v in r["bytes"].items() if v}
    print(f"{arch}: XLA {xla}, port {port}")
    assert xla == XLA_SP[arch]
    assert port == PORT_SP[arch]
