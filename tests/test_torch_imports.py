"""Import hygiene of the port: no module of repro_torch and no import in
chip_smoke.py loads JAX or the reference package, and the entry points
refuse to fall back to the CPU when no card is present."""
import ast
import dataclasses
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.models import model
from repro_torch.serve.engine import ContinuousBatcher
from repro_torch.runtime.plan import PlacementPlan, PlanDelta

ROOT = Path(__file__).resolve().parents[1]


def _forbidden(name: str) -> bool:
    return name.startswith("jax") or name == "repro" or \
        name.startswith("repro.")


def test_port_modules_import_no_jax_and_no_reference():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert {"repro_torch.serve.engine", "repro_torch.kernels.paged_decode",
            "repro_torch.kernels.ssd", "repro_torch.models.ssm",
            "repro_torch.configs.zamba2_7b",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.decode_attention",
            "repro_torch.kernels.ops", "repro_torch.kernels.ref",
            "repro_torch.models.kvcache", "repro_torch.models.attention",
            "repro_torch.models.transformer", "repro_torch.models.model",
            "repro_torch.configs.base"} <= set(mods)
    assert {f"repro_torch.runtime.{m}" for m in (
        "objects", "costmodel", "tiergraph", "policies", "plan", "online",
        "synthetic")} <= set(mods)
    assert {f"repro_torch.core.{m}" for m in (
        "hardware", "profiler", "allocator", "hmsim", "offload")} <= set(mods)
    assert {"repro_torch.optim.adamw", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.ckpt", "repro_torch.train.loop",
            "repro_torch.launch.train"} <= set(mods)
    assert {"repro_torch.serve.disagg", "repro_torch.launch.mesh",
            "repro_torch.launch.serve"} <= set(mods)
    assert {"repro_torch.models.moe"} | {f"repro_torch.configs.{m}" for m in (
        "gemma2_2b", "gemma3_12b", "internlm2_1p8b", "granite_moe_3b",
        "deepseek_v2_lite")} <= set(mods)
    assert {"repro_torch.models.xlstm", "repro_torch.configs.xlstm_1p3b",
            "repro_torch.configs.lstm_ptb"} <= set(mods)
    assert {"repro_torch.configs.musicgen_medium",
            "repro_torch.configs.paligemma_3b"} <= set(mods)
    assert {"repro_torch.sharding", "repro_torch.launch.specs",
            "repro_torch.launch.costing", "repro_torch.launch.dryrun"} <= \
        set(mods)
    # importing builds and loads no kernel: nvcc runs at a kernel's first
    # call only (this machine may have none)
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from repro_torch.kernels import build\n"
            "assert not build._loaded\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True, timeout=300)
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if _forbidden(m)] == []
    assert set(mods) <= set(loaded)


def test_chip_smoke_imports_no_jax_and_no_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "repro_torch.serve.engine" in names
    assert [n for n in names if _forbidden(n)] == []


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              use_paged_decode=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(cfg)
    params = model.init_params(cfg, device="cpu")
    plan = PlacementPlan(hot_window=16, page_tokens=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(params, cfg, 2, 32, plan=plan, paged=True)
    ContinuousBatcher(params, cfg, 2, 32, plan=plan, paged=True,
                      device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(params, cfg, 2, 32)      # all-HBM
    hybrid = get_config("zamba2-7b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(hybrid)
    model.init_params(hybrid, device="cpu")


def test_training_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The train loop's state, its batches and the training CLI run on the
    card unless given the CPU."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import train
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.loop import init_state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smollm-360m").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(cfg, OptConfig())
    state = init_state(cfg, OptConfig(), device="cpu")
    assert all(p.requires_grad for p in state["params"].parameters())
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch(dcfg, 0)
    assert make_batch(dcfg, 0, device="cpu")["tokens"].device.type == "cpu"
    argv = ["--reduced", "--steps", "2", "--seq", "8", "--batch", "2",
            "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(argv)
    out = train.main(argv + ["--device", "cpu"])
    assert len(out["losses"]) == 2


def test_serving_cli_runs_on_the_cpu_when_asked(monkeypatch):
    """The serving CLI at reduced size on the CPU, as a user runs it: it
    exits 0 and prints its rate and tokens.  Without ``--device cpu`` it
    needs a card."""
    from repro_torch.launch import serve
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "-n", "4", "--batch", "2", "--temperature",
         "0.7"], capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert "8 tokens in" in lines[-2] and "tok/s batched) on cpu" in lines[-2]
    assert len(json.loads(lines[-1])) == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "-n", "2"])
    out = serve.main(["--reduced", "--device", "cpu", "-n", "3", "--batch",
                      "2", "--temperature", "0.7", "--seed", "5"])
    again = serve.main(["--reduced", "--device", "cpu", "-n", "3", "--batch",
                        "2", "--temperature", "0.7", "--seed", "5"])
    assert out.shape == (2, 3) and torch.equal(out, again)


def test_unported_layouts_raise():
    """All four engine layouts are ported, and every layer kind of the
    reference with its cache (the MLA latent, the xLSTM and LSTM states
    among them); a layer kind the reference does not have raises when its
    config is built.  Every arch of the reference is registered: the list
    of unported archs is gone, and musicgen-medium (codebooks) and
    paligemma-3b (the prefix-LM) build, full and reduced, equal to the
    reference's configs field for field.  As in the reference, paged=True
    needs a plan and a re-plan applies to the pools only; an incremental
    re-plan applies only against the plan it was diffed from."""
    cfg = get_config("smollm-360m").reduced()
    params = model.init_params(cfg, device="cpu")
    dataclasses.replace(cfg, period=("mlstm", "slstm"))
    with pytest.raises(ValueError, match="unknown layer kinds"):
        dataclasses.replace(cfg, period=("mlstm", "conv"))
    from repro.configs import base as ref_base
    from repro_torch.configs import base, list_archs
    assert not hasattr(base, "UNPORTED_ARCHS")
    assert list_archs() == ref_base.list_archs()
    for arch in ("musicgen-medium", "paligemma-3b"):
        for got, ref in ((get_config(arch), ref_base.get_config(arch)),
                         (get_config(arch).reduced(),
                          ref_base.get_config(arch).reduced())):
            assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    with pytest.raises(ValueError, match="requires a plan"):
        ContinuousBatcher(params, cfg, 2, 32, paged=True, device="cpu")
    plan = PlacementPlan(page_tokens=4)
    for paged in (False, True):              # concat and paged-merged
        b = ContinuousBatcher(params, cfg, 2, 32, plan=plan, paged=paged,
                              device="cpu")
        with pytest.raises(ValueError, match="persistent-pools"):
            b.apply_plan(plan)
    b = ContinuousBatcher(params, dataclasses.replace(
        cfg, use_paged_decode=True), 2, 32, plan=plan, paged=True,
        device="cpu")
    with pytest.raises(ValueError, match="emission order"):
        b.apply_plan(PlanDelta(base_digest="0" * 16, changes={}))


def test_port_names_no_tpu_machine():
    """The port's machine is the H100: no source file of the package names
    the reference's TPU constants or machine."""
    hits = [str(p.relative_to(ROOT)) for p in
            (ROOT / "src" / "repro_torch").rglob("*")
            if p.is_file() and p.suffix in (".py", ".cu", ".h", ".cuh")
            and any(w in p.read_text() for w in ("TPU_V5E", "tpu-v5e"))]
    assert hits == []


def test_cached_hybrid_path_raises():
    """The zamba2 hybrid serves on every layout, but on the pools it admits
    by one dense prefill, so a prefill chunk budget is refused, as the
    reference refuses it; a MAMBA decode needs one token and a cache."""
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(),
                              use_paged_decode=True)
    params = model.init_params(cfg, device="cpu")
    plan = PlacementPlan(page_tokens=4, prefill_chunk_tokens=8)
    with pytest.raises(ValueError, match="prefill_chunk_tokens"):
        ContinuousBatcher(params, cfg, 2, 32, plan=plan, paged=True,
                          device="cpu")
    b = ContinuousBatcher(params, cfg, 2, 32, plan=plan, paged=True,
                          prefill_chunk_tokens=0, device="cpu")
    assert not b._pool_prefill_ok
    with pytest.raises(ValueError, match="one token and a cache"):
        model.forward(params, cfg, {"tokens": torch.zeros(1, 1, dtype=int)},
                      cache_index=torch.zeros(1, dtype=torch.int32),
                      decode=True)
