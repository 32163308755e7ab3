"""The plain reference against the port at a reduced size on the CPU, and
the configuration files against the port's registered configs."""
import dataclasses
import json

import pytest
import torch

from bench_tiny import BENCH, config, serve_mix, train_mix
from benchkit import port, weights
from reference import dense_gqa as ref

SIZES = ("num_hidden_layers", "hidden_size", "intermediate_size",
         "num_attention_heads", "num_key_value_heads", "vocab_size",
         "head_dim", "rope_theta", "tie_word_embeddings")


@pytest.mark.parametrize("name", ["smollm-360m", "internlm2-1.8b"])
def test_port_configs_hold_the_published_sizes(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    diff = port.differences(cfg)
    assert not set(diff) & set(SIZES), diff
    # the one departure: the registered configs keep the port's default
    # norm epsilon; the benchmark runs the published one
    assert set(diff) <= {"rms_norm_eps"}
    assert port.config(cfg).norm_eps == cfg["rms_norm_eps"]


def _fp32_port(cfg, seed):
    pc = dataclasses.replace(port.config(cfg), dtype="float32")
    from repro_torch.models import model
    w = weights.make(cfg, seed, "cpu", torch.float32)
    m = model.Model(pc, device=torch.device("cpu"), dtype=torch.float32)
    weights.load_into(m, cfg, w)
    return pc, m, w


@pytest.mark.parametrize("name", ["smollm-360m", "internlm2-1.8b"])
def test_forward_matches_the_port(name):
    torch.manual_seed(0)
    cfg = config(name)
    pc, m, w = _fp32_port(cfg, 2 ** 31 + 5)
    from repro_torch.models import model
    tokens = torch.randint(0, cfg["vocab_size"], (2, 24))
    got = model.forward(m, pc, {"tokens": tokens})[..., :cfg["vocab_size"]]
    for b in range(2):
        want = ref.logits(w, cfg, tokens[b])
        torch.testing.assert_close(got[b], want, atol=2e-5, rtol=2e-5)


def test_loss_and_gradients_match_the_port():
    cfg = config("smollm-360m")
    pc, m, w = _fp32_port(cfg, 11)
    from repro_torch.models import model
    m.requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, cfg["vocab_size"], (2, 17), generator=g)
    batch = {"tokens": x[:, :-1], "labels": x[:, 1:]}
    loss = model.loss_fn(m, pc, batch)
    names = weights.port_names(cfg)
    params = dict(m.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    want_loss, want = ref.loss_and_grads(w, cfg, batch)
    assert float(loss.detach()) == pytest.approx(want_loss, rel=1e-5)
    for (n, _), gr in zip(params.items(), grads):
        torch.testing.assert_close(gr[:cfg["vocab_size"]] if n == "table"
                                   else gr, want[names[n]], atol=1e-5,
                                   rtol=1e-4)


def test_train_cell_agrees_with_the_reference_in_bf16():
    from benchkit.drivers import train
    cfg, mix = config(), train_mix("full")
    limits = json.loads((BENCH / "limits" /
                         "smollm-360m.train.full.json").read_text())
    run = train.run(cfg, mix, limits, 2 ** 31 + 1, 0.5, False,
                    torch.device("cpu"), 0.0)
    assert run.correct, run.checks
    assert run.notes["loss_gap"] < 1e-3


def test_serve_cell_agrees_with_the_reference_in_bf16():
    from benchkit.drivers import serve
    cfg = config("internlm2-1.8b")
    limits = json.loads((BENCH / "limits" /
                         "internlm2-1.8b.serve.decode.json").read_text())
    run = serve.run(cfg, serve_mix(), limits, 2 ** 31 + 3, 0.5, False,
                    torch.device("cpu"), 0.0)
    assert run.correct, run.checks
    assert run.sample and all(r["served"] for r in run.sample)
