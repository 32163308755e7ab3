"""The comparison that decides ``correct`` fails the control and every
fault a cell can have, at a size a CPU test holds: the control (the
reference in float8 e4m3 in the program's place), a step that returns its
state unchanged, half of the batch left out, and a served token altered
where it is produced.  Each drives the rest of a run as the harness does,
with the timed path broken underneath, under the cells' own limits."""
import json

import pytest
import torch

from bench_tiny import BENCH, config, serve_mix, train_mix
from benchkit import compare
from benchkit.drivers import serve, train

CPU = torch.device("cpu")


def limits(name):
    return json.loads((BENCH / "limits" / f"{name}.json").read_text())


def _train_run(break_step, seed=2 ** 31 + 21):
    cfg, mix = config(), train_mix("offload")
    lim = limits("smollm-360m.train.offload")
    _, prog = train.program_readings(cfg, mix, seed, CPU, 0.0, 0.2, False,
                                     break_step=break_step)
    ref = train.reference_readings(cfg, mix, seed, CPU)
    return compare.train_checks(prog, ref, lim)


def _failed(checks):
    return [n for n, v, lim in checks if not v <= lim]


def test_sound_training_passes():
    assert not _failed(_train_run(None))


def test_training_control_fails():
    cfg, mix = config(), train_mix("offload")
    lim = limits("smollm-360m.train.offload")
    for seed in (1, 2, 3):
        ref = train.reference_readings(cfg, mix, seed, CPU)
        ctl = train.reference_readings(cfg, mix, seed, CPU, prec="fp8")
        assert "grad_gap" in _failed(compare.train_checks(ctl, ref, lim))


def test_state_left_unchanged_fails():
    def unchanged(step):
        def stuck(state, batch):
            return state, {"loss": torch.tensor(7.0)}
        return stuck
    assert {"grad_gap", "change_gap"} <= set(_failed(_train_run(unchanged)))


def test_half_the_batch_fails():
    def half(step):
        def on_half(state, batch):
            return step(state, {k: v[: v.shape[0] // 2]
                                for k, v in batch.items()})
        return on_half
    assert "grad_gap" in _failed(_train_run(half))


def test_altered_token_fails(monkeypatch):
    from repro_torch.serve.engine import ContinuousBatcher
    real = ContinuousBatcher._pool_decode_step
    calls = []

    def altered(self):
        tok = real(self)
        calls.append(1)
        if len(calls) % 3 == 0:                 # every third step
            tok = (tok + 1) % self.cfg.vocab_size
        return tok
    monkeypatch.setattr(ContinuousBatcher, "_pool_decode_step", altered)
    cfg = config("internlm2-1.8b")
    run = serve.run(cfg, serve_mix(), limits("internlm2-1.8b.serve.decode"),
                    2 ** 31 + 3, 0.5, False, CPU, 0.0)
    assert not run.correct, run.checks


def test_serving_control_fails():
    cfg = config("internlm2-1.8b")
    lim = limits("internlm2-1.8b.serve.decode")
    run = serve.run(cfg, serve_mix(), lim, 2 ** 31 + 3, 0.5, False,
                    CPU, 0.0)
    assert run.correct
    gap = serve.reference_gap(cfg, run.sample, 2 ** 31 + 3, CPU, prec="fp8")
    assert gap > lim["served_logit_gap"]
