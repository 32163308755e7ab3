"""The port's recorder (``repro_torch.telemetry``) and the pools' count of
the cold pages K1 reads, on the CPU.

  * off, ``span`` returns one shared no-op and nothing is recorded; on,
    spans nest per thread, carry their parent and key, and lie inside a
    ``time.time_ns`` interval taken around them; ``drain`` clears; many
    threads lose no count and no span;
  * a planned engine with cold pages and a train step give the same tokens
    and losses with the recorder on and off, and record their layers'
    spans when it is on;
  * ``PagedKVPools.stats["cold_page_reads"]`` equals, step by step, the
    entries K1 reads from the cold pool in the page tiers and lengths it is
    handed (a finished slot's stale length included), over every layer.
"""
import dataclasses
import os
import sys
import threading
import time

import pytest
import torch

from repro_torch import runtime, telemetry
from repro_torch.configs import get_config
from repro_torch.core.offload import SentinelConfig
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.serve.engine import ContinuousBatcher, serve_trace_for
from repro_torch.train import loop

MAX_SEQ, SLOTS, PAGE = 32, 2, 4
# slot 0 finishes first, is refilled by a chunked prefill, finishes again
# and stays stale while slot 1 decodes on
REQUESTS = [(17, 3), (9, 12), (6, 4)]


@pytest.fixture(autouse=True)
def recorder_off():
    telemetry.disable()
    telemetry.drain()
    yield
    telemetry.disable()
    telemetry.drain()


def test_off_records_nothing_and_returns_one_object():
    spans = {id(telemetry.span("engine.step")) for _ in range(3)}
    spans.add(id(telemetry.span("engine.prefill_chunk", key=1)))
    assert spans == {id(telemetry.OFF)}
    with telemetry.span("train.forward") as inside:
        assert inside is None
    telemetry.count("offload.carry_waits", 2)
    telemetry.elapsed_ms("offload.carry_wait_ms", None, None)
    assert not telemetry.enabled()
    assert telemetry.drain() == ([], {})


def test_spans_nest_with_parent_key_and_clock():
    telemetry.enable()
    w0 = time.time_ns()
    with telemetry.span("engine.step"):
        with telemetry.span("engine.admit"):
            with telemetry.span("engine.prefill_chunk", key=3):
                pass
        with telemetry.span("engine.readback"):
            pass
    w1 = time.time_ns()
    spans, _ = telemetry.drain()
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["engine.step", "engine.admit",
                                       "engine.prefill_chunk",
                                       "engine.readback"]
    assert by["engine.step"].parent is None
    assert by["engine.admit"].parent == "engine.step"
    assert by["engine.prefill_chunk"].parent == "engine.admit"
    assert by["engine.readback"].parent == "engine.step"
    assert by["engine.prefill_chunk"].key == 3
    assert by["engine.step"].key is None
    assert {s.thread for s in spans} == {threading.get_ident()}
    for s in spans:
        assert w0 <= s.start_ns <= s.end_ns <= w1
    outer = by["engine.step"]
    for s in spans[1:]:
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns


def test_parents_are_per_thread():
    """Two threads with spans open at once: each span's parent is the
    innermost open span of its own thread."""
    telemetry.enable()
    both_open = threading.Barrier(2, timeout=10)
    idents = {}

    def work(tag):
        idents[tag] = threading.get_ident()
        with telemetry.span(f"{tag}.outer"):
            both_open.wait()
            with telemetry.span(f"{tag}.inner", key=len(tag)):
                both_open.wait()

    threads = [threading.Thread(target=work, args=(t,))
               for t in ("train", "offload")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    spans, _ = telemetry.drain()
    assert len(spans) == 4
    for s in spans:
        tag = s.name.split(".")[0]
        assert s.thread == idents[tag]
        assert s.parent == (None if s.name.endswith("outer")
                            else f"{tag}.outer")


def test_threads_lose_no_count_or_span():
    """More threads than cores, switching as often as the interpreter
    allows: every count and every span lands."""
    telemetry.enable()
    n_threads, n = 2 * (os.cpu_count() or 4) + 2, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with telemetry.span("engine.step"):
                    telemetry.count("offload.carry_waits")
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    spans, counters = telemetry.drain()
    assert counters == {"offload.carry_waits": n_threads * n}
    assert len(spans) == n_threads * n
    assert all(s.parent is None for s in spans)


class _Event:
    """Stands in for a timed CUDA event: ``elapsed_time`` in ms."""

    def __init__(self, t):
        self.t, self.waited = t, False

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        assert end.waited
        return end.t - self.t


def test_counters_and_timings_clear_on_drain():
    telemetry.enable()
    telemetry.count("offload.carry_waits")
    telemetry.count("offload.carry_waits", 2)
    telemetry.elapsed_ms("offload.carry_wait_ms", _Event(1.0), _Event(3.5))
    telemetry.elapsed_ms("offload.carry_wait_ms", _Event(4.0), _Event(4.25))
    with telemetry.span("train.adamw"):
        pass
    spans, counters = telemetry.drain()
    assert [s.name for s in spans] == ["train.adamw"]
    assert counters == {"offload.carry_waits": 3,
                        "offload.carry_wait_ms": 2.75}
    assert telemetry.drain() == ([], {})
    telemetry.disable()
    with telemetry.span("train.adamw"):
        pass
    assert telemetry.drain() == ([], {})


# ------------------------------------------------------------- engine --

def _engine_setup(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              use_paged_decode=True)
    params = model.init_params(cfg, 0, "cpu")
    trace = serve_trace_for(cfg, [(p, d) for p, d in REQUESTS], slots=SLOTS,
                            layer_group=2)
    plan = runtime.plan(trace, runtime.H100_COST,
                        0.2 * trace.peak_kv_bytes(), lookaheads=(2,))
    plan = dataclasses.replace(plan, hot_window=MAX_SEQ // 2,
                               slot_hot_windows=[4, 8], page_tokens=PAGE,
                               prefill_chunk_tokens=PAGE)
    prompts = [torch.randint(0, cfg.vocab_size, (p,),
                             generator=torch.Generator().manual_seed(i))
               for i, (p, _) in enumerate(REQUESTS)]
    return cfg, params, plan, prompts


def _serve(cfg, params, plan, prompts, on_k1=None):
    """Every request through the pools, step by step; ``on_k1(b)`` runs
    after each step."""
    b = ContinuousBatcher(params, cfg, SLOTS, MAX_SEQ, plan=plan, paged=True,
                          device="cpu")
    for toks, (_, d) in zip(prompts, REQUESTS):
        b.submit(toks, d)
    outs = []
    while b.queue or b._jobs or any(b.active):
        assert b.step()
        if on_k1 is not None:
            on_k1(b)
        for i in range(b.B):
            if not b.active[i] and b.outputs[i]:
                outs.append(list(b.outputs[i]))
                b.outputs[i] = []
    return b, sorted(outs)


def _k1_cold_reads(tier, lengths, window, page):
    """What K1 reads from the cold pool: each slot's entries of tier other
    than 0 from the window's first page to its length's last page."""
    n = 0
    for row, length in zip(tier.tolist(), lengths.tolist()):
        lo = max(0, (length - window) // page) if window else 0
        n += sum(1 for t in row[lo:-(-length // page)] if t != 0)
    return n


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma2-2b"])
def test_cold_page_reads_count_what_k1_reads(arch, monkeypatch):
    cfg, params, plan, prompts = _engine_setup(arch)
    calls = []
    k1 = kernel_ops.paged_decode_attention

    def recording(q, k_hot, v_hot, k_cold, v_cold, page_table, page_tier,
                  lengths, *, window=0, softcap_val=0.0):
        active = list(engine[0].active) if engine else None
        calls.append((page_tier.clone(), lengths.clone(), window, active))
        return k1(q, k_hot, v_hot, k_cold, v_cold, page_table, page_tier,
                  lengths, window=window, softcap_val=softcap_val)

    monkeypatch.setattr(kernel_ops, "paged_decode_attention", recording)
    engine, seen = [], []

    def check(b):
        if not engine:
            engine.append(b)
        seen.extend(calls)
        calls.clear()
        want = sum(_k1_cold_reads(t, n, w, PAGE) for t, n, w, _ in seen)
        assert b.pool.stats["cold_page_reads"] == want

    _serve(cfg, params, plan, prompts, check)
    layers = sum(1 for l in range(cfg.num_layers)
                 if cfg.layer_kind(l) in ("attn", "local"))
    decode_steps = engine[0].decode_steps
    assert len(seen) == layers * decode_steps > 0
    # cold pages are read, and a slot K1 reads while it is not active
    # (stale length, refilled or finished) reads pages too
    assert any((t == 1).any() for t, _, _, _ in seen)
    stale = [(t[s], n[s], w) for t, n, w, act in seen if act is not None
             for s in range(SLOTS) if not act[s]]
    assert stale and any(_k1_cold_reads(t[None], n[None], w, PAGE)
                         for t, n, w in stale)
    if arch == "gemma2-2b":
        assert {w for _, _, w, _ in seen} == {0, cfg.sliding_window}


def test_engine_tokens_equal_with_recorder_on_and_off():
    cfg, params, plan, prompts = _engine_setup("smollm-360m")
    b_off, out_off = _serve(cfg, params, plan, prompts)
    assert telemetry.drain() == ([], {})
    telemetry.enable()
    b_on, out_on = _serve(cfg, params, plan, prompts)
    spans, _ = telemetry.drain()
    assert out_on == out_off and len(out_on) == len(REQUESTS)
    c_on, c_off = b_on.counters(), b_off.counters()
    assert c_on == c_off and c_on["cold_page_reads"] > 0
    names = {s.name for s in spans}
    assert names == {"engine.step", "engine.admit", "engine.prefill_chunk",
                     "engine.decode_forward", "engine.demote",
                     "engine.readback"}
    parent = {s.name: s.parent for s in spans}
    assert parent["engine.admit"] == parent["engine.decode_forward"] == \
        parent["engine.readback"] == "engine.step"
    assert parent["engine.prefill_chunk"] == "engine.admit"
    assert parent["engine.demote"] == "engine.step"
    chunks = [s for s in spans if s.name == "engine.prefill_chunk"]
    assert {s.key for s in chunks} == {0, 1}
    assert sum(s.name == "engine.step" for s in spans) == \
        len(b_on.step_prefill_tokens)


def test_planner_spans():
    telemetry.enable()
    cfg, _, _, _ = _engine_setup("smollm-360m")
    spans, _ = telemetry.drain()
    assert [s.name for s in spans] == ["plan.profile", "plan.place"]
    assert all(s.parent is None for s in spans)


# -------------------------------------------------------------- train --

def _train(steps=2):
    cfg = get_config("smollm-360m").reduced()
    ocfg = adamw.OptConfig(lr=1e-3, warmup_steps=1)
    state = loop.init_state(cfg, ocfg, seed=0, device="cpu")
    step = loop.make_train_step(cfg, SentinelConfig("offload", 1), ocfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    losses = []
    for k in range(steps):
        state, m = step(state, make_batch(dcfg, k, "cpu"))
        losses.append(float(m["loss"]))
    return losses, {n: p.detach().clone()
                    for n, p in state["params"].named_parameters()}


def test_train_step_equal_with_recorder_on_and_off():
    losses_off, params_off = _train()
    telemetry.enable()
    losses_on, params_on = _train()
    spans, _ = telemetry.drain()
    assert losses_on == losses_off
    assert all(torch.equal(params_on[n], params_off[n]) for n in params_off)
    names = [s.name for s in spans]
    assert names == ["train.forward", "train.backward", "train.adamw"] * 2
    assert all(s.parent is None for s in spans)
