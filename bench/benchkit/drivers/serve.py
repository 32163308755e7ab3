"""The serving cell: the port's ``ContinuousBatcher`` on the persistent page
pools (``paged=True`` with ``use_paged_decode``: hot pages on the card,
cold pages in pinned host memory, decode through kernel K1), planned by
``runtime.plan`` on ``H100_COST`` from ``serve_trace_for``'s profile of the
mix's sessions.

Every session is submitted and admitted during set-up (chunked pool
prefill), then a few decode steps warm up; the window is pure decode
through ``ContinuousBatcher.step``.

Once the window has closed and the engine is freed, the plain reference
runs over a sample of the sessions, drawn from the seed with the longest
prompt in it: each prompt with the tokens served until the window closed,
and the widest gap by which a served token's reference logit lies below
the reference's best (``compare.served_gap``)."""
from __future__ import annotations

import time

from benchkit import compare, flops, port, stats, traffic, weights
from benchkit.core import Run, free, peak_bytes, reset_peak, sync
from benchkit.trace import Spans, Tracer, warm_profiler

TRACE_SECONDS = 4.0      # the traced part of a --trace 1 window


class Book:
    """What the harness sees of the engine's sessions: which prompt (its
    host tuple) each slot serves, from the admission's finish, which it
    wraps on the instance."""

    def __init__(self, b, cfg):
        self.b, self.cfg = b, cfg
        self.slot_req = {}
        finish = b._finish_job

        def finished(slot, job):
            finish(slot, job)
            self.slot_req[slot] = job.tok_host

        b._finish_job = finished

    def slot_lengths(self):
        """(context tokens after this step's write, cold tokens) of each
        active slot, from the engine's host lengths and the page table."""
        b, page = self.b, self.b.page_tokens
        return [(b._host_len[s] + 1, b.ptable.cold_pages(s) * page)
                for s in range(b.B) if b.active[s]]


def _plan(pc, mix, params, requests, spans):
    """The engine's plan from a profile of ``requests`` (their decode cut
    to the mix's ``profile_decode_steps``: Sentinel profiles the first
    steps and takes them to repeat), one trace object a page of every
    layer, the look-aheads the mix names."""
    from repro_torch import runtime
    from repro_torch.serve.engine import serve_trace_for
    with spans.record("plan"):
        horizon = mix.get("profile_decode_steps")
        tr = serve_trace_for(pc, [(len(t), min(a, horizon or a))
                                  for t, a in requests],
                             slots=mix["slots"],
                             block_tokens=mix["page_tokens"],
                             layer_group=mix["layer_group"], params=params)
        plan = runtime.plan(tr, runtime.H100_COST,
                            mix["budget_frac"] * tr.peak_kv_bytes(),
                            objective=mix["objective"],
                            prefill_chunk_tokens=mix["prefill_chunk_tokens"],
                            lookaheads=tuple(mix["lookaheads"]))
    return plan, {"peak_kv_bytes": tr.peak_kv_bytes(),
                  "hot_window": plan.hot_window,
                  "slot_hot_windows": list(plan.slot_hot_windows or []),
                  "page_tokens": plan.page_tokens}


def _step(b, book, spans, counters, tracing, name="decode_step"):
    """One engine step; counts the tokens it emitted and, while traced, the
    pages its decode read."""
    before = sum(len(o) for o in b.outputs)
    lengths = book.slot_lengths() if b.active and any(b.active) else []
    if tracing and lengths:
        page_kv = flops.kv_bytes_per_token(book.cfg)
        L = book.cfg["num_hidden_layers"]
        counters["cold_bytes"] += sum(c for _, c in lengths) * page_kv * L
        counters["counted_decode_steps"] += 1
        counters["k1_bound_s_traced"] += L * flops.paged_decode_bound_s(
            book.cfg, [n - c for n, c in lengths], [c for _, c in lengths])
    d0 = b.decode_steps
    with spans.record(name):
        b.step()
    if b.decode_steps > d0:
        counters["model_flops"] += flops.decode_step_flops(
            book.cfg, [n for n, _ in lengths])
    return sum(len(o) for o in b.outputs) - before


def run(cfg, mix, limits, seed, seconds, trace, device, t_start):
    import torch
    from repro_torch.serve.engine import ContinuousBatcher

    spans = Spans()
    pc = port.config(cfg, use_paged_decode=True)
    w = weights.make(cfg, seed, device)
    params = port.model(cfg, pc, w, device, train=False)
    del w
    sessions = traffic.sessions(mix, cfg, seed)
    plan, notes = _plan(pc, mix, params, sessions, spans)
    free(device)
    reset_peak(device)
    b = ContinuousBatcher(params, pc, mix["slots"], mix["max_seq"], plan=plan,
                          paged=True,
                          prefill_chunk_tokens=mix["prefill_chunk_tokens"],
                          device=device)
    book = Book(b, cfg)
    counters = {"cold_bytes": 0, "counted_decode_steps": 0,
                "k1_bound_s_traced": 0.0, "model_flops": 0.0}
    reqs = {}                    # prompt tuple -> record

    # ---- set-up: admit, warm up -----------------------------------------
    for tokens, budget in sessions:
        reqs[tuple(int(x) for x in tokens)] = {"prompt": tokens,
                                               "served": None}
        b.submit(torch.from_numpy(tokens), budget)
    while b.queue or b._jobs:
        _step(b, book, spans, counters, False, "setup_step")
    for _ in range(mix["warm_decode_steps"]):
        _step(b, book, spans, counters, False, "setup_step")
    if trace:
        with warm_profiler():
            _step(b, book, spans, counters, False, "setup_step")
    sync(device)
    setup_s = time.perf_counter() - t_start
    for k in counters:
        counters[k] = 0

    # ---- window -----------------------------------------------------------
    tracer = Tracer(device) if trace else None
    emitted, steps, at_stop = 0, 0, 0.0
    t0 = time.perf_counter()
    with spans.record("window"):
        while True:
            traced = tracer is not None and tracer.tracing
            emitted += _step(b, book, spans, counters, traced,
                             "traced_step" if traced else "decode_step")
            steps += 1
            now = time.perf_counter()
            if traced and now - t0 >= TRACE_SECONDS:
                tracer.stop(steps)
                at_stop = counters["model_flops"]
            if now - t0 >= seconds:
                break
    t1 = time.perf_counter()
    if tracer is not None:
        tracer.stop(steps)
    run = Run(spans=spans, notes=notes, window_s=t1 - t0)
    run.peak_bytes = peak_bytes(device)
    # host-clock readings: the steps after the traced part (all of them
    # without a trace, or where the trace took the whole window)
    untraced = tracer is not None and tracer.steps < steps
    counters["host_flops"] = counters["model_flops"] - (at_stop if untraced
                                                        else 0.0)
    counters["host_s"] = t1 - (tracer.stopped if untraced else t0)
    counters["traced_steps"] = tracer.steps if tracer else 0
    counters["steps"] = steps
    counters["emitted"] = emitted
    run.e2e = {"decode_tokens_per_s": stats.rate(emitted, run.window_s),
               "peak_device_gib": run.peak_bytes / 2 ** 30,
               "setup_s": setup_s}
    # a session's answer is what it has served when the window closes
    for s in range(b.B):
        if s in book.slot_req:
            reqs[book.slot_req[s]]["served"] = list(b.outputs[s])
    answers = list(reqs.values())
    run.attempted = len(answers)
    run.counters = counters
    del b, book, params
    free(device)
    if tracer is not None:
        run.trace = tracer.summary(spans)
    run.failed = sum(1 for r in answers if not r["served"])
    sample = choose(answers, mix["sample"]["sessions"], seed)
    run.notes["sampled"] = [(len(r["prompt"]), len(r["served"]))
                            for r in sample]
    run.sample = sample
    gap = reference_gap(cfg, sample, seed, device)
    run.checks = [("served_logit_gap", gap, limits["served_logit_gap"])]
    return run


def choose(records, n: int, seed: int) -> list:
    """The sample of ``records`` the reference judges: the one with the
    longest prompt, and the rest drawn from the seed."""
    done = [r for r in records if r["served"]]
    if len(done) <= n:
        return done
    longest = max(range(len(done)), key=lambda i: len(done[i]["prompt"]))
    others = [i for i in range(len(done)) if i != longest]
    pick = traffic.rng(seed, 4).choice(len(others), n - 1, replace=False)
    return [done[longest]] + [done[others[i]] for i in sorted(pick)]


def reference_logits(cfg, record, w, prec="fp32"):
    """The reference's logits at the rows that produced ``record``'s served
    tokens: the prompt's last row, then each served token but the last."""
    import torch
    from benchkit.registry import reference
    ref = reference(cfg["reference"])
    prompt, out = record["prompt"], record["served"]
    dev = w["embed"].device
    toks = torch.as_tensor(list(prompt) + out[:-1], device=dev)
    rows = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out),
                        device=dev)
    with torch.no_grad(), ref.exact_fp32():
        return ref.logits(w, cfg, toks, rows, prec)


def reference_gap(cfg, sample, seed, device, prec=None) -> float:
    """The widest gap over ``sample``'s served tokens.  With ``prec`` (the
    control): the tokens that the reference in that precision puts first at
    the same rows, judged under the float32 reference."""
    import torch
    if not sample:
        return float("nan")
    w = weights.as_fp32(weights.make(cfg, seed, device))
    gap = 0.0
    for r in sample:
        lg = reference_logits(cfg, r, w)
        if prec is None:
            tok = torch.as_tensor(r["served"], device=lg.device)
        else:
            tok = reference_logits(cfg, r, w, prec).argmax(-1)
        gap = max(gap, compare.served_gap(lg, tok))
        del lg
    del w
    free(device)
    return gap
