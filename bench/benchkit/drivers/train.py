"""The training cells: the port's train step (``train/loop.make_train_step``)
with AdamW, in the Sentinel mode the mix names.

Set-up builds one step object with its model and optimizer state, drives it
from the seed through its first three steps (reading each step's loss, the
first moment after step 1 and the parameters after step 3), and hands the
same object to the window.  The window runs steps 4, 5, ... for the
window's seconds, each on a new batch drawn on the host and handed over,
each ending in a synchronise.  Once the window has closed and the
program's state is freed, the plain reference runs the same three steps in
float32 from the same weights and batches, and ``compare.train_checks``
judges the three readings."""
from __future__ import annotations

import time
from contextlib import nullcontext

from benchkit import compare, flops, port, stats, traffic, weights
from benchkit.core import Run, free, peak_bytes, reset_peak, sync
from benchkit.trace import Spans, Tracer, warm_profiler

TRACE_SECONDS = 4.0      # the traced part of a --trace 1 window


def _batch(mix, cfg, seed, step, device):
    import torch
    return {k: torch.from_numpy(v).to(device)
            for k, v in traffic.train_batch(mix, cfg, seed, step).items()}


def plan_config(pc, mix, spans):
    """The Sentinel config of the mix's mode; for offload the MI that
    ``runtime.plan`` picks on ``H100_COST`` from the step's profile, at
    ``fast_frac`` of its peak."""
    from repro_torch import runtime
    from repro_torch.core.offload import SentinelConfig, from_plan
    if mix["mode"] != "offload":
        return SentinelConfig(mode=mix["mode"]), {}
    from repro_torch.launch.train import profile_step
    with spans.record("plan"):
        prof = profile_step(pc, mix["batch"], mix["seq"])
        plan = runtime.plan(prof, runtime.H100_COST,
                            mix["fast_frac"] * prof.peak_bytes())
        scfg = from_plan(prof, plan)
    return scfg, {"planned_mi": plan.mi, "mi_periods": scfg.mi_periods,
                  "profile_peak_bytes": prof.peak_bytes()}


def program_readings(cfg, mix, seed, device, t_start, seconds, trace,
                     break_step=None):
    """Set-up, the first three steps' readings and the window.  Returns
    (Run without checks, readings).  ``break_step(step)`` wraps the step
    (the tests plant faults with it)."""
    import torch
    from repro_torch.core import offload
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    spans = Spans()
    pc = port.config(cfg)
    w = weights.make(cfg, seed, device)
    params = port.model(cfg, pc, w, device, train=True)
    del w
    scfg, notes = plan_config(pc, mix, spans)
    ocfg = adamw.OptConfig(**mix["optimizer"])
    free(device)
    reset_peak(device)
    state = {"params": params, "opt": adamw.init(params, ocfg),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    step = loop.make_train_step(pc, scfg, ocfg)
    if break_step is not None:
        step = break_step(step)
    names = weights.port_names(cfg)
    b1 = ocfg.b1
    read = {"losses": []}
    for k in (1, 2, 3):
        warm = warm_profiler() if trace and k == 3 else nullcontext()
        with warm, spans.record("setup_step"):
            state, m = step(state, _batch(mix, cfg, seed, k, device))
            read["losses"].append(float(m["loss"]))
        if k == 1:
            read["grad"] = {names[n]: float(t.norm()) / (1 - b1)
                            for n, t in state["opt"]["m"].items()}
        if k == 3:
            w0 = weights.make(cfg, seed, device)
            read["change"] = {
                names[n]: float((p.detach().float()
                                 - _padded(w0[names[n]], p)).norm())
                for n, p in state["params"].named_parameters()}
            del w0
    sync(device)
    setup_s = time.perf_counter() - t_start

    B, S = mix["batch"], mix["seq"]
    run = Run(spans=spans, notes=notes)
    offload.reset_traffic()
    tracer = Tracer(device) if trace else None
    n = 0
    t0 = time.perf_counter()
    with spans.record("window"):
        while True:
            traced = tracer is not None and tracer.tracing
            with spans.record("traced_step" if traced else "train_step"):
                state, m = step(state, _batch(mix, cfg, seed, 4 + n, device))
                loss = float(m["loss"])
                sync(device)
            n += 1
            now = time.perf_counter() - t0
            if traced and now >= TRACE_SECONDS:
                tracer.stop(n)
            if now >= seconds:
                break
    t1 = time.perf_counter()
    if tracer is not None:
        tracer.stop(n)
    # host-clock readings: the steps after the traced part (all of them
    # without a trace, or where the trace took the whole window)
    host_n = n - tracer.steps if tracer and tracer.steps < n else n
    host_s = t1 - tracer.stopped if tracer and tracer.steps < n else t1 - t0
    run.window_s = t1 - t0
    run.peak_bytes = peak_bytes(device)
    run.attempted, run.failed = n, 0 if loss == loss else 1
    moved = dict(offload.traffic)
    run.counters = {"steps": n, "tokens": n * B * S,
                    "model_flops": n * flops.train_step_flops(cfg, B, S),
                    "offload_bytes": moved["d2h"] + moved["h2d"],
                    "traced_steps": tracer.steps if tracer else 0,
                    "host_flops": host_n * flops.train_step_flops(cfg, B, S),
                    "host_s": host_s}
    run.e2e = {f"train_tokens_per_s.{mix['mode']}":
               stats.rate(n * B * S, run.window_s),
               "peak_device_gib": run.peak_bytes / 2 ** 30,
               "setup_s": setup_s}
    del state, step, params, m
    free(device)
    if tracer is not None:
        run.trace = tracer.summary(spans)
    return run, read


def _padded(w, p):
    """The benchmark's weight ``w`` in the shape of the program's leaf
    ``p`` (zero rows past a padded vocabulary)."""
    import torch
    if w.shape == p.shape:
        return w.float()
    out = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    out[:w.shape[0]] = w.float()
    return out


def reference_readings(cfg, mix, seed, device, prec="fp32", rows=None):
    """The plain reference's three steps from the same weights and
    batches; ``prec="fp8"`` is the control, ``rows`` a planted fault (the
    batch rows that count)."""
    from benchkit.registry import reference
    ref = reference(cfg["reference"])
    with ref.exact_fp32():
        w = weights.as_fp32(weights.make(cfg, seed, device))
        w0 = {k: t.clone() for k, t in w.items()}
        state, out = {}, {"losses": []}
        for k in (1, 2, 3):
            b = {key: v for key, v in
                 _batch(mix, cfg, seed, k, device).items()}
            loss, grads = ref.loss_and_grads(w, cfg, b, prec, rows)
            clipped = ref.adamw(w, grads, state, mix["optimizer"])
            out["losses"].append(loss)
            if k == 1:
                out["grad"] = compare.leaf_norms(clipped)
                out["raw_grad"] = compare.leaf_norms(grads)
            del grads, clipped
        out["change"] = {k: float((w[k] - w0[k]).norm()) for k in w}
    del w, w0, state
    free(device)
    return out


def run(cfg, mix, limits, seed, seconds, trace, device, t_start):
    run, prog = program_readings(cfg, mix, seed, device, t_start, seconds,
                                 trace)
    if prog["losses"] and all(x == x for x in prog["losses"]):
        ref = reference_readings(cfg, mix, seed, device)
        run.checks = compare.train_checks(prog, ref, limits)
        run.notes["loss_gap"] = compare.loss_gap(prog, ref)
        run.notes["losses"] = {"program": prog["losses"],
                               "reference": ref["losses"]}
    else:
        run.checks = [("grad_gap", float("nan"), limits["grad_gap"])]
    return run
