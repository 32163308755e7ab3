"""Deterministic synthetic workloads for both planner halves.

No RNG, no tracing: the same arguments always resolve to byte-identical
traces, which is what the golden-plan JSON tests and the unified benchmark
smoke (benchmarks/bench_runtime.py) depend on.

``synthetic_profile`` hand-builds a training ``TraceProfile`` with the
paper's object population (a majority of short-lived activations in the
reserve pool, long-lived residuals bridging forward->backward, weights read
in both passes and streamed by the optimizer).  ``synthetic_serve_trace``
resolves a deterministic request stream through the real serve-trace function.
"""
from __future__ import annotations

from repro_torch.core.profiler import (DataObject, LayerStats, TraceProfile,
                                       timeline_steps)


def synthetic_profile(num_periods: int = 4, unit: int = 1 << 20,
                      res_per_period: int = 3) -> TraceProfile:
    """A training profile with the paper's §3 object structure.

    Per forward period: ``res_per_period`` long-lived residuals (born in the
    forward step, re-read in the matching backward step — the migration
    candidates), a pile of short-lived temporaries (the reserve pool), and a
    weight block read in forward + backward and streamed at the optimizer
    boundary.  ``unit`` scales every byte count.
    """
    P = num_periods
    steps = timeline_steps(P)                 # 2P + 3
    prof = TraceProfile(num_periods=P, num_steps=steps)
    uid = 0

    def add(size, birth, death, kind, accesses):
        nonlocal uid
        o = DataObject(uid, int(size), birth, death, len(accesses), kind,
                       accesses=sorted(accesses))
        prof.objects.append(o)
        uid += 1
        return o

    opt = steps - 1
    for p in range(P):
        fwd, bwd = p + 1, 2 * P + 1 - p
        # weights: read in forward and backward, streamed by the optimizer
        add(4 * unit, 0, opt, "weight", [fwd, bwd, opt])
        # long-lived residuals: forward -> backward reuse (offload targets)
        for r in range(res_per_period):
            add(2 * unit, fwd, bwd, "activation", [fwd, bwd])
        # short-lived temporaries: born and consumed within the step
        for r in range(6):
            add(unit, fwd, fwd, "activation", [fwd])
            add(unit, bwd, bwd, "activation", [bwd])
    # head/loss boundary activation
    add(unit, P + 1, P + 1, "activation", [P + 1])

    for s in range(steps):
        touched = sum(o.size for o in prof.objects if s in o.accesses)
        flops = 40.0 * touched                # mildly compute-bound roofline
        prof.layers[s] = LayerStats(s, flops=flops,
                                    bytes_accessed=float(touched) + unit)
        prof.total_flops += flops
    for o in prof.objects:
        if o.kind != "activation":
            continue
        ls = prof.layers[max(o.birth, 0)]
        if o.lifetime <= 1:
            ls.produced_short += o.size
        else:
            ls.produced_long += o.size
            prof.layers[max(o.death, 0)].reads_long += o.size
    return prof


def synthetic_serve_trace(num_requests: int = 12, num_slots: int = 4,
                          num_layers: int = 8, kv_token_bytes: float = 4096,
                          weight_bytes: float = 50e6,
                          flops_per_token: float = 2e9):
    """The serving fixture trace: a deterministic mixed request stream
    resolved into per-slot per-layer KV-block objects."""
    from repro_torch.core.hmsim import build_serve_trace, synthetic_requests
    reqs = synthetic_requests(num_requests)
    return build_serve_trace(reqs, num_slots=num_slots, num_layers=num_layers,
                             kv_token_bytes=kv_token_bytes,
                             weight_bytes=weight_bytes,
                             flops_per_token=flops_per_token)


def synthetic_shared_prefix_trace(num_tenants: int = 12, num_slots: int = 4,
                                  system_tokens: int = 64,
                                  user_tokens: int = 32,
                                  decode_tokens: int = 40,
                                  num_layers: int = 8,
                                  kv_token_bytes: float = 4096,
                                  weight_bytes: float = 50e6,
                                  flops_per_token: float = 2e9,
                                  shared: bool = True):
    """N tenants x one common system prompt — the multi-tenant serving
    workload for prefix sharing on the unified surface.

    Every request carries the same ``system_tokens``-token system prompt
    followed by a per-tenant user turn (deterministic jitter, no RNG).  With
    ``shared=True`` the system-prompt KV blocks are tagged as one physical
    allocation (``KVObject.shared_key``); ``shared=False`` builds the
    byte-for-byte identical stream *without* sharing — the matched baseline
    the --shared-prefix benchmark gate compares against."""
    from repro_torch.core.hmsim import build_serve_trace
    reqs = []
    for i in range(num_tenants):
        p = system_tokens + user_tokens + (i * 17) % 33
        d = decode_tokens + (i * 11) % 17
        reqs.append((p, d, 0 if shared else i))
    return build_serve_trace(reqs, num_slots=num_slots, num_layers=num_layers,
                             kv_token_bytes=kv_token_bytes,
                             weight_bytes=weight_bytes,
                             flops_per_token=flops_per_token,
                             shared_prefix_tokens=system_tokens
                             if shared else 0)


def synthetic_multi_tenant_trace(chatty_requests: int = 10,
                                 bursty_requests: int = 4,
                                 slots_per_tenant: int = 2,
                                 chatty_quota: float = 0.45,
                                 bursty_quota: float = 0.55,
                                 system_tokens: int = 0,
                                 num_layers: int = 8,
                                 kv_token_bytes: float = 4096,
                                 weight_bytes: float = 50e6,
                                 flops_per_token: float = 2e9):
    """The adversarial multi-tenant serving mix: two tenants with opposite
    shapes competing for one fast tier, as a ``MultiTenantWorkload``.

      chatty   many small-context conversational turns (short prompts, short
               decodes) under a tight decode-latency SLO — its working set
               is far below its guaranteed share, but every block of it is
               latency-critical.
      bursty   few long-context requests (analytics-style prompts, long
               decodes) under a loose SLO — its KV floods any capacity-
               limited fast tier, which is exactly what starves the chatty
               tenant under tenant-blind placement.

    At 20% fast memory a quota-blind lifetime policy packs fast memory with
    the bursty tenant's high-reuse blocks past its share and serves part of
    the chatty tenant's entitled reads from slow memory (quota violations);
    ``sentinel_slo`` keeps the guarantee and degrades the bursty tenant
    instead.  ``system_tokens > 0`` additionally gives every request of both
    tenants one shared system prompt (``prefix_id`` 0 — one physical
    allocation platform-wide).  Deterministic: no RNG anywhere.
    """
    from repro_torch.core.hmsim import build_serve_trace
    from repro_torch.runtime.objects import MultiTenantWorkload, Tenant
    geometry = dict(num_slots=slots_per_tenant, num_layers=num_layers,
                    kv_token_bytes=kv_token_bytes, weight_bytes=weight_bytes,
                    flops_per_token=flops_per_token,
                    shared_prefix_tokens=system_tokens)
    chatty_reqs = [(system_tokens + 16 + (i * 7) % 13,
                    12 + (i * 5) % 9, 0)
                   for i in range(chatty_requests)]
    bursty_reqs = [(system_tokens + 224 + (i * 31) % 49,
                    40 + (i * 13) % 17, 0)
                   for i in range(bursty_requests)]
    tenants = [Tenant("chatty", fast_quota_frac=chatty_quota,
                      slo_slack=1.05, arrival=0),
               Tenant("bursty", fast_quota_frac=bursty_quota,
                      slo_slack=2.0, arrival=4)]
    traces = [build_serve_trace(chatty_reqs, **geometry),
              build_serve_trace(bursty_reqs, **geometry)]
    # prefix_id 0 is the platform-wide system prompt: the one key that is
    # genuinely shared across tenants (everything else stays namespaced)
    return MultiTenantWorkload(tenants, traces, shared_prefix_ids=(0,))


# --------------------------------------------------- drifting traffic --
# Piecewise-stationary workloads for the online re-planner
# (runtime/online.py): each is a sequence of stationary segments over one
# slot/KV geometry, with a distribution shift at every boundary.  Like
# everything else here they are RNG-free, so the golden re-plan trace and
# the clairvoyant-regret gates are byte-stable.

def synthetic_drift_tenant_flip(num_layers: int = 8,
                                kv_token_bytes: float = 4096):
    """Diurnal tenant-mix flip: chatty-dominated -> bursty-dominated ->
    chatty again.  The aggregate slot occupancy barely moves; what drifts is
    *which tenant* the read traffic belongs to — the mix signal the
    re-planner's per-tenant window shares exist to catch."""
    from repro_torch.runtime.online import DriftSegment, DriftWorkload
    mk = lambda c, b: synthetic_multi_tenant_trace(
        chatty_requests=c, bursty_requests=b, num_layers=num_layers,
        kv_token_bytes=kv_token_bytes)
    return DriftWorkload("tenant_flip", (
        DriftSegment("chatty_heavy", mk(12, 2)),
        DriftSegment("bursty_heavy", mk(2, 8)),
        DriftSegment("chatty_back", mk(10, 2))))


def synthetic_drift_prompt_shift(num_slots: int = 4, num_layers: int = 8,
                                 kv_token_bytes: float = 4096,
                                 weight_bytes: float = 50e6,
                                 flops_per_token: float = 2e9):
    """Prompt-length shift: short conversational prompts -> long analytics
    prompts -> short again.  Per-step KV read volume grows ~5x in the middle
    segment, so the hot windows planned on short contexts starve."""
    from repro_torch.core.hmsim import build_serve_trace
    from repro_torch.runtime.online import DriftSegment, DriftWorkload
    geometry = dict(num_slots=num_slots, num_layers=num_layers,
                    kv_token_bytes=kv_token_bytes, weight_bytes=weight_bytes,
                    flops_per_token=flops_per_token)

    def seg(prompt):
        reqs = [(prompt + (i * 7) % 13, 40 + (i * 5) % 9)
                for i in range(2 * num_slots)]
        return build_serve_trace(reqs, **geometry)

    return DriftWorkload("prompt_shift", (
        DriftSegment("short_prompts", seg(64)),
        DriftSegment("long_prompts", seg(320)),
        DriftSegment("short_again", seg(64))))


def synthetic_drift_flash_crowd(slots_per_tenant: int = 2,
                                num_layers: int = 8,
                                kv_token_bytes: float = 4096,
                                weight_bytes: float = 50e6,
                                flops_per_token: float = 2e9):
    """Flash crowd: a tenant that is near-silent in the calm segments floods
    the system in the middle one.  While it sleeps its batch slots sit idle
    — the elastic-lending case: the replanner lends them to the busy tenant
    and reclaims them when the crowd arrives."""
    from repro_torch.core.hmsim import build_serve_trace
    from repro_torch.runtime.objects import MultiTenantWorkload, Tenant
    from repro_torch.runtime.online import DriftSegment, DriftWorkload
    geometry = dict(num_slots=slots_per_tenant, num_layers=num_layers,
                    kv_token_bytes=kv_token_bytes, weight_bytes=weight_bytes,
                    flops_per_token=flops_per_token)
    tenants = lambda: [Tenant("steady", fast_quota_frac=0.5,
                              slo_slack=1.1, arrival=0),
                       Tenant("crowd", fast_quota_frac=0.5,
                              slo_slack=2.0, arrival=0)]

    def calm(n_steady):
        steady = [(96 + (i * 7) % 13, 16 + (i * 5) % 9, 0)
                  for i in range(n_steady)]
        crowd = [(32, 6, 0)]                 # one straggler, then silence
        return MultiTenantWorkload(tenants(), [
            build_serve_trace(steady, **geometry),
            build_serve_trace(crowd, **geometry)])

    def surge():
        steady = [(96 + (i * 7) % 13, 16 + (i * 5) % 9, 0)
                  for i in range(4)]
        crowd = [(160 + (i * 31) % 29, 24 + (i * 13) % 11, 0)
                 for i in range(12)]
        return MultiTenantWorkload(tenants(), [
            build_serve_trace(steady, **geometry),
            build_serve_trace(crowd, **geometry)])

    return DriftWorkload("flash_crowd", (
        DriftSegment("calm", calm(8)),
        DriftSegment("surge", surge()),
        DriftSegment("calm_again", calm(8))))


def synthetic_disagg_trace(num_slots: int = 4, num_layers: int = 8,
                           kv_token_bytes: float = 4096,
                           weight_bytes: float = 50e6,
                           flops_per_token: float = 2e9):
    """Prefill/decode phase drift: decode-steady traffic interrupted by a
    prefill-heavy burst, then steady again.

    The burst segment is the regime prefill/decode disaggregation exists
    for (``serve/disagg.py``): long analytics prompts with short answers,
    so admission compute (the per-step ``extra_*`` channels) dominates and
    a colocated engine serializes a prompt's worth of prefill into every
    decode step.  The steady segments are the opposite shape — short
    conversational prompts, long decodes — where the planned hot windows
    are all that matters.  Replayed by ``bench_runtime --drift`` and the
    ``OnlineReplanner`` differential suite like any other drift workload:
    the re-planner must catch the phase flip in both directions."""
    from repro_torch.core.hmsim import build_serve_trace
    from repro_torch.runtime.online import DriftSegment, DriftWorkload
    geometry = dict(num_slots=num_slots, num_layers=num_layers,
                    kv_token_bytes=kv_token_bytes, weight_bytes=weight_bytes,
                    flops_per_token=flops_per_token)

    def seg(prompt, decode, n):
        reqs = [(prompt + (i * 7) % 13, decode + (i * 5) % 9)
                for i in range(n)]
        return build_serve_trace(reqs, **geometry)

    return DriftWorkload("disagg_phases", (
        DriftSegment("decode_steady", seg(48, 64, 2 * num_slots)),
        DriftSegment("prefill_burst", seg(384, 12, 3 * num_slots)),
        DriftSegment("decode_again", seg(48, 64, 2 * num_slots))))


def synthetic_prefill_burst(num_slots: int = 4, num_layers: int = 8,
                            kv_token_bytes: float = 4096,
                            weight_bytes: float = 50e6,
                            flops_per_token: float = 2e9):
    """Chunked-prefill drift: decode-steady traffic hit by a flash crowd of
    long *shared-prefix* prompts, then steady again.

    The burst is the regime the cache-aware prefill scheduler exists for:
    every crowd request carries the same prefix_id over a long common
    prefix, so the engine skips the shared rows' compute (the trace's
    ``prefill_skip_tokens`` / the timeline's net ``extra_flops`` +
    ``prefill_read_bytes``) while the chunker keeps decode stepping through
    the admissions.  Distinct from ``disagg_phases``: there the burst is
    unshared and whole-prompt, here the re-planner must track a burst whose
    *priced* prefill cost is far below its token count — mis-modeling the
    skip shows up directly as clairvoyant regret in ``bench_runtime
    --drift``."""
    from repro_torch.core.hmsim import build_serve_trace
    from repro_torch.runtime.online import DriftSegment, DriftWorkload
    geometry = dict(num_slots=num_slots, num_layers=num_layers,
                    kv_token_bytes=kv_token_bytes, weight_bytes=weight_bytes,
                    flops_per_token=flops_per_token,
                    shared_prefix_tokens=256)

    def steady(n):
        reqs = [(48 + (i * 7) % 13, 56 + (i * 5) % 9) for i in range(n)]
        return build_serve_trace(reqs, **geometry)

    def burst(n):
        # one shared 256-token system prefix + a private tail per request
        reqs = [(512 + (i * 11) % 23, 24 + (i * 3) % 7, 0)
                for i in range(n)]
        return build_serve_trace(reqs, **geometry)

    return DriftWorkload("prefill_burst", (
        DriftSegment("decode_steady", steady(2 * num_slots)),
        DriftSegment("shared_burst", burst(4 * num_slots)),
        DriftSegment("decode_again", steady(2 * num_slots))))


def drift_workloads() -> dict:
    """The canonical piecewise-stationary set the differential suite and
    ``bench_runtime --drift`` replay."""
    return {w.name: w for w in (synthetic_drift_tenant_flip(),
                                synthetic_drift_prompt_shift(),
                                synthetic_drift_flash_crowd(),
                                synthetic_disagg_trace(),
                                synthetic_prefill_burst())}
