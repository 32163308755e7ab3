#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (name and power limit, as nvidia-smi gives them) and the
     build of every CUDA kernel from the sources in this checkout;
  2. every kernel against its plain PyTorch version on the card, over the
     reference's shape sweep, window/softcap cases and the full-width shape,
     with hot pages on the card, cold pages in pinned host memory and
     unmapped (FREE) table entries;
  3. serving smollm-360m at full width (bf16, random weights from seed 0)
     through the paged-pool ContinuousBatcher: tiered hot windows against
     an all-hot run (tokens must be identical), the kernel's launch count
     against decode steps x layers, and a small fp32 run on the card
     against the same run on the CPU (plain path);
  4. timings: decode tokens/s and step time, each kernel's time beside its
     bound, its plain version's time and one PyTorch library call's, and a
     profile of a few decode steps (device-busy share, top device ops).

Then one JSON line with the kernels' record, the card line again, and the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises, so
the exit code is non-zero; without a card the script exits with 2 and
prints no result.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOP_PER_S = 67e12          # H100 SXM float32 outside tensor cores
MAX_SEQ, SLOTS, PAGE, DECODE = 1024, 8, 16, 32
SWEEP = [(2, 64, 4, 2, 16, 8), (3, 128, 8, 4, 32, 16), (1, 32, 2, 1, 128, 8),
         (2, 96, 6, 2, 64, 16)]
WINDOW_SOFTCAP = [(0, 0.0), (24, 0.0), (0, 30.0), (16, 50.0)]
FULL_WIDTH = (SLOTS, MAX_SEQ, 15, 5, 64, PAGE)   # B, S, H, KVH, D, page


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- kernels ----

def k1_case(shape, dtype, seed, *, lengths=None, free_row=False):
    """Inputs for the paged decode kernel: dense caches packed into pools
    with the first half of each slot's tokens cold (pinned host memory),
    table entries past each slot's length FREE (-1), and optionally a last
    slot that is wholly unmapped, as an inactive engine slot is."""
    import torch
    from repro_torch.kernels.ref import pack_kv_pools
    B, S, H, KVH, D, page = shape
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, D, generator=g).to(dtype)
    kd = torch.randn(B, S, KVH, D, generator=g).to(dtype)
    vd = torch.randn(B, S, KVH, D, generator=g).to(dtype)
    if lengths is None:
        lengths = [S - 1 - (5 * b) % (S // 2) for b in range(B)]
    cold = [int(n * 0.5) for n in lengths]
    kh, vh, kc, vc, tab, tier = pack_kv_pools(kd, vd, cold, page)
    for b, n in enumerate(lengths):
        used = 0 if (free_row and b == B - 1) else -(-n // page)
        tab[b, used:] = -1
        tier[b, used:] = -1
    dev = "cuda"
    return {"q": q.to(dev), "k_hot": kh.to(dev), "v_hot": vh.to(dev),
            "k_cold": kc.pin_memory(), "v_cold": vc.pin_memory(),
            "page_table": tab.to(dev), "page_tier": tier.to(dev),
            "lengths": torch.tensor(lengths, dtype=torch.int32, device=dev),
            "dense": (kd.to(dev), vd.to(dev)), "shape": shape}


def k1_args(c, cold_on_device=False):
    kc, vc = c["k_cold"], c["v_cold"]
    if cold_on_device:
        kc, vc = kc.to("cuda"), vc.to("cuda")
    return (c["q"], c["k_hot"], c["v_hot"], kc, vc, c["page_table"],
            c["page_tier"], c["lengths"])


def check_kernels():
    """Phase 2: the kernel against its plain version on the card.  Returns
    the full-width bf16 case and its max abs error."""
    import torch
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False     # plain version in fp32
    cases = [(s, dt, 0, 0.0) for s in SWEEP
             for dt in (torch.float32, torch.bfloat16)]
    cases += [((2, 96, 4, 2, 32, 16), torch.float32, w, cap)
              for w, cap in WINDOW_SOFTCAP]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (shape, dt, window, cap) in enumerate(cases):
        c = k1_case(shape, dt, seed=i)
        out = pd.paged_decode_attention(*k1_args(c), window=window,
                                        softcap_val=cap)
        want = ref.paged_decode_attention_ref(*k1_args(c, True),
                                              window=window, softcap_val=cap)
        torch.cuda.synchronize()
        err = _assert_k1_close(out, want, f"{shape} {dt} w{window} cap{cap}")
        worst[dt] = max(worst[dt], err)
    # the main path's shape, lengths 100-1000 and a wholly unmapped slot, in
    # both dtypes: f32 holds the kernel's arithmetic to the plain version's,
    # bf16 its loads and its rounding of the output
    lengths = [int(n) for n in np.random.default_rng(1).integers(
        100, 1000, SLOTS)]
    full = {}
    for dt in (torch.float32, torch.bfloat16):
        c = k1_case(FULL_WIDTH, dt, seed=99, free_row=True, lengths=lengths)
        out = pd.paged_decode_attention(*k1_args(c))
        want = ref.paged_decode_attention_ref(*k1_args(c, True))
        torch.cuda.synchronize()
        full[dt] = (c, _assert_k1_close(out, want,
                                        f"full width {FULL_WIDTH} {dt}"))
    print(f"k1 check: {len(cases) + 2} cases match the plain version; "
          f"max_abs_err f32 {worst[torch.float32]:.3e} (sweep) "
          f"{full[torch.float32][1]:.3e} (full width) within "
          f"{_tol_text(torch.float32)}; bf16 {worst[torch.bfloat16]:.3e} "
          f"(sweep) {full[torch.bfloat16][1]:.3e} (full width) within "
          f"{_tol_text(torch.bfloat16)}", flush=True)
    return full[torch.bfloat16]


def _tol(dtype):
    """f32: the same math summed in another order.  bf16: the output's
    rounding may differ by one bf16 ulp, at most 2**-7 of the value, so
    rtol 8e-3 at the output's own scale (atol for values near zero)."""
    import torch
    return dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 \
        else dict(atol=2e-3, rtol=8e-3)


def _tol_text(dtype) -> str:
    t = _tol(dtype)
    return f"atol {t['atol']:g} + rtol {t['rtol']:g}"


def _assert_k1_close(out, want, what):
    import torch
    if out.dtype != want.dtype or out.shape != want.shape:
        raise AssertionError(f"k1 {what}: {out.dtype}{tuple(out.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    err = float((out.float() - want.float()).abs().max())
    torch.testing.assert_close(
        out.float(), want.float(), **_tol(out.dtype),
        msg=lambda m: f"k1 {what}: max_abs_err {err:.3e}, limit "
                      f"{_tol_text(out.dtype)}: {m}")
    return err


# --------------------------------------------------------------- serving ----

def requests(vocab: int, seed: int = 0):
    """12 prompts of 100-700 tokens; four share a 256-token prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 256)
    reqs = []
    for i, n in enumerate(rng.integers(100, 701, 12)):
        if i % 3 == 1:                  # 4 of 12 share the system prompt
            n = max(int(n), 300)
            toks = np.concatenate([prefix, rng.integers(0, vocab, n - 256)])
            reqs.append((toks, "sys"))
        else:
            reqs.append((rng.integers(0, vocab, int(n)), None))
    return reqs


def serve(params, cfg, plan, reqs, *, max_seq, slots, decode, device):
    """Run one engine to completion.  Returns (sorted outputs, engine,
    launches, decode steps that ran with cold pages mapped, wall seconds,
    seconds of each pure decode step)."""
    import torch
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.serve.engine import ContinuousBatcher
    b = ContinuousBatcher(params, cfg, slots, max_seq, plan=plan,
                          device=device)
    for toks, key in reqs:
        b.submit(torch.as_tensor(toks), decode, prefix_key=key)
    results, cold_steps, step_s = [], 0, []
    if device == "cuda":
        torch.cuda.synchronize()
    pd.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    while b.queue or b._jobs or any(b.active):
        cold_mapped = any(b.ptable.tier[s][i] == 1 for s in range(b.B)
                          if b.active[s]
                          for i in range(b.ptable.n_pages[s]))
        d0, ts = b.decode_steps, time.perf_counter()
        if not b.step():
            break
        # step() reads the decoded tokens back, so the host clock is synced
        if b.decode_steps > d0:
            cold_steps += cold_mapped
            if b.step_prefill_tokens[-1] == 0:
                step_s.append(time.perf_counter() - ts)
        for i in range(b.B):
            if not b.active[i] and b.outputs[i]:
                results.append(tuple(b.outputs[i]))
                b.outputs[i] = []
    wall = time.perf_counter() - t0
    launches = pd.paged_decode_attention.launches
    return sorted(results), b, launches, cold_steps, wall, step_s


def check_serving():
    """Phase 3.  Returns the tiered run's numbers and what phase 4 needs to
    profile it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.plan import ServingPlan
    cfg = get_config("smollm-360m")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    reqs = requests(cfg.vocab_size)
    windows = [128 + 16 * s for s in range(SLOTS)]          # 128..240 tokens
    tiered = ServingPlan(hot_window=192, slot_hot_windows=windows,
                         page_tokens=PAGE, prefill_chunk_tokens=256)
    all_hot = dataclasses.replace(tiered, hot_window=MAX_SEQ,
                                  slot_hot_windows=[MAX_SEQ] * SLOTS)
    runs = {}
    for name, plan in (("tiered", tiered), ("all_hot", all_hot)):
        out, b, launches, cold_steps, wall, step_s = serve(
            params, cfg, plan, reqs, max_seq=MAX_SEQ, slots=SLOTS,
            decode=DECODE, device="cuda")
        cnt = b.counters()
        if launches != cnt["decode_steps"] * cfg.num_layers:
            raise AssertionError(f"{name}: {launches} kernel launches for "
                                 f"{cnt['decode_steps']} decode steps x "
                                 f"{cfg.num_layers} layers")
        if len(out) != len(reqs) or any(len(o) != DECODE for o in out) or \
                any(not 0 <= t < cfg.vocab_size for o in out for t in o):
            raise AssertionError(f"{name}: malformed outputs")
        runs[name] = (out, cnt, launches, cold_steps, wall, step_s)
        print(f"serve {name}: {len(out)} requests, {cnt['decode_steps']} "
              f"decode steps, {launches} kernel launches, {cold_steps} decode "
              f"steps with cold pages mapped, page_copies "
              f"{cnt['page_copies']}, prefill compute/skipped tokens "
              f"{cnt['prefill_compute_tokens']}/"
              f"{cnt['prefill_skipped_tokens']}, wall {wall:.3f} s",
              flush=True)
    out_t, cnt_t, launches, cold_steps = runs["tiered"][:4]
    if out_t != runs["all_hot"][0]:
        raise AssertionError("tiered tokens differ from the all-hot run")
    if not (cnt_t["page_copies"] > 0 and cold_steps > 0
            and cnt_t["prefill_skipped_tokens"] > 0):
        raise AssertionError(f"tiered run did not exercise cold pages and "
                             f"prefix sharing: {cnt_t}")
    print("serve check: tiered tokens == all-hot tokens; launches == decode "
          f"steps x {cfg.num_layers}", flush=True)
    check_small_against_cpu()
    print(f"phase 3 took {time.perf_counter() - t0:.1f} s", flush=True)
    return runs["tiered"], (params, cfg, tiered, reqs)


def check_small_against_cpu():
    """The reduced fp32 model served on the card (kernel) and on the CPU
    (plain path) from the same parameters: identical tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.plan import ServingPlan
    cfg = get_config("smollm-360m").reduced()
    params_cpu = init_params(cfg, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to("cuda")
    rng = np.random.default_rng(3)
    sys_p = rng.integers(0, cfg.vocab_size, 9)
    reqs = [(np.concatenate([sys_p, rng.integers(0, cfg.vocab_size, 3 + i)]),
             "sys") for i in range(3)] + \
        [(rng.integers(0, cfg.vocab_size, 21), None)]
    plan = ServingPlan(hot_window=8, slot_hot_windows=[4, 8], page_tokens=4,
                       prefill_chunk_tokens=8)
    got = {}
    for dev, p in (("cuda", params_gpu), ("cpu", params_cpu)):
        got[dev] = serve(p, cfg, plan, reqs, max_seq=48, slots=2, decode=10,
                         device=dev)
    if got["cuda"][0] != got["cpu"][0]:
        raise AssertionError("reduced fp32 model: card tokens differ from "
                             "the CPU's plain path")
    if got["cuda"][2] != got["cuda"][1].decode_steps * cfg.num_layers or \
            got["cuda"][3] == 0:
        raise AssertionError("reduced run did not go through the kernel "
                             "with cold pages mapped")
    print("small check: reduced fp32 engine tokens on the card == on the CPU "
          "plain path", flush=True)


# ---------------------------------------------------------------- timing ----

def time_ms(fn, reps=20, flush_bytes=64 << 20):
    """Median ms of ``fn`` over ``reps`` launches, each after writing a
    buffer larger than L2 so every launch starts from a cold cache."""
    import torch
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    ts = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def h2d_bytes_per_s(nbytes=256 << 20):
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: dst.copy_(src, non_blocking=True), reps=5,
                 flush_bytes=1)
    return nbytes / (ms * 1e-3)


def profile_decode(params, cfg, plan, reqs, card, steps=8):
    """Where a decode step's time goes: torch.profiler over ``steps`` pure
    decode steps of the tiered engine once all slots decode.  Prints the
    device-busy share (device time summed over all device ops / wall time,
    profiler on) and the ops that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import ContinuousBatcher
    b = ContinuousBatcher(params, cfg, SLOTS, MAX_SEQ, plan=plan)
    for toks, key in reqs[:SLOTS]:
        b.submit(torch.as_tensor(toks), DECODE, prefix_key=key)
    for _ in range(100):
        if not b._jobs and all(b.active):
            break
        b.step()
    else:
        raise AssertionError("profile window: the slots never all decoded")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            b.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    if not rows:
        print("decode profile: no device time in the trace (not measured)",
              flush=True)
        return
    busy = sum(r[0] for r in rows)
    top = "; ".join(f"{k[:60]} {us / steps / 1e3:.3f} ms x{n // steps}"
                    for us, n, k in rows[:6])
    print(f"decode profile: {wall_us / steps / 1e3:.3f} ms per step under the "
          f"profiler, device busy {100 * busy / wall_us:.1f}% "
          f"({busy / steps / 1e3:.3f} ms device time per step); top device "
          f"ops per step: {top} [{card}]", flush=True)


def k1_record(full, err, launches, card):
    """Phase 4 for the paged decode kernel at the full-width shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ref
    B, S, H, KVH, D, page = full["shape"]
    lengths = full["lengths"].tolist()
    esize = full["q"].element_size()
    page_bytes = page * KVH * D * 2 * esize          # K and V, all heads
    # distinct physical pages this run's lengths make the kernel read, by
    # the pool it reads them from (tier 0 hot; cold and FREE entries, clipped
    # as the kernel clips them, from the pinned pool): each is input the
    # function must move once.  The unmapped slot visits clipped cold page 0
    # for every page of its length; that page counts once.  The arithmetic
    # counts every visit.
    table, tier = full["page_table"].cpu(), full["page_tier"].cpu()
    n_pool = {True: full["k_hot"].shape[0], False: full["k_cold"].shape[0]}
    read = set()
    for b, n in enumerate(lengths):
        for i in range(-(-n // page)):
            hot = int(tier[b, i]) == 0
            read.add((hot, min(max(int(table[b, i]), 0), n_pool[hot] - 1)))
    hot_pages = sum(1 for hot, _ in read if hot)
    cold_pages = len(read) - hot_pages
    tokens = sum(-(-n // page) for n in lengths) * page
    # q in, out back, and the int32 table, tier and lengths
    io_bytes = 2 * full["q"].numel() * esize + (2 * B * (S // page) + B) * 4
    h2d = h2d_bytes_per_s()
    bytes_s = max((hot_pages * page_bytes + io_bytes) / HBM_BYTES_PER_S,
                  cold_pages * page_bytes / h2d)
    ops_s = 4.0 * H * D * tokens / FP32_FLOP_PER_S
    bound_ms = 1e3 * max(bytes_s, ops_s)
    ms = time_ms(lambda: pd.paged_decode_attention(*k1_args(full)))
    dev_args = k1_args(full, True)
    plain_ms = time_ms(lambda: ref.paged_decode_attention_ref(*dev_args),
                       reps=5)
    # yardstick only: one SDPA call over the same KV gathered densely
    kd, vd = full["dense"]
    G = H // KVH
    k = kd.transpose(1, 2).repeat_interleave(G, dim=1)    # (B, H, S, D)
    v = vd.transpose(1, 2).repeat_interleave(G, dim=1)
    pos = torch.arange(S, device="cuda")
    mask = (pos[None, :] < full["lengths"][:, None])[:, None, None, :]
    qq = full["q"][:, :, None, :]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask))
    print(f"k1 time: {ms:.4f} ms at B{B} H{H} KVH{KVH} D{D} page{page} bf16 "
          f"({hot_pages} hot + {cold_pages} cold distinct pages of "
          f"{page_bytes} B, {tokens // page} page visits); "
          f"bound {bound_ms:.4f} ms (hot at {HBM_BYTES_PER_S / 1e12} TB/s, "
          f"cold at measured pinned H2D {h2d / 1e9:.2f} GB/s); plain "
          f"{plain_ms:.4f} ms; sdpa {library_ms:.4f} ms [{card}]", flush=True)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/paged_decode.py:119",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": library_ms}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    built = build.build("paged_decode")
    if built is not None:
        secs, log = built
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build paged_decode: {secs:.2f} s; " + " | ".join(info),
              flush=True)

    full, err = check_kernels()
    (out, cnt, launches, cold_steps, wall, step_s), served = check_serving()

    decode_tokens = sum(len(o) - 1 for o in out)
    print(f"serve time: {decode_tokens / wall:.1f} decode tokens/s over the "
          f"whole tiered run ({wall:.3f} s, prefill included); mean pure "
          f"decode step {1e3 * float(np.mean(step_s)):.3f} ms over "
          f"{len(step_s)} steps of {SLOTS} slots [{card}]", flush=True)
    record = k1_record(full, err, launches, card)
    profile_decode(*served, card)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
