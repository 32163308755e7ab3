"""Serving-phase trace model (port of the trace half of
``repro/core/hmsim.py``): ``ServeTrace`` / ``KVObject`` /
``build_serve_trace``.  Prefill/decode phases run over a slot-based
continuous batch, where the data objects are per-slot, per-layer KV
*blocks* with token-indexed access patterns — the inference analogue of the
paper's training-step objects.  Lifetimes are known exactly (a request's KV
dies when its slot is refilled), and the access schedule repeats every
token, which is precisely the structure Sentinel exploits.

The policies that simulate a trace live in ``repro_torch.runtime.policies``
(``runtime.simulate(trace, cost_model, fast_bytes, policy)``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.runtime.objects import peak_object_bytes


# Access model per decode step: a slot reads all blocks inside its recent
# attention window every token; older history blocks are re-read every
# ``history_period`` tokens (sparse/strided history attention — the
# "token skipping" structure of the Data_Placement_Optimization traces).
# Every KV object's access list is therefore monotone in token index.


@dataclass
class KVObject:
    """One per-slot, per-layer KV block (``block_tokens`` tokens of K+V).

    ``shared_key`` tags blocks that are the *same physical data* across
    requests (a common prompt prefix — one system prompt serving N tenants):
    blocks with equal keys occupy the same physical pages at runtime, so
    sharing-aware policies and the capacity/migration accounting count their
    bytes exactly once (the trace-level mirror of kvcache.PageTable
    refcounts)."""
    uid: int
    slot: int
    req: int
    layer: int
    block: int                 # block index within the request's token stream
    bytes: int
    birth: int                 # global decode step when first written
    death: int                 # last decode step of the owning request
    token_start: int           # token range covered, [start, end)
    token_end: int
    prefill: bool              # born during prefill (vs appended during decode)
    accesses: List[int] = field(default_factory=list)  # sorted decode steps
    shared_key: Optional[tuple] = None   # (prefix_id, layer, block) or None
    tenant: Optional[str] = None         # owning tenant id (multi-tenant runs)


@dataclass
class ServeTrace:
    """A fully resolved serving timeline for one continuous-batching run."""
    num_slots: int
    num_layers: int
    block_tokens: int
    recent_window: int
    history_period: int
    kv_token_bytes: float      # KV bytes per token per layer
    weight_bytes: float        # weight bytes streamed per decode step
    flops_per_token: float
    num_steps: int = 0
    objects: List[KVObject] = field(default_factory=list)
    admits: Dict[int, List[KVObject]] = field(default_factory=dict)
    births: Dict[int, List[KVObject]] = field(default_factory=dict)
    frees: Dict[int, List[KVObject]] = field(default_factory=dict)
    reads: Dict[int, List[KVObject]] = field(default_factory=dict)
    active: Dict[int, int] = field(default_factory=dict)
    prefill_tokens: Dict[int, int] = field(default_factory=dict)
    # prompt tokens per admit step the cache-aware engine does NOT compute:
    # full blocks of a shared prefix whose KV a donor already materialized
    # (engine._start_job's compute skip — the suffix pass attends back into
    # the shared pages instead of recomputing them)
    prefill_skip_tokens: Dict[int, int] = field(default_factory=dict)

    def rs_bytes(self) -> float:
        """Serving reserve pool (paper §4.3 restated per-token): the open,
        still-filling KV blocks every active slot writes into must stay fast."""
        return (self.num_slots * self.num_layers * self.block_tokens
                * self.kv_token_bytes)

    def write_bytes(self, t: int) -> float:
        """New KV appended at step t (one token per layer per active slot)."""
        return self.active.get(t, 0) * self.num_layers * self.kv_token_bytes

    def peak_kv_bytes(self) -> float:
        """Peak concurrently-live KV bytes — sharing-aware: blocks with the
        same ``shared_key`` are one physical allocation, so a shared group
        contributes its bytes once over the union of its members' lifetimes
        (exactly when at least one reference holds the pages live)."""
        return peak_object_bytes(self.objects)


def synthetic_requests(n: int, prompt_tokens: int = 96, decode_tokens: int = 48,
                       jitter: int = 3) -> List[tuple]:
    """Deterministic mixed request stream (no RNG: repeatability is the point)."""
    out = []
    for i in range(n):
        p = prompt_tokens + (i * 17) % (jitter * 16 + 1)
        d = decode_tokens + (i * 11) % (jitter * 8 + 1)
        out.append((p, d))
    return out


def build_serve_trace(requests: Sequence[tuple], num_slots: int,
                      num_layers: int, kv_token_bytes: float, *,
                      block_tokens: int = 16, recent_window: int = 32,
                      history_period: int = 4, flops_per_token: float = 1e9,
                      weight_bytes: float = 0.0,
                      shared_prefix_tokens: int = 0) -> ServeTrace:
    """Resolve a request stream ``[(prompt_tokens, decode_tokens), ...]`` into
    a slot-scheduled decode timeline with per-block KV objects.

    Requests may carry a third element ``prefix_id``: with
    ``shared_prefix_tokens > 0``, prefill blocks lying fully inside the
    first ``shared_prefix_tokens`` prompt tokens of same-``prefix_id``
    requests get equal ``shared_key`` tags — they are one physical
    allocation at runtime (engine page sharing), and the sharing-aware
    accounting counts them once."""
    tr = ServeTrace(num_slots, num_layers, block_tokens, recent_window,
                    history_period, float(kv_token_bytes), float(weight_bytes),
                    float(flops_per_token))
    slot_free = [0] * num_slots
    seen_prefix: set = set()
    uid = 0
    for req, r in enumerate(requests):
        p, d = r[0], r[1]
        prefix_id = r[2] if len(r) > 2 else None
        slot = min(range(num_slots), key=lambda s: slot_free[s])
        a = slot_free[slot]                 # admit step (slot refill)
        end = a + d - 1                     # last decode step
        slot_free[slot] = a + d
        tr.prefill_tokens[a] = tr.prefill_tokens.get(a, 0) + p
        if prefix_id is not None and shared_prefix_tokens > 0:
            if prefix_id in seen_prefix:
                # cache-aware prefill skips full shared blocks a donor
                # already materialized; capped below the last prompt token
                # (at least one suffix row is always computed), mirroring
                # engine._start_job's shared-page cap
                skip = (min(shared_prefix_tokens, p - 1)
                        // block_tokens) * block_tokens
                if skip > 0:
                    tr.prefill_skip_tokens[a] = \
                        tr.prefill_skip_tokens.get(a, 0) + skip
            seen_prefix.add(prefix_id)
        for t in range(a, end + 1):
            tr.active[t] = tr.active.get(t, 0) + 1

        def make_obj(layer, blk, ts, te, birth, is_prefill):
            nonlocal uid
            shared = None
            if prefix_id is not None and is_prefill and \
                    te <= shared_prefix_tokens:
                shared = (prefix_id, layer, blk)    # same physical pages
            o = KVObject(uid, slot, req, layer, blk,
                         int((te - ts) * kv_token_bytes), birth, end,
                         ts, te, is_prefill, shared_key=shared)
            uid += 1
            for t in range(birth, end + 1):
                tokens_now = p + (t - a) + 1
                recent = tokens_now - te < recent_window
                if recent or (t - birth) % history_period == 0:
                    o.accesses.append(t)
                    tr.reads.setdefault(t, []).append(o)
            tr.objects.append(o)
            (tr.admits if is_prefill else tr.births).setdefault(
                birth, []).append(o)
            tr.frees.setdefault(end + 1, []).append(o)

        n_pre = (p + block_tokens - 1) // block_tokens
        for layer in range(num_layers):
            for b in range(n_pre):
                make_obj(layer, b, b * block_tokens,
                         min((b + 1) * block_tokens, p), a, True)
            n_dec = (d + block_tokens - 1) // block_tokens
            for b in range(n_dec):
                ts = p + b * block_tokens
                make_obj(layer, n_pre + b, ts,
                         min(ts + block_tokens, p + d), a + b * block_tokens,
                         False)
    tr.num_steps = max(slot_free)
    return tr

