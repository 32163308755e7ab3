"""Batched serving engine: prefill and lockstep decode over KV caches (port
of ``repro/serve/engine.py``).

``make_serve_step`` (one token for the whole batch against a filled cache)
and ``generate`` (prefill, then greedy or temperature sampling) drive a
dense cache; ``ContinuousBatcher`` refills finished slots from request
queues and keeps its cache in one of four layouts, selected as the
reference selects them:

  all-HBM (``plan=None``)   one dense cache in device memory.
  concat  (``plan``, ``paged=False``)   one *global* cold boundary
      (``plan.cold_len``): the cold prefix of every slot in host memory,
      read back by concatenation (kvcache.TieredCache).
  paged-merged (``paged=True``)   *per-slot* boundaries at page grain
      (``plan.cold_len_slot``), kvcache.PagedTieredCache plus a PageTable;
      the dense hot tree stays the working copy, the masked merge reads it.
  pools (``paged=True`` + ``cfg.use_paged_decode``)   the persistent page
      pools (kvcache.PagedKVPools) ARE the cache: hot pages in device
      memory, cold pages in pinned host memory, one refcounted PageTable.
      Decode writes each token's KV through the table and reads the pools
      with the paged decode kernel.  A pure-attention stack admits by a
      per-slot state machine (``queued -> prefilling -> active``) whose
      page-aligned chunks prefill straight into the slot's pages, and a
      request with a ``prefix_key`` maps the donor's full prompt pages
      instead of computing them; any other stack (zamba2's, whose Mamba
      state is not paged, or deepseek's, whose MLA latent stays dense as
      in the reference) admits by one dense prefill whose rows and state
      are then written into the pools.

Every other layout admits by one dense prefill spliced into its cache.
A prefix-LM config (paligemma) never takes the pools: ``paged=True`` gives
it paged-merged, whose decode stays on the dense core (K1 has no prefix
mask), and the batcher takes its text-only prompts.  A codebook config
(musicgen) is refused: the batcher decodes one token id a slot, and such
streams serve through ``generate``.
``sim_migration_bytes`` counts every byte moved device->host, so the
layouts' migration traffic compares directly; ``counters()`` exports the
integer books the reference engine keeps; ``predict_pool_counters``
replays the pools layout's from the plan alone, and ``serve_trace_for``
profiles a request stream for ``runtime.plan``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from repro_torch import telemetry
from repro_torch.core import hmsim
from repro_torch.device import resolve
from repro_torch.models import kvcache, model


@dataclass
class ServeConfig:
    max_seq: int = 2048
    temperature: float = 0.0     # 0 = greedy
    eos_id: int = -1             # -1: never stop early


@dataclass
class _PrefillJob:
    """One queued request bound to its batch slot; ``done`` advances chunk
    by chunk until the whole prompt's KV is in the pools."""
    tokens: Any                  # device prompt (S,)
    tok_host: tuple              # host mirror, cached once at submit()
    S: int                       # prompt length
    budget: int                  # decode tokens requested
    prefix_key: Any
    tenant: Any
    done: int = 0                # prompt tokens whose KV is materialized
    shared_pages: int = 0        # full pages mapped onto the donor (skipped)
    started: bool = False        # pages freed/shared, donor registered
    last: Any = None             # last computed row's logits (1, vocab)


def make_prefill(cfg):
    """(params, batch) -> (last row's logits, caches)."""
    def prefill(params, batch):
        return model.prefill(params, cfg, batch)
    return prefill


def make_serve_step(cfg):
    """(params, tokens (B, 1) or (B, 1, K), caches, index) -> (logits,
    caches); the caches are updated in place."""
    def step(params, tokens, caches, index):
        return model.decode_step(params, cfg, tokens, caches, index)
    return step


def sample(logits, generator, temperature: float):
    """Greedy (argmax) at temperature 0, else one draw per row (per row
    and codebook for (B, K, V) logits) from softmax(logits / temperature)
    with ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                             generator=generator).reshape(probs.shape[:-1])


class ContinuousBatcher:
    """Slot-based continuous batching over a fixed B-slot decode batch: all
    slots decode in lockstep against per-slot lengths, and finished or
    empty slots are refilled from per-tenant request queues.  ``plan`` (a
    ``runtime.PlacementPlan``) sets the page size, every slot's hot window,
    the per-step prefill budget and the slots' tenants; without one the
    cache is all-HBM.  The layout follows ``plan``, ``paged`` and
    ``cfg.use_paged_decode`` (see the module's docstring)."""

    def __init__(self, params, cfg, batch_slots: int, max_seq: int,
                 scfg: Optional[ServeConfig] = None, plan=None,
                 paged: bool = False, slot_tenants=None,
                 prefill_chunk_tokens: Optional[int] = None, device=None):
        if cfg.num_codebooks:
            # the reference's batcher has no codebook path either: it
            # fails at submit (ROADMAP R10)
            raise ValueError(
                f"{cfg.name}: the batcher decodes one token id a slot; "
                f"codebook streams ({cfg.num_codebooks} codes a step) serve "
                "through generate")
        if paged and plan is None:
            raise ValueError("paged=True requires a plan (plan=...)")
        self.device = resolve(device)
        p_dev = next(params.parameters()).device
        if p_dev != self.device:
            raise ValueError(f"params live on {p_dev}, engine on "
                             f"{self.device}")
        self.params, self.cfg = params, cfg
        self.B, self.max_seq = batch_slots, max_seq
        self.scfg = scfg or ServeConfig(max_seq=max_seq)
        self.plan = plan
        # at most this many prompt tokens of pending prefill per step (0:
        # each admission in one shot); the plan's by default
        if prefill_chunk_tokens is None:
            prefill_chunk_tokens = plan.prefill_chunk_tokens \
                if plan is not None else 0
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        # a tenant's requests admit only into the tenant's own slots;
        # ``slot_tenants=`` lets an all-HBM run replay the same admissions
        if slot_tenants is None and plan is not None:
            slot_tenants = plan.slot_tenants
        self.slot_tenants = list(slot_tenants) if slot_tenants else None
        if self.slot_tenants and len(self.slot_tenants) != batch_slots:
            raise ValueError(
                f"slot_tenants has {len(self.slot_tenants)} entries for "
                f"{batch_slots} batch slots (plan/batch geometry mismatch)")
        self.tenant_hot_peak: dict = {}        # tenant -> peak hot pool bytes
        self._tenant_note_version = -1         # last-sampled table version
        self.cold_len = plan.cold_len(max_seq) if plan is not None else 0
        dt = model.param_dtype(cfg)
        self._row_bytes = kvcache.kv_token_bytes(
            cfg, torch.finfo(dt).bits // 8) * cfg.num_layers
        self.sim_migration_bytes = 0.0         # device->host cold traffic
        # per-step deltas of sim_migration_bytes, tracked against a
        # persistent marker so bytes moved between steps (apply_plan) land
        # in the next step's entry: sum(series) == total always
        self.step_migration_bytes: list = []
        self._mig_accounted = 0.0
        self.paged = self.tiered = self.caches = self.ptable = None
        self.pool = None
        if paged:
            page = max(1, plan.page_tokens)
            if max_seq % page:                 # buffer must tile in pages
                page = next(p for p in range(page, 0, -1) if max_seq % p == 0)
            self.page_tokens = page
            if cfg.use_paged_decode and not cfg.prefix_lm:
                # K1 has no prefix mask: a prefix-LM config takes
                # paged-merged, whose decode stays on the dense core
                self.pool = kvcache.PagedKVPools(cfg, batch_slots, max_seq,
                                                 page, dt, self.device)
                self.ptable = self.pool.table
            else:
                self.paged = kvcache.init_paged_cache(
                    cfg, batch_slots, max_seq, page, dt, self.device)
                self.ptable = kvcache.PageTable(batch_slots, max_seq // page,
                                                page)
        elif self.cold_len > 0:
            self.tiered = kvcache.init_tiered_cache(
                cfg, batch_slots, max_seq, self.cold_len, dt, self.device)
        else:
            self.caches = kvcache.init_cache(cfg, batch_slots, max_seq, dt,
                                             self.device)
        self.lengths = torch.zeros(batch_slots, dtype=torch.int32,
                                   device=self.device)
        self.active = [False] * batch_slots
        self.budget = [0] * batch_slots         # tokens left to generate
        self.last_tok = torch.zeros(batch_slots, dtype=torch.long,
                                    device=self.device)
        self.outputs = [[] for _ in range(batch_slots)]
        # per-tenant admission queues (None = untagged); ``_qseq`` stamps
        # global FIFO order across them
        self._queues: dict = {}
        self._qseq = 0
        # host-side mirrors of the per-slot lengths and the active set, so
        # per-step bookkeeping never reads a device tensor back
        self._host_len = [0] * batch_slots
        self._active_mask = torch.zeros(batch_slots, dtype=torch.bool,
                                        device=self.device)
        self._active_inc = torch.zeros(batch_slots, dtype=torch.int32,
                                       device=self.device)
        self._prefix_donor: dict = {}          # prefix_key -> (slot, tokens)
        # the one-shot admission's dense prefill, (params, batch) -> (last
        # row's logits, cache): the seam the disaggregated engine wraps to
        # run it on its prefill device
        self._prefill = lambda p, batch: model.prefill(p, cfg, batch,
                                                       max_seq=max_seq)
        self._jobs: dict = {}                  # slot -> _PrefillJob
        self._step_prefill = 0                 # prompt tokens run this step
        self.step_prefill_tokens: list = []
        self.prefill_compute_tokens = 0        # prompt rows actually run
        self.prefill_skipped_tokens = 0        # rows skipped via shared pages
        self.decode_steps = 0                  # steps that ran a decode
        # pool-direct prefill (chunks straight into the pages) needs every
        # layer's cache to be a pool: pure-attention stacks only, and no
        # modality stub; any other stack on the pools admits by one dense
        # prefill (_admit_dense)
        self._pool_prefill_ok = (
            self.pool is not None
            and all(cfg.layer_kind(l) in kvcache.ATTN_KINDS
                    for l in range(cfg.num_layers))
            and not cfg.prefix_lm and not cfg.num_prefix_tokens
            and not cfg.num_codebooks)
        if self.prefill_chunk_tokens and not self._pool_prefill_ok:
            raise ValueError(
                "prefill_chunk_tokens requires the persistent-pools layout "
                "with a pure-attention stack (pool-direct prefill)")

    def submit(self, tokens, num_tokens: int, prefix_key=None, tenant=None):
        """Queue a request (``tokens``: 1-D prompt ids).  ``prefix_key``
        marks requests sharing a prompt prefix, whose common full pages map
        to the same physical pages; ``tenant`` restricts admission to the
        tenant's slots when the plan partitions them."""
        if tenant is not None and self.slot_tenants and \
                tenant not in self.slot_tenants:
            raise ValueError(f"tenant {tenant!r} owns no batch slot "
                             f"(slot_tenants={self.slot_tenants})")
        tokens = torch.as_tensor(tokens)
        tok_host = tuple(int(t) for t in tokens.tolist())
        tokens = tokens.to(self.device, torch.long)
        self._queues.setdefault(tenant, deque()).append(
            (self._qseq, tokens, tok_host, num_tokens, prefix_key, tenant))
        self._qseq += 1

    @property
    def queue(self) -> list:
        """Pending requests in global FIFO order, as ``(tokens, num_tokens,
        prefix_key, tenant)``."""
        items = sorted((it for q in self._queues.values() for it in q),
                       key=lambda it: it[0])
        return [(t, n, pk, tn) for _, t, _, n, pk, tn in items]

    def _slot_tenant(self, slot: int):
        return self.slot_tenants[slot] if self.slot_tenants else None

    def _pop_for_slot(self, slot: int):
        """Pop the earliest-submitted request admissible to ``slot`` (FIFO
        within each tenant; untagged requests match any slot)."""
        tn = self._slot_tenant(slot)
        best_q = None
        for key in (self._queues.keys() if tn is None else (None, tn)):
            q = self._queues.get(key)
            if q and (best_q is None or q[0][0] < best_q[0][0]):
                best_q = q
        return best_q.popleft() if best_q else None

    def _note_tenant_pages(self):
        """Fold each tenant's current hot-pool footprint (distinct physical
        hot pages across its slots) into its peak; only after a table
        mutation."""
        if not self.slot_tenants or self.ptable is None:
            return
        if self.ptable.version == self._tenant_note_version:
            return
        self._tenant_note_version = self.ptable.version
        per: dict = {}
        for s in range(self.B):
            tn = self._slot_tenant(s)
            if tn is None:
                continue
            per.setdefault(tn, set()).update(
                self.ptable.table[s][i]
                for i in range(self.ptable.n_pages[s])
                if self.ptable.tier[s][i] == 0)
        page_bytes = self.page_tokens * self._row_bytes
        for tn, pages in per.items():
            v = len(pages) * page_bytes
            if v > self.tenant_hot_peak.get(tn, 0):
                self.tenant_hot_peak[tn] = v

    def _refresh_active(self):
        """Re-derive the device-side active mask (only when a slot starts or
        finishes)."""
        self._active_mask = torch.tensor(self.active, dtype=torch.bool,
                                         device=self.device)
        self._active_inc = self._active_mask.to(torch.int32)

    def _slot_cold_target(self, slot: int, seq_len: int) -> int:
        return self.plan.cold_len_slot(slot, seq_len, self.page_tokens)

    def _slot_pool(self, slot: int):
        """The pools holding ``slot``'s pages (one decode shard's pools in
        the disaggregated engine)."""
        return self.pool

    def _demote_to_target(self, slot: int, seq_len: int):
        """Demote the slot's boundary page by page to the plan's target;
        twin-deduped shared pages advance it with zero copy."""
        pool = self._slot_pool(slot)
        target = self._slot_cold_target(slot, seq_len)
        while pool.table.cold_tokens(slot) < target:
            if pool.demote_boundary(slot):
                self.sim_migration_bytes += self.page_tokens * self._row_bytes

    def _admit(self):
        """Bind queued requests to free slots and advance pending prefill:
        pool-direct stacks go through the admission state machine
        (``_drain_prefill``), every other layout admits one-shot."""
        for slot in range(self.B):
            if self.active[slot] or slot in self._jobs:
                continue
            item = self._pop_for_slot(slot)
            if item is None:
                continue
            _, tokens, tok_host, budget, prefix_key, tenant = item
            S = int(tokens.shape[-1])
            if self._pool_prefill_ok:
                self._jobs[slot] = _PrefillJob(tokens, tok_host, S, budget,
                                               prefix_key, tenant)
            else:
                self._admit_dense(slot, tokens, tok_host, S, budget,
                                  prefix_key)
        if self._jobs:
            self._drain_prefill()

    def _admit_dense(self, slot: int, tokens, tok_host, S: int, budget: int,
                     prefix_key):
        """One-shot admission: a dense full-prompt prefill, then the
        layout's splice of its cache."""
        last, fresh = self._prefill(self.params, {"tokens": tokens[None]})
        if self.pool is not None:
            self._admit_pool(slot, tok_host, fresh, S, prefix_key)
        elif self.paged is not None:
            # per-slot boundary: only THIS slot's cold pages are re-hosted
            cold = self._slot_cold_target(slot, S)
            self.ptable.splice_slot(slot, S, cold)
            kvcache.splice_slot(self.paged.hot, fresh, slot)
            self.paged.set_boundary(slot, 0)
            if cold:
                self.paged.demote_rows(slot, cold)
            self.sim_migration_bytes += cold * self._row_bytes
        elif self.tiered is not None:
            fc, fh = kvcache.split_seq_cache(fresh, self.cold_len)
            kvcache.splice_slot(self.tiered.cold, fc, slot)
            kvcache.splice_slot(self.tiered.hot, fh, slot)
            # global boundary: the full cold prefix re-hosts on refill
            self.sim_migration_bytes += self.cold_len * self._row_bytes
        else:
            kvcache.splice_slot(self.caches, fresh, slot)
        self.prefill_compute_tokens += S
        self._step_prefill += S
        self._activate(slot, S, last, budget)

    def _admit_pool(self, slot: int, tok_host, fresh, S: int, prefix_key):
        """Admit a dense prefill into the pools: free the slot's page refs,
        map shared-prefix full pages onto the donor's, write the rest of the
        prefilled rows into fresh private pages and the other layers' state
        into the tree, then demote page by page to the plan's target."""
        pool = self._slot_pool(slot)
        shared = self._share_prefix(slot, tok_host, prefix_key)
        n = -(-S // self.page_tokens)
        self._alloc_admit_pages(slot, n)
        # the KV crosses to the pools' device here (no copy when it is there)
        fresh = kvcache.to_device(fresh, pool.device)
        pool.admit_rows(fresh, slot, range(shared, n))
        pool.splice_other(fresh, slot)
        self._demote_to_target(slot, S)

    def _share_prefix(self, slot: int, tok_host, prefix_key,
                      cap: Optional[int] = None) -> int:
        """Free the slot's pages and the donor registrations that die with
        them; map the full pages of the prompt's common prefix with the
        key's donor (pages the donor holds, at most ``cap``) onto the
        donor's physical pages, refcounted; register this prompt as the
        key's donor.  Returns the pages shared (never the page decode
        writes into: a shared page is read-only)."""
        pool = self._slot_pool(slot)
        table = pool.table
        for key in [k for k, (s, _) in self._prefix_donor.items()
                    if s == slot]:
            del self._prefix_donor[key]
        table.free_slot(slot)
        if prefix_key is None:
            return 0
        shared = 0
        donor = self._prefix_donor.get(prefix_key)
        # physical pages alias only within one set of pools
        if donor is not None and donor[0] != slot and \
                self._slot_pool(donor[0]) is pool and \
                table.n_pages[donor[0]] > 0:
            lcp = 0
            for a, b in zip(tok_host, donor[1]):
                if a != b:
                    break
                lcp += 1
            shared = min(lcp // self.page_tokens, table.n_pages[donor[0]])
            if cap is not None:
                shared = min(shared, cap)
            if shared:
                table.share(slot, donor[0], shared)
        self._prefix_donor[prefix_key] = (slot, tok_host)
        return shared

    def _alloc_admit_pages(self, slot: int, n: int) -> None:
        """Grow ``slot`` to ``n`` hot pages for an admission (the seam the
        disaggregated engine overrides: there the pages are staged on the
        prefill device's table and cross to the decode side as a
        ``MeshPageTable.migrate_slot`` transition)."""
        for _ in range(self.ptable.n_pages[slot], n):
            self.ptable.alloc(slot, 0)

    def _activate(self, slot: int, S: int, last, budget: int):
        """Flip the slot active; the prompt's last-row logits decode its
        first token."""
        self.lengths[slot] = S
        self._host_len[slot] = S
        self.last_tok[slot] = torch.argmax(last[0, :self.cfg.vocab_size])
        self.active[slot] = True
        self.budget[slot] = budget
        self.outputs[slot] = [int(self.last_tok[slot])]
        self.budget[slot] -= 1
        self._refresh_active()
        self._note_tenant_pages()

    def _drain_prefill(self):
        """Run pending prefill jobs, at most ``prefill_chunk_tokens`` prompt
        tokens this step (0 = each job in one shot).  Jobs drain in slot
        order; chunk ends are page-aligned except a final partial page, and
        the budget may overdraw by less than one page."""
        pg = self.page_tokens
        budget = self.prefill_chunk_tokens
        spent = 0
        for slot in sorted(self._jobs):
            job = self._jobs[slot]
            while slot in self._jobs:
                if budget and spent >= budget:
                    return                 # budget exhausted: resume next step
                if not job.started:
                    self._start_job(slot, job)
                pages_left = -(-(job.S - job.done) // pg)
                take = pages_left if not budget else \
                    min(pages_left, max(1, (budget - spent) // pg))
                end = min(job.S, job.done + take * pg)
                spent += end - job.done
                with telemetry.span("engine.prefill_chunk", key=slot):
                    self._run_chunk(slot, job, end)
                if job.done >= job.S:
                    self._finish_job(slot, job)

    def _start_job(self, slot: int, job: _PrefillJob):
        """First touch of a job: free the slot's old pages and map the
        shared-prefix full pages onto the donor's (their compute is
        skipped)."""
        pg = self.page_tokens
        # strictly below the prompt's last token: the suffix pass computes
        # at least the next-token row
        shared = self._share_prefix(slot, job.tok_host, job.prefix_key,
                                    (job.S - 1) // pg)
        job.shared_pages = shared
        job.done = shared * pg
        job.started = True
        self.prefill_skipped_tokens += job.done

    def _run_chunk(self, slot: int, job: _PrefillJob, end: int):
        """One prefill chunk ``tokens[done:end]`` straight into the slot's
        physical pages; each row attends back over the donor pages and the
        earlier chunks."""
        pg = self.page_tokens
        first = self.ptable.n_pages[slot]
        self._alloc_admit_pages(slot, -(-end // pg))
        self.pool.stats["admit_page_writes"] += self.ptable.n_pages[slot] \
            - first
        table, tier = self.pool.arrays()
        table_host, tier_host = self.pool.host_row(slot)
        view = {"page_table": table[slot][None], "page_tier": tier[slot][None],
                "page_table_host": table_host, "page_tier_host": tier_host,
                "page_tokens": pg, "active": None, "prefill": True}
        self.pool.sync_cold()                  # the gather reads cold pages
        job.last = model.prefill_suffix(
            self.params, self.cfg, {"tokens": job.tokens[job.done:end][None]},
            caches=self.pool.tree, start=job.done, paged_view=view)
        self.prefill_compute_tokens += end - job.done
        self._step_prefill += end - job.done
        job.done = end

    def _finish_job(self, slot: int, job: _PrefillJob):
        """Prompt fully materialized: advance the cold boundary to the
        current plan's target and flip the slot active."""
        del self._jobs[slot]
        self._demote_to_target(slot, job.S)
        self._activate(slot, job.S, job.last, job.budget)

    def _pool_decode_step(self):
        """One decode forward: write-page guarantee, the batched forward
        through the page-table view, and the post-step cold-boundary
        advance.  Returns the decoded tokens (B,)."""
        for s in range(self.B):
            if self.active[s]:
                self.pool.ensure_write_page(s, self._host_len[s])
        paged_view = self.pool.paged_view(self._active_mask)
        self.pool.count_decode_reads([n + 1 for n in self._host_len])
        with telemetry.span("engine.decode_forward"):
            logits = model.forward(
                self.params, self.cfg, {"tokens": self.last_tok[:, None]},
                caches=self.pool.tree, cache_index=self.lengths, decode=True,
                paged_view=paged_view)
        with telemetry.span("engine.demote"):
            for s in range(self.B):
                if self.active[s]:
                    self._demote_to_target(s, self._host_len[s] + 1)
        self._note_tenant_pages()
        return torch.argmax(logits[:, -1, :self.cfg.vocab_size], dim=-1)

    def _dense_decode_step(self):
        """One decode forward on a dense layout (all-HBM, concat or
        paged-merged) over the merged view of the cache, then the layout's
        bookkeeping: the write lands in the hot tree, and a slot's rows
        crossing its cold boundary move to host memory.  Returns the
        decoded tokens (B,)."""
        if self.paged is not None:
            caches = self.paged.merged()
        elif self.tiered is not None:
            caches = self.tiered.merged()
        else:
            caches = self.caches
        with telemetry.span("engine.decode_forward"):
            logits = model.forward(
                self.params, self.cfg, {"tokens": self.last_tok[:, None]},
                caches=caches, cache_index=self.lengths, decode=True)
        if self.paged is not None:
            self.paged.hot = caches
            # each active slot's own boundary: a page leaving the slot's hot
            # window is re-hosted, rows and table alike
            for s in range(self.B):
                if not self.active[s]:
                    continue
                new_len = self._host_len[s] + 1
                while self.ptable.n_pages[s] * self.page_tokens < new_len:
                    self.ptable.alloc(s, 0)    # decode grew into a new page
                target = self._slot_cold_target(s, new_len)
                moved = self.paged.demote_rows(s, target)
                while self.ptable.cold_tokens(s) < target:
                    self.ptable.demote(s, self.ptable.cold_pages(s))
                self.sim_migration_bytes += moved * self._row_bytes
            self._note_tenant_pages()
        elif self.tiered is not None:
            self.tiered.hot = kvcache.split_seq_cache(caches,
                                                      self.cold_len)[1]
            # a write inside the cold prefix (a short slot) re-hosts that
            # slot's row only
            for s in range(self.B):
                if self.active[s] and self._host_len[s] < self.cold_len:
                    pos = self._host_len[s]
                    kvcache.copy_slot_rows(self.tiered.cold, caches, s, pos,
                                           pos + 1)
                    self.sim_migration_bytes += self._row_bytes
        return torch.argmax(logits[:, -1, :self.cfg.vocab_size], dim=-1)

    def step(self):
        """Admission, then one lockstep decode step across all active
        slots; each slot writes its KV at its own length.  Returns False
        when there was nothing to do."""
        with telemetry.span("engine.step"):
            return self._step()

    def _step(self):
        self._step_prefill = 0
        with telemetry.span("engine.admit"):
            self._admit()
        if not any(self.active):
            if self._jobs:
                # prefill-only step: still a step for the accounting series
                self.step_prefill_tokens.append(self._step_prefill)
                self.step_migration_bytes.append(
                    self.sim_migration_bytes - self._mig_accounted)
                self._mig_accounted = self.sim_migration_bytes
                return True
            return False
        if self.pool is not None:
            tok = self._pool_decode_step()
        else:
            tok = self._dense_decode_step()
        self.decode_steps += 1
        self.last_tok = tok
        self.lengths = self.lengths + self._active_inc
        with telemetry.span("engine.readback"):
            tok_host = tok.tolist()        # the decoded tokens themselves
        was_active = list(self.active)
        for slot in range(self.B):
            if not was_active[slot]:
                continue
            self._host_len[slot] += 1
            self.outputs[slot].append(tok_host[slot])
            self.budget[slot] -= 1
            if self.budget[slot] <= 0 or tok_host[slot] == self.scfg.eos_id:
                self.active[slot] = False
        if self.active != was_active:
            self._refresh_active()
        self.step_prefill_tokens.append(self._step_prefill)
        self.step_migration_bytes.append(
            self.sim_migration_bytes - self._mig_accounted)
        self._mig_accounted = self.sim_migration_bytes
        return True

    def apply_plan(self, new_plan):
        """Adopt a re-plan (a whole ``PlacementPlan`` or an incremental
        ``runtime.PlanDelta`` against the current plan) between decode
        steps: re-target every active slot's cold boundary under the new
        windows (page-grain demotions; grown windows promote nothing) and
        re-partition slot tenancy.  Returns the migration bytes moved,
        attributed to the next step's ``step_migration_bytes`` entry,
        exactly as ``predict_pool_counters(..., plan_schedule=...)``
        replays it."""
        if self.pool is None:
            raise ValueError("apply_plan requires the persistent-pools "
                             "layout (paged=True, cfg.use_paged_decode)")
        if hasattr(new_plan, "changes"):       # a PlanDelta, not a plan
            new_plan = self.plan.apply_delta(new_plan)
        page = max(1, new_plan.page_tokens)
        if self.max_seq % page:
            page = next(p for p in range(page, 0, -1)
                        if self.max_seq % p == 0)
        if page != self.page_tokens:
            raise ValueError(
                f"re-plan changes page geometry ({page} != "
                f"{self.page_tokens} tokens/page) — pools cannot be "
                "re-paged in place")
        tenants = new_plan.slot_tenants
        if tenants and len(tenants) != self.B:
            raise ValueError(
                f"slot_tenants has {len(tenants)} entries for {self.B} "
                f"batch slots (plan/batch geometry mismatch)")
        self.plan = new_plan
        if tenants:
            self.slot_tenants = list(tenants)
        mig0 = self.sim_migration_bytes
        for s in range(self.B):
            if self.active[s]:
                self._demote_to_target(s, self._host_len[s])
        # tenancy may have moved without a table event — force a resample
        self._tenant_note_version = -1
        self._note_tenant_pages()
        return self.sim_migration_bytes - mig0

    def counters(self) -> dict:
        """The live counter export: migration totals and series, per-tenant
        hot-pool peaks, prefill books, decode steps and the pools' event
        counters."""
        out = {"sim_migration_bytes": self.sim_migration_bytes,
               "step_migration_bytes": list(self.step_migration_bytes),
               "tenant_hot_peak": dict(self.tenant_hot_peak),
               "table_version": self.ptable.version if self.ptable else 0,
               "prefill_compute_tokens": self.prefill_compute_tokens,
               "prefill_skipped_tokens": self.prefill_skipped_tokens,
               "prefill_read_bytes":
                   self.prefill_skipped_tokens * self._row_bytes,
               "step_prefill_tokens": list(self.step_prefill_tokens),
               "decode_steps": self.decode_steps}
        if self.pool is not None:
            out.update(self.pool.stats)
        return out

    def run(self):
        """Step until every request finished; returns the finished outputs
        (first token from prefill, then one per decode step)."""
        results = []
        while self.queue or self._jobs or any(self.active):
            if not self.step():
                break
            for i in range(self.B):
                if not self.active[i] and self.outputs[i]:
                    results.append(self.outputs[i])
                    self.outputs[i] = []
        return results


def predict_pool_counters(requests: Sequence[tuple], plan, *, slots: int,
                          max_seq: int, page_tokens: int, row_bytes: float,
                          slot_tenants=None,
                          plan_schedule: Sequence[tuple] = (),
                          prefill_chunk_tokens: int = 0,
                          dense_admit: bool = False,
                          slot_devices=None) -> dict:
    """Pure-Python replay of the pools-layout batcher's bookkeeping: given
    the request stream ``[(prompt, decode_tokens[, tenant[, prefix_key]]),
    ...]`` and a plan, predict ``sim_migration_bytes`` (total and the
    per-decode-step ``step_migration_bytes`` series a CostModel prices),
    the pool's ``page_copies`` / ``admit_page_writes`` counters, and the
    per-tenant hot-pool byte peaks
    — *exactly* (integer-for-integer) what a ``ContinuousBatcher`` will
    report on the same deterministic stream.  This is the engine/simulator
    agreement contract: the simulator predicts, the engine counts, the two
    never drift (``tests/test_torch_online.py`` pins it on this engine).

    ``prompt`` is either the prompt token *count* or the prompt token
    *sequence*; requests carrying a ``prefix_key`` must pass the sequence —
    the replay mirrors the engine's donor registry (LCP against the last
    prompt registered under the key, full pages mapped onto the donor's
    physical pages, refcounted, cold twins deduping shared demotions), so
    ``admit_page_writes`` / ``xdev_migration_bytes`` count only the private
    tail and stay integer-exact for shared-prefix admits.  ``dense_admit``
    replays the one-shot dense admission path (the disaggregated engine's
    ``_admit_pool``, ``serve/disagg.py``), whose
    shared-page cap differs from the pool-direct prefill scheduler's by the
    final-row carve-out.

    ``slot_devices`` (defaulting to the plan's) splits the replay across
    decode shards: sharing is intra-shard only, ``device_hot_peak`` tracks
    each shard's distinct-hot-page byte peak, and ``edge_migration_bytes``
    ledgers every ``(src, dst)`` device edge — prefill->shard admit streams
    and shard->shard slot re-homings (a ``plan_schedule`` entry whose plan
    moves an active slot's owner) — integer-exactly as the disaggregated
    engine's ``MeshPageTable`` counts them (``serve/disagg.py``).

    The replay mirrors the engine's event order: per step, binding of queued
    requests to free slots (FIFO within each tenant), the prefill drain
    (page-aligned chunks in slot order, at most ``prefill_chunk_tokens``
    prompt tokens per step — 0 replays the legacy one-shot admission),
    write-page growth for every active slot, then per-slot cold-boundary
    demotions toward the plan's target; peaks are sampled after each
    admission finalize and after each step's demotions, the same points the
    engine samples.  Steps in which only prefill ran (budget exhausted
    before any slot went active) still append a ``step_migration_bytes``
    entry, exactly as ``ContinuousBatcher.step()`` does.

    ``plan_schedule`` makes the replay *segment-aware* for online
    re-planning: ``[(step, new_plan_or_delta), ...]`` means "the engine
    called ``apply_plan`` before decode step ``step``".  The replay switches
    plans at exactly that point — re-targeting active slots' cold boundaries
    and re-partitioning slot tenancy — and, like the engine's marker-based
    accounting, attributes the re-layout bytes to that step's
    ``step_migration_bytes`` entry, so the two stay integer-identical
    across a re-plan boundary (sum of the series == the total on both
    sides)."""
    pg = page_tokens
    if slot_tenants is None and plan is not None:
        slot_tenants = getattr(plan, "slot_tenants", None)
    if slot_tenants and len(slot_tenants) != slots:
        raise ValueError(f"slot_tenants has {len(slot_tenants)} entries for "
                         f"{slots} slots (plan/batch geometry mismatch)")
    if slot_devices is None and plan is not None:
        slot_devices = getattr(plan, "slot_devices", None)
    if slot_devices:
        slot_devices = list(slot_devices)
        if len(slot_devices) != slots:
            raise ValueError(f"slot_devices has {len(slot_devices)} entries "
                             f"for {slots} slots")

    def parse(r):
        p = r[0]
        if isinstance(p, (list, tuple)):
            toks = tuple(int(t) for t in p)
            plen = len(toks)
        else:
            plen, toks = int(p), None
        pk = r[3] if len(r) > 3 else None
        if pk is not None and toks is None:
            raise ValueError("a prefix_key needs the prompt's token values "
                             "(pass the token sequence, not its length): "
                             "the replay LCPs them against the donor")
        return (plen, int(r[1]), r[2] if len(r) > 2 else None, toks, pk)

    queue = [parse(r) for r in requests]
    active = [False] * slots
    host_len = [0] * slots
    budget = [0] * slots
    # physical-page model, mirroring PageTable: per-slot phys ids + tiers
    # (cold-prefix), refcounts, and the cold-twin memo that dedupes shared
    # demotions — without prefix sharing it degenerates to the old counters
    ptab: list = [[] for _ in range(slots)]
    ptier: list = [[] for _ in range(slots)]
    hot_ref: dict = {}
    cold_ref: dict = {}
    cold_twin: dict = {}                   # hot phys -> its live cold twin
    twin_of: dict = {}
    donors: dict = {}                      # prefix_key -> (slot, tokens)
    next_phys = [0]
    mig = 0.0
    copies = admit_writes = 0
    peaks: dict = {}
    dev_peaks: dict = {}
    edge_bytes: dict = {}
    step_mig: list = []

    def slot_tn(s):
        return slot_tenants[s] if slot_tenants else None

    def dev(s):
        return slot_devices[s] if slot_devices else 0

    def dev_name(d):
        return f"dev{d}" if slot_devices else "decode"

    def fresh():
        next_phys[0] += 1
        return next_phys[0]

    def release(tier, phys):
        refs = cold_ref if tier else hot_ref
        refs[phys] -= 1
        if refs[phys] == 0:                # PageTable._release: memo death
            if tier == 0:
                twin = cold_twin.pop(phys, None)
                if twin is not None:
                    twin_of.pop(twin, None)
            else:
                src = twin_of.pop(phys, None)
                if src is not None:
                    cold_twin.pop(src, None)

    def free_slot(s):
        for t, p in zip(ptier[s], ptab[s]):
            release(t, p)
        ptab[s], ptier[s] = [], []

    def alloc(s):
        p = fresh()
        hot_ref[p] = 1
        ptab[s].append(p)
        ptier[s].append(0)

    def share(s, donor_slot, n):
        for i in range(n):
            p, t = ptab[donor_slot][i], ptier[donor_slot][i]
            (cold_ref if t else hot_ref)[p] += 1
            ptab[s].append(p)
            ptier[s].append(t)

    def cold_pages(s):
        c = 0
        for t in ptier[s]:
            if t != 1:
                break
            c += 1
        return c

    def note():
        per_t: dict = {}
        per_d: dict = {}
        for s in range(slots):
            hot = {p for p, t in zip(ptab[s], ptier[s]) if t == 0}
            per_d.setdefault(dev(s), set()).update(hot)
            tn = slot_tn(s)
            if tn is not None:
                per_t.setdefault(tn, set()).update(hot)
        for tn, pages in per_t.items():
            v = len(pages) * pg * row_bytes
            if v > peaks.get(tn, 0):
                peaks[tn] = v
        for d, pages in per_d.items():
            v = len(pages) * pg * row_bytes
            if v > dev_peaks.get(dev_name(d), 0):
                dev_peaks[dev_name(d)] = v

    def demote_one(s):
        # PageTable.demote: first sharer copies and memoizes a cold twin,
        # later sharers reuse it — shared bytes migrate exactly once
        nonlocal mig, copies
        idx = cold_pages(s)
        src = ptab[s][idx]
        twin = cold_twin.get(src)
        if twin is not None and cold_ref.get(twin, 0) > 0:
            cold_ref[twin] += 1
            cold_phys, copied = twin, False
        else:
            cold_phys = fresh()
            cold_ref[cold_phys] = 1
            copied = True
            if hot_ref[src] > 1:           # others still share: memoize
                cold_twin[src] = cold_phys
                twin_of[cold_phys] = src
        release(0, src)
        ptab[s][idx] = cold_phys
        ptier[s][idx] = 1
        if copied:
            mig += pg * row_bytes
            copies += 1

    def demote_to(s, target):
        while cold_pages(s) * pg < target:
            demote_one(s)

    def start_slot(s, prompt_len, toks, pk):
        # _start_job / _admit_pool head: stale donor registrations for the
        # slot die with its pages, then prefix-share against the donor —
        # intra-shard only (MeshPageTable refuses cross-device aliasing)
        for key in [k for k, (ds, _) in donors.items() if ds == s]:
            del donors[key]
        free_slot(s)
        shared = 0
        if pk is not None:
            donor = donors.get(pk)
            if donor is not None and donor[0] != s and ptab[donor[0]] \
                    and dev(donor[0]) == dev(s):
                lcp = 0
                for a, b in zip(toks, donor[1]):
                    if a != b:
                        break
                    lcp += 1
                cap = lcp // pg
                if not dense_admit:        # the suffix pass computes >= 1 row
                    cap = min(cap, (prompt_len - 1) // pg)
                shared = min(cap, len(ptab[donor[0]]))
                if shared:
                    share(s, donor[0], shared)
            donors[pk] = (s, toks)
        return shared

    schedule = sorted(((int(t), p) for t, p in plan_schedule),
                      key=lambda e: e[0])
    # slot -> [done, prompt, decode, started, tokens, prefix_key]
    jobs: dict = {}
    while queue or jobs or any(active):
        mig0 = mig
        while schedule and schedule[0][0] <= len(step_mig):
            _, nxt = schedule.pop(0)       # ContinuousBatcher.apply_plan
            if hasattr(nxt, "changes"):    # a PlanDelta, not a plan
                nxt = plan.apply_delta(nxt)
            plan = nxt
            tenants = getattr(plan, "slot_tenants", None)
            if tenants:
                if len(tenants) != slots:
                    raise ValueError(
                        f"slot_tenants has {len(tenants)} entries for "
                        f"{slots} slots (plan/batch geometry mismatch)")
                slot_tenants = list(tenants)
            for s in range(slots):
                if active[s]:
                    demote_to(s, plan.cold_len_slot(s, host_len[s], pg))
            new_sd = getattr(plan, "slot_devices", None)
            if new_sd and slot_devices and list(new_sd) != slot_devices:
                # slot re-homing: the demoted-first hot tail crosses the
                # shard<->shard edge (MeshPageTable.migrate_slot; cold pages
                # move host-internally and never touch a device edge)
                if len(new_sd) != slots:
                    raise ValueError(
                        f"slot_devices has {len(new_sd)} entries for "
                        f"{slots} slots")
                for s in range(slots):
                    if new_sd[s] == slot_devices[s]:
                        continue
                    if active[s]:
                        hot = sum(1 for t in ptier[s] if t == 0)
                        key = (dev_name(slot_devices[s]),
                               dev_name(new_sd[s]))
                        edge_bytes[key] = edge_bytes.get(key, 0.0) \
                            + hot * pg * row_bytes
                        # migrate_slot lands *exclusive* pages on the
                        # destination and releases the source refs (any
                        # remaining sharers keep the source pages, twin
                        # memos die with the refs)
                        moved = []
                        for t_, p in zip(ptier[s], ptab[s]):
                            release(t_, p)
                            p2 = fresh()
                            (cold_ref if t_ else hot_ref)[p2] = 1
                            moved.append(p2)
                        ptab[s] = moved
                    elif s not in jobs and ptab[s]:
                        # a finished slot's stale pages are dropped on
                        # ownership change, not copied across the edge
                        free_slot(s)
                slot_devices = list(new_sd)
            note()
        for s in range(slots):             # ContinuousBatcher._admit: bind
            if active[s] or s in jobs or not queue:
                continue
            tn_s = slot_tn(s)
            qi = next((i for i, q in enumerate(queue)
                       if tn_s is None or q[2] is None or q[2] == tn_s),
                      None)
            if qi is None:
                continue
            p, d, _, toks, pk = queue.pop(qi)
            jobs[s] = [0, p, d, False, toks, pk]   # queued -> prefilling(0)
        spent = 0                          # _drain_prefill: slot order,
        stop = False                       # page-aligned chunks, one budget
        for s in sorted(jobs):
            if stop:
                break
            job = jobs[s]
            while s in jobs:
                if prefill_chunk_tokens and spent >= prefill_chunk_tokens:
                    stop = True            # resume next step, all slots
                    break
                if not job[3]:             # _start_job: free + prefix share
                    job[0] = start_slot(s, job[1], job[4], job[5]) * pg
                    job[3] = True
                done, p = job[0], job[1]
                pages_left = -(-(p - done) // pg)
                take = pages_left if not prefill_chunk_tokens else \
                    min(pages_left,
                        max(1, (prefill_chunk_tokens - spent) // pg))
                end = min(p, done + take * pg)
                spent += end - done
                new = -(-end // pg) - len(ptab[s])
                if new:
                    admit_writes += new
                    key = ("prefill", dev_name(dev(s)))
                    edge_bytes[key] = edge_bytes.get(key, 0.0) \
                        + new * pg * row_bytes
                    for _ in range(new):
                        alloc(s)
                job[0] = end
                if end >= p:               # _finish_job -> active
                    del jobs[s]
                    demote_to(s, plan.cold_len_slot(s, p, pg))
                    host_len[s], active[s], budget[s] = p, True, job[2] - 1
                    note()
        if not any(active):
            if jobs:
                step_mig.append(mig - mig0)  # prefill-only step
                continue
            break
        for s in range(slots):             # pool.ensure_write_page
            if active[s] and len(ptab[s]) * pg < host_len[s] + 1:
                alloc(s)
        for s in range(slots):             # post-forward boundary advance
            if active[s]:
                demote_to(s, plan.cold_len_slot(s, host_len[s] + 1, pg))
        note()
        for s in range(slots):
            if active[s]:
                host_len[s] += 1
                budget[s] -= 1
                if budget[s] <= 0:
                    active[s] = False
        step_mig.append(mig - mig0)        # one engine decode step's delta
    # xdev_migration_bytes: the planner's predicted device<->device edge
    # traffic under prefill/decode disaggregation — every *private* admitted
    # page is prefilled on the prefill group and crosses the edge exactly
    # once; shared-prefix pages stay put on the decode side and never cross
    # (serve/disagg.py's MeshPageTable ledger matches it integer-exactly)
    return {"migration_bytes": mig, "page_copies": copies,
            "admit_page_writes": admit_writes, "tenant_hot_peak": peaks,
            "step_migration_bytes": step_mig,
            "device_hot_peak": dev_peaks,
            "edge_migration_bytes": edge_bytes,
            "xdev_migration_bytes": admit_writes * pg * row_bytes}


def serve_trace_for(cfg, requests: Sequence[tuple], *, slots: int,
                    params=None, block_tokens: int = 16,
                    recent_window: int = 32, history_period: int = 4,
                    dtype_bytes: int = 2, layer_group: int = 1,
                    shared_prefix_tokens: int = 0):
    """Build the serving-phase trace (hmsim.ServeTrace) for this model and
    request stream — the profiling step of the decode-phase planner.  KV
    bytes/token come from the cache geometry; weight bytes and flops/token
    from the parameter count (2N MACs/token) when ``params`` is given, else
    from the config's dense-layer dimensions.  ``layer_group`` coarsens the
    object granularity to one KV block per *group* of layers (same total
    bytes, fewer objects) — the simulator cost scales with object count while
    the byte geometry is what decides placement quality.

    Requests may be ``(prompt, decode)`` or ``(prompt, decode, prefix_id)``;
    with ``shared_prefix_tokens > 0``, requests carrying the same prefix_id
    share the KV blocks of their first ``shared_prefix_tokens`` prompt
    tokens (tagged via ``KVObject.shared_key`` — the trace-level mirror of
    the engine's physical page sharing)."""
    kv_tok = kvcache.kv_token_bytes(cfg, dtype_bytes)
    layers = max(1, -(-cfg.num_layers // max(1, layer_group)))
    if params is not None:
        n_params = sum(p.numel() for p in params.parameters())
    else:
        n_params = (12 * cfg.num_layers * cfg.d_model ** 2
                    + cfg.vocab_size * cfg.d_model)
    with telemetry.span("plan.profile"):
        return hmsim.build_serve_trace(
            requests, num_slots=slots, num_layers=layers,
            kv_token_bytes=kv_tok * cfg.num_layers / layers,
            block_tokens=block_tokens,
            recent_window=recent_window, history_period=history_period,
            flops_per_token=2.0 * n_params,
            weight_bytes=float(n_params) * dtype_bytes,
            shared_prefix_tokens=shared_prefix_tokens)


def generate(params, cfg, prompts, num_tokens: int,
             scfg: Optional[ServeConfig] = None, generator=None):
    """Prefill ``prompts["tokens"]`` (B, S), or (B, S, K) for codebooks,
    after ``prompts["prefix_embed"]`` (B, P, d) where given, into a dense
    cache, then decode ``num_tokens`` tokens per row in lockstep.  Returns
    (B, num_tokens), or (B, num_tokens, K).  Temperature sampling draws
    from ``generator`` (a ``torch.Generator`` on the prompts' device);
    JAX's random stream is not reproduced."""
    scfg = scfg or ServeConfig()
    S = prompts["tokens"].shape[1] + (
        cfg.num_prefix_tokens if "prefix_embed" in prompts else 0)
    max_seq = max(scfg.max_seq, S + num_tokens)
    last, caches = model.prefill(params, cfg, prompts, max_seq=max_seq)
    step_fn = make_serve_step(cfg)
    tok = sample(last[..., :cfg.vocab_size], generator, scfg.temperature)
    outs = [tok]
    for i in range(num_tokens - 1):
        logits, caches = step_fn(params, tok[:, None], caches, S + i)
        tok = sample(logits[..., :cfg.vocab_size], generator,
                     scfg.temperature)
        outs.append(tok)
    return torch.stack(outs, dim=1)
