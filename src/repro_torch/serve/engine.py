"""Continuous-batching serving engine on the persistent-pools layout (port
of ``repro/serve/engine.py::ContinuousBatcher`` with ``paged=True`` and
``cfg.use_paged_decode``, the one layout ported: here it is unconditional).

The physical page pools (models/kvcache.PagedKVPools) ARE the cache: hot
pages in device memory, cold pages in pinned host memory, one refcounted
PageTable mapping every slot's logical pages.  Admission is a per-slot state
machine (``queued -> prefilling -> active``): prompts are prefilled in
page-aligned chunks straight into the slot's pages, and a request with a
``prefix_key`` maps the donor's full prompt pages instead of computing them.
Decode writes each token's KV through the table and reads the pools with
the paged decode kernel; each slot's cold boundary advances one page at a
time as its hot window slides, under the plan's per-slot windows.

``sim_migration_bytes`` counts every byte moved device->host, and
``counters()`` exports the same integer books the reference engine keeps.
The dense and concat layouts and the paged-merged layout are not ported yet
(ROADMAP, modules to port: item 7).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ATTN, LOCAL
from repro_torch.device import resolve
from repro_torch.models import kvcache, model


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


class ContinuousBatcher:
    """Slot-based continuous batching over a fixed B-slot decode batch: all
    slots decode in lockstep against per-slot lengths, and finished or
    empty slots are refilled from per-tenant request queues.  ``plan`` (a
    serve/plan.ServingPlan) sets the page size, every slot's hot window,
    the per-step prefill budget and the slots' tenants."""

    def __init__(self, params, cfg, batch_slots: int, max_seq: int, plan,
                 device=None):
        kinds = set(cfg.prologue) | set(cfg.period)
        if not kinds <= {ATTN, LOCAL}:
            raise NotImplementedError(
                f"{cfg.name}: the engine serves ATTN/LOCAL stacks only; the "
                "cached path of other layer kinds is not ported yet "
                "(ROADMAP, modules to port: items 7 and 9)")
        self.device = resolve(device)
        p_dev = next(params.parameters()).device
        if p_dev != self.device:
            raise ValueError(f"params live on {p_dev}, engine on "
                             f"{self.device}")
        self.params, self.cfg = params, cfg
        self.B, self.max_seq = batch_slots, max_seq
        self.plan = plan
        self.prefill_chunk_tokens = int(plan.prefill_chunk_tokens)
        # a tenant's requests admit only into the tenant's own slots
        self.slot_tenants = list(plan.slot_tenants) if plan.slot_tenants \
            else None
        if self.slot_tenants and len(self.slot_tenants) != batch_slots:
            raise ValueError(
                f"slot_tenants has {len(self.slot_tenants)} entries for "
                f"{batch_slots} batch slots (plan/batch geometry mismatch)")
        self.tenant_hot_peak: dict = {}        # tenant -> peak hot pool bytes
        self._tenant_note_version = -1         # last-sampled table version
        dt = model.param_dtype(cfg)
        self._row_bytes = kvcache.kv_token_bytes(
            cfg, torch.finfo(dt).bits // 8) * cfg.num_layers
        self.sim_migration_bytes = 0.0         # device->host cold traffic
        # per-step deltas of sim_migration_bytes, tracked against a
        # persistent marker so bytes moved between steps (apply_plan) land
        # in the next step's entry: sum(series) == total always
        self.step_migration_bytes: list = []
        self._mig_accounted = 0.0
        page = max(1, plan.page_tokens)
        if max_seq % page:                     # buffer must tile in pages
            page = next(p for p in range(page, 0, -1) if max_seq % p == 0)
        self.page_tokens = page
        self.pool = kvcache.PagedKVPools(cfg, batch_slots, max_seq, page, dt,
                                         self.device)
        self.ptable = self.pool.table
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
        self._jobs: dict = {}                  # slot -> _PrefillJob
        self._step_prefill = 0                 # prompt tokens run this step
        self.step_prefill_tokens: list = []
        self.prefill_compute_tokens = 0        # prompt rows actually run
        self.prefill_skipped_tokens = 0        # rows skipped via shared pages
        self.decode_steps = 0                  # steps that ran a decode

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
        if not self.slot_tenants:
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

    def _demote_to_target(self, slot: int, seq_len: int):
        """Demote the slot's boundary page by page to the plan's target;
        twin-deduped shared pages advance it with zero copy."""
        target = self._slot_cold_target(slot, seq_len)
        while self.ptable.cold_tokens(slot) < target:
            if self.pool.demote_boundary(slot):
                self.sim_migration_bytes += self.page_tokens * self._row_bytes

    def _admit(self):
        """Bind queued requests to free slots, then advance pending
        prefill."""
        for slot in range(self.B):
            if self.active[slot] or slot in self._jobs:
                continue
            item = self._pop_for_slot(slot)
            if item is None:
                continue
            _, tokens, tok_host, budget, prefix_key, tenant = item
            self._jobs[slot] = _PrefillJob(tokens, tok_host,
                                           int(tokens.shape[-1]), budget,
                                           prefix_key, tenant)
        if self._jobs:
            self._drain_prefill()

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
                self._run_chunk(slot, job, end)
                if job.done >= job.S:
                    self._finish_job(slot, job)

    def _start_job(self, slot: int, job: _PrefillJob):
        """First touch of a job: free the slot's old pages, map shared-prefix
        full pages onto the donor's (their compute is skipped), and register
        this prompt as the key's new donor."""
        pg = self.page_tokens
        for key in [k for k, (s, _) in self._prefix_donor.items()
                    if s == slot]:
            del self._prefix_donor[key]
        self.ptable.free_slot(slot)
        shared = 0
        if job.prefix_key is not None:
            donor = self._prefix_donor.get(job.prefix_key)
            if donor is not None and donor[0] != slot and \
                    self.ptable.n_pages[donor[0]] > 0:
                lcp = 0
                for a, b in zip(job.tok_host, donor[1]):
                    if a != b:
                        break
                    lcp += 1
                # full pages of common prefix, pages the donor holds, and
                # strictly below the prompt's last token (the suffix pass
                # computes at least the next-token row)
                shared = min(lcp // pg, self.ptable.n_pages[donor[0]],
                             (job.S - 1) // pg)
                if shared:
                    self.ptable.share(slot, donor[0], shared)
            self._prefix_donor[job.prefix_key] = (slot, job.tok_host)
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
        for _ in range(first, -(-end // pg)):
            self.ptable.alloc(slot, 0)
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
        logits = model.forward(
            self.params, self.cfg, {"tokens": self.last_tok[:, None]},
            caches=self.pool.tree, cache_index=self.lengths, decode=True,
            paged_view=paged_view)
        for s in range(self.B):
            if self.active[s]:
                self._demote_to_target(s, self._host_len[s] + 1)
        self._note_tenant_pages()
        return torch.argmax(logits[:, -1, :self.cfg.vocab_size], dim=-1)

    def step(self):
        """Admission, then one lockstep decode step across all active
        slots; each slot writes its KV at its own length.  Returns False
        when there was nothing to do."""
        self._step_prefill = 0
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
        tok = self._pool_decode_step()
        self.decode_steps += 1
        self.last_tok = tok
        self.lengths = self.lengths + self._active_inc
        tok_host = tok.tolist()                # the decoded tokens themselves
        was_active = list(self.active)
        for slot in range(self.B):
            if not was_active[slot]:
                continue
            self._host_len[slot] += 1
            self.outputs[slot].append(tok_host[slot])
            self.budget[slot] -= 1
            if self.budget[slot] <= 0:
                self.active[slot] = False
        if self.active != was_active:
            self._refresh_active()
        self.step_prefill_tokens.append(self._step_prefill)
        self.step_migration_bytes.append(
            self.sim_migration_bytes - self._mig_accounted)
        self._mig_accounted = self.sim_migration_bytes
        return True

    def apply_plan(self, new_plan):
        """Adopt a whole re-plan between decode steps: re-target every
        active slot's cold boundary under the new windows (page-grain
        demotions; grown windows promote nothing) and re-partition slot
        tenancy.  Returns the migration bytes moved, attributed to the next
        step's ``step_migration_bytes`` entry."""
        if hasattr(new_plan, "changes"):
            raise NotImplementedError(
                "incremental PlanDeltas are not ported yet (ROADMAP, modules "
                "to port: item 6); pass a whole plan")
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
               "table_version": self.ptable.version,
               "prefill_compute_tokens": self.prefill_compute_tokens,
               "prefill_skipped_tokens": self.prefill_skipped_tokens,
               "prefill_read_bytes":
                   self.prefill_skipped_tokens * self._row_bytes,
               "step_prefill_tokens": list(self.step_prefill_tokens),
               "decode_steps": self.decode_steps}
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
