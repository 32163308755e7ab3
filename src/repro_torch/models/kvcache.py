"""Persistent KV page pools for serving (port of the pools half of
``repro/models/kvcache.py``): the refcounted ``PageTable`` allocator, the
``PagedKVPools`` storage the paged decode kernel reads, and
``kv_token_bytes``.

Hot pools live in device memory and cold pools in pinned host memory, which
the decode kernel reads directly.  Every write into a cold pool is a
stream-ordered ``copy_(..., non_blocking=True)`` issued from the device side
of the current stream, never a CPU-side store: a cold page freed and
reallocated while an earlier decode kernel still reads it is protected by
stream order alone.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def kv_token_bytes(cfg, dtype_bytes: int = 2) -> float:
    """Mean KV-cache bytes per token per layer (every layer of a dense
    ATTN/LOCAL stack holds K and V), so ``kv_token_bytes(cfg) *
    cfg.num_layers`` is the model's per-token KV growth."""
    return float(2 * cfg.num_kv_heads * cfg.head_dim * dtype_bytes)


class PageTable:
    """Slot-local logical->physical page mapping over two physical pools —
    a physical-page allocator with reference counting (the port's own copy
    of ``repro.models.kvcache.PageTable``).

    Pages are ``page_tokens`` tokens of KV.  Each slot owns an ordered list
    of logical pages; page i lives either in the hot pool (tier 0) or the
    cold pool (tier 1).  Invariant: the cold pages of a slot form a prefix of
    its logical pages (the cold *boundary*), and within one residency a
    slot's boundary only moves forward.

    Sharing: ``share(dst, src, n)`` maps the first n logical pages of
    ``dst`` onto ``src``'s physical pages, bumping refcounts.  A shared page
    is read-only; the first divergent write goes through ``cow``.  Demoting
    a shared page gives the demoting slot a cold *twin*, memoized per hot
    page, so N sharers demoting one logical page move its bytes once.

    ``version`` increments on every mutation; callers caching ``as_arrays``
    output re-upload only when it changes.
    """

    FREE = -1

    def __init__(self, slots: int, pages_per_slot: int, page_tokens: int):
        self.slots, self.pages_per_slot = slots, pages_per_slot
        self.page_tokens = page_tokens
        # each pool can hold every slot's every page
        self.n_hot = self.n_cold = slots * pages_per_slot
        self.hot_free = list(range(self.n_hot - 1, -1, -1))
        self.cold_free = list(range(self.n_cold - 1, -1, -1))
        self.hot_ref = [0] * self.n_hot
        self.cold_ref = [0] * self.n_cold
        self.table = [[self.FREE] * pages_per_slot for _ in range(slots)]
        self.tier = [[self.FREE] * pages_per_slot for _ in range(slots)]
        self.n_pages = [0] * slots
        self.cold_twin: Dict[int, int] = {}      # hot phys -> cold twin phys
        self._twin_of: Dict[int, int] = {}       # cold phys -> hot phys
        self.version = 0

    # ------------------------------------------------------------ queries --
    def cold_pages(self, slot: int) -> int:
        """Pages below the slot's cold boundary."""
        t = self.tier[slot]
        n = 0
        while n < self.n_pages[slot] and t[n] == 1:
            n += 1
        return n

    def cold_tokens(self, slot: int) -> int:
        return self.cold_pages(slot) * self.page_tokens

    def _refs(self, tier: int):
        return self.cold_ref if tier == 1 else self.hot_ref

    def _free(self, tier: int):
        return self.cold_free if tier == 1 else self.hot_free

    def refcount(self, slot: int, page_idx: int) -> int:
        return self._refs(self.tier[slot][page_idx])[
            self.table[slot][page_idx]]

    def is_shared(self, slot: int, page_idx: int) -> bool:
        return self.refcount(slot, page_idx) > 1

    def as_arrays(self, device):
        """(page_table, page_tier) int32 tensors (slots, pages_per_slot) on
        ``device``, for kernels/paged_decode.py."""
        return (torch.tensor(self.table, dtype=torch.int32, device=device),
                torch.tensor(self.tier, dtype=torch.int32, device=device))

    # ---------------------------------------------------------- mutations --
    def _acquire(self, tier: int) -> int:
        pool = self._free(tier)
        if not pool:
            raise ValueError(f"{'cold' if tier else 'hot'} pool exhausted")
        phys = pool.pop()
        self._refs(tier)[phys] = 1
        return phys

    def _release(self, tier: int, phys: int) -> None:
        refs = self._refs(tier)
        refs[phys] -= 1
        if refs[phys] < 0:
            raise AssertionError(f"tier {tier} page {phys}: negative refcount")
        if refs[phys] == 0:
            self._free(tier).append(phys)
            if tier == 0:
                # hot page gone: its cold twin (if any) lives on through its
                # own refs, but can no longer be reached for dedup
                twin = self.cold_twin.pop(phys, None)
                if twin is not None:
                    self._twin_of.pop(twin, None)
            else:
                src = self._twin_of.pop(phys, None)
                if src is not None:
                    self.cold_twin.pop(src, None)

    def alloc(self, slot: int, tier: int) -> int:
        """Append one logical page to ``slot`` in the given tier; returns the
        physical page id.  Raises when the slot or the pool is exhausted."""
        i = self.n_pages[slot]
        if i >= self.pages_per_slot:
            raise ValueError(f"slot {slot}: pages_per_slot exhausted")
        if tier == 1 and i != self.cold_pages(slot):
            raise ValueError(f"slot {slot}: cold alloc would break the "
                             "cold-prefix invariant")
        phys = self._acquire(tier)
        self.table[slot][i] = phys
        self.tier[slot][i] = tier
        self.n_pages[slot] = i + 1
        self.version += 1
        return phys

    def share(self, dst: int, src: int, n: int) -> int:
        """Map the first ``n`` logical pages of empty slot ``dst`` onto
        ``src``'s physical pages.  Refcounts bump; tiers are inherited from
        ``src``.  Returns the number of pages shared."""
        if self.n_pages[dst]:
            raise ValueError(f"slot {dst}: share requires an empty slot")
        if n > self.n_pages[src]:
            raise ValueError(f"slot {src}: only {self.n_pages[src]} pages "
                             f"allocated, cannot share {n}")
        for i in range(n):
            phys, tier = self.table[src][i], self.tier[src][i]
            self._refs(tier)[phys] += 1
            self.table[dst][i] = phys
            self.tier[dst][i] = tier
        self.n_pages[dst] = n
        if n:
            self.version += 1
        return n

    def cow(self, slot: int, page_idx: int) -> Optional[tuple]:
        """Copy-on-write: give ``slot`` a private physical page for logical
        page ``page_idx`` before a divergent write.  Returns None when the
        page is already exclusive, else ``(src_phys, new_phys, tier)`` — the
        caller copies the page's data from src to new in that tier's pool."""
        if page_idx >= self.n_pages[slot]:
            raise ValueError(f"slot {slot}: page {page_idx} not allocated")
        if not self.is_shared(slot, page_idx):
            return None
        tier = self.tier[slot][page_idx]
        src = self.table[slot][page_idx]
        new = self._acquire(tier)
        self._refs(tier)[src] -= 1
        self.table[slot][page_idx] = new
        self.version += 1
        return (src, new, tier)

    def free_slot(self, slot: int) -> int:
        """Release every page reference of ``slot``; a physical page returns
        to its free list when its last reference drops.  Returns the number
        of references released."""
        n = self.n_pages[slot]
        for i in range(n):
            self._release(self.tier[slot][i], self.table[slot][i])
            self.table[slot][i] = self.tier[slot][i] = self.FREE
        self.n_pages[slot] = 0
        if n:
            self.version += 1
        return n

    def demote(self, slot: int, page_idx: int) -> tuple:
        """Move the page at the slot's cold boundary hot->cold.  Exclusive
        page: hot page freed, cold page allocated, data must be copied.
        Shared page: the demoting slot gets a cold twin, allocated and
        copied on the first demotion and reused by later sharers.  Returns
        ``(cold_phys, src_hot_phys, copied)``."""
        if page_idx != self.cold_pages(slot):
            raise ValueError(f"slot {slot}: demote({page_idx}) is not the "
                             f"cold boundary {self.cold_pages(slot)}")
        if page_idx >= self.n_pages[slot]:
            raise ValueError(f"slot {slot}: page {page_idx} not allocated")
        src = self.table[slot][page_idx]
        twin = self.cold_twin.get(src)
        if twin is not None and self.cold_ref[twin] > 0:
            self.cold_ref[twin] += 1
            cold_phys, copied = twin, False
        else:
            if not self.cold_free:
                raise ValueError("cold pool exhausted")
            cold_phys = self._acquire(1)
            copied = True
            if self.hot_ref[src] > 1:        # others still share: memoize
                self.cold_twin[src] = cold_phys
                self._twin_of[cold_phys] = src
        self._release(0, src)
        self.table[slot][page_idx] = cold_phys
        self.tier[slot][page_idx] = 1
        self.version += 1
        return (cold_phys, src, copied)

    def check(self) -> None:
        """Raise on a broken structural invariant (used by the tests)."""
        import collections as _c
        for tier, pool, refs in ((0, self.hot_free, self.hot_ref),
                                 (1, self.cold_free, self.cold_ref)):
            used = _c.Counter(self.table[s][i] for s in range(self.slots)
                              for i in range(self.n_pages[s])
                              if self.tier[s][i] == tier)
            for phys, r in enumerate(refs):
                if r < 0 or used.get(phys, 0) != r:
                    raise AssertionError(
                        f"tier {tier}: page {phys} refcount {r} != "
                        f"{used.get(phys, 0)} references")
            if set(used) & set(pool):
                raise AssertionError(f"tier {tier}: used page on free list")
        for s in range(self.slots):
            n, nc = self.n_pages[s], self.cold_pages(s)
            if not (all(self.tier[s][i] == 0 for i in range(nc, n)) and
                    all(self.table[s][i] == self.FREE
                        for i in range(n, self.pages_per_slot))):
                raise AssertionError(f"slot {s}: broken page row")
        for src, twin in self.cold_twin.items():
            if not (self.hot_ref[src] > 0 and self.cold_ref[twin] > 0
                    and self._twin_of.get(twin) == src):
                raise AssertionError(f"stale twin memo {src} -> {twin}")


class PagedKVPools:
    """Persistent physical KV page pools — the storage paged decode reads.

    For the ``L`` attention layers the storage is

      k_hot / v_hot    (L, n_hot+1, page, KV*hd)   device memory
      k_cold / v_cold  (L, n_cold,  page, KV*hd)   pinned host memory
                                                   (plain host memory when
                                                   the device is the CPU)

    addressed through one layer-independent :class:`PageTable`.  ``tree``
    holds one ``{"k_hot", "v_hot", "k_cold", "v_cold"}`` dict of per-layer
    views, the cache the model's forward reads and writes in place.  The
    hot page at index ``garbage`` (= n_hot) absorbs the lockstep writes of
    inactive slots.

    ``stats`` counts ``repacks`` (never in this design), ``table_uploads``
    (layout deltas), ``page_copies`` (demote / CoW data movement) and
    ``admit_page_writes`` (prefill landing in the pools).
    """

    def __init__(self, cfg, slots: int, max_seq: int, page_tokens: int,
                 dtype, device):
        if max_seq % page_tokens:
            raise ValueError(f"max_seq {max_seq} is not a whole number of "
                             f"{page_tokens}-token pages")
        self.cfg, self.num_slots = cfg, slots
        self.device = torch.device(device)
        self.max_seq, self.page_tokens = max_seq, page_tokens
        self.num_pages = max_seq // page_tokens
        self.table = PageTable(slots, self.num_pages, page_tokens)
        self.garbage = self.table.n_hot          # scratch page, never mapped
        L, D = cfg.num_layers, cfg.num_kv_heads * cfg.head_dim
        hot = (L, self.table.n_hot + 1, page_tokens, D)
        cold = (L, self.table.n_cold, page_tokens, D)
        pin = self.device.type == "cuda"
        self.k_hot = torch.zeros(hot, dtype=dtype, device=self.device)
        self.v_hot = torch.zeros(hot, dtype=dtype, device=self.device)
        self.k_cold = torch.zeros(cold, dtype=dtype, pin_memory=pin)
        self.v_cold = torch.zeros(cold, dtype=dtype, pin_memory=pin)
        self.tree = [{"k_hot": self.k_hot[l], "v_hot": self.v_hot[l],
                      "k_cold": self.k_cold[l], "v_cold": self.v_cold[l]}
                     for l in range(L)]
        self._cached_arrays = None
        self._cached_version = -1
        # event recorded after the last stream-ordered cold-pool write; a
        # host-side read of the cold pools waits on it (sync_cold)
        self._cold_written = None
        self.stats = {"repacks": 0, "table_uploads": 0, "page_copies": 0,
                      "admit_page_writes": 0}

    def _copy_into_cold(self, dst_pool, dst: int, src_pool, src: int):
        """dst_pool[:, dst] = src_pool[:, src], one contiguous page per
        layer, stream-ordered.  A cold source goes through the device (H2D
        then D2H) so no CPU thread ever touches the pinned pool."""
        for l in range(dst_pool.shape[0]):
            page = src_pool[l, src].to(self.device, non_blocking=True)
            dst_pool[l, dst].copy_(page, non_blocking=True)
        if self.device.type == "cuda":
            self._cold_written = torch.cuda.Event()
            self._cold_written.record()

    def sync_cold(self):
        """Wait until every issued cold-pool write has landed — before a
        host-side read of the cold pools (the prefill gather)."""
        if self._cold_written is not None:
            self._cold_written.synchronize()
            self._cold_written = None

    # -------------------------------------------------------------- layout --
    def arrays(self):
        """(page_table, page_tier) device tensors, re-uploaded only when the
        PageTable mutated since the last call."""
        if self._cached_version != self.table.version:
            self._cached_arrays = self.table.as_arrays(self.device)
            self._cached_version = self.table.version
            self.stats["table_uploads"] += 1
        return self._cached_arrays

    def host_row(self, slot: int):
        """The slot's (page_table, page_tier) rows as (1, NP) host tensors:
        the host-side index the prefill gather reads the cold pool with."""
        return (torch.tensor([self.table.table[slot]], dtype=torch.long),
                torch.tensor([self.table.tier[slot]], dtype=torch.long))

    def paged_view(self, active_mask) -> dict:
        """The per-step view models/attention.py consumes; everything in it
        is cached or a python constant."""
        table_arr, tier_arr = self.arrays()
        return {"page_table": table_arr, "page_tier": tier_arr,
                "page_tokens": self.page_tokens, "active": active_mask,
                "garbage_page": self.garbage}

    # ----------------------------------------------------------- mutations --
    def ensure_write_page(self, slot: int, pos: int) -> None:
        """Pre-step guarantee for the decode write at token ``pos``: the page
        holding ``pos`` exists and is private (CoW on a shared page)."""
        while self.table.n_pages[slot] * self.page_tokens < pos + 1:
            self.table.alloc(slot, 0)
        self.cow_for_write(slot, pos)

    def cow_for_write(self, slot: int, pos: int) -> bool:
        """Copy-on-write before a divergent write at token ``pos``; no-op on
        exclusive pages.  Returns True when a private copy was made."""
        idx = pos // self.page_tokens
        if idx >= self.table.n_pages[slot]:
            return False
        r = self.table.cow(slot, idx)
        if r is None:
            return False
        src, new, tier = r
        if tier == 1:
            self._copy_into_cold(self.k_cold, new, self.k_cold, src)
            self._copy_into_cold(self.v_cold, new, self.v_cold, src)
        else:
            # in place (the reference's .at[:, new].set(pool[:, src]))
            self.k_hot[:, new] = self.k_hot[:, src]
            self.v_hot[:, new] = self.v_hot[:, src]
        self.stats["page_copies"] += 1
        return True

    def demote_boundary(self, slot: int) -> bool:
        """Advance the slot's cold boundary one page.  Pool data moves
        hot->cold only when the PageTable allocated a fresh cold copy
        (exclusive page, or the first sharer to demote).  Returns whether
        data was copied."""
        idx = self.table.cold_pages(slot)
        cold_phys, src, copied = self.table.demote(slot, idx)
        if copied:
            self._copy_into_cold(self.k_cold, cold_phys, self.k_hot, src)
            self._copy_into_cold(self.v_cold, cold_phys, self.v_hot, src)
            self.stats["page_copies"] += 1
        return copied
