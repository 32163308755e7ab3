"""Cache construction for serving (port of ``repro/models/kvcache.py``):
the dense per-layer caches and their tiered forms, the refcounted
``PageTable`` allocator, the ``MeshPageTable`` that puts one table per
device under one slot namespace (the disaggregated engine's), and the
``PagedKVPools`` storage the paged decode kernel reads.

A dense cache is a list with one entry per layer, prologue first, as the
port's loop over layers runs them (the reference stacks the period layers
on a leading axis; the port has no such axis): an attention layer holds
{"k", "v"} (B, max_seq, KV*hd), an MLA layer its latent {"ckv", "krope"}
(B, max_seq, kv_lora_rank / qk_rope_dim), a MAMBA layer {"h", "conv"}
(``ssm.init_mamba_cache``), an MLSTM, SLSTM or LSTM layer its recurrent
state as flat leaves (``xlstm.init_*_cache``; the reference holds a
tuple).  "k", "v", "ckv" and "krope" are the sequence leaves the tiered
forms split; the reference recognises them by shape (a leaf whose
second-to-last dim equals max_seq), the port by name, so a state leaf is
never split here, whatever max_seq is.  The reference's ``.at[].set``
splices are in-place writes here, and a ``None`` leaf is a tier that
holds no copy of that leaf.

Tiers: the *concat* layout (``TieredCache``) splits every sequence leaf at
one global cold boundary; the *paged-merged* layout
(``PagedTieredCache``) keeps full-size hot and cold trees and a per-slot
boundary; the *pools* layout (``PagedKVPools``) keeps the attention
layers' KV as pages.  Cold storage is pinned host memory when the cache
lives on a CUDA card, and the cache itself on the CPU (``to_host`` is then
the identity, as the reference's is when the backend has no host memory
kind).  Every write into pinned memory is a copy issued on the current
stream, never a CPU-side store, so stream order protects pages a kernel
still reads.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import (ATTN, LOCAL, LSTM, MAMBA, MLA, MLSTM,
                                      SHARED_ATTN, SLSTM)
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.sharding import local_shape

ATTN_KINDS = (ATTN, LOCAL, SHARED_ATTN)
# the sequence leaves of a dense cache: GQA KV and the MLA latent
SEQ_KEYS = ("k", "v", "ckv", "krope")


def init_layer_cache(cfg, kind: str, batch: int, max_seq: int, dtype,
                     device):
    if kind in ATTN_KINDS:
        # KV heads folded into one dim, as the reference's; under a rank
        # context the rank's block of them where the rules split them
        shape = local_shape((batch, max_seq, cfg.num_kv_heads * cfg.head_dim),
                            _layer_cache_axes(kind)["k"])
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == MLA:
        # under a rank context the rank's block of the latent's columns
        ckv = local_shape((batch, max_seq, cfg.kv_lora_rank),
                          _layer_cache_axes(kind)["ckv"])
        return {"ckv": torch.zeros(ckv, dtype=dtype, device=device),
                "krope": torch.zeros(batch, max_seq, cfg.qk_rope_dim,
                                     dtype=dtype, device=device)}
    if kind == MAMBA:
        return ssm_mod.init_mamba_cache(cfg, batch, dtype, device)
    if kind == MLSTM:
        return xlstm_mod.init_mlstm_cache(cfg, batch, dtype, device)
    if kind == SLSTM:
        return xlstm_mod.init_slstm_cache(cfg, batch, dtype, device)
    if kind == LSTM:
        return xlstm_mod.init_lstm_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def init_cache(cfg, batch: int, max_seq: int, dtype, device) -> list:
    """One zeroed cache entry per layer, prologue first."""
    return [init_layer_cache(cfg, cfg.layer_kind(l), batch, max_seq, dtype,
                             device) for l in range(cfg.num_layers)]


def _layer_cache_axes(kind: str) -> dict:
    """The logical axes of each leaf of one layer's dense cache entry, as
    the reference's ``cache_logical_axes`` names them: the recurrent
    states' flat leaves take the axes of the reference's tuple members
    (mLSTM C, n, m; sLSTM c, n, m, h)."""
    if kind in ATTN_KINDS:
        return {"k": ("batch", "kv_seq", "kv_heads"),
                "v": ("batch", "kv_seq", "kv_heads")}
    if kind == MLA:
        return {"ckv": ("batch", "kv_seq", "kv_latent"),
                "krope": ("batch", "kv_seq", None)}
    if kind == MAMBA:
        return {"h": ("batch", "ssm_heads", None, None),
                "conv": ("batch", None, "ssm_heads")}
    if kind == MLSTM:
        return dict(xlstm_mod.MLSTM_AXES)
    if kind == SLSTM:
        return dict(xlstm_mod.SLSTM_AXES)
    if kind == LSTM:
        return dict(xlstm_mod.LSTM_AXES)
    raise ValueError(kind)


def cache_logical_axes(cfg) -> list:
    """Logical sharding axes for every leaf of ``init_cache``'s entries,
    one dict per layer, prologue first (the reference's, without its
    stacked ``layers`` axis)."""
    return [_layer_cache_axes(cfg.layer_kind(l))
            for l in range(cfg.num_layers)]


def _map(fn, tree):
    """``fn`` over the leaves of a per-layer cache list; None stays None."""
    return [{k: None if a is None else fn(a) for k, a in layer.items()}
            for layer in tree]


def to_host(tree):
    """Every leaf in host memory: pinned copies of CUDA tensors (a copy on
    the current stream), CPU tensors as they are."""
    def host(a):
        if not a.is_cuda:
            return a
        out = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        return out.copy_(a, non_blocking=True)
    return _map(host, tree)


def to_device(tree, device):
    """Every leaf on ``device`` (a copy on the current stream)."""
    return _map(lambda a: a.to(device, non_blocking=True), tree)


def kv_token_bytes(cfg, dtype_bytes: int = 2) -> float:
    """Mean KV-cache bytes per token per layer, averaged over ALL layers
    (stateful kinds hold O(1) state and add nothing), so
    ``kv_token_bytes(cfg) * cfg.num_layers`` is the model's per-token KV
    growth, computed as the reference computes it."""
    def one(kind):
        if kind in ATTN_KINDS:
            return 2 * cfg.num_kv_heads * cfg.head_dim * dtype_bytes
        if kind == MLA:
            return (cfg.kv_lora_rank + cfg.qk_rope_dim) * dtype_bytes
        return 0.0
    total = sum(one(k) for k in cfg.prologue) + \
        cfg.num_periods * sum(one(k) for k in cfg.period)
    return total / cfg.num_layers if cfg.num_layers else 0.0


def split_seq_cache(caches, cold_len: int):
    """Split every sequence leaf at ``cold_len``: (cold prefix, a view of
    ``caches``; hot window, a copy, so it holds no more than the window).
    Other leaves stay whole in the hot tree; their cold leaf is None."""
    cold = [{k: a[:, :cold_len] if k in SEQ_KEYS else None
             for k, a in layer.items()} for layer in caches]
    hot = [{k: a[:, cold_len:].contiguous() if k in SEQ_KEYS else a
            for k, a in layer.items()} for layer in caches]
    return cold, hot


def merge_seq_cache(cold, hot):
    """Inverse of split_seq_cache, on the hot tree's device: reading a
    host-resident cold leaf here is the streamed cold-KV fetch."""
    return [{k: h if c[k] is None else
             torch.cat([c[k].to(h.device, non_blocking=True), h], dim=1)
             for k, h in hl.items()} for c, hl in zip(cold, hot)]


def splice_slot(big_tree, one_tree, slot: int):
    """Write a batch-1 cache into row ``slot`` of a batched cache, in place
    (full, cold and hot trees alike; None leaves pass).  Returns
    ``big_tree``."""
    for big, one in zip(big_tree, one_tree):
        for k, a in big.items():
            if a is not None:
                a[slot].copy_(one[k][0], non_blocking=True)
    return big_tree


def copy_slot_rows(dst_tree, src_tree, slot: int, lo: int, hi: int):
    """dst[slot, lo:hi] = src[slot, lo:hi] on every sequence leaf, in
    place; other leaves and None pass.  The per-slot demotion and re-host
    primitive: only the named slot's rows move.  ``dst`` may be a cold
    slice whose sequence is shorter; rows [lo, hi) must be valid in both.
    Returns ``dst_tree``."""
    for dst, src in zip(dst_tree, src_tree):
        for k in SEQ_KEYS:
            if dst.get(k) is not None:
                dst[k][slot, lo:hi].copy_(src[k][slot, lo:hi],
                                          non_blocking=True)
    return dst_tree


@dataclass
class TieredCache:
    """A cache split into a host-resident cold prefix and a fast hot
    window (the concat layout)."""
    cold: Any
    hot: Any
    cold_len: int
    max_seq: int

    def merged(self):
        return merge_seq_cache(self.cold, self.hot)


def init_tiered_cache(cfg, batch: int, max_seq: int, cold_len: int, dtype,
                      device) -> TieredCache:
    """The cold KV prefix in host memory; the hot window and every
    stateful cache in device memory."""
    cold_len = max(0, min(int(cold_len), max_seq))
    return retier(init_cache(cfg, batch, max_seq, dtype, device), max_seq,
                  cold_len)


def retier(caches, max_seq: int, cold_len: int) -> TieredCache:
    """Split an existing full cache (e.g. fresh from prefill) into tiers."""
    cold, hot = split_seq_cache(caches, cold_len)
    return TieredCache(to_host(cold), hot, cold_len, max_seq)


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
    page, so N sharers demoting one logical page move its bytes once.  A
    write in place to either page of a memoized pair (``cow`` on an
    exclusive page) drops the memo, where the reference's keeps it
    (ROADMAP R11): a later sharer's demotion then copies its own page.

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

    def pages_in_use(self) -> int:
        """Distinct physical pages currently allocated across both pools."""
        return (self.n_hot - len(self.hot_free)
                + self.n_cold - len(self.cold_free))

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
            # a hot page gone: its cold twin (if any) lives on through its
            # own refs, but can no longer be reached for dedup
            self._forget_twin(tier, phys)

    def _forget_twin(self, tier: int, phys: int) -> None:
        """Drop the twin memo that holds page ``phys`` of ``tier`` (as the
        hot source or as the cold twin), if any."""
        if tier == 0:
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
        tier = self.tier[slot][page_idx]
        src = self.table[slot][page_idx]
        if not self.is_shared(slot, page_idx):
            # the caller writes this page in place: a twin memo through it
            # would hand a later sharer's demotion the new data (ROADMAP
            # R11), so the pair is forgotten
            self._forget_twin(tier, src)
            return None
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

    def splice_slot(self, slot: int, tokens: int, cold_tokens: int) -> int:
        """Refill ``slot`` with a fresh request: free its pages, then
        allocate ceil(tokens/page) pages with the first ``cold_tokens``
        worth cold.  Returns the number of cold pages allocated."""
        self.free_slot(slot)
        n = -(-tokens // self.page_tokens) if tokens else 0
        n_cold = min(n, cold_tokens // self.page_tokens)
        for i in range(n):
            self.alloc(slot, 1 if i < n_cold else 0)
        return n_cold

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


class MeshPageTable:
    """N per-device ``PageTable``s under one global logical slot namespace
    (the port's own copy of ``repro.models.kvcache.MeshPageTable``).

    The allocator view of a device mesh: device ``d``'s hot pool is its own
    device memory, its cold pool a region of the one shared host memory.
    Global slot ids are ``gslot = offset[d] + local_slot`` (offsets
    cumulative over per-device slot counts), so every logical slot names
    exactly one ``(device, slot)`` pair.

    Intra-device operations (alloc/share/cow/demote/free) delegate to the
    owning table unchanged.  ``migrate_slot`` is the cross-device tier
    transition: a slot's pages move to a slot on another device, hot pages
    crossing the device<->device edge, cold pages re-homing *inside* host
    memory (their bytes never touch a device link).  A shared page's mover
    pays a full private copy on the destination -- the source physical page
    lives on for its remaining sharers -- so after migration every migrated
    page is exclusive.

    Byte conservation: every migrated page's payload is attributed to
    exactly one ledger entry -- ``edge_bytes[(src_dev, dst_dev)]`` for hot
    pages, ``host_internal_bytes`` for cold -- and the per-device
    ``bytes_out``/``bytes_in`` ledgers always equal the edge sums
    (``check()``).  The table moves no data: the caller copies the pages.
    """

    def __init__(self, tables, names=None, page_bytes: float = 1.0):
        if not tables:
            raise ValueError("MeshPageTable needs at least one PageTable")
        self.tables = list(tables)
        self.names = list(names) if names is not None else \
            [f"dev{d}" for d in range(len(self.tables))]
        if len(self.names) != len(self.tables):
            raise ValueError(f"{len(self.tables)} tables but "
                             f"{len(self.names)} names")
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"duplicate device names: {self.names}")
        pts = {t.page_tokens for t in self.tables}
        if len(pts) != 1:
            raise ValueError(f"tables disagree on page_tokens: {pts}")
        self.page_tokens = pts.pop()
        self.page_bytes = float(page_bytes)
        self.offsets = [0]
        for t in self.tables:
            self.offsets.append(self.offsets[-1] + t.slots)
        self.edge_bytes: Dict[tuple, float] = {}
        self.host_internal_bytes = 0.0
        self.bytes_out = {n: 0.0 for n in self.names}
        self.bytes_in = {n: 0.0 for n in self.names}

    # ------------------------------------------------------ the namespace --
    @property
    def num_devices(self) -> int:
        return len(self.tables)

    @property
    def slots(self) -> int:
        """Global logical slots across the mesh."""
        return self.offsets[-1]

    def gslot(self, dev: int, slot: int) -> int:
        if not 0 <= slot < self.tables[dev].slots:
            raise ValueError(f"device {dev}: no slot {slot}")
        return self.offsets[dev] + slot

    def owner(self, gslot: int) -> tuple:
        """The unique ``(device, local_slot)`` a global slot names."""
        if not 0 <= gslot < self.slots:
            raise ValueError(f"global slot {gslot} outside [0, {self.slots})")
        d = next(d for d in range(len(self.tables))
                 if gslot < self.offsets[d + 1])
        return d, gslot - self.offsets[d]

    def _at(self, gslot: int):
        d, s = self.owner(gslot)
        return self.tables[d], d, s

    # ------------------------------------------- delegated intra-device ops --
    def n_pages(self, gslot: int) -> int:
        t, _, s = self._at(gslot)
        return t.n_pages[s]

    def cold_pages(self, gslot: int) -> int:
        t, _, s = self._at(gslot)
        return t.cold_pages(s)

    def refcount(self, gslot: int, page_idx: int) -> int:
        t, _, s = self._at(gslot)
        return t.refcount(s, page_idx)

    def alloc(self, gslot: int, tier: int) -> int:
        t, _, s = self._at(gslot)
        return t.alloc(s, tier)

    def share(self, dst: int, src: int, n: int) -> int:
        """Prefix sharing -- intra-device only: a shared physical page can
        only be mapped by slots on the device whose pool holds it."""
        td, dd, sd = self._at(dst)
        _, ds, ss = self._at(src)
        if dd != ds:
            raise ValueError(
                f"share across devices ({self.names[ds]} -> "
                f"{self.names[dd]}): physical pages cannot alias across "
                "HBMs — migrate_slot copies instead")
        return td.share(sd, ss, n)

    def cow(self, gslot: int, page_idx: int):
        t, _, s = self._at(gslot)
        return t.cow(s, page_idx)

    def demote(self, gslot: int, page_idx: int) -> tuple:
        t, _, s = self._at(gslot)
        return t.demote(s, page_idx)

    def free_slot(self, gslot: int) -> int:
        t, _, s = self._at(gslot)
        return t.free_slot(s)

    # -------------------------------------------- the cross-device transition --
    def migrate_slot(self, src: int, dst: int) -> dict:
        """Move every page of global slot ``src`` to global slot ``dst`` on
        another device, appending after ``dst``'s existing pages (a shared
        prefix admitted on the destination stays put; only the private tail
        crosses).  Tiers are preserved per page.  Validates capacity and the
        destination's cold-prefix invariant up front, so it either moves the
        whole slot or raises without mutating.  Returns
        ``{"pages", "hot_bytes", "cold_bytes"}``."""
        st, sd, ss = self._at(src)
        dt, dd, ds = self._at(dst)
        if sd == dd:
            raise ValueError(f"migrate_slot within device "
                             f"{self.names[sd]}: use share/splice instead")
        n = st.n_pages[ss]
        n_cold = st.cold_pages(ss)
        n_hot = n - n_cold
        if dt.n_pages[ds] + n > dt.pages_per_slot:
            raise ValueError(f"dst slot {ds} on {self.names[dd]}: "
                             f"{dt.n_pages[ds]}+{n} pages exceed "
                             f"pages_per_slot {dt.pages_per_slot}")
        if n_cold and dt.n_pages[ds] > dt.cold_pages(ds):
            raise ValueError(f"dst slot {ds} on {self.names[dd]}: cold "
                             "pages would land above its hot pages")
        if len(dt.hot_free) < n_hot or len(dt.cold_free) < n_cold:
            raise ValueError(f"{self.names[dd]}: pool exhausted "
                             f"(need {n_hot} hot / {n_cold} cold)")
        edge = (self.names[sd], self.names[dd])
        for i in range(n):
            tier = st.tier[ss][i]
            dt.alloc(ds, tier)
            if tier == 0:
                self.edge_bytes[edge] = self.edge_bytes.get(edge, 0.0) \
                    + self.page_bytes
                self.bytes_out[edge[0]] += self.page_bytes
                self.bytes_in[edge[1]] += self.page_bytes
            else:
                # cold pools are regions of the one host memory: re-homing
                # copies inside it, no device link is touched
                self.host_internal_bytes += self.page_bytes
        st.free_slot(ss)
        return {"pages": n,
                "hot_bytes": n_hot * self.page_bytes,
                "cold_bytes": n_cold * self.page_bytes}

    # ----------------------------------------------------------- invariants --
    def pages_in_use(self) -> int:
        return sum(t.pages_in_use() for t in self.tables)

    def check(self) -> None:
        """Each table's structural invariants plus the mesh ledgers: every
        byte that left a device landed on exactly one edge.  Raises
        AssertionError on a broken one."""
        for t in self.tables:
            t.check()
        out_sum = {n: 0.0 for n in self.names}
        in_sum = {n: 0.0 for n in self.names}
        for (s, d), b in self.edge_bytes.items():
            if s not in out_sum or d not in in_sum:
                raise AssertionError(f"edge {(s, d)} names an unknown "
                                     "device")
            if b < 0:
                raise AssertionError(f"edge {(s, d)}: negative bytes")
            out_sum[s] += b
            in_sum[d] += b
        for name in self.names:
            if out_sum[name] != self.bytes_out[name]:
                raise AssertionError(
                    f"{name}: {self.bytes_out[name]} bytes departed but "
                    f"{out_sum[name]} attributed to edges")
            if in_sum[name] != self.bytes_in[name]:
                raise AssertionError(
                    f"{name}: {self.bytes_in[name]} bytes arrived but "
                    f"{in_sum[name]} attributed to edges")
        if self.host_internal_bytes < 0:
            raise AssertionError("negative host-internal bytes")


@dataclass
class PagedTieredCache:
    """Cache with per-slot cold boundaries at page granularity (the
    paged-merged layout).

    ``hot`` is the full-size device tree every decode step writes into;
    ``cold`` holds host copies of each slot's rows below its boundary
    (sequence leaves only, None elsewhere).  ``boundaries`` (B,) int32 on
    the hot tree's device is slot b's cold-token count, a multiple of
    ``page_tokens`` and monotone within one residency; ``host_boundaries``
    mirrors it, so the engine's bookkeeping never reads the device."""
    cold: Any
    hot: Any
    boundaries: torch.Tensor
    page_tokens: int
    max_seq: int
    host_boundaries: list

    def merged(self):
        """Masked where-merge on the device: rows below each slot's
        boundary read the cold (host) copy, which is the streamed cold-KV
        fetch, the rows above it the hot tree.  Equal to the dense cache,
        since every row was copied from the dense values when it changed
        tier."""
        dev = self.boundaries.device
        pos = torch.arange(self.max_seq, device=dev)
        mask = (pos[None, :] < self.boundaries[:, None])[..., None]
        return [{k: h if c[k] is None else
                 torch.where(mask, c[k].to(dev, non_blocking=True), h)
                 for k, h in hl.items()} for c, hl in zip(self.cold,
                                                          self.hot)]

    def set_boundary(self, slot: int, cold_tokens: int):
        if cold_tokens % self.page_tokens:
            raise ValueError(f"boundary {cold_tokens} is not whole "
                             f"{self.page_tokens}-token pages")
        self.host_boundaries[slot] = int(cold_tokens)
        self.boundaries[slot] = int(cold_tokens)

    def demote_rows(self, slot: int, new_cold_tokens: int) -> int:
        """Advance slot's boundary: copy rows [old, new) from the hot tree
        into the cold one; only this slot's rows move.  Returns the tokens
        moved."""
        old = self.host_boundaries[slot]
        if new_cold_tokens <= old:
            return 0
        copy_slot_rows(self.cold, self.hot, slot, old, new_cold_tokens)
        self.set_boundary(slot, new_cold_tokens)
        return new_cold_tokens - old


def init_paged_cache(cfg, batch: int, max_seq: int, page_tokens: int, dtype,
                     device) -> PagedTieredCache:
    """Boundaries start at zero (everything hot); the cold tree mirrors the
    sequence leaves in host memory."""
    if max_seq % page_tokens:
        raise ValueError(f"max_seq {max_seq} is not a whole number of "
                         f"{page_tokens}-token pages")
    hot = init_cache(cfg, batch, max_seq, dtype, device)
    cold = to_host([{k: a if k in SEQ_KEYS else None for k, a in l.items()}
                    for l in hot])
    return PagedTieredCache(cold, hot,
                            torch.zeros(batch, dtype=torch.int32,
                                        device=device),
                            page_tokens, max_seq, [0] * batch)


class PagedKVPools:
    """Persistent physical KV page pools — the storage paged decode reads.

    For the ``L`` attention layers (ATTN, LOCAL, SHARED_ATTN) the storage is

      k_hot / v_hot    (L, n_hot+1, page, KV*hd)   device memory
      k_cold / v_cold  (L, n_cold,  page, KV*hd)   pinned host memory
                                                   (plain host memory when
                                                   the device is the CPU)

    addressed through one layer-independent :class:`PageTable`.  ``tree``
    holds one entry per layer of the stack, the cache the model's forward
    reads and writes in place: a ``{"k_hot", "v_hot", "k_cold", "v_cold"}``
    dict of views into pool ``pool_of[layer]`` for an attention layer, and
    the layer's dense batched state (``init_layer_cache``) for any other
    kind: a Mamba layer's state, and an MLA layer's latent, which the
    reference does not page either.  The hot page at index ``garbage``
    (= n_hot) absorbs the lockstep writes of inactive slots.

    ``stats`` counts ``repacks`` (never in this design), ``table_uploads``
    (layout deltas), ``page_copies`` (demote / CoW data movement),
    ``admit_page_writes`` (prefill landing in the pools) and
    ``cold_page_reads`` (the cold pages decode's K1 calls read,
    ``count_decode_reads``).
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
        kinds = [cfg.layer_kind(l) for l in range(cfg.num_layers)]
        # layer -> its pool, for the attention layers only
        self.pool_of = {l: i for i, l in enumerate(
            l for l, k in enumerate(kinds) if k in ATTN_KINDS)}
        # K1's window (0: none) -> the attention layers that read with it
        self._windows = Counter(cfg.sliding_window if kinds[l] == LOCAL
                                else 0 for l in self.pool_of)
        L, D = len(self.pool_of), cfg.num_kv_heads * cfg.head_dim
        hot = (L, self.table.n_hot + 1, page_tokens, D)
        cold = (L, self.table.n_cold, page_tokens, D)
        pin = self.device.type == "cuda"
        self.k_hot = torch.zeros(hot, dtype=dtype, device=self.device)
        self.v_hot = torch.zeros(hot, dtype=dtype, device=self.device)
        self.k_cold = torch.zeros(cold, dtype=dtype, pin_memory=pin)
        self.v_cold = torch.zeros(cold, dtype=dtype, pin_memory=pin)
        self.tree = [
            {"k_hot": self.k_hot[i], "v_hot": self.v_hot[i],
             "k_cold": self.k_cold[i], "v_cold": self.v_cold[i]}
            if (i := self.pool_of.get(l)) is not None else
            init_layer_cache(cfg, kind, slots, max_seq, dtype, self.device)
            for l, kind in enumerate(kinds)]
        self._cached_arrays = None
        self._cached_version = -1
        # event recorded after the last stream-ordered cold-pool write; a
        # host-side read of the cold pools waits on it (sync_cold)
        self._cold_written = None
        self.stats = {"repacks": 0, "table_uploads": 0, "page_copies": 0,
                      "admit_page_writes": 0, "cold_page_reads": 0}

    def _copy_into_cold(self, dst_pool, dst: int, src_pool, src: int):
        """dst_pool[:, dst] = src_pool[:, src], one contiguous page per
        layer, stream-ordered.  A cold source goes through the device (H2D
        then D2H) so no CPU thread ever touches the pinned pool."""
        for l in range(dst_pool.shape[0]):
            page = src_pool[l, src].to(self.device, non_blocking=True)
            dst_pool[l, dst].copy_(page, non_blocking=True)
        if self.device.type == "cuda":
            self._cold_written = torch.cuda.Event()
            self._cold_written.record(torch.cuda.current_stream(self.device))

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

    def paged_view(self, active_mask, slots=None) -> dict:
        """The per-step view models/attention.py consumes; everything in it
        is cached or a python constant.  ``slots`` (a device index tensor)
        narrows it to a sub-batch of slots, in that order, as one decode
        shard of the disaggregated engine reads its pools;
        ``active_mask`` is then the sub-batch's."""
        table_arr, tier_arr = self.arrays()
        if slots is not None:
            table_arr, tier_arr = table_arr[slots], tier_arr[slots]
        return {"page_table": table_arr, "page_tier": tier_arr,
                "page_tokens": self.page_tokens, "active": active_mask,
                "garbage_page": self.garbage}

    def count_decode_reads(self, lengths, slots=None) -> None:
        """Add the cold pages one decode step's K1 calls read to
        ``stats["cold_page_reads"]``: for each slot of ``slots`` (default
        every slot) with K1 length ``lengths[i]``, the entries of its table
        row that K1 reads from the cold pool, from the layer's window's
        first page to the page holding its last token, summed over the
        attention layers.  K1 reads every entry whose tier is not 0 there:
        the cold pages, and unmapped entries, which it clips into the cold
        pool.  It is handed every slot's length, a finished slot's stale
        one included."""
        pg, tier = self.page_tokens, self.table.tier
        slots = range(self.num_slots) if slots is None else slots
        for window, layers in self._windows.items():
            n = 0
            for s, length in zip(slots, lengths):
                lo = max(0, (length - window) // pg) if window else 0
                row = tier[s][lo:-(-length // pg)]
                n += len(row) - row.count(0)
            self.stats["cold_page_reads"] += layers * n

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

    def admit_rows(self, fresh, slot: int, pages) -> None:
        """Write whole pages of a batch-1 prefilled dense cache ``fresh``
        (per-layer {"k", "v"} (1, max_seq, KV*hd)) into the slot's private
        hot pages, in place.  Shared pages are skipped by the caller: their
        physical pages already hold the same data."""
        pages = list(pages)
        if not pages:
            return
        if any(self.table.tier[slot][i] != 0 for i in pages):
            raise ValueError("admitted pages land in the hot pool")
        if pages != list(range(pages[0], pages[-1] + 1)):
            raise ValueError("admitted pages are one run of logical pages")
        pg = self.page_tokens
        phys = torch.tensor([self.table.table[slot][i] for i in pages],
                            device=self.device)
        lo, hi = pages[0] * pg, (pages[-1] + 1) * pg
        for l, i in self.pool_of.items():
            for name in ("k", "v"):
                rows = fresh[l][name][0, lo:hi]
                pool = self.k_hot if name == "k" else self.v_hot
                pool[i, phys] = rows.reshape(len(pages), pg, -1)
        self.stats["admit_page_writes"] += len(pages)

    def splice_other(self, fresh, slot: int) -> None:
        """Row-splice the non-attention layers' caches (Mamba state, the
        MLA latent) of a batch-1 cache into the tree, in place, as
        ``splice_slot`` does on a dense cache."""
        for l, entry in enumerate(self.tree):
            if l not in self.pool_of:
                for k, a in entry.items():
                    a[slot].copy_(fresh[l][k][0])

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
