"""Prefill/decode disaggregation over a group of devices (port of
``repro/serve/disagg.py``).

Prefill is a compute-bound burst over the whole prompt, decode a
bandwidth-bound steady loop.  Colocated, every admission serializes a
prompt's worth of compute into the decode stream; disaggregated, prefill
runs on its own device group and the finished KV pages stream over the
device<->device edge into the decode pools.

``DisaggregatedEngine`` subclasses ``ContinuousBatcher`` on the pools
layout.  ``devices`` is split by ``launch.mesh.disagg_groups``; prefill runs
on the prefill group and the finished ``(last, fresh)`` KV streams to the
decode side, where every decode device is a *shard*:

  * each shard owns its own ``PagedKVPools`` + ``PageTable``, all under one
    ``MeshPageTable`` global slot namespace (names ``("prefill", "dev0",
    ..., "devN-1")``; one decode device keeps the ``("prefill", "decode")``
    pair and the colocated engine's code paths);
  * the plan's ``slot_devices`` (``runtime.plan_serving(...,
    decode_devices=N)``) assigns each batch slot to its shard -- prefix
    sharing is intra-shard only, and each step runs one sub-batch forward
    per shard against that shard's pools, on that shard's device;
  * ``_alloc_admit_pages`` stages the admitted pages on the prefill table
    and moves them into the owning shard's slot as a
    ``MeshPageTable.migrate_slot`` transition, so the per-edge ledger equals
    ``predict_pool_counters(..., dense_admit=True)["edge_migration_bytes"]``
    integer for integer (shared pages stay put; only the private tail
    crosses);
  * ``apply_plan`` with a re-plan whose ``slot_devices`` moves an active
    slot re-homes it the same way (hot pages over the shard<->shard edge,
    cold pages inside host memory), the pages written in place into the
    destination pools.

Devices may repeat: ``devices=[cuda:0] * 4`` runs two decode shards, each
with its own pools, on one card.  Where a stream's two ends are one device
the KV is not copied (``Tensor.to`` returns the tensor itself); the ledger
still counts the logical edge traffic, as the reference's does.  Between
distinct devices it is ``tensor.to(dst, non_blocking=True)``.

With ``tp_prefill=True`` and more than one prefill device, the prefill
group runs the prompt tensor-parallel under ``sharding.serve_rules`` on a
``("model",)`` mesh over the prefill devices (``TensorParallelPrefill``):
every rank runs the same model code on its parameter blocks under a rank
context, its collectives go through one ``collectives.Group``, whose
ledger is ``engine.collectives`` and ``counters()["collectives"]``.  The
last-row logits come back concatenated over the vocab and the fresh KV
over the KV heads, in rank order (the prefill->decode stream, not a
collective); the edge ledger is the same as without it.  The ranks' sums
add in another order than one device's product does, so the logits agree
to rounding, not bit for bit; with one prefill device the flag is ignored,
as the reference's ``bool(tp_prefill) and len(prefill_devices) > 1``
makes it.  A rank that fails makes the admission raise: nothing falls back
to one device.

``price_disagg`` is the planner-side model of the same trade: a serving
trace priced colocated against disaggregated at equal total device memory,
on the machine the caller names (``H100_COST`` for the card).
"""
from __future__ import annotations

import copy
from dataclasses import replace
from typing import Optional

import torch

from repro_torch import collectives, telemetry
from repro_torch import sharding as shd
from repro_torch.device import resolve
from repro_torch.launch.mesh import disagg_groups
from repro_torch.models import kvcache, model
from repro_torch.runtime.plan import validate_slot_devices
from repro_torch.runtime.policies import simulate
from repro_torch.runtime.tiergraph import TierGraph
from repro_torch.serve.engine import ContinuousBatcher


def _params_on(params, device: torch.device):
    """``params`` on ``device``: the module itself when it lives there, else
    a moved copy (``nn.Module.to`` moves in place, and the caller's module
    stays where it is)."""
    if next(params.parameters()).device == device:
        return params
    return copy.deepcopy(params).to(device)


class TensorParallelPrefill:
    """``model.prefill`` partitioned over ``devices`` (a ``("model",)``
    mesh under ``sharding.serve_rules``; a device may repeat): each rank
    holds its blocks of the parameters (``sharding.shard_params``) on its
    device and runs the one-device code under a rank context, on a worker
    thread of ``self.group``, whose ``ledger`` records what the
    collectives moved.  A call returns (the last row's logits (B, V), the
    caches) on ``devices[0]``, each gathered over the ranks in rank order
    where the rules split it."""

    def __init__(self, params, cfg, devices, max_seq=None):
        self.cfg, self.max_seq = cfg, max_seq
        self.devices = list(devices)
        n = len(self.devices)
        self.rules = shd.serve_rules(
            shd.Mesh((n,), ("model",), devices=self.devices))
        self.group = collectives.Group(self.devices)
        self.params = [shd.shard_params(params, self.rules, {"model": r},
                                        device=d)
                       for r, d in enumerate(self.devices)]

    @property
    def ledger(self) -> dict:
        return self.group.ledger

    def close(self):
        """Stop the ranks' worker threads."""
        self.group.close()

    def _rank(self, batch, r: int):
        dev = self.devices[r]
        ctx = shd.RankContext(self.group, r, self.rules, {"model": r})
        with shd.rank_context(ctx):
            return model.prefill(
                self.params[r], self.cfg,
                {k: v.to(dev) for k, v in batch.items()},
                max_seq=self.max_seq)

    def __call__(self, batch):
        outs = self.group.run(lambda r: self._rank(batch, r))
        home = self.devices[0]

        def join(parts, full_dims):
            """Rank 0's tensor, or the ranks' blocks concatenated on the
            one dim that is shorter than its full size."""
            t = parts[0]
            for i, (n, full) in enumerate(zip(t.shape, full_dims)):
                if n < full:
                    return torch.cat([p.to(home) for p in parts], dim=i)
            return t.to(home)

        cfg = self.cfg
        last = join([o[0] for o in outs],
                     (*outs[0][0].shape[:-1], cfg.padded_vocab))
        fresh = []
        for l, entry in enumerate(outs[0][1]):
            full = kvcache.init_layer_cache(
                cfg, cfg.layer_kind(l), 1, 1, model.param_dtype(cfg),
                torch.device("meta"))
            # the whole leaf's dims: the batch and a sequence leaf's rows
            # are the rank's own, the rest from the unpartitioned cache
            fresh.append({
                k: join([o[1][l][k] for o in outs],
                        (v.shape[0], v.shape[1] if k in kvcache.SEQ_KEYS
                         else full[k].shape[1], *full[k].shape[2:]))
                for k, v in entry.items()})
        return last, fresh


class DisaggregatedEngine(ContinuousBatcher):
    """A ``ContinuousBatcher`` whose prefill runs on a separate device group
    and whose decode batch is sharded across the decode group (see the
    module's docstring).  Requires a plan and the persistent-pools layout
    (``cfg.use_paged_decode``); multi-shard decode also needs a
    pure-attention stack."""

    def __init__(self, params, cfg, batch_slots: int, max_seq: int,
                 scfg=None, plan=None, slot_tenants=None, devices=None,
                 tp_prefill: bool = False, prefill_devices=None):
        """``prefill_devices``: the prefill group, given beside ``devices``,
        which is then the decode group as it stands (default: the split of
        ``devices`` by ``launch.mesh.disagg_groups``), so a prefill group of
        two tensor-parallel ranks can feed one decode shard."""
        if plan is None:
            raise ValueError("DisaggregatedEngine requires a plan (the "
                             "pools layout is planned)")
        if prefill_devices is None:
            prefill_devs, decode_devs = disagg_groups(devices)
        else:
            prefill_devs = [resolve(d) for d in prefill_devices]
            decode_devs = [resolve(d) for d in devices or [None]]
        self.prefill_devices = list(prefill_devs)
        self.prefill_device = prefill_devs[0]
        self.decode_devices = list(decode_devs)
        self.decode_device = decode_devs[0]
        self.n_shards = len(self.decode_devices)
        super().__init__(_params_on(params, self.decode_device), cfg,
                         batch_slots, max_seq, scfg=scfg, plan=plan,
                         paged=True, slot_tenants=slot_tenants,
                         device=self.decode_device)
        # prompts prefill whole on the prefill group and stream across the
        # device edge; pool-direct chunks would write the decode pools from
        # the wrong device, so admission takes the dense one-shot path
        self._pool_prefill_ok = False
        if self.prefill_chunk_tokens:
            raise ValueError(
                "chunked prefill is colocated-engine only: the "
                "DisaggregatedEngine prefills whole prompts on the prefill "
                "group (set prefill_chunk_tokens=0)")
        if self.pool is None:
            raise ValueError(
                "DisaggregatedEngine needs the persistent pools layout: "
                "set cfg.use_paged_decode (and not cfg.prefix_lm)")
        pg = self.page_tokens
        self.device_hot_peak: dict = {}    # shard name -> peak hot pool bytes
        self._dev_note_version = None
        stage = kvcache.PageTable(1, max_seq // pg, pg)
        if self.n_shards == 1:
            # a plan placed for N shards cannot silently colocate
            if plan.slot_devices is not None:
                validate_slot_devices(plan.slot_devices, batch_slots, 1)
            self.slot_devices = None
            self.pools = [self.pool]
            self.params_shards = [self.params]
            names = ("prefill", "decode")
        else:
            if not all(cfg.layer_kind(l) in kvcache.ATTN_KINDS
                       for l in range(cfg.num_layers)) \
                    or cfg.num_prefix_tokens or cfg.num_codebooks:
                raise ValueError(
                    "multi-shard decode needs a pure-attention stack: every "
                    "layer's KV must live in the physical page pools (the "
                    "per-shard sub-batch forwards have no dense per-slot "
                    "caches to split)")
            sd = plan.slot_devices
            if sd is None:
                sd = [s % self.n_shards for s in range(batch_slots)]
            self.slot_devices = validate_slot_devices(sd, batch_slots,
                                                      self.n_shards)
            # one B-slot pool per shard (cold pages pinned, as every pool
            # is on a card): a slot's pages live only in its owning shard's
            # pools, and the global slot index doubles as the local one
            dt = model.param_dtype(cfg)
            self.pools = [self.pool] + [
                kvcache.PagedKVPools(cfg, batch_slots, max_seq, pg, dt, d)
                for d in self.decode_devices[1:]]
            self.params_shards = [self.params] + [
                _params_on(self.params, d) for d in self.decode_devices[1:]]
            names = ("prefill",) + tuple(f"dev{d}"
                                         for d in range(self.n_shards))
        self.mesh_table = kvcache.MeshPageTable(
            [stage] + [p.table for p in self.pools], names=names,
            page_bytes=pg * self._row_bytes)
        self._index_shards()
        # one staging slot on the prefill side: a request's pages are born
        # there and migrate to their decode slot as one tier transition
        self._stage = self.mesh_table.gslot(0, 0)
        base_prefill = self._prefill
        self.tp_prefill = bool(tp_prefill) and len(self.prefill_devices) > 1
        if self.tp_prefill:
            self._tp = TensorParallelPrefill(self.params, cfg,
                                             self.prefill_devices, max_seq)
        else:
            self.params_prefill = _params_on(self.params,
                                             self.prefill_device)

        def prefill_remote(p, batch):
            del p                              # the decode side's params
            if self.tp_prefill:
                last, fresh = self._tp(batch)
            else:
                batch = {k: v.to(self.prefill_device)
                         for k, v in batch.items()}
                last, fresh = base_prefill(self.params_prefill, batch)
            # the first token decodes from the last row on the decode side;
            # the KV streams over the prefill->decode edge in _admit_pool,
            # to the owning shard's device (no copy where the two alias)
            return last.to(self.decode_device), fresh

        self._prefill = prefill_remote

    def _index_shards(self):
        """Each shard's slots, in slot order, as a list and as index
        tensors on the engine's device and on the shard's device."""
        self._shard_slots = []
        for d in range(self.n_shards):
            idxs = [s for s in range(self.B) if self._shard_of(s) == d]
            idx = torch.tensor(idxs, dtype=torch.long, device=self.device)
            self._shard_slots.append(
                (idxs, idx, idx.to(self.decode_devices[d])))

    def _shard_of(self, slot: int) -> int:
        return self.slot_devices[slot] if self.n_shards > 1 else 0

    def _slot_pool(self, slot: int):
        return self.pools[self._shard_of(slot)]

    def _dev_label(self, d: int) -> str:
        return "decode" if self.n_shards == 1 else f"dev{d}"

    def _gslot(self, d: int, slot: int) -> int:
        return self.mesh_table.gslot(1 + d, slot)

    # ------------------------------------------------------------- admits --
    def _alloc_admit_pages(self, slot: int, n: int) -> None:
        d = self._shard_of(slot)
        need = n - self.pools[d].table.n_pages[slot]
        if need <= 0:
            return
        stage_table = self.mesh_table.tables[0]
        for _ in range(need):
            stage_table.alloc(0, 0)            # prefill writes land here
        self.mesh_table.migrate_slot(self._stage, self._gslot(d, slot))

    # -------------------------------------------------------------- decode --
    def _pool_decode_step(self):
        """One sub-batch forward per shard with an active slot, against
        that shard's pools on its device, then the boundary advance of
        every active slot.  Returns the decoded tokens (B,)."""
        if self.n_shards == 1:
            return super()._pool_decode_step()
        tok = self.last_tok.clone()
        for d, (idxs, idx, idx_d) in enumerate(self._shard_slots):
            if not any(self.active[s] for s in idxs):
                continue
            pool, dev = self.pools[d], self.decode_devices[d]
            for s in idxs:
                if self.active[s]:
                    pool.ensure_write_page(s, self._host_len[s])
            view = pool.paged_view(self._active_mask[idx].to(dev), idx_d)
            pool.count_decode_reads([self._host_len[s] + 1 for s in idxs],
                                    idxs)
            with telemetry.span("engine.decode_forward"):
                logits = model.forward(
                    self.params_shards[d], self.cfg,
                    {"tokens": self.last_tok[idx][:, None].to(dev)},
                    caches=pool.tree, cache_index=self.lengths[idx].to(dev),
                    decode=True, paged_view=view)
            tok[idx] = torch.argmax(logits[:, -1, :self.cfg.vocab_size],
                                    dim=-1).to(self.device)
        with telemetry.span("engine.demote"):
            for s in range(self.B):
                if self.active[s]:
                    self._demote_to_target(s, self._host_len[s] + 1)
        self._note_tenant_pages()
        return tok

    # ----------------------------------------------------------- re-plans --
    def apply_plan(self, new_plan):
        """Adopt a re-plan on the sharded pools: demote active slots toward
        the new hot windows on their current owner (the colocated engine's
        ``apply_plan``), then re-home every active slot whose
        ``slot_devices`` entry moved as a ``MeshPageTable.migrate_slot``
        transition; a finished slot's stale pages are dropped, not copied.
        Returns the boundary bytes plus the re-homing bytes."""
        moved = super().apply_plan(new_plan)
        new_sd = self.plan.slot_devices
        if self.n_shards == 1 or new_sd is None:
            return moved
        new_sd = validate_slot_devices(new_sd, self.B, self.n_shards)
        rehome = 0.0
        for s in range(self.B):
            old, new = self.slot_devices[s], new_sd[s]
            if old == new:
                continue
            if self.active[s]:
                rehome += self._rehome_slot(s, old, new)
            elif self.pools[old].table.n_pages[s]:
                self.pools[old].table.free_slot(s)
        self.slot_devices = new_sd
        self._index_shards()
        # ownership moved without a table event the sampler keys on
        self._tenant_note_version = -1
        self._note_tenant_pages()
        return moved + rehome

    def _rehome_slot(self, slot: int, old: int, new: int) -> float:
        """Move one live slot's pages between shards: the ``migrate_slot``
        transition for the tables and the ledger, then the page data,
        written in place into the destination pools' own tensors (their
        tree views and pinned cold pages stay valid).  Returns the bytes
        moved (hot over the edge + cold host-internal)."""
        src, dst = self.pools[old], self.pools[new]
        st, dt = src.table, dst.table
        n = st.n_pages[slot]
        if n == 0:
            return 0.0
        src_phys, src_tier = st.table[slot][:n], st.tier[slot][:n]
        base = dt.n_pages[slot]
        out = self.mesh_table.migrate_slot(self._gslot(old, slot),
                                           self._gslot(new, slot))
        dst_phys = dt.table[slot][base:base + n]
        hot = [(sp, dp) for sp, dp, t in zip(src_phys, dst_phys, src_tier)
               if t == 0]
        if hot:                                # the shard<->shard edge copy
            s_idx = torch.tensor([sp for sp, _ in hot], device=src.device)
            d_idx = torch.tensor([dp for _, dp in hot], device=dst.device)
            for a, b in ((src.k_hot, dst.k_hot), (src.v_hot, dst.v_hot)):
                b[:, d_idx] = a[:, s_idx].to(dst.device, non_blocking=True)
        cold = [(sp, dp) for sp, dp, t in zip(src_phys, dst_phys, src_tier)
                if t == 1]
        # the source's cold pages are written on its own device's stream
        # (demotions just issued by apply_plan included) and read here on
        # the destination's: between two cards each stream waits for the
        # other's side (one device's stream orders both by itself)
        two_cards = src.device != dst.device and \
            src.device.type == dst.device.type == "cuda"
        if cold and two_cards and src._cold_written is not None:
            torch.cuda.current_stream(dst.device).wait_event(
                src._cold_written)
        for sp, dp in cold:                    # re-homed inside host memory
            dst._copy_into_cold(dst.k_cold, dp, src.k_cold, sp)
            dst._copy_into_cold(dst.v_cold, dp, src.v_cold, sp)
        if cold and two_cards:
            # the freed source pages are rewritten only after these reads
            torch.cuda.current_stream(src.device).wait_event(
                dst._cold_written)
        return out["hot_bytes"] + out["cold_bytes"]

    # ----------------------------------------------------------- counters --
    def _note_tenant_pages(self):
        """Per-tenant and per-shard hot-footprint peaks (distinct physical
        hot pages of each shard), sampled at the colocated engine's layout
        events."""
        ver = tuple(p.table.version for p in self.pools)
        if ver == self._dev_note_version and self._tenant_note_version != -1:
            return
        self._dev_note_version = ver
        self._tenant_note_version = self.pools[0].table.version
        per_t: dict = {}
        per_d: dict = {}
        for s in range(self.B):
            d = self._shard_of(s)
            t = self.pools[d].table
            hot = {(d, t.table[s][i]) for i in range(t.n_pages[s])
                   if t.tier[s][i] == 0}
            per_d.setdefault(self._dev_label(d), set()).update(hot)
            tn = self._slot_tenant(s)
            if tn is not None:
                per_t.setdefault(tn, set()).update(hot)
        page_bytes = self.page_tokens * self._row_bytes
        for peaks, per in ((self.tenant_hot_peak, per_t),
                           (self.device_hot_peak, per_d)):
            for k, pages in per.items():
                v = len(pages) * page_bytes
                if v > peaks.get(k, 0):
                    peaks[k] = v

    def close(self):
        """Stop the tensor-parallel prefill's rank threads (nothing to stop
        without it)."""
        if self.tp_prefill:
            self._tp.close()

    @property
    def collectives(self) -> dict:
        """What the tensor-parallel prefill's collectives moved
        (``collectives.Group.ledger``); all zeros without it."""
        return self._tp.ledger if self.tp_prefill \
            else collectives.new_ledger()

    @property
    def xdev_migration_bytes(self) -> float:
        """Bytes that crossed a prefill->decode edge (equal to
        ``predict_pool_counters(..., dense_admit=True)
        ["xdev_migration_bytes"]``)."""
        return sum(b for (src, _), b in self.mesh_table.edge_bytes.items()
                   if src == "prefill")

    @property
    def edge_migration_bytes(self) -> dict:
        """The per-edge ledger ``{(src, dst): bytes}``: admit streams plus
        re-homing transitions."""
        return dict(self.mesh_table.edge_bytes)

    def counters(self) -> dict:
        out = super().counters()
        if self.n_shards > 1:
            for k in self.pools[0].stats:
                out[k] = sum(p.stats[k] for p in self.pools)
            out["table_version"] = sum(p.table.version for p in self.pools)
        out["xdev_migration_bytes"] = self.xdev_migration_bytes
        out["edge_migration_bytes"] = self.edge_migration_bytes
        out["device_hot_peak"] = dict(self.device_hot_peak)
        out["collectives"] = {k: dict(v) for k, v in self.collectives.items()}
        return out


def price_disagg(trace, cm, decode_fast_bytes: float, *,
                 policy: str = "sentinel", graph: Optional[TierGraph] = None,
                 decode_devices: int = 1, **knobs) -> dict:
    """Price a serving trace colocated vs disaggregated at equal total
    device memory, on ``cm``.

    Colocated: one device with ``2 * decode_fast_bytes`` runs both phases;
    each admission's prefill serializes into the decode stream (the
    ``extra_*`` channels of the recorded ``StepTraffic``).  Disaggregated:
    decode keeps ``decode_fast_bytes``, the ``extra_*`` channels move to the
    prefill group, and the finished KV streams over the prefill->decode
    edge(s) of ``graph`` (default: ``TierGraph.mesh`` with
    ``decode_devices`` decode shards plus the prefill device), priced per
    edge as a pipe overlapped behind decode.  With ``decode_devices`` N > 1
    the decode stream splits evenly across N shard pipes and the slowest
    shard paces the step.

    The admitted-prefill tokens behind each step's KV stream come from
    ``StepTraffic.extra_flops`` when the trace prices compute
    (``flops_per_token``), else from the admit byte channel ``extra_fast``
    (computed prefill tokens x KV row bytes); a trace admitting prompts
    that neither channel can attribute raises.

    Returns ``{"colocated": CostReport, "disagg": CostReport,
    "edge_bytes": float, "graph": TierGraph}``.
    """
    if decode_devices < 1:
        raise ValueError(f"price_disagg(decode_devices={decode_devices}): "
                         "need at least one decode shard")
    graph = graph if graph is not None else \
        TierGraph.mesh(decode_devices + 1, cm,
                       decode_fast_bytes / decode_devices)
    res_c = simulate(trace, cm, 2.0 * decode_fast_bytes, policy, **knobs)
    colocated = cm.price(res_c.step_traffic)
    res_d = simulate(trace, cm, decode_fast_bytes, policy, **knobs)
    kv_row = trace.num_layers * trace.kv_token_bytes
    flops_tok = getattr(trace, "flops_per_token", 0.0)
    if not flops_tok and not kv_row and \
            getattr(trace, "prefill_tokens", None):
        raise ValueError(
            "price_disagg cannot attribute the prefill->decode KV stream: "
            "the trace admits prompts but has neither flops_per_token nor "
            "kv_token_bytes, so no StepTraffic channel (extra_flops / "
            "extra_fast) carries the admitted tokens")
    N = decode_devices
    prefill_name = f"dev{N}"
    stripped, edge_flows, dev_series, edge_total = [], [], [], 0.0
    for tr in res_d.step_traffic:
        if flops_tok:
            ptok = tr.extra_flops / flops_tok
        elif kv_row:
            ptok = tr.extra_fast / kv_row
        else:
            ptok = 0.0
        flow = ptok * kv_row
        edge_total += flow
        base = replace(tr, extra_flops=0.0, extra_fast=0.0,
                       prefill_flops=0.0, prefill_read=0.0)
        stripped.append(base)
        flows = {}
        per_dev = {}
        for d in range(N):
            per_dev[f"dev{d}"] = base if N == 1 else replace(
                base, flops=base.flops / N, fast_read=base.fast_read / N,
                slow_read=base.slow_read / N,
                demand_read=base.demand_read / N, mig_in=base.mig_in / N,
                mig_out=base.mig_out / N, migs=base.migs / N)
            if flow:
                flows[(prefill_name, f"dev{d}")] = flow / N
        # the prefill group's own pipe runs concurrently with the shards:
        # its prompt compute is one more max() arm, never serialized into
        # the decode stream
        per_dev[prefill_name] = replace(
            tr, flops=0.0, fast_read=0.0, slow_read=0.0, demand_read=0.0,
            mig_in=0.0, mig_out=0.0, migs=0.0, stall=0.0)
        edge_flows.append(flows)
        dev_series.append(per_dev)
    disagg = cm.price_on_graph(stripped, graph, edge_flows,
                               device_traffic=dev_series)
    return {"colocated": colocated, "disagg": disagg,
            "edge_bytes": edge_total, "graph": graph}
