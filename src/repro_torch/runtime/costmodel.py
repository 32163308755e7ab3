"""Time-domain cost model: price per-step traffic, not migration bytes.

Every gate in the repo before this module optimized migration *bytes* — a
proxy that cannot see bandwidth contention between decode reads and
background migration.  Sentinel's actual claim is *performance* parity with
fast-memory-only at ~20% capacity, so the planner needs a clock, not a byte
counter.  This module supplies it:

  StepTraffic   what one timeline step actually moved: fast/slow demand
                reads, migration in/out, compute, tokens.  Every policy's
                ``simulate`` records one per step (``result.step_traffic``).
  CostModel     the machine the traffic is priced on: per-tier read/write
                bandwidths, the host interface-vs-internal split, migration
                contention, and a DMA-overlap factor for the double-buffered
                paged-decode window.  ``step_time`` prices one step as

                    T_step = max(T_compute, T_roofline, T_HBM, T_ext)

                the per-step pipe maximum of fangyunh's
                ``Data_Placement_Optimization`` simulator (SNIPPETS.md 1-2):
                reads and migration share each memory pipe, and the step
                takes as long as its most-contended pipe.
  CostReport    ``price`` folds a traffic series to simulated seconds and
                tokens/sec — the latency objective ``runtime.plan`` selects
                placements by.

The pipe terms, for visible migration v_in/v_out = (1-dma_overlap) * bytes:

  T_compute   flops / peak_flops
  T_roofline  (fast_read + slow_read) / fast_read_bw — every byte the step's
              compute consumed, priced at fast bandwidth.  This floor makes
              the model *placement-consistent*: an all-fast placement
              lower-bounds every other placement of the same reads, and
              slow reads are free exactly while the external pipe hides
              under this floor (the paper's parity-at-20%-capacity regime).
  T_HBM       fast_read / fast_read_bw + v_in / fast_write_bw
              + v_out / fast_read_bw — demand reads and migration copies
              contend for HBM bandwidth.
  T_ext       max((slow_read - demand_read) / min(slow_read_bw,
                                                  host_internal_bw)
                  + max(v_in / mig_read_bw, v_out / mig_write_bw),
                  (slow_read + v_in + v_out) / host_internal_bw)
              — the external pipe seen two ways: the device interface
              (planned slow reads streamed with the slower migration
              direction) and the host memory servicing all of it internally.

plus, serialized on top of the maximum, ``demand_read / ext_read_bw``: the
reactive portion of the slow reads.  A policy that knows the access schedule
(``plans_ahead``: the sentinel family, static placements) streams its slow
reads behind the pipe maximum; a reactive one (LRU paging, caching daemons)
discovers each miss at touch time, so those bytes stall compute — the
paper's proactive-vs-reactive distinction, and the reason demand paging
cannot reach prefetch's latency even at equal traffic.

``CostModel`` duck-types ``HWSpec`` (``fast_bw``/``slow_bw``/``mig_bw``
properties), so it drops into ``runtime.simulate`` and every policy
unchanged; ``CostModel.from_hw`` upgrades a legacy ``HWSpec`` to a model
that simulates *identically* (host interface-bound, no DMA overlap).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, fields
from typing import List, Optional, Sequence

from repro_torch.core.hardware import H100, HWSpec


@dataclass
class StepTraffic:
    """What one timeline step moved — the unit ``CostModel`` prices.

    ``fast_read``/``slow_read`` are bytes the step's compute consumed from
    each tier (fast includes the placement-independent fixed traffic:
    KV writes, weight streaming, reserve-pool churn).  ``demand_read`` is
    the *reactive* portion of ``slow_read``: bytes a schedule-blind policy
    only discovered it needed when compute touched them, so they cannot be
    streamed behind the pipe maximum and serialize onto the critical path
    (the event loop sets it from the policy's ``plans_ahead`` flag — the
    paper's proactive-vs-reactive distinction).  ``mig_in``/``mig_out``
    are migration bytes slow->fast / fast->slow attributed to the step;
    ``migs`` the migration events (each costs ``mig_overhead``), ``stall``
    seconds already on the critical path (Case-3 / SLO repair copies).
    ``extra_flops``/``extra_fast`` carry the off-timeline add-on (slot-refill
    prefill), always fast-tier.

    ``prefill_flops``/``prefill_read`` refine the prefill add-on for the
    cache-aware engine: ``prefill_flops`` is the prompt compute actually
    *run* (net of the shared-prefix compute skip — rows whose KV maps onto
    a donor's pages are never recomputed) and ``prefill_read`` the shared
    KV bytes those skipped rows' successors attend back into.  When
    ``extra_flops`` is zero the prefill terms stand alone; series built by
    the serving timeline set both, with ``extra_flops`` preferred so legacy
    pricing is unchanged (``extra_flops == prefill_flops`` there).  With
    ``chunked_prefill=True`` the pricing entry points fold the prefill term
    into the step's pipe maximum (prefill chunks interleave with decode)
    instead of serializing it after the step.
    """
    flops: float = 0.0
    fast_read: float = 0.0
    slow_read: float = 0.0
    demand_read: float = 0.0
    mig_in: float = 0.0
    mig_out: float = 0.0
    tokens: int = 0
    migs: float = 0.0
    extra_flops: float = 0.0
    extra_fast: float = 0.0
    stall: float = 0.0
    prefill_flops: float = 0.0
    prefill_read: float = 0.0


@dataclass
class CostReport:
    """A priced traffic series: the latency objective's measurement."""
    time: float                      # predicted seconds for the series
    compute_time: float              # all-fast prediction of the same reads
    tokens: int
    step_times: List[float] = field(default_factory=list)

    @property
    def slowdown(self) -> float:
        return self.time / max(self.compute_time, 1e-30)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.time, 1e-30)


@dataclass(frozen=True)
class CostModel:
    """The machine a ``StepTraffic`` series is priced on.

    Bandwidths are bytes/second.  ``slow_read_bw`` is the *interface* a
    demand read from the slow tier comes through (the host link for pinned
    host memory read by the card);
    ``host_internal_bw`` is the slow tier's internal bandwidth servicing
    demand reads AND migration copies together (``inf`` = interface-bound,
    the legacy two-bandwidth model).  ``mig_read_bw``/``mig_write_bw`` are
    the migration DMA engines per direction; ``dma_overlap`` is the fraction
    of migration traffic the double-buffered paged-decode window hides
    behind compute (0 = fully exposed, the legacy model's assumption).
    """
    name: str = "costmodel"
    peak_flops: float = 1e12
    fast_read_bw: float = 1e11
    fast_write_bw: float = 1e11
    slow_read_bw: float = 1e10
    mig_read_bw: float = 1e10
    mig_write_bw: float = 1e10
    host_internal_bw: float = math.inf
    link_bw: float = 0.0
    dma_overlap: float = 0.0
    mig_overhead: float = 0.0
    fast_bytes: float = 0.0

    # ------------------------------------------------ HWSpec duck-typing --
    # Every policy and simulator reads hw.fast_bw/slow_bw/mig_bw; a
    # CostModel drops in wherever an HWSpec was accepted.
    @property
    def fast_bw(self) -> float:
        return self.fast_read_bw

    @property
    def slow_bw(self) -> float:
        return self.slow_read_bw

    @property
    def mig_bw(self) -> float:
        return self.mig_read_bw

    @classmethod
    def from_hw(cls, hw) -> "CostModel":
        """Upgrade an ``HWSpec`` (or pass a CostModel through).  The mapped
        model simulates and prices the legacy machine exactly: interface-
        bound host (``host_internal_bw = inf``), symmetric migration DMA,
        no DMA overlap."""
        if isinstance(hw, cls):
            return hw
        return cls(name=hw.name, peak_flops=hw.peak_flops,
                   fast_read_bw=hw.fast_bw, fast_write_bw=hw.fast_bw,
                   slow_read_bw=hw.slow_bw, mig_read_bw=hw.mig_bw,
                   mig_write_bw=hw.mig_bw, host_internal_bw=math.inf,
                   link_bw=hw.link_bw, dma_overlap=0.0,
                   mig_overhead=hw.mig_overhead, fast_bytes=hw.fast_bytes)

    # ------------------------------------------------------------ pricing --
    def ext_read_bw(self) -> float:
        """Effective demand-read bandwidth from the slow tier: the slower of
        the device interface and the host's internal memory."""
        return min(self.slow_read_bw, self.host_internal_bw)

    def optimal_alpha(self) -> float:
        """Bandwidth-optimal fast:total read split.  Splitting a read stream
        alpha fast / (1-alpha) slow equalizes the two pipes' times when
        alpha/(1-alpha) = B_fast/B_ext, i.e. alpha = B_fast/(B_fast+B_ext)
        — reads beyond that fraction buy no time, only migration traffic."""
        return self.fast_read_bw / (self.fast_read_bw + self.ext_read_bw())

    def step_time(self, tr: StepTraffic, *,
                  chunked_prefill: bool = False) -> float:
        """Price one step: max over the contended pipes (see module doc),
        plus the serialized demand misses — a reactive policy's slow reads
        are discovered at touch time and stall compute instead of streaming
        behind it (the planned remainder overlaps inside ``T_ext``).

        ``chunked_prefill`` models the engine's interleaved prefill: the
        prefill add-on becomes one more pipe under the step maximum (chunks
        run between decode dispatches and hide behind the slower of the
        two) instead of serializing after the step — the one-shot engine's
        whole-batch stall."""
        vin = tr.mig_in * (1.0 - self.dma_overlap)
        vout = tr.mig_out * (1.0 - self.dma_overlap)
        planned_slow = max(0.0, tr.slow_read - tr.demand_read)
        t_compute = tr.flops / self.peak_flops
        t_roofline = (tr.fast_read + tr.slow_read) / self.fast_read_bw
        t_hbm = tr.fast_read / self.fast_read_bw \
            + vin / self.fast_write_bw + vout / self.fast_read_bw
        t_ext = max(planned_slow / self.ext_read_bw()
                    + max(vin / self.mig_read_bw, vout / self.mig_write_bw),
                    (tr.slow_read + vin + vout) / self.host_internal_bw)
        extra = self._extra_time(tr)
        t = max(t_compute, t_roofline, t_hbm, t_ext)
        if chunked_prefill:
            t = max(t, extra)
            extra = 0.0
        return t + min(tr.demand_read, tr.slow_read) / self.ext_read_bw() \
            + extra + tr.stall \
            + tr.migs * self.mig_overhead

    def step_time_all_fast(self, tr: StepTraffic, *,
                           chunked_prefill: bool = False) -> float:
        """The same step with every demand byte in the fast tier and no
        migration: the roofline floor ``step_time`` can never beat."""
        t = max(tr.flops / self.peak_flops,
                (tr.fast_read + tr.slow_read) / self.fast_read_bw)
        extra = self._extra_time(tr)
        return max(t, extra) if chunked_prefill else t + extra

    def _extra_time(self, tr: StepTraffic) -> float:
        # extra_flops is preferred when both are set (the serving timeline
        # mirrors it into prefill_flops); prefill_read rides the same fast
        # pipe as the prefill's own KV traffic
        eflops = tr.extra_flops or tr.prefill_flops
        ebytes = tr.extra_fast + tr.prefill_read
        if not eflops and not ebytes:
            return 0.0
        return max(eflops / self.peak_flops,
                   ebytes / self.fast_read_bw)

    def price(self, traffic: Sequence[StepTraffic], *,
              chunked_prefill: bool = False) -> CostReport:
        """Fold a traffic series to predicted seconds and tokens/sec."""
        step_times = [self.step_time(tr, chunked_prefill=chunked_prefill)
                      for tr in traffic]
        return CostReport(time=sum(step_times),
                          compute_time=sum(self.step_time_all_fast(tr)
                                           for tr in traffic),
                          tokens=int(sum(tr.tokens for tr in traffic)),
                          step_times=step_times)

    def price_result(self, result, tier_graph=None, *,
                     chunked_prefill: bool = False) -> CostReport:
        """Price a ``PlacementResult`` through its recorded traffic.

        With ``tier_graph`` the series is priced per *edge*: each step's
        time is the pipe maximum over the scalar pipes AND every graph
        edge's attributed bytes over that edge's bandwidth (see
        ``price_on_graph``)."""
        traffic = getattr(result, "step_traffic", None)
        if traffic is None:
            raise ValueError(
                f"result for policy {result.policy!r} carries no "
                "step_traffic (was it built by runtime.simulate?)")
        if tier_graph is None:
            return self.price(traffic, chunked_prefill=chunked_prefill)
        return self.price_on_graph(traffic, tier_graph,
                                   getattr(result, "edge_traffic", None),
                                   chunked_prefill=chunked_prefill)

    def price_on_graph(self, traffic: Sequence[StepTraffic], tier_graph,
                       edge_traffic: Optional[Sequence[dict]] = None,
                       compute: Optional[str] = None, *,
                       chunked_prefill: bool = False,
                       device_traffic: Optional[Sequence[dict]] = None
                       ) -> CostReport:
        """Per-edge pricing: fold each step's channels onto graph edges and
        take the pipe maximum across them.

        The migration channels ride the spill<->compute path (promotions on
        spill->compute, demotions on compute->spill, the DMA-overlapped
        visible fraction only — exactly the terms ``step_time`` already
        prices inside ``T_ext``, so a canonical two-tier graph prices
        byte-identically to ``price``).  ``edge_traffic`` optionally adds
        per-step ``{(src, dst): bytes}`` flows the two-tier fold cannot
        see — cross-device KV streaming on the dev<->dev link — each priced
        at ``path_bw(src, dst)`` as its own pipe (a transfer engine running
        behind compute, surfacing only when it is the bottleneck).

        ``device_traffic`` splits a step across compute nodes: per step a
        ``{node_name: StepTraffic}`` map of each device's *own* share of the
        reads/compute.  When present for a step, the scalar pipe is the max
        over the devices' ``step_time`` values — devices run concurrently,
        so the step lasts as long as its slowest shard — instead of the
        global series' single-machine time (which would price the summed
        reads through one HBM pipe and hide any skew).  The global series
        still supplies tokens and the all-fast floor."""
        # attribute the mig channels to the unbounded (host-like) tier when
        # the graph has one — demotion targets capacity-free memory — and
        # fall back to the view's widest-path spill otherwise.  On the
        # canonical two-tier graph both pick "slow", keeping the pricing
        # byte-identical to ``price``.
        compute_name = compute or tier_graph.nodes[0].name
        spill = next((n.name for n in tier_graph.nodes
                      if n.capacity is None and n.name != compute_name),
                     None)
        view = tier_graph.hw_view(self, compute=compute, spill=spill)

        def pipe(nbytes, src, dst):
            bw = tier_graph.path_bw(src, dst)
            if bw <= 0:
                raise ValueError(f"no path {src} -> {dst} in the tier "
                                 f"graph for {nbytes:.0f} attributed bytes")
            return nbytes / bw

        step_times = []
        for t, tr in enumerate(traffic):
            per_dev = (device_traffic[t] if device_traffic is not None
                       and t < len(device_traffic) else None)
            if per_dev:
                pipes = [self.step_time(dtr,
                                        chunked_prefill=chunked_prefill)
                         for dtr in per_dev.values()]
            else:
                pipes = [self.step_time(tr,
                                        chunked_prefill=chunked_prefill)]
            vin = tr.mig_in * (1.0 - self.dma_overlap)
            vout = tr.mig_out * (1.0 - self.dma_overlap)
            if vin:
                pipes.append(pipe(vin, view.spill, view.compute))
            if vout:
                pipes.append(pipe(vout, view.compute, view.spill))
            flows = (edge_traffic[t] if edge_traffic is not None
                     and t < len(edge_traffic) else None)
            if flows:
                for (src, dst), nbytes in flows.items():
                    if nbytes:
                        pipes.append(pipe(nbytes, src, dst))
            step_times.append(max(pipes))
        return CostReport(time=sum(step_times),
                          compute_time=sum(self.step_time_all_fast(tr)
                                           for tr in traffic),
                          tokens=int(sum(tr.tokens for tr in traffic)),
                          step_times=step_times)

    # --------------------------------------------------------------- json --
    def to_dict(self) -> dict:
        """JSON-safe dict (``inf`` host bandwidth serialized as None)."""
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        if math.isinf(d["host_internal_bw"]):
            d["host_internal_bw"] = None
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CostModel":
        d = dict(d)
        if d.get("host_internal_bw") is None:
            d["host_internal_bw"] = math.inf
        return cls(**d)


def as_cost_model(hw_or_cost) -> CostModel:
    """Coerce an ``HWSpec`` or ``CostModel`` into a ``CostModel``."""
    return CostModel.from_hw(hw_or_cost)


# The default machine: the H100's constants as a time-domain model
# (``core.hardware.default_cost_model``), on an NVIDIA H100 80GB HBM3 at
# its power limit of 700.00 W (nvidia-smi).  "Measured" numbers are one
# run of ``chip_smoke.py``'s ``machine`` line on that card, which prints
# each measured rate beside the constant here (PERF.md, section 5).
H100_COST = CostModel(
    name=H100.name,
    peak_flops=H100.peak_flops,        # spec sheet: dense bf16
    fast_read_bw=H100.fast_bw,         # measured: device-to-device copy
    fast_write_bw=H100.fast_bw,        # measured: the same copy
    slow_read_bw=H100.slow_bw,         # measured: pinned host->device, the
                                       # rate the paged decode kernel's cold
                                       # pages are bounded at
    mig_read_bw=H100.mig_bw,           # measured: pinned host->device
    mig_write_bw=55.15e9,              # measured: a 256 MiB device->
                                       # pinned host copy (demotion)
    # the host link bounds every slow-tier byte, as CostModel.from_hw
    # assumes: host DRAM serves reads and copies faster than the link
    host_internal_bw=math.inf,
    link_bw=H100.link_bw,              # spec sheet: NVLink 4 per direction
    # modelling choice: the engine enqueues demotions on the compute stream
    # between steps and the decode kernel reads cold pages in place with
    # no prefetch window, so no migration byte hides behind compute
    dma_overlap=0.0,
    mig_overhead=H100.mig_overhead,    # measured: see core/hardware.py
    fast_bytes=H100.fast_bytes,        # spec sheet: 80 GB
)
