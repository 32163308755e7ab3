"""Hardware constants for the planner, simulator and roofline analysis."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HWSpec:
    name: str
    peak_flops: float          # /s (bf16 where applicable)
    fast_bw: float             # fast-tier bandwidth, B/s
    slow_bw: float             # slow-tier bandwidth, B/s
    mig_bw: float              # migration bandwidth fast<->slow, B/s (per dir)
    fast_bytes: float          # fast-tier capacity (per device)
    link_bw: float = 0.0       # interconnect per link, B/s (roofline)
    mig_overhead: float = 0.0  # per-migration fixed critical-path cost, s
                               # (move_pages syscall / TLB shootdown on CPU;
                               #  copy dispatch on an accelerator)


# NVIDIA H100 80GB HBM3 (SXM5) at its power limit of 700.00 W, as
# ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
# it: device memory is the fast tier; pinned host memory, read over the
# host link, is the slow tier.  "Measured" numbers are one run of
# ``chip_smoke.py``'s ``machine`` line on that card (PERF.md, section 5).
H100 = HWSpec(
    name="h100-sxm5-80gb",
    peak_flops=989e12,         # spec sheet: dense bf16 on tensor cores
    fast_bw=3023.7e9,          # measured: a 1 GiB device-to-device copy,
                               # each byte read once and written once
    slow_bw=53.42e9,           # measured: a 256 MiB pinned host->device
                               # copy, the link the paged decode kernel
                               # reads cold pages over in place
    mig_bw=53.42e9,            # measured: the same copy (promotion)
    fast_bytes=80e9,           # spec sheet: 80 GB of HBM3
    link_bw=450e9,             # spec sheet: NVLink 4, 900 GB/s both ways
    mig_overhead=1284.01e-6,   # measured: one demotion (a 16-token page of
                               # all 32 layers' K and V, 655360 B, as 64
                               # copies) took 1295.89 us of host time; its
                               # bytes at the device->host rate 11.88 us
)


def default_cost_model():
    """The default machine as a time-domain ``CostModel``: ``H100_COST``,
    the H100's constants plus the device->host migration rate the
    byte-domain ``HWSpec`` cannot express.  Imported lazily:
    ``repro_torch.runtime.costmodel`` depends on this module for the raw
    constants."""
    from repro_torch.runtime.costmodel import H100_COST
    return H100_COST


# The paper's evaluation platform (Table 2): 2-socket Xeon, local vs remote DDR4.
PAPER_HM = HWSpec(
    name="paper-xeon-hm",
    peak_flops=1.5e12,         # ~2x12-core AVX2 Xeon E5-2670v3 fp32
    fast_bw=34e9,
    slow_bw=19e9,
    mig_bw=19e9,               # cross-socket
    fast_bytes=6.4e9,          # Fig.10 uses 20% of peak model footprint
    mig_overhead=2e-6,         # per page, amortized over batched move_pages
                               # with 4-thread parallel copy (Yan et al. mech.)
)
