"""What a cell driver hands back to the harness, and small helpers of the
device."""
from __future__ import annotations

import gc
from dataclasses import dataclass, field


@dataclass
class Run:
    """One run of one cell.  ``e2e``: the end-to-end metrics by name;
    ``window_s``: the measured window; ``spans``: host spans
    (``trace.Spans``); ``counters``: counts the drivers took; ``trace``: the
    device trace's summary (``trace.summarize``), in a ``--trace 1`` run;
    ``checks``: [(name, value, limit)] of the comparison that decides
    ``correct``; ``attempted``/``failed``: steps or requests."""
    e2e: dict = field(default_factory=dict)
    window_s: float = 0.0
    spans: object = None
    counters: dict = field(default_factory=dict)
    trace: dict = None
    checks: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    peak_bytes: int = 0
    notes: dict = field(default_factory=dict)
    sample: list = None          # the served requests the reference judged

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0 and all(
            v is not None and v == v and v <= lim
            for _, v, lim in self.checks)


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    import torch
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device):
    """Collect the dead tensors, hand back the card's cached blocks and the
    pinned host blocks PyTorch keeps."""
    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch._C._host_emptyCache()
