"""The serving half of a placement plan (the port's own copy of the fields
and queries of ``repro/runtime/plan.py::PlacementPlan`` that the engine
reads).  The planner itself is not ported yet: a plan made by the reference
planner crosses over as ``ServingPlan.from_dict(plan.to_dict())``."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class ServingPlan:
    """Per-slot hot windows at page granularity.  ``slot_hot_windows``
    refines the global ``hot_window`` per batch slot; ``page_tokens`` is the
    unit the per-slot cold boundaries are quantized to;
    ``prefill_chunk_tokens`` is the engine's per-step prompt-token budget
    (0 = one-shot prefill); ``slot_tenants[s]`` names the tenant owning
    slot s."""
    hot_window: int = 0
    slot_hot_windows: Optional[List[int]] = None
    page_tokens: int = 0
    prefill_chunk_tokens: int = 0
    slot_tenants: Optional[List[str]] = None

    def slot_window(self, slot: int) -> int:
        """Hot-window tokens for ``slot`` (falls back to the global window)."""
        if not self.slot_hot_windows:
            return self.hot_window
        return self.slot_hot_windows[slot % len(self.slot_hot_windows)]

    def cold_len_slot(self, slot: int, seq_len: int,
                      page_tokens: Optional[int] = None) -> int:
        """Cold boundary for ``slot`` at its current sequence length: tokens
        older than the slot's hot window, in whole pages (``page_tokens``
        overrides the plan's page size).  Monotone in ``seq_len``."""
        cold = max(0, seq_len - self.slot_window(slot))
        page = max(1, page_tokens if page_tokens else self.page_tokens)
        return (cold // page) * page

    @classmethod
    def from_dict(cls, d: dict) -> "ServingPlan":
        """From a reference ``PlacementPlan.to_dict()``; keys this plan does
        not use are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})
